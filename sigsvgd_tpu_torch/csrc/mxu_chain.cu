// Goursat PDE at dyadic order >= 6 as a chain of 64x64 block hops (K8).
//
// Replaces the TPU kernels sigsvgd_tpu/kernels/pallas_mxu_chain.py::
// _fwd_kernel and ::_bwd_kernel (launched by _chain_tiled and _chain_bwd).
// For each pair, with z = inc / 4^λ per coarse cell, every block hop (I, J)
// maps its 129 input nodes in (south row e <= 64 from the hop below, west
// column e > 64 from the hop to the left) to its 129 output nodes:
//   U_d[f] = Σ_{e<128} M_d[f, e]·bf16(in[e]) + M_d[f, 128]·in[128]
//   out[f] = Σ_{d=0..D} z^d U_d[f]
// The value k is node 64 of the last hop's north row. The backward kernel
// recomputes the chain (storing each hop's bf16 input and fp32 last node in
// device scratch), then sweeps the hops in reverse:
//   dz   += Σ_{d>=1} d·z^{d-1}·Σ_f U_d[f]·d_out[f]
//   d_in  = Σ_d M_d[:, :128]ᵀ·bf16(z^d·d_out)  (rows < 128),
//           Σ_d Σ_f M_d[f, 128]·z^d·d_out[f]   (row 128, fp32).
// Both products run on the tensor cores in this file's own body, as
// mma.sync.m16n8k16 bf16 x bf16 -> fp32.
//
// What bounds it on an H100: operations. A hop is a [144 x 128] x [128 x P]
// product for each of the 11 degrees (2·11·129·128 operations per pair),
// against 4 bytes of z per coarse cell, so at the planning shape (2^20
// pairs, 4 hops) the forward is ~1.5e12 bf16 operations (~1.5 ms at 989
// TFLOP/s) and moves ~21 MB. The design, simple first:
//   * one block of 9 warps owns a tile of P = 64 pairs and runs all its hops;
//     blocks are persistent (as many as are resident) and walk the tiles;
//   * warp w owns output rows 16w..16w+15 (144 rows, 129 used). For each
//     degree it streams its A fragments of M_d (pre-laid-out by the wrapper
//     so each lane loads 16 bytes, L2-resident: 0.4 MB shared by every
//     block) and multiplies them with the tile's staged bf16 input in
//     shared memory, 8 n-tiles of 8 pairs. The accumulator layout of
//     mma.sync is fixed, so the rank-1 last-node term, the z^d scaling and
//     the degree sum happen in registers;
//   * the north rows of the tile's hops and the stored hop inputs live in
//     per-block device scratch (allocated by the wrapper), the west carry,
//     the staged input, z, z^d and the backward's cotangents in shared
//     memory. Pairs are independent: no atomics, deterministic sums.
// Not yet: wgmma, TMA, a larger pair tile (each block re-reads the basis once
// per hop, so the L2 traffic is 6.3 KB per pair and hop).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int M = 64;            // block edge
constexpr int NB = 2 * M + 1;    // nodes per hop vector
constexpr int NS = M + 1;        // north rows (the next hop's south input)
constexpr int NE = M;            // east rows (the next hop's west input)
constexpr int FP = 144;          // output rows padded to 9 m-tiles
constexpr int MT = FP / 16;      // m-tiles of the forward product
constexpr int KS = 128 / 16;     // k-steps of the forward product
constexpr int MTB = 128 / 16;    // m-tiles of the backward product
constexpr int KSB = FP / 16;     // k-steps of the backward product
constexpr int P = 64;            // pairs per tile
constexpr int NT = P / 8;        // n-tiles of 8 pairs
constexpr int NWARP = MT;
constexpr int NTH = NWARP * 32;
constexpr int LDI = 136;         // bf16 row stride of the staged input [P][LDI]
constexpr int LDW = 152;         // bf16 row stride of the weighted cotangent
constexpr int LDD = P + 4;       // fp32 row stride of the output cotangent
constexpr int NSTG = 4 * P;      // backward staging threads: 4 row classes per pair
constexpr size_t INP_BYTES = (size_t)P * LDI * 2 + (size_t)P * 4;  // one hop

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Shared-memory layout common to both kernels.
struct Smem {
  uint16_t* in_bf;   // [P][LDI] bf16 hop input, nodes 0..127
  uint16_t* w_bf;    // [P][LDW] bf16 weighted cotangent (backward only)
  float* in_last;    // [P] node 128
  float* west;       // [NE][P] west carry (forward) / its cotangent (backward)
  float* mlast;      // [D1][FP] M_d[f, 128]
  float* zs;         // [nc][P]
  float* zpow;       // [D1][P] z^d by repeated multiplication
  float* dout;       // [FP][LDD] output cotangent (backward only)
  float* part;       // [NWARP][P] per-warp dz partials (backward only)
  float* dlp;        // [4][P] last-node cotangent partials (backward only)
  float* dzs;        // [nc][P] dz accumulator (backward only)
};

__host__ __device__ size_t smem_bytes(int nc, int D1, bool bwd) {
  size_t b = (size_t)P * LDI * 2 + (size_t)4 * (P + NE * P + D1 * FP + nc * P + D1 * P);
  if (bwd) b += (size_t)P * LDW * 2 + (size_t)4 * (FP * LDD + NWARP * P + 4 * P + nc * P);
  return b;
}

__device__ Smem carve(unsigned char* raw, int nc, int D1, bool bwd) {
  Smem s;
  s.in_bf = reinterpret_cast<uint16_t*>(raw);
  raw += (size_t)P * LDI * 2;
  s.w_bf = reinterpret_cast<uint16_t*>(raw);
  if (bwd) raw += (size_t)P * LDW * 2;
  float* f = reinterpret_cast<float*>(raw);
  s.in_last = f; f += P;
  s.west = f; f += NE * P;
  s.mlast = f; f += D1 * FP;
  s.zs = f; f += nc * P;
  s.zpow = f; f += D1 * P;
  s.dout = f; if (bwd) f += FP * LDD;
  s.part = f; if (bwd) f += NWARP * P;
  s.dlp = f; if (bwd) f += 4 * P;
  s.dzs = f;
  return s;
}

// z^0..z^{D1-1} of the tile's pairs for coarse cell cidx (threads < P).
__device__ void stage_zpow(const Smem& s, int cidx, int D1) {
  const int p = threadIdx.x;
  if (p < P) {
    const float zz = s.zs[cidx * P + p];
    float zp = zz;
    s.zpow[p] = 1.f;
    for (int d = 1; d < D1; ++d) {
      s.zpow[d * P + p] = zp;
      zp = zp * zz;
    }
  }
}

// Hop input from the north buffer of column I (rows <= 64) and the west
// carry (rows > 64; ones at I == 0), into the bf16 tile and the last node.
// With `keep`, also into this hop's slot of the input scratch.
__device__ void stage_input(const Smem& s, const float* north_I, bool first_col,
                            unsigned char* keep) {
  for (int i = threadIdx.x; i < NB * P; i += NTH) {
    const int e = i / P, p = i % P;
    const float v = e <= M ? north_I[e * P + p]
                           : (first_col ? 1.f : s.west[(e - NS) * P + p]);
    if (e < 128) {
      const uint16_t bits = bf16_bits(v);
      s.in_bf[p * LDI + e] = bits;
      if (keep) reinterpret_cast<uint16_t*>(keep)[p * LDI + e] = bits;
    } else {
      s.in_last[p] = v;
      if (keep) reinterpret_cast<float*>(keep + (size_t)P * LDI * 2)[p] = v;
    }
  }
}

// U_d for this warp's 16 output rows and the tile's 64 pairs:
// u[nt][c] = (M_d · bf16(in))[row, col] + M_d[row, 128]·in[128].
__device__ __forceinline__ void hop_u(const Smem& s, const uint4* __restrict__ afrag,
                                      int d, int warp, int lane, float u[NT][4]) {
  const int gid = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) u[nt][c] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < KS; ++ks) {
    const uint4 a = __ldg(&afrag[((d * MT + warp) * KS + ks) * 32 + lane]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint16_t* bp = s.in_bf + (nt * 8 + gid) * LDI + ks * 16 + tq * 2;
      mma_bf16(u[nt], a, *reinterpret_cast<const uint32_t*>(bp),
               *reinterpret_cast<const uint32_t*>(bp + 8));
    }
  }
  const int f0 = warp * 16 + gid;
  const float ml0 = s.mlast[d * FP + f0], ml1 = s.mlast[d * FP + f0 + 8];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float il = s.in_last[nt * 8 + tq * 2 + h];
      u[nt][h] = u[nt][h] + ml0 * il;
      u[nt][2 + h] = u[nt][2 + h] + ml1 * il;
    }
}

// One forward hop: the degree sum of U_d into this warp's rows, written to
// the north buffer (rows <= 64) and the west carry (rows 65..128).
__device__ void forward_hop(const Smem& s, const uint4* __restrict__ afrag,
                            float* north_I, int D1) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tq = lane & 3;
  float out[NT][4], u[NT][4];
  for (int d = 0; d < D1; ++d) {
    hop_u(s, afrag, d, warp, lane, u);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (d == 0) {
          out[nt][c] = u[nt][c];
        } else {
          const float zp = s.zpow[d * P + nt * 8 + tq * 2 + (c & 1)];
          out[nt][c] = out[nt][c] + zp * u[nt][c];
        }
      }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = warp * 16 + gid + (c >= 2 ? 8 : 0);
      const int p = nt * 8 + tq * 2 + (c & 1);
      if (f <= M) north_I[f * P + p] = out[nt][c];
      else if (f < NB) s.west[(f - NS) * P + p] = out[nt][c];
    }
}

__device__ void load_common(const Smem& s, const float* __restrict__ z,
                            const float* __restrict__ mlast, int B, int nc, int D1,
                            int p0) {
  for (int i = threadIdx.x; i < D1 * FP; i += NTH) s.mlast[i] = mlast[i];
  for (int i = threadIdx.x; i < nc * P; i += NTH) {
    const int p = i / nc, c = i % nc;
    s.zs[c * P + p] = p0 + p < B ? z[(size_t)p0 * nc + i] : 0.f;
  }
}

// The whole forward chain of one tile; `inputs` (or null) receives each
// hop's staged input.
__device__ void forward_chain(const Smem& s, const uint4* __restrict__ afrag,
                              float* north, unsigned char* inputs, int nbx, int nby,
                              int sub, int ly1, int D1) {
  for (int i = threadIdx.x; i < nbx * NS * P; i += NTH) north[i] = 1.f;
  for (int J = 0; J < nby; ++J) {
    for (int I = 0; I < nbx; ++I) {
      __syncthreads();  // the previous hop's outputs (or the init) are visible
      stage_input(s, north + (size_t)I * NS * P, I == 0,
                  inputs ? inputs + (size_t)(J * nbx + I) * INP_BYTES : nullptr);
      stage_zpow(s, (I / sub) * ly1 + (J / sub), D1);
      __syncthreads();
      forward_hop(s, afrag, north + (size_t)I * NS * P, D1);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTH, 2)
chain_fwd_kernel(const float* __restrict__ z, const uint4* __restrict__ afrag,
                 const float* __restrict__ mlast, float* __restrict__ k,
                 float* __restrict__ north_all, int B, int nc, int nbx, int nby,
                 int sub, int ly1, int D1) {
  extern __shared__ __align__(16) unsigned char smraw[];
  const Smem s = carve(smraw, nc, D1, false);
  float* north = north_all + (size_t)blockIdx.x * nbx * NS * P;
  const int ntiles = (B + P - 1) / P;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * P;
    __syncthreads();  // the previous tile is done with zs and north
    load_common(s, z, mlast, B, nc, D1, p0);
    forward_chain(s, afrag, north, nullptr, nbx, nby, sub, ly1, D1);
    const int p = threadIdx.x;
    if (p < P && p0 + p < B) k[p0 + p] = north[((nbx - 1) * NS + M) * P + p];
  }
}

__global__ void __launch_bounds__(NTH, 2)
chain_bwd_kernel(const float* __restrict__ z, const float* __restrict__ gout,
                 const uint4* __restrict__ afrag, const uint4* __restrict__ atfrag,
                 const float* __restrict__ mlast, float* __restrict__ dz,
                 float* __restrict__ north_all, unsigned char* __restrict__ inp_all,
                 int B, int nc, int nbx, int nby, int sub, int ly1, int D1) {
  extern __shared__ __align__(16) unsigned char smraw[];
  const Smem s = carve(smraw, nc, D1, true);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tq = lane & 3;
  float* dnorth = north_all + (size_t)blockIdx.x * nbx * NS * P;
  unsigned char* inputs = inp_all + (size_t)blockIdx.x * nbx * nby * INP_BYTES;
  const int ntiles = (B + P - 1) / P;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * P;
    __syncthreads();
    load_common(s, z, mlast, B, nc, D1, p0);
    forward_chain(s, afrag, dnorth, inputs, nbx, nby, sub, ly1, D1);

    // reverse sweep: dnorth[I] holds the cotangent of hop (I, J)'s north
    // rows, s.west that of its east rows (the next hop's west input)
    for (int i = threadIdx.x; i < nbx * NS * P; i += NTH) dnorth[i] = 0.f;
    for (int i = threadIdx.x; i < nc * P; i += NTH) s.dzs[i] = 0.f;
    __syncthreads();
    if (threadIdx.x < P) {
      const int p = threadIdx.x;
      dnorth[((nbx - 1) * NS + M) * P + p] = p0 + p < B ? gout[p0 + p] : 0.f;
    }
    for (int J = nby - 1; J >= 0; --J) {
      for (int I = nbx - 1; I >= 0; --I) {
        const int cidx = (I / sub) * ly1 + (J / sub);
        float* dn = dnorth + (size_t)I * NS * P;
        const unsigned char* kept = inputs + (size_t)(J * nbx + I) * INP_BYTES;
        __syncthreads();
        for (int i = threadIdx.x; i < FP * P; i += NTH) {
          const int f = i / P, p = i % P;
          float v = 0.f;
          if (f <= M) v = dn[f * P + p];
          else if (f < NB && I < nbx - 1) v = s.west[(f - NS) * P + p];
          s.dout[f * LDD + p] = v;
        }
        for (int i = threadIdx.x; i < P * LDI / 2; i += NTH)
          reinterpret_cast<uint32_t*>(s.in_bf)[i] =
              reinterpret_cast<const uint32_t*>(kept)[i];
        for (int i = threadIdx.x; i < P; i += NTH)
          s.in_last[i] = reinterpret_cast<const float*>(kept + (size_t)P * LDI * 2)[i];
        stage_zpow(s, cidx, D1);
        __syncthreads();

        // dz: Σ_{d>=1} d·z^{d-1}·Σ_f U_d[f]·d_out[f], this warp's rows
        {
          float acc[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = 0.f;
          float u[NT][4];
          const int f0 = warp * 16 + gid;
          for (int d = 1; d < D1; ++d) {
            hop_u(s, afrag, d, warp, lane, u);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int p = nt * 8 + tq * 2 + h;
                const float dot = u[nt][h] * s.dout[f0 * LDD + p] +
                                  u[nt][2 + h] * s.dout[(f0 + 8) * LDD + p];
                acc[nt][h] += ((float)d * s.zpow[(d - 1) * P + p]) * dot;
              }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v = acc[nt][h];
              v += __shfl_xor_sync(0xffffffffu, v, 4);
              v += __shfl_xor_sync(0xffffffffu, v, 8);
              v += __shfl_xor_sync(0xffffffffu, v, 16);
              if (gid == 0) s.part[warp * P + nt * 8 + tq * 2 + h] = v;
            }
        }

        // d_in = Σ_d M_dᵀ·bf16(z^d·d_out) (warps 0-7, rows e = 16w..16w+15).
        // The staging threads form w = z^d·d_out for pair sp and the rows
        // f ≡ sq (mod 4), and fold the last node's fp32 cotangent
        // Σ_d Σ_f M_d[f, 128]·w[f] into their partial as they go.
        float din[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) din[nt][c] = 0.f;
        const int sp = threadIdx.x % P, sq = threadIdx.x / P;
        float dl = 0.f;
        for (int d = 0; d < D1; ++d) {
          __syncthreads();  // the previous degree's w is consumed
          if (threadIdx.x < NSTG) {
            const float zp = s.zpow[d * P + sp];
            const float* ml = s.mlast + d * FP;
            for (int f = sq; f < FP; f += 4) {
              const float w = zp * s.dout[f * LDD + sp];
              s.w_bf[sp * LDW + f] = bf16_bits(w);
              dl = fmaf(ml[f], w, dl);
            }
          }
          __syncthreads();
          if (warp < MTB) {
#pragma unroll 1
            for (int ks = 0; ks < KSB; ++ks) {
              const uint4 a = __ldg(&atfrag[((d * MTB + warp) * KSB + ks) * 32 + lane]);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const uint16_t* bp = s.w_bf + (nt * 8 + gid) * LDW + ks * 16 + tq * 2;
                mma_bf16(din[nt], a, *reinterpret_cast<const uint32_t*>(bp),
                         *reinterpret_cast<const uint32_t*>(bp + 8));
              }
            }
          }
        }
        __syncthreads();  // dout and west are consumed; part is complete
        if (threadIdx.x < NSTG) s.dlp[sq * P + sp] = dl;
        if (threadIdx.x < P) {
          const int p = threadIdx.x;
          float v = 0.f;
          for (int w = 0; w < NWARP; ++w) v += s.part[w * P + p];
          s.dzs[cidx * P + p] += v;
        }
        if (warp < MTB) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int e = warp * 16 + gid + (c >= 2 ? 8 : 0);
              const int p = nt * 8 + tq * 2 + (c & 1);
              if (e <= M) dn[e * P + p] = din[nt][c];
              else s.west[(e - NS) * P + p] = din[nt][c];
            }
        }
        __syncthreads();  // the last-node partials are complete
        if (threadIdx.x < P) {
          const int p = threadIdx.x;
          s.west[(NB - 1 - NS) * P + p] =
              (s.dlp[p] + s.dlp[P + p]) + (s.dlp[2 * P + p] + s.dlp[3 * P + p]);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nc * P; i += NTH) {
      const int p = i / nc, c = i % nc;
      if (p0 + p < B) dz[(size_t)p0 * nc + i] = s.dzs[c * P + p];
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, int nc, int D1, bool bwd, size_t* smem) {
  *smem = smem_bytes(nc, D1, bwd);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" {

// Resident blocks of the forward (bwd = 0) or backward kernel on the
// current device: blocks per SM at this shared-memory size × SMs.
int mxu_chain_blocks(int nc, int D1, int bwd, int* blocks) {
  size_t smem;
  cudaError_t err = bwd ? prepare(chain_bwd_kernel, nc, D1, true, &smem)
                        : prepare(chain_fwd_kernel, nc, D1, false, &smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = bwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_bwd_kernel,
                                                            NTH, smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_fwd_kernel,
                                                            NTH, smem);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return 0;
}

// z [B, nc] fp32 (scaled increments, coarse cells row-major), afrag the
// forward basis fragments, mlast [D1, 144]; k [B]; north: `blocks` slices of
// nbx·65·64 floats. Returns cudaGetLastError() after the launch.
int mxu_chain_fwd(const float* z, const void* afrag, const float* mlast, float* k,
                  float* north, int B, int nc, int nbx, int nby, int sub, int ly1,
                  int D1, int blocks, void* stream) {
  size_t smem;
  cudaError_t err = prepare(chain_fwd_kernel, nc, D1, false, &smem);
  if (err != cudaSuccess) return (int)err;
  chain_fwd_kernel<<<blocks, NTH, smem, static_cast<cudaStream_t>(stream)>>>(
      z, static_cast<const uint4*>(afrag), mlast, k, north, B, nc, nbx, nby, sub,
      ly1, D1);
  return (int)cudaGetLastError();
}

// As mxu_chain_fwd, plus gout [B], atfrag the backward basis fragments,
// dz [B, nc] out, and `blocks` slices of nbx·nby·(64·136·2 + 64·4) bytes of
// input scratch.
int mxu_chain_bwd(const float* z, const float* gout, const void* afrag,
                  const void* atfrag, const float* mlast, float* dz, float* north,
                  void* inputs, int B, int nc, int nbx, int nby, int sub, int ly1,
                  int D1, int blocks, void* stream) {
  size_t smem;
  cudaError_t err = prepare(chain_bwd_kernel, nc, D1, true, &smem);
  if (err != cudaSuccess) return (int)err;
  chain_bwd_kernel<<<blocks, NTH, smem, static_cast<cudaStream_t>(stream)>>>(
      z, gout, static_cast<const uint4*>(afrag), static_cast<const uint4*>(atfrag),
      mlast, dz, north, static_cast<unsigned char*>(inputs), B, nc, nbx, nby, sub,
      ly1, D1);
  return (int)cudaGetLastError();
}

}  // extern "C"
