// λ=3 signature kernel on given increments: K5 (forward, with or without the
// checkpoints; the stable backward).
//
// Replaces the TPU kernels sigsvgd_tpu/kernels/pallas_sigkernel.py::
// _fwd_kernel (with _band_sweep) and ::_bwd_kernel (with _bwd_rows_stable).
// Contract, as solve_goursat_pde_pallas / pallas_pair_values there: pair p
// has the scaled increments z[:, :, p] = inc/64 on an lx1 × ly1 coarse grid
// (ly1 <= 48, any lx1), A = 1 + z/2 + z^2/12 and B = 1 - z^2/12 per coarse
// cell; k[p] is node (8·lx1, 8·ly1) of the fine-grid recurrence
//   k[i][j] = (k[i][j-1] + k[i-1][j])·A - k[i-1][j-1]·B
// with ones on the boundary; the backward gives dz, the gradient of
// Σ_p gout[p]·k[p] with respect to z. All arrays are pair-minor
// (z [lx1][ly1][P], ck [nslots][8·ly1+1][P]) so a warp's accesses coalesce.
//
// What bounds it on an H100. At the flagship pair list (524,800 pairs of
// 40-point paths) every pair sweeps (8·39)^2 ≈ 97k fine cells: 2.1e11 fp32
// operations forward (3.1 ms at 67 TFLOP/s) against 7.8 GB of increments and
// checkpoints (2.3 ms at 3.35 TB/s), 7.3e11 backward (10.8 ms) against 11 GB
// (3.3 ms): the operations bound both. A pair's fine row (8·ly1+1 values)
// fits neither a thread's registers nor, for enough threads, shared memory,
// so rows stream through device memory. The design (a simple one, right
// first):
//   * one thread per pair; forward: bands of 8 fine rows whose carries stay
//     in registers while the sweep walks the fine columns, z read once per
//     coarse cell; the fine row lives in the pair's own checkpoint slot, so
//     the checkpoints (every bpc = min(6, lx1) bands and the last) cost no
//     copy. Without checkpoints one slot is the working row. Bands stream,
//     so lx1 is unbounded (as K4's forward, csrc/sigkernel_fused.cu);
//   * backward: persistent blocks, bands top down, as the JAX kernel. The
//     band's primal rows are rebuilt toward +j from its top row (the
//     checkpoint at anchor bands, else the row the band above rebuilt):
//       k[i-1][j] = (k[i][j] + k[i-1][j-1]·B)·A⁻¹ - k[i][j-1],
//     two fused multiply-adds and one reciprocal per coarse cell, stable for
//     general increments (K2's -j scheme divides by B and drifts at large
//     |z|). The rebuild runs left to right and the adjoint right to left, so
//     a first pass rebuilds the band and keeps only each coarse cell's left
//     column (8 values) in per-thread scratch; the second pass walks the
//     coarse cells right to left, rebuilds the cell's 8 × 8 nodes in
//     registers from that column and the top row (the same arithmetic, so
//     the same values), runs the adjoint down the cell's columns
//       ĝ[i][j] = A(i,j+1)·ĝ[i][j+1] + A(i+1,j)·ĝ[i+1][j] - B(i+1,j+1)·ĝ[i+1][j+1]
//     and sums the cell's dz in registers. The adjoint row below the band
//     and the band's bottom primal row (the next band's top) are handed down
//     in per-thread scratch, in place. No shared memory, no atomics; each
//     dz is written once.
// Speed work (wider bands, rows in shared memory, cp.async) comes later.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int M = 8;  // fine cells per coarse cell side (2^λ)
constexpr int NT_FWD = 128;
constexpr int NT_BWD = 64;
constexpr float I6 = 1.0f / 6.0f;
constexpr float I12 = 1.0f / 12.0f;

struct Coef {
  float A, B;
};

// A and B of one coarse cell, rounded as the twin rounds them.
__device__ __forceinline__ Coef coef(float z) {
  Coef k;
  const float zz = __fmul_rn(z, z);
  k.A = __fadd_rn(__fadd_rn(1.f, __fmul_rn(0.5f, z)), __fmul_rn(zz, I12));
  k.B = __fsub_rn(1.f, __fmul_rn(zz, I12));
  return k;
}

// One primal node rebuilt toward +j: k[i-1][j] from k[i][j] (here), its
// left neighbour k[i-1][j-1] (kl) and k[i][j-1] (hl).
__device__ __forceinline__ float rebuild(float kl, float here, float hl, float B, float Ai) {
  return __fmaf_rn(__fmaf_rn(kl, B, here), Ai, -hl);
}

__global__ void __launch_bounds__(NT_FWD)
tiled_fwd_kernel(const float* __restrict__ z, float* __restrict__ kout, float* ck, int P_,
                 int lx1, int ly1, int bpc) {
  const size_t P = P_;
  const size_t p = (size_t)blockIdx.x * NT_FWD + threadIdx.x;
  if (p >= P) return;
  const size_t G1 = (size_t)M * ly1 + 1;
  float edge = 1.f;  // k[8b][G]
  for (int b = 0; b < lx1; ++b) {
    float* slot = ck + (size_t)(b / bpc) * G1 * P + p;
    const bool first = b % bpc == 0;
    if (first) slot[0] = 1.f;  // node column 0
    // node row 8b at columns 1..G (null: the ones boundary) and row 8b+8;
    // in place when they share a slot (each column is read before written)
    const float* below = b == 0 ? nullptr : (first ? slot - G1 * P : slot) + P;
    float* above = slot + P;
    const float* zb = z + (size_t)b * ly1 * P + p;
    float left[M], corner[M];
#pragma unroll
    for (int s = 0; s < M; ++s) {
      left[s] = 1.f;
      corner[s] = 1.f;
    }
    for (int cj = 0; cj < ly1; ++cj) {
      const Coef k = coef(zb[(size_t)cj * P]);
#pragma unroll
      for (int tt = 0; tt < M; ++tt) {
        const size_t j = (size_t)(cj * M + tt);  // node column j+1
        float up = below ? below[j * P] : 1.f;
#pragma unroll
        for (int s = 0; s < M; ++s) {
          const float kn = __fmaf_rn(__fadd_rn(left[s], up), k.A, -__fmul_rn(corner[s], k.B));
          corner[s] = up;
          left[s] = kn;
          up = kn;
        }
        above[j * P] = up;
      }
    }
    edge = left[M - 1];
  }
  kout[p] = edge;
}

__global__ void __launch_bounds__(NT_BWD)
tiled_bwd_kernel(const float* __restrict__ z, const float* __restrict__ ck,
                 const float* __restrict__ gout, float* __restrict__ dz, float* scratch,
                 int P_, int lx1, int ly1, int bpc) {
  const size_t P = P_;
  const size_t T = (size_t)gridDim.x * NT_BWD;
  const size_t t = (size_t)blockIdx.x * NT_BWD + threadIdx.x;
  const int G = M * ly1;
  const size_t G1 = (size_t)G + 1;
  // per-thread scratch, thread-minor: row [G] (primal node row at columns
  // 1..G: the band's top, then its bottom for the band below), lam [G]
  // (adjoint of the row above the band, then of the band's bottom row),
  // bnd [ly1-1][8] (rows 8b..8b+7 at column 8cc, cc >= 1)
  float* row = scratch + t;
  float* lam = row + (size_t)G * T;
  float* bnd = lam + (size_t)G * T;

  for (size_t p = t; p < P; p += T) {
    const float sd = gout[p];
    for (int b = lx1 - 1; b >= 0; --b) {
      const bool topband = b == lx1 - 1;
      const bool anchor = topband || (b + 1) % bpc == 0;
      // top[(j-1)·ts] = k[8b+8][j], j = 1..G
      const float* top = anchor ? ck + (size_t)(b / bpc) * G1 * P + P + p : row;
      const size_t ts = anchor ? P : T;
      const float* zb = z + (size_t)b * ly1 * P + p;
      const float* zu = z + (size_t)(b + 1) * ly1 * P + p;  // read only below the top band

      // pass 1: rebuild the band left to right; keep each cell's left column
      {
        float prev[M + 1];
#pragma unroll
        for (int s = 0; s <= M; ++s) prev[s] = 1.f;
        for (int cc = 0; cc < ly1 - 1; ++cc) {
          const Coef k = coef(zb[(size_t)cc * P]);
          const float Ai = __frcp_rn(k.A);
#pragma unroll
          for (int tt = 0; tt < M; ++tt) {
            float cur[M + 1];
            cur[M] = top[(size_t)(cc * M + tt) * ts];
#pragma unroll
            for (int s = M - 1; s >= 0; --s)
              cur[s] = rebuild(prev[s], cur[s + 1], prev[s + 1], k.B, Ai);
#pragma unroll
            for (int s = 0; s <= M; ++s) prev[s] = cur[s];
          }
#pragma unroll
          for (int s = 0; s < M; ++s) bnd[(size_t)(cc * M + s) * T] = prev[s];
        }
      }

      // pass 2: coarse cells right to left
      float gR[M + 1];  // ĝ[8b+s][j+1], s = 1..8
#pragma unroll
      for (int s = 0; s <= M; ++s) gR[s] = 0.f;
      float lamR = 0.f;                        // ĝ[8b+9][j+1]
      float Ar = 0.f, Br = 0.f, Bur = 0.f;     // cell cc+1 of band b, B of band b+1
      for (int cc = ly1 - 1; cc >= 0; --cc) {
        const float zc = zb[(size_t)cc * P];
        const Coef k = coef(zc);
        const float Ai = __frcp_rn(k.A);
        const Coef ku = topband ? Coef{0.f, 0.f} : coef(zu[(size_t)cc * P]);
        // the cell's primal nodes: K[s][c] = k[8b+s][8cc+c]
        float K[M + 1][M + 1];
#pragma unroll
        for (int s = 0; s < M; ++s) K[s][0] = cc ? bnd[(size_t)((cc - 1) * M + s) * T] : 1.f;
        K[M][0] = cc ? top[(size_t)(cc * M - 1) * ts] : 1.f;
#pragma unroll
        for (int c = 1; c <= M; ++c) K[M][c] = top[(size_t)(cc * M + c - 1) * ts];
#pragma unroll
        for (int c = 1; c <= M; ++c) {
#pragma unroll
          for (int s = M - 1; s >= 0; --s)
            K[s][c] = rebuild(K[s][c - 1], K[s + 1][c], K[s + 1][c - 1], k.B, Ai);
        }
        if (b > 0) {
#pragma unroll
          for (int c = 1; c <= M; ++c) row[(size_t)(cc * M + c - 1) * T] = K[0][c];
        }
        // the adjoint down each column, columns right to left; the cell's dz
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int c = M; c >= 1; --c) {
          const int j = cc * M + c;
          const float ar = c == M ? Ar : k.A;    // A(i, j+1)
          const float br = c == M ? Br : k.B;    // B(i+1, j+1), rows inside the band
          const float bur = c == M ? Bur : ku.B; // B(i+1, j+1), the top row
          const float lamj = topband ? 0.f : lam[(size_t)(j - 1) * T];  // ĝ[8b+9][j]
          float gN[M + 1];
          float g = __fmaf_rn(ar, gR[M], __fmaf_rn(ku.A, lamj, -__fmul_rn(bur, lamR)));
          if (topband && j == G) g = g + sd;
          gN[M] = g;
#pragma unroll
          for (int s = M - 1; s >= 1; --s)
            gN[s] = __fmaf_rn(ar, gR[s], __fmaf_rn(k.A, gN[s + 1], -__fmul_rn(br, gR[s + 1])));
#pragma unroll
          for (int s = M; s >= 1; --s) {
            s1 = __fmaf_rn(gN[s], __fadd_rn(K[s][c - 1], K[s - 1][c]), s1);
            s2 = __fmaf_rn(gN[s], K[s - 1][c - 1], s2);
          }
          if (b > 0) lam[(size_t)(j - 1) * T] = gN[1];  // ĝ[8b+1][j] for the band below
          lamR = lamj;
#pragma unroll
          for (int s = 1; s <= M; ++s) gR[s] = gN[s];
        }
        const float zs = __fmul_rn(zc, I6);
        dz[((size_t)b * ly1 + cc) * P + p] =
            __fmaf_rn(__fadd_rn(0.5f, zs), s1, __fmul_rn(zs, s2));
        Ar = k.A;
        Br = k.B;
        Bur = ku.B;
      }
    }
  }
}

}  // namespace

extern "C" {

// z [lx1, ly1, P] scaled increments; k [P]; ck [ceil(lx1/bpc), 8·ly1+1, P]
// (the working row and the checkpoints; bpc = lx1 for values only). fp32,
// contiguous, on the stream's device; 1 <= ly1 <= 48. Returns
// cudaGetLastError() after the launch.
int sigkernel_tiled_fwd(const float* z, float* k, float* ck, int P, int lx1, int ly1,
                        int bpc, void* stream) {
  if (lx1 < 1 || ly1 < 1 || ly1 > 48 || bpc < 1) return (int)cudaErrorInvalidValue;
  const int grid = (P + NT_FWD - 1) / NT_FWD;
  tiled_fwd_kernel<<<grid, NT_FWD, 0, static_cast<cudaStream_t>(stream)>>>(z, k, ck, P, lx1,
                                                                           ly1, bpc);
  return (int)cudaGetLastError();
}

// Number of persistent blocks of nt threads for a backward launch on P
// pairs: those resident on the card at once, at most one per nt pairs.
int sigkernel_tiled_bwd_grid(int nt, int P, int* blocks) {
  if (nt != NT_BWD) return (int)cudaErrorInvalidValue;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tiled_bwd_kernel, NT_BWD, 0);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int need = (P + NT_BWD - 1) / NT_BWD;
  *blocks = min(per_sm * sms, need > 0 ? need : 1);
  return (int)cudaSuccess;
}

// K5's backward: z and ck as the forward wrote them (bpc = min(6, lx1)),
// gout [P]; writes dz [lx1, ly1, P]. scratch: blocks · 64 · 4·3·8·ly1 bytes.
int sigkernel_tiled_bwd(const float* z, const float* ck, const float* gout, float* dz,
                        void* scratch, int blocks, int P, int lx1, int ly1, int bpc,
                        void* stream) {
  if (lx1 < 1 || ly1 < 1 || ly1 > 48 || bpc < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  tiled_bwd_kernel<<<blocks, NT_BWD, 0, static_cast<cudaStream_t>(stream)>>>(
      z, ck, gout, dz, static_cast<float*>(scratch), P, lx1, ly1, bpc);
  return (int)cudaGetLastError();
}

}  // extern "C"
