// λ=3 symmetric signature-kernel Gram + full-sum pull-back gradient (K2).
//
// Replaces the TPU kernels sigsvgd_tpu/kernels/pallas_sigkernel_block3.py::
// _fwd_kernel_b3 and ::_bwd_kernel_b3 (with pallas_sigkernel.py::_band_sweep
// and ::_bwd_rows_fast inside them). Contract, as block3_gram_and_grad there:
// for paths X [n, L, C] fp32 and static bandwidth h,
//   K  [n, n]    the dyadic-order-3 Goursat-PDE signature kernel with the
//                RBF static kernel exp(-|x_p - y_q|^2 / h), on the 8(L-1)
//                square fine grid, written to [a,b] and [b,a];
//   dX [n, L, C] = ½ ∂(Σ_ab K_ab)/∂X.
// Each unordered pair a <= b is solved once, with cotangent seed 2 off the
// diagonal and 1 on it.
//
// What bounds it on an H100. Every pair sweeps (8(L-1))² fine cells forward
// and back: ~1.4M operations per pair at L=40, 7.6e11 over the 524,800
// pairs of [1024, 40, 2], against a few MB of inputs and outputs, so the
// arithmetic bound (fp32 CUDA cores) is ~10^4 times the byte bound. But a
// pair's fine row (8(L-1)+1 floats) fits neither a thread's registers nor,
// for enough threads, shared memory, so rows stream through device memory
// and the traffic they cause (~1 B per fine cell forward, ~1.5 B back) is
// what a simple design pays for. The design:
//   * one thread per pair; a block holds an 8-row × 16-column particle tile
//     and stages its 24 paths (pre-scaled by rsqrt(h)) in shared memory;
//     blocks are persistent (as many as are resident) and walk a tile list;
//   * statics are formed on the fly, two exp per coarse cell, as the
//     squared-difference form exp(-Σ_c (x'_c - y'_c)^2); z, A, B once per
//     coarse cell, shared by its 8×8 fine cells;
//   * forward: bands of 8 fine rows; the band's 8 row carries (left value
//     and corner) stay in registers while the sweep walks the fine columns,
//     so the fine row is read and written once per 8 fine rows. Every
//     band's top row is kept (a checkpoint per band) in per-thread device
//     scratch laid out pair-minor, so a warp's accesses coalesce, and so is
//     the right-edge column;
//   * backward: bands top-down, fine columns right to left, three chains in
//     registers per column: the adjoint of the band's 8 rows, the primal of
//     the column to the left reconstructed toward -j (divide by B, as the
//     TPU's _bwd_rows_fast does), re-anchored at the band's stored top row
//     and every row's stored right edge, and the dz sums. With a
//     checkpoint at every band, the reconstruction spans at most 8 fine
//     rows (the TPU kernel's spans up to 48);
//   * the adjoint row passed from one band to the next is the only other
//     scratch; no per-cell array lives in local memory;
//   * dz is pulled back through the statics per coarse cell (row difference
//     of dinc, then d/dd² = -g·dg and 2(x'-y')); the row-path gradient of
//     each static row is summed over the tile's 16 columns by warp shuffles
//     and the column-path gradient goes to per-thread slots in shared
//     memory, then a fixed-order per-block sum writes per-tile partials and
//     a second kernel sums each particle's partials in tile order: no
//     atomics, deterministic.
// The statics and the forward sweep round as the plain twin does, each
// operation on its own except the sweep's product by A, which is fused into
// its subtraction as XLA compiles the JAX kernel's sweep (A - 1 ≈ z/2 keeps
// a few digits in fp32 and every A serves 64 fine cells, so where the sweep
// rounds moves K). K then matches the twin on the card up to the exp; the
// backward contracts freely.
// Speed work (wider bands to cut row traffic, more warps per SM) comes later.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TR = 8;   // row particles per block
constexpr int TC = 16;  // column particles per block
constexpr int NT = TR * TC;
constexpr int M = 8;    // fine cells per coarse cell side (2^λ)
constexpr float ZS = 1.0f / 64.0f;
constexpr float I6 = 1.0f / 6.0f;
constexpr float I12 = 1.0f / 12.0f;

size_t smem_bytes(int L, int C) {
  const int LC = L * C;
  return sizeof(float) * (size_t)(LC * (TR + TC) + LC * NT + LC * TR);
}

// Static-Gram entry g[p][q] = exp(-Σ_c (x'_p,c - y'_q,c)^2), rounded in the
// twin's order.
template <int C>
__device__ __forceinline__ float gval(const float* xs, const float* ys, int p,
                                      int q, int r, int cl) {
  float d2 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float d = __fsub_rn(xs[(p * C + c) * TR + r], ys[(q * C + c) * TC + cl]);
    d2 = __fadd_rn(d2, __fmul_rn(d, d));
  }
  return expf(-d2);
}

struct Coef {
  float z, A, B;
};

__device__ __forceinline__ Coef coef(float gu1, float gu0, float gd1, float gd0) {
  Coef k;
  k.z = __fmul_rn(__fadd_rn(__fsub_rn(__fsub_rn(gu1, gu0), gd1), gd0), ZS);
  const float zz = __fmul_rn(k.z, k.z);
  k.A = __fadd_rn(__fadd_rn(1.f, __fmul_rn(0.5f, k.z)), __fmul_rn(zz, I12));
  k.B = __fsub_rn(1.f, __fmul_rn(zz, I12));
  return k;
}

// Pull one adjoint increment E back through static node column q of the
// band's two static rows: dg = +E on the upper row, -E on the lower row.
template <int C>
__device__ __forceinline__ void pull_back(float E, float gu, float gd,
                                          const float* ys, float* dyc, int q,
                                          int cl, int tid, const float (&xu)[C],
                                          const float (&xd)[C], float (&sxu)[C],
                                          float (&sxd)[C], float& swu, float& swd) {
  const float wu = -gu * E;   // ∂/∂d² of the upper node
  const float wd = gd * E;    // ∂/∂d² of the lower node
  swu += wu;
  swd += wd;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float yv = ys[(q * C + c) * TC + cl];
    sxu[c] = fmaf(wu, yv, sxu[c]);
    sxd[c] = fmaf(wd, yv, sxd[c]);
    float* d = dyc + (q * C + c) * NT + tid;
    *d += 2.f * ((yv - xu[c]) * wu + (yv - xd[c]) * wd);
  }
}

// Sum v over the 16 lanes of a half-warp (the 16 columns of one tile row)
// and store it from the half-warp's first lane.
__device__ __forceinline__ void row_sum_store(float v, float* dst, int cl) {
#pragma unroll
  for (int o = TC / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (cl == 0) *dst = v;
}

template <int C>
__global__ void __launch_bounds__(NT)
block3_kernel(const float* __restrict__ X, const float* __restrict__ sptr,
              const int* __restrict__ tiles, int n_tiles, float* __restrict__ K,
              float* __restrict__ rowpart, float* __restrict__ colpart,
              float* __restrict__ scratch, int n, int L) {
  extern __shared__ float smem[];
  const int LC = L * C;
  float* xs = smem;              // [L][C][TR] scaled row paths
  float* ys = xs + LC * TR;      // [L][C][TC] scaled column paths
  float* dyc = ys + LC * TC;     // [L·C][NT]  per-thread column-path gradient
  float* dxr = dyc + LC * NT;    // [L·C][TR]  tile-row sums of the row-path gradient

  const int tid = threadIdx.x;
  const int r = tid / TC, cl = tid % TC;
  const float scale = sptr[0];
  const int G = M * (L - 1);
  // per-thread scratch, pair-minor: rows [L-1][G] (band tops, columns 1..G),
  // redge [G] (rows 1..G at column G), lam [G] (adjoint row, columns 1..G)
  const size_t nr = (size_t)gridDim.x * NT;
  const size_t rid = (size_t)blockIdx.x * NT + tid;
  float* rows = scratch + rid;
  float* redge = rows + (size_t)(L - 1) * G * nr;
  float* lamb = redge + (size_t)G * nr;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int I = tiles[2 * t], J = tiles[2 * t + 1];
    __syncthreads();  // the previous tile's partials are written
    for (int e = tid; e < LC * TR; e += NT) {
      const int rr = e / LC, k = e % LC;
      const int a = I * TR + rr;
      xs[k * TR + rr] = a < n ? __fmul_rn(X[(size_t)a * LC + k], scale) : 0.f;
    }
    for (int e = tid; e < LC * TC; e += NT) {
      const int cc = e / LC, k = e % LC;
      const int b = J * TC + cc;
      ys[k * TC + cc] = b < n ? __fmul_rn(X[(size_t)b * LC + k], scale) : 0.f;
    }
    for (int k = 0; k < LC; ++k) dyc[k * NT + tid] = 0.f;
    __syncthreads();

    // Every thread runs the sweeps (a warp takes as long as its busiest
    // thread anyway); a thread without a pair a <= b has seed 0, so its
    // adjoint and gradients are 0, and the row sums below stay convergent.
    const int a = I * TR + r, b = J * TC + cl;
    const bool active = a < n && b < n && a <= b;
    const float sd = active ? (a == b ? 1.f : 2.f) : 0.f;

    // ---- forward: bands of 8 fine rows, bottom-up ----------------------
    float kval = 1.f;
    for (int ci = 0; ci < L - 1; ++ci) {
      float left[M], corner[M];
#pragma unroll
      for (int s = 0; s < M; ++s) {
        left[s] = 1.f;
        corner[s] = 1.f;
      }
      const float* below = ci > 0 ? rows + (size_t)(ci - 1) * G * nr : nullptr;
      float* above = rows + (size_t)ci * G * nr;
      float gd0 = gval<C>(xs, ys, ci, 0, r, cl);
      float gu0 = gval<C>(xs, ys, ci + 1, 0, r, cl);
      for (int cj = 0; cj < L - 1; ++cj) {
        const float gd1 = gval<C>(xs, ys, ci, cj + 1, r, cl);
        const float gu1 = gval<C>(xs, ys, ci + 1, cj + 1, r, cl);
        const Coef k = coef(gu1, gu0, gd1, gd0);
#pragma unroll
        for (int tt = 0; tt < M; ++tt) {
          const size_t j = (size_t)(cj * M + tt);  // node column j+1
          float up = below ? below[j * nr] : 1.f;
#pragma unroll
          for (int s = 0; s < M; ++s) {
            const float kn = __fmaf_rn(__fadd_rn(left[s], up), k.A,
                                       -__fmul_rn(corner[s], k.B));
            corner[s] = up;
            left[s] = kn;
            up = kn;
          }
          above[j * nr] = up;
        }
        gd0 = gd1;
        gu0 = gu1;
      }
#pragma unroll
      for (int s = 0; s < M; ++s) redge[(size_t)(ci * M + s) * nr] = left[s];
      kval = left[M - 1];
    }
    if (active) {
      K[(size_t)a * n + b] = kval;
      K[(size_t)b * n + a] = kval;
    }

    // ---- backward: bands top-down, fine columns right to left ----------
    float carry[C];
#pragma unroll
    for (int c = 0; c < C; ++c) carry[c] = 0.f;
    for (int ci = L - 2; ci >= 0; --ci) {
      const float* top = rows + (size_t)ci * G * nr;  // node row 8ci+8
      const bool topband = ci == L - 2;
      float P[M + 1], Lm[M + 1];  // primal at column j, adjoint at column j+1
      P[0] = ci == 0 ? 1.f : redge[(size_t)(ci * M - 1) * nr];
#pragma unroll
      for (int s = 1; s <= M; ++s) P[s] = redge[(size_t)(ci * M + s - 1) * nr];
#pragma unroll
      for (int s = 0; s <= M; ++s) Lm[s] = 0.f;
      float xu[C], xd[C], sxu[C], sxd[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        xu[c] = xs[((ci + 1) * C + c) * TR + r];
        xd[c] = xs[(ci * C + c) * TR + r];
        sxu[c] = 0.f;
        sxd[c] = 0.f;
      }
      float swu = 0.f, swd = 0.f;
      float gu_r = gval<C>(xs, ys, ci + 1, L - 1, r, cl);
      float gd_r = gval<C>(xs, ys, ci, L - 1, r, cl);
      float Ar = 0.f, Br = 0.f;  // coefficients of coarse column cj+1 (none at the edge)
      float dinc_r = 0.f;        // dinc of coarse column cj+1
      for (int cj = L - 2; cj >= 0; --cj) {
        const float gu_l = gval<C>(xs, ys, ci + 1, cj, r, cl);
        const float gd_l = gval<C>(xs, ys, ci, cj, r, cl);
        const Coef k = coef(gu_r, gu_l, gd_r, gd_l);
        const float Bi = 1.f / k.B;
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int tt = M - 1; tt >= 0; --tt) {
          const int j = cj * M + tt + 1;          // node column, G .. 1
          const float ar = tt == M - 1 ? Ar : k.A;  // cell column j
          const float br = tt == M - 1 ? Br : k.B;
          float* lj = lamb + (size_t)(j - 1) * nr;
          // adjoint of the band's rows at column j
          float Ln[M + 1];
          const float lt = topband ? (j == G ? sd : 0.f) : *lj;
          Ln[M] = fmaf(Lm[M], ar, lt);
#pragma unroll
          for (int s = M - 1; s >= 1; --s)
            Ln[s] = fmaf(Lm[s], ar, Ln[s + 1] * k.A) - Lm[s + 1] * br;
          // partial adjoint of node row 8ci, handed to the band below
          if (ci > 0) *lj = Ln[1] * k.A - Lm[1] * br;
          // primal of column j-1, reconstructed toward -j from column j
          float Pn[M + 1];
          if (j == 1) {
#pragma unroll
            for (int s = 0; s <= M; ++s) Pn[s] = 1.f;
          } else {
            Pn[M] = top[(size_t)(j - 2) * nr];
#pragma unroll
            for (int s = M - 1; s >= 0; --s)
              Pn[s] = ((Pn[s + 1] + P[s]) * k.A - P[s + 1]) * Bi;
            if (ci == 0) Pn[0] = 1.f;
          }
          // dz of cells (s, j-1): weight λ[s+1][j]
#pragma unroll
          for (int s = 0; s < M; ++s) {
            s1 = fmaf(Ln[s + 1], Pn[s + 1] + P[s], s1);
            s2 = fmaf(Ln[s + 1], Pn[s], s2);
          }
#pragma unroll
          for (int s = 0; s <= M; ++s) {
            P[s] = Pn[s];
            Lm[s] = Ln[s];
          }
        }
        const float dinc = ((0.5f + k.z * I6) * s1 + (k.z * I6) * s2) * ZS;
        pull_back<C>(dinc - dinc_r, gu_r, gd_r, ys, dyc, cj + 1, cl, tid, xu, xd,
                     sxu, sxd, swu, swd);
        dinc_r = dinc;
        gu_r = gu_l;
        gd_r = gd_l;
        Ar = k.A;
        Br = k.B;
      }
      pull_back<C>(-dinc_r, gu_r, gd_r, ys, dyc, 0, cl, tid, xu, xd, sxu, sxd, swu,
                   swd);
      // static row ci+1 is complete: its lower-row part came from band ci+1
#pragma unroll
      for (int c = 0; c < C; ++c) {
        row_sum_store(carry[c] + 2.f * (xu[c] * swu - sxu[c]),
                      dxr + ((ci + 1) * C + c) * TR + r, cl);
        carry[c] = 2.f * (xd[c] * swd - sxd[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) row_sum_store(carry[c], dxr + c * TR + r, cl);
    __syncthreads();

    // ---- per-tile partials ------------------------------------------------
    for (int e = tid; e < TR * LC; e += NT) {
      const int rr = e / LC, k = e % LC;
      const int aa = I * TR + rr;
      if (aa < n) rowpart[((size_t)J * n + aa) * LC + k] = dxr[k * TR + rr];
    }
    for (int e = tid; e < TC * LC; e += NT) {
      const int cc = e / LC, k = e % LC;
      const int bb = J * TC + cc;
      if (bb < n) {
        float s = 0.f;
        for (int rr = 0; rr < TR; ++rr) s += dyc[k * NT + rr * TC + cc];
        colpart[((size_t)I * n + bb) * LC + k] = s;
      }
    }
  }
}

// dX[a] = ½·rsqrt(h)·(Σ row partials of a + Σ column partials of a), summed
// over the active tiles in tile order (deterministic).
__global__ void reduce_partials_kernel(const float* __restrict__ rowpart,
                                       const float* __restrict__ colpart,
                                       const float* __restrict__ sptr,
                                       float* __restrict__ dX, int n, int LC,
                                       int nI, int nJ) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * LC) return;
  const int a = idx / LC, k = idx % LC;
  float s = 0.f;
  // row tiles (a/TR, J) are active for J >= (a/TR)·TR / TC
  for (int J = ((a / TR) * TR) / TC; J < nJ; ++J)
    s += rowpart[((size_t)J * n + a) * LC + k];
  // column tiles (I, a/TC) are active for I·TR <= (a/TC)·TC + TC - 1
  const int imax = min(nI - 1, ((a / TC) * TC + TC - 1) / TR);
  for (int I = 0; I <= imax; ++I) s += colpart[((size_t)I * n + a) * LC + k];
  dX[idx] = (0.5f * sptr[0]) * s;
}

template <int C>
cudaError_t grid_blocks(int L, int n_tiles, int* blocks) {
  const size_t smem = smem_bytes(L, C);
  cudaError_t err = cudaFuncSetAttribute(
      block3_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block3_kernel<C>,
                                                      NT, smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = min(per_sm * sms, n_tiles);
  return cudaSuccess;
}

template <int C>
cudaError_t launch(const float* X, const float* s, const int* tiles, int n_tiles,
                   float* K, float* rowpart, float* colpart, float* scratch,
                   int blocks, int n, int L, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, C);
  cudaError_t err = cudaFuncSetAttribute(
      block3_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  block3_kernel<C><<<blocks, NT, smem, stream>>>(X, s, tiles, n_tiles, K, rowpart,
                                                 colpart, scratch, n, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of persistent blocks for a launch: the blocks resident on the
// device at once, at most one per tile. The caller sizes the scratch by it.
int sigkernel_block3_grid(int L, int C, int n_tiles, int* blocks) {
  switch (C) {
    case 1: return (int)grid_blocks<1>(L, n_tiles, blocks);
    case 2: return (int)grid_blocks<2>(L, n_tiles, blocks);
    case 3: return (int)grid_blocks<3>(L, n_tiles, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

// X [n, L, C], s [1] = rsqrt(h), tiles [n_tiles, 2] int32 (I, J) with
// I·8 <= J·16 + 15, K [n, n], dX [n, L, C], rowpart [ceil(n/16), n, L·C],
// colpart [ceil(n/8), n, L·C], scratch [blocks·128·(L+1)·8(L-1)]; fp32,
// contiguous, on the stream's device. Returns cudaGetLastError() after both
// launches (0 on success).
int sigkernel_block3_gram_grad(const float* X, const float* s, const int* tiles,
                               float* K, float* dX, float* rowpart, float* colpart,
                               float* scratch, int n_tiles, int blocks, int n,
                               int L, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 1: err = launch<1>(X, s, tiles, n_tiles, K, rowpart, colpart, scratch, blocks, n, L, st); break;
    case 2: err = launch<2>(X, s, tiles, n_tiles, K, rowpart, colpart, scratch, blocks, n, L, st); break;
    case 3: err = launch<3>(X, s, tiles, n_tiles, K, rowpart, colpart, scratch, blocks, n, L, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int LC = L * C;
  const int total = n * LC;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      rowpart, colpart, s, dX, n, LC, (n + TR - 1) / TR, (n + TC - 1) / TC);
  return (int)cudaGetLastError();
}

}  // extern "C"
