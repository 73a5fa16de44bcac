// λ=3 pair-list signature kernel with the RBF statics computed in the
// kernels: K4 (forward; fp32 backward) and K6 (bf16 delta-form backward).
//
// Replaces the TPU kernels sigsvgd_tpu/kernels/pallas_sigkernel.py::
// _fused_fwd_kernel (with _band_sweep), ::_fused_bwd_kernel (with
// _bwd_rows_fast) and ::_fused_bwd_kernel_bf16 (with _bwd_rows_fast_bf16).
// Contract, as pallas_pair_gram_fused there: for pair p, paths xt[:, :, p]
// [Lx, C] and yt[:, :, p] [Ly, C], already scaled by rsqrt(h), k[p] is the
// dyadic-order-3 Goursat-PDE signature kernel with static kernel
// exp(-|x_a - y_b|^2) on the 8(Lx-1) × 8(Ly-1) fine grid; the backward gives
// the gradients of Σ_p gout[p]·k[p] with respect to both tiles. All arrays
// are pair-minor ([L][C][P], [nslots][G1][P], [lx1][8][P]).
//
// What bounds it on an H100. Every pair sweeps G² = (8·39)² ≈ 97k fine cells
// at the flagship shape (4 fp32 operations each forward, 14 in the fp32
// backward, 12 bf16 in the bf16 one): 2.1e11 operations forward over the
// 524,800 pairs of 1024 paths, against ~5.6 GB of residuals, so the bound is
// the operations (3.3 ms forward at 67 TFLOP/s, 11.3 ms for the fp32
// backward, 5.3 ms for K6's bf16x2 at 134). A pair's fine row (8·ly1+1
// values) fits neither one thread's registers nor, for enough threads,
// shared memory. All three kernels spread it over the registers of a group
// of lanes, the design of K2 and K5 (csrc/sigkernel_block3.cu,
// csrc/sigkernel_tiled.cu):
//   * a lane group per pair (K4) or per pair couple (K6): g lanes (a
//     power of two, the fewest that leave a lane at most 5 coarse columns:
//     8 at ly1 = 39-40, 16 at 48, 1 up to 5) split the ly1 coarse columns
//     into spans [t·ly1/g, (t+1)·ly1/g); a block (4 warps) takes a tile of
//     runs × 128/g pairs (couples), the groups of a warp on adjacent pairs
//     (adjoining couples), and each group walks its run band by band as one
//     pipeline, so lanes idle only at the run's ends. The blocks are
//     persistent over the tiles (kernels/sigkernel_fused.py::fused_plan
//     sizes the runs, tiles and blocks);
//   * forward (K5's pipeline, the statics formed in the kernel): at step k
//     lane t sweeps band k - t of its run over its span, its fine row in
//     registers, and hands its 8 right-edge values and the corner to lane
//     t+1 by __shfl_up_sync. Each lane keeps its span's y points in shared
//     memory (loaded once a pair) and the band's lower static row in
//     registers: the upper row takes one exp a node and becomes the next
//     band's lower row; z, A, B once per coarse cell. At the checkpoint
//     bands (every bpc = min(6, lx1)-th band and the last) each lane writes
//     its span of the band's top row into ck (lane 0 also column 0), and
//     the last lane writes the band's right edge into rc; values only,
//     nothing but k is written;
//   * both backwards run the JAX kernels' order: three chains per fine
//     column, all right to left and top down (the adjoint of the band's 8
//     rows; the primal of the column to the left, rebuilt toward -j from the
//     band's top row and re-anchored at every row's right edge, the top row
//     itself carried from the band above and re-anchored at the checkpoint
//     bands, never recomputed forward; the dz sums). So one pipeline right
//     to left over the group's units (pair or couple, band), bands top down,
//     serves them: lane g-1 takes unit k at step k, lane t unit
//     k - (g-1-t). Each lane owns its span of the band's top-row primal and
//     of the adjoint row handed from band to band, carried in registers, and
//     at its span's left edge hands lane t-1 (__shfl_down_sync) the 8 rows'
//     state at that column, the coefficients or z/2 of the cell to its
//     right, the pull-back's per-pair state and the row-path sums. The
//     checkpoint rows (the lane's span), lane g-1's checkpoint column G and
//     right edges and the x rows are copied a step ahead by cp.async into a
//     per-lane stage in shared memory (the lanes reach a band at different
//     steps, so a load at the unit's start would hold up the warp);
//   * fp32 backward (K4): the exact discrete adjoint in the form of K2's band
//     backward; each lane keeps its span's kb (k[8b+8] at node columns
//     8c0..8c0+8·nspan-1, rebuilt in place into k[8b]), lam (the band
//     above's part of the adjoint of node row 8b+8) and the band's upper
//     static row (one exp a node a band, the lower row carried as the next
//     band's upper) in registers, and hands on the 8 rows' adjoint and 9
//     rows' primal at its left edge, the A and B of the cell to its right
//     and that cell's dz. The fp32 right edges rc[b] start each row;
//   * bf16 backward (K6): the three delta chains (ρ, σ, the dz sum). A
//     register holds one bf16 value of each pair of the couple
//     (add.rn/sub.rn/mul.rn.bf16x2: one rounding per half and operation,
//     never fused, as the scalar twin rounds; Hopper issues them at twice
//     the fp32 rate); each lane's kb,
//     gb (the adjoint row) and the band above's z/2 in bf16x2, the anchor
//     rows rounded to bf16. C ≤ 4, JAX's bf16 envelope;
//   * both backwards pull dz back through the statics per coarse column, a
//     lane through its own cells: the column-path gradient of the node
//     columns it owns (inside and at the right edge of its span, lane 0
//     also column 0) in its shared-memory slots, written once a pair; the
//     row-path sums in registers, handed on with the pipeline (lane 0
//     writes the band's upper row). No atomics; dx and dy are
//     deterministic.
// No kernel sends a fine row, a band top, a right edge, an adjoint row or a
// scratch row through device memory: the paths, k, the residuals and the
// gradients are their only traffic. Each node keeps the twin's rounding
// where the twin fixes it (the forward's product by A fused into its
// subtraction; K6's bf16 order), so k and the residuals are the twin's on
// the card up to the exp. The fp32 backward's rounding is pinned by
// intrinsics (tests/test_torch_fused_schedule.py models it); its rebuild
// toward -j drifts from the exact grid by rounding alone, as the JAX
// kernel's does, within K2's tolerance at every shape tested.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int M = 8;      // fine cells per coarse cell side (2^λ)
constexpr int NT = 128;   // threads per block of every kernel here
constexpr unsigned FULL = 0xffffffffu;
constexpr float ZS = 1.0f / 64.0f;
constexpr float I6 = 1.0f / 6.0f;
constexpr float I12 = 1.0f / 12.0f;

// Path point q of a pair-minor tile t [L][C][P].
template <int C>
__device__ __forceinline__ void load_pt(const float* __restrict__ t, int q, size_t P,
                                        size_t p, float (&v)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = t[((size_t)q * C + c) * P + p];
}

// Static node exp(-Σ_c (x_c - y_c)^2), rounded as the twin rounds it.
template <int C>
__device__ __forceinline__ float gval(const float (&x)[C], const float (&y)[C]) {
  float d2 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float d = __fsub_rn(x[c], y[c]);
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

// A lane's place in its group: position t, the group's index in the block,
// and its span of coarse columns [c0, c0 + nspan).
struct Lanes {
  int t, gi, c0, nspan;
};

__device__ __forceinline__ Lanes lanes(int g, int ly1) {
  Lanes L;
  const int tid = threadIdx.x;
  L.t = (tid & 31) & (g - 1);
  L.gi = tid / g;
  L.c0 = (L.t * ly1) / g;
  L.nspan = ((L.t + 1) * ly1) / g - L.c0;
  return L;
}

// Bands whose top row is a checkpoint: every bpc-th and the last.
__device__ __forceinline__ bool ck_band(int b, int lx1, int bpc) {
  return (b + 1) % bpc == 0 || b == lx1 - 1;
}

// ---- K4 forward ---------------------------------------------------------------
// Shared memory: per thread the y points of its span, [(SPAN+1)·C][NT].
__host__ __device__ inline size_t fwd_smem_floats(int span, int C) {
  return (size_t)(span + 1) * C * NT;
}

template <int SPAN, int C>
__global__ void __launch_bounds__(NT, C <= 4 ? 4 : 3)
fused_fwd_lanes_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                 float* __restrict__ kout, float* __restrict__ ck, float* __restrict__ rc,
                 int P_, int lx1, int ly1, int g, int bpc, int runs, int tiles) {
  extern __shared__ float smem[];
  const size_t P = P_;
  const Lanes L = lanes(g, ly1);
  const int t = L.t, nspan = L.nspan, c0 = L.c0;
  const int NG = NT / g;
  const int U = runs * lx1, steps = U + g - 1;
  const size_t G1 = (size_t)M * ly1 + 1;
  float* ys = smem + threadIdx.x;  // [(SPAN+1)·C][NT]

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t pbase = (size_t)tile * runs * NG + L.gi;
    float row[M * SPAN];  // the span's node row below the band, then its top
    float gd[SPAN + 1];   // the band's lower static row at node columns c0..
    float left[M], corner[M], inL[M], inC = 1.f, edge = 1.f, xn[C];
#pragma unroll
    for (int s = 0; s < M; ++s) left[s] = corner[s] = inL[s] = 1.f;
#pragma unroll
    for (int i = 0; i < M * SPAN; ++i) row[i] = 1.f;
#pragma unroll
    for (int q = 0; q <= SPAN; ++q) gd[q] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) xn[c] = 0.f;
    // unit u of the run: pair pbase + (u / lx1)·NG, band u % lx1 (bottom up);
    // x row b+1 of a unit is loaded a step ahead
    auto prefetch = [&](int u) {
      if (u < 0 || u >= U) return;
      const int r = u / lx1;
      const size_t p = pbase + (size_t)r * NG;
      if (p < P) load_pt<C>(xt, u - r * lx1 + 1, P, p, xn);
    };
    prefetch(-t);
    for (int k = 0; k < steps; ++k) {
      const int u = k - t;
      float xu[C];
#pragma unroll
      for (int c = 0; c < C; ++c) xu[c] = xn[c];
      prefetch(u + 1);
      if (u >= 0 && u < U) {
        const int r = u / lx1, b = u - r * lx1;
        const size_t p = pbase + (size_t)r * NG;
        if (p < P) {
          if (b == 0) {  // a pair's start: its y points and static row 0
            float xd[C];
            load_pt<C>(xt, 0, P, p, xd);
#pragma unroll
            for (int i = 0; i < M * SPAN; ++i) row[i] = 1.f;
            edge = 1.f;
#pragma unroll
            for (int q = 0; q <= SPAN; ++q) {
              if (q <= nspan) {
                float yq[C];
#pragma unroll
                for (int c = 0; c < C; ++c) {
                  yq[c] = yt[((size_t)(c0 + q) * C + c) * P + p];
                  ys[(q * C + c) * NT] = yq[c];
                }
                gd[q] = gval<C>(xd, yq);
              }
            }
          }
          // the carries at node column 8c0, from lane t-1 (1 on the boundary)
#pragma unroll
          for (int s = 0; s < M; ++s) {
            corner[s] = t == 0 ? 1.f : (s == 0 ? inC : inL[s - 1]);
            left[s] = t == 0 ? 1.f : inL[s];
          }
          const bool keep = ck != nullptr && ck_band(b, lx1, bpc);
          float* dst = keep ? ck + (size_t)(b / bpc) * G1 * P + p : nullptr;
          if (keep && t == 0) dst[0] = 1.f;  // node column 0
          float gu0;
          {
            float yq[C];
#pragma unroll
            for (int c = 0; c < C; ++c) yq[c] = ys[c * NT];
            gu0 = gval<C>(xu, yq);
          }
#pragma unroll
          for (int kk = 0; kk < SPAN; ++kk) {
            if (kk < nspan) {
              float yq[C];
#pragma unroll
              for (int c = 0; c < C; ++c) yq[c] = ys[((kk + 1) * C + c) * NT];
              const float gu1 = gval<C>(xu, yq);
              const Coef q = coef(gu1, gu0, gd[kk + 1], gd[kk]);
              // the upper static row becomes the next band's lower row
              gd[kk] = gu0;
              if (kk + 1 == nspan) gd[kk + 1] = gu1;
              gu0 = gu1;
#pragma unroll
              for (int tt = 0; tt < M; ++tt) {
                float up = row[kk * M + tt];
#pragma unroll
                for (int s = 0; s < M; ++s) {
                  const float kn =
                      __fmaf_rn(__fadd_rn(left[s], up), q.A, -__fmul_rn(corner[s], q.B));
                  corner[s] = up;
                  left[s] = kn;
                  up = kn;
                }
                row[kk * M + tt] = up;
              }
              if (keep) {  // the band's top row at node columns 8cj+1 .. 8cj+8
#pragma unroll
                for (int tt = 0; tt < M; ++tt)
                  dst[(size_t)(1 + M * (c0 + kk) + tt) * P] = row[kk * M + tt];
              }
            }
          }
          if (t == g - 1) {  // the right edge: rc[b, s] = k[8b+s][G]
            if (rc != nullptr) {
              float* e = rc + (size_t)b * M * P + p;
              e[0] = edge;
#pragma unroll
              for (int s = 1; s < M; ++s) e[s * P] = left[s - 1];
            }
            edge = left[M - 1];
            if (b == lx1 - 1) kout[p] = left[M - 1];
          }
        }
      }
      inC = __shfl_up_sync(FULL, corner[0], 1, g);
#pragma unroll
      for (int s = 0; s < M; ++s) inL[s] = __shfl_up_sync(FULL, left[s], 1, g);
    }
  }
}

// Pull one adjoint increment E back through static column q of the band's
// two static rows: dg = +E on the upper row (x row xu), -E on the lower.
// dyq[c·ds] accumulates the column-path gradient of node q.
template <int C>
__device__ __forceinline__ void pull_back(float E, float gu, float gd, const float (&yq)[C],
                                          float* dyq, size_t ds, const float (&xu)[C],
                                          const float (&xd)[C], float (&sxu)[C],
                                          float (&sxd)[C], float& swu, float& swd) {
  const float wu = -gu * E;  // ∂/∂d² of the upper node
  const float wd = gd * E;   // ∂/∂d² of the lower node
  swu += wu;
  swd += wd;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float yv = yq[c];
    sxu[c] = fmaf(wu, yv, sxu[c]);
    sxd[c] = fmaf(wd, yv, sxd[c]);
    dyq[c * ds] += 2.f * ((yv - xu[c]) * wu + (yv - xd[c]) * wd);
  }
}

// The row-path gradient of static row b+1 (complete: its lower-row part came
// from band b+1 as `carry`) and the lower part of row b.
template <int C>
__device__ __forceinline__ void store_rows(float* __restrict__ dxt, int b, size_t P,
                                           size_t p, const float (&xu)[C],
                                           const float (&xd)[C], const float (&sxu)[C],
                                           const float (&sxd)[C], float swu, float swd,
                                           float (&carry)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    dxt[((size_t)(b + 1) * C + c) * P + p] = carry[c] + 2.f * (xu[c] * swu - sxu[c]);
    carry[c] = 2.f * (xd[c] * swd - sxd[c]);
  }
}

// Static row 0's row-path gradient: only band 0's lower-row part.
template <int C>
__device__ __forceinline__ void store_row0(float* __restrict__ dxt, size_t P, size_t p,
                                           const float (&carry)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) dxt[(size_t)c * P + p] = carry[c];
}

// ---- K6: bf16 delta-form backward, a lane group per pair couple ------------
// A register holds one bf16 value of each of the couple's pairs (low half:
// pair 2q, high half: pair 2q+1); add.rn/sub.rn/mul.rn.bf16x2 round each
// half once, as the scalar twin does.
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  unsigned r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ unsigned sub2(unsigned a, unsigned b) {
  unsigned r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ unsigned mul2(unsigned a, unsigned b) {
  unsigned r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// Round (a, b) to bf16 into one register (a in the low half).
__device__ __forceinline__ unsigned pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float half2f(unsigned u, int i) {
  return __uint_as_float(i == 0 ? u << 16 : u & 0xffff0000u);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of a K6 block in floats, per thread (thread-minor, [i][NT]):
// the y points of its span and their column-path gradients, [(SPAN+1)·C·2]
// each (node, channel, pair); the stage the next unit's inputs are copied
// into: its anchor row [8·SPAN][2], the checkpoint's node column G [2] and
// the right edges rc[b] [8][2] (lane g-1), x rows b+1 and b [2][C][2].
__host__ __device__ inline int bf16_thread_floats(int span, int C) {
  return 4 * (span + 1) * C + 16 * span + 2 + 16 + 4 * C;
}

template <int SPAN, int C>
__global__ void __launch_bounds__(NT, 2)
fused_bwd_bf16_lanes_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                      const float* __restrict__ ck, const float* __restrict__ rc,
                      const float* __restrict__ gout, float* __restrict__ dxt,
                      float* __restrict__ dyt, int P_, int lx1, int ly1, int g, int bpc,
                      int runs, int tiles) {
  extern __shared__ float smem[];
  constexpr int YN = (SPAN + 1) * C * 2;
  const size_t P = P_;
  const size_t Q = (P + 1) / 2;  // pair couples (2q, 2q+1)
  const Lanes L = lanes(g, ly1);
  const int t = L.t, nspan = L.nspan, c0 = L.c0;
  const bool last = t == g - 1;
  const int NG = NT / g;
  const int U = runs * lx1, steps = U + g - 1;
  const int G = M * ly1;
  const size_t G1 = (size_t)G + 1;
  float* ys = smem + threadIdx.x;      // [(SPAN+1)][C][2]
  float* dys = ys + YN * NT;           // [(SPAN+1)][C][2]
  float* stk = dys + YN * NT;          // [8·SPAN][2]
  float* stg = stk + 16 * SPAN * NT;   // [2]
  float* str = stg + 2 * NT;           // [8][2]
  float* stx = str + 16 * NT;          // [2][C][2]

#pragma unroll
  for (int i = 0; i < YN; ++i) dys[i * NT] = 0.f;
  // the lane's own rows (bf16x2, one half a pair): the band's top-row primal
  // kb[8c0 + i] (then its bottom row), the adjoint row gb[8c0 + 1 + i], the
  // band above's z/2 zhu[c0 + i]; lane g-1 also k[8b+8][G]
  unsigned kb[M * SPAN], gb[M * SPAN], zhu[SPAN], kbG = 0u;
#pragma unroll
  for (int i = 0; i < M * SPAN; ++i) kb[i] = gb[i] = 0u;
#pragma unroll
  for (int i = 0; i < SPAN; ++i) zhu[i] = 0u;
  // the pipeline's state, handed to lane t-1 at the span's left edge: per row
  // r (node row i = 8b+8-r) ρ, σ and the row's outputs at the previous
  // column, k[i-1][j+1] and ĝ[i][j+2]; row 0's inputs k[8b+8][j+1],
  // ĝ[8b+9][j+2]; z/2 of the cell to the right; per pair the dz, statics and
  // row-path sums of the pull-back
  unsigned rho[M], sig[M], pK[M], pG[M], k0r = 0u, g0r = 0u, zh_r = 0u;
  float dz_r[2], gu_r[2], gd_r[2], swu[2], swd[2], sxu[2][C], sxd[2][C], carry[2][C];
#pragma unroll
  for (int r = 0; r < M; ++r) rho[r] = sig[r] = pK[r] = pG[r] = 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dz_r[i] = gu_r[i] = gd_r[i] = swu[i] = swd[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) sxu[i][c] = sxd[i][c] = carry[i][c] = 0.f;
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t qbase = (size_t)tile * runs * NG + L.gi;
    // unit u of the run: couple qbase + (u / lx1)·NG, band lx1-1 - u % lx1.
    // Copy its inputs into the stage asynchronously (cp.async); the thread's
    // own earlier reads of the stage are emitted before the copies (a
    // compiler barrier: the copy instructions do not tell the compiler that
    // they write shared memory).
    auto fetch = [&](int u) {
      asm volatile("" ::: "memory");
      if (u < 0 || u >= U) return;
      const int r = u / lx1, b = lx1 - 1 - (u - r * lx1);
      const size_t q = qbase + (size_t)r * NG;
      if (q >= Q) return;
      const size_t pp[2] = {2 * q, 2 * q + 1 < P ? 2 * q + 1 : 2 * q};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          cp_async4(stx + (c * 2 + i) * NT, xt + ((size_t)(b + 1) * C + c) * P + pp[i]);
          cp_async4(stx + ((C + c) * 2 + i) * NT, xt + ((size_t)b * C + c) * P + pp[i]);
        }
      }
      if (ck_band(b, lx1, bpc)) {
        const float* row = ck + (size_t)(b / bpc) * G1 * P;
#pragma unroll
        for (int j = 0; j < M * SPAN; ++j) {
          if (j < M * nspan) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
              cp_async4(stk + (2 * j + i) * NT, row + (size_t)(M * c0 + j) * P + pp[i]);
          }
        }
        if (last) {
#pragma unroll
          for (int i = 0; i < 2; ++i) cp_async4(stg + i * NT, row + (size_t)G * P + pp[i]);
        }
      }
      if (last) {
#pragma unroll
        for (int s = 0; s < M; ++s) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            cp_async4(str + (2 * s + i) * NT, rc + ((size_t)b * M + s) * P + pp[i]);
        }
      }
    };
    fetch(-(g - 1 - t));
    cp_async_commit();

    for (int k = 0; k < steps; ++k) {
      cp_async_wait_all();
      const int u = k - (g - 1 - t);
      int b = 0;
      size_t q = 0;
      bool mine = false;
      if (u >= 0 && u < U) {
        const int r = u / lx1;
        b = lx1 - 1 - (u - r * lx1);
        q = qbase + (size_t)r * NG;
        mine = q < Q;
      }
      const bool has_b = 2 * q + 1 < P;
      const size_t pp[2] = {2 * q, has_b ? 2 * q + 1 : 2 * q};
      const bool topband = b == lx1 - 1;
      float xu[2][C], xd[2][C];
      unsigned seed = 0u;
      if (mine) {  // the unit's inputs, from the stage
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            xu[i][c] = stx[(c * 2 + i) * NT];
            xd[i][c] = stx[((C + c) * 2 + i) * NT];
          }
        }
        const bool anchored = ck_band(b, lx1, bpc);
        if (anchored) {  // the lane's span of the bf16-rounded checkpoint row
#pragma unroll
          for (int j = 0; j < M * SPAN; ++j)
            if (j < M * nspan) kb[j] = pack2(stk[2 * j * NT], stk[(2 * j + 1) * NT]);
        }
        if (topband) {  // a couple's first unit: the y points of the span
#pragma unroll
          for (int s = 0; s <= SPAN; ++s) {
            if (s <= nspan) {
#pragma unroll
              for (int c = 0; c < C; ++c) {
#pragma unroll
                for (int i = 0; i < 2; ++i)
                  ys[((s * C + c) * 2 + i) * NT] = yt[((size_t)(c0 + s) * C + c) * P + pp[i]];
              }
            }
          }
          if (last) seed = pack2(gout[pp[0]], has_b ? gout[pp[1]] : 0.f);
        }
        if (last) {  // the pipeline's start at the fp32 right edge
          unsigned kr0[M];  // k[8b+7-r][G]
#pragma unroll
          for (int r = 0; r < M; ++r)
            kr0[r] = pack2(str[2 * (M - 1 - r) * NT], str[(2 * (M - 1 - r) + 1) * NT]);
          k0r = anchored ? pack2(stg[0], stg[NT]) : kbG;
          g0r = 0u;  // ĝ of the row above at node G+1
#pragma unroll
          for (int r = 0; r < M; ++r) {
            sig[r] = sub2(kr0[r], r == 0 ? k0r : kr0[r > 0 ? r - 1 : 0]);
            rho[r] = 0u;
            pK[r] = kr0[r];
            pG[r] = 0u;
          }
          kbG = kr0[M - 1];  // k[8b][G], the next band's top edge
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float yr[C];
#pragma unroll
            for (int c = 0; c < C; ++c) yr[c] = ys[((nspan * C + c) * 2 + i) * NT];
            gu_r[i] = gval<C>(xu[i], yr);
            gd_r[i] = gval<C>(xd[i], yr);
            dz_r[i] = swu[i] = swd[i] = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) sxu[i][c] = sxd[i][c] = 0.f;
          }
        }
      }
      fetch(u + 1);
      cp_async_commit();

      if (mine) {
#pragma unroll
        for (int kk = SPAN - 1; kk >= 0; --kk) {
          if (kk < nspan) {
            const int cc = c0 + kk;
            float gu_l[2], gd_l[2], zf[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float yl[C];
#pragma unroll
              for (int c = 0; c < C; ++c) yl[c] = ys[((kk * C + c) * 2 + i) * NT];
              gu_l[i] = gval<C>(xu[i], yl);
              gd_l[i] = gval<C>(xd[i], yl);
              zf[i] = __fmul_rn(coef(gu_r[i], gu_l[i], gd_r[i], gd_l[i]).z, 0.5f);
            }
            const unsigned zc = pack2(zf[0], zf[1]);
            const unsigned zr = cc == ly1 - 1 ? zc : zh_r;  // z/2 of cell min(cc+1, ly1-1)
            const unsigned zu = zhu[kk];  // the band above's (0 at the top band)
            zhu[kk] = zc;
            unsigned s1[M];
#pragma unroll
            for (int tt = M - 1; tt >= 0; --tt) {
              const int jn = cc * M + tt;  // node column of the rebuilt primal
              // row 0's inputs: k[8b+8][jn], ĝ[8b+9][jn+1] and, from the
              // previous column, k[8b+8][jn+1], ĝ[8b+9][jn+2]
              unsigned kin = kb[kk * M + tt], gin = gb[kk * M + tt];
              unsigned kin_r = k0r, gin_r = g0r;
              k0r = kin;
              g0r = gin;
              const unsigned z1 = tt == M - 1 ? zr : zc;
#pragma unroll
              for (int r = 0; r < M; ++r) {
                // adjoint delta ρ[j] = ρ[j+1] + z1·ĝ[i+1][j+1] + zu·ĝ[i+1][j]
                rho[r] = add2(add2(rho[r], mul2(z1, gin_r)), mul2(r == 0 ? zu : zc, gin));
                if (r == 0 && topband && jn == G - 1) rho[r] = add2(rho[r], seed);
                const unsigned gg = add2(gin, rho[r]);
                // primal delta and the dz term (m1 takes the incoming σ)
                const unsigned s = add2(kin, kin_r);
                const unsigned m1 = add2(s, sig[r]);
                s1[r] = tt == M - 1 ? mul2(gg, m1) : add2(s1[r], mul2(gg, m1));
                sig[r] = add2(sig[r], mul2(zc, s));
                if (jn == 0) sig[r] = 0u;  // the left boundary is one
                const unsigned kus = add2(kin, sig[r]);
                // row r+1's inputs
                kin_r = pK[r];
                gin_r = pG[r];
                pK[r] = kus;
                pG[r] = gg;
                kin = kus;
                gin = gg;
              }
              kb[kk * M + tt] = kin;  // k[8b][jn]
              gb[kk * M + tt] = gin;  // ĝ[8b+1][jn+1]
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float dz = __fmul_rn(half2f(s1[0], i), 0.5f);
#pragma unroll
              for (int r = 1; r < M; ++r) dz = __fadd_rn(dz, __fmul_rn(half2f(s1[r], i), 0.5f));
              float yr[C];
#pragma unroll
              for (int c = 0; c < C; ++c) yr[c] = ys[(((kk + 1) * C + c) * 2 + i) * NT];
              pull_back<C>(__fmul_rn(__fsub_rn(dz, dz_r[i]), ZS), gu_r[i], gd_r[i], yr,
                           dys + ((kk + 1) * C * 2 + i) * NT, 2 * NT, xu[i], xd[i], sxu[i],
                           sxd[i], swu[i], swd[i]);
              dz_r[i] = dz;
              gu_r[i] = gu_l[i];
              gd_r[i] = gd_l[i];
            }
            zh_r = zc;
          }
        }
        if (t == 0) {  // node column 0 and the band's row-path gradients
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float y0[C];
#pragma unroll
            for (int c = 0; c < C; ++c) y0[c] = ys[(c * 2 + i) * NT];
            pull_back<C>(__fmul_rn(-dz_r[i], ZS), gu_r[i], gd_r[i], y0, dys + i * NT, 2 * NT,
                         xu[i], xd[i], sxu[i], sxd[i], swu[i], swd[i]);
            if (i == 0 || has_b) {
              store_rows<C>(dxt, b, P, pp[i], xu[i], xd[i], sxu[i], sxd[i], swu[i], swd[i],
                            carry[i]);
              if (b == 0) store_row0<C>(dxt, P, pp[i], carry[i]);
            }
          }
        }
        if (b == 0) {  // the couple's end: its column-path gradients, and a clean slate
#pragma unroll
          for (int s = 0; s <= SPAN; ++s) {
            if ((s > 0 || t == 0) && s <= nspan) {
#pragma unroll
              for (int c = 0; c < C; ++c) {
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                  if (i == 0 || has_b)
                    dyt[((size_t)(c0 + s) * C + c) * P + pp[i]] = dys[((s * C + c) * 2 + i) * NT];
                }
              }
            }
          }
#pragma unroll
          for (int i = 0; i < YN; ++i) dys[i * NT] = 0.f;
#pragma unroll
          for (int i = 0; i < M * SPAN; ++i) gb[i] = 0u;
#pragma unroll
          for (int i = 0; i < SPAN; ++i) zhu[i] = 0u;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int c = 0; c < C; ++c) carry[i][c] = 0.f;
          }
        }
      }

      // ---- the hand-off to lane t-1
#pragma unroll
      for (int r = 0; r < M; ++r) {
        rho[r] = __shfl_down_sync(FULL, rho[r], 1, g);
        sig[r] = __shfl_down_sync(FULL, sig[r], 1, g);
        pK[r] = __shfl_down_sync(FULL, pK[r], 1, g);
        pG[r] = __shfl_down_sync(FULL, pG[r], 1, g);
      }
      k0r = __shfl_down_sync(FULL, k0r, 1, g);
      g0r = __shfl_down_sync(FULL, g0r, 1, g);
      zh_r = __shfl_down_sync(FULL, zh_r, 1, g);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dz_r[i] = __shfl_down_sync(FULL, dz_r[i], 1, g);
        gu_r[i] = __shfl_down_sync(FULL, gu_r[i], 1, g);
        gd_r[i] = __shfl_down_sync(FULL, gd_r[i], 1, g);
        swu[i] = __shfl_down_sync(FULL, swu[i], 1, g);
        swd[i] = __shfl_down_sync(FULL, swd[i], 1, g);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          sxu[i][c] = __shfl_down_sync(FULL, sxu[i][c], 1, g);
          sxd[i][c] = __shfl_down_sync(FULL, sxd[i][c], 1, g);
        }
      }
    }
  }
}

// ---- K4 backward: fp32, a lane group per pair --------------------------------
// Shared memory of a K4 backward block in floats, per thread (thread-minor,
// [i][NT]): the y points of its span and their column-path gradients,
// [(SPAN+1)·C] each; the stage the next unit's inputs are copied into: its
// anchor row [8·SPAN], the checkpoint's node column G [1] and the right
// edges rc[b] [8] (lane g-1), x rows b+1 and b [2][C].
__host__ __device__ inline int bwd_thread_floats(int span, int C) {
  return 2 * (span + 1) * C + M * span + 1 + M + 2 * C;
}

template <int SPAN, int C>
__global__ void __launch_bounds__(NT, 2)
fused_bwd_lanes_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                       const float* __restrict__ ck, const float* __restrict__ rc,
                       const float* __restrict__ gout, float* __restrict__ dxt,
                       float* __restrict__ dyt, int P_, int lx1, int ly1, int g, int bpc,
                       int runs, int tiles) {
  extern __shared__ float smem[];
  constexpr int YN = (SPAN + 1) * C;
  const size_t P = P_;
  const Lanes L = lanes(g, ly1);
  const int t = L.t, nspan = L.nspan, c0 = L.c0;
  const bool last = t == g - 1;
  const int NG = NT / g;
  const int U = runs * lx1, steps = U + g - 1;
  const int G = M * ly1;
  const size_t G1 = (size_t)G + 1;
  float* ys = smem + threadIdx.x;    // [SPAN+1][C]
  float* dys = ys + YN * NT;         // [SPAN+1][C]
  float* stk = dys + YN * NT;        // [8·SPAN]
  float* stg = stk + M * SPAN * NT;  // [1]
  float* str = stg + NT;             // [8]
  float* stx = str + M * NT;         // [2][C]

#pragma unroll
  for (int i = 0; i < YN; ++i) dys[i * NT] = 0.f;
  // the lane's own rows: the band's top-row primal kb[i] = k[8b+8][8c0+i]
  // (rebuilt toward -j into k[8b][8c0+i], the next band's top row), the
  // band above's part of the adjoint of node row 8b+8, lam[i] at node column
  // 8c0+1+i, and the band's upper static row gs[q] at node column c0+q;
  // lane g-1 also k[8b+8][G]
  float kb[M * SPAN], lam[M * SPAN], gs[SPAN + 1], kbG = 0.f;
#pragma unroll
  for (int i = 0; i < M * SPAN; ++i) kb[i] = lam[i] = 0.f;
#pragma unroll
  for (int q = 0; q <= SPAN; ++q) gs[q] = 0.f;
  // the pipeline's state, handed to lane t-1 at the span's left edge: the
  // adjoint of node rows 8b+s (s = 1..8) at the last column done, lm[s], the
  // primal of rows 8b+s (s = 0..8) at the column left of it, pv[s], the
  // coarse cell to the right's A, B and dz·ZS, and the row-path sums
  float lm[M + 1], pv[M + 1], Ar = 0.f, Br = 0.f, dinc_r = 0.f, swu = 0.f, swd = 0.f;
  float sxu[C], sxd[C], carry[C];
#pragma unroll
  for (int s = 0; s <= M; ++s) lm[s] = pv[s] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) sxu[c] = sxd[c] = carry[c] = 0.f;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t pbase = (size_t)tile * runs * NG + L.gi;
    // unit u of the run: pair pbase + (u / lx1)·NG, band lx1-1 - u % lx1.
    // Copy its inputs into the stage asynchronously (cp.async), behind a
    // compiler barrier: the thread's own earlier reads of the stage must not
    // move past the copies, which the compiler does not see write it.
    auto fetch = [&](int u) {
      asm volatile("" ::: "memory");
      if (u < 0 || u >= U) return;
      const int r = u / lx1, b = lx1 - 1 - (u - r * lx1);
      const size_t p = pbase + (size_t)r * NG;
      if (p >= P) return;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        cp_async4(stx + c * NT, xt + ((size_t)(b + 1) * C + c) * P + p);
        cp_async4(stx + (C + c) * NT, xt + ((size_t)b * C + c) * P + p);
      }
      if (ck_band(b, lx1, bpc)) {
        const float* row = ck + (size_t)(b / bpc) * G1 * P + p;
#pragma unroll
        for (int j = 0; j < M * SPAN; ++j)
          if (j < M * nspan) cp_async4(stk + j * NT, row + (size_t)(M * c0 + j) * P);
        if (last) cp_async4(stg, row + (size_t)G * P);
      }
      if (last) {
#pragma unroll
        for (int s = 0; s < M; ++s) cp_async4(str + s * NT, rc + ((size_t)b * M + s) * P + p);
      }
    };
    fetch(-(g - 1 - t));
    cp_async_commit();

    for (int k = 0; k < steps; ++k) {
      cp_async_wait_all();
      const int u = k - (g - 1 - t);
      int b = 0;
      size_t p = 0;
      bool mine = false;
      if (u >= 0 && u < U) {
        const int r = u / lx1;
        b = lx1 - 1 - (u - r * lx1);
        p = pbase + (size_t)r * NG;
        mine = p < P;
      }
      const bool topband = b == lx1 - 1;
      float xu[C], xd[C], gd[SPAN + 1], sd = 0.f;
      if (mine) {  // the unit's inputs, from the stage
#pragma unroll
        for (int c = 0; c < C; ++c) {
          xu[c] = stx[c * NT];
          xd[c] = stx[(C + c) * NT];
        }
        const bool anchored = ck_band(b, lx1, bpc);
        if (anchored) {  // the lane's span of the checkpoint row
#pragma unroll
          for (int j = 0; j < M * SPAN; ++j)
            if (j < M * nspan) kb[j] = stk[j * NT];
        }
        if (topband) {  // a pair's first unit: the span's y points, static row lx1
#pragma unroll
          for (int q = 0; q <= SPAN; ++q) {
            if (q <= nspan) {
              float yq[C];
#pragma unroll
              for (int c = 0; c < C; ++c) {
                yq[c] = yt[((size_t)(c0 + q) * C + c) * P + p];
                ys[(q * C + c) * NT] = yq[c];
              }
              gs[q] = gval<C>(xu, yq);
            }
          }
          if (last) sd = gout[p];
        }
        // the band's lower static row: one exp a node
#pragma unroll
        for (int q = 0; q <= SPAN; ++q) {
          if (q <= nspan) {
            float yq[C];
#pragma unroll
            for (int c = 0; c < C; ++c) yq[c] = ys[(q * C + c) * NT];
            gd[q] = gval<C>(xd, yq);
          }
        }
        if (last) {  // the pipeline's start at the right edge: rc[b] and k[8b+8][G]
#pragma unroll
          for (int s = 0; s < M; ++s) pv[s] = str[s * NT];
          pv[M] = anchored ? stg[0] : kbG;
          kbG = pv[0];  // k[8b][G], the next band's
#pragma unroll
          for (int s = 0; s <= M; ++s) lm[s] = 0.f;
          Ar = Br = dinc_r = swu = swd = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) sxu[c] = sxd[c] = 0.f;
        }
      }
      fetch(u + 1);
      cp_async_commit();

      if (mine) {
#pragma unroll
        for (int kk = SPAN - 1; kk >= 0; --kk) {
          if (kk < nspan) {
            const Coef q = coef(gs[kk + 1], gs[kk], gd[kk + 1], gd[kk]);
            const float Bi = __frcp_rn(q.B);
            float s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int tt = M - 1; tt >= 0; --tt) {
              const int i = kk * M + tt;     // node column j = 8c0 + 1 + i
              const float ar = tt == M - 1 ? Ar : q.A;  // cell column j
              const float br = tt == M - 1 ? Br : q.B;
              // the adjoint of rows 8b+s at column j
              float ln[M + 1];
              const float lt = topband ? (c0 * M + 1 + i == G ? sd : 0.f) : lam[i];
              ln[M] = __fmaf_rn(lm[M], ar, lt);
#pragma unroll
              for (int s = M - 1; s >= 1; --s)
                ln[s] = __fmaf_rn(lm[s], ar, __fmaf_rn(ln[s + 1], q.A, -__fmul_rn(lm[s + 1], br)));
              // its part of row 8b's adjoint, handed to the band below in place
              if (b > 0) lam[i] = __fmaf_rn(ln[1], q.A, -__fmul_rn(lm[1], br));
              // the primal of column j-1, rebuilt toward -j from column j
              float pn[M + 1], h[M];
              pn[M] = kb[i];
#pragma unroll
              for (int s = M - 1; s >= 0; --s) {
                h[s] = __fadd_rn(pn[s + 1], pv[s]);
                pn[s] = __fmul_rn(__fmaf_rn(h[s], q.A, -pv[s + 1]), Bi);
              }
              if (b == 0) pn[0] = 1.f;  // node row 0 is one
              if (c0 + kk == 0 && tt == 0) {  // and node column 0
#pragma unroll
                for (int s = M - 1; s >= 0; --s) {
                  pn[s + 1] = 1.f;
                  h[s] = __fadd_rn(1.f, pv[s]);
                }
                pn[0] = 1.f;
              }
              kb[i] = pn[0];
              // dz of cells (8b+s, j-1): weight λ[8b+s+1][j]
#pragma unroll
              for (int s = 0; s < M; ++s) {
                s1 = __fmaf_rn(ln[s + 1], h[s], s1);
                s2 = __fmaf_rn(ln[s + 1], pn[s], s2);
              }
#pragma unroll
              for (int s = 0; s <= M; ++s) {
                pv[s] = pn[s];
                if (s > 0) lm[s] = ln[s];
              }
            }
            const float t1 = __fmul_rn(q.z, I6);
            const float dinc = __fmul_rn(__fmaf_rn(__fadd_rn(0.5f, t1), s1, __fmul_rn(t1, s2)), ZS);
            float yq[C];
#pragma unroll
            for (int c = 0; c < C; ++c) yq[c] = ys[((kk + 1) * C + c) * NT];
            pull_back<C>(__fsub_rn(dinc, dinc_r), gs[kk + 1], gd[kk + 1], yq,
                         dys + (kk + 1) * C * NT, NT, xu, xd, sxu, sxd, swu, swd);
            dinc_r = dinc;
            Ar = q.A;
            Br = q.B;
          }
        }
        if (t == 0) {  // node column 0 and the band's row-path gradients
          float y0[C];
#pragma unroll
          for (int c = 0; c < C; ++c) y0[c] = ys[c * NT];
          pull_back<C>(-dinc_r, gs[0], gd[0], y0, dys, NT, xu, xd, sxu, sxd, swu, swd);
          store_rows<C>(dxt, b, P, p, xu, xd, sxu, sxd, swu, swd, carry);
          if (b == 0) store_row0<C>(dxt, P, p, carry);
        }
#pragma unroll
        for (int q = 0; q <= SPAN; ++q)
          if (q <= nspan) gs[q] = gd[q];  // the next band's upper row
        if (b == 0) {  // the pair's end: its column-path gradients, and a clean slate
#pragma unroll
          for (int q = 0; q <= SPAN; ++q) {
            if ((q > 0 || t == 0) && q <= nspan) {
#pragma unroll
              for (int c = 0; c < C; ++c)
                dyt[((size_t)(c0 + q) * C + c) * P + p] = dys[(q * C + c) * NT];
            }
          }
#pragma unroll
          for (int i = 0; i < YN; ++i) dys[i * NT] = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) carry[c] = 0.f;
        }
      }

      // ---- the hand-off to lane t-1
#pragma unroll
      for (int s = 0; s <= M; ++s) {
        if (s > 0) lm[s] = __shfl_down_sync(FULL, lm[s], 1, g);
        pv[s] = __shfl_down_sync(FULL, pv[s], 1, g);
      }
      Ar = __shfl_down_sync(FULL, Ar, 1, g);
      Br = __shfl_down_sync(FULL, Br, 1, g);
      dinc_r = __shfl_down_sync(FULL, dinc_r, 1, g);
      swu = __shfl_down_sync(FULL, swu, 1, g);
      swd = __shfl_down_sync(FULL, swd, 1, g);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        sxu[c] = __shfl_down_sync(FULL, sxu[c], 1, g);
        sxd[c] = __shfl_down_sync(FULL, sxd[c], 1, g);
      }
    }
  }
}

// ---- host side -----------------------------------------------------------------

// The plan (kernels/sigkernel_fused.py::fused_plan) picks g, the span
// template, the runs, tiles and blocks; these are the shapes the lane
// kernels take.
bool valid(int lx1, int ly1, int C, int g, int span, int max_ly1, int max_c) {
  if (lx1 < 1 || ly1 < 1 || ly1 > max_ly1 || C < 1 || C > max_c) return false;
  if (g < 1 || g > 16 || g > ly1 || (g & (g - 1)) != 0) return false;
  if (span != 3 && span != 5) return false;
  return (ly1 + g - 1) / g <= span;
}

size_t fwd_smem(int span, int C) { return fwd_smem_floats(span, C) * sizeof(float); }
size_t bf16_smem(int span, int C) {
  return (size_t)bf16_thread_floats(span, C) * NT * sizeof(float);
}
size_t bwd_smem(int span, int C) {
  return (size_t)bwd_thread_floats(span, C) * NT * sizeof(float);
}

template <typename K>
cudaError_t occupancy(K kernel, size_t smem, int* per_sm) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, NT, smem);
}

template <int SPAN, int C>
cudaError_t resident_fwd(int* per_sm) {
  return occupancy(fused_fwd_lanes_kernel<SPAN, C>, fwd_smem(SPAN, C), per_sm);
}

template <int SPAN, int C>
cudaError_t resident_bwd(int* per_sm) {
  return occupancy(fused_bwd_lanes_kernel<SPAN, C>, bwd_smem(SPAN, C), per_sm);
}

template <int SPAN, int C>
cudaError_t resident_bf16(int* per_sm) {
  return occupancy(fused_bwd_bf16_lanes_kernel<SPAN, C>, bf16_smem(SPAN, C), per_sm);
}

template <int SPAN, int C>
cudaError_t launch_fwd(const float* xt, const float* yt, float* k, float* ck, float* rc, int P,
                       int lx1, int ly1, int g, int bpc, int runs, int tiles, int blocks,
                       cudaStream_t st) {
  const size_t smem = fwd_smem(SPAN, C);
  cudaError_t err = cudaFuncSetAttribute(fused_fwd_lanes_kernel<SPAN, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_fwd_lanes_kernel<SPAN, C><<<blocks, NT, smem, st>>>(xt, yt, k, ck, rc, P, lx1, ly1, g,
                                                            bpc, runs, tiles);
  return cudaGetLastError();
}

template <int SPAN, int C>
cudaError_t launch_bwd(const float* xt, const float* yt, const float* ck, const float* rc,
                       const float* gout, float* dxt, float* dyt, int P, int lx1, int ly1, int g,
                       int bpc, int runs, int tiles, int blocks, cudaStream_t st) {
  const size_t smem = bwd_smem(SPAN, C);
  cudaError_t err = cudaFuncSetAttribute(fused_bwd_lanes_kernel<SPAN, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_bwd_lanes_kernel<SPAN, C><<<blocks, NT, smem, st>>>(xt, yt, ck, rc, gout, dxt, dyt, P,
                                                            lx1, ly1, g, bpc, runs, tiles);
  return cudaGetLastError();
}

template <int SPAN, int C>
cudaError_t launch_bf16(const float* xt, const float* yt, const float* ck, const float* rc,
                        const float* gout, float* dxt, float* dyt, int P, int lx1, int ly1,
                        int g, int bpc, int runs, int tiles, int blocks, cudaStream_t st) {
  const size_t smem = bf16_smem(SPAN, C);
  cudaError_t err = cudaFuncSetAttribute(fused_bwd_bf16_lanes_kernel<SPAN, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_bwd_bf16_lanes_kernel<SPAN, C><<<blocks, NT, smem, st>>>(
      xt, yt, ck, rc, gout, dxt, dyt, P, lx1, ly1, g, bpc, runs, tiles);
  return cudaGetLastError();
}

}  // namespace

// span × C dispatch of the lane kernels: K4's forward and backward at C = 1..8,
// K6 at 1..4
#define K4_DISPATCH(FN, ...)                                    \
  switch (span * 16 + C) {                                      \
    case 49: return (int)FN<3, 1>(__VA_ARGS__);                 \
    case 50: return (int)FN<3, 2>(__VA_ARGS__);                 \
    case 51: return (int)FN<3, 3>(__VA_ARGS__);                 \
    case 52: return (int)FN<3, 4>(__VA_ARGS__);                 \
    case 53: return (int)FN<3, 5>(__VA_ARGS__);                 \
    case 54: return (int)FN<3, 6>(__VA_ARGS__);                 \
    case 55: return (int)FN<3, 7>(__VA_ARGS__);                 \
    case 56: return (int)FN<3, 8>(__VA_ARGS__);                 \
    case 81: return (int)FN<5, 1>(__VA_ARGS__);                 \
    case 82: return (int)FN<5, 2>(__VA_ARGS__);                 \
    case 83: return (int)FN<5, 3>(__VA_ARGS__);                 \
    case 84: return (int)FN<5, 4>(__VA_ARGS__);                 \
    case 85: return (int)FN<5, 5>(__VA_ARGS__);                 \
    case 86: return (int)FN<5, 6>(__VA_ARGS__);                 \
    case 87: return (int)FN<5, 7>(__VA_ARGS__);                 \
    case 88: return (int)FN<5, 8>(__VA_ARGS__);                 \
    default: return (int)cudaErrorInvalidValue;                 \
  }

#define BF16_DISPATCH(FN, ...)                                  \
  switch (span * 16 + C) {                                      \
    case 49: return (int)FN<3, 1>(__VA_ARGS__);                 \
    case 50: return (int)FN<3, 2>(__VA_ARGS__);                 \
    case 51: return (int)FN<3, 3>(__VA_ARGS__);                 \
    case 52: return (int)FN<3, 4>(__VA_ARGS__);                 \
    case 81: return (int)FN<5, 1>(__VA_ARGS__);                 \
    case 82: return (int)FN<5, 2>(__VA_ARGS__);                 \
    case 83: return (int)FN<5, 3>(__VA_ARGS__);                 \
    case 84: return (int)FN<5, 4>(__VA_ARGS__);                 \
    default: return (int)cudaErrorInvalidValue;                 \
  }

extern "C" {

// Blocks of K4's forward (part 0), K6 (part 1) or K4's backward (part 2)
// resident on one SM at once, with their shared memory, for the plan.
int sigkernel_fused_resident(int span, int C, int part, int* per_sm) {
  if (part == 0) {
    K4_DISPATCH(resident_fwd, per_sm)
  }
  if (part == 2) {
    K4_DISPATCH(resident_bwd, per_sm)
  }
  BF16_DISPATCH(resident_bf16, per_sm)
}

// K4's forward. xt [Lx, C, P], yt [Ly, C, P] scaled path tiles; k [P]; ck
// [ceil(lx1/bpc), 8(Ly-1)+1, P] and rc [Lx-1, 8, P], both null for values
// only. fp32, contiguous, on the stream's device; g, span, runs (pairs a
// group walks), tiles (of runs·128/g pairs) and blocks from the plan.
// Returns cudaGetLastError() after the launch.
int sigkernel_fused_fwd(const float* xt, const float* yt, float* k, float* ck, float* rc, int P,
                        int Lx, int Ly, int C, int g, int span, int bpc, int runs, int tiles,
                        int blocks, void* stream) {
  if (!valid(Lx - 1, Ly - 1, C, g, span, 48, 8) || P < 1 || bpc < 1 || runs < 1 ||
      tiles < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  K4_DISPATCH(launch_fwd, xt, yt, k, ck, rc, P, Lx - 1, Ly - 1, g, bpc, runs, tiles, blocks,
               static_cast<cudaStream_t>(stream))
}

// K4's fp32 backward: xt, yt as the forward, ck [ceil(lx1/bpc), 8(Ly-1)+1, P]
// its checkpoints at spacing bpc = min(6, Lx-1), rc [Lx-1, 8, P] its right
// edges, gout [P]; writes dxt [Lx, C, P], dyt [Ly, C, P]. g, span, runs
// (pairs a group walks), tiles (of runs·128/g pairs) and blocks from the
// plan. No device scratch.
int sigkernel_fused_bwd(const float* xt, const float* yt, const float* ck, const float* rc,
                        const float* gout, float* dxt, float* dyt, int P, int Lx, int Ly, int C,
                        int g, int span, int bpc, int runs, int tiles, int blocks,
                        void* stream) {
  if (!valid(Lx - 1, Ly - 1, C, g, span, 48, 8) || P < 1 || bpc < 1 || runs < 1 ||
      tiles < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  K4_DISPATCH(launch_bwd, xt, yt, ck, rc, gout, dxt, dyt, P, Lx - 1, Ly - 1, g, bpc, runs,
              tiles, blocks, static_cast<cudaStream_t>(stream))
}

// K6: xt, yt, ck, rc as K4's backward, C <= 4, Ly - 1 <= 40; g, span, runs
// (couples a group walks), tiles (of runs·128/g couples) and blocks from
// the plan. No device scratch.
int sigkernel_fused_bwd_bf16(const float* xt, const float* yt, const float* ck, const float* rc,
                             const float* gout, float* dxt, float* dyt, int P, int Lx, int Ly,
                             int C, int g, int span, int bpc, int runs, int tiles, int blocks,
                             void* stream) {
  if (!valid(Lx - 1, Ly - 1, C, g, span, 40, 4) || P < 1 || bpc < 1 || runs < 1 ||
      tiles < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  BF16_DISPATCH(launch_bf16, xt, yt, ck, rc, gout, dxt, dyt, P, Lx - 1, Ly - 1, g, bpc, runs,
                tiles, blocks, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
