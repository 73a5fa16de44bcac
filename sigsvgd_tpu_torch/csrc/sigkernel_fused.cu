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
// are pair-minor ([L][C][P], [nslots][G1][P], [lx1][8][P]) so a warp's
// accesses coalesce.
//
// What bounds it on an H100. Every pair sweeps G² = (8·39)² ≈ 97k fine cells
// at the flagship shape (4 fp32 operations each forward, 14 in the fp32
// backward, 12 bf16 in the bf16 one): 2.1e11 operations forward over the
// 524,800 pairs of 1024 paths, against ~5.6 GB of residuals, so the bound is
// the operations (3.2 ms forward at 67 TFLOP/s). A pair's fine row (8·ly1+1
// values) fits neither a thread's registers nor, for enough threads, shared
// memory, so the rows stream through device memory. The design, K2's
// (csrc/sigkernel_block3.cu) on a pair list:
//   * one thread per pair; the paths are read from device memory (a pair
//     list shares no path tile between threads), the static node g on the
//     fly, two exp per coarse cell per band, z, A, B once per coarse cell;
//   * forward: bands of 8 fine rows whose carries stay in registers while
//     the sweep walks the fine columns; the fine row lives in the pair's own
//     checkpoint slot, so the checkpoints (every bpc = min(6, lx1) bands and
//     the last) cost no copy, and the right edge of every row is written as
//     the bf16 backward's anchor. Without residuals one slot is the working
//     row. Bands stream, so lx1 is unbounded;
//   * fp32 backward (K4): per checkpoint segment, top down, the segment's
//     band tops and right edges are recomputed from the checkpoint below it
//     into per-thread scratch (bit-identical to the forward), then K2's band
//     backward runs on them: three chains per fine column in registers
//     (adjoint of the band's 8 rows, the primal of the column to the left
//     rebuilt toward -j and re-anchored at every band's top row and every
//     row's right edge, the dz sums), the adjoint row handed down in scratch;
//   * bf16 backward (K6): the band's 8 rows advance together column by
//     column right to left, each row carrying its ρ and σ chains and its
//     previous column's outputs in registers, so that only the band's top
//     and bottom rows pass through memory (bf16 scratch). It re-anchors
//     where the JAX kernel does: the checkpoint rows (rounded to bf16) and
//     every row's fp32 right edge. Two pairs per thread, packed in bf16x2
//     registers (add.rn/sub.rn/mul.rn.bf16x2: one rounding per half and
//     operation, never fused, as the scalar twin rounds), which Hopper's
//     CUDA cores issue at twice the fp32 rate; C ≤ 4, JAX's bf16 envelope;
//   * both backwards pull dz back through the statics per coarse column:
//     the row-path gradient in registers; the column-path gradient in a
//     per-thread shared-memory slot written out once per pair (K6: two
//     slots, 41 KB a block at the flagship shape, which caps it at five
//     resident blocks per SM; accumulating in the output instead gave six
//     blocks but took 4% longer on the H100). No atomics.
// The backwards are persistent (as many blocks as are resident) and size
// their scratch by the resident threads. Speed work (K6's rows staggered by
// a column, wider bands, shared y tiles) comes later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int M = 8;  // fine cells per coarse cell side (2^λ)
constexpr int NT_FWD = 128;
constexpr int NT_BWD = 64;
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

// Advance one band (x rows xd = b, xu = b+1) over the fine row: node row 8b
// is read from `below` (nullptr: ones) at columns 1..G with stride bs, node
// row 8b+8 is written to `above` with stride as (in place when they alias:
// each column is read before it is written). left[s] = k[8b+1+s][G].
template <int C>
__device__ __forceinline__ void band_forward(const float (&xd)[C], const float (&xu)[C],
                                             const float* __restrict__ yt, size_t P,
                                             size_t p, int ly1, const float* below,
                                             size_t bs, float* above, size_t as,
                                             float (&left)[M]) {
  float corner[M];
#pragma unroll
  for (int s = 0; s < M; ++s) {
    left[s] = 1.f;
    corner[s] = 1.f;
  }
  float yq[C];
  load_pt<C>(yt, 0, P, p, yq);
  float gd0 = gval<C>(xd, yq), gu0 = gval<C>(xu, yq);
  for (int cj = 0; cj < ly1; ++cj) {
    load_pt<C>(yt, cj + 1, P, p, yq);
    const float gd1 = gval<C>(xd, yq), gu1 = gval<C>(xu, yq);
    const Coef k = coef(gu1, gu0, gd1, gd0);
#pragma unroll
    for (int tt = 0; tt < M; ++tt) {
      const size_t j = (size_t)(cj * M + tt);  // node column j+1
      float up = below ? below[j * bs] : 1.f;
#pragma unroll
      for (int s = 0; s < M; ++s) {
        const float kn = __fmaf_rn(__fadd_rn(left[s], up), k.A, -__fmul_rn(corner[s], k.B));
        corner[s] = up;
        left[s] = kn;
        up = kn;
      }
      above[j * as] = up;
    }
    gd0 = gd1;
    gu0 = gu1;
  }
}

template <int C>
__global__ void __launch_bounds__(NT_FWD)
fused_fwd_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                 float* __restrict__ kout, float* ck, float* __restrict__ rc, int P_,
                 int Lx, int Ly, int bpc) {
  const size_t P = P_;
  const size_t p = (size_t)blockIdx.x * NT_FWD + threadIdx.x;
  if (p >= P) return;
  const int lx1 = Lx - 1, ly1 = Ly - 1;
  const size_t G1 = (size_t)M * ly1 + 1;
  float xd[C], xu[C], left[M];
  load_pt<C>(xt, 0, P, p, xd);
  float edge = 1.f;  // k[8b][G]
  for (int b = 0; b < lx1; ++b) {
    load_pt<C>(xt, b + 1, P, p, xu);
    float* slot = ck + (size_t)(b / bpc) * G1 * P + p;
    const bool first = b % bpc == 0;
    if (first) slot[0] = 1.f;  // node column 0
    const float* below = b == 0 ? nullptr : (first ? slot - G1 * P : slot) + P;
    band_forward<C>(xd, xu, yt, P, p, ly1, below, P, slot + P, P, left);
    if (rc) {
      float* r = rc + (size_t)b * M * P + p;
      r[0] = edge;
#pragma unroll
      for (int s = 1; s < M; ++s) r[s * P] = left[s - 1];
    }
    edge = left[M - 1];
#pragma unroll
    for (int c = 0; c < C; ++c) xd[c] = xu[c];
  }
  kout[p] = edge;
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

// A pair's start: its column-path gradient dy[k·ds] (k < Ly·C) and the
// row-path carry set to 0.
template <int C>
__device__ __forceinline__ void start_pair(float* dy, size_t ds, int Ly, float (&carry)[C]) {
  for (int k = 0; k < Ly * C; ++k) dy[k * ds] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) carry[c] = 0.f;
}

// Static row 0's row-path gradient: only band 0's lower-row part.
template <int C>
__device__ __forceinline__ void store_row0(float* __restrict__ dxt, size_t P, size_t p,
                                           const float (&carry)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) dxt[(size_t)c * P + p] = carry[c];
}

// ---- K4 backward ------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(NT_BWD)
fused_bwd_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                 const float* __restrict__ ck, const float* __restrict__ gout,
                 float* __restrict__ dxt, float* __restrict__ dyt, float* scratch, int P_,
                 int Lx, int Ly, int bpc) {
  extern __shared__ float dyc[];  // [Ly][C][NT_BWD] column-path gradient
  const size_t P = P_;
  const int tid = threadIdx.x;
  const size_t T = (size_t)gridDim.x * NT_BWD;
  const size_t t = (size_t)blockIdx.x * NT_BWD + tid;
  const int lx1 = Lx - 1, ly1 = Ly - 1, G = M * ly1;
  const size_t G1 = (size_t)G + 1;
  const int nslots = (lx1 + bpc - 1) / bpc;
  // per-thread scratch, thread-minor: rows [bpc][G] (band tops of one
  // segment, columns 1..G), redge [bpc·M] (rows 8b+1.. at column G),
  // lamb [G] (the adjoint row handed from band to band)
  float* rows = scratch + t;
  float* redge = rows + (size_t)bpc * G * T;
  float* lamb = redge + (size_t)bpc * M * T;

  for (size_t p = t; p < P; p += T) {
    const float sd = gout[p];
    float carry[C];
    start_pair<C>(dyc + tid, NT_BWD, Ly, carry);
    for (int seg = nslots - 1; seg >= 0; --seg) {
      const int b0 = seg * bpc, b1 = min(b0 + bpc, lx1);
      const float* ckb = seg > 0 ? ck + (size_t)(seg - 1) * G1 * P + p : nullptr;
      // recompute the segment's band tops and right edges
      {
        float xd[C], xu[C], left[M];
        load_pt<C>(xt, b0, P, p, xd);
        for (int ci = b0; ci < b1; ++ci) {
          const int lb = ci - b0;
          load_pt<C>(xt, ci + 1, P, p, xu);
          const float* below =
              lb == 0 ? (ckb ? ckb + P : nullptr) : rows + (size_t)(lb - 1) * G * T;
          band_forward<C>(xd, xu, yt, P, p, ly1, below, lb == 0 ? P : T,
                          rows + (size_t)lb * G * T, T, left);
#pragma unroll
          for (int s = 0; s < M; ++s) redge[(size_t)(lb * M + s) * T] = left[s];
#pragma unroll
          for (int c = 0; c < C; ++c) xd[c] = xu[c];
        }
      }
      const float edge0 = ckb ? ckb[(size_t)G * P] : 1.f;  // k[8·b0][G]

      for (int ci = b1 - 1; ci >= b0; --ci) {
        const int lb = ci - b0;
        const float* top = rows + (size_t)lb * G * T;  // node row 8ci+8
        const bool topband = ci == lx1 - 1;
        float Pv[M + 1], Lm[M + 1];  // primal at column j, adjoint at column j+1
        Pv[0] = lb == 0 ? edge0 : redge[(size_t)(lb * M - 1) * T];
#pragma unroll
        for (int s = 1; s <= M; ++s) Pv[s] = redge[(size_t)(lb * M + s - 1) * T];
#pragma unroll
        for (int s = 0; s <= M; ++s) Lm[s] = 0.f;
        float xu[C], xd[C], sxu[C], sxd[C], yr[C], yl[C];
        load_pt<C>(xt, ci + 1, P, p, xu);
        load_pt<C>(xt, ci, P, p, xd);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          sxu[c] = 0.f;
          sxd[c] = 0.f;
        }
        float swu = 0.f, swd = 0.f;
        load_pt<C>(yt, ly1, P, p, yr);
        float gu_r = gval<C>(xu, yr), gd_r = gval<C>(xd, yr);
        float Ar = 0.f, Br = 0.f;  // coefficients of coarse column cj+1 (none at the edge)
        float dinc_r = 0.f;        // dinc of coarse column cj+1
        for (int cj = ly1 - 1; cj >= 0; --cj) {
          load_pt<C>(yt, cj, P, p, yl);
          const float gu_l = gval<C>(xu, yl), gd_l = gval<C>(xd, yl);
          const Coef k = coef(gu_r, gu_l, gd_r, gd_l);
          const float Bi = 1.f / k.B;
          float s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int tt = M - 1; tt >= 0; --tt) {
            const int j = cj * M + tt + 1;  // node column, G .. 1
            const float ar = tt == M - 1 ? Ar : k.A;  // cell column j
            const float br = tt == M - 1 ? Br : k.B;
            float* lj = lamb + (size_t)(j - 1) * T;
            // adjoint of the band's rows at column j
            float Ln[M + 1];
            const float lt = topband ? (j == G ? sd : 0.f) : *lj;
            Ln[M] = fmaf(Lm[M], ar, lt);
#pragma unroll
            for (int s = M - 1; s >= 1; --s)
              Ln[s] = fmaf(Lm[s], ar, Ln[s + 1] * k.A) - Lm[s + 1] * br;
            // partial adjoint of node row 8ci, handed to the band below
            if (ci > 0) *lj = Ln[1] * k.A - Lm[1] * br;
            // primal of column j-1, rebuilt toward -j from column j
            float Pn[M + 1];
            if (j == 1) {
#pragma unroll
              for (int s = 0; s <= M; ++s) Pn[s] = 1.f;
            } else {
              Pn[M] = top[(size_t)(j - 2) * T];
#pragma unroll
              for (int s = M - 1; s >= 0; --s)
                Pn[s] = ((Pn[s + 1] + Pv[s]) * k.A - Pv[s + 1]) * Bi;
              if (ci == 0) Pn[0] = 1.f;
            }
            // dz of cells (s, j-1): weight λ[s+1][j]
#pragma unroll
            for (int s = 0; s < M; ++s) {
              s1 = fmaf(Ln[s + 1], Pn[s + 1] + Pv[s], s1);
              s2 = fmaf(Ln[s + 1], Pn[s], s2);
            }
#pragma unroll
            for (int s = 0; s <= M; ++s) {
              Pv[s] = Pn[s];
              Lm[s] = Ln[s];
            }
          }
          const float dinc = ((0.5f + k.z * I6) * s1 + (k.z * I6) * s2) * ZS;
          pull_back<C>(dinc - dinc_r, gu_r, gd_r, yr,
                       dyc + (size_t)(cj + 1) * C * NT_BWD + tid, NT_BWD, xu, xd, sxu, sxd,
                       swu, swd);
          dinc_r = dinc;
          gu_r = gu_l;
          gd_r = gd_l;
#pragma unroll
          for (int c = 0; c < C; ++c) yr[c] = yl[c];
          Ar = k.A;
          Br = k.B;
        }
        pull_back<C>(-dinc_r, gu_r, gd_r, yr, dyc + tid, NT_BWD, xu, xd, sxu, sxd, swu, swd);
        store_rows<C>(dxt, ci, P, p, xu, xd, sxu, sxd, swu, swd, carry);
      }
    }
    store_row0<C>(dxt, P, p, carry);
    for (int k = 0; k < Ly * C; ++k) dyt[(size_t)k * P + p] = dyc[k * NT_BWD + tid];
  }
}

// ---- K6: bf16 delta-form backward, two pairs per thread ----------------------
// A register holds one bf16 value of each of the thread's two pairs (low
// half: pair a, high half: pair b); add.rn/sub.rn/mul.rn.bf16x2 round each
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

template <int C>
__global__ void __launch_bounds__(NT_BWD)
fused_bwd_bf16_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                      const float* __restrict__ ck, const float* __restrict__ rc,
                      const float* __restrict__ gout, float* __restrict__ dxt,
                      float* __restrict__ dyt, unsigned* scratch, int P_, int Lx, int Ly,
                      int bpc) {
  extern __shared__ float dys[];  // [2][Ly][C][NT_BWD] column-path gradients
  const size_t P = P_;
  const size_t Q = (P + 1) / 2;   // pair couples (2q, 2q+1)
  const int tid = threadIdx.x;
  const size_t T = (size_t)gridDim.x * NT_BWD;
  const size_t t = (size_t)blockIdx.x * NT_BWD + tid;
  const int lx1 = Lx - 1, ly1 = Ly - 1, G = M * ly1;
  const size_t G1 = (size_t)G + 1;
  // per-thread bf16x2 scratch, thread-minor: kb [G+1] (primal of the band's
  // top row, then of its bottom row), gb [G+2] (adjoint of the row above the
  // band, nodes 0..G+1; node G+1 stays 0), zhu [ly1] (z/2 of the band above)
  unsigned* kb = scratch + t;
  unsigned* gb = kb + G1 * T;
  unsigned* zhu = gb + (G1 + 1) * T;

  for (size_t q = t; q < Q; q += T) {
    const bool has_b = 2 * q + 1 < P;
    const size_t pp[2] = {2 * q, has_b ? 2 * q + 1 : 2 * q};
    const unsigned seed = pack2(gout[pp[0]], has_b ? gout[pp[1]] : 0.f);
    float* dyq[2] = {dys + tid, dys + (size_t)Ly * C * NT_BWD + tid};
    float carry[2][C];
    start_pair<C>(dyq[0], NT_BWD, Ly, carry[0]);
    start_pair<C>(dyq[1], NT_BWD, Ly, carry[1]);
    for (int j = 0; j <= G + 1; ++j) gb[(size_t)j * T] = 0u;
    for (int c = 0; c < ly1; ++c) zhu[(size_t)c * T] = 0u;

    for (int b = lx1 - 1; b >= 0; --b) {
      const bool anchored = (b + 1) % bpc == 0 || b == lx1 - 1;
      const float* ckrow = ck + (size_t)(b / bpc) * G1 * P;  // node row 8b+8
      const bool topband = b == lx1 - 1;
      // per row r (node row i = 8b+8-r): ρ, σ, and the row's outputs at the
      // previous (right) column, k[i-1][j+1] and ĝ[i][j+2]
      unsigned kr0[M], rho[M], sig[M], pK[M], pG[M], s1[M];
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const float* e = rc + ((size_t)b * M + (M - 1 - r)) * P;
        kr0[r] = pack2(e[pp[0]], e[pp[1]]);
      }
      unsigned k0r = anchored ? pack2(ckrow[(size_t)G * P + pp[0]], ckrow[(size_t)G * P + pp[1]])
                              : kb[(size_t)G * T];
      unsigned g0r = 0u;  // ĝ of the row above at node G+1
#pragma unroll
      for (int r = 0; r < M; ++r) {
        sig[r] = sub2(kr0[r], r == 0 ? k0r : kr0[r > 0 ? r - 1 : 0]);
        rho[r] = 0u;
        pK[r] = kr0[r];
        pG[r] = 0u;
      }
      float xu[2][C], xd[2][C], sxu[2][C], sxd[2][C], yr[2][C], yl[2][C];
      float swu[2], swd[2], gu_r[2], gd_r[2], dz_r[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        load_pt<C>(xt, b + 1, P, pp[i], xu[i]);
        load_pt<C>(xt, b, P, pp[i], xd[i]);
        load_pt<C>(yt, ly1, P, pp[i], yr[i]);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          sxu[i][c] = 0.f;
          sxd[i][c] = 0.f;
        }
        swu[i] = swd[i] = dz_r[i] = 0.f;
        gu_r[i] = gval<C>(xu[i], yr[i]);
        gd_r[i] = gval<C>(xd[i], yr[i]);
      }
      unsigned zh_r = 0u;
      for (int cc = ly1 - 1; cc >= 0; --cc) {
        float gu_l[2], gd_l[2], zf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          load_pt<C>(yt, cc, P, pp[i], yl[i]);
          gu_l[i] = gval<C>(xu[i], yl[i]);
          gd_l[i] = gval<C>(xd[i], yl[i]);
          zf[i] = __fmul_rn(coef(gu_r[i], gu_l[i], gd_r[i], gd_l[i]).z, 0.5f);
        }
        const unsigned zc = pack2(zf[0], zf[1]);
        const unsigned zr = cc == ly1 - 1 ? zc : zh_r;  // z/2 of cell min(cc+1, ly1-1)
        unsigned* zslot = zhu + (size_t)cc * T;
        const unsigned zu = *zslot;  // the band above's (0 at the top band)
        *zslot = zc;
#pragma unroll
        for (int tt = M - 1; tt >= 0; --tt) {
          const int jn = cc * M + tt;  // node column of the rebuilt primal
          // row 0's inputs: k[8b+8][jn], ĝ[8b+9][jn+1] and, from the
          // previous column, k[8b+8][jn+1], ĝ[8b+9][jn+2]
          unsigned kin = anchored ? pack2(ckrow[(size_t)jn * P + pp[0]],
                                          ckrow[(size_t)jn * P + pp[1]])
                                  : kb[(size_t)jn * T];
          unsigned gin = gb[(size_t)(jn + 1) * T];
          unsigned kin_r = k0r, gin_r = g0r;
          k0r = kin;
          g0r = gin;
          const unsigned z1 = tt == M - 1 ? zr : zc;
#pragma unroll
          for (int r = 0; r < M; ++r) {
            // adjoint delta ρ[j] = ρ[j+1] + z1·ĝ[i+1][j+1] + zu·ĝ[i+1][j]
            rho[r] = add2(add2(rho[r], mul2(z1, gin_r)), mul2(r == 0 ? zu : zc, gin));
            if (r == 0 && topband && jn == G - 1) rho[r] = add2(rho[r], seed);
            const unsigned g = add2(gin, rho[r]);
            // primal delta and the dz term (m1 takes the incoming σ)
            const unsigned s = add2(kin, kin_r);
            const unsigned m1 = add2(s, sig[r]);
            s1[r] = tt == M - 1 ? mul2(g, m1) : add2(s1[r], mul2(g, m1));
            sig[r] = add2(sig[r], mul2(zc, s));
            if (jn == 0) sig[r] = 0u;  // the left boundary is one
            const unsigned kus = add2(kin, sig[r]);
            // row r+1's inputs
            kin_r = pK[r];
            gin_r = pG[r];
            pK[r] = kus;
            pG[r] = g;
            kin = kus;
            gin = g;
          }
          kb[(size_t)jn * T] = kin;        // k[8b][jn]
          gb[(size_t)(jn + 1) * T] = gin;  // ĝ[8b+1][jn+1]
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float dz = __fmul_rn(half2f(s1[0], i), 0.5f);
#pragma unroll
          for (int r = 1; r < M; ++r) dz = __fadd_rn(dz, __fmul_rn(half2f(s1[r], i), 0.5f));
          if (i == 0 || has_b)
            pull_back<C>(__fmul_rn(__fsub_rn(dz, dz_r[i]), ZS), gu_r[i], gd_r[i], yr[i],
                         dyq[i] + (size_t)(cc + 1) * C * NT_BWD, NT_BWD, xu[i], xd[i], sxu[i],
                         sxd[i], swu[i], swd[i]);
          dz_r[i] = dz;
          gu_r[i] = gu_l[i];
          gd_r[i] = gd_l[i];
#pragma unroll
          for (int c = 0; c < C; ++c) yr[i][c] = yl[i][c];
        }
        zh_r = zc;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && !has_b) continue;
        pull_back<C>(__fmul_rn(-dz_r[i], ZS), gu_r[i], gd_r[i], yr[i], dyq[i], NT_BWD, xu[i],
                     xd[i], sxu[i], sxd[i], swu[i], swd[i]);
        store_rows<C>(dxt, b, P, pp[i], xu[i], xd[i], sxu[i], sxd[i], swu[i], swd[i],
                      carry[i]);
      }
      kb[(size_t)G * T] = kr0[M - 1];  // k[8b][G], the next band's top edge
    }
    for (int i = 0; i < (has_b ? 2 : 1); ++i) {
      store_row0<C>(dxt, P, pp[i], carry[i]);
      for (int k = 0; k < Ly * C; ++k) dyt[(size_t)k * P + pp[i]] = dyq[i][k * NT_BWD];
    }
  }
}

// The column-path gradient slots of a block: one pair a thread (K4) or two
// (K6).
size_t bwd_smem(int Ly, int C, int pairs) {
  return sizeof(float) * (size_t)pairs * Ly * C * NT_BWD;
}

// `items`: pairs (K4) or pair couples (K6), one per thread.
template <typename K>
cudaError_t resident_blocks(K kernel, size_t smem, int items, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT_BWD, smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int need = (items + NT_BWD - 1) / NT_BWD;
  *blocks = min(per_sm * sms, need > 0 ? need : 1);
  return cudaSuccess;
}

template <int C>
cudaError_t fwd(const float* xt, const float* yt, float* k, float* ck, float* rc, int P, int Lx,
                int Ly, int bpc, cudaStream_t st) {
  const int grid = (P + NT_FWD - 1) / NT_FWD;
  fused_fwd_kernel<C><<<grid, NT_FWD, 0, st>>>(xt, yt, k, ck, rc, P, Lx, Ly, bpc);
  return cudaGetLastError();
}

template <int C>
cudaError_t grid32(int Ly, int P, int* blocks) {
  return resident_blocks(fused_bwd_kernel<C>, bwd_smem(Ly, C, 1), P, blocks);
}

template <int C>
cudaError_t grid16(int Ly, int P, int* blocks) {
  return resident_blocks(fused_bwd_bf16_kernel<C>, bwd_smem(Ly, C, 2), (P + 1) / 2, blocks);
}

template <int C>
cudaError_t bwd(const float* xt, const float* yt, const float* ck, const float* gout, float* dxt,
                float* dyt, float* scratch, int blocks, int P, int Lx, int Ly, int bpc,
                cudaStream_t st) {
  const size_t smem = bwd_smem(Ly, C, 1);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_bwd_kernel<C><<<blocks, NT_BWD, smem, st>>>(xt, yt, ck, gout, dxt, dyt, scratch, P, Lx,
                                                    Ly, bpc);
  return cudaGetLastError();
}

template <int C>
cudaError_t bwd16(const float* xt, const float* yt, const float* ck, const float* rc,
                  const float* gout, float* dxt, float* dyt, unsigned* scratch, int blocks,
                  int P, int Lx, int Ly, int bpc, cudaStream_t st) {
  const size_t smem = bwd_smem(Ly, C, 2);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_bwd_bf16_kernel<C><<<blocks, NT_BWD, smem, st>>>(xt, yt, ck, rc, gout, dxt, dyt,
                                                         scratch, P, Lx, Ly, bpc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xt [Lx, C, P], yt [Ly, C, P] scaled path tiles; k [P]; ck [ceil(lx1/bpc),
// 8(Ly-1)+1, P] (the working row and the checkpoints); rc [Lx-1, 8, P] or
// null. fp32, contiguous, on the stream's device. Returns cudaGetLastError().
int sigkernel_fused_fwd(const float* xt, const float* yt, float* k, float* ck, float* rc, int P,
                        int Lx, int Ly, int C, int bpc, void* stream) {
#define CALL(c) fwd<c>(xt, yt, k, ck, rc, P, Lx, Ly, bpc, static_cast<cudaStream_t>(stream))
  switch (C) {
    case 1: return (int)CALL(1);
    case 2: return (int)CALL(2);
    case 3: return (int)CALL(3);
    case 4: return (int)CALL(4);
    case 5: return (int)CALL(5);
    case 6: return (int)CALL(6);
    case 7: return (int)CALL(7);
    case 8: return (int)CALL(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}

// Number of persistent blocks for a backward launch (bf = 1: K6, C <= 4);
// the caller sizes the scratch by blocks · 64 threads.
int sigkernel_fused_bwd_grid(int Ly, int C, int bf, int P, int* blocks) {
  if (bf) {
    switch (C) {
      case 1: return (int)grid16<1>(Ly, P, blocks);
      case 2: return (int)grid16<2>(Ly, P, blocks);
      case 3: return (int)grid16<3>(Ly, P, blocks);
      case 4: return (int)grid16<4>(Ly, P, blocks);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (C) {
    case 1: return (int)grid32<1>(Ly, P, blocks);
    case 2: return (int)grid32<2>(Ly, P, blocks);
    case 3: return (int)grid32<3>(Ly, P, blocks);
    case 4: return (int)grid32<4>(Ly, P, blocks);
    case 5: return (int)grid32<5>(Ly, P, blocks);
    case 6: return (int)grid32<6>(Ly, P, blocks);
    case 7: return (int)grid32<7>(Ly, P, blocks);
    case 8: return (int)grid32<8>(Ly, P, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4's fp32 backward: xt, yt as the forward, ck its checkpoints at spacing
// bpc = min(6, Lx-1), gout [P]; writes dxt [Lx, C, P], dyt [Ly, C, P].
// scratch: blocks · 64 · 4·(bpc·G + 8·bpc + G) bytes, G = 8(Ly-1).
int sigkernel_fused_bwd(const float* xt, const float* yt, const float* ck, const float* gout,
                        float* dxt, float* dyt, void* scratch, int blocks, int P, int Lx,
                        int Ly, int C, int bpc, void* stream) {
#define CALL(c)                                                                      \
  bwd<c>(xt, yt, ck, gout, dxt, dyt, static_cast<float*>(scratch), blocks, P, Lx, Ly, bpc, \
         static_cast<cudaStream_t>(stream))
  switch (C) {
    case 1: return (int)CALL(1);
    case 2: return (int)CALL(2);
    case 3: return (int)CALL(3);
    case 4: return (int)CALL(4);
    case 5: return (int)CALL(5);
    case 6: return (int)CALL(6);
    case 7: return (int)CALL(7);
    case 8: return (int)CALL(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}

// K6: as sigkernel_fused_bwd, with the right edges rc [Lx-1, 8, P], C <= 4;
// scratch: blocks · 64 · 4·(2G + 3 + Ly-1) bytes (one bf16x2 per couple).
int sigkernel_fused_bwd_bf16(const float* xt, const float* yt, const float* ck, const float* rc,
                             const float* gout, float* dxt, float* dyt, void* scratch,
                             int blocks, int P, int Lx, int Ly, int C, int bpc, void* stream) {
#define CALL(c)                                                                     \
  bwd16<c>(xt, yt, ck, rc, gout, dxt, dyt, static_cast<unsigned*>(scratch), blocks, P, Lx, \
           Ly, bpc, static_cast<cudaStream_t>(stream))
  switch (C) {
    case 1: return (int)CALL(1);
    case 2: return (int)CALL(2);
    case 3: return (int)CALL(3);
    case 4: return (int)CALL(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}

}  // extern "C"
