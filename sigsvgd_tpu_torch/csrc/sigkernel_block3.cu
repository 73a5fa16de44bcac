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
// fp32 CUDA cores bound it. A pair's fine row (8(L-1)+1 floats) is too long
// for one thread's registers, and the TPU kernel's answer (2,048 rows in
// VMEM) does not fit a block's shared memory, so the design spreads each
// row over the registers of a group of lanes:
//   * a lane group per pair: g lanes (a power of two, g·5 >= L-1) of a warp
//     solve one pair; the L-1 coarse columns are split into g spans of whole
//     coarse columns (at most SPAN = 3 or 5, the template), and each lane
//     keeps its span of the fine row (forward) and of the adjoint row
//     (backward) in registers from one band to the next;
//   * a block (4 warps) takes a tile of 8 row particles × 128/g column
//     particles; each group walks its column's 8 pairs, and its lanes run
//     the bands of all 8 as one pipeline: at step k lane t sweeps band k - t
//     over its span and hands its 8 right-edge values and the corner to lane
//     t+1 by __shfl_up_sync; the backward runs the same pipeline right to
//     left (P, the primal column, and Lm, the adjoint column, at the span's
//     left edge, the coefficients and dinc of its leftmost coarse column and
//     the group's running row sums go to lane t-1 by __shfl_down_sync). A
//     run of 8 pairs takes 8(L-1) + g-1 steps, so lanes idle only in the g-1
//     steps at its ends;
//   * device memory sees only the band-top checkpoints: each lane writes
//     its span of every band's top row once in the forward (and the last
//     lane the band's right-edge column), and reads it once in the backward,
//     where the primal is rebuilt toward -j from it (divide by B, as the
//     TPU's _bwd_rows_fast does) over at most 8 fine rows. The slots are
//     indexed by pipeline step and hold the lanes' float4s side by side, so
//     each store (and load) of a warp fills whole 128-byte lines; each lane
//     reads only what it wrote; pairs with seed 0 (a > b, or padding) are
//     skipped and move nothing;
//   * statics are formed by each lane for its span from the paths staged in
//     shared memory (pre-scaled by rsqrt(h)), two exp per coarse cell; z,
//     A, B once per coarse cell, shared by its 8×8 fine cells;
//   * dz is pulled back through the statics per coarse cell; a lane owns the
//     static node columns inside and at the right edge of its span (lane 0
//     also column 0), so every node is pulled back once, in the serial
//     right-to-left order of one thread. The column-path gradient of those
//     nodes sums over the group's 8 pairs in per-lane shared slots; the
//     row-path gradient sums over the group's lanes through the hand-off,
//     over a warp's groups by shuffles and over the block's warps in a fixed
//     order; per-tile partials and a second kernel summing each particle's
//     partials in tile order give dX: no atomics, deterministic.
// The statics and the forward sweep round as the plain twin does, each
// operation on its own except the sweep's product by A, which is fused into
// its subtraction as XLA compiles the JAX kernel's sweep (A - 1 ≈ z/2 keeps
// a few digits in fp32 and every A serves 64 fine cells, so where the sweep
// rounds moves K). K then matches the twin on the card up to the exp; the
// backward contracts freely.
// At 128 registers the backward spills, so the kernel takes 168 (3 blocks,
// 12 warps an SM): at [1024, 40, 2] more warps measured no faster, and the
// arithmetic, not the ~52 GB of checkpoint traffic, takes most of the time.
// Channels: C ≤ 3 up to L = 64, and the JAX package's block envelope beyond
// it, C = 4..8 with L·C ≤ 128 (ly1 ≤ 31). What grows with C is a lane's row
// points and its pull-back sums (sxu, sxd, carry: C floats each) in
// registers and its column-path sums ((SPAN+1)·C floats) in shared memory;
// the fine and adjoint rows (8·SPAN floats each) do not. At C ≥ 4 a lane
// holds at most 3 coarse columns (span template 3), which frees 16 floats of
// each row for the C-sized arrays: every instantiation fits 168 registers
// with no spill (164-168 at C = 4..8), 3 blocks an SM.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr int TR = 8;    // row particles per tile (pairs a group walks)
constexpr int M = 8;     // fine cells per coarse cell side (2^λ)
constexpr unsigned FULL = 0xffffffffu;
constexpr float ZS = 1.0f / 64.0f;
constexpr float I6 = 1.0f / 6.0f;
constexpr float I12 = 1.0f / 12.0f;

// Shared memory: xs [L][C][TR], ys [L][C·TC+1] (a padded node stride, so a
// group's lanes, on different nodes, hit different banks), dxw [TR][NW][L·C]
// (each warp's row-path sums), dyc [(SPAN+1)·C][NT] (each lane's
// column-path sums, node-major).
size_t smem_floats(int L, int C, int g, int span) {
  const int tc = NT / g;
  return (size_t)L * C * TR + (size_t)L * (C * tc + 1) + (size_t)TR * NW * L * C +
         (size_t)(span + 1) * C * NT;
}

// Floats of device scratch a pipeline step takes, per warp: the tops of 32
// lanes' spans, [2·span][32 lanes] float4s (so the lanes' i-th float4s fill
// whole lines), then the right-edge column of each group, [2][32/g] float4s.
__host__ __device__ inline size_t step_floats(int g, int span) {
  return (size_t)32 * M * span + (size_t)(32 / g) * M;
}

// Static-Gram entry g[p][q] = exp(-Σ_c (x'_p,c - y'_q,c)^2), rounded in the
// twin's order.
template <int C>
__device__ __forceinline__ float gval(const float* xs, const float* yg, int p, int q,
                                      int r, int ys_stride, int tc) {
  float d2 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float d = __fsub_rn(xs[(p * C + c) * TR + r], yg[q * ys_stride + c * tc]);
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
// yq points at the column path's node q (channel stride tc); dq at the
// lane's slot for that node (channel stride NT).
template <int C>
__device__ __forceinline__ void pull_back(float E, float gu, float gd, const float* yq,
                                          int tc, float* dq, const float (&xu)[C],
                                          const float (&xd)[C], float (&sxu)[C],
                                          float (&sxd)[C], float& swu, float& swd) {
  const float wu = -gu * E;  // ∂/∂d² of the upper node
  const float wd = gd * E;   // ∂/∂d² of the lower node
  swu += wu;
  swd += wd;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float yv = yq[c * tc];
    sxu[c] = fmaf(wu, yv, sxu[c]);
    sxd[c] = fmaf(wd, yv, sxd[c]);
    dq[c * NT] += 2.f * ((yv - xu[c]) * wu + (yv - xd[c]) * wd);
  }
}

template <int SPAN, int C>
__global__ void __launch_bounds__(NT, 3)
block3_kernel(const float* __restrict__ X, const float* __restrict__ sptr,
              const int* __restrict__ tiles, int n_tiles, float* __restrict__ K,
              float* __restrict__ rowpart, float* __restrict__ colpart,
              float* __restrict__ scratch, int n, int L, int g) {
  extern __shared__ float smem[];
  const int LC = L * C;
  const int tc = NT / g;           // column particles per tile
  const int ys_stride = C * tc + 1;
  float* xs = smem;                             // [L][C][TR]
  float* ys = xs + LC * TR;                     // [L][C·tc + 1]
  float* dxw = ys + L * ys_stride;              // [TR][NW][L·C]
  float* dyc = dxw + TR * NW * LC;              // [(SPAN+1)·C][NT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & (g - 1);  // position in the group
  const int grp = tid / g;       // the group's tile column
  const float scale = sptr[0];
  const int L1 = L - 1, G = M * L1;
  const int c0 = (t * L1) / g, c1 = ((t + 1) * L1) / g, nspan = c1 - c0;
  const int U = TR * L1, steps = U + g - 1;
  const size_t sf = step_floats(g, SPAN);
  float* wscr = scratch + ((size_t)blockIdx.x * NW + warp) * steps * sf;
  const int ngw = 32 / g;  // groups in a warp
  // a lane's i-th float4 of a step's slot: + slot·sf/4 + 32·i (tops), + ngw·i (edge)
  float4* mytops = reinterpret_cast<float4*>(wscr) + lane;
  float4* myedge = reinterpret_cast<float4*>(wscr + 32 * M * SPAN) + lane / g;
  float* dmy = dyc + tid;                                     // slot s, channel c: + (s·C + c)·NT
  const float* yg = ys + grp;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int I = tiles[2 * tile], J = tiles[2 * tile + 1];
    __syncthreads();  // the previous tile's partials are written
    for (int e = tid; e < LC * TR; e += NT) {
      const int rr = e / LC, k = e % LC;
      const int a = I * TR + rr;
      xs[k * TR + rr] = a < n ? __fmul_rn(X[(size_t)a * LC + k], scale) : 0.f;
    }
    for (int e = tid; e < LC * tc; e += NT) {
      const int cc = e / LC, k = e % LC;
      const int b = J * tc + cc;
      ys[(k / C) * ys_stride + (k % C) * tc + cc] =
          b < n ? __fmul_rn(X[(size_t)b * LC + k], scale) : 0.f;
    }
    for (int k = 0; k < (SPAN + 1) * C; ++k) dmy[k * NT] = 0.f;
    __syncthreads();

    const int b = J * tc + grp;

    // ---- forward: lane t sweeps band k - t of the group's 8-pair run ------
    {
      float row[M * SPAN];  // the span's node row below the band, then its top
      float left[M], corner[M], inL[M], inC = 1.f;
#pragma unroll
      for (int s = 0; s < M; ++s) {
        left[s] = corner[s] = inL[s] = 1.f;
      }
#pragma unroll
      for (int i = 0; i < M * SPAN; ++i) row[i] = 1.f;
      for (int k = 0; k < steps; ++k) {
        const int u = k - t;
        if (u >= 0 && u < U) {
          const int r = u / L1, ci = u - r * L1;
          const int a = I * TR + r;
          if (a < n && b < n && a <= b) {
            if (ci == 0) {
#pragma unroll
              for (int i = 0; i < M * SPAN; ++i) row[i] = 1.f;
            }
            // the carries at node column 8c0, from lane t-1 (1 on the boundary)
#pragma unroll
            for (int s = 0; s < M; ++s) {
              corner[s] = t == 0 ? 1.f : (s == 0 ? inC : inL[s - 1]);
              left[s] = t == 0 ? 1.f : inL[s];
            }
            const float top0 = left[M - 1];  // node (8ci+8, 8c0)
            float4* dst = mytops + k * (sf / 4);
            float gd0 = gval<C>(xs, yg, ci, c0, r, ys_stride, tc);
            float gu0 = gval<C>(xs, yg, ci + 1, c0, r, ys_stride, tc);
#pragma unroll
            for (int kk = 0; kk < SPAN; ++kk) {
              if (kk < nspan) {
                const int cj = c0 + kk;
                const float gd1 = gval<C>(xs, yg, ci, cj + 1, r, ys_stride, tc);
                const float gu1 = gval<C>(xs, yg, ci + 1, cj + 1, r, ys_stride, tc);
                const Coef q = coef(gu1, gu0, gd1, gd0);
#pragma unroll
                for (int tt = 0; tt < M; ++tt) {
                  float up = row[kk * M + tt];
#pragma unroll
                  for (int s = 0; s < M; ++s) {
                    const float kn = __fmaf_rn(__fadd_rn(left[s], up), q.A,
                                               -__fmul_rn(corner[s], q.B));
                    corner[s] = up;
                    left[s] = kn;
                    up = kn;
                  }
                  row[kk * M + tt] = up;
                }
                // checkpoint: the band's top row at node columns 8cj .. 8cj+7,
                // stored as soon as it is final so the stores spread over the step
                dst[64 * kk] = make_float4(kk == 0 ? top0 : row[kk > 0 ? kk * M - 1 : 0],
                                           row[kk * M], row[kk * M + 1], row[kk * M + 2]);
                dst[64 * kk + 32] = make_float4(row[kk * M + 3], row[kk * M + 4],
                                                row[kk * M + 5], row[kk * M + 6]);
                gd0 = gd1;
                gu0 = gu1;
              }
            }
            if (t == g - 1) {  // the right edge: nodes (8ci+1 .. 8ci+8, G)
              float4* e = myedge + k * (sf / 4);
              e[0] = make_float4(left[0], left[1], left[2], left[3]);
              e[ngw] = make_float4(left[4], left[5], left[6], left[7]);
              if (ci == L1 - 1) {
                K[(size_t)a * n + b] = left[M - 1];
                K[(size_t)b * n + a] = left[M - 1];
              }
            }
          }
        }
        inC = __shfl_up_sync(FULL, corner[0], 1, g);
#pragma unroll
        for (int s = 0; s < M; ++s) inL[s] = __shfl_up_sync(FULL, left[s], 1, g);
      }
    }

    // ---- backward: lane t takes band v of the reversed run at step k with
    // v = k - (g-1-t), bands top-down, fine columns right to left ----------
    {
      float lamb[M * SPAN];  // adjoint of the band's top node row on the span
      float P[M + 1], Lm[M + 1];  // primal at column j, adjoint at column j+1
      float Ar = 0.f, Br = 0.f, dinc_r = 0.f, swu = 0.f, swd = 0.f;
      float sxu[C], sxd[C], carry[C];
#pragma unroll
      for (int s = 0; s <= M; ++s) P[s] = Lm[s] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) sxu[c] = sxd[c] = carry[c] = 0.f;
#pragma unroll
      for (int i = 0; i < M * SPAN; ++i) lamb[i] = 0.f;
      // the first coarse column's tops (and the last lane's edge) of a step,
      // loaded one step ahead
      float4 na = make_float4(0.f, 0.f, 0.f, 0.f), nb = na, ea = na, eb = na;
      float e0 = 1.f;
      auto prefetch = [&](int kq) {
        const int vq = kq - (g - 1 - t);
        if (vq < 0 || vq >= U) return;
        const int uq = U - 1 - vq, rq = uq / L1, ciq = uq - rq * L1;
        const int aq = I * TR + rq;
        if (!(aq < n && b < n && aq <= b)) return;
        const size_t slot = (size_t)(steps - 1 - kq);
        const float4* src = mytops + slot * (sf / 4);
        na = src[64 * (nspan - 1)];
        nb = src[64 * (nspan - 1) + 32];
        if (t == g - 1) {
          const float4* e = myedge + slot * (sf / 4);
          ea = e[0];
          eb = e[ngw];
          // node (8ci, G): the top of the band below, written a step earlier
          e0 = ciq > 0 ? myedge[(slot - 1) * (sf / 4) + ngw].w : 1.f;
        }
      };
      prefetch(0);
      for (int k = 0; k < steps; ++k) {
        const int v = k - (g - 1 - t);
        const bool mine = v >= 0 && v < U;
        const int u = U - 1 - v, r = mine ? u / L1 : 0, ci = mine ? u - r * L1 : 0;
        const int a = I * TR + r;
        float rv[C], rv0[C];  // lane 0: the row-path sums of nodes ci+1 and 0
#pragma unroll
        for (int c = 0; c < C; ++c) rv[c] = rv0[c] = 0.f;
        if (mine && a < n && b < n && a <= b) {
          const size_t slot = (size_t)(steps - 1 - k);
          const float4* tops = mytops + slot * (sf / 4);
          if (t == g - 1) {  // the right edge column, nodes 8ci .. 8ci+8
            P[0] = e0;
            P[1] = ea.x; P[2] = ea.y; P[3] = ea.z; P[4] = ea.w;
            P[5] = eb.x; P[6] = eb.y; P[7] = eb.z; P[8] = eb.w;
#pragma unroll
            for (int s = 0; s <= M; ++s) Lm[s] = 0.f;
            Ar = Br = dinc_r = swu = swd = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) sxu[c] = sxd[c] = 0.f;
          }
          const bool topband = ci == L1 - 1;
          if (t == 0 && topband) {
#pragma unroll
            for (int c = 0; c < C; ++c) carry[c] = 0.f;
          }
          const float sd = a == b ? 1.f : 2.f;
          float xu[C], xd[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            xu[c] = xs[((ci + 1) * C + c) * TR + r];
            xd[c] = xs[(ci * C + c) * TR + r];
          }
          float gu_r = gval<C>(xs, yg, ci + 1, c1, r, ys_stride, tc);
          float gd_r = gval<C>(xs, yg, ci, c1, r, ys_stride, tc);
#pragma unroll
          for (int kk = SPAN - 1; kk >= 0; --kk) {
            if (kk < nspan) {
              const int cj = c0 + kk;
              const float tp[M] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w};
              if (kk > 0) {  // the next coarse column's tops, in flight meanwhile
                na = tops[64 * (kk - 1)];
                nb = tops[64 * (kk - 1) + 32];
              }
              const float gu_l = gval<C>(xs, yg, ci + 1, cj, r, ys_stride, tc);
              const float gd_l = gval<C>(xs, yg, ci, cj, r, ys_stride, tc);
              const Coef q = coef(gu_r, gu_l, gd_r, gd_l);
              const float Bi = 1.f / q.B;
              float s1 = 0.f, s2 = 0.f;
#pragma unroll
              for (int tt = M - 1; tt >= 0; --tt) {
                const int j = cj * M + tt + 1;              // node column
                const float ar = tt == M - 1 ? Ar : q.A;    // cell column j
                const float br = tt == M - 1 ? Br : q.B;
                // adjoint of the band's rows at column j
                // (the terms from column j+1 first, so each chain runs through
                // one fma a row)
                float Ln[M + 1];
                const float lt = topband ? (j == G ? sd : 0.f) : lamb[kk * M + tt];
                Ln[M] = fmaf(Lm[M], ar, lt);
#pragma unroll
                for (int s = M - 1; s >= 1; --s)
                  Ln[s] = fmaf(Ln[s + 1], q.A, fmaf(Lm[s], ar, -Lm[s + 1] * br));
                // partial adjoint of node row 8ci, for the band below
                lamb[kk * M + tt] = fmaf(Ln[1], q.A, -Lm[1] * br);
                // primal of column j-1, rebuilt toward -j from column j, and the
                // sums of cells (s, j-1) that dz weighs
                float Pn[M + 1], u[M];
                if (j == 1) {
#pragma unroll
                  for (int s = 0; s <= M; ++s) Pn[s] = 1.f;
#pragma unroll
                  for (int s = 0; s < M; ++s) u[s] = 1.f + P[s];
                } else {
                  Pn[M] = tp[tt];
#pragma unroll
                  for (int s = M - 1; s >= 0; --s) {
                    u[s] = Pn[s + 1] + P[s];
                    Pn[s] = fmaf(u[s], q.A, -P[s + 1]) * Bi;
                  }
                  if (ci == 0) Pn[0] = 1.f;
                }
                // dz of cells (s, j-1): weight λ[s+1][j]
#pragma unroll
                for (int s = 0; s < M; ++s) {
                  s1 = fmaf(Ln[s + 1], u[s], s1);
                  s2 = fmaf(Ln[s + 1], Pn[s], s2);
                }
#pragma unroll
                for (int s = 0; s <= M; ++s) {
                  P[s] = Pn[s];
                  Lm[s] = Ln[s];
                }
              }
              const float dinc = ((0.5f + q.z * I6) * s1 + (q.z * I6) * s2) * ZS;
              pull_back<C>(dinc - dinc_r, gu_r, gd_r, yg + (cj + 1) * ys_stride, tc,
                           dmy + (kk + 1) * C * NT, xu, xd, sxu, sxd, swu, swd);
              dinc_r = dinc;
              gu_r = gu_l;
              gd_r = gd_l;
              Ar = q.A;
              Br = q.B;
            }
          }
          if (t == 0) {
            pull_back<C>(-dinc_r, gu_r, gd_r, yg, tc, dmy, xu, xd, sxu, sxd, swu, swd);
            // static row ci+1 is complete: its lower-row part came from band ci+1
#pragma unroll
            for (int c = 0; c < C; ++c) {
              rv[c] = carry[c] + 2.f * (xu[c] * swu - sxu[c]);
              carry[c] = 2.f * (xd[c] * swd - sxd[c]);
              rv0[c] = ci == 0 ? carry[c] : 0.f;
            }
          }
        }
        prefetch(k + 1);
        // the row-path sums over the warp's groups (lanes at position 0)
#pragma unroll
        for (int o = g; o < 32; o <<= 1) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            rv[c] += __shfl_xor_sync(FULL, rv[c], o);
            rv0[c] += __shfl_xor_sync(FULL, rv0[c], o);
          }
        }
        if (lane == 0 && mine) {
          float* w = dxw + (r * NW + warp) * LC;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            w[(ci + 1) * C + c] = rv[c];
            if (ci == 0) w[c] = rv0[c];
          }
        }
        // hand-off to lane t-1
#pragma unroll
        for (int s = 0; s <= M; ++s) {
          P[s] = __shfl_down_sync(FULL, P[s], 1, g);
          Lm[s] = __shfl_down_sync(FULL, Lm[s], 1, g);
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
    __syncthreads();

    // ---- per-tile partials ------------------------------------------------
    for (int e = tid; e < TR * LC; e += NT) {
      const int rr = e / LC, k = e % LC;
      const int aa = I * TR + rr;
      if (aa < n) {
        float s = 0.f;
        for (int w = 0; w < NW; ++w) s += dxw[(rr * NW + w) * LC + k];
        rowpart[((size_t)J * n + aa) * LC + k] = s;
      }
    }
    if (b < n) {
      float* dst = colpart + ((size_t)I * n + b) * LC;
      for (int sl = t == 0 ? 0 : 1; sl <= nspan; ++sl)
        for (int c = 0; c < C; ++c) dst[(c0 + sl) * C + c] = dmy[(sl * C + c) * NT];
    }
  }
}

// dX[a] = ½·rsqrt(h)·(Σ row partials of a + Σ column partials of a), summed
// over the active tiles in tile order (deterministic).
__global__ void reduce_partials_kernel(const float* __restrict__ rowpart,
                                       const float* __restrict__ colpart,
                                       const float* __restrict__ sptr,
                                       const unsigned char* __restrict__ present,
                                       float* __restrict__ dX, int n, int LC,
                                       int nI, int nJ, int tc) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * LC) return;
  const int a = idx / LC, k = idx % LC;
  float s = 0.f;
  // row tiles (a/TR, J) are active for J >= (a/TR)·TR / tc; with a tile
  // subset (present != null, [nI, nJ]) only the launched tiles wrote a slot
  const int ia = a / TR, ja = a / tc;
  for (int J = (ia * TR) / tc; J < nJ; ++J)
    if (!present || present[ia * nJ + J]) s += rowpart[((size_t)J * n + a) * LC + k];
  // column tiles (I, a/tc) are active for I·TR <= (a/tc)·tc + tc - 1
  const int imax = min(nI - 1, (ja * tc + tc - 1) / TR);
  for (int I = 0; I <= imax; ++I)
    if (!present || present[I * nJ + ja]) s += colpart[((size_t)I * n + a) * LC + k];
  dX[idx] = (0.5f * sptr[0]) * s;
}

template <int SPAN, int C>
cudaError_t grid_blocks(int L, int g, int n_tiles, int* blocks) {
  const size_t smem = smem_floats(L, C, g, SPAN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block3_kernel<SPAN, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block3_kernel<SPAN, C>,
                                                      NT, smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = min(per_sm * sms, n_tiles);
  return cudaSuccess;
}

template <int SPAN, int C>
cudaError_t launch(const float* X, const float* s, const int* tiles, int n_tiles,
                   float* K, float* rowpart, float* colpart, float* scratch,
                   int blocks, int n, int L, int g, cudaStream_t stream) {
  const size_t smem = smem_floats(L, C, g, SPAN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block3_kernel<SPAN, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  block3_kernel<SPAN, C><<<blocks, NT, smem, stream>>>(X, s, tiles, n_tiles, K, rowpart,
                                                       colpart, scratch, n, L, g);
  return cudaGetLastError();
}

// The plan (kernels/sigkernel_block3.py::block3_plan) picks g and the span
// template; these are the shapes the kernel takes: C ≤ 3 at L ≤ 64 (span
// template 3 or 5), C = 4..8 at L·C ≤ 128 (span template 3).
bool valid(int L, int C, int g, int span) {
  if (L < 2 || L > 64 || C < 1 || C > 8 || (C > 3 && (L * C > 128 || span != 3)))
    return false;
  if (g < 1 || g > 16 || g > L - 1 || (g & (g - 1)) != 0) return false;
  if (span != 3 && span != 5) return false;
  return (L - 1 + g - 1) / g <= span;
}

}  // namespace

// one instantiation per (span template, C) of valid
#define K2_DISPATCH(RET, FN, ...)                                   \
  switch (span * 16 + C) {                                          \
    case 49: RET FN<3, 1>(__VA_ARGS__); break;                      \
    case 50: RET FN<3, 2>(__VA_ARGS__); break;                      \
    case 51: RET FN<3, 3>(__VA_ARGS__); break;                      \
    case 52: RET FN<3, 4>(__VA_ARGS__); break;                      \
    case 53: RET FN<3, 5>(__VA_ARGS__); break;                      \
    case 54: RET FN<3, 6>(__VA_ARGS__); break;                      \
    case 55: RET FN<3, 7>(__VA_ARGS__); break;                      \
    case 56: RET FN<3, 8>(__VA_ARGS__); break;                      \
    case 81: RET FN<5, 1>(__VA_ARGS__); break;                      \
    case 82: RET FN<5, 2>(__VA_ARGS__); break;                      \
    case 83: RET FN<5, 3>(__VA_ARGS__); break;                      \
    default: return (int)cudaErrorInvalidValue;                     \
  }

extern "C" {

// Number of persistent blocks for a launch: the blocks resident on the
// device at once, at most one per tile. The caller sizes the scratch by it.
int sigkernel_block3_grid(int L, int C, int g, int span, int n_tiles, int* blocks) {
  if (!valid(L, C, g, span)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  K2_DISPATCH(err =, grid_blocks, L, g, n_tiles, blocks)
  return (int)err;
}

// X [n, L, C], s [1] = rsqrt(h), tiles [n_tiles, 2] int32 (I, J) with
// I·8 <= J·tc + tc - 1 (tc = 128/g), K [n, n], dX [n, L, C], rowpart
// [ceil(n/tc), n, L·C], colpart [ceil(n/8), n, L·C], scratch [blocks·4·
// (8(L-1)+g-1)·(256·span + 256/g)]; fp32, contiguous, on the stream's
// device. present: null for the whole tile list, else [ceil(n/8), ceil(n/tc)]
// bytes, 1 for each tile of a subset list (the reduction sums only the slots
// those tiles wrote; K holds only their pairs). Returns cudaGetLastError()
// after both launches (0 on success).
int sigkernel_block3_gram_grad(const float* X, const float* s, const int* tiles,
                               float* K, float* dX, float* rowpart, float* colpart,
                               float* scratch, const unsigned char* present,
                               int n_tiles, int blocks, int n, int L, int C, int g,
                               int span, void* stream) {
  if (!valid(L, C, g, span)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  K2_DISPATCH(err =, launch, X, s, tiles, n_tiles, K, rowpart, colpart, scratch, blocks,
              n, L, g, st)
  if (err != cudaSuccess) return (int)err;
  const int LC = L * C;
  const int total = n * LC;
  const int tc = NT / g;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      rowpart, colpart, s, present, dX, n, LC, (n + TR - 1) / TR, (n + tc - 1) / tc, tc);
  return (int)cudaGetLastError();
}

}  // extern "C"
