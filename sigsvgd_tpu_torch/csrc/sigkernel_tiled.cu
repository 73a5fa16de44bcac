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
// Σ_p gout[p]·k[p] with respect to z. z and dz are pair-minor [lx1][ly1][P].
//
// What bounds it on an H100. At the flagship pair list (524,800 pairs of
// 40-point paths) every pair sweeps (8·39)^2 ≈ 97k fine cells: 2.1e11 fp32
// operations forward (3.1 ms at 67 TFLOP/s), 7.3e11 backward (10.8 ms),
// against 7.8 and 11 GB of increments and checkpoints (2.3 and 3.3 ms): the
// operations bound both. A pair's fine row (8·ly1+1 floats) fits neither one
// thread's registers nor, for enough threads, shared memory, so the design
// spreads it over the registers of a group of lanes, as K2 does
// (csrc/sigkernel_block3.cu):
//   * a lane group per pair: g lanes (a power of two, the fewest that leave
//     a lane at most 5 coarse columns: 8 at ly1 = 39, 16 at 48, 1 up to 5)
//     split the ly1 coarse columns into spans [t·ly1/g, (t+1)·ly1/g); a
//     block (4 warps) takes a tile of 8 × 128/g pairs, and each group walks
//     its 8 pairs band by band as one pipeline, so lanes idle only at its
//     ends;
//   * forward: at step k lane t sweeps band k - t over its span, its fine
//     row in registers, z read once per coarse cell, and hands its 8
//     right-edge values and the corner to lane t+1 by __shfl_up_sync. It
//     writes its span of the band's top row only at the checkpoint bands
//     (every bpc = min(6, lx1)-th band and the last), into per-pair slots
//     that outlive the launch (8·ly1 floats a pair and slot, column 0 being
//     1). The lanes of one position t in a warp's groups reach a checkpoint
//     band at the same step (lane t at step k0 + t), so for each tile,
//     slot, warp and pipeline position the slots hold lane position t's
//     span float4 by float4 with the warp's 32/g groups side by side: each
//     store writes 32/g adjacent float4s (whole 32-byte sectors), lane
//     position t's 2·span stores of a step fill 2·span·512/g contiguous
//     bytes, and each lane reads back only what it wrote. Without
//     checkpoints nothing but k is written;
//   * backward: the primal is rebuilt toward +j from each band's top row,
//       k[i-1][j] = (k[i][j] + k[i-1][j-1]·B)·A⁻¹ - k[i][j-1],
//     stable for general increments (K2's -j scheme divides by B and drifts
//     at large |z|), re-anchored at each checkpoint. This rebuild runs left
//     to right while the adjoint runs right to left, so each step runs two
//     pipelines over the group's units (pair, band; bands top down):
//       1. the rebuild pipeline: lane t rebuilds unit k - t over its span
//          from its top row (shared memory) and the span's left-edge column
//          (9 values from lane t-1, __shfl_up_sync), hands its right edge to
//          lane t+1 and keeps the left edge in its ring in shared memory;
//       2. the adjoint pipeline, right to left: lane t takes unit
//          k - (2g-1-t), g steps behind, so that its ring already holds the
//          unit's left edge. It rebuilds its span again from that edge and
//          its own top row (registers) to find each coarse cell's left
//          column (shared memory), then walks the cells right to left:
//          rebuilds the cell's 9 × 9 nodes in registers (the same
//          arithmetic, so the same values), runs the adjoint down its
//          columns
//            ĝ[i][j] = A(i,j+1)·ĝ[i][j+1] + A(i+1,j)·ĝ[i+1][j]
//                      - B(i+1,j+1)·ĝ[i+1][j+1]
//          with the adjoint row above the band in shared memory, sums the
//          cell's dz and writes it once; the adjoint column at its left
//          edge and the coefficients beside it go to lane t-1 by
//          __shfl_down_sync.
//     Lane t's ring holds 2g - 2t left edges (9 floats each). The lanes of
//     a warp reach checkpoint bands at different steps, so a checkpoint row
//     loaded when its unit starts would hold up every step of the warp:
//     both pipelines' rows are copied a step ahead by cp.async. No fine row
//     or adjoint row goes to device memory; z, the checkpoints, the
//     cotangent and dz are the only device traffic. Each dz is written by
//     the lane that owns its cell: no atomics.
// Each node keeps the twin's rounding (the forward's product by A fused
// into its subtraction; the rebuild's two fused multiply-adds; the
// adjoint's chain), so k is the twin's bit for bit. The backward takes 227
// registers and 110 KB of shared memory a block at ly1 = 39 (two blocks an
// SM) and rebuilds each fine node three times; the issue rate at 8 warps
// an SM and the instructions around the arithmetic hold it (PERF.md §7).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr int TR = 8;    // pairs a group walks (tile rows)
constexpr int M = 8;     // fine cells per coarse cell side (2^λ)
constexpr unsigned FULL = 0xffffffffu;
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

// Where a lane's span of a pair's fine row lies in the checkpoints, in
// float4s: per (tile, slot, warp, pipeline position) a block of
// 32/g · 2·ly1 float4s; float4 i of the lane at span start c0, group q in
// the warp, at (2·c0 + i)·32/g + q. Mirrored by kernels/sigkernel_tiled.py.
struct CkLayout {
  int c0, q, ngw;
  size_t block_f4;  // float4s of one (tile, slot, warp, position) block

  __device__ int f4(int i) const { return (2 * c0 + i) * ngw + q; }
  __device__ size_t base(size_t tile, int slot, int nslots, int warp, int r) const {
    return (((tile * nslots + slot) * NW + warp) * TR + r) * block_f4;
  }
};

struct Lanes {
  int t, q, lane, warp, gi, c0, nspan;
  CkLayout ck;
};

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The backward's unit u (pair u / lx1, bands top down) has its top row in a
// checkpoint: copy the lane's span of it into dst ([2·SPAN][NT] float4s,
// thread-minor) asynchronously (cp.async); nothing otherwise. The thread's
// own earlier reads and writes of dst are emitted before the copies (a
// compiler barrier: the copy instructions do not tell the compiler that
// they write shared memory).
template <int SPAN>
__device__ __forceinline__ void fetch_top(float4* dst, const float4* ck, const Lanes& L, int u,
                                          int U, int lx1, int bpc, int nslots, size_t tile,
                                          size_t pbase, int NG, size_t P) {
  asm volatile("" ::: "memory");
  if (u < 0 || u >= U) return;
  const int r = u / lx1, b = lx1 - 1 - (u - r * lx1);
  if (pbase + (size_t)r * NG >= P || !(b == lx1 - 1 || (b + 1) % bpc == 0)) return;
  const float4* src = ck + L.ck.base(tile, b / bpc, nslots, L.warp, r);
#pragma unroll
  for (int i = 0; i < 2 * SPAN; ++i)
    if (i < 2 * L.nspan) cp_async16(dst + i * NT, src + L.ck.f4(i));
}

__device__ __forceinline__ Lanes lanes(int g, int ly1) {
  Lanes L;
  const int tid = threadIdx.x;
  L.lane = tid & 31;
  L.warp = tid >> 5;
  L.t = L.lane & (g - 1);
  L.q = L.lane / g;
  L.gi = tid / g;
  L.c0 = (L.t * ly1) / g;
  L.nspan = ((L.t + 1) * ly1) / g - L.c0;
  L.ck.c0 = L.c0;
  L.ck.q = L.q;
  L.ck.ngw = 32 / g;
  L.ck.block_f4 = (size_t)(32 / g) * 2 * ly1;
  return L;
}

template <int SPAN>
__global__ void __launch_bounds__(NT, 4)
tiled_fwd_kernel(const float* __restrict__ z, float* __restrict__ kout, float4* __restrict__ ck,
                 int P_, int lx1, int ly1, int g, int bpc, int nslots) {
  const size_t P = P_;
  const Lanes L = lanes(g, ly1);
  const int t = L.t, nspan = L.nspan;
  const int NG = NT / g;
  const size_t tile = blockIdx.x;
  const size_t pbase = tile * TR * NG + L.gi;
  const int U = TR * lx1, steps = U + g - 1;

  float row[M * SPAN];  // the span's node row below the band, then its top
  float left[M], corner[M], inL[M], inC = 1.f;
#pragma unroll
  for (int s = 0; s < M; ++s) left[s] = corner[s] = inL[s] = 1.f;
#pragma unroll
  for (int i = 0; i < M * SPAN; ++i) row[i] = 1.f;
  for (int k = 0; k < steps; ++k) {
    const int u = k - t;
    if (u >= 0 && u < U) {
      const int r = u / lx1, b = u - r * lx1;
      const size_t p = pbase + (size_t)r * NG;
      if (p < P) {
        if (b == 0) {
#pragma unroll
          for (int i = 0; i < M * SPAN; ++i) row[i] = 1.f;
        }
        // the carries at node column 8c0, from lane t-1 (1 on the boundary)
#pragma unroll
        for (int s = 0; s < M; ++s) {
          corner[s] = t == 0 ? 1.f : (s == 0 ? inC : inL[s - 1]);
          left[s] = t == 0 ? 1.f : inL[s];
        }
        float zc[SPAN];
        const float* zb = z + ((size_t)b * ly1 + L.c0) * P + p;
#pragma unroll
        for (int kk = 0; kk < SPAN; ++kk) zc[kk] = kk < nspan ? zb[(size_t)kk * P] : 0.f;
        const bool keep = ck != nullptr && ((b + 1) % bpc == 0 || b == lx1 - 1);
        float4* dst = keep ? ck + L.ck.base(tile, b / bpc, nslots, L.warp, r) : nullptr;
#pragma unroll
        for (int kk = 0; kk < SPAN; ++kk) {
          if (kk < nspan) {
            const Coef q = coef(zc[kk]);
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
              dst[L.ck.f4(2 * kk)] =
                  make_float4(row[kk * M], row[kk * M + 1], row[kk * M + 2], row[kk * M + 3]);
              dst[L.ck.f4(2 * kk + 1)] = make_float4(row[kk * M + 4], row[kk * M + 5],
                                                     row[kk * M + 6], row[kk * M + 7]);
            }
          }
        }
        if (t == g - 1 && b == lx1 - 1) kout[p] = left[M - 1];
      }
    }
    inC = __shfl_up_sync(FULL, corner[0], 1, g);
#pragma unroll
    for (int s = 0; s < M; ++s) inL[s] = __shfl_up_sync(FULL, left[s], 1, g);
  }
}

// Shared memory of a backward block, in floats: per thread (thread-minor,
// [index][NT]) the rebuild pipeline's top row (8·SPAN, in float4s), the
// adjoint row above the band (8·SPAN) and the left columns of coarse cells
// 1.. of the span (8·(SPAN-1)); the next adjoint unit's checkpoint row
// (8·SPAN, in float4s); per
// group the rings of lanes 1..g-1, (2g-2t) left edges of 9 floats each
// (g(g-1)·9 floats a group).
__host__ __device__ inline size_t bwd_smem_floats(int span, int g) {
  return (size_t)NT * (M * span * 3 + M * (span - 1)) + (size_t)NT * (g - 1) * 9;
}

template <int SPAN>
__global__ void __launch_bounds__(NT, 2)
tiled_bwd_kernel(const float* __restrict__ z, const float4* __restrict__ ck,
                 const float* __restrict__ gout, float* __restrict__ dz, int P_, int lx1,
                 int ly1, int g, int bpc, int nslots) {
  extern __shared__ float smem[];
  const size_t P = P_;
  const Lanes L = lanes(g, ly1);
  const int t = L.t, nspan = L.nspan, tid = threadIdx.x;
  const int NG = NT / g;
  const int G = M * ly1;
  const size_t tile = blockIdx.x;
  const size_t pbase = tile * TR * NG + L.gi;
  const int U = TR * lx1, steps = U + 2 * g - 1;
  float4* row1 = reinterpret_cast<float4*>(smem) + tid;  // [2·SPAN][NT]
  float* lam = smem + M * SPAN * NT + tid;               // [8·SPAN][NT]
  float* lefts = lam + M * SPAN * NT;        // [8·(SPAN-1)][NT]: cell kk at (kk-1)·8
  float4* top2 = reinterpret_cast<float4*>(smem + (M * SPAN * 2 + M * (SPAN - 1)) * NT) + tid;
  const int Q = 2 * g - 2 * t;               // the ring's left edges
  float* ring = smem + (size_t)NT * (M * SPAN * 3 + M * (SPAN - 1)) +
                ((size_t)L.gi * g * (g - 1) + (size_t)(t > 0 ? (t - 1) * (2 * g - t) : 0)) * 9;

  float in1[M + 1];            // the rebuild's left-edge column from lane t-1
  float in2[M + 4];            // the adjoint's state from lane t+1
  float row2[M * SPAN];        // the adjoint pipeline's top row, then bottom row
  float zu[SPAN];              // z of the band above (the adjoint's last unit)
#pragma unroll
  for (int s = 0; s <= M; ++s) in1[s] = 1.f;
#pragma unroll
  for (int s = 0; s < M + 4; ++s) in2[s] = 0.f;
#pragma unroll
  for (int i = 0; i < M * SPAN; ++i) row2[i] = 1.f;
#pragma unroll
  for (int kk = 0; kk < SPAN; ++kk) zu[kk] = 0.f;
  // the checkpoint rows a unit starts from are copied a step ahead (the
  // lanes of a warp reach checkpoint bands at different steps, so a load at
  // the unit's start would hold up every step of the warp)
  fetch_top<SPAN>(row1, ck, L, -t, U, lx1, bpc, nslots, tile, pbase, NG, P);
  cp_async_commit();

  for (int k = 0; k < steps; ++k) {
    cp_async_wait_all();
    // ---- 1. the rebuild pipeline: unit k - t, left to right ---------------
    float out1[M + 1];
#pragma unroll
    for (int s = 0; s <= M; ++s) out1[s] = 1.f;
    const int u1 = k - t;
    if (u1 >= 0 && u1 < U) {
      const int r = u1 / lx1, b = lx1 - 1 - (u1 - r * lx1);
      const size_t p = pbase + (size_t)r * NG;
      if (p < P) {  // row1 holds the top row (its checkpoint, fetched a step ago)
        float prev[M + 1];
#pragma unroll
        for (int s = 0; s <= M; ++s) prev[s] = t == 0 ? 1.f : in1[s];
        if (t > 0) {
          float* e = ring + (u1 % Q) * 9;
#pragma unroll
          for (int s = 0; s <= M; ++s) e[s] = in1[s];
        }
        float zc[SPAN];
        const float* zb = z + ((size_t)b * ly1 + L.c0) * P + p;
#pragma unroll
        for (int kk = 0; kk < SPAN; ++kk) zc[kk] = kk < nspan ? zb[(size_t)kk * P] : 0.f;
#pragma unroll
        for (int kk = 0; kk < SPAN; ++kk) {
          if (kk < nspan) {
            const Coef q = coef(zc[kk]);
            const float Ai = __frcp_rn(q.A);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float4* w = row1 + (2 * kk + h) * NT;
              const float4 tv = *w;
              const float tops[4] = {tv.x, tv.y, tv.z, tv.w};
              float bots[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                float cur[M + 1];
                cur[M] = tops[c];
#pragma unroll
                for (int s = M - 1; s >= 0; --s)
                  cur[s] = rebuild(prev[s], cur[s + 1], prev[s + 1], q.B, Ai);
                bots[c] = cur[0];
#pragma unroll
                for (int s = 0; s <= M; ++s) prev[s] = cur[s];
              }
              *w = make_float4(bots[0], bots[1], bots[2], bots[3]);
            }
          }
        }
#pragma unroll
        for (int s = 0; s <= M; ++s) out1[s] = prev[s];
      }
    }
    fetch_top<SPAN>(row1, ck, L, u1 + 1, U, lx1, bpc, nslots, tile, pbase, NG, P);

    // ---- 2. the adjoint pipeline: unit k - (2g-1-t), right to left ---------
    // out2: ĝ at the span's left node column, rows 8b+1..8b+8 (0..7); ĝ of
    // the row above there (8); A, B of the span's first cell (9, 10) and B
    // of the cell above it (11)
    float out2[M + 4];
#pragma unroll
    for (int s = 0; s < M + 4; ++s) out2[s] = 0.f;
    const int u2 = k - (2 * g - 1 - t);
    if (u2 >= 0 && u2 < U) {
      const int r = u2 / lx1, b = lx1 - 1 - (u2 - r * lx1);
      const bool topband = b == lx1 - 1;
      const size_t p = pbase + (size_t)r * NG;
      if (p < P && (topband || (b + 1) % bpc == 0)) {
#pragma unroll
        for (int i = 0; i < 2 * SPAN; ++i) {
          const float4 v = top2[i * NT];
          row2[4 * i] = v.x;
          row2[4 * i + 1] = v.y;
          row2[4 * i + 2] = v.z;
          row2[4 * i + 3] = v.w;
        }
      }
    }
    fetch_top<SPAN>(top2, ck, L, u2 + 1, U, lx1, bpc, nslots, tile, pbase, NG, P);
    cp_async_commit();
    if (u2 >= 0 && u2 < U) {
      const int r = u2 / lx1, b = lx1 - 1 - (u2 - r * lx1);
      const bool topband = b == lx1 - 1;
      const size_t p = pbase + (size_t)r * NG;
      if (p < P) {
        // the span's left-edge column, rows 8b..8b+8 at node column 8c0
        float edge[M + 1];
        if (t == 0) {
#pragma unroll
          for (int s = 0; s <= M; ++s) edge[s] = 1.f;
        } else {
          const float* e = ring + (u2 % Q) * 9;
#pragma unroll
          for (int s = 0; s <= M; ++s) edge[s] = e[s];
        }
        float zc[SPAN];
        const float* zb = z + ((size_t)b * ly1 + L.c0) * P + p;
#pragma unroll
        for (int kk = 0; kk < SPAN; ++kk) zc[kk] = kk < nspan ? zb[(size_t)kk * P] : 0.f;
        // (i) the left column of each cell after the first
        {
          float prev[M + 1];
#pragma unroll
          for (int s = 0; s <= M; ++s) prev[s] = edge[s];
#pragma unroll
          for (int kk = 0; kk < SPAN - 1; ++kk) {
            if (kk < nspan - 1) {
              const Coef q = coef(zc[kk]);
              const float Ai = __frcp_rn(q.A);
#pragma unroll
              for (int tt = 0; tt < M; ++tt) {
                float cur[M + 1];
                cur[M] = row2[kk * M + tt];
#pragma unroll
                for (int s = M - 1; s >= 0; --s)
                  cur[s] = rebuild(prev[s], cur[s + 1], prev[s + 1], q.B, Ai);
#pragma unroll
                for (int s = 0; s <= M; ++s) prev[s] = cur[s];
              }
#pragma unroll
              for (int s = 0; s < M; ++s) lefts[(kk * M + s) * NT] = prev[s];
            }
          }
        }
        // (ii) coarse cells right to left
        const float sd = gout[p];
        float gR[M + 1];  // ĝ[8b+s][j+1], s = 1..8
        gR[0] = 0.f;
#pragma unroll
        for (int s = 1; s <= M; ++s) gR[s] = t == g - 1 ? 0.f : in2[s - 1];
        float lamR = t == g - 1 ? 0.f : in2[M];        // ĝ[8b+9][j+1]
        float Ar = t == g - 1 ? 0.f : in2[M + 1];      // cell cc+1 of band b
        float Br = t == g - 1 ? 0.f : in2[M + 2];
        float Bur = t == g - 1 ? 0.f : in2[M + 3];     // cell cc+1 of band b+1
#pragma unroll
        for (int kk = SPAN - 1; kk >= 0; --kk) {
          if (kk < nspan) {
            const int cc = L.c0 + kk;
            const Coef q = coef(zc[kk]);
            const float Ai = __frcp_rn(q.A);
            const Coef qu = topband ? Coef{0.f, 0.f} : coef(zu[kk]);
            // the cell's primal nodes: K[s][c] = k[8b+s][8cc+c]
            float K[M + 1][M + 1];
#pragma unroll
            for (int s = 0; s < M; ++s) K[s][0] = kk ? lefts[((kk - 1) * M + s) * NT] : edge[s];
            K[M][0] = kk ? row2[kk * M - 1] : edge[M];
#pragma unroll
            for (int c = 1; c <= M; ++c) K[M][c] = row2[kk * M + c - 1];
#pragma unroll
            for (int c = 1; c <= M; ++c) {
#pragma unroll
              for (int s = M - 1; s >= 0; --s)
                K[s][c] = rebuild(K[s][c - 1], K[s + 1][c], K[s + 1][c - 1], q.B, Ai);
            }
            if (b > 0) {
#pragma unroll
              for (int c = 1; c <= M; ++c) row2[kk * M + c - 1] = K[0][c];
            }
            // the adjoint down each column, columns right to left; the cell's dz
            float s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int c = M; c >= 1; --c) {
              const int j = cc * M + c;
              float* lj = lam + (kk * M + c - 1) * NT;
              const float ar = c == M ? Ar : q.A;     // A(i, j+1)
              const float br = c == M ? Br : q.B;     // B(i+1, j+1), rows inside the band
              const float bur = c == M ? Bur : qu.B;  // B(i+1, j+1), the top row
              const float lamj = topband ? 0.f : *lj;  // ĝ[8b+9][j]
              float gN[M + 1];
              float gv = __fmaf_rn(ar, gR[M], __fmaf_rn(qu.A, lamj, -__fmul_rn(bur, lamR)));
              if (topband && j == G) gv = gv + sd;
              gN[M] = gv;
#pragma unroll
              for (int s = M - 1; s >= 1; --s)
                gN[s] = __fmaf_rn(ar, gR[s], __fmaf_rn(q.A, gN[s + 1], -__fmul_rn(br, gR[s + 1])));
#pragma unroll
              for (int s = M; s >= 1; --s) {
                s1 = __fmaf_rn(gN[s], __fadd_rn(K[s][c - 1], K[s - 1][c]), s1);
                s2 = __fmaf_rn(gN[s], K[s - 1][c - 1], s2);
              }
              if (b > 0) *lj = gN[1];  // ĝ[8b+1][j] for the band below
              lamR = lamj;
#pragma unroll
              for (int s = 1; s <= M; ++s) gR[s] = gN[s];
            }
            const float zs = __fmul_rn(zc[kk], I6);
            dz[((size_t)b * ly1 + cc) * P + p] =
                __fmaf_rn(__fadd_rn(0.5f, zs), s1, __fmul_rn(zs, s2));
            Ar = q.A;
            Br = q.B;
            Bur = qu.B;
          }
        }
#pragma unroll
        for (int s = 0; s < M; ++s) out2[s] = gR[s + 1];
        out2[M] = lamR;
        out2[M + 1] = Ar;
        out2[M + 2] = Br;
        out2[M + 3] = Bur;
#pragma unroll
        for (int kk = 0; kk < SPAN; ++kk) zu[kk] = zc[kk];
      }
    }

    // ---- hand-offs: the rebuild's right edge to lane t+1, the adjoint's
    // left edge to lane t-1
#pragma unroll
    for (int s = 0; s <= M; ++s) in1[s] = __shfl_up_sync(FULL, out1[s], 1, g);
#pragma unroll
    for (int s = 0; s < M + 4; ++s) in2[s] = __shfl_down_sync(FULL, out2[s], 1, g);
  }
}

// The plan (kernels/sigkernel_tiled.py::tiled_plan) picks g and the span
// template; these are the shapes the kernels take.
bool valid(int lx1, int ly1, int g, int span) {
  if (lx1 < 1 || ly1 < 1 || ly1 > 48) return false;
  if (g < 1 || g > 16 || g > ly1 || (g & (g - 1)) != 0) return false;
  if (span != 3 && span != 5) return false;
  return (ly1 + g - 1) / g <= span;
}

int tiles_of(int P, int g) {
  const int np = TR * (NT / g);
  return (P + np - 1) / np;
}

template <int SPAN>
cudaError_t resident(int g, int* fwd, int* bwd) {
  const size_t smem = bwd_smem_floats(SPAN, g) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tiled_bwd_kernel<SPAN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(fwd, tiled_fwd_kernel<SPAN>, NT, 0);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(bwd, tiled_bwd_kernel<SPAN>, NT, smem);
}

template <int SPAN>
cudaError_t launch_fwd(const float* z, float* k, float* ck, int P, int lx1, int ly1, int g,
                       int bpc, int nslots, cudaStream_t st) {
  tiled_fwd_kernel<SPAN><<<tiles_of(P, g), NT, 0, st>>>(
      z, k, reinterpret_cast<float4*>(ck), P, lx1, ly1, g, bpc, nslots);
  return cudaGetLastError();
}

template <int SPAN>
cudaError_t launch_bwd(const float* z, const float* ck, const float* gout, float* dz, int P,
                       int lx1, int ly1, int g, int bpc, int nslots, cudaStream_t st) {
  const size_t smem = bwd_smem_floats(SPAN, g) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tiled_bwd_kernel<SPAN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tiled_bwd_kernel<SPAN><<<tiles_of(P, g), NT, smem, st>>>(
      z, reinterpret_cast<const float4*>(ck), gout, dz, P, lx1, ly1, g, bpc, nslots);
  return cudaGetLastError();
}

}  // namespace

#define K5_DISPATCH(FN, ...)                          \
  switch (span) {                                     \
    case 3: return (int)FN<3>(__VA_ARGS__);           \
    case 5: return (int)FN<5>(__VA_ARGS__);           \
    default: return (int)cudaErrorInvalidValue;       \
  }

extern "C" {

// Blocks of each kernel resident on one SM at once (the backward with its
// shared memory), for the plan's report.
int sigkernel_tiled_resident(int ly1, int g, int span, int* fwd, int* bwd) {
  if (!valid(1, ly1, g, span)) return (int)cudaErrorInvalidValue;
  K5_DISPATCH(resident, g, fwd, bwd)
}

// z [lx1, ly1, P] scaled increments; k [P]; ck (null: values only) the
// checkpoints of nslots = ceil(lx1/bpc) slots, tiles·nslots·1024/g·8·ly1
// floats (tiles of 1024/g pairs) in the lane layout above. fp32, contiguous,
// on the stream's device; g and span from the plan. Returns
// cudaGetLastError() after the launch.
int sigkernel_tiled_fwd(const float* z, float* k, float* ck, int P, int lx1, int ly1, int g,
                        int span, int bpc, int nslots, void* stream) {
  if (!valid(lx1, ly1, g, span) || bpc < 1 || P < 1) return (int)cudaErrorInvalidValue;
  K5_DISPATCH(launch_fwd, z, k, ck, P, lx1, ly1, g, bpc, nslots,
              static_cast<cudaStream_t>(stream))
}

// K5's backward: z and ck as the forward wrote them (bpc = min(6, lx1)),
// gout [P]; writes dz [lx1, ly1, P].
int sigkernel_tiled_bwd(const float* z, const float* ck, const float* gout, float* dz, int P,
                        int lx1, int ly1, int g, int span, int bpc, int nslots, void* stream) {
  if (!valid(lx1, ly1, g, span) || bpc < 1 || P < 1) return (int)cudaErrorInvalidValue;
  K5_DISPATCH(launch_bwd, z, ck, gout, dz, P, lx1, ly1, g, bpc, nslots,
              static_cast<cudaStream_t>(stream))
}

}  // extern "C"
