// λ=0 symmetric signature-kernel Gram + full-sum pull-back gradient (K1),
// and the values-only Gram (K3).
//
// K1 replaces the TPU kernel sigsvgd_tpu/kernels/pallas_sigkernel_block.py::
// _block_kernel (launched by _block_call); K3 replaces ::_block_values_kernel
// (launched by block_gram), the same forward without checkpoints or adjoint.
// Contract, as block_gram_and_grad there: for paths X [n, L, C] fp32 and
// static bandwidth h,
//   K  [n, n]    the λ=0 Goursat-PDE signature kernel with the RBF static
//                kernel exp(-|x_p - y_q|^2 / h), written to [a,b] and [b,a];
//   dX [n, L, C] = ½ ∂(Σ_ab K_ab)/∂X, the detached-second-argument repulsion.
// Each unordered pair a <= b is solved once, with cotangent seed 2 off the
// diagonal and 1 on it.
//
// What bounds it on an H100: arithmetic. Inputs are n·L·C floats and
// outputs n² + n·L·C floats, while every pair runs a (L-1)² cell forward
// sweep and its adjoint (~99k operations with L² exp at L=40, C=2, each
// value counted once), so the operation count over the fp32 CUDA-core rate
// is ~500x the byte count over the memory rate. One thread a pair, as K3
// solves it, would keep the adjoint's per-cell factors in local memory
// (6 KB a pair at L = 40, as K1's first port did); K1 keeps no per-cell
// value off chip:
//   * a lane group per pair: g lanes (a power of two, the fewest that leave
//     a lane at most 5 of the L-1 cell columns: 8 at L = 40, 16 at 64) split
//     the cell columns into spans [t(L-1)/g, (t+1)(L-1)/g); a block (4 warps)
//     takes a tile of 8 row particles × 128/g column particles from a list of
//     the tiles holding a pair a <= b, and each group walks its column's 8
//     pairs in bands of RB = 4 cell rows as one pipeline, so lanes idle only
//     in the g-1 steps at its ends (bands of 4-8 rows measured within 7%:
//     4 the fastest, 143 registers; 7 and 8 spill);
//   * forward: at step k lane t sweeps band k - t over its span, the K row
//     and two static rows of its span in registers, the statics of its node
//     columns formed in the expand form exp(x'·y' - ½|x'|² - ½|y'|²) on paths
//     pre-scaled by √(2/h), one exp a node, from its own copy of its column
//     path in shared memory; it hands its right column (4 values) to lane
//     t+1 by __shfl_up_sync, and writes the band's bottom row over its span
//     and its left column, 10 nodes, to the slot of step k in device scratch
//     (lane-minor float4s, so a warp's store fills whole lines);
//   * adjoint: the same pipeline right to left, bands top down: lane t takes
//     unit k - (g-1-t), copies the slot its forward step wrote (cp.async, a
//     step ahead), rebuilds the band's K rows over its span from it in the
//     forward's rounding and keeps each cell's factor fac = (k[i+1][j] +
//     k[i][j+1])(½ + z/6) + k[i][j]·z/6 of the band in registers, then runs
//     the λ rows top down through the band, each right to left, taking the
//     terms of the cell right of its span (λ·A, λ·B and dz, per row) from
//     lane t+1's hand-off slot in shared memory. A band is rebuilt from its
//     own bottom row and left column, so nothing is rebuilt toward -j (no
//     division) and fac is the twin's bit for bit. The rebuild cannot run in
//     the adjoint's pipeline (it needs lane t-1's column of the same band,
//     which the adjoint reaches later), and a lane's checkpoints and left
//     columns of a run (~100 floats a pair) outlive many steps, so they go
//     to the scratch slots; no per-cell value goes to device or local memory;
//   * pull-back: dz through the statics by the row difference D[i][q] =
//     dz[i][q-1] - dz[i][q], +D on node row i+1 and -D on node row i; a lane
//     owns the node columns inside and at the right edge of its span (lane 0
//     also column 0), so every node is pulled back once, when its row is
//     finished (weights W = dg·g). The column-path gradient of those nodes
//     sums over the band's rows in registers and over the group's 8 pairs in
//     per-lane shared slots; the row-path gradient of each node row sums
//     over the warp's groups by shuffles and over the lanes and the block's
//     warps in per-warp shared sums taken in the schedule's fixed order;
//     per-tile partials and a second kernel summing each particle's partials
//     in tile order give dX: no atomics, deterministic.
//   * no branch divides a warp inside a band: cells past a lane's span and
//     rows past a pair's top are computed on valid statics and not kept
//     (with per-cell branches the same schedule ran 1.5x slower, with a
//     branch a row in the adjoint 1.1x).
// The forward's and the rebuild's statics and sweep round each product and
// sum on its own in the twin's order (so K is the twin's bit for bit); the
// adjoint contracts freely (dX is compared at a scaled 5e-5). 12 warps an
// SM (at most 151 registers, no stack frame).
// Channels: K1 takes C ≤ 3 up to L = 64 and the JAX package's block
// envelope beyond it, C = 4..8 with L·C ≤ 128. What grows with C is per
// lane: the row point of the statics (C+1 floats in registers), the span of
// the column path and its column-path sums ((SPAN+1)(C+1) floats each in
// shared memory), and the band's column-path sums cx[SPAN+1][C] in
// registers through the adjoint. At C ≥ 4 a lane holds at most 3 cell
// columns (span template 3, up to twice the lanes of the C ≤ 3 rule at
// the same L): cx stays within 32 registers and a block's shared memory
// within 72.5 KiB, so three blocks (12 warps) still fit an SM.
// K3, values only at λ=0, takes the JAX package's block envelope (C ≤ 8,
// L·C ≤ 128, L ≤ 64), as K1 does. Its work is the forward alone: per
// pair L² static nodes (~13 instructions each at C = 2, the IEEE expf ~8 of
// them) and (L-1)² cells (14, each product and sum rounded on its own, so
// no FMA), ~42k instructions a pair at L = 40; issued at one an instruction
// slot, the card's issue rate bounds it (~0.66 ms at [1024, 40, 2], ~2.6×
// the fp32 operations bound, which counts an FMA as two). One thread solves
// a pair, which pays no hand-off, pipeline fill or per-lane start; what a
// row-at-a-time sweep loses is the cell chain (each cell's update waits ~12
// cycles on its left neighbour) and three full rows in registers. So:
//   * a block takes a tile of 8 row × 16 column particles from the list of
//     the tiles holding a pair a <= b, and stages the tile's pre-scaled paths
//     with -½|·|² in shared memory (the column paths padded to the length
//     bucket LMAX = 16, 40 or 64 by repeating node L-1);
//   * each thread sweeps its pair in bands of RV cell rows (2 up to L = 40,
//     4 at 64: band_rows) as a skewed wavefront: at step t band row s
//     updates cell (i0 + s, t - s), RV independent chains a step. The band's bottom K row is an [LMAX]
//     register array, its bottom static row the thread's column of a
//     shared [LMAX][128] array (each node read once a band, a step before
//     row 0 needs it; with both rows in registers the 40- and 64-node
//     buckets spilled under these launch bounds); each
//     static node is formed once, serving the two cells that use it, and a
//     column point is loaded once a band for the static nodes of all RV
//     rows; the band's top rows replace the bottom ones behind the
//     wavefront (at most 128 registers at LMAX = 16, 16 warps an SM; 168
//     at 40 and 64, 12 warps);
//   * no branch inside a band: cells past L-1 run on the repeated node (z =
//     0) and are not read, the last band's rows past L-2 run on node row L-1
//     and copy the row below, so the band's top hands on node row L-1;
//   * statics and sweep round as K1's forward and the twin, so K is the
//     twin's bit for bit (and K1's).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr int TR = 8;    // row particles per tile (the pairs a K1 group walks)
constexpr int TC = 16;   // K3: column particles a tile
constexpr int RB = 4;    // K1: cell rows a band (a pipeline step)
constexpr unsigned FULL = 0xffffffffu;
constexpr float I6 = 1.0f / 6.0f;
constexpr float I12 = 1.0f / 12.0f;

// ---- the arithmetic both kernels share ----------------------------------------

struct Coef {
  float z, A, B;
};

// z, A and B of the cell between static rows u (upper) and d, node columns
// q and q+1, rounded as the twin rounds them.
__device__ __forceinline__ Coef coef(float u1, float u0, float d1, float d0) {
  Coef k;
  k.z = ((u1 - u0) - d1) + d0;
  k.A = __fadd_rn(1.f, __fmul_rn(k.z, __fadd_rn(0.5f, __fmul_rn(k.z, I12))));
  k.B = __fsub_rn(1.f, __fmul_rn(__fmul_rn(k.z, k.z), I12));
  return k;
}

// The cell update k[i+1][j+1] = (k[i+1][j] + k[i][j+1])·A - k[i][j]·B with
// sm = k[i+1][j] + k[i][j+1], each operation rounded on its own.
__device__ __forceinline__ float cell(float sm, float prev, const Coef& q) {
  return __fsub_rn(__fmul_rn(sm, q.A), __fmul_rn(prev, q.B));
}

// ---- K3: one thread a pair, a band wavefront, values only ------------------

// Static g = exp(x'·y' - ½|x'|² - ½|y'|²) of a row point x and a column point
// y (each C channels, then -½|·|² at [C]), each product and sum rounded on
// its own in the twin's order: fp32 rounding alone moves K by about the 3e-5
// tolerance at the flagship shape, so K3 and K1 give the twin's K bit for
// bit only if all three round the same operations the same way.
template <int C>
__device__ __forceinline__ float stat(const float (&x)[C + 1], const float (&y)[C + 1]) {
  float cross = __fmul_rn(x[0], y[0]);
#pragma unroll
  for (int c = 1; c < C; ++c) cross = __fadd_rn(cross, __fmul_rn(x[c], y[c]));
  return expf(__fadd_rn(cross, __fadd_rn(y[C], x[C])));
}

// A point of the tile's staged paths: C channels and -½|·|², STRIDE apart.
template <int C, int STRIDE>
__device__ __forceinline__ void load_point(const float* p, float (&v)[C + 1]) {
#pragma unroll
  for (int c = 0; c <= C; ++c) v[c] = p[c * STRIDE];
}

// Blocks an SM the launch bounds ask for: 16 warps at the 16-node bucket
// (at most 128 registers), 12 at 40 and 64 (at most 168).
template <int LMAX>
__host__ __device__ constexpr int values_min_blocks() { return LMAX <= 16 ? 4 : 3; }

// Cell rows a K3 band (the wavefront's independent chains), by length
// bucket: 2 up to 40 nodes, the fastest of 1-8 (tools/k3_probe.py), 4 at 64,
// where 2 spill under 168 registers.
template <int LMAX>
__host__ __device__ constexpr int band_rows() { return LMAX <= 40 ? 2 : 4; }

// Shared memory of a K3 block, in floats: xs [L][C+1][TR] (the tile's row
// paths, pre-scaled, with -½|x'|²), ys [LMAX][C+1][TC] (its column paths,
// the nodes past L-1 repeating node L-1) and gs [LMAX][NT] (each thread's
// bottom static row of its band).
template <int LMAX, int C>
size_t values_smem_floats(int L) {
  return (size_t)(C + 1) * (L * TR + LMAX * TC) + (size_t)LMAX * NT;
}

template <int LMAX, int C>
__global__ void __launch_bounds__(NT, values_min_blocks<LMAX>())
block_values_kernel(const float* __restrict__ X, const float* __restrict__ hptr,
                    const int* __restrict__ tiles, float* __restrict__ K, int n, int L) {
  extern __shared__ float smem[];
  constexpr int CP = C + 1;
  constexpr int RV = band_rows<LMAX>();
  const int tid = threadIdx.x;
  const int L1 = L - 1, LC = L * C;
  const int I = tiles[2 * blockIdx.x], J = tiles[2 * blockIdx.x + 1];
  float* xs = smem;
  float* ys = xs + L * CP * TR;
  const float scale = sqrtf(2.0f / hptr[0]);
  for (int e = tid; e < LC * TR; e += NT) {
    const int rr = e / LC, k = e % LC;
    const int a = I * TR + rr;
    xs[((k / C) * CP + k % C) * TR + rr] =
        a < n ? __fmul_rn(X[(size_t)a * LC + k], scale) : 0.f;
  }
  for (int e = tid; e < LMAX * C * TC; e += NT) {
    const int cc = e / (LMAX * C), k = e % (LMAX * C);
    const int b = J * TC + cc;
    ys[((k / C) * CP + k % C) * TC + cc] =
        b < n ? __fmul_rn(X[((size_t)b * L + min(k / C, L1)) * C + k % C], scale) : 0.f;
  }
  __syncthreads();
  // -½|·|², summed in the twin's order
  for (int e = tid; e < L * TR + LMAX * TC; e += NT) {
    const bool row = e < L * TR;
    const int w = row ? TR : TC, f = row ? e : e - L * TR;
    float* pt = (row ? xs : ys) + (f / w) * CP * w + f % w;
    float sq = 0.f;
    for (int c = 0; c < C; ++c) sq = __fadd_rn(sq, __fmul_rn(pt[c * w], pt[c * w]));
    pt[C * w] = -0.5f * sq;
  }
  __syncthreads();
  const int r = tid / TC, cl = tid % TC;
  const int a = I * TR + r, b = J * TC + cl;
  if (a >= n || b >= n || a > b) return;
  const float* xr = xs + r;   // node p, channel c: + (p·(C+1) + c)·TR
  const float* yc = ys + cl;  // node q, channel c: + (q·(C+1) + c)·TC

  // the band's bottom K row in registers and its bottom static row in the
  // thread's column of gs, over the bucket's LMAX nodes; nodes past L-1 are
  // computed on node L-1's column point (their z is 0) and never read by a
  // kept cell
  float* gs = ys + LMAX * CP * TC + tid;  // node q: + q·NT
  float krow[LMAX];
  {
    float x[CP], y[CP];
    load_point<C, TR>(xr, x);
#pragma unroll
    for (int q = 0; q < LMAX; ++q) {
      load_point<C, TC>(yc + q * CP * TC, y);
      gs[q * NT] = stat<C>(x, y);
      krow[q] = 1.f;
    }
  }
  for (int i0 = 0; i0 < L1; i0 += RV) {
    // band row s: cell row i0 + s, between node rows i0 + s and i0 + s + 1;
    // rows past L-2 (the last band's) run on node row L-1 and copy the row
    // below, so the top row hands on node row L-1
    float xp[RV][CP];
    bool keep[RV];
#pragma unroll
    for (int s = 0; s < RV; ++s) {
      load_point<C, TR>(xr + min(i0 + s + 1, L1) * CP * TR, xp[s]);
      keep[s] = i0 + s < L1;
    }
    // gr, kr: node row i0 + s + 1 of band row s, statics and K; gd: the
    // bottom static row, each node read before the top row's replaces it.
    // Each value lives from the step that makes it to the step after row
    // s + 1 last reads it, so the compiler keeps a few a row.
    float gr[RV][LMAX], kr[RV][LMAX], gd[LMAX];
    {
      float y[CP];
      load_point<C, TC>(yc, y);
      gd[0] = gs[0];
#pragma unroll
      for (int s = 0; s < RV; ++s) {
        gr[s][0] = stat<C>(xp[s], y);
        kr[s][0] = 1.f;
      }
      gs[0] = gr[RV - 1][0];
    }
    // step t: column node t + 1's statics for every band row (its column
    // point loaded once), then cell (i0 + s, t - s) of each row s: RV
    // independent chains a step
#pragma unroll
    for (int t = 0; t < LMAX + RV - 2; ++t) {
      if (t + 1 < LMAX) {
        float y[CP];
        load_point<C, TC>(yc + (t + 1) * CP * TC, y);
        gd[t + 1] = gs[(t + 1) * NT];
#pragma unroll
        for (int s = 0; s < RV; ++s) gr[s][t + 1] = stat<C>(xp[s], y);
        gs[(t + 1) * NT] = gr[RV - 1][t + 1];
      }
#pragma unroll
      for (int s = 0; s < RV; ++s) {
        const int j = t - s;
        if (j >= 0 && j < LMAX - 1) {
          const int sb = s > 0 ? s - 1 : 0;
          const float gd0 = s > 0 ? gr[sb][j] : gd[j];
          const float gd1 = s > 0 ? gr[sb][j + 1] : gd[j + 1];
          const float kd0 = s > 0 ? kr[sb][j] : krow[j];
          const float kd1 = s > 0 ? kr[sb][j + 1] : krow[j + 1];
          const Coef q = coef(gr[s][j + 1], gr[s][j], gd1, gd0);
          const float kn = cell(kr[s][j] + kd1, kd0, q);
          kr[s][j + 1] = s == 0 || keep[s] ? kn : kd1;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < LMAX; ++q) krow[q] = kr[RV - 1][q];
  }
  float kv = krow[1];
#pragma unroll
  for (int q = 2; q < LMAX; ++q) kv = q == L1 ? krow[q] : kv;
  K[(size_t)a * n + b] = kv;
  K[(size_t)b * n + a] = kv;
}

// ---- K1: a lane group per pair --------------------------------------------

// A lane's slot a pipeline step, in float4s: the band's bottom row over the
// span's SPAN+1 nodes, then its left column (the RB nodes above the corner).
template <int SPAN>
__host__ __device__ constexpr int slot_f4() { return (SPAN + 1 + RB + 3) / 4; }

// Shared memory of a K1 block, in floats (kernels/sigkernel_block.py::
// block_plan): sb [slot_f4·4][NT] (each lane's copy of its next slot), yl
// [(SPAN+1)·(C+1)][NT] (each lane's span of its column path: y' and
// -½|y'|²), xs [L][C+1][TR] (the row paths: x' and -½|x'|²), dxw
// [TR][NW][L·C] (each warp's row-path sums), dyc [(SPAN+1)·(C+1)][NT] (each
// lane's column-path sums), hs [2][RB][3][NT] (each lane's hand-off of a
// step, by step parity). Lane-private arrays are lane-minor, so a warp's
// access of one of them hits 32 banks.
size_t lanes_smem_floats(int L, int C, int span) {
  const int sf = span == 3 ? slot_f4<3>() : slot_f4<5>();
  return (size_t)4 * sf * NT + (size_t)2 * (span + 1) * (C + 1) * NT + (size_t)L * (C + 1) * TR +
         (size_t)TR * NW * L * C + (size_t)2 * RB * 3 * NT;
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Statics of row node p over the lane's node columns c0 .. c0+SPAN, rounded
// as the twin rounds them: xp is x'_p of the lane's row particle (channel
// stride TR, -½|x'_p|² at channel C), yq the lane's column path from node
// c0 (node stride (C+1)·NT, channel stride NT, -½|y'|² at channel C; nodes
// past the span repeat its last, so every value is finite).
template <int SPAN, int C>
__device__ __forceinline__ void stat_row(const float* xp, const float* yq,
                                         float (&g)[SPAN + 1]) {
  float xv[C + 1];
#pragma unroll
  for (int c = 0; c <= C; ++c) xv[c] = xp[c * TR];
#pragma unroll
  for (int q = 0; q <= SPAN; ++q) {
    const float* y = yq + q * (C + 1) * NT;
    float cross = __fmul_rn(xv[0], y[0]);
#pragma unroll
    for (int c = 1; c < C; ++c) cross = __fadd_rn(cross, __fmul_rn(xv[c], y[c * NT]));
    g[q] = expf(__fadd_rn(cross, __fadd_rn(y[C * NT], xv[C])));
  }
}

// Pull back node row p's finished weights W = dg·g of the lane's owned node
// columns (W is 0 at the others): its row-path part (returned, this lane's
// share) and its column-path sums cx, cw.
template <int SPAN, int C>
__device__ __forceinline__ void pull_row(const float (&W)[SPAN + 1], const float* xp,
                                         const float* yq, float (&cx)[SPAN + 1][C],
                                         float (&cw)[SPAN + 1], float (&hi)[C]) {
  float xv[C], sy[C], sw = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    xv[c] = xp[c * TR];
    sy[c] = 0.f;
  }
#pragma unroll
  for (int q = 0; q <= SPAN; ++q) {
    sw += W[q];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sy[c] = fmaf(W[q], yq[(q * (C + 1) + c) * NT], sy[c]);
      cx[q][c] = fmaf(W[q], xv[c], cx[q][c]);
    }
    cw[q] += W[q];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) hi[c] = sy[c] - xv[c] * sw;
}

// Sum a lane's row-path part over the warp's groups (all at the same unit)
// and add it to the warp's sums of node row p, by group 0's lane.
template <int C>
__device__ __forceinline__ void row_sum(float (&hi)[C], int g, bool write, float* w) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    for (int o = g; o < 32; o <<= 1) hi[c] += __shfl_xor_sync(FULL, hi[c], o);
  if (write) {
#pragma unroll
    for (int c = 0; c < C; ++c) w[c] += hi[c];
  }
}

template <int SPAN, int C>
__global__ void __launch_bounds__(NT, 3)
block_lanes_kernel(const float* __restrict__ X, const float* __restrict__ hptr,
                   const int* __restrict__ tiles, int n_tiles, float* __restrict__ K,
                   float* __restrict__ rowpart, float* __restrict__ colpart,
                   float4* __restrict__ scratch, int n, int L, int g) {
  extern __shared__ float4 smem4[];
  constexpr int SF = slot_f4<SPAN>();
  constexpr int YN = (SPAN + 1) * (C + 1);  // a lane's column-path values
  const int LC = L * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* sb = smem4 + tid;                                  // float4 e: + e·NT
  float* yl = reinterpret_cast<float*>(smem4 + SF * NT) + tid;  // node q, channel c: + (q(C+1)+c)·NT
  float* dmy = yl + YN * NT;                                 // the same layout
  float* xs = dmy - tid + YN * NT;                           // [L][C+1][TR]
  float* dxw = xs + L * (C + 1) * TR;                        // [TR][NW][L·C]
  float* hs = dxw + TR * NW * LC;                            // [2][RB][3][NT]

  const int t = lane & (g - 1);  // position in the group
  const int grp = tid / g;       // the group's tile column
  const int tc = NT / g;         // column particles per tile
  const float scale = sqrtf(2.0f / hptr[0]);
  const int L1 = L - 1;
  const int c0 = (t * L1) / g, nspan = ((t + 1) * L1) / g - c0;
  const int nb = (L1 + RB - 1) / RB;
  const int U = TR * nb, steps = U + g - 1;
  const int xrow = (C + 1) * TR;  // xs stride of a node
  // the lane's slot of step k: + k·SF·32 float4s, its e-th float4 + e·32
  float4* wscr = scratch + ((size_t)blockIdx.x * NW + warp) * steps * SF * 32 + lane;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int I = tiles[2 * tile], J = tiles[2 * tile + 1];
    const int b = J * tc + grp;
    __syncthreads();  // the previous tile's partials are written
    for (int e = tid; e < LC * TR; e += NT) {
      const int rr = e / LC, k = e % LC;
      const int a = I * TR + rr;
      xs[((k / C) * (C + 1) + k % C) * TR + rr] =
          a < n ? __fmul_rn(X[(size_t)a * LC + k], scale) : 0.f;
    }
    for (int e = tid; e < TR * NW * LC; e += NT) dxw[e] = 0.f;
    // the lane's span of its column path, and -½|y'|² summed in the twin's order
    for (int q = 0; q <= SPAN; ++q) {
      float sq = 0.f;
      for (int c = 0; c < C; ++c) {
        const float v = b < n ? __fmul_rn(X[((size_t)b * L + min(c0 + q, L1)) * C + c], scale)
                              : 0.f;
        yl[(q * (C + 1) + c) * NT] = v;
        sq = __fadd_rn(sq, __fmul_rn(v, v));
        dmy[(q * (C + 1) + c) * NT] = 0.f;
      }
      yl[(q * (C + 1) + C) * NT] = -0.5f * sq;
      dmy[(q * (C + 1) + C) * NT] = 0.f;
    }
    __syncthreads();
    for (int e = tid; e < L * TR; e += NT) {
      const int p = e / TR, rr = e % TR;
      float sq = 0.f;
      for (int c = 0; c < C; ++c) {
        const float v = xs[(p * (C + 1) + c) * TR + rr];
        sq = __fadd_rn(sq, __fmul_rn(v, v));
      }
      xs[(p * (C + 1) + C) * TR + rr] = -0.5f * sq;
    }
    __syncthreads();

    // ---- forward: lane t sweeps band k - t of the group's 8-pair run ------
    {
      float krow[SPAN], gdn[SPAN + 1], gup[SPAN + 1], inL[RB];
      float corner = 1.f;
#pragma unroll
      for (int q = 0; q <= SPAN; ++q) gdn[q] = gup[q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < SPAN; ++kk) krow[kk] = 1.f;
#pragma unroll
      for (int s = 0; s < RB; ++s) inL[s] = 1.f;
      for (int k = 0; k < steps; ++k) {
        const int u = k - t;
        float rc[RB];  // the right column, for lane t+1
#pragma unroll
        for (int s = 0; s < RB; ++s) rc[s] = 0.f;
        if (u >= 0 && u < U) {
          const int r = u / nb, v = u - r * nb;
          const int a = I * TR + r;
          if (a < n && b < n && a <= b) {
            const int i0 = v * RB;
            const float* xr = xs + r;
            if (v == 0) {
#pragma unroll
              for (int kk = 0; kk < SPAN; ++kk) krow[kk] = 1.f;
              corner = 1.f;
              stat_row<SPAN, C>(xr, yl, gdn);
            }
            // the band's left column: the corner and lane t-1's right column
            float lc[RB + 1];
            lc[0] = t == 0 ? 1.f : corner;
#pragma unroll
            for (int s = 0; s < RB; ++s) lc[s + 1] = t == 0 ? 1.f : inL[s];
            float sv[4 * SF];  // the slot: bottom row (the corner first), left column
            sv[0] = lc[0];
#pragma unroll
            for (int kk = 0; kk < SPAN; ++kk) sv[kk + 1] = krow[kk];
#pragma unroll
            for (int e = 0; e < RB; ++e) sv[SPAN + 1 + e] = lc[e + 1];
#pragma unroll
            for (int e = SPAN + 1 + RB; e < 4 * SF; ++e) sv[e] = 0.f;
            float4* dst = wscr + (size_t)k * SF * 32;
#pragma unroll
            for (int e = 0; e < SF; ++e)
              dst[e * 32] = make_float4(sv[4 * e], sv[4 * e + 1], sv[4 * e + 2], sv[4 * e + 3]);
            float klast = 1.f;
#pragma unroll
            for (int s = 0; s < RB; ++s) {
              // rows past L-2 (a pair's top band) and cells past the span are
              // computed on valid statics and not kept: no branch divides the
              // warp
              const bool on_r = i0 + s < L1;
              stat_row<SPAN, C>(xr + min(i0 + s + 1, L1) * xrow, yl, gup);
              float prev = lc[s], kl = lc[s + 1];
#pragma unroll
              for (int kk = 0; kk < SPAN; ++kk) {
                const bool on = on_r && kk < nspan;
                const Coef q = coef(gup[kk + 1], gup[kk], gdn[kk + 1], gdn[kk]);
                const float old = krow[kk];
                const float kn = cell(kl + old, prev, q);
                krow[kk] = on ? kn : old;
                prev = on ? old : prev;
                kl = on ? kn : kl;
              }
              rc[s] = kl;
              klast = on_r ? kl : klast;
#pragma unroll
              for (int q = 0; q <= SPAN; ++q) gdn[q] = gup[q];
            }
            corner = lc[RB];
            if (t == g - 1 && v == nb - 1) {
              K[(size_t)a * n + b] = klast;
              K[(size_t)b * n + a] = klast;
            }
          }
        }
#pragma unroll
        for (int s = 0; s < RB; ++s) inL[s] = __shfl_up_sync(FULL, rc[s], 1, g);
      }
    }

    // ---- adjoint: lane t takes unit k - (g-1-t) of the reversed run, bands
    // top down, each cell row right to left ----------------------------------
    {
      // lam: the partial λ of the node row below the last cell row done;
      // wlp: that node row's weights from the cell row above it
      float lam[SPAN], wlp[SPAN + 1];
#pragma unroll
      for (int kk = 0; kk < SPAN; ++kk) lam[kk] = 0.f;
#pragma unroll
      for (int q = 0; q <= SPAN; ++q) wlp[q] = 0.f;
      // the slot the adjoint's step kq reads, copied into the lane's buffer
      auto prefetch = [&](int kq) {
        const int vq = kq - (g - 1 - t);
        if (vq < 0 || vq >= U) return;
        const int aq = I * TR + (U - 1 - vq) / nb;
        if (!(aq < n && b < n && aq <= b)) return;
        const float4* src = wscr + (size_t)(steps - 1 - kq) * SF * 32;
#pragma unroll
        for (int e = 0; e < SF; ++e) cp_async16(sb + e * NT, src + e * 32);
      };
      prefetch(0);
      cp_async_commit();
      for (int k = 0; k < steps; ++k) {
        const int vq = k - (g - 1 - t);
        const bool mine = vq >= 0 && vq < U;
        const int u = U - 1 - vq;
        const int r = mine ? u / nb : 0, v = mine ? u - r * nb : 0;
        const int a = I * TR + r;
        const bool act = mine && a < n && b < n && a <= b;
        const int i0 = v * RB;
        const float* xr = xs + r;
        const float sd = a == b ? 1.f : 2.f;
        const float* hin = hs + ((k + 1) & 1) * RB * 3 * NT + tid + 1;  // lane t+1, step k-1
        float* hout = hs + (k & 1) * RB * 3 * NT + tid;
        float fac[RB][SPAN];
        float gu[SPAN + 1], gd[SPAN + 1];
#pragma unroll
        for (int q = 0; q <= SPAN; ++q) gu[q] = gd[q] = 0.f;
        cp_async_wait_all();
        if (act) {
          if (v == nb - 1) {  // a pair's top band: λ is 1 at node (L-1, L-1)
#pragma unroll
            for (int kk = 0; kk < SPAN; ++kk) lam[kk] = (t == g - 1 && kk == nspan - 1) ? 1.f : 0.f;
#pragma unroll
            for (int q = 0; q <= SPAN; ++q) wlp[q] = 0.f;
          }
          // rebuild the band from its slot, in the forward's rounding
          float sv[4 * SF], lc[RB + 1], krow[SPAN];
#pragma unroll
          for (int e = 0; e < SF; ++e) {
            const float4 f = sb[e * NT];
            sv[4 * e] = f.x;
            sv[4 * e + 1] = f.y;
            sv[4 * e + 2] = f.z;
            sv[4 * e + 3] = f.w;
          }
          lc[0] = sv[0];
#pragma unroll
          for (int kk = 0; kk < SPAN; ++kk) krow[kk] = sv[kk + 1];
#pragma unroll
          for (int e = 0; e < RB; ++e) lc[e + 1] = sv[SPAN + 1 + e];
          stat_row<SPAN, C>(xr + i0 * xrow, yl, gd);
#pragma unroll
          for (int s = 0; s < RB; ++s) {
            const bool on_r = i0 + s < L1;
            stat_row<SPAN, C>(xr + min(i0 + s + 1, L1) * xrow, yl, gu);
            float prev = lc[s], kl = lc[s + 1];
#pragma unroll
            for (int kk = 0; kk < SPAN; ++kk) {
              const bool on = on_r && kk < nspan;
              const Coef q = coef(gu[kk + 1], gu[kk], gd[kk + 1], gd[kk]);
              const float old = krow[kk];
              const float sm = kl + old;
              const float kn = cell(sm, prev, q);
              fac[s][kk] = __fadd_rn(__fmul_rn(sm, __fadd_rn(0.5f, __fmul_rn(q.z, I6))),
                                     __fmul_rn(prev, __fmul_rn(q.z, I6)));
              krow[kk] = on ? kn : old;
              prev = on ? old : prev;
              kl = on ? kn : kl;
            }
#pragma unroll
            for (int q = 0; q <= SPAN; ++q) gd[q] = gu[q];
          }
          // gu holds the static row at the band's top (row L-1 in a top band)
        }
        // the slot of the next step, in flight while this one's adjoint runs
        asm volatile("" ::: "memory");
        prefetch(k + 1);
        cp_async_commit();
        float cx[SPAN + 1][C], cw[SPAN + 1];  // the band's column-path sums
#pragma unroll
        for (int q = 0; q <= SPAN; ++q) {
          cw[q] = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) cx[q][c] = 0.f;
        }
#pragma unroll
        for (int s = RB - 1; s >= 0; --s) {
          const bool on_r = i0 + s < L1;
          float hi[C];  // this lane's part of node row i+1's row-path gradient
#pragma unroll
          for (int c = 0; c < C; ++c) hi[c] = 0.f;
          if (act) {
            // a row past L-2 (first in a top band) is computed on valid
            // statics (gd = gu, row L-1) and changes nothing
            stat_row<SPAN, C>(xr + min(i0 + s, L1) * xrow, yl, gd);
            // A and B for the λ chains only: fused, as the adjoint may round
            float A[SPAN], B[SPAN];
#pragma unroll
            for (int kk = 0; kk < SPAN; ++kk) {
              const float z = ((gu[kk + 1] - gu[kk]) - gd[kk + 1]) + gd[kk];
              A[kk] = fmaf(z, fmaf(z, I12, 0.5f), 1.f);
              B[kk] = fmaf(z * z, -I12, 1.f);
            }
            const bool last = t == g - 1;
            const float hA = last ? 0.f : hin[(s * 3) * NT];
            const float hB = last ? 0.f : hin[(s * 3 + 1) * NT];
            const float hD = last ? 0.f : hin[(s * 3 + 2) * NT];
            // complete λ row i+1, right to left (past the span λ is 0)
            float lm[SPAN];
#pragma unroll
            for (int kk = SPAN - 1; kk >= 0; --kk) {
              const int k1 = kk + 1 < SPAN ? kk + 1 : kk;
              const float right = kk + 1 < SPAN ? lm[k1] * A[k1] : 0.f;
              lm[kk] = kk < nspan ? lam[kk] + (kk == nspan - 1 ? hA : right) : 0.f;
            }
            float dz[SPAN];
#pragma unroll
            for (int kk = 0; kk < SPAN; ++kk) dz[kk] = kk < nspan ? lm[kk] * fac[s][kk] * sd : 0.f;
            if (t > 0 && on_r) {  // the terms of this lane's first cell, for lane t-1
              hout[(s * 3) * NT] = lm[0] * A[0];
              hout[(s * 3 + 1) * NT] = lm[0] * B[0];
              hout[(s * 3 + 2) * NT] = dz[0];
            }
            // partial λ row i
#pragma unroll
            for (int kk = 0; kk < SPAN; ++kk) {
              const int k1 = kk + 1 < SPAN ? kk + 1 : kk;
              const float nl = lm[kk] * A[kk] - (kk == nspan - 1 ? hB : lm[k1] * B[k1]);
              lam[kk] = on_r && kk < nspan ? nl : lam[kk];
            }
            // dg of the owned node columns c0+1 .. c0+nspan (lane 0: and 0):
            // D = dz[q-1] - dz[q], +D on node row i+1, -D on node row i; node
            // row i+1 is then finished
            float W[SPAN + 1];
#pragma unroll
            for (int q = 0; q <= SPAN; ++q) {
              const int qm = q > 0 ? q - 1 : 0, qn = q < SPAN ? q : SPAN - 1;
              const bool own = on_r && (q == 0 ? t == 0 : q <= nspan);
              const float D = q == 0 ? -dz[0] : dz[qm] - (q == nspan ? hD : dz[qn]);
              W[q] = own ? fmaf(D, gu[q], wlp[q]) : 0.f;
              wlp[q] = own ? -D * gd[q] : wlp[q];
            }
            pull_row<SPAN, C>(W, xr + min(i0 + s + 1, L1) * xrow, yl, cx, cw, hi);
#pragma unroll
            for (int q = 0; q <= SPAN; ++q) gu[q] = gd[q];
          }
          row_sum<C>(hi, g, mine && a < n && on_r && lane < g,
                     dxw + (r * NW + warp) * LC + (i0 + s + 1) * C);
        }
        float h0[C];  // node row 0, after a pair's bottom band
#pragma unroll
        for (int c = 0; c < C; ++c) h0[c] = 0.f;
        if (act && v == 0) pull_row<SPAN, C>(wlp, xr, yl, cx, cw, h0);
        row_sum<C>(h0, g, mine && a < n && v == 0 && lane < g, dxw + (r * NW + warp) * LC);
        if (act) {
#pragma unroll
          for (int q = 0; q <= SPAN; ++q) {
#pragma unroll
            for (int c = 0; c < C; ++c) dmy[(q * (C + 1) + c) * NT] += cx[q][c];
            dmy[(q * (C + 1) + C) * NT] += cw[q];
          }
        }
        __syncwarp();  // the hand-off slots and the warp's sums, for the next step
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
      for (int q = t == 0 ? 0 : 1; q <= nspan; ++q)
        for (int c = 0; c < C; ++c)
          dst[(c0 + q) * C + c] = dmy[(q * (C + 1) + c) * NT] -
                                  yl[(q * (C + 1) + c) * NT] * dmy[(q * (C + 1) + C) * NT];
    }
  }
}

// dX[a] = ½·√(2/h)·(Σ row partials of a + Σ column partials of a), summed
// over the active tiles in tile order (deterministic).
__global__ void reduce_partials_kernel(const float* __restrict__ rowpart,
                                       const float* __restrict__ colpart,
                                       const float* __restrict__ hptr,
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
  dX[idx] = 0.5f * sqrtf(2.0f / hptr[0]) * s;
}

template <int SPAN, int C>
cudaError_t lanes_grid(int L, int g, int n_tiles, int* blocks) {
  const size_t smem = lanes_smem_floats(L, C, SPAN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_lanes_kernel<SPAN, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_lanes_kernel<SPAN, C>,
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
cudaError_t lanes_launch(const float* X, const float* h, const int* tiles, int n_tiles,
                         float* K, float* rowpart, float* colpart, float* scratch, int blocks,
                         int n, int L, int g, cudaStream_t stream) {
  const size_t smem = lanes_smem_floats(L, C, SPAN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_lanes_kernel<SPAN, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  block_lanes_kernel<SPAN, C><<<blocks, NT, smem, stream>>>(
      X, h, tiles, n_tiles, K, rowpart, colpart, reinterpret_cast<float4*>(scratch), n, L, g);
  return cudaGetLastError();
}

// The plan (kernels/sigkernel_block.py::block_plan) picks g and the span
// template; these are the shapes K1 takes: C ≤ 3 at L ≤ 64 (span template 3
// or 5), C = 4..8 at L·C ≤ 128 (span template 3).
bool lanes_valid(int L, int C, int g, int span) {
  if (L < 2 || L > 64 || C < 1 || C > 8 || (C > 3 && (L * C > 128 || span != 3)))
    return false;
  if (g < 1 || g > 16 || g > L - 1 || (g & (g - 1)) != 0) return false;
  if (span != 3 && span != 5) return false;
  return (L - 1 + g - 1) / g <= span;
}

template <int LMAX, int C>
cudaError_t launch_values(const float* X, const float* h, const int* tiles, int n_tiles,
                          float* K, int n, int L, cudaStream_t stream) {
  const size_t smem = values_smem_floats<LMAX, C>(L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_values_kernel<LMAX, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  block_values_kernel<LMAX, C><<<n_tiles, NT, smem, stream>>>(X, h, tiles, K, n, L);
  return cudaGetLastError();
}

// K3's envelope, the JAX package's block envelope without its VMEM bound
// (kernels/sigkernel_block.py::block_values_supported).
bool values_valid(int n, int L, int C) {
  return n >= 2 && L >= 2 && L <= 64 && C >= 1 && C <= 8 && L * C <= 128;
}

}  // namespace

// one instantiation per (span template, C) of lanes_valid
#define K1_DISPATCH(RET, FN, ...)                                   \
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

// Shape envelope of the kernels (checked again by the Python wrapper): L ≤
// 64 and C ≤ 8 for both, L·C ≤ 128 for K3 and, at C ≥ 4, for K1.
int sigkernel_block_max_l() { return 64; }
int sigkernel_block_max_c() { return 8; }

// Number of persistent K1 blocks for a launch: the blocks resident on the
// device at once, at most one per tile. The caller sizes the scratch by it.
int sigkernel_block_grid(int L, int C, int g, int span, int n_tiles, int* blocks) {
  if (!lanes_valid(L, C, g, span)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  K1_DISPATCH(err =, lanes_grid, L, g, n_tiles, blocks)
  return (int)err;
}

// K1: X [n, L, C], h [1], tiles [n_tiles, 2] int32 (I, J) with I·8 <= J·tc +
// tc - 1 (tc = 128/g), K [n, n], dX [n, L, C], rowpart [ceil(n/tc), n, L·C],
// colpart [ceil(n/8), n, L·C], scratch [blocks·4·(8·ceil((L-1)/8) + g-1)·
// 32·4·slot_f4] floats; fp32, contiguous, on the stream's device. present:
// null for the whole tile list, else [ceil(n/8), ceil(n/tc)] bytes, 1 for each
// tile of a subset list (the reduction sums only the slots those tiles wrote;
// K holds only their pairs). Returns cudaGetLastError() after both launches
// (0 on success).
int sigkernel_block_gram_grad(const float* X, const float* h, const int* tiles, float* K,
                              float* dX, float* rowpart, float* colpart, float* scratch,
                              const unsigned char* present, int n_tiles, int blocks, int n,
                              int L, int C, int g, int span, void* stream) {
  if (!lanes_valid(L, C, g, span)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  K1_DISPATCH(err =, lanes_launch, X, h, tiles, n_tiles, K, rowpart, colpart, scratch, blocks,
              n, L, g, st)
  if (err != cudaSuccess) return (int)err;
  const int LC = L * C;
  const int total = n * LC;
  const int tc = NT / g;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      rowpart, colpart, h, present, dX, n, LC, (n + TR - 1) / TR, (n + tc - 1) / tc, tc);
  return (int)cudaGetLastError();
}

// K3: X [n, L, C], h [1], tiles [n_tiles, 2] int32 (I, J) with I·8 <= J·16 +
// 15, K [n, n]; fp32, contiguous, on the stream's device. One block a tile.
// Returns cudaGetLastError() after the launch (0 on success).
int sigkernel_block_gram(const float* X, const float* h, const int* tiles, int n_tiles,
                         float* K, int n, int L, int C, void* stream) {
  if (!values_valid(n, L, C) || n_tiles < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lmax = L <= 16 ? 16 : L <= 40 ? 40 : 64;
  switch (lmax * 16 + C) {
#define K3_CASE(LM, CC) \
  case LM * 16 + CC: return (int)launch_values<LM, CC>(X, h, tiles, n_tiles, K, n, L, s);
    K3_CASE(16, 1) K3_CASE(16, 2) K3_CASE(16, 3) K3_CASE(16, 4)
    K3_CASE(16, 5) K3_CASE(16, 6) K3_CASE(16, 7) K3_CASE(16, 8)
    K3_CASE(40, 1) K3_CASE(40, 2) K3_CASE(40, 3) K3_CASE(40, 4)
    K3_CASE(40, 5) K3_CASE(40, 6) K3_CASE(40, 7)
    K3_CASE(64, 1) K3_CASE(64, 2) K3_CASE(64, 3)
#undef K3_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
