// λ=0 pair-list signature kernel with the RBF statics computed in the
// kernels: K7 (forward, with or without the residual; fp32 backward).
//
// Replaces the TPU kernels sigsvgd_tpu/kernels/pallas_sigkernel_small.py::
// _small_fwd_kernel and ::_small_bwd_kernel. Contract, as
// pallas_pair_gram_small there: for pair p, paths xt[:, :, p] [Lx, C] and
// yt[:, :, p] [Ly, C], already scaled by rsqrt(h), k[p] is the order-0
// Goursat-PDE signature kernel with static kernel
// exp(-max(|x|^2 + |y|^2 - 2<x, y>, 0)) on the (Lx-1) × (Ly-1) grid; with
// the residual the forward also writes fac[i][j] = ∂k[i+1][j+1]/∂z; the
// backward gives the gradients of Σ_p gout[p]·k[p] with respect to both
// tiles. All arrays are pair-minor ([L][C][P], fac [lx1][ly1][P]).
//
// What bounds it on an H100. A pair's grid is only lx1·ly1 cells (1,521 at
// 40-node paths), ~14 operations each plus ~(2C+4) per static node: about
// 3.4e4 operations a pair forward, against 4·lx1·ly1 = 6 KB of fac written
// with the residual and read by the backward. Values only, the operations
// bound it (0.5 ms for 2^20 pairs at 67 TFLOP/s); with the residual, and in
// the backward, the bytes (6.4 GB of fac at 2^20 pairs, 1.9 ms at 3.35
// TB/s). A λ=0 row is at most 63 cells, so the design of K2, K4 and K5
// (a lane group per pair) holds a pair's rows in registers with no band, no
// fine grid and no checkpoint:
//   * a lane group per pair: g lanes (a power of two, at most 32, the
//     fewest that leave a lane at most 5 columns up to C = 4 and 3 beyond:
//     8 at ly1 = 33-40, 16 at 41-63, 1 up to 5), each holding SPAN (the
//     template, 3 or 5) columns of the grid padded to g·SPAN by virtual
//     columns whose cells have z = 0 exactly (see each kernel), so every
//     lane runs the same cells with no per-cell branch. A block (4 warps)
//     takes a tile of runs × 128/g pairs, the groups of a warp on adjacent
//     pairs, and each group walks its run row by row as one pipeline, so
//     lanes idle only in the g-1 steps at the run's ends. Blocks are
//     persistent over the tiles (kernels/sigkernel_small.py::small_plan);
//     run position r of every tile lies in band r of the pairs, so the
//     blocks that run at once move adjacent pieces of each residual row;
//   * each lane keeps its span's y points and their squared norms in
//     registers, loaded once a pair; a step's unit (pair, row) and its
//     offsets advance by counters, with no division;
//   * forward: at step k lane t sweeps row k - t of its run over its span,
//     its span of the K row and of the static row carried in registers
//     (one exp a node a row; row i+1 becomes the next row's lower row), and
//     hands lane t+1 (__shfl_up_sync) the new row's value and static node
//     at the span's right edge; lane t+1 keeps the value as the next row's
//     corner. Lane g-1 writes k;
//   * the residual: each lane puts the fac of its cells into the block's
//     stage in shared memory at the step it forms them, and after a block
//     barrier the threads of each lane position write its rows out, a
//     column of the block's 128/g pairs at a time (16-byte stores where P
//     is a multiple of 4), so every warp's stores cover whole 32-byte
//     sectors (16 pairs, 64 B, at 8 lanes a pair); two stages alternate,
//     one barrier a step;
//   * backward: one pipeline right to left, rows top down: lane g-1 takes
//     unit k at step k, lane t unit k - (g-1-t). Each lane keeps its span of
//     the row above's partial adjoint λ[i+1] (node columns c0+1 .. c0+SPAN),
//     of the static row i+1 (c0 .. c0+SPAN; row i, formed as it goes,
//     takes its place) and of the column-path gradient of the nodes it
//     pulls back (c0+1 .. c0+SPAN, lane 0 also 0) in registers; lane t+1
//     hands it (__shfl_down_sync) the increment that completes λ[i+1] at
//     the span's right edge, the pending term of λ[i] there, that cell's
//     dz, the static node g[i] there and the row-path sums; lane 0 writes
//     dx[i+1]. dz = λ[i+1][j+1]·fac (no primal reconstruction) is pulled
//     back through the statics at once, split by rows as K1 splits it
//     (D[q] = dz[q-1] - dz[q]: w_hi = D·g[i+1][q] to row i+1, w_lo =
//     -D·g[i][q] to row i). fac comes through the block's stage, copied
//     two steps ahead by cp.async, the threads of a lane position copying
//     the rows of the unit their lane takes then. No atomics.
// No K row, static row or adjoint row goes through device or shared
// memory. The statics and the forward round every product and sum on its
// own in the twin's order (no FMA contraction but the exact 2<x, y>), so k
// and fac are the twin's up to the exp, and the parent kernel's bit for
// bit; the backward's rounding is pinned by intrinsics
// (tests/test_torch_small_schedule.py models it), so dx and dy do not
// depend on the lanes and are bit-equal across calls.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr unsigned FULL = 0xffffffffu;
constexpr float I6 = 1.0f / 6.0f;
constexpr float I12 = 1.0f / 12.0f;

// Path point q of a pair-minor tile t [L][C][P].
template <int C>
__device__ __forceinline__ void load_pt(const float* __restrict__ t, int q, size_t P, size_t p,
                                        float (&v)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = t[((size_t)q * C + c) * P + p];
}

// Squared norm, summed in channel order.
template <int C>
__device__ __forceinline__ float sq_norm(const float (&v)[C]) {
  float n = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int c = 1; c < C; ++c) n = __fadd_rn(n, __fmul_rn(v[c], v[c]));
  return n;
}

// Static node exp(-max((|x|^2 + |y|^2) - 2<x, y>, 0)).
template <int C>
__device__ __forceinline__ float gnode(const float (&x)[C], float xn, const float (&y)[C],
                                       float yn) {
  float cross = __fmul_rn(x[0], y[0]);
#pragma unroll
  for (int c = 1; c < C; ++c) cross = __fadd_rn(cross, __fmul_rn(x[c], y[c]));
  // (|x|^2 + |y|^2) - 2<x, y>: 2<x, y> is exact, so the fused form rounds once, as the twin
  const float d2 = __fmaf_rn(-2.f, cross, __fadd_rn(xn, yn));
  return expf(-fmaxf(d2, 0.f));
}

struct Coef {
  float z, A, B;
};

// z = ((gu1 - gu0) - gl1) + gl0, A = 1 + z(½ + z/12), B = 1 - z²/12.
__device__ __forceinline__ Coef coef(float gu1, float gu0, float gl1, float gl0) {
  Coef k;
  k.z = __fadd_rn(__fsub_rn(__fsub_rn(gu1, gu0), gl1), gl0);
  k.A = __fadd_rn(1.f, __fmul_rn(k.z, __fadd_rn(0.5f, __fmul_rn(k.z, I12))));
  k.B = __fsub_rn(1.f, __fmul_rn(__fmul_rn(k.z, k.z), I12));
  return k;
}

// The residual's stage: a row per lane position t and span column kk (row
// t·SPAN + kk: the forward's column j is row j + pad, the backward's row
// j), each the block's 128/g pairs and 4 floats more, so a row starts
// 16-byte aligned and, at 8 lanes a pair, a warp's lanes write 32 banks.
// The forward alternates two stages, the backward cycles three.
__host__ __device__ inline int stage_stride(int g) { return NT / g + 4; }
__host__ __device__ inline int stage_floats(int g, int span) {
  return g * span * stage_stride(g);
}
constexpr int FWD_STAGES = 2;
constexpr int BWD_STAGES = 3;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The unit of a step k for a lane position with lag `lag` (u = k - lag):
// run position r and row counter m (u = r·lx1 + m; m < 0 before the run
// begins), the unit's pair p, whether it exists, and an offset into a
// pair-minor array, `first_row + p` at the pair's start and `row_step` more
// each row, so no step divides or multiplies a 64-bit index. The pairs are
// laid out band-major: run position r of every tile lies in band r of
// tiles·128/g pairs (pair0 + r·band), so the blocks that run at once move
// adjacent pieces of each residual row.
struct Unit {
  int r, m;
  size_t p, off;
  bool live;
};

// The counter one unit before step 0's.
__device__ __forceinline__ Unit unit_before(int lag) {
  Unit u;
  u.r = 0;
  u.m = -lag - 1;
  u.p = u.off = 0;
  u.live = false;
  return u;
}

__device__ __forceinline__ void unit_next(Unit& u, int lx1, int runs, size_t pair0, size_t band,
                                          size_t P, size_t first_row, ptrdiff_t row_step) {
  if (++u.m == lx1) {
    u.m = 0;
    ++u.r;
  }
  if (u.m == 0) {  // a pair's start
    u.p = pair0 + (size_t)u.r * band;
    u.live = u.r < runs && u.p < P;
    u.off = first_row + u.p;
  } else {
    u.off += row_step;
  }
}

__device__ __forceinline__ bool active(const Unit& u) { return u.m >= 0 && u.live; }

// A thread's share of the stage's traffic: the rows of its own lane
// position t (span columns kk, column j = c0 + kk), each 32/g chunks of 4
// adjacent pairs, items e = gi and gi + 128/g of those SPAN·32/g chunks,
// so an item moves the rows of the unit its thread's lane takes. An item
// keeps its stage offset and its offset in a residual row's band, j·P + 4
// pairs a chunk; j < 0 (a virtual column) or e past the chunks: none.
struct Item {
  int soff, coff;
  long long goff;  // -1: none
};

template <int SPAN>
__device__ __forceinline__ void items_init(Item (&it)[2], int g, int t, int gi, int c0,
                                           int ly1, size_t P) {
  const int per = 32 / g, NG = NT / g;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int e = gi + n * NG;
    const int kk = (e * g) >> 5, chunk = e - kk * per;
    const int j = c0 + kk;
    it[n].soff = (t * SPAN + kk) * stage_stride(g) + 4 * chunk;
    it[n].coff = 4 * chunk;
    it[n].goff = e < SPAN * per && j >= 0 && j < ly1 ? (long long)j * P + 4 * chunk : -1;
  }
}

// ---- forward ------------------------------------------------------------------
// The lanes' spans are SPAN columns each: the grid is padded on the left
// with pad = g·SPAN - ly1 virtual columns whose y point is point 0, so
// every cell there has z = 0 exactly, A = B = 1, and keeps k = 1 exactly;
// lane t holds columns [t·SPAN - pad, (t+1)·SPAN - pad). A lane forms the
// static nodes c0+1 .. c0+SPAN of a row (one exp a node); its left node
// comes from lane t-1, or, for lane 0, is a virtual node equal to its
// first (at pad = 0 node 0, one more exp), so the lanes run the same cells.
template <int SPAN, int C, bool FAC>
__global__ void __launch_bounds__(NT, C <= 6 ? 4 : 3)
small_fwd_lanes_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                       float* __restrict__ kout, float* __restrict__ fac, int P_, int lx1,
                       int ly1, int g, int runs, int tiles) {
  extern __shared__ float stage[];  // FAC: FWD_STAGES stages of stage_floats(g, SPAN)
  const size_t P = P_;
  const int t = (threadIdx.x & 31) & (g - 1), gi = threadIdx.x / g;
  const int pad = g * SPAN - ly1, c0 = t * SPAN - pad;
  const bool first = t == 0, last = t == g - 1;
  const int NG = NT / g;
  const int U = runs * lx1, steps = U + g - 1;
  const int stride = stage_stride(g), SF = stage_floats(g, SPAN);
  const size_t CP = (size_t)C * P;
  float* mine = stage + t * SPAN * stride + gi;  // row t·SPAN + q: + q·stride
  Item it[2];
  if (FAC) items_init<SPAN>(it, g, t, gi, c0, ly1, P);
  const size_t rowP = (size_t)ly1 * P;
  int cur = 0;  // the stage this step writes; alternates across tiles too

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t tile_pair = (size_t)tile * NG, band = (size_t)tiles * NG;
    // the lane's y points c0+1 .. c0+SPAN by slot and point c0 (a virtual
    // point is point 0), their norms; the K row k[i][c0 + q] (q = 0: the
    // corner, from lane t-1 a row earlier) and the static row g[i][c0 + q]
    float ys[SPAN][C], yns[SPAN], yc[C], ync = 0.f, krow[SPAN + 1], grow[SPAN + 1];
    float xn[C];
#pragma unroll
    for (int q = 0; q <= SPAN; ++q) krow[q] = grow[q] = 0.f;
#pragma unroll
    for (int s = 0; s < SPAN; ++s) {
      yns[s] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) ys[s][c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) xn[c] = yc[c] = 0.f;
    // from lane t-1: the new row's value and static node at column c0
    float kl_in = 1.f, gu_in = 0.f;
    // the lane's unit (row m, x point m+1), the next one's x point loaded a
    // step ahead
    Unit cu = unit_before(t);
    unit_next(cu, lx1, runs, tile_pair + gi, band, P, CP, CP);
    if (active(cu)) load_pt<C>(xt + cu.off, 0, P, 0, xn);
    for (int k = 0; k < steps; ++k) {
      float x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = xn[c];
      Unit nu = cu;
      unit_next(nu, lx1, runs, tile_pair + gi, band, P, CP, CP);
      if (active(nu)) load_pt<C>(xt + nu.off, 0, P, 0, xn);
      float kl = 1.f, gu0 = 0.f;  // handed to lane t+1
      if (active(cu)) {
        const size_t p = cu.p;
        if (cu.m == 0) {  // a pair's start: its y points, K row 0 (ones), static row 0
          float x0[C];
          load_pt<C>(xt, 0, P, p, x0);
          const float x0n = sq_norm<C>(x0);
          load_pt<C>(yt, max(c0, 0), P, p, yc);
          ync = sq_norm<C>(yc);
          grow[0] = gnode<C>(x0, x0n, yc, ync);
          krow[0] = 1.f;
#pragma unroll
          for (int s = 0; s < SPAN; ++s) {
            load_pt<C>(yt, max(c0 + 1 + s, 0), P, p, ys[s]);
            yns[s] = sq_norm<C>(ys[s]);
            grow[s + 1] = gnode<C>(x0, x0n, ys[s], yns[s]);
            krow[s + 1] = 1.f;
          }
        }
        const float xnn = sq_norm<C>(x);
        float gn[SPAN];  // the row's new static nodes c0+1 .. c0+SPAN
#pragma unroll
        for (int s = 0; s < SPAN; ++s) gn[s] = gnode<C>(x, xnn, ys[s], yns[s]);
        float prev = krow[0];
        if (first) {
          gu0 = pad > 0 ? gn[0] : gnode<C>(x, xnn, yc, ync);
        } else {
          kl = kl_in;
          gu0 = gu_in;
        }
        float gl0 = grow[0];
        float* st = mine + cur * SF;
#pragma unroll
        for (int q = 0; q < SPAN; ++q) {
          const float gu1 = gn[q];
          const float gl1 = grow[q + 1];
          const Coef cf = coef(gu1, gu0, gl1, gl0);
          const float old = krow[q + 1];
          const float s = __fadd_rn(kl, old);
          const float kn = __fsub_rn(__fmul_rn(s, cf.A), __fmul_rn(prev, cf.B));
          if (FAC) {
            const float zi6 = __fmul_rn(cf.z, I6);
            st[q * stride] = __fadd_rn(__fmul_rn(s, __fadd_rn(0.5f, zi6)), __fmul_rn(prev, zi6));
          }
          krow[q + 1] = kn;
          grow[q] = gu0;  // row i+1: the next row's lower row
          prev = old;
          kl = kn;
          gu0 = gu1;
          gl0 = gl1;
        }
        grow[SPAN] = gu0;
        if (!first) krow[0] = kl_in;
        if (last && cu.m == lx1 - 1) kout[p] = kl;
      }
      kl_in = __shfl_up_sync(FULL, kl, 1, g);
      gu_in = __shfl_up_sync(FULL, gu0, 1, g);
      if (FAC) {  // the block writes the stage out: its lane's rows of this unit
        __syncthreads();
        if (cu.m >= 0 && cu.r < runs) {
          const size_t p0 = cu.p - gi;  // the band's first pair of this tile
          const float* sb = stage + cur * SF;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const Item& I = it[n];
            if (I.goff < 0) continue;
            const size_t q0 = p0 + I.coff;  // the item's first pair
            float* dst = fac + (size_t)cu.m * rowP + (size_t)I.goff + p0;
            const float* src = sb + I.soff;
            if (P % 4 == 0 && q0 + 4 <= P) {
              *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
            } else {
              for (int s = 0; s < 4; ++s)
                if (q0 + s < P) dst[s] = src[s];
            }
          }
        }
        cur ^= 1;
      }
      cu = nu;
    }
  }
}

// ---- backward -----------------------------------------------------------------
// Pull-back of one dg pair at node q: row i+1 (point xh) gets w_hi = D·gh,
// row i (point xl) gets w_lo = -D·gl; dyq accumulates the column path's
// gradient of node q.
template <int C>
__device__ __forceinline__ void pull_back(float D, float gh, float gl, const float (&y)[C],
                                          float (&dyq)[C], const float (&xh)[C],
                                          const float (&xl)[C], float (&sxh)[C],
                                          float (&sxl)[C], float& swh, float& swl) {
  const float wh = __fmul_rn(D, gh);
  const float wl = -__fmul_rn(D, gl);
  swh = __fadd_rn(swh, wh);
  swl = __fadd_rn(swl, wl);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sxh[c] = __fmaf_rn(wh, y[c], sxh[c]);
    sxl[c] = __fmaf_rn(wl, y[c], sxl[c]);
    const float s = __fmaf_rn(wh, __fsub_rn(y[c], xh[c]), __fmul_rn(wl, __fsub_rn(y[c], xl[c])));
    dyq[c] = __fmaf_rn(-2.f, s, dyq[c]);
  }
}

// The lanes' spans are SPAN columns each: the grid is padded on the right
// with pad = g·SPAN - ly1 virtual columns whose y point is point ly1; no
// seed reaches them, so their adjoint is 0 and they add exact zeros; their
// fac reads a stage row that stays 0. Lane t holds columns [t·SPAN,
// (t+1)·SPAN) and forms the static nodes c0 .. c0+SPAN-1 of a row; its
// right node comes from lane t+1, or, for lane g-1, is a virtual node equal
// to its last (at pad = 0 node ly1, one more exp).
template <int SPAN, int C>
__global__ void __launch_bounds__(NT, SPAN == 5 && C <= 2 ? 4 : (C <= 6 ? 3 : 2))
small_bwd_lanes_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                       const float* __restrict__ fac, const float* __restrict__ gout,
                       float* __restrict__ dxt, float* __restrict__ dyt, int P_, int lx1,
                       int ly1, int g, int runs, int tiles) {
  extern __shared__ float stage[];  // BWD_STAGES stages of stage_floats(g, SPAN)
  const size_t P = P_;
  const int t = (threadIdx.x & 31) & (g - 1), gi = threadIdx.x / g;
  const int pad = g * SPAN - ly1, c0 = t * SPAN;
  const bool first = t == 0, last = t == g - 1;
  const int NG = NT / g;
  const int U = runs * lx1, steps = U + g - 1;
  const int stride = stage_stride(g), SF = stage_floats(g, SPAN);
  const size_t CP = (size_t)C * P;
  const float* mine = stage + t * SPAN * stride + gi;
  Item it[2];
  items_init<SPAN>(it, g, t, gi, c0, ly1, P);
  const size_t rowP = (size_t)ly1 * P;
  for (int e = threadIdx.x; e < BWD_STAGES * SF; e += NT) stage[e] = 0.f;  // virtual rows stay 0
  __syncthreads();
  int cur = 0;  // the stage this step reads; cycles across tiles too

  // the lane's span: y points c0 .. c0+SPAN (a virtual point is point ly1)
  // and their norms, the static row g[i+1][c0 + q], the row above's partial
  // adjoint λ[i+1][c0 + q] (q >= 1), the column-path gradients of its
  // nodes (q >= 1; lane 0 also q = 0)
  float y[SPAN + 1][C], yn[SPAN + 1], gs[SPAN + 1], lam[SPAN + 1], dy[SPAN + 1][C];
  float xh[C], xn[C], carry[C];
  // the pipeline's state, handed to lane t-1 at the span's left edge: the
  // cell's increment λ[i+1][c0+1]·A that completes λ[i+1][c0] there, the
  // pending term of λ[i][c0], the cell's dz, g[i][c0] and the row-path sums
  float tt = 0.f, pending = 0.f, dzr = 0.f, gl_r = 0.f, swh = 0.f, swl = 0.f;
  float sxh[C], sxl[C];
#pragma unroll
  for (int q = 0; q <= SPAN; ++q) {
    yn[q] = gs[q] = lam[q] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) y[q][c] = dy[q][c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) xh[c] = xn[c] = carry[c] = sxh[c] = sxl[c] = 0.f;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t tile_pair = (size_t)tile * NG, band = (size_t)tiles * NG;
    // fac rows top down, BWD_STAGES - 1 steps ahead: the unit the thread's
    // lane takes at the step it loads for, its rows
    Unit au = unit_before(g - 1 - t);
    auto load_stage = [&](float* st) {
      unit_next(au, lx1, runs, tile_pair + gi, band, P, 0, 0);
      if (au.m >= 0 && au.r < runs) {
        const size_t p0 = au.p - gi;  // the band's first pair of this tile
        const float* row = fac + (size_t)(lx1 - 1 - au.m) * rowP + p0;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const Item& I = it[n];
          if (I.goff < 0) continue;
          const size_t q0 = p0 + I.coff;  // the item's first pair
          const float* src = row + I.goff;
          float* dst = st + I.soff;
          if (P % 4 == 0 && q0 + 4 <= P) {
            cp_async16(dst, src);
          } else {
            for (int s = 0; s < 4; ++s)
              if (q0 + s < P) cp_async4(dst + s, src + s);
          }
        }
      }
      cp_async_commit();
    };
    int ahead = cur;
    for (int s = 0; s < BWD_STAGES - 1; ++s) {
      load_stage(stage + ahead * SF);
      ahead = ahead + 1 == BWD_STAGES ? 0 : ahead + 1;
    }
    // the lane's unit (row lx1-1 - m, x point lx1-1 - m), the next one's x
    // point loaded a step ahead
    const size_t xtop = (size_t)(lx1 - 1) * CP;
    Unit cu = unit_before(g - 1 - t);
    unit_next(cu, lx1, runs, tile_pair + gi, band, P, xtop, -(ptrdiff_t)CP);
    if (active(cu)) load_pt<C>(xt + cu.off, 0, P, 0, xn);
    for (int k = 0; k < steps; ++k) {
      cp_async_wait<BWD_STAGES - 2>();
      __syncthreads();  // step k's stage has landed; step k-1's reads are done
      load_stage(stage + ahead * SF);
      ahead = ahead + 1 == BWD_STAGES ? 0 : ahead + 1;
      float xl[C];
#pragma unroll
      for (int c = 0; c < C; ++c) xl[c] = xn[c];
      Unit nu = cu;
      unit_next(nu, lx1, runs, tile_pair + gi, band, P, xtop, -(ptrdiff_t)CP);
      if (active(nu)) load_pt<C>(xt + nu.off, 0, P, 0, xn);
      if (active(cu)) {
        const int i = lx1 - 1 - cu.m;
        const size_t p = cu.p;
        if (cu.m == 0) {  // a pair's start: y points, static row lx1, the seed
          load_pt<C>(xt, lx1, P, p, xh);
          const float xhn = sq_norm<C>(xh);
          const float seed = gout[p];
#pragma unroll
          for (int q = 0; q <= SPAN; ++q) {
            load_pt<C>(yt, min(c0 + q, ly1), P, p, y[q]);
            yn[q] = sq_norm<C>(y[q]);
            gs[q] = gnode<C>(xh, xhn, y[q], yn[q]);
            lam[q] = c0 + q == ly1 ? seed : 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) dy[q][c] = 0.f;
          }
          if (first) {
#pragma unroll
            for (int c = 0; c < C; ++c) carry[c] = 0.f;
          }
        }
        const float xln = sq_norm<C>(xl);
        float gn[SPAN];  // static row i at nodes c0 .. c0+SPAN-1
#pragma unroll
        for (int s = 0; s < SPAN; ++s) gn[s] = gnode<C>(xl, xln, y[s], yn[s]);
        // λ[i+1][c0+SPAN] completed by lane t+1's increment; lane g-1 starts
        // the row there, where it is complete, with clean sums
        const float R0 = __fadd_rn(lam[SPAN], last ? 0.f : tt);
        pending = last ? 0.f : pending;
        dzr = last ? 0.f : dzr;
        swh = last ? 0.f : swh;
        swl = last ? 0.f : swl;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          sxh[c] = last ? 0.f : sxh[c];
          sxl[c] = last ? 0.f : sxl[c];
        }
        if (last) gl_r = pad > 0 ? gn[SPAN - 1] : gnode<C>(xl, xln, y[SPAN], yn[SPAN]);
        float R = R0;
        const float* st = mine + cur * SF;
#pragma unroll
        for (int q = SPAN - 1; q >= 0; --q) {  // cell (i, c0+q), right to left
          const float gl0 = gn[q];
          const Coef cf = coef(gs[q + 1], gs[q], gl_r, gl0);
          tt = __fmul_rn(R, cf.A);
          const float lam_new = __fadd_rn(pending, tt);  // λ[i][c0+q+1], partial
          pending = -__fmul_rn(R, cf.B);
          const float dz = __fmul_rn(R, st[q * stride]);
          pull_back<C>(__fsub_rn(dz, dzr), gs[q + 1], gl_r, y[q + 1], dy[q + 1], xh, xl, sxh,
                       sxl, swh, swl);
          lam[q + 1] = lam_new;
          gs[q + 1] = gl_r;  // row i: the next row's upper row
          if (q > 0) R = __fadd_rn(lam[q], tt);  // completes λ[i+1][c0+q]
          dzr = dz;
          gl_r = gl0;
        }
        if (first) {  // node column 0 and the row-path gradients
          pull_back<C>(-dzr, gs[0], gl_r, y[0], dy[0], xh, xl, sxh, sxl, swh, swl);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dxt[((size_t)(i + 1) * C + c) * P + p] =
                __fadd_rn(carry[c], 2.f * __fsub_rn(sxh[c], __fmul_rn(xh[c], swh)));
            carry[c] = 2.f * __fsub_rn(sxl[c], __fmul_rn(xl[c], swl));
            if (i == 0) dxt[(size_t)c * P + p] = carry[c];
          }
        }
        gs[0] = gl_r;
        if (i == 0) {  // the pair's end: the column-path gradients of the lane's nodes
#pragma unroll
          for (int q = 0; q <= SPAN; ++q) {
            if ((q > 0 || first) && c0 + q <= ly1) {
#pragma unroll
              for (int c = 0; c < C; ++c) dyt[((size_t)(c0 + q) * C + c) * P + p] = dy[q][c];
            }
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) xh[c] = xl[c];
      }
      // ---- the hand-off to lane t-1
      tt = __shfl_down_sync(FULL, tt, 1, g);
      pending = __shfl_down_sync(FULL, pending, 1, g);
      dzr = __shfl_down_sync(FULL, dzr, 1, g);
      gl_r = __shfl_down_sync(FULL, gl_r, 1, g);
      swh = __shfl_down_sync(FULL, swh, 1, g);
      swl = __shfl_down_sync(FULL, swl, 1, g);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        sxh[c] = __shfl_down_sync(FULL, sxh[c], 1, g);
        sxl[c] = __shfl_down_sync(FULL, sxl[c], 1, g);
      }
      cur = cur + 1 == BWD_STAGES ? 0 : cur + 1;
      cu = nu;
    }
  }
}

// ---- host side -----------------------------------------------------------------

// The plan (kernels/sigkernel_small.py::small_plan) picks g, the span
// template, the runs, tiles and blocks; these are the shapes the kernels
// take (span 5 only up to C = 4).
bool valid(int lx1, int ly1, int C, int g, int span) {
  if (lx1 < 1 || ly1 < 1 || ly1 > 63 || C < 1 || C > 8) return false;
  if (g < 1 || g > 32 || g > ly1 || (g & (g - 1)) != 0) return false;
  if (span != 3 && !(span == 5 && C <= 4)) return false;
  return (ly1 + g - 1) / g <= span;
}

size_t fwd_smem(int g, int span) { return FWD_STAGES * sizeof(float) * stage_floats(g, span); }
size_t bwd_smem(int g, int span) { return BWD_STAGES * sizeof(float) * stage_floats(g, span); }

template <int SPAN, int C>
cudaError_t resident(int part, int g, int* per_sm) {
  if (part == 0)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, small_fwd_lanes_kernel<SPAN, C, false>, NT, 0);
  if (part == 1)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, small_fwd_lanes_kernel<SPAN, C, true>, NT, fwd_smem(g, SPAN));
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, small_bwd_lanes_kernel<SPAN, C>,
                                                       NT, bwd_smem(g, SPAN));
}

template <int SPAN, int C>
cudaError_t launch_fwd(const float* xt, const float* yt, float* k, float* fac, int P, int lx1,
                       int ly1, int g, int runs, int tiles, int blocks, cudaStream_t st) {
  if (fac)
    small_fwd_lanes_kernel<SPAN, C, true><<<blocks, NT, fwd_smem(g, SPAN), st>>>(
        xt, yt, k, fac, P, lx1, ly1, g, runs, tiles);
  else
    small_fwd_lanes_kernel<SPAN, C, false><<<blocks, NT, 0, st>>>(xt, yt, k, nullptr, P, lx1,
                                                                   ly1, g, runs, tiles);
  return cudaGetLastError();
}

template <int SPAN, int C>
cudaError_t launch_bwd(const float* xt, const float* yt, const float* fac, const float* gout,
                       float* dxt, float* dyt, int P, int lx1, int ly1, int g, int runs,
                       int tiles, int blocks, cudaStream_t st) {
  small_bwd_lanes_kernel<SPAN, C><<<blocks, NT, bwd_smem(g, SPAN), st>>>(
      xt, yt, fac, gout, dxt, dyt, P, lx1, ly1, g, runs, tiles);
  return cudaGetLastError();
}

}  // namespace

// span × C dispatch: span 3 at C = 1..8, span 5 at C = 1..4
#define K7_DISPATCH(FN, ...)                    \
  switch (span * 16 + C) {                      \
    case 49: return (int)FN<3, 1>(__VA_ARGS__); \
    case 50: return (int)FN<3, 2>(__VA_ARGS__); \
    case 51: return (int)FN<3, 3>(__VA_ARGS__); \
    case 52: return (int)FN<3, 4>(__VA_ARGS__); \
    case 53: return (int)FN<3, 5>(__VA_ARGS__); \
    case 54: return (int)FN<3, 6>(__VA_ARGS__); \
    case 55: return (int)FN<3, 7>(__VA_ARGS__); \
    case 56: return (int)FN<3, 8>(__VA_ARGS__); \
    case 81: return (int)FN<5, 1>(__VA_ARGS__); \
    case 82: return (int)FN<5, 2>(__VA_ARGS__); \
    case 83: return (int)FN<5, 3>(__VA_ARGS__); \
    case 84: return (int)FN<5, 4>(__VA_ARGS__); \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// Blocks of K7's forward values only (part 0), with the residual (part 1)
// or backward (part 2) resident on one SM at once, with the stages of g
// lanes a pair, for the plan.
int sigkernel_small_resident(int span, int C, int part, int g, int* per_sm) {
  if (g < 1 || g > 32 || part < 0 || part > 2) return (int)cudaErrorInvalidValue;
  K7_DISPATCH(resident, part, g, per_sm)
}

// xt [Lx, C, P], yt [Ly, C, P] scaled path tiles; k [P]; fac [Lx-1, Ly-1, P]
// or null (values only). fp32, contiguous, on the stream's device; g, span,
// runs (pairs a group walks), tiles (of runs·128/g pairs) and blocks from
// the plan. Returns cudaGetLastError() after the launch.
int sigkernel_small_fwd(const float* xt, const float* yt, float* k, float* fac, int P, int Lx,
                        int Ly, int C, int g, int span, int runs, int tiles, int blocks,
                        void* stream) {
  if (!valid(Lx - 1, Ly - 1, C, g, span) || P < 1 || runs < 1 || tiles < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  K7_DISPATCH(launch_fwd, xt, yt, k, fac, P, Lx - 1, Ly - 1, g, runs, tiles, blocks,
              static_cast<cudaStream_t>(stream))
}

// xt, yt as the forward, fac its residual, gout [P]; writes dxt [Lx, C, P],
// dyt [Ly, C, P], the gradients of Σ gout·k. g, span, runs, tiles and
// blocks from the plan. No device scratch.
int sigkernel_small_bwd(const float* xt, const float* yt, const float* fac, const float* gout,
                        float* dxt, float* dyt, int P, int Lx, int Ly, int C, int g, int span,
                        int runs, int tiles, int blocks, void* stream) {
  if (!valid(Lx - 1, Ly - 1, C, g, span) || P < 1 || runs < 1 || tiles < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  K7_DISPATCH(launch_bwd, xt, yt, fac, gout, dxt, dyt, P, Lx - 1, Ly - 1, g, runs, tiles,
              blocks, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
