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
// recomputes the chain (keeping each hop's bf16 input and fp32 last node),
// then sweeps the hops in reverse:
//   dz   += Σ_{d>=1} d·z^{d-1}·Σ_f U_d[f]·d_out[f]
//   d_in  = Σ_d M_d[:, :128]ᵀ·bf16(z^d·d_out)  (rows < 128),
//           Σ_d Σ_f M_d[f, 128]·z^d·d_out[f]   (row 128, fp32).
//
// What bounds it on an H100: operations. A hop is a [P x 128] x [128 x 136]
// bf16 product for each of the 11 degrees, against 4 bytes of z per coarse
// cell, so at the planning shape (2^20 pairs, 4 hops) the forward is
// ~1.5e12 bf16 operations (~1.5 ms at 989 TFLOP/s) and moves ~21 MB. The
// basis (11 slices of 37 KB) is shared by every pair and is read from L2,
// once per hop and degree for each pair tile. The design:
//   * pairs on the M side of Hopper's wgmma: a consumer warpgroup owns 64
//     pairs (m64nNk16, bf16 in, fp32 accumulators, A from registers), a
//     block one or two consumer warpgroups, so each staged slice serves up
//     to 128 pairs. The accumulator layout is the A-from-registers layout,
//     so the next hop's input (north rows from the hop below, east rows of
//     the hop to the left) and the weighted cotangent bf16(z^d·d_out) are
//     formed in registers; z^d, the rank-1 last-node term and the degree sum
//     are applied per pair (a row) in registers;
//   * a producer warp copies the degree slices M_d (bf16 [144 x 128], 128B
//     swizzled, packed so by the wrapper) with cp.async.bulk into a ring of
//     shared-memory stages, with mbarriers; the consumers release a stage
//     when their products on it are complete. The basis never goes through
//     registers on its way in;
//   * one staged slice serves both products: U_d reads it K-major (B[e, f]
//     = M_d[f, e]), d_in MN-major (B[f, e] = M_d[f, e]). The reverse sweep
//     is one pass over the degrees per hop (d_in, then U_d and its dz term),
//     whose only waits are the ring's mbarriers: no block barrier runs after
//     the set-up;
//   * each thread's north rows (forward: bf16 fragments; backward: fp32
//     cotangents) and each hop's kept input are private to it, so they need
//     no barrier: they sit in shared memory where the plan's budget allows
//     (mxu_chain.py::chain_plan), else in per-block device scratch;
//   * pairs are independent and a pair's sums over f run within its thread
//     and then its quad in a fixed order: no atomics, deterministic sums.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int FP = 144;                  // slice rows (129 used, zeros below)
constexpr int BLK = FP * 128;            // bytes of one 64-wide column block
constexpr int SLICE = 2 * BLK;           // bytes of one degree slice
constexpr int WGT = 128;                 // threads a warpgroup
constexpr int PAIRS = 64;                // pairs a consumer warpgroup
constexpr int NSLOT = 9;                 // uint4 a thread in a north slot
constexpr int KSLOT = 9;                 // uint4 a thread in a kept-input slot
constexpr int MAX_WG = 2;                // consumer warpgroups a block
constexpr uint32_t ONES = 0x3F803F80u;   // two bf16 1.0

struct Params {
  const float* z;        // [B, nc]
  const float* gout;     // [B] (backward)
  const char* basis;     // [D1] packed slices
  const float* mlast;    // [D1, 144]
  float* out;            // k [B] or dz [B, nc]
  uint4* north;          // device scratch, or null when in shared memory
  uint4* kept;           // device scratch, or null when in shared memory (backward)
  int B, nc, nbx, nby, sub, ly1, D1, nwg, nstage, north_smem, kept_smem;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- mbarriers and the bulk copy ------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!ok);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// B[e, f] = M_d[f, e] for k-step ks (e = 16ks..16ks+15) and rows f0.. of a
// staged slice: K-major, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t slice, int ks, int f0) {
  return smem_desc(slice + (ks >> 2) * BLK + f0 * 128 + (ks & 3) * 32, 16, 1024);
}

// B[f, e] = M_d[f, e] for k-step ks (f = 16ks..16ks+15), e = 0..127:
// MN-major, the two 64-wide column blocks BLK apart, 8-row groups 1024.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t slice, int ks) {
  return smem_desc(slice + ks * 2048, BLK, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 72] (+)= A[64 x 16] (registers) · B (K-major descriptor)
__device__ __forceinline__ void wgmma_n72_kmajor(float (&d)[36], const uint32_t (&a)[4],
                                                 uint64_t desc, uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] (registers) · B (MN-major descriptor)
__device__ __forceinline__ void wgmma_n128_mnmajor(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1u));
}

// ---- one consumer thread ------------------------------------------------------
//
// Thread t of a consumer warpgroup (warp w = t/32, g = lane/4, q = lane%4)
// holds pairs r0 = 16w+g and r1 = r0+8 of the warpgroup's 64, and columns
// f = 8j+2q, 8j+2q+1 of each 8-column n-tile j: accumulator element 4j+c is
// (row c < 2 ? r0 : r1, column 8j+2q+(c&1)). The A fragment of k-step ks
// packs n-tiles 2ks and 2ks+1 of that layout.

struct Ring {
  uint32_t slices, full, empty;  // shared addresses: stage s at +s·SLICE, +8s
  int nstage, stage;
  uint32_t phase;
  __device__ __forceinline__ uint32_t wait() {
    mbar_wait(full + 8 * stage, phase);
    return slices + stage * SLICE;
  }
  // after this warp's products on the stage are complete
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * stage);
    if (++stage == nstage) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

struct Thread {
  const Params* p;
  const float* mlast;  // shared [D1][FP]
  uint4* north;        // this thread's north slots: [(I·NSLOT + i)·WGT + t]
  uint4* kept;         // its kept inputs: [(h·KSLOT + i)·WGT + t]
  int t, q, r0, r1;    // r0, r1: rows within the warpgroup
};

// The A fragment of k-step ks from accumulator n-tiles 2ks, 2ks+1.
__device__ __forceinline__ void frag_of(const float* acc, int ks, uint32_t (&a)[4]) {
  a[0] = pack_bf16(acc[8 * ks + 0], acc[8 * ks + 1]);
  a[1] = pack_bf16(acc[8 * ks + 2], acc[8 * ks + 3]);
  a[2] = pack_bf16(acc[8 * ks + 4], acc[8 * ks + 5]);
  a[3] = pack_bf16(acc[8 * ks + 6], acc[8 * ks + 7]);
}

__device__ __forceinline__ float zval(const Thread& th, int p0, int r, int cidx) {
  const int pr = p0 + r;
  return pr < th.p->B ? __ldg(&th.p->z[(size_t)pr * th.p->nc + cidx]) : 0.f;
}

// Hop (I, J)'s input: the south nodes e <= 64 from column I's north slot
// (ones at J == 0), the west nodes e > 64 from the previous hop's output
// `out` (ones at I == 0); bf16 fragments a[0..7] and the fp32 last node.
__device__ __forceinline__ void hop_input(const Thread& th, const float (&out)[72], int I,
                                          int J, uint32_t (&a)[8][4], float (&il)[2]) {
  if (I == 0) {
#pragma unroll
    for (int ks = 4; ks < 8; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[ks][r] = ONES;
    il[0] = il[1] = 1.f;
  } else {
#pragma unroll
    for (int ks = 4; ks < 8; ++ks) frag_of(out, ks, a[ks]);
    // node 128 is column 2q of n-tile 16 at q = 0
    const int src = (threadIdx.x & 31) & ~3;
    il[0] = __shfl_sync(0xffffffffu, out[64], src);
    il[1] = __shfl_sync(0xffffffffu, out[66], src);
  }
  uint4 s[5];
  if (J == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) s[i] = make_uint4(ONES, ONES, ONES, ONES);
  } else {
#pragma unroll
    for (int i = 0; i < 5; ++i) s[i] = th.north[(I * NSLOT + i) * WGT + th.t];
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = s[ks].x;
    a[ks][1] = s[ks].y;
    a[ks][2] = s[ks].z;
    a[ks][3] = s[ks].w;
  }
  if (th.q == 0) {  // node 64 (the low half at q = 0) is south
    a[4][0] = (s[4].x & 0xFFFFu) | (a[4][0] & 0xFFFF0000u);
    a[4][1] = (s[4].y & 0xFFFFu) | (a[4][1] & 0xFFFF0000u);
  }
}

// U_d over rows f0..f0+71 for the thread's pairs: u = (bf16(in)·M_dᵀ) +
// M_d[f, 128]·in[128].
__device__ __forceinline__ void hop_u_chunk(uint32_t slice, const uint32_t (&a)[8][4],
                                            int f0, float (&u)[36]) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) wgmma_n72_kmajor(u, a[ks], desc_kmajor(slice, ks, f0), ks > 0);
}

__device__ __forceinline__ void add_rank1(const Thread& th, int d, int j0, const float (&il)[2],
                                          float (&u)[36]) {
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float2 ml =
        *reinterpret_cast<const float2*>(th.mlast + d * FP + 8 * (j0 + j) + 2 * th.q);
    u[4 * j + 0] = u[4 * j + 0] + ml.x * il[0];
    u[4 * j + 1] = u[4 * j + 1] + ml.y * il[0];
    u[4 * j + 2] = u[4 * j + 2] + ml.x * il[1];
    u[4 * j + 3] = u[4 * j + 3] + ml.y * il[1];
  }
}

__device__ __forceinline__ void degree_sum(int d, int j0, const float (&zp)[2],
                                           const float (&u)[36], float (&out)[72]) {
#pragma unroll
  for (int j = 0; j < 9; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float& o = out[4 * (j0 + j) + c];
      o = d == 0 ? u[4 * j + c] : o + zp[c >> 1] * u[4 * j + c];
    }
}

// One forward hop: out = Σ_d z^d U_d, one staged slice a degree.
__device__ __forceinline__ void forward_hop(const Thread& th, Ring& ring,
                                            const uint32_t (&a)[8][4], const float (&il)[2],
                                            const float (&zc)[2], float (&out)[72]) {
  float zp[2] = {zc[0], zc[1]};
  for (int d = 0; d < th.p->D1; ++d) {
    const uint32_t slice = ring.wait();
    float u1[36], u2[36];
    wgmma_fence();
    hop_u_chunk(slice, a, 0, u1);
    wgmma_commit();
    hop_u_chunk(slice, a, 72, u2);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(u1);
    add_rank1(th, d, 0, il, u1);
    degree_sum(d, 0, zp, u1, out);
    wgmma_wait<0>();
    fence_regs(u2);
    ring.release();
    add_rank1(th, d, 9, il, u2);
    degree_sum(d, 9, zp, u2, out);
    if (d > 0) {
      zp[0] = zp[0] * zc[0];
      zp[1] = zp[1] * zc[1];
    }
  }
}

// The forward chain of the thread's pairs p0 + r0, p0 + r1. With `keep`
// (the backward) each hop's input goes to its kept slot and the last hop,
// whose output nothing reads, is not run; else k is written.
__device__ __forceinline__ void forward_chain(const Thread& th, Ring& ring, int p0, bool keep) {
  const Params& p = *th.p;
  const int H = p.nbx * p.nby;
  float out[72];
#pragma unroll
  for (int i = 0; i < 72; ++i) out[i] = 0.f;
  for (int h = 0; h < H; ++h) {
    const int J = h / p.nbx, I = h % p.nbx;
    uint32_t a[8][4];
    float il[2];
    hop_input(th, out, I, J, a, il);
    if (keep) {
      uint4* slot = th.kept + (size_t)h * KSLOT * WGT + th.t;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        slot[ks * WGT] = make_uint4(a[ks][0], a[ks][1], a[ks][2], a[ks][3]);
      slot[8 * WGT] = make_uint4(__float_as_uint(il[0]), __float_as_uint(il[1]), 0u, 0u);
      if (h == H - 1) break;
    }
    const int cidx = (I / p.sub) * p.ly1 + J / p.sub;
    const float zc[2] = {zval(th, p0, th.r0, cidx), zval(th, p0, th.r1, cidx)};
    forward_hop(th, ring, a, il, zc, out);
    if (J < p.nby - 1) {
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        uint32_t f[4];
        frag_of(out, i, f);
        th.north[(I * NSLOT + i) * WGT + th.t] = make_uint4(f[0], f[1], f[2], f[3]);
      }
    }
  }
  if (!keep && th.q == 0) {  // node 64 of the last hop: n-tile 8, column 0
    if (p0 + th.r0 < p.B) p.out[p0 + th.r0] = out[32];
    if (p0 + th.r1 < p.B) p.out[p0 + th.r1] = out[34];
  }
}

// The reverse sweep of the thread's pairs: one pass over the degrees a hop.
__device__ __forceinline__ void reverse_sweep(const Thread& th, Ring& ring, int p0) {
  const Params& p = *th.p;
  const int H = p.nbx * p.nby;
  float din[64], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) din[i] = 0.f;
  if (th.q == 0) {
    for (int c = 0; c < p.nc; ++c) {
      if (p0 + th.r0 < p.B) p.out[(size_t)(p0 + th.r0) * p.nc + c] = 0.f;
      if (p0 + th.r1 < p.B) p.out[(size_t)(p0 + th.r1) * p.nc + c] = 0.f;
    }
  }
  for (int h = H - 1; h >= 0; --h) {
    const int J = h / p.nbx, I = h % p.nbx;
    // d_out: north rows from column I's slot (the hop above; at the top row
    // only k's cotangent), east rows from the hop to the right's d_in
    float dout[68];
    const bool east = I < p.nbx - 1;
#pragma unroll
    for (int i = 32; i < 64; ++i) dout[i] = east ? din[i] : 0.f;
    dout[64] = east && th.q == 0 ? dl[0] : 0.f;
    dout[66] = east && th.q == 0 ? dl[1] : 0.f;
    dout[65] = dout[67] = 0.f;
    if (J == p.nby - 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dout[i] = 0.f;
      if (th.q == 0) {
        const bool top = I == p.nbx - 1;
        dout[32] = top && p0 + th.r0 < p.B ? p.gout[p0 + th.r0] : 0.f;
        dout[34] = top && p0 + th.r1 < p.B ? p.gout[p0 + th.r1] : 0.f;
      }
    } else {
      const uint4* slot = th.north + (size_t)I * NSLOT * WGT + th.t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint4 v = slot[j * WGT];
        dout[4 * j + 0] = __uint_as_float(v.x);
        dout[4 * j + 1] = __uint_as_float(v.y);
        dout[4 * j + 2] = __uint_as_float(v.z);
        dout[4 * j + 3] = __uint_as_float(v.w);
      }
      if (th.q == 0) {
        const uint4 v = slot[8 * WGT];
        dout[32] = __uint_as_float(v.x);
        dout[34] = __uint_as_float(v.z);
      }
    }
    // the hop's kept input and z
    uint32_t a[8][4];
    float il[2];
    {
      const uint4* slot = th.kept + (size_t)h * KSLOT * WGT + th.t;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const uint4 v = slot[ks * WGT];
        a[ks][0] = v.x;
        a[ks][1] = v.y;
        a[ks][2] = v.z;
        a[ks][3] = v.w;
      }
      const uint4 v = slot[8 * WGT];
      il[0] = __uint_as_float(v.x);
      il[1] = __uint_as_float(v.y);
    }
    const int cidx = (I / p.sub) * p.ly1 + J / p.sub;
    const float zc[2] = {zval(th, p0, th.r0, cidx), zval(th, p0, th.r1, cidx)};
#pragma unroll
    for (int i = 0; i < 64; ++i) din[i] = 0.f;
    float zp[2] = {1.f, 1.f};  // z^{d-1} entering degree d >= 1
    float dz[2] = {0.f, 0.f};
    dl[0] = dl[1] = 0.f;
    for (int d = 0; d < p.D1; ++d) {
      const uint32_t slice = ring.wait();
      float zd[2] = {zp[0], zp[1]};  // z^d
      if (d > 0) {
        zd[0] = zp[0] * zc[0];
        zd[1] = zp[1] * zc[1];
      }
      // d_in += bf16(z^d·d_out)·M_d, and the last node's fp32 cotangent
      fence_regs(din);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 9; ++ks) {
        float w[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = 2 * ks + (c >> 2);
          w[c] = j < 17 ? zd[(c >> 1) & 1] * dout[4 * j + (c & 3)] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * ks + jj;
          if (j < 17) {
            const float2 ml =
                *reinterpret_cast<const float2*>(th.mlast + d * FP + 8 * j + 2 * th.q);
            dl[0] = fmaf(ml.x, w[4 * jj + 0], dl[0]);
            dl[0] = fmaf(ml.y, w[4 * jj + 1], dl[0]);
            dl[1] = fmaf(ml.x, w[4 * jj + 2], dl[1]);
            dl[1] = fmaf(ml.y, w[4 * jj + 3], dl[1]);
          }
        }
        const uint32_t wa[4] = {pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]),
                                pack_bf16(w[4], w[5]), pack_bf16(w[6], w[7])};
        wgmma_n128_mnmajor(din, wa, desc_mnmajor(slice, ks));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(din);
      // U_d (d >= 1) and its term of dz, 72 rows at a time
      if (d > 0) {
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float u[36];
          wgmma_fence();
          hop_u_chunk(slice, a, 72 * half, u);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(u);
          add_rank1(th, d, 9 * half, il, u);
#pragma unroll
          for (int j = 0; j < 9; ++j) {
            const int jg = 9 * half + j;
            if (jg < 17) {
              part[0] = fmaf(u[4 * j + 0], dout[4 * jg + 0], part[0]);
              part[0] = fmaf(u[4 * j + 1], dout[4 * jg + 1], part[0]);
              part[1] = fmaf(u[4 * j + 2], dout[4 * jg + 2], part[1]);
              part[1] = fmaf(u[4 * j + 3], dout[4 * jg + 3], part[1]);
            }
          }
        }
        dz[0] = fmaf((float)d * zp[0], part[0], dz[0]);
        dz[1] = fmaf((float)d * zp[1], part[1], dz[1]);
      }
      ring.release();
      zp[0] = zd[0];
      zp[1] = zd[1];
    }
    // the pair's sums across its quad, in a fixed order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dz[r] += __shfl_xor_sync(0xffffffffu, dz[r], 1);
      dz[r] += __shfl_xor_sync(0xffffffffu, dz[r], 2);
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
    }
    if (th.q == 0) {
      if (p0 + th.r0 < p.B) p.out[(size_t)(p0 + th.r0) * p.nc + cidx] += dz[0];
      if (p0 + th.r1 < p.B) p.out[(size_t)(p0 + th.r1) * p.nc + cidx] += dz[1];
    }
    // the south nodes' cotangent to column I's slot for the hop below
    if (J > 0) {
      uint4* slot = th.north + (size_t)I * NSLOT * WGT + th.t;
#pragma unroll
      for (int j = 0; j < 9; ++j)
        slot[j * WGT] = make_uint4(__float_as_uint(din[4 * j + 0]), __float_as_uint(din[4 * j + 1]),
                                   __float_as_uint(din[4 * j + 2]), __float_as_uint(din[4 * j + 3]));
    }
  }
}

template <bool BWD>
__global__ void __launch_bounds__((MAX_WG + 1) * WGT, 1) chain_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smraw[];
  // carve: [pad to 1024] ring | mlast | full, empty | north? | kept?
  const uint32_t raw = smem_u32(smraw);
  unsigned char* base = smraw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* cur = base + (size_t)p.nstage * SLICE;
  float* mlast = reinterpret_cast<float*>(cur);
  cur += (size_t)p.D1 * FP * 4;
  const uint32_t bars = smem_u32(cur);
  cur += 16 * p.nstage;
  uint4* north_s = reinterpret_cast<uint4*>(cur);
  const size_t north_wg = (size_t)p.nbx * NSLOT * WGT;  // uint4 a warpgroup
  if (p.north_smem) cur += north_wg * p.nwg * 16;
  uint4* kept_s = reinterpret_cast<uint4*>(cur);
  const size_t kept_wg = (size_t)p.nbx * p.nby * KSLOT * WGT;

  for (int i = threadIdx.x; i < p.D1 * FP; i += blockDim.x) mlast[i] = p.mlast[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.nstage; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (p.nstage + s), 4 * p.nwg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WGT;
  const int pairs = PAIRS * p.nwg;
  const int ntiles = (p.B + pairs - 1) / pairs;
  if (wg == p.nwg) {
    // producer: one thread streams the slices in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == p.nwg * WGT) {
      const int H = p.nbx * p.nby;
      const int per_tile = (BWD ? 2 * H - 1 : H) * p.D1;
      const uint32_t slices = smem_u32(base);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        for (int i = 0; i < per_tile; ++i) {
          const uint32_t empty = bars + 8 * (p.nstage + stage);
          mbar_wait(empty, phase ^ 1u);
          bulk_load(slices + stage * SLICE, p.basis + (size_t)(i % p.D1) * SLICE, SLICE,
                    bars + 8 * stage);
          if (++stage == p.nstage) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    Thread th;
    th.p = &p;
    th.mlast = mlast;
    th.t = threadIdx.x % WGT;
    const int lane = threadIdx.x & 31, warp = th.t / 32;
    th.q = lane & 3;
    th.r0 = 16 * warp + lane / 4;
    th.r1 = th.r0 + 8;
    th.north = p.north_smem ? north_s + wg * north_wg
                            : p.north + ((size_t)blockIdx.x * p.nwg + wg) * north_wg;
    th.kept = p.kept_smem ? kept_s + wg * kept_wg
                          : p.kept + ((size_t)blockIdx.x * p.nwg + wg) * kept_wg;
    Ring ring{smem_u32(base), bars, bars + 8 * p.nstage, p.nstage, 0, 0u};
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int p0 = tile * pairs + wg * PAIRS;
      forward_chain(th, ring, p0, BWD);
      if (BWD) reverse_sweep(th, ring, p0);
    }
  }
}

}  // namespace

extern "C" {

// One launch of K8's forward (bwd = 0: z → k) or backward (bwd = 1: z,
// gout → dz) kernel, on the plan of mxu_chain.py::chain_plan: `nwg`
// consumer warpgroups and one producer warpgroup a block, `nstage` ring
// stages, `smem` dynamic shared bytes, `blocks` persistent blocks; north
// (and kept) is per-block device scratch unless north_smem (kept_smem).
// basis: [D1] packed slices of 36,864 bytes; mlast [D1, 144] fp32.
// Returns cudaGetLastError() after the launch.
int mxu_chain_launch(int bwd, const float* z, const float* gout, const void* basis,
                     const float* mlast, float* out, void* north, void* kept, int B, int nc,
                     int nbx, int nby, int sub, int ly1, int D1, int nwg, int nstage,
                     int north_smem, int kept_smem, int smem, int blocks, void* stream) {
  Params p{z,  gout, static_cast<const char*>(basis), mlast, out, static_cast<uint4*>(north),
           static_cast<uint4*>(kept), B, nc, nbx, nby, sub, ly1, D1, nwg, nstage,
           north_smem, kept_smem};
  if (nwg < 1 || nwg > MAX_WG) return (int)cudaErrorInvalidValue;
  const auto kernel = bwd ? chain_kernel<true> : chain_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, (nwg + 1) * WGT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
