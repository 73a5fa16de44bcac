// Fused RBF Stein velocity (K9) on the tensor cores, in 3xTF32.
//
// Replaces the TPU kernel sigsvgd_tpu/kernels/pallas_svgd.py::_velocity_kernel
// (launched by fused_rbf_velocity_pallas). For particles x [N, D] (centred
// by the caller), scores s [N, D] fp32 and a bandwidth h it computes
//   φ_i = (Σ_j K_ij s_j - (Σ_j K_ij x_j - r_i x_i) / h²) / N,
//   K_ij = exp(-½·max(|x_i|² + |x_j|² - 2 x_i·x_j, 0) / h²),  r_i = Σ_j K_ij,
// the expand form of the JAX kernel and of the plain twin.
//
// What bounds it on an H100: operations. Three products of 2·N²·D
// (X·Xᵀ, K·s, K·x; 1.76e9 at N = 1024, D = 280) against 3·N·D floats of
// traffic. On the CUDA cores in fp32 that is 0.026 ms at 67 TFLOP/s
// ([1024, 280]; 0.079 at D = 840, 0.131 at 1400). Here every product runs
// on the tensor cores in 3xTF32: each operand splits into hi = tf32(a) and
// lo = tf32(a - hi) (round to nearest, ties away, as cvt.rna.tf32.f32), and
// a·b accumulates lo·hi + hi·lo + hi·hi in fp32, three TF32 passes. Its
// bound is 3 passes × 3 products × 2·N²·D over 495 TFLOP/s: 0.0107 ms at
// [1024, 280], 0.032 at D = 840, 0.053 at 1400; with X·Xᵀ counted once for
// its symmetry (N(N+1)/2 dot products), 0.0089, 0.0267 and 0.0445 ms, the
// bound chip_smoke.py reports.
//
// Why all three products in 3xTF32: single-pass TF32 keeps 10 mantissa
// bits. On the distances that is plainly too coarse (|x|² ~ 10³ against
// d² ~ 10³ with K's slope 1/h² ~ 10⁻²). On K·[s | x] it passes scores of
// unit size only because φ = (...)/N is then small enough for the
// tolerance's atol to hide it: with scores 100 times larger, the CPU
// emulation in tests/test_torch_velocity_tc.py puts single-pass TF32 at
// 2.5e-4 from the twin (the tolerance is rtol 2e-4, atol 5e-5), 3xTF32 at
// 1.1e-6. The JAX kernel's bf16 split of
// the cross term alone is a choice for the TPU's matrix unit, not part of
// the function. The tensor cores add with truncation, so a running sum
// leaves them every second k-slice for an fp32 add (round to nearest): the
// chains they add stay at 12 products.
//
// The design, two kernels a chunk, each a block of four warps that computes
// a 64 × 64 product C = A·B with mma.sync m16n8k8 tf32, the k axis streamed
// in 32-wide slices through shared memory by cp.async, double-buffered.
// Warp w owns rows 32·(w & 1) .. +32 against all 64 columns (2 × 8 mma
// tiles) for half of each slice's k-steps (w >> 1); the halves meet through
// shared memory at the end, in a fixed order. Operands are split in
// registers as they leave shared memory (two integer operations a half).
//   * Kernel A (gram_kernel): one 64 × 64 tile of X·Xᵀ a block. The squared
//     norms are summed from the same staged slices (the same code for a row
//     as for a column, so |x_i|² is one value). The epilogue forms d², the
//     clamp, expf and the ragged-edge mask in registers and stores the fp32
//     tile of K. So the distances are formed once per call at every D.
//   * Kernel B (apply_kernel): a block owns 64 rows and a 32-wide slice of
//     φ's columns. It streams 32-column slices of K with the matching rows
//     of s and x side by side (a 64-column B), accumulates K·s and K·x, and
//     r_i in fp32 from the K values it splits anyway, in a fixed order (a
//     quad's partial sums by a butterfly whose operands commute, then the
//     two k-halves). Its epilogue writes φ.
//   * K leaves the chip only as far as L2: a chunk of R rows × Cc columns
//     is at most 32 MiB of the 50 MB L2 (the wrapper's velocity_plan), so
//     kernel B reads back what kernel A wrote from L2, as the JAX kernel
//     keeps K in VMEM. Up to N = 2880 the whole Gram is one chunk and a call
//     makes two launches. Beyond, row chunks; beyond N = 131,072, square
//     column chunks too, each column chunk's term added into φ in a fixed
//     chunk order (φ holds the running sum until the last one divides by N).
// No atomics and no reduction in a varying order: φ is the same bit for bit
// from call to call.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int T = 64;            // rows and columns of a Gram tile; rows of a kernel-B block
constexpr int KS = 32;           // k-slice streamed through shared memory
constexpr int DS = 32;           // φ columns of a kernel-B block
constexpr int NTH = 128;         // four warps
constexpr int LDA = KS + 4;      // [.][36] tiles: a fragment's 32 reads hit 32 banks
constexpr int LDB = 2 * DS + 8;  // [32][72] tile of s | x: the same

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// cvt.rna.tf32.f32 of a finite a, in two integer operations (the cvt
// instruction adds an infinity test and a select on sm_90)
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo with hi = tf32(a), lo = tf32(a - hi): 21 of fp32's 24 bits
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in 3xTF32: the two small cross terms first, then hi·hi
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                     const uint32_t bh[2], const uint32_t bl[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// The A fragment (16 × 8, row-major) at (r0, k0) of a [.][LDA] tile, split;
// v keeps the fp32 values: (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4).
__device__ __forceinline__ void load_a(const float* t, int r0, int k0, int g, int q,
                                       uint32_t ah[4], uint32_t al[4], float v[4]) {
  v[0] = t[(r0 + g) * LDA + k0 + q];
  v[1] = t[(r0 + g + 8) * LDA + k0 + q];
  v[2] = t[(r0 + g) * LDA + k0 + q + 4];
  v[3] = t[(r0 + g + 8) * LDA + k0 + q + 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], ah[i], al[i]);
}

// One warp's share of a 32-wide k-slice of a block's C[64 × 64] += A · B:
// rows wm .. wm + 31 (two m-tiles) against all 64 columns (eight n-tiles)
// for the two k-steps 16·kw and 16·kw + 8, so each A value is split by one
// warp. NK: B is staged [n][LDA] (rows of x), else [k][LDB] (s | x). ROWSUM
// adds A's fp32 values of rows wm + 16·mt + g (+ 8) into rs[2·mt (+ 1)].
template <bool NK, bool ROWSUM>
__device__ __forceinline__ void warp_slice(const float* a, const float* b, int wm, int kw,
                                           int g, int q, float part[2][8][4], float rs[4]) {
#pragma unroll
  for (int k0 = 16 * kw; k0 < 16 * kw + 16; k0 += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float v[4];
      load_a(a, wm + 16 * mt, k0, g, q, ah[mt], al[mt], v);
      if (ROWSUM) {
        rs[2 * mt] += v[0];
        rs[2 * mt] += v[2];
        rs[2 * mt + 1] += v[1];
        rs[2 * mt + 1] += v[3];
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t bh[2], bl[2];
      const float* bp = NK ? b + (8 * nt + g) * LDA + k0 + q : b + (k0 + q) * LDB + 8 * nt + g;
      split(bp[0], bh[0], bl[0]);
      split(bp[NK ? 4 : 4 * LDB], bh[1], bl[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma3(part[mt][nt], ah[mt], al[mt], bh, bl);
    }
  }
}

// acc += part and part = 0, every second slice (the header says why)
__device__ __forceinline__ void flush(float acc[2][8][4], float part[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] += part[mt][nt][i];
        part[mt][nt][i] = 0.f;
      }
}

// The two k-halves' sums of a block meet: the kw = 1 warps leave theirs in
// red (shared memory, free after the main loop), the kw = 0 warps add them
// to their own, always in that order.
__device__ __forceinline__ void reduce_k(float acc[2][8][4], float* red, int wm, int kw,
                                         int lane) {
  float* mine = red + (wm / 32) * 64 * 32 + lane;
  if (kw == 1) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) mine[((mt * 8 + nt) * 4 + i) * 32] = acc[mt][nt][i];
  }
  __syncthreads();
  if (kw == 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += mine[((mt * 8 + nt) * 4 + i) * 32];
  }
}

// Kernel A: K for rows [r0, r0 + rows) and columns [c0, c0 + cols) of the
// centred x (rows of ld floats, zero from D on), one 64 × 64 tile a block,
// into kbuf [.][ldk]; zero outside those rows and columns.
__global__ void __launch_bounds__(NTH)
gram_kernel(const float* __restrict__ x, const float* __restrict__ hptr,
            float* __restrict__ kbuf, int ld, int r0, int rows, int c0, int cols, int ldk) {
  __shared__ __align__(16) float As[2][T * LDA];
  __shared__ __align__(16) float Bs[2][T * LDA];
  __shared__ float nrm[2 * T];   // |x|² of the tile's rows, then of its columns

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (w & 1) * 32, kw = w >> 1;
  const int tr = blockIdx.y * T, tc = blockIdx.x * T;
  const int nk = (ld + KS - 1) / KS;

  // a thread copies 16 bytes of rows tid/8 + 16·i of each tile, at column 4·(tid % 8)
  const int lr0 = tid >> 3, kq = (tid & 7) * 4;
  auto load = [&](int slice, int buf) {
    const int k0 = slice * KS;
    const bool kin = k0 + kq < ld;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool col = i >= 4;
      const int r = lr0 + 16 * (i & 3);
      const int local = (col ? tc : tr) + r;
      const bool valid = kin && local < (col ? cols : rows);
      const float* src = valid ? x + (size_t)((col ? c0 : r0) + local) * ld + k0 + kq : x;
      cp_async16((col ? Bs[buf] : As[buf]) + r * LDA + kq, src, valid);
    }
  };

  float acc[2][8][4] = {}, part[2][8][4] = {};
  float nsum = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int slice = 0; slice < nk; ++slice) {
    if (slice + 1 < nk) load(slice + 1, (slice + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* a = As[slice & 1];
    const float* b = Bs[slice & 1];
    {
      // thread t < 64 sums row t of the rows' tile, t >= 64 row t - 64 of
      // the columns' (rows 144 bytes apart: conflict-free 16-byte reads)
      const float* r = tid < T ? a + tid * LDA : b + (tid - T) * LDA;
#pragma unroll
      for (int k = 0; k < KS; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(r + k);
        nsum = fmaf(v.x, v.x, nsum);
        nsum = fmaf(v.y, v.y, nsum);
        nsum = fmaf(v.z, v.z, nsum);
        nsum = fmaf(v.w, v.w, nsum);
      }
    }
    warp_slice<true, false>(a, b, wm, kw, g, q, part, nullptr);
    if (slice & 1) flush(acc, part);
    __syncthreads();  // this buffer is refilled two slices on
  }
  flush(acc, part);
  nrm[tid] = nsum;
  reduce_k(acc, &As[0][0], wm, kw, lane);
  if (kw == 1) return;

  const float h = hptr[0];
  const float h2 = h * h;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = wm + 16 * mt + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int lc = 8 * nt + 2 * q;
        float kv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d2 =
              fmaxf(nrm[lr] + nrm[T + lc + e] - 2.f * acc[mt][nt][2 * half + e], 0.f);
          kv[e] = tr + lr < rows && tc + lc + e < cols ? expf(-0.5f * d2 / h2) : 0.f;
        }
        *reinterpret_cast<float2*>(kbuf + (size_t)(tr + lr) * ldk + tc + lc) =
            make_float2(kv[0], kv[1]);
      }
    }
}

// Kernel B: for rows [r0, r0 + rows) and the column chunk [c0, c0 + cols),
//   term = K·s - (K·x - r·x_i) / h²
// for φ's columns [32·blockIdx.x, +32). mode bit 1: the first column chunk
// (φ = term, else φ += term); bit 2: the last (then φ /= N).
__global__ void __launch_bounds__(NTH)
apply_kernel(const float* __restrict__ x, const float* __restrict__ s,
             const float* __restrict__ hptr, const float* __restrict__ kbuf,
             float* __restrict__ phi, int N, int D, int ld, int r0, int rows, int c0,
             int cols, int ldk, int mode) {
  __shared__ __align__(16) float Ks[2][T * LDA];
  __shared__ __align__(16) float Vs[2][KS * LDB];   // [j][s slice | x slice]
  __shared__ float rsum[T];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (w & 1) * 32, kw = w >> 1;
  const int tr = blockIdx.y * T, d0 = blockIdx.x * DS;
  const int nj = (cols + KS - 1) / KS;

  // K: 16 bytes of rows tid/8 + 16·i at column 4·(tid % 8); s | x: 16 bytes
  // of rows tid/16 + 8·i, of s for tid % 16 < 8, else of x
  const int kr0 = tid >> 3, kq = (tid & 7) * 4;
  const int vr0 = tid >> 4, vq = (tid & 7) * 4;
  const bool vx = (tid & 15) >= 8, din = d0 + vq < ld;
  const float* vsrc = (vx ? x : s) + d0 + vq;
  auto load = [&](int slice, int buf) {
    const int j0 = slice * KS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = kr0 + 16 * i;
      cp_async16(Ks[buf] + r * LDA + kq, kbuf + (size_t)(tr + r) * ldk + j0 + kq, true);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = vr0 + 8 * i;
      const bool valid = din && j0 + r < cols;
      cp_async16(Vs[buf] + r * LDB + (vx ? DS : 0) + vq,
                 valid ? vsrc + (size_t)(c0 + j0 + r) * ld : s, valid);
    }
  };

  // n-tiles 0-3: K·s, 4-7: K·x, at the same (row, column)
  float acc[2][8][4] = {}, part[2][8][4] = {};
  float rs[4] = {0.f, 0.f, 0.f, 0.f};   // r of rows wm + 16·mt + g (+ 8), this k-half

  load(0, 0);
  cp_async_commit();
  for (int slice = 0; slice < nj; ++slice) {
    if (slice + 1 < nj) load(slice + 1, (slice + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    warp_slice<false, true>(Ks[slice & 1], Vs[slice & 1], wm, kw, g, q, part, rs);
    if (slice & 1) flush(acc, part);
    __syncthreads();
  }
  flush(acc, part);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
  }
  if (kw == 1 && q == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) rsum[wm + 16 * (i >> 1) + g + 8 * (i & 1)] = rs[i];
  }
  reduce_k(acc, &Ks[0][0], wm, kw, lane);
  if (kw == 1) return;

  const float h = hptr[0];
  const float h2 = h * h;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = tr + wm + 16 * mt + g + 8 * half;
      if (lr >= rows) continue;
      const float r = rs[2 * mt + half] + rsum[lr - tr];
      const size_t i = (size_t)(r0 + lr);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = d0 + 8 * nt + 2 * q + e;
          if (d >= D) continue;
          const float ks = acc[mt][nt][2 * half + e], kx = acc[mt][nt + 4][2 * half + e];
          const float term = ks - (kx - r * x[i * ld + d]) / h2;
          float* p = phi + i * D + d;
          float val = mode & 1 ? term : *p + term;
          if (mode & 2) val = val / (float)N;
          *p = val;
        }
    }
}

}  // namespace

extern "C" {

// x [N, ld] centred, zero in columns D..ld-1 (ld a multiple of 4); s [N, ld]
// likewise; phi [N, D]; h [1]; kbuf at least round64(R) × round64(Cc)
// floats; all fp32, contiguous, 16-byte aligned, on the stream's device.
// Row chunks of R rows, column chunks of Cc columns, in order. Returns the
// first launch error, else 0.
int svgd_velocity(const float* x, const float* s, const float* h, float* phi, float* kbuf,
                  int N, int D, int ld, int R, int Cc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || D < 1 || ld < D || ld % 4 || R < 1 || Cc < 1)
    return (int)cudaErrorInvalidValue;
  const int ldk = (Cc + T - 1) / T * T;
  for (int r0 = 0; r0 < N; r0 += R) {
    const int rows = R < N - r0 ? R : N - r0;
    for (int c0 = 0; c0 < N; c0 += Cc) {
      const int cols = Cc < N - c0 ? Cc : N - c0;
      const dim3 ga((cols + T - 1) / T, (rows + T - 1) / T);
      gram_kernel<<<ga, NTH, 0, st>>>(x, h, kbuf, ld, r0, rows, c0, cols, ldk);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const int mode = (c0 == 0 ? 1 : 0) | (c0 + Cc >= N ? 2 : 0);
      const dim3 gb((D + DS - 1) / DS, (rows + T - 1) / T);
      apply_kernel<<<gb, NTH, 0, st>>>(x, s, h, kbuf, phi, N, D, ld, r0, rows, c0, cols, ldk,
                                       mode);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // extern "C"
