// λ=0 symmetric signature-kernel Gram + full-sum pull-back gradient (K1),
// and the values-only Gram (K3).
//
// K1 replaces the TPU kernel sigsvgd_tpu/kernels/pallas_sigkernel_block.py::
// _block_kernel (launched by _block_call); K3 replaces ::_block_values_kernel
// (launched by block_gram), K1's forward without checkpoints or adjoint.
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
// value counted once; this kernel recomputes static rows and z, A, B, so it
// executes more), so the operation count over the fp32 CUDA-core rate is
// ~500x the byte count over the memory rate. The design keeps every
// per-pair quantity on chip or in
// thread-private memory and moves only paths, K and gradient partials:
//   * one thread per pair; a block holds an 8-row × 16-column particle tile
//     and stages its 24 paths (pre-scaled by √(2/h)) in shared memory;
//   * the static Gram is formed on the fly, one node row at a time, in the
//     TPU kernel's expand form exp(x'·y' - ½|x'|² - ½|y'|²); no [pairs, L, L]
//     tensor reaches device memory;
//   * the K node row and the two static-Gram rows live in registers (loops
//     over j unrolled to the template bound LMAX, guarded by the run-time L);
//   * the forward stores the per-cell adjoint factor
//     fac = (k[i+1][j] + k[i][j+1])·(½ + z/6) + k[i][j]·z/6 in
//     thread-local memory, so the adjoint needs neither band
//     rematerialisation nor primal reconstruction;
//   * the adjoint sweeps λ rows top-down (right-to-left chain, then
//     dz = λ·fac·seed) and pulls dz back through the static Gram with the
//     row difference D[i][q] = dz[i][q-1] - dz[i][q], so no dg row is carried;
//   * gradients reduce deterministically: per-thread slots in shared memory,
//     a fixed-order sum per block into per-tile partials, and a second small
//     kernel that sums the partials of each particle in tile order.
// K3 is the same staging and the same forward sweep (one device function,
// so its K equals K1's bit for bit) with nothing stored for an adjoint: its
// operations bound it (~1.5e10 at [1024, 40, 2], 0.2 ms at 67 TFLOP/s).
// Speed work (warp-level row pipelining, register blocking) comes later.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TR = 8;   // row particles per block
constexpr int TC = 16;  // column particles per block
constexpr int NT = TR * TC;
constexpr float I6 = 1.0f / 6.0f;
constexpr float I12 = 1.0f / 12.0f;

// Static-Gram row g[q] = exp(x'_p·y'_q - ½|x'_p|² - ½|y'_q|²), q < L.
// Here and in the forward sweep every product and sum is rounded on its own
// (no FMA contraction), in the plain twin's order: fp32 rounding alone moves
// K by about the 3e-5 tolerance at the flagship shape (chip_smoke.py reports
// both against the twin in fp64), so K agrees with the twin to atol 3e-5
// only if both round the same operations the same way.
// The adjoint keeps FMA: dX is compared at a scaled 5e-5.
template <int LMAX, int C>
__device__ __forceinline__ void g_row(const float* xs, const float* ys,
                                      const float* ynh, int p, int r, int cl,
                                      int L, float (&g)[LMAX]) {
  float xv[C];
  float xn = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    xv[c] = xs[(p * C + c) * TR + r];
    xn = __fadd_rn(xn, __fmul_rn(xv[c], xv[c]));
  }
  const float xnh = -0.5f * xn;
#pragma unroll
  for (int q = 0; q < LMAX; ++q) {
    if (q < L) {
      float cross = __fmul_rn(xv[0], ys[(q * C) * TC + cl]);
#pragma unroll
      for (int c = 1; c < C; ++c)
        cross = __fadd_rn(cross, __fmul_rn(xv[c], ys[(q * C + c) * TC + cl]));
      g[q] = expf(__fadd_rn(cross, __fadd_rn(ynh[q * TC + cl], xnh)));
    }
  }
}

// Pull-back of one adjoint row difference D at node column q: row i+1 gets
// w_hi = D·g[i+1][q], row i gets w_lo = -D·g[i][q].
template <int C>
__device__ __forceinline__ void pull_back(float D, float gh, float gl,
                                          const float* ys, float* dyc, int q,
                                          int cl, int tid, const float (&xh)[C],
                                          const float (&xl)[C], float (&sxh)[C],
                                          float (&sxl)[C], float& swh, float& swl) {
  const float wh = D * gh;
  const float wl = -D * gl;
  swh += wh;
  swl += wl;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float yv = ys[(q * C + c) * TC + cl];
    sxh[c] = fmaf(wh, yv, sxh[c]);
    sxl[c] = fmaf(wl, yv, sxl[c]);
    float* d = dyc + (q * C + c) * NT + tid;
    *d += (wh * xh[c] + wl * xl[c]) - (wh + wl) * yv;
  }
}

// Stage the tile's pre-scaled row paths xs [L][C][TR], column paths
// ys [L][C][TC] and -½|y'_q|² ynh [L][TC] in shared memory.
template <int C>
__device__ __forceinline__ void stage_paths(const float* __restrict__ X, float scale,
                                            float* xs, float* ys, float* ynh, int I,
                                            int J, int n, int L, int tid) {
  const int LC = L * C;
  for (int e = tid; e < LC * TR; e += NT) {
    const int rr = e / LC, k = e % LC;
    const int a = I * TR + rr;
    xs[k * TR + rr] = a < n ? X[(size_t)a * LC + k] * scale : 0.f;
  }
  for (int e = tid; e < LC * TC; e += NT) {
    const int cc = e / LC, k = e % LC;
    const int b = J * TC + cc;
    ys[k * TC + cc] = b < n ? X[(size_t)b * LC + k] * scale : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < L * TC; e += NT) {
    const int q = e / TC, cc = e % TC;
    float s = 0.f;
    for (int c = 0; c < C; ++c) {
      const float v = ys[(q * C + c) * TC + cc];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    ynh[e] = -0.5f * s;
  }
  __syncthreads();
}

// The forward sweep of one pair: K node rows bottom-up. Returns
// k[L-1][L-1]; leaves static row L-1 in gdn; with FAC stores the per-cell
// adjoint factors in fac [(LMAX-1)²].
template <int LMAX, int C, bool FAC>
__device__ __forceinline__ float forward_sweep(const float* xs, const float* ys,
                                               const float* ynh, int r, int cl, int L,
                                               float (&gdn)[LMAX], float* fac) {
  float gup[LMAX], krow[LMAX];
  float kl = 1.f;
#pragma unroll
  for (int q = 0; q < LMAX; ++q) krow[q] = 1.f;
  g_row<LMAX, C>(xs, ys, ynh, 0, r, cl, L, gdn);
  for (int i = 0; i < L - 1; ++i) {
    g_row<LMAX, C>(xs, ys, ynh, i + 1, r, cl, L, gup);
    float* fr = fac + i * (LMAX - 1);
    float prev = krow[0];
    kl = 1.f;
#pragma unroll
    for (int j = 0; j < LMAX - 1; ++j) {
      if (j < L - 1) {
        const float z = ((gup[j + 1] - gup[j]) - gdn[j + 1]) + gdn[j];
        const float A = __fadd_rn(1.f, __fmul_rn(z, __fadd_rn(0.5f, __fmul_rn(z, I12))));
        const float B = __fsub_rn(1.f, __fmul_rn(__fmul_rn(z, z), I12));
        const float old = krow[j + 1];
        const float s = kl + old;
        const float kn = __fsub_rn(__fmul_rn(s, A), __fmul_rn(prev, B));
        if constexpr (FAC) fr[j] = s * (0.5f + z * I6) + prev * (z * I6);
        krow[j + 1] = kn;
        prev = old;
        kl = kn;
      }
    }
#pragma unroll
    for (int q = 0; q < LMAX; ++q) gdn[q] = gup[q];
  }
  return kl;
}

// ---- K3: values only --------------------------------------------------------
template <int LMAX, int C>
__global__ void __launch_bounds__(NT)
block_values_kernel(const float* __restrict__ X, const float* __restrict__ hptr,
                    float* __restrict__ K, int n, int L) {
  const int J = blockIdx.x, I = blockIdx.y;
  if (I * TR > J * TC + TC - 1) return;
  extern __shared__ float smem[];
  const int LC = L * C;
  float* xs = smem;
  float* ys = xs + LC * TR;
  float* ynh = ys + LC * TC;
  const int tid = threadIdx.x;
  const int r = tid / TC, cl = tid % TC;
  stage_paths<C>(X, sqrtf(2.0f / hptr[0]), xs, ys, ynh, I, J, n, L, tid);
  const int a = I * TR + r, b = J * TC + cl;
  if (a < n && b < n && a <= b) {
    float gdn[LMAX];
    const float kl = forward_sweep<LMAX, C, false>(xs, ys, ynh, r, cl, L, gdn, nullptr);
    K[(size_t)a * n + b] = kl;
    K[(size_t)b * n + a] = kl;
  }
}

// ---- K1: values and adjoint -------------------------------------------------
template <int LMAX, int C>
__global__ void __launch_bounds__(NT)
block_gram_grad_kernel(const float* __restrict__ X, const float* __restrict__ hptr,
                       float* __restrict__ K, float* __restrict__ rowpart,
                       float* __restrict__ colpart, int n, int L) {
  const int J = blockIdx.x, I = blockIdx.y;
  // a tile holding no pair a <= b has nothing to do
  if (I * TR > J * TC + TC - 1) return;

  extern __shared__ float smem[];
  const int LC = L * C;
  float* xs = smem;              // [L][C][TR] pre-scaled row paths
  float* ys = xs + LC * TR;      // [L][C][TC] pre-scaled column paths
  float* ynh = ys + LC * TC;     // [L][TC]    -½|y'_q|²
  float* dxr = ynh + L * TC;     // [L·C][NT]  per-thread row-path gradient
  float* dyc = dxr + LC * NT;    // [L·C][NT]  per-thread column-path gradient

  const int tid = threadIdx.x;
  const int r = tid / TC, cl = tid % TC;
  for (int k = 0; k < LC; ++k) {
    dxr[k * NT + tid] = 0.f;
    dyc[k * NT + tid] = 0.f;
  }
  stage_paths<C>(X, sqrtf(2.0f / hptr[0]), xs, ys, ynh, I, J, n, L, tid);

  const int a = I * TR + r, b = J * TC + cl;
  if (a < n && b < n && a <= b) {
    float fac[(LMAX - 1) * (LMAX - 1)];  // thread-local adjoint factors
    float gup[LMAX], gdn[LMAX];
    const float kl = forward_sweep<LMAX, C, true>(xs, ys, ynh, r, cl, L, gdn, fac);
    K[(size_t)a * n + b] = kl;
    K[(size_t)b * n + a] = kl;

    // ---- adjoint: λ rows top-down, pull-back through the static Gram ----
    // gdn holds static-Gram row L-1; it becomes the upper row.
    float lam[LMAX];
#pragma unroll
    for (int q = 0; q < LMAX; ++q) {
      gup[q] = gdn[q];
      lam[q] = (q == L - 1) ? 1.f : 0.f;
    }
    const float sd = (a == b) ? 1.f : 2.f;
    float carry[C];
#pragma unroll
    for (int c = 0; c < C; ++c) carry[c] = 0.f;

    for (int i = L - 2; i >= 0; --i) {
      g_row<LMAX, C>(xs, ys, ynh, i, r, cl, L, gdn);
      const float* fr = fac + i * (LMAX - 1);
      // complete λ row i+1 right-to-left: λ[j] += A[i][j]·λ[j+1]
#pragma unroll
      for (int j = LMAX - 2; j >= 0; --j) {
        if (j < L - 1) {
          const float z = ((gup[j + 1] - gup[j]) - gdn[j + 1]) + gdn[j];
          const float A = 1.f + z * (0.5f + z * I12);
          lam[j] = lam[j] + lam[j + 1] * A;
        }
      }
      float xh[C], xl[C], sxh[C], sxl[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        xh[c] = xs[((i + 1) * C + c) * TR + r];
        xl[c] = xs[(i * C + c) * TR + r];
        sxh[c] = 0.f;
        sxl[c] = 0.f;
      }
      float swh = 0.f, swl = 0.f, pending = 0.f, dzprev = 0.f;
#pragma unroll
      for (int j = 0; j < LMAX - 1; ++j) {
        if (j < L - 1) {
          const float z = ((gup[j + 1] - gup[j]) - gdn[j + 1]) + gdn[j];
          const float A = 1.f + z * (0.5f + z * I12);
          const float B = 1.f - z * z * I12;
          const float t = lam[j + 1];  // complete λ[i+1][j+1]
          const float dz = t * fr[j] * sd;
          lam[j] = pending - t * B;    // partial λ[i][j]
          pending = t * A;
          pull_back<C>(dzprev - dz, gup[j], gdn[j], ys, dyc, j, cl, tid, xh, xl,
                       sxh, sxl, swh, swl);
          dzprev = dz;
          if (j == L - 2) {
            lam[j + 1] = pending;
            pull_back<C>(dz, gup[j + 1], gdn[j + 1], ys, dyc, j + 1, cl, tid, xh,
                         xl, sxh, sxl, swh, swl);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dxr[((i + 1) * C + c) * NT + tid] = carry[c] + sxh[c] - xh[c] * swh;
        carry[c] = sxl[c] - xl[c] * swl;
      }
#pragma unroll
      for (int q = 0; q < LMAX; ++q) gup[q] = gdn[q];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) dxr[c * NT + tid] = carry[c];
  }
  __syncthreads();

  // ---- per-tile partials, summed over the tile in a fixed order ----------
  for (int e = tid; e < TR * LC; e += NT) {
    const int rr = e / LC, k = e % LC;
    const int aa = I * TR + rr;
    if (aa < n) {
      float s = 0.f;
      for (int cc = 0; cc < TC; ++cc) s += dxr[k * NT + rr * TC + cc];
      rowpart[((size_t)J * n + aa) * LC + k] = s;
    }
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

// dX[a] = ½·√(2/h)·(Σ row partials of a + Σ column partials of a), summed
// over the active tiles in tile order (deterministic).
__global__ void reduce_partials_kernel(const float* __restrict__ rowpart,
                                       const float* __restrict__ colpart,
                                       const float* __restrict__ hptr,
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
  dX[idx] = 0.5f * sqrtf(2.0f / hptr[0]) * s;
}

template <int LMAX, int C>
cudaError_t launch(const float* X, const float* h, float* K, float* rowpart,
                   float* colpart, int n, int L, cudaStream_t stream) {
  const int LC = L * C;
  const size_t smem = sizeof(float) * (size_t)(LC * (TR + TC) + L * TC + 2 * LC * NT);
  cudaError_t err = cudaFuncSetAttribute(block_gram_grad_kernel<LMAX, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TC - 1) / TC, (n + TR - 1) / TR);
  block_gram_grad_kernel<LMAX, C><<<grid, NT, smem, stream>>>(X, h, K, rowpart,
                                                              colpart, n, L);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch_l(const float* X, const float* h, float* K, float* rowpart,
                       float* colpart, int n, int L, cudaStream_t stream) {
  if (L <= 16) return launch<16, C>(X, h, K, rowpart, colpart, n, L, stream);
  if (L <= 40) return launch<40, C>(X, h, K, rowpart, colpart, n, L, stream);
  if (L <= 64) return launch<64, C>(X, h, K, rowpart, colpart, n, L, stream);
  return cudaErrorInvalidValue;
}

template <int LMAX, int C>
cudaError_t launch_values(const float* X, const float* h, float* K, int n, int L,
                          cudaStream_t stream) {
  const int LC = L * C;
  const size_t smem = sizeof(float) * (size_t)(LC * (TR + TC) + L * TC);
  const dim3 grid((n + TC - 1) / TC, (n + TR - 1) / TR);
  block_values_kernel<LMAX, C><<<grid, NT, smem, stream>>>(X, h, K, n, L);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch_values(const float* X, const float* h, float* K, int n, int L,
                            cudaStream_t stream) {
  if (L <= 16) return launch_values<16, C>(X, h, K, n, L, stream);
  if (L <= 40) return launch_values<40, C>(X, h, K, n, L, stream);
  if (L <= 64) return launch_values<64, C>(X, h, K, n, L, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shape envelope of the kernel (checked again by the Python wrapper).
int sigkernel_block_max_l() { return 64; }
int sigkernel_block_max_c() { return 3; }
int sigkernel_block_tile_rows() { return TR; }
int sigkernel_block_tile_cols() { return TC; }

// X [n, L, C], h [1], K [n, n], dX [n, L, C], rowpart [ceil(n/TC), n, L·C],
// colpart [ceil(n/TR), n, L·C]; all fp32, contiguous, on the stream's device.
// Returns cudaGetLastError() after both launches (0 on success).
int sigkernel_block_gram_grad(const float* X, const float* h, float* K, float* dX,
                              float* rowpart, float* colpart, int n, int L, int C,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 1: err = dispatch_l<1>(X, h, K, rowpart, colpart, n, L, s); break;
    case 2: err = dispatch_l<2>(X, h, K, rowpart, colpart, n, L, s); break;
    case 3: err = dispatch_l<3>(X, h, K, rowpart, colpart, n, L, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int LC = L * C;
  const int total = n * LC;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      rowpart, colpart, h, dX, n, LC, (n + TR - 1) / TR, (n + TC - 1) / TC);
  return (int)cudaGetLastError();
}

// K3: X [n, L, C], h [1], K [n, n]; fp32, contiguous, on the stream's
// device. Returns cudaGetLastError() after the launch (0 on success).
int sigkernel_block_gram(const float* X, const float* h, float* K, int n, int L, int C,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)dispatch_values<1>(X, h, K, n, L, s);
    case 2: return (int)dispatch_values<2>(X, h, K, n, L, s);
    case 3: return (int)dispatch_values<3>(X, h, K, n, L, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
