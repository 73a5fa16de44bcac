// λ=0 pair-list signature kernel with the RBF statics computed in the
// kernels: K7 (forward, with or without the residual; fp32 backward).
//
// Replaces the TPU kernels sigsvgd_tpu/kernels/pallas_sigkernel_small.py::
// _small_fwd_kernel and ::_small_bwd_kernel. Contract, as
// pallas_pair_gram_small there: for pair p, paths xt[:, :, p] [Lx, C] and
// yt[:, :, p] [Ly, C], already scaled by rsqrt(h), k[p] is the order-0
// Goursat-PDE signature kernel with static kernel
// exp(-max(|x|^2 + |y|^2 - 2<x, y>, 0)) on the (Lx-1) × (Ly-1) grid; with
// residuals the forward also writes fac[i][j] = ∂k[i+1][j+1]/∂z; the
// backward gives the gradients of Σ_p gout[p]·k[p] with respect to both
// tiles. All arrays are pair-minor ([L][C][P], [lx1][ly1][P]) so a warp's
// accesses coalesce.
//
// What bounds it on an H100. A pair's grid is only lx1·ly1 cells (1,521 at
// 40-node paths), ~14 operations each plus ~(2C+4) per static node: about
// 3.4e4 operations a pair forward, against 4·lx1·ly1 = 6 KB of fac written
// with residuals and 4·lx1·ly1 + 8·(Lx+Ly)·C bytes moved by the backward.
// Values only, the operations bound it (0.5 ms for 2^20 pairs at 67
// TFLOP/s); with the residual, and in the backward, the bytes (6.4 GB of
// fac at 2^20 pairs, 1.9 ms at 3.35 TB/s). The design:
//   * one thread per pair, persistent blocks of 64 threads (as many as are
//     resident), the pair's paths read from the pair-minor tiles (a pair
//     list shares no path between threads) and each static node formed on
//     the fly from its y point;
//   * a λ=0 row is at most 63 cells wide, so the K node row and the static
//     row live on chip, in the thread's slots of pair-minor shared memory
//     ([Ly][64]: consecutive threads on consecutive banks), at most 32 KB a
//     block. Registers were tried first (loops unrolled to a template bound
//     on Ly): 255 registers with spills at Ly = 64 and a 143 s build. The
//     static row is updated in place as the sweep passes each column, so
//     one array serves both rows;
//   * the forward writes fac pair-minor, one coalesced store per cell;
//   * the backward sweeps each adjoint row once right to left: it completes
//     λ[i+1] in place while it forms row i's partial λ, takes
//     dz = λ[i+1][j+1]·fac (no primal reconstruction) and pulls it back
//     through the statics at once, split by rows as K1 splits it
//     (D[q] = dz[q-1] - dz[q]: w_hi = D·g[i+1][q] to row i+1,
//     w_lo = -D·g[i][q] to row i), so no dg row is carried. The row-path
//     gradient stays in registers; the column path's, Ly·C floats a pair,
//     accumulates in a per-thread shared-memory slot written out once per
//     pair (with the adjoint and static rows, (2 + C)·Ly floats a thread:
//     up to 160 KB a block at Ly = 64, C = 8). No atomics.
// The statics and the forward sweep round every product and sum on its own
// in the twin's order (no FMA contraction), so k and fac agree with the
// fp32 twin to a few ulp; the backward keeps FMA.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 64;
constexpr float I6 = 1.0f / 6.0f;
constexpr float I12 = 1.0f / 12.0f;

// Path point q of a pair-minor tile t [L][C][P] and its squared norm.
template <int C>
__device__ __forceinline__ float load_pt(const float* __restrict__ t, int q, size_t P,
                                         size_t p, float (&v)[C]) {
  float n = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[c] = t[((size_t)q * C + c) * P + p];
    n = c == 0 ? __fmul_rn(v[c], v[c]) : __fadd_rn(n, __fmul_rn(v[c], v[c]));
  }
  return n;
}

// Static node exp(-max((|x|^2 + |y|^2) - 2<x, y>, 0)) of path point x
// (squared norm xn) against y point q, which is returned in yq.
template <int C>
__device__ __forceinline__ float gnode(const float (&x)[C], float xn,
                                       const float* __restrict__ yt, int q, size_t P,
                                       size_t p, float (&yq)[C]) {
  const float yn = load_pt<C>(yt, q, P, p, yq);
  float cross = __fmul_rn(x[0], yq[0]);
#pragma unroll
  for (int c = 1; c < C; ++c) cross = __fadd_rn(cross, __fmul_rn(x[c], yq[c]));
  const float d2 = __fsub_rn(__fadd_rn(xn, yn), __fmul_rn(2.f, cross));
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

// ---- forward ----------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(NT)
small_fwd_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                 float* __restrict__ kout, float* __restrict__ fac, int P_, int Lx,
                 int Ly) {
  extern __shared__ float sm[];
  float* krow = sm + threadIdx.x;  // [Ly][NT] K node row
  float* g = krow + Ly * NT;       // [Ly][NT] static row
  const size_t P = P_;
  const size_t T = (size_t)gridDim.x * NT;
  const int lx1 = Lx - 1, ly1 = Ly - 1;
  for (size_t p = (size_t)blockIdx.x * NT + threadIdx.x; p < P; p += T) {
    float x[C], yq[C];
    float xn = load_pt<C>(xt, 0, P, p, x);
    for (int q = 0; q < Ly; ++q) {
      krow[q * NT] = 1.f;
      g[q * NT] = gnode<C>(x, xn, yt, q, P, p, yq);
    }
    float kl = 1.f;
    for (int i = 0; i < lx1; ++i) {
      xn = load_pt<C>(xt, i + 1, P, p, x);
      // g holds static row i at columns > j and row i+1 at columns <= j
      float gu0 = gnode<C>(x, xn, yt, 0, P, p, yq);
      float gl0 = g[0];
      float prev = 1.f;  // k[i][0]
      kl = 1.f;          // k[i+1][0]
      float* fr = fac ? fac + (size_t)i * ly1 * P + p : nullptr;
      for (int j = 0; j < ly1; ++j) {
        const float gu1 = gnode<C>(x, xn, yt, j + 1, P, p, yq);
        const float gl1 = g[(j + 1) * NT];
        const Coef k = coef(gu1, gu0, gl1, gl0);
        const float old = krow[(j + 1) * NT];
        const float s = __fadd_rn(kl, old);
        const float kn = __fsub_rn(__fmul_rn(s, k.A), __fmul_rn(prev, k.B));
        if (fr) fr[(size_t)j * P] = s * (0.5f + k.z * I6) + prev * (k.z * I6);
        krow[(j + 1) * NT] = kn;
        g[j * NT] = gu0;
        prev = old;
        kl = kn;
        gu0 = gu1;
        gl0 = gl1;
      }
      g[ly1 * NT] = gu0;
    }
    kout[p] = kl;
  }
}

// ---- backward ---------------------------------------------------------------
// Pull-back of one dg pair at node q: row i+1 (point xh) gets w_hi = D·gh,
// row i (point xl) gets w_lo = -D·gl; dyq[c·NT] accumulates the column
// path's gradient of node q.
template <int C>
__device__ __forceinline__ void pull_back(float D, float gh, float gl, const float (&yv)[C],
                                          const float (&xh)[C], const float (&xl)[C],
                                          float* dyq, float (&sxh)[C], float (&sxl)[C],
                                          float& swh, float& swl) {
  const float wh = D * gh;
  const float wl = -D * gl;
  swh += wh;
  swl += wl;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sxh[c] = fmaf(wh, yv[c], sxh[c]);
    sxl[c] = fmaf(wl, yv[c], sxl[c]);
    dyq[c * NT] -= 2.f * (wh * (yv[c] - xh[c]) + wl * (yv[c] - xl[c]));
  }
}

template <int C>
__global__ void __launch_bounds__(NT)
small_bwd_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                 const float* __restrict__ fac, const float* __restrict__ gout,
                 float* __restrict__ dxt, float* __restrict__ dyt, int P_, int Lx, int Ly) {
  extern __shared__ float sm[];
  float* lam = sm + threadIdx.x;  // [Ly][NT] adjoint row
  float* g = lam + Ly * NT;       // [Ly][NT] static row
  float* dy = g + Ly * NT;        // [Ly][C][NT] column-path gradient
  const size_t P = P_;
  const size_t T = (size_t)gridDim.x * NT;
  const int lx1 = Lx - 1, ly1 = Ly - 1;
  for (size_t p = (size_t)blockIdx.x * NT + threadIdx.x; p < P; p += T) {
    for (int k = 0; k < Ly * C; ++k) dy[k * NT] = 0.f;
    float xh[C], xl[C], yq[C], yr[C], carry[C];
    const float xnh = load_pt<C>(xt, lx1, P, p, xh);
    const float seed = gout[p];
    for (int q = 0; q < Ly; ++q) {
      g[q * NT] = gnode<C>(xh, xnh, yt, q, P, p, yq);
      lam[q * NT] = q == ly1 ? seed : 0.f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) carry[c] = 0.f;

    for (int i = lx1 - 1; i >= 0; --i) {
      // on entry g holds static row i+1 and lam the partial adjoint of node
      // row i+1 (complete at column ly1); the sweep leaves g at row i and lam
      // at the partial adjoint of row i
      const float xnl = load_pt<C>(xt, i, P, p, xl);
      const float* fr = fac + (size_t)i * ly1 * P + p;
      float sxh[C], sxl[C];
#pragma unroll
      for (int c = 0; c < C; ++c) sxh[c] = sxl[c] = 0.f;
      float swh = 0.f, swl = 0.f, pending = 0.f, dzr = 0.f;
      float R = lam[ly1 * NT];                           // λ[i+1][ly1]: complete
      float ghr = g[ly1 * NT];                           // g[i+1][j+1]
      float glr = gnode<C>(xl, xnl, yt, ly1, P, p, yr);  // g[i][j+1]
      for (int j = ly1 - 1; j >= 0; --j) {
        const float gl0 = gnode<C>(xl, xnl, yt, j, P, p, yq);
        const float gh0 = g[j * NT];
        const Coef k = coef(ghr, gh0, glr, gl0);
        const float t = R * k.A;
        const float Rn = lam[j * NT] + t;  // completes λ[i+1][j]
        lam[(j + 1) * NT] = pending + t;   // λ[i][j+1], partial
        pending = -R * k.B;
        const float dz = R * fr[(size_t)j * P];
        pull_back<C>(dz - dzr, ghr, glr, yr, xh, xl, dy + (j + 1) * C * NT, sxh, sxl, swh,
                     swl);
        g[(j + 1) * NT] = glr;
        ghr = gh0;
        glr = gl0;
        dzr = dz;
        R = Rn;
#pragma unroll
        for (int c = 0; c < C; ++c) yr[c] = yq[c];
      }
      lam[0] = pending;
      pull_back<C>(-dzr, ghr, glr, yr, xh, xl, dy, sxh, sxl, swh, swl);
      g[0] = glr;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dxt[((size_t)(i + 1) * C + c) * P + p] = carry[c] + 2.f * (sxh[c] - xh[c] * swh);
        carry[c] = 2.f * (sxl[c] - xl[c] * swl);
        xh[c] = xl[c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) dxt[(size_t)c * P + p] = carry[c];
    for (int k = 0; k < Ly * C; ++k) dyt[(size_t)k * P + p] = dy[k * NT];
  }
}

// Shared memory of a block: the K and static rows (forward); the adjoint and
// static rows and the column-path gradient (backward).
size_t smem_bytes(int Ly, int C, int bwd) {
  return sizeof(float) * (size_t)(bwd ? 2 + C : 2) * Ly * NT;
}

template <typename K>
cudaError_t resident_blocks(K kernel, size_t smem, int P, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int need = (P + NT - 1) / NT;
  *blocks = min(per_sm * sms, need > 0 ? need : 1);
  return cudaSuccess;
}

template <int C>
cudaError_t grid(int Ly, int bwd, int P, int* blocks) {
  if (bwd) return resident_blocks(small_bwd_kernel<C>, smem_bytes(Ly, C, 1), P, blocks);
  return resident_blocks(small_fwd_kernel<C>, smem_bytes(Ly, C, 0), P, blocks);
}

template <int C>
cudaError_t fwd(const float* xt, const float* yt, float* k, float* fac, int blocks, int P,
                int Lx, int Ly, cudaStream_t st) {
  const size_t smem = smem_bytes(Ly, C, 0);
  cudaError_t err = cudaFuncSetAttribute(
      small_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  small_fwd_kernel<C><<<blocks, NT, smem, st>>>(xt, yt, k, fac, P, Lx, Ly);
  return cudaGetLastError();
}

template <int C>
cudaError_t bwd(const float* xt, const float* yt, const float* fac, const float* gout,
                float* dxt, float* dyt, int blocks, int P, int Lx, int Ly, cudaStream_t st) {
  const size_t smem = smem_bytes(Ly, C, 1);
  cudaError_t err = cudaFuncSetAttribute(
      small_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  small_bwd_kernel<C><<<blocks, NT, smem, st>>>(xt, yt, fac, gout, dxt, dyt, P, Lx, Ly);
  return cudaGetLastError();
}

// The instantiation for C = 1..8, called as CALL(c); Ly ≤ 64 is checked here.
#define SMALL_DISPATCH(CALL)                                  \
  if (Ly < 2 || Ly > 64) return (int)cudaErrorInvalidValue;   \
  switch (C) {                                                \
    case 1: return (int)CALL(1);                              \
    case 2: return (int)CALL(2);                              \
    case 3: return (int)CALL(3);                              \
    case 4: return (int)CALL(4);                              \
    case 5: return (int)CALL(5);                              \
    case 6: return (int)CALL(6);                              \
    case 7: return (int)CALL(7);                              \
    case 8: return (int)CALL(8);                              \
    default: return (int)cudaErrorInvalidValue;               \
  }

}  // namespace

extern "C" {

// Persistent blocks of a launch (bwd = 1: the backward), at most one per 64
// pairs.
int sigkernel_small_grid(int Ly, int C, int bwd, int P, int* blocks) {
#define CALL(c) grid<c>(Ly, bwd, P, blocks)
  SMALL_DISPATCH(CALL)
#undef CALL
}

// xt [Lx, C, P], yt [Ly, C, P] scaled path tiles; k [P]; fac [Lx-1, Ly-1, P]
// or null (values only). fp32, contiguous, on the stream's device.
// Returns cudaGetLastError().
int sigkernel_small_fwd(const float* xt, const float* yt, float* k, float* fac, int blocks,
                        int P, int Lx, int Ly, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(c) fwd<c>(xt, yt, k, fac, blocks, P, Lx, Ly, st)
  SMALL_DISPATCH(CALL)
#undef CALL
}

// xt, yt as the forward, fac its residual, gout [P]; writes dxt [Lx, C, P],
// dyt [Ly, C, P], the gradients of Σ gout·k.
int sigkernel_small_bwd(const float* xt, const float* yt, const float* fac, const float* gout,
                        float* dxt, float* dyt, int blocks, int P, int Lx, int Ly, int C,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(c) bwd<c>(xt, yt, fac, gout, dxt, dyt, blocks, P, Lx, Ly, st)
  SMALL_DISPATCH(CALL)
#undef CALL
}

}  // extern "C"
