// Fused RBF Stein velocity (K9).
//
// Replaces the TPU kernel sigsvgd_tpu/kernels/pallas_svgd.py::_velocity_kernel
// (launched by fused_rbf_velocity_pallas). For particles x [N, D] (centred
// by the caller), scores s [N, D] fp32 and a bandwidth h it computes
//   φ_i = (Σ_j K_ij s_j - (Σ_j K_ij x_j - (Σ_j K_ij) x_i) / h²) / N,
//   K_ij = exp(-½·max(d²_ij, 0) / h²),
// with the pair distances, the Gram and the three contractions in this
// kernel's body; no [N, N] array reaches device memory.
//
// What bounds it on an H100: arithmetic. Three products of 2·N²·D
// operations (1.8e9 at N=1024, D=280) against 3·N·D floats of traffic, so
// the fp32 CUDA-core rate bounds it (~26 µs at 67 TFLOP/s). The design is a
// simple tiled one in fp32 (the TPU kernel's bf16 hi/lo split of the cross
// term works around the TPU's bf16 matrix unit and is not part of the
// function):
//   * a block owns 8 rows (one warp each) and streams 32-column tiles of x
//     and s through shared memory (rows padded to D+1 floats, so the
//     distance loop's column-strided reads hit distinct banks);
//   * each lane forms one K entry of its warp's row per tile, as the sum of
//     squared differences (never negative, so the clamp is inert), masks
//     the ragged edge, and the warp then accumulates K·s, K·x and the row
//     sum in registers, lane ℓ owning columns ℓ, ℓ+32, ...;
//   * the block writes φ for its rows; no atomics.
// Above D = 800 a block's rows and tiles no longer fit its shared memory,
// and the JAX kernel has no D bound (it holds x and s whole in VMEM), so a
// D-tiled variant takes those shapes: each block owns 8 rows and one
// 512-wide tile of φ's columns (the grid's second axis); per column tile it
// first sums the squared distances over D in 512-wide slices staged through
// shared memory (in the same order, so K is the untiled kernel's), then
// accumulates K·s and K·x for its own output columns. The distances are
// formed once per output tile (⌈D/512⌉ times in all): a simple loop.
// Tensor cores are not used: fp32 throughout. Speed work comes later.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 8;            // rows per block, one warp each
constexpr int BN = 32;           // columns per streamed tile
constexpr int NTH = BM * 32;

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BM + 2 * BN) * (D + 1) + BM * BN);
}

template <int DPT>
__global__ void __launch_bounds__(NTH)
velocity_kernel(const float* __restrict__ x, const float* __restrict__ s,
                const float* __restrict__ hptr, float* __restrict__ phi, int N,
                int D) {
  extern __shared__ float sm[];
  const int ld = D + 1;
  float* xr = sm;              // [BM][ld] this block's rows
  float* xc = xr + BM * ld;    // [BN][ld] column tile of x
  float* sc = xc + BN * ld;    // [BN][ld] column tile of s
  float* kt = sc + BN * ld;    // [BM][BN] Gram tile

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BM;
  const float h = hptr[0];
  const float h2 = h * h;

  for (int e = threadIdx.x; e < BM * D; e += NTH) {
    const int rr = e / D, d = e % D;
    xr[rr * ld + d] = row0 + rr < N ? x[(size_t)(row0 + rr) * D + d] : 0.f;
  }
  float ks[DPT], kx[DPT];
#pragma unroll
  for (int m = 0; m < DPT; ++m) {
    ks[m] = 0.f;
    kx[m] = 0.f;
  }
  float rowsum = 0.f;

  for (int c0 = 0; c0 < N; c0 += BN) {
    __syncthreads();  // the previous tile is consumed (and xr is staged)
    for (int e = threadIdx.x; e < BN * D; e += NTH) {
      const int cc = e / D, d = e % D;
      const bool in = c0 + cc < N;
      xc[cc * ld + d] = in ? x[(size_t)(c0 + cc) * D + d] : 0.f;
      sc[cc * ld + d] = in ? s[(size_t)(c0 + cc) * D + d] : 0.f;
    }
    __syncthreads();
    {
      const float* xa = xr + w * ld;
      const float* xb = xc + lane * ld;
      float d2 = 0.f;
      for (int d = 0; d < D; ++d) {
        const float df = xa[d] - xb[d];
        d2 = fmaf(df, df, d2);
      }
      // padded columns must not contribute to any sum
      kt[w * BN + lane] = c0 + lane < N ? expf(-0.5f * d2 / h2) : 0.f;
    }
    __syncwarp();
    for (int c = 0; c < BN; ++c) {
      const float kv = kt[w * BN + c];
      rowsum += kv;
      const float* sv = sc + c * ld;
      const float* xv = xc + c * ld;
#pragma unroll
      for (int m = 0; m < DPT; ++m) {
        const int d = lane + 32 * m;
        if (d < D) {
          ks[m] = fmaf(kv, sv[d], ks[m]);
          kx[m] = fmaf(kv, xv[d], kx[m]);
        }
      }
    }
  }

  const int row = row0 + w;
  if (row < N) {
    const float inv_n = 1.f / (float)N;
#pragma unroll
    for (int m = 0; m < DPT; ++m) {
      const int d = lane + 32 * m;
      if (d < D) {
        const float grad_k = (kx[m] - rowsum * xr[w * ld + d]) / h2;
        phi[(size_t)row * D + d] = (ks[m] - grad_k) * inv_n;
      }
    }
  }
}

constexpr int DT = 512;          // φ columns per block in the D-tiled kernel
constexpr int DPT_T = DT / 32;

size_t smem_tiled_bytes() {
  return sizeof(float) * ((size_t)(BM + 2 * BN) * (DT + 1) + BM * BN);
}

// Rows [r0, r0 + BM) (zero beyond N) of x's columns [e0, e0 + width) into
// dst [BM][DT + 1].
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int r0,
                                      int rows, int N, int D, int e0, int width) {
  for (int e = threadIdx.x; e < rows * width; e += NTH) {
    const int rr = e / width, d = e % width;
    dst[rr * (DT + 1) + d] = r0 + rr < N ? src[(size_t)(r0 + rr) * D + e0 + d] : 0.f;
  }
}

__global__ void __launch_bounds__(NTH)
velocity_tiled_kernel(const float* __restrict__ x, const float* __restrict__ s,
                      const float* __restrict__ hptr, float* __restrict__ phi, int N,
                      int D) {
  extern __shared__ float sm[];
  constexpr int ld = DT + 1;
  float* xr = sm;              // [BM][ld] this block's rows, a D slice
  float* xc = xr + BM * ld;    // [BN][ld] column tile of x, a D slice
  float* sc = xc + BN * ld;    // [BN][ld] column tile of s, the output slice
  float* kt = sc + BN * ld;    // [BM][BN] Gram tile

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BM;
  const int d0 = blockIdx.y * DT, wout = min(DT, D - d0);
  const float h = hptr[0];
  const float h2 = h * h;
  float ks[DPT_T], kx[DPT_T];
#pragma unroll
  for (int m = 0; m < DPT_T; ++m) {
    ks[m] = 0.f;
    kx[m] = 0.f;
  }
  float rowsum = 0.f;

  for (int c0 = 0; c0 < N; c0 += BN) {
    float d2 = 0.f;
    for (int e0 = 0; e0 < D; e0 += DT) {
      const int width = min(DT, D - e0);
      __syncthreads();  // the previous slice (or tile) is consumed
      stage(xr, x, row0, BM, N, D, e0, width);
      stage(xc, x, c0, BN, N, D, e0, width);
      __syncthreads();
      const float* xa = xr + w * ld;
      const float* xb = xc + lane * ld;
      for (int d = 0; d < width; ++d) {
        const float df = xa[d] - xb[d];
        d2 = fmaf(df, df, d2);
      }
    }
    // padded columns must not contribute to any sum
    kt[w * BN + lane] = c0 + lane < N ? expf(-0.5f * d2 / h2) : 0.f;
    __syncthreads();
    stage(xc, x, c0, BN, N, D, d0, wout);
    stage(sc, s, c0, BN, N, D, d0, wout);
    __syncthreads();
    for (int c = 0; c < BN; ++c) {
      const float kv = kt[w * BN + c];
      rowsum += kv;
      const float* sv = sc + c * ld;
      const float* xv = xc + c * ld;
#pragma unroll
      for (int m = 0; m < DPT_T; ++m) {
        const int d = lane + 32 * m;
        if (d < wout) {
          ks[m] = fmaf(kv, sv[d], ks[m]);
          kx[m] = fmaf(kv, xv[d], kx[m]);
        }
      }
    }
  }

  __syncthreads();
  stage(xr, x, row0, BM, N, D, d0, wout);
  __syncthreads();
  const int row = row0 + w;
  if (row < N) {
    const float inv_n = 1.f / (float)N;
#pragma unroll
    for (int m = 0; m < DPT_T; ++m) {
      const int d = lane + 32 * m;
      if (d < wout) {
        const float grad_k = (kx[m] - rowsum * xr[w * ld + d]) / h2;
        phi[(size_t)row * D + d0 + d] = (ks[m] - grad_k) * inv_n;
      }
    }
  }
}

cudaError_t launch_tiled(const float* x, const float* s, const float* h, float* phi, int N,
                         int D, cudaStream_t stream) {
  const size_t smem = smem_tiled_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      velocity_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BM - 1) / BM, (D + DT - 1) / DT);
  velocity_tiled_kernel<<<grid, NTH, smem, stream>>>(x, s, h, phi, N, D);
  return cudaGetLastError();
}

template <int DPT>
cudaError_t launch(const float* x, const float* s, const float* h, float* phi,
                   int N, int D, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      velocity_kernel<DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  velocity_kernel<DPT><<<(N + BM - 1) / BM, NTH, smem, stream>>>(x, s, h, phi, N, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, s, phi [N, D], h [1]; fp32, contiguous, on the stream's device; D <=
// 800 takes the untiled kernel, wider rows the D-tiled one (at most 65535
// column tiles). Returns cudaGetLastError() after the launch.
int svgd_velocity(const float* x, const float* s, const float* h, float* phi,
                  int N, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 128) err = launch<4>(x, s, h, phi, N, D, st);
  else if (D <= 288) err = launch<9>(x, s, h, phi, N, D, st);
  else if (D <= 512) err = launch<16>(x, s, h, phi, N, D, st);
  else if (D <= 800) err = launch<25>(x, s, h, phi, N, D, st);
  else if ((D + DT - 1) / DT <= 65535) err = launch_tiled(x, s, h, phi, N, D, st);
  else return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
