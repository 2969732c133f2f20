// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * g.
//
// Replaces: unionml_tpu/ops/fused_norm.py::_fwd_kernel with rms=True and no
// beta (reached through _norm_fwd -> pl.pallas_call), the Llama RMSNorm of
// norm_impl="fused".
//
// Bound on the H100: memory. Per row it reads D inputs once and writes D
// outputs once, and does ~4 flops per element, far below the ~295 flops per
// byte at which the card's arithmetic would limit it.
//
// Design: one block of 256 threads per row. Each thread reads 16 bytes at a
// time (neighbouring threads on neighbouring addresses), accumulates x^2 in
// fp32, and a warp-shuffle plus shared-memory reduction gives the row's
// statistic. The second pass re-reads the row (an 8 KB row at D = 4096 is
// still in L1/L2, so device memory sees one read) and writes y in x's dtype.
// No statistics are written, as in the TPU kernel. The TPU kernel's
// 256-row blocks exist to fill VMEM tiles; here one row per block already
// gives thousands of blocks at prefill, and the decode case (a few rows)
// is latency-bound whatever the tiling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(THREADS)
rms_norm_fwd_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                    TX* __restrict__ y, int d, float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  const TX* xr = x + (size_t)blockIdx.x * d;
  TX* yr = y + (size_t)blockIdx.x * d;
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    alignas(16) TX v[VEC];
    *reinterpret_cast<uint4*>(v) = reinterpret_cast<const uint4*>(xr)[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(v[j]);
      ss += f * f;
    }
  }

  __shared__ float partial[THREADS / 32];
  __shared__ float rstd_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < THREADS / 32 ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) rstd_s = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float rstd = rstd_s;

  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    alignas(16) TX in[VEC];
    alignas(16) TX out[VEC];
    *reinterpret_cast<uint4*>(in) = reinterpret_cast<const uint4*>(xr)[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      out[j] = from_f<TX>(to_f(in[j]) * rstd * to_f(g[i * VEC + j]));
    }
    reinterpret_cast<uint4*>(yr)[i] = *reinterpret_cast<const uint4*>(out);
  }
}

template <typename TX, typename TG>
cudaError_t launch(const void* x, const void* g, void* y, int rows, int d,
                   float eps, cudaStream_t stream) {
  rms_norm_fwd_kernel<TX, TG><<<rows, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(g),
      static_cast<TX*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: [rows, d] contiguous, bf16 (x_bf16 = 1) or fp32; g: [d], bf16
// (g_bf16 = 1) or fp32. d must be a multiple of 16 / sizeof(x element).
// Returns the cudaError_t of the launch.
extern "C" int rms_norm_fwd(const void* x, const void* g, void* y, int rows,
                            int d, float eps, int x_bf16, int g_bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (x_bf16 && g_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(x, g, y, rows, d, eps, s);
  if (x_bf16) return launch<__nv_bfloat16, float>(x, g, y, rows, d, eps, s);
  if (g_bf16) return launch<float, __nv_bfloat16>(x, g, y, rows, d, eps, s);
  return launch<float, float>(x, g, y, rows, d, eps, s);
}
