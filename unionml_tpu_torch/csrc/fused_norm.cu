// Fused RMSNorm / LayerNorm for Hopper (sm_90a): forward, residual-add
// forward, and the shared backward.
//
// Replaces (unionml_tpu/ops/fused_norm.py, each reached through
// pl.pallas_call):
//   - _fwd_kernel via _norm_fwd, rms=True, no beta   (Llama RMSNorm)
//   - _fwd_kernel via _norm_fwd, LayerNorm with beta  (ViT ln1 / ln_final)
//   - _add_fwd_kernel via _norm_add_fwd              (ViT ln2: s = x + r,
//     y = norm(s), statistics from the fp32 sum, s written in x's dtype)
//   - _bwd_kernel via _norm_bwd                       (both modes: dx plus
//     per-row-block dgamma / dbeta partials, summed outside the kernel)
//
// What they compute: over the last axis of x [rows, d], fp32 statistics
// (mean and variance E[(x - mu)^2] for LayerNorm; mean(x^2) for RMS, mu = 0),
// y = ((x - mu) * rstd) * g (+ b) cast to x's dtype; nothing else is written
// in the forward. The backward recomputes the statistics from x (the add
// form passes the stored, rounded s), then
//   dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat))   (LayerNorm)
//   dx = rstd * (dyg - xhat * mean(dyg * xhat))               (RMS)
// with dyg = dy * g, and per block of rows the column sums dy * xhat and dy.
//
// Bound on the H100: memory. Every element is read once and written once
// with a handful of flops, far below the ~295 flops per byte at which the
// card's arithmetic would limit it.
//
// Design: a block of T threads (a multiple of 32, at most 256) owns a row:
// thread t holds the 16-byte vectors t, t + T, ... of the row in registers
// (NV of them, NV <= 8), so the row is read from device memory once;
// neighbouring threads read neighbouring 16 bytes. Block reductions are a
// warp shuffle plus a fixed-order pass over the warps' partials, so results
// do not depend on scheduling. The backward gives each block a fixed run of
// rows and keeps its column sums in registers across them (a thread owns the
// same columns in every row), writing one fp32 partial row of dgamma (and
// dbeta) per block: deterministic, no atomics. On the TPU one grid step
// covered a 256-row VMEM block and masked its ragged tail; here rows past
// the end are simply never visited.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;

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

// Sum of (a, b) over the block, returned to every thread. `scratch` holds
// MAX_WARPS float2; the trailing barrier lets the caller reuse it at once.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) {
    t.x += scratch[w].x;
    t.y += scratch[w].y;
  }
  __syncthreads();
  return t;
}

template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);
  alignas(16) T v[N];
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* row, int i, float* out) {
  Pack<T> p;
  *reinterpret_cast<uint4*>(p.v) = reinterpret_cast<const uint4*>(row)[i];
#pragma unroll
  for (int j = 0; j < Pack<T>::N; ++j) out[j] = to_f(p.v[j]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* row, int i, const float* in) {
  Pack<T> p;
#pragma unroll
  for (int j = 0; j < Pack<T>::N; ++j) p.v[j] = from_f<T>(in[j]);
  reinterpret_cast<uint4*>(row)[i] = *reinterpret_cast<const uint4*>(p.v);
}

// Forward: y = norm(x) (r == nullptr), or s = x + r, y = norm(s32) with s
// written in TX. b may be nullptr (RMS, or LayerNorm without a shift).
template <typename TX, typename TG, int NV>
__global__ void __launch_bounds__(MAX_THREADS)
norm_fwd_kernel(const TX* __restrict__ x, const TX* __restrict__ r,
                const TG* __restrict__ g, const TG* __restrict__ b,
                TX* __restrict__ s, TX* __restrict__ y, int d, float eps,
                int rms) {
  constexpr int VEC = Pack<TX>::N;
  __shared__ float2 scratch[MAX_WARPS];
  const size_t base = (size_t)blockIdx.x * d;
  const int nvec = d / VEC;
  float v[NV][VEC];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < nvec) {
      load_vec(x + base, i, v[u]);
      if (r != nullptr) {
        float rv[VEC];
        load_vec(r + base, i, rv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[u][j] += rv[j];
        store_vec(s + base, i, v[u]);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sum += v[u][j];
        sq += v[u][j] * v[u][j];
      }
    }
  }
  float mu = 0.f, var;
  if (rms) {
    var = block_sum2(sq, 0.f, scratch).x / (float)d;
  } else {
    mu = block_sum2(sum, 0.f, scratch).x / (float)d;
    float c = 0.f;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      if (threadIdx.x + u * blockDim.x < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float t = v[u][j] - mu;
          c += t * t;
        }
      }
    }
    var = block_sum2(c, 0.f, scratch).x / (float)d;
  }
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < nvec) {
      float out[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int col = i * VEC + j;
        float o = (v[u][j] - mu) * rstd * to_f(g[col]);
        if (b != nullptr) o += to_f(b[col]);
        out[j] = o;
      }
      store_vec(y + base, i, out);
    }
  }
}

// Backward over rows [blockIdx.x * rpb, min(rows, (blockIdx.x + 1) * rpb)):
// dx for each row, and this block's partial column sums of dy * xhat
// (dg_parts) and dy (db_parts, skipped when nullptr), one fp32 row each.
template <typename TX, int NV>
__global__ void __launch_bounds__(MAX_THREADS)
norm_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ g,
                const TX* __restrict__ dy, TX* __restrict__ dx,
                float* __restrict__ dg_parts, float* __restrict__ db_parts,
                int rows, int d, float eps, int rms, int rpb) {
  constexpr int VEC = Pack<TX>::N;
  __shared__ float2 scratch[MAX_WARPS];
  const int nvec = d / VEC;
  float dg[NV][VEC], db[NV][VEC], gv[NV][VEC];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      dg[u][j] = 0.f;
      db[u][j] = 0.f;
      gv[u][j] = i < nvec ? g[i * VEC + j] : 0.f;
    }
  }
  const int row0 = blockIdx.x * rpb;
  const int row1 = min(rows, row0 + rpb);
  for (int row = row0; row < row1; ++row) {
    const size_t base = (size_t)row * d;
    float xv[NV][VEC], gy[NV][VEC];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = threadIdx.x + u * blockDim.x;
      if (i < nvec) {
        load_vec(x + base, i, xv[u]);
        load_vec(dy + base, i, gy[u]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          sum += xv[u][j];
          sq += xv[u][j] * xv[u][j];
        }
      }
    }
    float mu = 0.f, var;
    if (rms) {
      var = block_sum2(sq, 0.f, scratch).x / (float)d;
    } else {
      mu = block_sum2(sum, 0.f, scratch).x / (float)d;
      float c = 0.f;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        if (threadIdx.x + u * blockDim.x < nvec) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float t = xv[u][j] - mu;
            c += t * t;
          }
        }
      }
      var = block_sum2(c, 0.f, scratch).x / (float)d;
    }
    const float rstd = rsqrtf(var + eps);
    // xv becomes xhat; gy keeps dy, and the column sums take their share
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      if (threadIdx.x + u * blockDim.x < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (xv[u][j] - mu) * rstd;
          const float dyv = gy[u][j];
          const float dyg = dyv * gv[u][j];
          xv[u][j] = xh;
          dg[u][j] += dyv * xh;
          db[u][j] += dyv;
          s1 += dyg;
          s2 += dyg * xh;
        }
      }
    }
    const float2 c12 = block_sum2(s1, s2, scratch);
    const float c1 = rms ? 0.f : c12.x / (float)d;
    const float c2 = c12.y / (float)d;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = threadIdx.x + u * blockDim.x;
      if (i < nvec) {
        float out[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float dyg = gy[u][j] * gv[u][j];
          out[j] = rms ? rstd * (dyg - xv[u][j] * c2)
                       : rstd * (dyg - c1 - xv[u][j] * c2);
        }
        store_vec(dx + base, i, out);
      }
    }
  }
  const size_t pbase = (size_t)blockIdx.x * d;
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        dg_parts[pbase + i * VEC + j] = dg[u][j];
        if (db_parts != nullptr) db_parts[pbase + i * VEC + j] = db[u][j];
      }
    }
  }
}

// Threads per row and registers per thread for a row of nvec vectors:
// T = nvec rounded up to a warp, at most 256; NV = ceil(nvec / T).
inline void row_shape(int nvec, int* threads, int* nv) {
  int t = ((nvec + 31) / 32) * 32;
  *threads = t < MAX_THREADS ? t : MAX_THREADS;
  *nv = (nvec + *threads - 1) / *threads;
}

template <typename TX, typename TG, int NV>
cudaError_t fwd_launch(const void* x, const void* r, const void* g, const void* b,
                       void* s, void* y, int rows, int d, float eps, int rms,
                       int threads, cudaStream_t stream) {
  norm_fwd_kernel<TX, TG, NV><<<rows, threads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(r),
      static_cast<const TG*>(g), static_cast<const TG*>(b),
      static_cast<TX*>(s), static_cast<TX*>(y), d, eps, rms);
  return cudaGetLastError();
}

template <typename TX, typename TG>
cudaError_t fwd_dispatch(const void* x, const void* r, const void* g, const void* b,
                         void* s, void* y, int rows, int d, float eps, int rms,
                         cudaStream_t stream) {
  int threads, nv;
  row_shape(d / Pack<TX>::N, &threads, &nv);
  switch (nv) {
    case 1: return fwd_launch<TX, TG, 1>(x, r, g, b, s, y, rows, d, eps, rms, threads, stream);
    case 2: return fwd_launch<TX, TG, 2>(x, r, g, b, s, y, rows, d, eps, rms, threads, stream);
    case 3:
    case 4: return fwd_launch<TX, TG, 4>(x, r, g, b, s, y, rows, d, eps, rms, threads, stream);
    case 5: case 6: case 7:
    case 8: return fwd_launch<TX, TG, 8>(x, r, g, b, s, y, rows, d, eps, rms, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX, int NV>
cudaError_t bwd_launch(const void* x, const float* g, const void* dy, void* dx,
                       float* dg, float* db, int rows, int d, float eps, int rms,
                       int rpb, int threads, cudaStream_t stream) {
  const int blocks = (rows + rpb - 1) / rpb;
  norm_bwd_kernel<TX, NV><<<blocks, threads, 0, stream>>>(
      static_cast<const TX*>(x), g, static_cast<const TX*>(dy),
      static_cast<TX*>(dx), dg, db, rows, d, eps, rms, rpb);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t bwd_dispatch(const void* x, const float* g, const void* dy, void* dx,
                         float* dg, float* db, int rows, int d, float eps, int rms,
                         int rpb, cudaStream_t stream) {
  int threads, nv;
  row_shape(d / Pack<TX>::N, &threads, &nv);
  switch (nv) {
    case 1: return bwd_launch<TX, 1>(x, g, dy, dx, dg, db, rows, d, eps, rms, rpb, threads, stream);
    case 2: return bwd_launch<TX, 2>(x, g, dy, dx, dg, db, rows, d, eps, rms, rpb, threads, stream);
    case 3:
    case 4: return bwd_launch<TX, 4>(x, g, dy, dx, dg, db, rows, d, eps, rms, rpb, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Forward. x, y (and r, s for the add form; else both nullptr): [rows, d]
// contiguous, bf16 (x_bf16 = 1) or fp32; g, b: [d] bf16 (g_bf16 = 1) or
// fp32, b may be nullptr. rms = 1 drops the mean. d must be a multiple of
// 16 / sizeof(x element) and at most 2048 such vectors. Returns the
// launch's cudaError_t.
extern "C" int norm_fwd(const void* x, const void* r, const void* g, const void* b,
                        void* s, void* y, int rows, int d, float eps, int rms,
                        int x_bf16, int g_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (x_bf16 && g_bf16)
    return fwd_dispatch<__nv_bfloat16, __nv_bfloat16>(x, r, g, b, s, y, rows, d, eps, rms, st);
  if (x_bf16) return fwd_dispatch<__nv_bfloat16, float>(x, r, g, b, s, y, rows, d, eps, rms, st);
  if (g_bf16) return fwd_dispatch<float, __nv_bfloat16>(x, r, g, b, s, y, rows, d, eps, rms, st);
  return fwd_dispatch<float, float>(x, r, g, b, s, y, rows, d, eps, rms, st);
}

// Backward. x, dy, dx: [rows, d] contiguous in one dtype (bf16 when x_bf16);
// g: [d] fp32; dg_parts (and db_parts unless nullptr): [ceil(rows / rpb), d]
// fp32, one partial row per block of rpb rows. d at most 1024 vectors.
extern "C" int norm_bwd(const void* x, const void* g, const void* dy, void* dx,
                        void* dg_parts, void* db_parts, int rows, int d, float eps,
                        int rms, int x_bf16, int rpb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (rpb <= 0) return (int)cudaErrorInvalidValue;
  const float* gf = static_cast<const float*>(g);
  float* dg = static_cast<float*>(dg_parts);
  float* db = static_cast<float*>(db_parts);
  if (x_bf16) return bwd_dispatch<__nv_bfloat16>(x, gf, dy, dx, dg, db, rows, d, eps, rms, rpb, st);
  return bwd_dispatch<float>(x, gf, dy, dx, dg, db, rows, d, eps, rms, rpb, st);
}
