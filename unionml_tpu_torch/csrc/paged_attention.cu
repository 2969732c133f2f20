// Paged decode attention for Hopper (sm_90a): one query per batch row over a
// block-paged KV pool, addressed through a block table.
//
// Replaces: unionml_tpu/ops/paged_attention.py::_paged_kernel (reached
// through _paged_pallas -> pl.pallas_call), the decode-step attention of the
// engine's paged mode, in its bf16-pool and int8-pool forms.
//
// What it computes, for batch row b and q head hq (kv head h = hq / G, G =
// Hq / Hk): out[b, hq] = sum_j p_j v_j / sum_j p'_j over the visible pool rows
// j < lengths[b], where row j lives in pool block table[b, j / block] at
// offset j % block, s_j = (q . k_j) * scale (times k_scale[j, h] for int8
// pools), p'_j = exp(s_j - max s), and p_j = p'_j * v_scale[j, h] (int8) or
// p'_j (bf16), rounded to q's dtype before the product with v, as the TPU
// kernel casts p to q.dtype. The normaliser sums the unscaled p'. Statistics
// (running max, normaliser, accumulator) stay in fp32 with the TPU kernel's
// NEG_INF guards; a row with nothing visible returns acc / max(l, 1e-30) = 0.
// Output is in q's dtype.
//
// Bound on the H100: bytes. Each visible K/V row is read once (Hk * D * 2
// bytes per row and per tensor for bf16, 1 byte plus a 4-byte scale per head
// for int8) and every row is used by only G = 4 queries, so the work is far
// below the card's operations-per-byte balance.
//
// Design (a first, simple version): one block of 4 warps per (batch row, kv
// head) holds that kv head's G query rows in shared memory and walks the
// row's table entries w < ceil(length / block), reading each pool block's
// visible rows for its kv head straight from the pool through table[b, w] (no
// gathered copy; rows at or past the length are never read, so trash entries
// past coverage and duplicate ids across rows are harmless). Each pass stages
// up to 32 rows of K and V in shared memory as fp32; one thread per (query,
// row) forms a score, one warp per query row does the online-softmax update
// (32 rows = one lane each), and one thread per (query, column) updates the
// fp32 accumulator. On the TPU the table-width grid axis ran in order with
// scratch carried between steps; here the loop inside the block takes its
// place. Tensor cores, a split of long rows over several blocks
// (flash-decoding) and asynchronous copies are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;   // pool rows staged per pass (one lane each)
constexpr int MAXG = 8;    // q heads per kv head held in shared memory
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

// p cast to q's dtype before the product with v (fp32 q: unchanged)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                       const TKV* __restrict__ v, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ table,
                       const int* __restrict__ lengths, TQ* __restrict__ out, int hq,
                       int hk, int num_blocks, int block, int width, float scale) {
  constexpr int KS = D + 1;  // padded K row: the score loop reads a column
  __shared__ float q_s[MAXG * D];
  __shared__ float k_s[TILE * KS];
  __shared__ float v_s[TILE * D];
  __shared__ float p_s[MAXG * TILE];
  __shared__ float acc_s[MAXG * D];
  __shared__ float m_s[MAXG], l_s[MAXG], c_s[MAXG];
  __shared__ float ks_s[TILE], vs_s[TILE];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g_n = hq / hk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // rows past the table's reach do not exist (the gather view is W*block)
  const int length = max(0, min(lengths[b], width * block));

  // q, out: [B, Hq, D]; this block's G query rows are contiguous
  const size_t q_base = ((size_t)b * hq + (size_t)h * g_n) * D;
  for (int i = tid; i < g_n * D; i += THREADS) {
    q_s[i] = to_float(q[q_base + i]);
    acc_s[i] = 0.f;
  }
  if (tid < g_n) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int n_entries = (length + block - 1) / block;
  for (int w = 0; w < n_entries; ++w) {
    const int pid = min(max(table[(size_t)b * width + w], 0), num_blocks - 1);
    const int rows = min(block, length - w * block);
    for (int r0 = 0; r0 < rows; r0 += TILE) {
      const int n = min(TILE, rows - r0);
      // pool [N, block, Hk, D]: row (pid, r0 + r), kv head h
      const size_t row0 = (size_t)pid * block + r0;
      for (int i = tid; i < n * D; i += THREADS) {
        const int r = i / D, c = i % D;
        const size_t off = ((row0 + r) * hk + h) * D + c;
        k_s[r * KS + c] = to_float(k[off]);
        v_s[r * D + c] = to_float(v[off]);
      }
      if (QUANT && tid < n) {
        ks_s[tid] = k_scale[(row0 + tid) * hk + h];
        vs_s[tid] = v_scale[(row0 + tid) * hk + h];
      }
      __syncthreads();

      // scores: one thread per (query row, pool row)
      for (int i = tid; i < g_n * TILE; i += THREADS) {
        const int g = i / TILE, r = i % TILE;
        float s = NEG_INF;
        if (r < n) {
          const float* qr = q_s + g * D;
          const float* kr = k_s + r * KS;
          float dot = 0.f;
#pragma unroll 8
          for (int c = 0; c < D; ++c) dot = fmaf(qr[c], kr[c], dot);
          s = dot * scale;
          if (QUANT) s *= ks_s[r];
        }
        p_s[i] = s;
      }
      __syncthreads();

      // online softmax: one warp per query row, one lane per pool row
      for (int g = warp; g < g_n; g += WARPS) {
        const bool valid = lane < n;
        const float s = p_s[g * TILE + lane];
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, warp_max(valid ? s : NEG_INF));
        const float m_safe = m_new == NEG_INF ? 0.f : m_new;
        float p = valid ? expf(s - m_safe) : 0.f;
        const float corr = m_prev == NEG_INF ? 0.f : expf(m_prev - m_safe);
        const float sum = warp_sum(p);
        if (QUANT && valid) p *= vs_s[lane];
        p_s[g * TILE + lane] = round_to(p, TQ());
        if (lane == 0) {
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
          c_s[g] = corr;
        }
      }
      __syncthreads();

      // acc = acc * corr + p . v: one thread per (query row, column)
      for (int i = tid; i < g_n * D; i += THREADS) {
        const int g = i / D, c = i % D;
        const float* pr = p_s + g * TILE;
        float a = acc_s[i] * c_s[g];
        for (int r = 0; r < n; ++r) a = fmaf(pr[r], v_s[r * D + c], a);
        acc_s[i] = a;
      }
      __syncthreads();  // K/V tiles are overwritten by the next pass
    }
  }

  for (int i = tid; i < g_n * D; i += THREADS) {
    store(out + q_base + i, acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <int D, typename TQ, typename TKV, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* table, const void* lengths, void* out,
                   int b, int hq, int hk, int num_blocks, int block, int width,
                   float scale, cudaStream_t stream) {
  dim3 grid(b, hk);
  paged_attention_kernel<D, TQ, TKV, QUANT><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<TQ*>(out), hq, hk, num_blocks, block, width, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* ks,
                     const void* vs, const void* table, const void* lengths, void* out,
                     int b, int hq, int hk, int num_blocks, int block, int width,
                     float scale, int q_bf16, int kv_int8, cudaStream_t s) {
  if (q_bf16 && kv_int8)
    return launch<D, __nv_bfloat16, int8_t, true>(q, k, v, ks, vs, table, lengths, out, b,
                                                  hq, hk, num_blocks, block, width, scale, s);
  if (q_bf16)
    return launch<D, __nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, ks, vs, table, lengths, out, b, hq, hk, num_blocks, block, width, scale, s);
  if (kv_int8)
    return launch<D, float, int8_t, true>(q, k, v, ks, vs, table, lengths, out, b, hq, hk,
                                          num_blocks, block, width, scale, s);
  return launch<D, float, __nv_bfloat16, false>(q, k, v, ks, vs, table, lengths, out, b,
                                                hq, hk, num_blocks, block, width, scale, s);
}

}  // namespace

// q, out: [b, hq, d] (bf16 if q_bf16 else fp32); k, v: [num_blocks, block, hk,
// d] (int8 if kv_int8 else bf16); k_scale, v_scale: [num_blocks, block, hk]
// fp32 (int8 only, else null); table: [b, width] int32; lengths: [b] int32;
// all contiguous on the device. d must be 64 or 128 and hq a multiple of hk
// with hq / hk <= 8. Returns the launch's cudaError_t.
extern "C" int paged_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* table, const void* lengths, void* out,
                                   int b, int hq, int hk, int d, int num_blocks,
                                   int block, int width, float scale, int q_bf16,
                                   int kv_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0) return 0;
  if (hk <= 0 || hq % hk != 0 || hq / hk > MAXG || block <= 0 || width <= 0 ||
      num_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (d == 128)
    return dispatch<128>(q, k, v, k_scale, v_scale, table, lengths, out, b, hq, hk,
                         num_blocks, block, width, scale, q_bf16, kv_int8, s);
  if (d == 64)
    return dispatch<64>(q, k, v, k_scale, v_scale, table, lengths, out, b, hq, hk,
                        num_blocks, block, width, scale, q_bf16, kv_int8, s);
  return (int)cudaErrorInvalidValue;
}
