// Flash-attention forward for Hopper (sm_90a), GQA-aware, in two modes.
//
// Replaces: unionml_tpu/ops/flash_attention.py::_fwd_kernel in both its
// forms: the padded, forward-only form (reached through _flash_fwd_padded ->
// pl.pallas_call), the full-prefill attention of prefill_impl="flash"
// (entry flash_fwd_padded); and the lse form of the differentiable path
// (reached through _flash_fwd_bhsd -> pl.pallas_call), the training forward
// whose per-row logsumexp the FlashAttention-2 backward reads (entry
// flash_fwd_lse, no padding).
//
// What it computes: out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, kvh] * scale)
// . v[b, j, kvh] over the kv positions j that are visible to query i:
// j >= pad[b] (left padding) and, causally with bottom-right alignment,
// j <= i + (Skv - Sq). kvh = h / (H / KVH): contiguous q-head groups share a
// kv head, which is read at its own width (never repeated). Query rows with
// no visible kv position (inside the padding) return zeros. Statistics m, l
// and the accumulator stay in fp32; P is cast to bf16 before the P.V
// product, as the TPU kernel does. The lse mode also writes lse[b, h, i] =
// m + ln(l) in fp32 (natural log), 0 for a row that sees nothing, so the
// backward's exp(s - lse) stays 0 there.
//
// Bound on the H100: at the prefill shapes (S = 1024, head_dim 128) and the
// training shape (S = 4095, head_dim 64) the tensor-core operations
// (4 * S^2/2 * D per head, causal) outweigh the bytes read, so the bound is
// the bf16 matrix rate.
//
// Design (a first, simple version): one block of 4 warps per (batch * head,
// 64-query tile). The q tile is loaded once into shared memory and held in
// WMMA fragments; a loop over 64-key tiles stages K and V in shared memory,
// each warp computes its 16x64 score slab with bf16 WMMA (fp32 accumulate),
// a lane pair per query row applies the mask and the online softmax, and the
// warp adds P.V into its fp32 accumulator rows in shared memory. Key tiles
// above the causal diagonal and tiles wholly inside the row's left padding
// are never visited; q tiles are scheduled longest-first. On the TPU the kv
// grid axis ran in order with scratch carried between steps; here the loop
// over kv tiles inside the block takes its place. wgmma, TMA and a ring of
// tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

// Shared-memory layout. Strides are padded off a multiple of 32 banks and
// keep every 16x16 WMMA tile 32-byte aligned.
template <int D>
struct Layout {
  static constexpr int LDH = D + 8;    // bf16 q/k/v tiles
  static constexpr int LDS = BKV + 4;  // fp32 scores
  static constexpr int LDP = BKV + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;    // fp32 accumulator
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + (size_t)BQ * LDH * 2;
  static constexpr size_t V = K + (size_t)BKV * LDH * 2;
  static constexpr size_t S = V + (size_t)BKV * LDH * 2;
  static constexpr size_t P = S + (size_t)BQ * LDS * 4;
  static constexpr size_t O = P + (size_t)BQ * LDP * 2;
  static constexpr size_t L = O + (size_t)BQ * LDO * 4;
  static constexpr size_t BYTES = L + (size_t)BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_padded_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ pad,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                        int sq, int skv, int h, int kvh, float scale, int causal) {
  using Lay = Layout<D>;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::Q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + Lay::K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::V);
  float* Ss = reinterpret_cast<float*>(smem + Lay::S);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + Lay::P);
  float* Os = reinterpret_cast<float*>(smem + Lay::O);
  float* Ls = reinterpret_cast<float*>(smem + Lay::L);

  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest first
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const int kv_head = head / (h / kvh);
  const int offset = skv - sq;  // bottom-right causal alignment
  const int pad_b = pad != nullptr ? pad[b] : 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // q/out: [B, Sq, H, D]; k/v: [B, Skv, KVH, D], all contiguous
  const size_t q_stride = (size_t)h * D;
  const size_t kv_stride = (size_t)kvh * D;
  const __nv_bfloat16* q_base = q + ((size_t)b * sq * h + head) * D;
  const __nv_bfloat16* k_base = k + ((size_t)b * skv * kvh + kv_head) * D;
  const __nv_bfloat16* v_base = v + ((size_t)b * skv * kvh + kv_head) * D;
  __nv_bfloat16* o_base = out + ((size_t)b * sq * h + head) * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 val = zero;
    if (q_start + r < sq) {
      val = *reinterpret_cast<const uint4*>(q_base + (q_start + r) * q_stride + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * Lay::LDH + c) = val;
  }
  for (int i = tid; i < BQ * Lay::LDO; i += THREADS) Os[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * Lay::LDH + kk * 16, Lay::LDH);
  }

  // the softmax row this lane pair owns, and which half of the kv tile
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int q_pos = q_start + row;
  float m_run = NEG_INF;
  float l_run = 0.f;

  // visit only kv tiles that hold a visible position for some row here
  const int kv_lo = (pad_b / BKV) * BKV;
  const int kv_hi = causal ? min(skv, q_start + BQ + offset) : skv;

  for (int kv_start = kv_lo; kv_start < kv_hi; kv_start += BKV) {
    for (int i = tid; i < BKV * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      uint4 kval = zero, vval = zero;
      if (kv_start + r < skv) {
        kval = *reinterpret_cast<const uint4*>(k_base + (kv_start + r) * kv_stride + c);
        vval = *reinterpret_cast<const uint4*>(v_base + (kv_start + r) * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * Lay::LDH + c) = kval;
      *reinterpret_cast<uint4*>(Vs + r * Lay::LDH + c) = vval;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 query rows
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * Lay::LDH + kk * 16, Lay::LDH);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * Lay::LDS + n * 16, sf, Lay::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // masked online softmax over this lane's 32 columns of its row
    {
      const float* srow = Ss + row * Lay::LDS + half * 32;
      float s[32];
      unsigned visible = 0u;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kv_pos = kv_start + half * 32 + j;
        const bool ok = q_pos < sq && kv_pos < skv && kv_pos >= pad_b &&
                        (!causal || q_pos + offset >= kv_pos);
        s[j] = ok ? srow[j] * scale : NEG_INF;
        visible |= (ok ? 1u : 0u) << j;
        mx = fmaxf(mx, s[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);
      const float m_safe = m_new == NEG_INF ? 0.f : m_new;
      __nv_bfloat16* prow = Ps + row * Lay::LDP + half * 32;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p = ((visible >> j) & 1u) ? expf(s[j] - m_safe) : 0.f;
        prow[j] = __float2bfloat16(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = m_run == NEG_INF ? 0.f : expf(m_run - m_safe);
      l_run = l_run * corr + sum;
      m_run = m_new;
      float* orow = Os + row * Lay::LDO + half * (D / 2);
#pragma unroll 8
      for (int j = 0; j < D / 2; ++j) orow[j] *= corr;
    }
    __syncwarp();

    // O += P V for this warp's rows (fp32 accumulator lives in shared memory)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      float* optr = Os + warp * 16 * Lay::LDO + n * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, optr, Lay::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + warp * 16 * Lay::LDP + kk * 16, Lay::LDP);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * Lay::LDH + n * 16, Lay::LDH);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(optr, of, Lay::LDO, wmma::mem_row_major);
    }
    __syncthreads();  // K/V tiles are overwritten by the next iteration
  }

  if (half == 0) Ls[row] = l_run;
  if (lse != nullptr && half == 0 && q_pos < sq) {
    lse[(size_t)bh * sq + q_pos] = l_run > 0.f ? m_run + logf(l_run) : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < BQ * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    if (q_start + r >= sq) continue;
    const float l = fmaxf(Ls[r], 1e-30f);
    alignas(16) __nv_bfloat16 packed[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      packed[j] = __float2bfloat16(Os[r * Lay::LDO + c + j] / l);
    }
    *reinterpret_cast<uint4*>(o_base + (q_start + r) * q_stride + c) =
        *reinterpret_cast<const uint4*>(packed);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pad,
                   void* out, float* lse, int b, int sq, int skv, int h, int kvh,
                   float scale, int causal, cudaStream_t stream) {
  const int bytes = (int)Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_padded_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, b * h);
  flash_fwd_padded_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pad, static_cast<__nv_bfloat16*>(out), lse,
      sq, skv, h, kvh, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, out: [b, sq, h, d] bf16; k, v: [b, skv, kvh, d] bf16; pad: [b] int32
// (first visible kv position per batch row); all contiguous on the device.
// d must be 64 or 128 and h a multiple of kvh. Returns the launch's
// cudaError_t.
extern "C" int flash_fwd_padded(const void* q, const void* k, const void* v,
                                const void* pad, void* out, int b, int sq,
                                int skv, int h, int kvh, int d, float scale,
                                int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pad);
  if (b <= 0 || sq <= 0) return 0;
  if (d == 128) return launch<128>(q, k, v, p, out, nullptr, b, sq, skv, h, kvh, scale, causal, s);
  if (d == 64) return launch<64>(q, k, v, p, out, nullptr, b, sq, skv, h, kvh, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The lse form (training forward): q, out: [b, sq, h, d] bf16; k, v:
// [b, skv, kvh, d] bf16; lse: [b, h, sq] fp32; all contiguous. No padding;
// causal alignment is bottom-right (query i sees keys j <= i + skv - sq).
// d must be 64 or 128 and h a multiple of kvh. Returns the launch's
// cudaError_t.
extern "C" int flash_fwd_lse(const void* q, const void* k, const void* v, void* out,
                             void* lse, int b, int sq, int skv, int h, int kvh, int d,
                             float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (b <= 0 || sq <= 0) return 0;
  if (d == 128) return launch<128>(q, k, v, nullptr, out, l, b, sq, skv, h, kvh, scale, causal, s);
  if (d == 64) return launch<64>(q, k, v, nullptr, out, l, b, sq, skv, h, kvh, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
