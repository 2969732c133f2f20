// FlashAttention-2 backward for Hopper (sm_90a), GQA-aware: a dq kernel and a
// dk/dv kernel.
//
// Replaces: unionml_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (both reached through _flash_bwd_bhsd -> pl.pallas_call), the backward of
// the differentiable flash_attention (attn_impl="flash", long-context
// training).
//
// What they compute, per (batch, q head) with its kv head kvh = head / (H /
// KVH), from the forward's lse (natural log) and delta = rowsum(dO * O):
//   s  = q k^T * scale (fp32),   p = exp(s - lse) over the visible pairs,
//   dp = dO v^T (fp32),          ds = bf16(p * (dp - delta) * scale),
//   dq = ds k,   dv = sum over the group's heads of bf16(p)^T dO,
//   dk = sum over the group's heads of ds^T q,
// every product in bf16 with an fp32 sum, rounded where the TPU kernels round
// (p before p^T dO, ds before both of its products). Visibility: query i
// (global position i + Skv - Sq, bottom-right causal alignment) sees key j
// when j <= i + Skv - Sq under causal; rows at or past Sq or Skv are masked,
// never read as data (tails are zero-filled in shared memory).
//
// Bound on the H100: at the training shape (S = 4095, head_dim 64, causal)
// the tensor-core operations (dq: 3 products, dk/dv: 4 products of 2 * S^2/2
// * D per head) far outweigh the bytes read, so the bound is the bf16 matrix
// rate.
//
// Design (a first, simple version, WMMA bf16 with fp32 accumulation):
// - dq: one block of 4 warps per (batch * q head, 64-query tile), walking the
//   visible 64-key tiles (tiles above the causal diagonal are never
//   visited). Each warp owns 16 query rows: its S and dP slabs go through
//   shared memory, where a lane pair per row applies the mask and forms ds,
//   and dq is accumulated in WMMA fragments (registers), written once.
// - dk/dv: one block of 4 warps per (batch * kv head, 64-key tile), walking
//   the visible 64-query tiles of every q head of the group in turn, so the
//   group sum happens inside the block: no atomics and no repeated k/v, and a
//   rerun gives the same bits. Each warp owns 16 key rows and computes the
//   transposed slabs s^T = k q^T and dp^T = v dO^T directly; dk and dv are
//   accumulated in WMMA fragments (registers, 2 * D/16 fragments a warp),
//   not in shared memory, and written once.
// On the TPU the inner grid axis ran in order with scratch carried between
// steps; here the loop inside the block takes its place. wgmma, TMA and
// mma.sync register-resident softmax are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE = 64;          // query tile and key tile
constexpr int WARPS = 4;          // 16 rows each
constexpr int THREADS = WARPS * 32;
constexpr int LDS = TILE + 4;     // fp32 [64, 64] slabs
constexpr int LDP = TILE + 8;     // bf16 [64, 64] slabs

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Shared memory of both kernels: four bf16 [64, D] tiles, two fp32 slabs
// (adjacent, so they also hold one fp32 [64, D] output tile at the end), two
// bf16 slabs and two fp32 row vectors. Strides are padded off a multiple of
// 32 banks and keep every 16x16 WMMA tile 32-byte aligned.
template <int D>
struct Lay {
  static constexpr int LDH = D + 8;   // bf16 [64, D] tiles
  static constexpr int LDO = D + 4;   // the fp32 [64, D] output tile
  static constexpr size_t H = (size_t)TILE * LDH * 2;
  static constexpr size_t S = (size_t)TILE * LDS * 4;
  static constexpr size_t P = (size_t)TILE * LDP * 2;
  static constexpr size_t T0 = 0, T1 = H, T2 = 2 * H, T3 = 3 * H;
  static constexpr size_t S0 = 4 * H, S1 = S0 + S;
  static constexpr size_t P0 = S1 + S, P1 = P0 + P;
  static constexpr size_t R0 = P1 + P, R1 = R0 + TILE * 4;
  static constexpr size_t BYTES = R1 + TILE * 4;
  static_assert((size_t)TILE * LDO * 4 <= 2 * S, "output tile must fit the two slabs");
};

// rows [start, start + 64) of a tensor with row stride `stride` (elements)
// into a [64, LDH] bf16 tile; rows at or past `len` are zero
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int start, int len,
                                          size_t stride) {
  constexpr int CHUNKS = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 v = zero;
    if (start + r < len) v = *reinterpret_cast<const uint4*>(base + (start + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Lay<D>::LDH + c) = v;
  }
}

// out[16, 64] (fp32, ld LDS) = A[16, D] . B[64, D]^T, A and B bf16 tiles in
// shared memory (ld LDH)
template <int D>
__device__ __forceinline__ void slab_abt(const bf16* a, const bf16* b, float* out) {
  constexpr int LDH = Lay<D>::LDH;
  FragA af[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(af[kk], a + kk * 16, LDH);
#pragma unroll
  for (int n = 0; n < TILE / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBT bf;
      wmma::load_matrix_sync(bf, b + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, af[kk], bf, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[n] (16 x 16 fragments covering [16, D]) += A[16, 64] (bf16, ld LDP)
// . B[64, D] (bf16 tile, ld LDH)
template <int D>
__device__ __forceinline__ void frag_acc(FragC* acc, const bf16* a, const bf16* b) {
  constexpr int LDH = Lay<D>::LDH;
  FragA af[TILE / 16];
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) wmma::load_matrix_sync(af[kk], a + kk * 16, LDP);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      FragB bf;
      wmma::load_matrix_sync(bf, b + kk * 16 * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], af[kk], bf, acc[n]);
    }
  }
}

// Write a [64, D] result held as each warp's 16-row fragments: through the
// fp32 tile `buf` (ld LDO) to rows [start, start + 64) of `dst` (row stride
// `stride`, rows at or past `len` skipped), rounded to bf16.
template <int D>
__device__ __forceinline__ void write_frags(const FragC* acc, float* buf, bf16* dst, int start,
                                            int len, size_t stride) {
  constexpr int LDO = Lay<D>::LDO;
  constexpr int CHUNKS = D / 8;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // buf may still be read as the slabs
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(buf + warp * 16 * LDO + n * 16, acc[n], LDO, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    if (start + r >= len) continue;
    alignas(16) bf16 out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = __float2bfloat16(buf[r * LDO + c + j]);
    *reinterpret_cast<uint4*>(dst + (start + r) * stride + c) =
        *reinterpret_cast<const uint4*>(out);
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int sq, int skv, int off, int causal) {
  return qp < sq && kp < skv && (!causal || qp + off >= kp);
}

// dq: one block per (batch * q head, query tile); q/dO/dq [B, Sq, H, D], k/v
// [B, Skv, KVH, D], lse/delta [B, H, Sq]
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int sq, int skv, int h, int kvh, float scale,
                int causal) {
  using L = Lay<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::T0);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::T1);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::T2);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::T3);
  float* Ss = reinterpret_cast<float*>(smem + L::S0);
  float* dPs = reinterpret_cast<float*>(smem + L::S1);
  bf16* DSs = reinterpret_cast<bf16*>(smem + L::P0);
  float* Lse = reinterpret_cast<float*>(smem + L::R0);
  float* Dl = reinterpret_cast<float*>(smem + L::R1);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const int kv_head = head / (h / kvh);
  const int off = skv - sq;
  const size_t q_stride = (size_t)h * D, kv_stride = (size_t)kvh * D;
  const bf16* q_base = q + ((size_t)b * sq * h + head) * D;
  const bf16* do_base = dout + ((size_t)b * sq * h + head) * D;
  const bf16* k_base = k + ((size_t)b * skv * kvh + kv_head) * D;
  const bf16* v_base = v + ((size_t)b * skv * kvh + kv_head) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int qp = q0 + row;

  load_tile<D>(Qs, q_base, q0, sq, q_stride);
  load_tile<D>(dOs, do_base, q0, sq, q_stride);
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const bool ok = q0 + i < sq;
    Lse[i] = ok ? lse[(size_t)bh * sq + q0 + i] : 0.f;
    Dl[i] = ok ? delta[(size_t)bh * sq + q0 + i] : 0.f;
  }
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int kv_hi = causal ? min(skv, q0 + TILE + off) : skv;
  for (int k0 = 0; k0 < kv_hi; k0 += TILE) {
    load_tile<D>(Ks, k_base, k0, skv, kv_stride);
    load_tile<D>(Vs, v_base, k0, skv, kv_stride);
    __syncthreads();
    slab_abt<D>(Qs + warp * 16 * L::LDH, Ks, Ss + warp * 16 * LDS);
    slab_abt<D>(dOs + warp * 16 * L::LDH, Vs, dPs + warp * 16 * LDS);
    __syncwarp();
    {
      const float l = Lse[row], dl = Dl[row];
      const float* srow = Ss + row * LDS + half * 32;
      const float* prow = dPs + row * LDS + half * 32;
      bf16* dsrow = DSs + row * LDP + half * 32;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        float ds = 0.f;
        if (visible(qp, k0 + half * 32 + j, sq, skv, off, causal)) {
          const float p = expf(srow[j] * scale - l);
          ds = p * (prow[j] - dl) * scale;
        }
        dsrow[j] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    frag_acc<D>(acc, DSs + warp * 16 * LDP, Ks);
    __syncthreads();  // K/V tiles are overwritten by the next iteration
  }
  write_frags<D>(acc, Ss, dq + ((size_t)b * sq * h + head) * D, q0, sq, q_stride);
}

// dk/dv: one block per (batch * kv head, key tile), walking every q head of
// the group and its visible query tiles
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int skv, int h,
                 int kvh, float scale, int causal) {
  using L = Lay<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::T0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::T1);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::T2);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::T3);
  float* St = reinterpret_cast<float*>(smem + L::S0);
  float* dPt = reinterpret_cast<float*>(smem + L::S1);
  bf16* Pt = reinterpret_cast<bf16*>(smem + L::P0);
  bf16* DSt = reinterpret_cast<bf16*>(smem + L::P1);
  float* Lse = reinterpret_cast<float*>(smem + L::R0);
  float* Dl = reinterpret_cast<float*>(smem + L::R1);

  const int k0 = blockIdx.x * TILE;  // causal: low key tiles see the most queries
  const int bkv = blockIdx.y;
  const int b = bkv / kvh, kv_head = bkv % kvh;
  const int group = h / kvh;
  const int off = skv - sq;
  const size_t q_stride = (size_t)h * D, kv_stride = (size_t)kvh * D;
  const size_t kv_off = ((size_t)b * skv * kvh + kv_head) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int kp = k0 + row;

  load_tile<D>(Ks, k + kv_off, k0, skv, kv_stride);
  load_tile<D>(Vs, v + kv_off, k0, skv, kv_stride);
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }
  // the first query that sees key k0: i + off >= k0
  const int q_lo = causal ? (max(0, k0 - off) / TILE) * TILE : 0;

  for (int g = 0; g < group; ++g) {
    const int head = kv_head * group + g;
    const size_t bh = (size_t)b * h + head;
    const bf16* q_base = q + ((size_t)b * sq * h + head) * D;
    const bf16* do_base = dout + ((size_t)b * sq * h + head) * D;
    for (int q0 = q_lo; q0 < sq; q0 += TILE) {
      load_tile<D>(Qs, q_base, q0, sq, q_stride);
      load_tile<D>(dOs, do_base, q0, sq, q_stride);
      for (int i = threadIdx.x; i < TILE; i += THREADS) {
        const bool ok = q0 + i < sq;
        Lse[i] = ok ? lse[bh * sq + q0 + i] : 0.f;
        Dl[i] = ok ? delta[bh * sq + q0 + i] : 0.f;
      }
      __syncthreads();
      slab_abt<D>(Ks + warp * 16 * L::LDH, Qs, St + warp * 16 * LDS);
      slab_abt<D>(Vs + warp * 16 * L::LDH, dOs, dPt + warp * 16 * LDS);
      __syncwarp();
      {
        const float* srow = St + row * LDS + half * 32;
        const float* prow = dPt + row * LDS + half * 32;
        bf16* ptrow = Pt + row * LDP + half * 32;
        bf16* dsrow = DSt + row * LDP + half * 32;
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
          const int c = half * 32 + j;
          float p = 0.f, ds = 0.f;
          if (visible(q0 + c, kp, sq, skv, off, causal)) {
            p = expf(srow[j] * scale - Lse[c]);
            ds = p * (prow[j] - Dl[c]) * scale;
          }
          ptrow[j] = __float2bfloat16(p);
          dsrow[j] = __float2bfloat16(ds);
        }
      }
      __syncwarp();
      frag_acc<D>(dv_acc, Pt + warp * 16 * LDP, dOs);
      frag_acc<D>(dk_acc, DSt + warp * 16 * LDP, Qs);
      __syncthreads();  // Q/dO tiles are overwritten by the next iteration
    }
  }
  write_frags<D>(dk_acc, St, dk + kv_off, k0, skv, kv_stride);
  write_frags<D>(dv_acc, St, dv + kv_off, k0, skv, kv_stride);
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t dq_launch(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int b, int sq, int skv,
                      int h, int kvh, float scale, int causal, cudaStream_t st) {
  cudaError_t err = prepare(flash_dq_kernel<D>, Lay<D>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + TILE - 1) / TILE, b * h);
  flash_dq_kernel<D><<<grid, THREADS, Lay<D>::BYTES, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), sq, skv, h, kvh, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int b, int sq,
                       int skv, int h, int kvh, float scale, int causal, cudaStream_t st) {
  cudaError_t err = prepare(flash_dkv_kernel<D>, Lay<D>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((skv + TILE - 1) / TILE, b * kvh);
  flash_dkv_kernel<D><<<grid, THREADS, Lay<D>::BYTES, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, skv,
      h, kvh, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq: [b, sq, h, d] bf16; k, v: [b, skv, kvh, d] bf16; lse, delta:
// [b, h, sq] fp32; all contiguous on the device. d must be 64 or 128 and h a
// multiple of kvh. Returns the launch's cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int b, int sq,
                            int skv, int h, int kvh, int d, float scale, int causal,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0) return 0;
  if (d == 64) return dq_launch<64>(q, k, v, dout, lse, delta, dq, b, sq, skv, h, kvh, scale, causal, st);
  if (d == 128) return dq_launch<128>(q, k, v, dout, lse, delta, dq, b, sq, skv, h, kvh, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The same operands; dk, dv: [b, skv, kvh, d] bf16, each written once (the
// group's q heads summed in fp32 inside the block).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int b,
                             int sq, int skv, int h, int kvh, int d, float scale, int causal,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || skv <= 0) return 0;
  if (d == 64) return dkv_launch<64>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, h, kvh, scale, causal, st);
  if (d == 128) return dkv_launch<128>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, h, kvh, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
