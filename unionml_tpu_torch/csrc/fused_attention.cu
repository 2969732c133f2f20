// Fused short-sequence attention for Hopper (sm_90a): forward and backward.
//
// Replaces: unionml_tpu/ops/fused_attention.py::_fwd_kernel (via _fwd_bhsd)
// and ::_bwd_kernel (via _bwd_bhsd), the ViT/BERT attention of
// attn_impl="fused" for sequences of at most 1024 tokens.
//
// What they compute, per (batch, head), with q already multiplied by
// scale * log2(e) by the caller (so scores are in log2 space):
//   forward   s = q k^T (fp32), causal mask, m = rowmax(s), e = exp2(s - m),
//             z = rowsum(e), o = (bf16(e) v) / z;
//   backward  dv = bf16(e)^T bf16(do / z), delta = rowsum(do * o),
//             dp = do v^T, ds = bf16(e * (dp - delta) * (ln2 / z)),
//             dq = ds k, dk = ds^T q,
// with every product accumulated in fp32 and rounded to bf16 where the TPU
// kernel rounds (e before P.V, do / z and ds before their products).
//
// Bound on the H100: at the ViT-B shape (S = 197, head_dim 64) the bytes of
// q, k, v, o (and do, dq, dk, dv) outweigh the tensor-core operations
// (4 * S^2 * D per head forward), so device memory bounds both directions.
//
// Design. The TPU kernel held a whole S x S fp32 score tile per program
// (155 KB at S = 197; K/V of one head at S = 1024 would already exceed the
// card's 227 KB of shared memory), so here every block owns a 64-row tile
// and walks the other side in 64-row chunks staged in shared memory, with
// bf16 WMMA (fp32 accumulation) for every product; tails past S are masked.
// The forward walks the keys twice: once for the row maximum, once for
// e = exp2(s - m) with the final maximum, so e is rounded to bf16 exactly
// as the TPU kernel rounds it (an online softmax would round it against a
// running maximum). The backward has no atomics: kernel A walks the keys
// for one query tile (row maximum, then z, then dq), writing m, z and delta
// to a scratch buffer; kernel B walks the queries for one key tile and
// accumulates dk and dv from those statistics. Both recompute e from the
// scores, so two runs give the same bits. q/k/v/o keep the [B, S, H, D]
// layout; a block reads its head with a row stride of H * D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE = 64;          // query tile and key chunk
constexpr int WARPS = 4;          // 16 rows each
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int LDS = TILE + 4;     // fp32 64-wide tiles
constexpr int LDP = TILE + 8;     // bf16 64-wide tiles

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

template <int D>
struct Dims {
  static constexpr int LDH = D + 8;  // bf16 [64, D] tiles
  static constexpr int LDO = D + 4;  // fp32 [64, D] accumulators
  static constexpr size_t H = (size_t)TILE * LDH * 2;
  static constexpr size_t S = (size_t)TILE * LDS * 4;
  static constexpr size_t P = (size_t)TILE * LDP * 2;
  static constexpr size_t O = (size_t)TILE * LDO * 4;
  static constexpr size_t STATS = (size_t)TILE * 4 * 4;
  static constexpr size_t FWD = 3 * H + S + P + O + STATS;       // Q K V | S | P | O
  static constexpr size_t BWD_Q = 4 * H + 2 * S + P + O + STATS; // Q dO K V | S dP | dS | dQ
  static constexpr size_t BWD_KV = 5 * H + 2 * S + 2 * P + 2 * O + STATS;
};

// rows [start, start + 64) of a [B, S, H, D] tensor's (b, head) slice into a
// [64, LDH] bf16 tile; rows at or past `len` are zero
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int start,
                                          int len, size_t stride) {
  constexpr int CHUNKS = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 v = zero;
    if (start + r < len) v = *reinterpret_cast<const uint4*>(base + (start + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Dims<D>::LDH + c) = v;
  }
}

// out[16, 64] (fp32, ld LDS) = A[16, D] (fragments) . B[64, D]^T (bf16 tile)
template <int D>
__device__ __forceinline__ void slab_abt(const FragA* a, const bf16* b, float* out) {
#pragma unroll
  for (int n = 0; n < TILE / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBT bf;
      wmma::load_matrix_sync(bf, b + n * 16 * Dims<D>::LDH + kk * 16, Dims<D>::LDH);
      wmma::mma_sync(acc, a[kk], bf, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[16, D] (fp32 smem, ld LDO) += A[16, 64] (bf16 smem, ld LDP) . B[64, D]
template <int D>
__device__ __forceinline__ void slab_acc(float* acc, const bf16* a, const bf16* b) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    FragC c;
    wmma::load_matrix_sync(c, acc + n * 16, Dims<D>::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      FragA af;
      FragB bf;
      wmma::load_matrix_sync(af, a + kk * 16, LDP);
      wmma::load_matrix_sync(bf, b + kk * 16 * Dims<D>::LDH + n * 16, Dims<D>::LDH);
      wmma::mma_sync(c, af, bf, c);
    }
    wmma::store_matrix_sync(acc + n * 16, c, Dims<D>::LDO, wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void load_frags(FragA* f, const bf16* tile) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(f[kk], tile + warp * 16 * Dims<D>::LDH + kk * 16, Dims<D>::LDH);
  }
}

__device__ __forceinline__ bool visible(int q, int k, int len, int causal) {
  return q < len && k < len && (!causal || k <= q);
}

// The key range [0, hi) that a query tile starting at q0 may see.
__device__ __forceinline__ int key_end(int q0, int len, int causal) {
  return causal ? min(len, q0 + TILE) : len;
}

// Row maximum of this lane pair's query row over all visible keys (pass 1
// of both query-tile kernels). Returns NEG_INF for a row with none.
template <int D>
__device__ float row_max(const FragA* qf, bf16* Ks, float* Ss, const bf16* k_base,
                         size_t stride, int q0, int len, int causal, int row, int half) {
  const int warp = threadIdx.x >> 5;
  float m = NEG_INF;
  for (int k0 = 0; k0 < key_end(q0, len, causal); k0 += TILE) {
    load_tile<D>(Ks, k_base, k0, len, stride);
    __syncthreads();
    slab_abt<D>(qf, Ks, Ss + warp * 16 * LDS);
    __syncwarp();
    const float* srow = Ss + row * LDS + half * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      if (visible(q0 + row, k0 + half * 32 + j, len, causal)) m = fmaxf(m, srow[j]);
    }
    __syncthreads();
  }
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fused_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int len,
                 int heads, int causal) {
  using L = Dims<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::H);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * L::H);
  float* Ss = reinterpret_cast<float*>(smem + 3 * L::H);
  bf16* Ps = reinterpret_cast<bf16*>(smem + 3 * L::H + L::S);
  float* Os = reinterpret_cast<float*>(smem + 3 * L::H + L::S + L::P);
  float* Zs = reinterpret_cast<float*>(smem + 3 * L::H + L::S + L::P + L::O);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;  // longest causal tiles first
  const int b = blockIdx.y / heads, head = blockIdx.y % heads;
  const size_t stride = (size_t)heads * D;
  const size_t off = ((size_t)b * len * heads + head) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1), half = lane & 1;

  load_tile<D>(Qs, q + off, q0, len, stride);
  for (int i = threadIdx.x; i < TILE * L::LDO; i += THREADS) Os[i] = 0.f;
  __syncthreads();
  FragA qf[D / 16];
  load_frags<D>(qf, Qs);

  const float m = row_max<D>(qf, Ks, Ss, k + off, stride, q0, len, causal, row, half);
  const float m_safe = m == NEG_INF ? 0.f : m;
  float z = 0.f;
  for (int k0 = 0; k0 < key_end(q0, len, causal); k0 += TILE) {
    load_tile<D>(Ks, k + off, k0, len, stride);
    load_tile<D>(Vs, v + off, k0, len, stride);
    __syncthreads();
    slab_abt<D>(qf, Ks, Ss + warp * 16 * LDS);
    __syncwarp();
    const float* srow = Ss + row * LDS + half * 32;
    bf16* prow = Ps + row * LDP + half * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float e = visible(q0 + row, k0 + half * 32 + j, len, causal)
                          ? exp2f(srow[j] - m_safe) : 0.f;
      z += e;
      prow[j] = __float2bfloat16(e);
    }
    __syncwarp();
    slab_acc<D>(Os + warp * 16 * L::LDO, Ps + warp * 16 * LDP, Vs);
    __syncthreads();
  }
  z += __shfl_xor_sync(0xffffffffu, z, 1);
  if (half == 0) Zs[row] = z;
  __syncthreads();
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    if (q0 + r >= len) continue;
    const float zr = fmaxf(Zs[r], 1e-30f);
    alignas(16) bf16 out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = __float2bfloat16(Os[r * L::LDO + c + j] / zr);
    *reinterpret_cast<uint4*>(o + off + (q0 + r) * stride + c) =
        *reinterpret_cast<const uint4*>(out);
  }
}

// Backward, kernel A: one query tile. Writes m, z, delta for its rows into
// stats [3, B*H, S] and dq for its rows.
template <int D>
__global__ void __launch_bounds__(THREADS)
fused_bwd_q_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ o,
                   const bf16* __restrict__ dout, bf16* __restrict__ dq,
                   float* __restrict__ stats, int len, int heads, int causal) {
  using L = Dims<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::H);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * L::H);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * L::H);
  float* Ss = reinterpret_cast<float*>(smem + 4 * L::H);
  float* dPs = reinterpret_cast<float*>(smem + 4 * L::H + L::S);
  bf16* DSs = reinterpret_cast<bf16*>(smem + 4 * L::H + 2 * L::S);
  float* dQs = reinterpret_cast<float*>(smem + 4 * L::H + 2 * L::S + L::P);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int b = blockIdx.y / heads, head = blockIdx.y % heads;
  const size_t stride = (size_t)heads * D;
  const size_t off = ((size_t)b * len * heads + head) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int qi = q0 + row;

  load_tile<D>(Qs, q + off, q0, len, stride);
  load_tile<D>(dOs, dout + off, q0, len, stride);
  for (int i = threadIdx.x; i < TILE * L::LDO; i += THREADS) dQs[i] = 0.f;
  // delta = rowsum(do * o) over this lane's half of the head dim
  float delta = 0.f;
  if (qi < len) {
    const bf16* orow = o + off + qi * stride + half * (D / 2);
    const bf16* drow = dout + off + qi * stride + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) delta += __bfloat162float(drow[c]) * __bfloat162float(orow[c]);
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  __syncthreads();
  FragA qf[D / 16], df[D / 16];
  load_frags<D>(qf, Qs);
  load_frags<D>(df, dOs);

  const float m = row_max<D>(qf, Ks, Ss, k + off, stride, q0, len, causal, row, half);
  const float m_safe = m == NEG_INF ? 0.f : m;
  float z = 0.f;
  for (int k0 = 0; k0 < key_end(q0, len, causal); k0 += TILE) {
    load_tile<D>(Ks, k + off, k0, len, stride);
    __syncthreads();
    slab_abt<D>(qf, Ks, Ss + warp * 16 * LDS);
    __syncwarp();
    const float* srow = Ss + row * LDS + half * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      if (visible(qi, k0 + half * 32 + j, len, causal)) z += exp2f(srow[j] - m_safe);
    }
    __syncthreads();
  }
  z += __shfl_xor_sync(0xffffffffu, z, 1);
  const size_t plane = (size_t)gridDim.y * len;
  if (half == 0 && qi < len) {
    const size_t at = (size_t)blockIdx.y * len + qi;
    stats[at] = m_safe;
    stats[plane + at] = z;
    stats[2 * plane + at] = delta;
  }
  const float cz = qi < len ? LN2 / z : 0.f;

  for (int k0 = 0; k0 < key_end(q0, len, causal); k0 += TILE) {
    load_tile<D>(Ks, k + off, k0, len, stride);
    load_tile<D>(Vs, v + off, k0, len, stride);
    __syncthreads();
    slab_abt<D>(qf, Ks, Ss + warp * 16 * LDS);
    slab_abt<D>(df, Vs, dPs + warp * 16 * LDS);
    __syncwarp();
    const float* srow = Ss + row * LDS + half * 32;
    const float* prow = dPs + row * LDS + half * 32;
    bf16* dsrow = DSs + row * LDP + half * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      float ds = 0.f;
      if (visible(qi, k0 + half * 32 + j, len, causal)) {
        const float e = exp2f(srow[j] - m_safe);
        ds = e * (prow[j] - delta) * cz;
      }
      dsrow[j] = __float2bfloat16(ds);
    }
    __syncwarp();
    slab_acc<D>(dQs + warp * 16 * L::LDO, DSs + warp * 16 * LDP, Ks);
    __syncthreads();
  }
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    if (q0 + r >= len) continue;
    alignas(16) bf16 out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = __float2bfloat16(dQs[r * L::LDO + c + j]);
    *reinterpret_cast<uint4*>(dq + off + (q0 + r) * stride + c) =
        *reinterpret_cast<const uint4*>(out);
  }
}

// Backward, kernel B: one key tile. Walks the query chunks that can see it,
// with the row statistics kernel A wrote, and accumulates dk and dv.
template <int D>
__global__ void __launch_bounds__(THREADS)
fused_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ stats, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int len, int heads, int causal) {
  using L = Dims<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::H);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * L::H);
  bf16* dOs = reinterpret_cast<bf16*>(smem + 3 * L::H);
  bf16* dOn = reinterpret_cast<bf16*>(smem + 4 * L::H);
  float* St = reinterpret_cast<float*>(smem + 5 * L::H);
  float* dPt = reinterpret_cast<float*>(smem + 5 * L::H + L::S);
  bf16* Et = reinterpret_cast<bf16*>(smem + 5 * L::H + 2 * L::S);
  bf16* DSt = reinterpret_cast<bf16*>(smem + 5 * L::H + 2 * L::S + L::P);
  float* dKs = reinterpret_cast<float*>(smem + 5 * L::H + 2 * L::S + 2 * L::P);
  float* dVs = reinterpret_cast<float*>(smem + 5 * L::H + 2 * L::S + 2 * L::P + L::O);
  float* Ms = reinterpret_cast<float*>(smem + 5 * L::H + 2 * L::S + 2 * L::P + 2 * L::O);
  float* Cz = Ms + TILE;   // ln2 / z
  float* Dl = Cz + TILE;   // delta
  float* Zs = Dl + TILE;   // z

  const int k0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int b = blockIdx.y / heads, head = blockIdx.y % heads;
  const size_t stride = (size_t)heads * D;
  const size_t off = ((size_t)b * len * heads + head) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int kj = k0 + row;
  const size_t plane = (size_t)gridDim.y * len;
  const float* m_row = stats + (size_t)blockIdx.y * len;

  load_tile<D>(Ks, k + off, k0, len, stride);
  load_tile<D>(Vs, v + off, k0, len, stride);
  for (int i = threadIdx.x; i < TILE * L::LDO; i += THREADS) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }
  __syncthreads();
  FragA kf[D / 16], vf[D / 16];
  load_frags<D>(kf, Ks);
  load_frags<D>(vf, Vs);

  constexpr int CHUNKS = D / 8;
  for (int q0 = causal ? k0 : 0; q0 < len; q0 += TILE) {
    load_tile<D>(Qs, q + off, q0, len, stride);
    load_tile<D>(dOs, dout + off, q0, len, stride);
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const bool ok = q0 + i < len;
      const float z = ok ? m_row[plane + q0 + i] : 1.f;
      Ms[i] = ok ? m_row[q0 + i] : 0.f;
      Zs[i] = z;
      Cz[i] = ok ? LN2 / z : 0.f;
      Dl[i] = ok ? m_row[2 * plane + q0 + i] : 0.f;
    }
    __syncthreads();
    // do / z rounded to bf16, the dv product's right-hand side
    for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const float zr = Zs[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dOn[r * L::LDH + c + j] =
            __float2bfloat16(__bfloat162float(dOs[r * L::LDH + c + j]) / zr);
      }
    }
    slab_abt<D>(kf, Qs, St + warp * 16 * LDS);
    slab_abt<D>(vf, dOs, dPt + warp * 16 * LDS);
    __syncwarp();
    const float* srow = St + row * LDS + half * 32;
    const float* prow = dPt + row * LDS + half * 32;
    bf16* erow = Et + row * LDP + half * 32;
    bf16* dsrow = DSt + row * LDP + half * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      float e = 0.f, ds = 0.f;
      if (visible(q0 + c, kj, len, causal)) {
        e = exp2f(srow[j] - Ms[c]);
        ds = e * (prow[j] - Dl[c]) * Cz[c];
      }
      erow[j] = __float2bfloat16(e);
      dsrow[j] = __float2bfloat16(ds);
    }
    __syncthreads();  // dOn complete; Et / DSt rows are this warp's own
    slab_acc<D>(dVs + warp * 16 * L::LDO, Et + warp * 16 * LDP, dOn);
    slab_acc<D>(dKs + warp * 16 * L::LDO, DSt + warp * 16 * LDP, Qs);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    if (k0 + r >= len) continue;
    alignas(16) bf16 ok[8], ov[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ok[j] = __float2bfloat16(dKs[r * L::LDO + c + j]);
      ov[j] = __float2bfloat16(dVs[r * L::LDO + c + j]);
    }
    *reinterpret_cast<uint4*>(dk + off + (k0 + r) * stride + c) = *reinterpret_cast<const uint4*>(ok);
    *reinterpret_cast<uint4*>(dv + off + (k0 + r) * stride + c) = *reinterpret_cast<const uint4*>(ov);
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, int b, int len,
                int heads, int causal, cudaStream_t st) {
  cudaError_t err = prepare(fused_fwd_kernel<D>, Dims<D>::FWD);
  if (err != cudaSuccess) return err;
  dim3 grid((len + TILE - 1) / TILE, b * heads);
  fused_fwd_kernel<D><<<grid, THREADS, Dims<D>::FWD, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), len, heads, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv, void* stats, int b,
                int len, int heads, int causal, cudaStream_t st) {
  cudaError_t err = prepare(fused_bwd_q_kernel<D>, Dims<D>::BWD_Q);
  if (err != cudaSuccess) return err;
  err = prepare(fused_bwd_kv_kernel<D>, Dims<D>::BWD_KV);
  if (err != cudaSuccess) return err;
  dim3 grid((len + TILE - 1) / TILE, b * heads);
  fused_bwd_q_kernel<D><<<grid, THREADS, Dims<D>::BWD_Q, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<float*>(stats), len, heads, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_bwd_kv_kernel<D><<<grid, THREADS, Dims<D>::BWD_KV, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(stats), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), len, heads, causal);
  return cudaGetLastError();
}

}  // namespace

// q (pre-scaled by scale * log2 e), k, v, o: [b, len, heads, d] bf16,
// contiguous; d is 64 or 128. Returns the launch's cudaError_t.
extern "C" int fused_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int b, int len, int heads, int d, int causal,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || len <= 0) return 0;
  if (d == 64) return fwd<64>(q, k, v, o, b, len, heads, causal, st);
  if (d == 128) return fwd<128>(q, k, v, o, b, len, heads, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of fused_attention_fwd: q, k, v, o, dout and the outputs dq,
// dk, dv are [b, len, heads, d] bf16 contiguous; stats is fp32 scratch of
// 3 * b * heads * len floats. Launches kernel A then kernel B on `stream`.
extern "C" int fused_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, void* dq, void* dk,
                                   void* dv, void* stats, int b, int len, int heads,
                                   int d, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || len <= 0) return 0;
  if (d == 64) return bwd<64>(q, k, v, o, dout, dq, dk, dv, stats, b, len, heads, causal, st);
  if (d == 128) return bwd<128>(q, k, v, o, dout, dq, dk, dv, stats, b, len, heads, causal, st);
  return (int)cudaErrorInvalidValue;
}
