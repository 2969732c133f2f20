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
// (4 * S^2 * D per head forward, 10 * S^2 * D backward), so device memory
// bounds both directions: 0.0462 ms for the backward at q/k/v[64,197,12,64].
//
// Forward design (row 12). The TPU kernel held a whole S x S fp32 score
// tile per program (155 KB at S = 197; K/V of one head at S = 1024 would
// already exceed the card's 227 KB of shared memory), so here every block
// owns a 64-row query tile and walks the keys in 64-row chunks staged in
// shared memory, with bf16 WMMA (fp32 accumulation) for every product;
// tails past S are masked. It walks the keys twice: once for the row
// maximum, once for e = exp2(s - m) with the final maximum, so e is rounded
// to bf16 exactly as the TPU kernel rounds it (an online softmax would
// round it against a running maximum).
//
// Backward design (row 13): two kernels, no atomics, so two runs give the
// same bits. Each block is one consumer warpgroup (128 threads) and one
// producer warp whose first thread issues TMA copies: 4-D tensor maps
// (head_dim, heads, seq, batch) over the [B, S, H, D] tensors, one
// 128-byte-swizzled box per 64-column chunk of a 64-row tile; rows past S
// read as zeros and stores past S are clipped. Loads run ahead of the math
// through a ring of slots with full and empty mbarriers. Every product is
// a wgmma with fp32 sums in registers: S, dP, e, ds and the dq / dk / dv
// sums never pass through shared memory.
// - Kernel A (fused_bwd_dq_kernel), one 64-query tile: pass 1 streams the
//   visible 64-key chunks of K and keeps the row max m and sum z online
//   (S = Q K^T by wgmma m64n64k16 from shared memory); then delta =
//   rowsum(dO * O) in fp32 and dO / z rounded to bf16 once per query row,
//   staged over O's tile and stored by TMA into the scratch, and m, ln2 / z
//   and delta into the stats; pass 2 streams K and V again: S and dP =
//   dO V^T by wgmma (two groups: e = exp2(s - m) against the final m is
//   computed while dP is in flight), ds in registers, converted to bf16 in
//   place (the accumulator layout is the A-operand layout), and dq += ds K
//   by wgmma with ds from registers and K read MN-major.
// - Kernel B (fused_bwd_dkv_kernel), one 64-key tile: K and V once, then
//   the query chunks that see it (Q, dO, dO / z and their statistics), 32
//   query rows a step at head_dim 64 and 64 at 128: S^T = K Q^T and dP^T =
//   V dO^T with the keys as rows, so e and ds come out with the keys as the
//   M side and feed dv += e^T (dO / z) and dk += ds^T Q straight from
//   registers; e and dv's product run while dP^T is in flight.
// Products per (64 x 64) tile pair: 4 on the query side (S twice, dP, dq),
// 4 on the key side (S^T, dP^T, dv, dk): 8, against 9 plus a row-max pass
// of S in the WMMA version this replaces (the TPU kernel's 5 on a whole
// S x S tile). Causal tiles wholly above the diagonal are never loaded;
// tiles that hold a hidden or out-of-range pair are masked. Each tile's
// dq, dk and dv are staged as bf16 over a tile the block no longer reads
// and stored by TMA.
// What holds it back is latency, not the tensor cores or the bytes: each
// warpgroup runs one chain (wait for a tile, wgmma, wait, exp2 and FMAs,
// wgmma, wait), so time falls with the warpgroups resident on an SM. At
// head_dim 64 three blocks fit (shared memory: kernel A 24 KB of Q / dO /
// O and 3 (K, V) slots of 16 KB, 73 KB with barriers and slack; kernel B
// 16 KB of K / V and 2 slots of (Q, dO, dO / z, stats) of 24.75 KB, 67 KB;
// registers at most 136 a thread, which kernel B's 32-row steps keep). At
// 128 one block fits (kernel A 113 KB, kernel B 131 KB). Issuing the next
// chunk's products before this chunk's last one is waited for needs more
// registers than three blocks leave, and ptxas then serializes the wgmmas;
// persistent blocks gained less than the third block did.
// Registers (ptxas -v): kernel A 122 at head_dim 64, 154 at 128; kernel B
// 128 and 238; no spills.

#include <mma.h>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

using namespace hopper;

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
// of the forward). Returns NEG_INF for a row with none.
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

// --------------------------------------------------------------------- //
// backward (row 13): TMA-fed tiles, wgmma, everything else in registers
// --------------------------------------------------------------------- //

constexpr int BT = TILE_ROWS;      // rows of every backward tile (queries or keys)
constexpr int BWD_THREADS = 160;   // one consumer warpgroup, then one producer warp

template <int D>
struct Bwd {
  static constexpr int TILE = BT * D * 2;          // one 64-row tile (D / 64 chunks of 8 KB)
  static constexpr int STAT_BYTES = 3 * BT * 4;    // m, ln2 / z, delta of 64 queries
  // blocks per SM, set by shared memory at head_dim 64 (and registers: at
  // most 136 a thread for three blocks of 160 threads)
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 1;
  // query rows per step of kernel B: 32 at head_dim 64 keeps its registers
  // under that bound, 64 at 128 (one block per SM either way)
  static constexpr int QW = D == 64 ? 32 : 64;
  // kernel A: Q, dO, O (then dO / z), and a ring of (K, V) slots
  static constexpr int A_STAGES = D == 64 ? 3 : 2;
  static constexpr int A_RING = 3 * TILE;
  static constexpr int A_BAR = A_RING + A_STAGES * 2 * TILE;
  static constexpr int A_SMEM = A_BAR + 8 * (1 + 2 * A_STAGES) + 1024;  // + alignment slack
  // kernel B: K, V, and a ring of (Q, dO, dO / z) slots with their stats
  static constexpr int B_STAGES = 2;
  static constexpr int B_RING = 2 * TILE;
  static constexpr int B_STAT = B_RING + B_STAGES * 3 * TILE;
  static constexpr int B_BAR = B_STAT + B_STAGES * STAT_BYTES;
  static constexpr int B_SMEM = B_BAR + 8 * (1 + 2 * B_STAGES) + 1024;
};

// some (query, key) pair of the (q0, k0) tile pair is hidden (causal) or
// past the sequence
__device__ __forceinline__ bool needs_mask(int q0, int k0, int len, int causal) {
  return q0 + BT > len || k0 + BT > len || (causal && k0 + BT - 1 > q0);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Kernel A: one 64-query tile of one (batch, head). Pass 1 streams the
// visible 64-key chunks of K for the row max m and sum z (online). Then
// delta = rowsum(dO * O) and dO / z (bf16, stored by TMA into the scratch
// for kernel B), and m, ln2 / z and delta into the stats. Pass 2 streams K
// and V again: S = Q K^T and dP = dO V^T, ds in registers, dq += ds K.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, Bwd<D>::MIN_BLOCKS)
fused_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap o_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap don_map,
                    const __grid_constant__ CUtensorMap dq_map, float* __restrict__ stats,
                    int len, int len_pad, int heads, int causal) {
  using C = Bwd<D>;
  constexpr int ST = C::A_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + C::TILE, o_s = base + 2 * C::TILE;
  const uint32_t ring = base + C::A_RING;       // slot s: K, then V
  const uint32_t in_full = base + C::A_BAR;     // then full[ST], empty[ST]
  auto full = [&](int s) { return in_full + 8 * (1 + s); };
  auto empty = [&](int s) { return in_full + 8 * (1 + ST + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // longest causal tiles first
  const int bh = blockIdx.y, b = bh / heads, head = bh % heads;
  const int n_chunks = ((causal ? min(len, q0 + BT) : len) + BT - 1) / BT;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(in_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---------------- producer: one thread issues every load ----------------
    if (tid == 128) {
      mbar_expect_tx(in_full, 3 * C::TILE);
      load_rows<D>(q_s, &q_map, in_full, head, q0, b);
      load_rows<D>(do_s, &do_map, in_full, head, q0, b);
      load_rows<D>(o_s, &o_map, in_full, head, q0, b);
      for (int it = 0; it < 2 * n_chunks; ++it) {
        const int s = it % ST;
        const bool pass2 = it >= n_chunks;
        const int k0 = (pass2 ? it - n_chunks : it) * BT;
        if (it >= ST) mbar_wait(empty(s), ((it / ST) - 1) & 1);
        mbar_expect_tx(full(s), (pass2 ? 2 : 1) * C::TILE);
        load_rows<D>(ring + s * 2 * C::TILE, &k_map, full(s), head, k0, b);
        if (pass2) load_rows<D>(ring + s * 2 * C::TILE + C::TILE, &v_map, full(s), head, k0, b);
      }
    }
    return;
  }

  // ---------------- consumer warpgroup ----------------
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int col_lane = 2 * (lane % 4);        // its first column of each 8
  const int qp[2] = {q0 + r0, q0 + r0 + 8};
  mbar_wait(in_full, 0);

  // pass 1: m and z, online over the key chunks
  float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f};
  for (int j = 0; j < n_chunks; ++j) {
    const int s = j % ST, k0 = j * BT;
    mbar_wait(full(s), (j / ST) & 1);
    float sc[32];
    wgmma_fence();
    issue_abt<D, BT>(sc, q_s, ring + s * 2 * C::TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(empty(s));
    if (needs_mask(q0, k0, len, causal)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (!visible(qp[(i >> 1) & 1], k0 + (i / 4) * 8 + col_lane + (i & 1), len, causal)) {
          sc[i] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY}, mu[2];
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      mu[h] = mn == -INFINITY ? 0.f : mn;  // nothing visible yet: e = 0
      z[h] *= ex2(m[h] - mu[h]);
      m[h] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) z[(i >> 1) & 1] += ex2(sc[i] - mu[(i >> 1) & 1]);
  }

  // delta = rowsum(dO * O); dO / z over O's tile; the rows' statistics
  float mu[2], cz[2], zz[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    z[h] = quad_sum(z[h]);
    mu[h] = m[h] == -INFINITY ? 0.f : m[h];
    cz[h] = z[h] > 0.f ? LN2 / z[h] : 0.f;  // rows past the sequence see nothing
    zz[h] = z[h] > 0.f ? z[h] : 1.f;
  }
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = tile_off(r0 + 8 * h, g * 8 + col_lane);
      const float2 ov = unpack_bf16(ld_shared_b32(o_s + off));
      const float2 dv = unpack_bf16(ld_shared_b32(do_s + off));
      dl[h] += dv.x * ov.x + dv.y * ov.y;
      st_shared_b32(o_s + off, pack_bf16(dv.x / zz[h], dv.y / zz[h]));
    }
  }
  dl[0] = quad_sum(dl[0]);
  dl[1] = quad_sum(dl[1]);
  if (lane % 4 == 0) {
    const size_t plane = (size_t)gridDim.y * len_pad;
    float* row = stats + (size_t)bh * len_pad + q0 + r0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[8 * h] = mu[h];
      row[plane + 8 * h] = cz[h];
      row[2 * plane + 8 * h] = dl[h];
    }
  }
  fence_async_shared();
  bar_sync(1, 128);
  if (tid == 0) {
    store_rows<D>(&don_map, o_s, head, q0, b);
    bulk_commit();
  }

  // pass 2: ds = bf16(e (dp - delta) ln2 / z), dq += ds K
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  for (int j = 0; j < n_chunks; ++j) {
    const int it = n_chunks + j, s = it % ST, k0 = j * BT;
    const uint32_t ks = ring + s * 2 * C::TILE;
    mbar_wait(full(s), (it / ST) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    issue_abt<D, BT>(sc, q_s, ks);
    wgmma_commit();
    issue_abt<D, BT>(dp, do_s, ks + C::TILE);
    wgmma_commit();
    wgmma_wait<1>();  // S; e while dP is in flight
    fence_regs(sc);
    const bool mask = needs_mask(q0, k0, len, causal);
    float e[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const bool ok = !mask || visible(qp[h], k0 + (i / 4) * 8 + col_lane + (i & 1), len, causal);
      e[i] = ok ? ex2(sc[i] - mu[h]) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t ds[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      ds[i / 2] = pack_bf16((e[i] * (dp[i] - dl[h])) * cz[h],
                            (e[i + 1] * (dp[i + 1] - dl[h])) * cz[h]);
    }
    fence_regs(dq);
    fence_regs(ds);
    wgmma_fence();
    issue_ab<D, BT>(dq, ds, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(ds);
    mbar_arrive(empty(s));
  }

  // epilogue: dq through the q tile (every wgmma that read it is done)
  bar_sync(1, 128);
  stage_rows<D>(q_s, dq, r0, col_lane);
  fence_async_shared();
  bar_sync(1, 128);
  if (tid == 0) {
    store_rows<D>(&dq_map, q_s, head, q0, b);
    bulk_commit();
    bulk_wait_read();
  }
}

// Kernel B: one 64-key tile of one (batch, head). Streams the query chunks
// that see it (Q, dO, dO / z and their m, ln2 / z, delta from kernel A):
// S^T = K Q^T and dP^T = V dO^T with the keys as rows, e and ds in
// registers as the A operand, dv += e^T (dO / z), dk += ds^T Q.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, Bwd<D>::MIN_BLOCKS)
fused_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap don_map,
                     const __grid_constant__ CUtensorMap dk_map,
                     const __grid_constant__ CUtensorMap dv_map,
                     const float* __restrict__ stats, int len, int len_pad, int heads,
                     int causal) {
  using C = Bwd<D>;
  constexpr int ST = C::B_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* stat_s = reinterpret_cast<const float*>(smem_raw + (base - raw) + C::B_STAT);
  const uint32_t k_s = base, v_s = base + C::TILE;
  const uint32_t in_full = base + C::B_BAR;     // then full[ST], empty[ST]
  auto slot = [&](int s) { return base + C::B_RING + s * 3 * C::TILE; };  // Q, dO, dO / z
  auto full = [&](int s) { return in_full + 8 * (1 + s); };
  auto empty = [&](int s) { return in_full + 8 * (1 + ST + s); };

  const int k0 = (gridDim.x - 1 - blockIdx.x) * BT;  // longest causal tiles first
  const int bh = blockIdx.y, b = bh / heads, head = bh % heads;
  const int i_lo = causal ? k0 / BT : 0;             // the first query chunk that sees it
  const int n_q = (len + BT - 1) / BT - i_lo;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(in_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---------------- producer: one thread issues every load ----------------
    if (tid == 128) {
      mbar_expect_tx(in_full, 2 * C::TILE);
      load_rows<D>(k_s, &k_map, in_full, head, k0, b);
      load_rows<D>(v_s, &v_map, in_full, head, k0, b);
      const size_t plane = (size_t)gridDim.y * len_pad;
      for (int it = 0; it < n_q; ++it) {
        const int s = it % ST, q0 = (i_lo + it) * BT;
        if (it >= ST) mbar_wait(empty(s), ((it / ST) - 1) & 1);
        mbar_expect_tx(full(s), 3 * C::TILE + C::STAT_BYTES);
        load_rows<D>(slot(s), &q_map, full(s), head, q0, b);
        load_rows<D>(slot(s) + C::TILE, &do_map, full(s), head, q0, b);
        load_rows<D>(slot(s) + 2 * C::TILE, &don_map, full(s), head, q0, b);
        const float* src = stats + (size_t)bh * len_pad + q0;
        const uint32_t dst = base + C::B_STAT + s * C::STAT_BYTES;
#pragma unroll
        for (int t = 0; t < 3; ++t) bulk_load(dst + t * BT * 4, src + t * plane, BT * 4, full(s));
      }
    }
    return;
  }

  // ---------------- consumer warpgroup ----------------
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's key rows: r0 and r0 + 8
  const int col_lane = 2 * (lane % 4);
  const int kp[2] = {k0 + r0, k0 + r0 + 8};
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(in_full, 0);
  for (int it = 0; it < n_q; ++it) {
    const int s = it % ST, q0 = (i_lo + it) * BT;
    const float* stat = stat_s + s * (C::STAT_BYTES / 4);  // m | ln2 / z | delta
    mbar_wait(full(s), (it / ST) & 1);
#pragma unroll 1
    for (int hq = 0; hq < BT; hq += C::QW) {  // QW query rows a step
      constexpr int QW = C::QW;
      const int qh = q0 + hq;
      const uint32_t qrow = slot(s) + hq * ROW_BYTES;
      const float* hs = stat + hq;
      float st[QW / 2], dpt[QW / 2];
      wgmma_fence();
      issue_abt<D, QW>(st, k_s, qrow);               // S^T = K Q^T
      wgmma_commit();
      issue_abt<D, QW>(dpt, v_s, qrow + C::TILE);    // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<1>();  // S^T; e and dv's product while dP^T is in flight
      fence_regs(st);
      const bool mask = needs_mask(qh, k0, len, causal);
      float e[QW / 2];
      uint32_t ea[QW / 4], da[QW / 4];
#pragma unroll
      for (int i = 0; i < QW / 2; ++i) {
        const int c = (i / 4) * 8 + col_lane + (i & 1);  // the query column in this step
        const bool ok = !mask || visible(qh + c, kp[(i >> 1) & 1], len, causal);
        e[i] = ok ? ex2(st[i] - hs[c]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < QW / 2; i += 2) ea[i / 2] = pack_bf16(e[i], e[i + 1]);
      fence_regs(dv);
      fence_regs(ea);
      wgmma_fence();
      issue_ab<D, QW>(dv, ea, qrow + 2 * C::TILE);  // dv += e^T (dO / z)
      wgmma_commit();
      wgmma_wait<1>();  // dP^T
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < QW / 2; i += 2) {
        const int c = (i / 4) * 8 + col_lane;
        da[i / 2] = pack_bf16((e[i] * (dpt[i] - hs[2 * BT + c])) * hs[BT + c],
                              (e[i + 1] * (dpt[i + 1] - hs[2 * BT + c + 1])) * hs[BT + c + 1]);
      }
      fence_regs(dk);
      fence_regs(da);
      wgmma_fence();
      issue_ab<D, QW>(dk, da, qrow);                // dk += ds^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(ea);
      fence_regs(da);
    }
    mbar_arrive(empty(s));
  }

  // epilogue: dk and dv through the K and V tiles (their wgmmas are done)
  bar_sync(1, 128);
  stage_rows<D>(k_s, dk, r0, col_lane);
  stage_rows<D>(v_s, dv, r0, col_lane);
  fence_async_shared();
  bar_sync(1, 128);
  if (tid == 0) {
    store_rows<D>(&dk_map, k_s, head, k0, b);
    store_rows<D>(&dv_map, v_s, head, k0, b);
    bulk_commit();
    bulk_wait_read();
  }
}

// --------------------------------------------------------------------- //
// host side
// --------------------------------------------------------------------- //

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
                const void* dout, void* dq, void* dk, void* dv, void* scratch, int b,
                int len, int heads, int causal, cudaStream_t st) {
  const int tiles = (len + BT - 1) / BT, len_pad = tiles * BT;
  float* stats = static_cast<float*>(scratch);
  void* don = stats + (size_t)3 * b * heads * len_pad;
  const void* bases[9] = {q, k, v, o, dout, don, dq, dk, dv};
  for (const void* p : bases) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;  // TMA
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap maps[9];  // q, k, v, o, do, dO / z, dq, dk, dv
  for (int i = 0; i < 9; ++i) {
    if (!make_map(encode, &maps[i], bases[i], D, heads, len, b, BT)) return cudaErrorInvalidValue;
  }
  cudaError_t err = prepare(fused_bwd_dq_kernel<D>, Bwd<D>::A_SMEM);
  if (err != cudaSuccess) return err;
  err = prepare(fused_bwd_dkv_kernel<D>, Bwd<D>::B_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, b * heads);
  fused_bwd_dq_kernel<D><<<grid, BWD_THREADS, Bwd<D>::A_SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], stats, len, len_pad,
      heads, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_bwd_dkv_kernel<D><<<grid, BWD_THREADS, Bwd<D>::B_SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[4], maps[5], maps[7], maps[8], stats, len, len_pad,
      heads, causal);
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
// dk, dv are [b, len, heads, d] bf16 contiguous, 16-byte aligned; scratch
// holds 3 * b * heads * len_pad floats (m, ln2 / z, delta per query row;
// len_pad = len rounded up to 64) and then b * len * heads * d bf16 (dO /
// z). Launches kernel A then kernel B on `stream`.
extern "C" int fused_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, void* dq, void* dk,
                                   void* dv, void* scratch, int b, int len, int heads,
                                   int d, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || len <= 0) return 0;
  if (d == 64) return bwd<64>(q, k, v, o, dout, dq, dk, dv, scratch, b, len, heads, causal, st);
  if (d == 128) return bwd<128>(q, k, v, o, dout, dq, dk, dv, scratch, b, len, heads, causal, st);
  return (int)cudaErrorInvalidValue;
}
