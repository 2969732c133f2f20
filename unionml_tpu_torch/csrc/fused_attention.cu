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
//   backward  dv = bf16(e)^T bf16(do / z), dp = do v^T,
//             delta = rowsum(e * dp) / z, ds = bf16(e * (dp - delta) * (ln2 / z)),
//             dq = ds k, dk = ds^T q,
// with every product accumulated in fp32 and rounded to bf16 where the TPU
// kernel rounds (e before P.V, do / z and ds before their products). The TPU
// kernel takes delta = rowsum(do * o) from the bf16 output instead; where a
// row's value vectors are nearly equal (the last layers of a randomly
// initialised post-LN encoder) dp - delta cancels and o's rounding then
// outweighs what is left, so dq and dk lose their direction. The sum over
// e * dp is delta before any rounding, and the backward needs no o.
//
// Bound on the H100: at the ViT-B shape (S = 197, head_dim 64) the bytes of
// q, k, v, o (and q, k, v, do, dq, dk, dv) outweigh the tensor-core
// operations (4 * S^2 * D per head forward, 10 * S^2 * D backward), so
// device memory bounds both directions: 0.0231 ms for the forward and
// 0.0405 ms for the backward at q/k/v[64,197,12,64].
//
// Forward design (row 12). The TPU kernel held a whole S x S fp32 score
// tile per program (155 KB at S = 197); here every block owns a 64-row
// query tile of one (batch, head) and one consumer warpgroup (128 threads),
// fed by TMA through the backward's 4-D tensor maps (rows past S read as
// zeros). Every product is a wgmma with fp32 sums in registers; nothing but
// the operands passes through shared memory. e is rounded to bf16 against
// the FINAL row maximum, as the TPU kernel rounds it (an online softmax
// would round it against a running maximum), z sums the unrounded e, and O
// = bf16(e) V is normalised by z after the product (one reciprocal a row).
// - Resident (head_dim 64, S <= 256: ViT's 197): the whole score row of
//   the tile stays in registers, one m64n64 accumulator per full 64-key
//   chunk and an m64n16 one for a last chunk of at most 16 keys (ViT's 197
//   = 3 x 64 + 5: 208 scores a row instead of 256). The block's first
//   thread issues every load at once (Q, each K chunk, each V chunk on its
//   own barrier; no producer warp); S of all chunks by wgmma, the exact row
//   max from the registers, e converted to bf16 in place (the accumulator
//   layout is the A-operand layout) and O = e V by wgmma with A from
//   registers and V read MN-major. K is read once: 2 products per tile pair
//   instead of 3. Templated on the chunk count (1-4) and the last chunk's
//   width (16 or 64).
// - Two passes (S > 256, or head_dim 128): a producer warp streams the
//   visible K chunks through a ring of full / empty mbarrier slots for the
//   row max alone (pass 1), then K and V for S again, e and O += e V chunk
//   by chunk (pass 2), as kernel A of the backward does.
// O / z is staged as bf16 over the Q tile and stored by TMA, rows past S
// clipped. No atomics: two runs give the same bits.
// What holds it back: the exp2 of every score (one MUFU op each; at ViT-B
// the softmax phase is the longest of a block's life) and three warpgroups
// an SM (registers: 168 a thread in the resident form).
// Registers (ptxas -v), forward: resident <chunks, last width> <1, 16> 62,
// <1, 64> 88, <2, 16> 100, <2, 64> 136, <3, 16> 148, <3, 64> 168, <4, 16>
// 166 (ViT-B), <4, 64> 168 with 28 bytes of spill stores (193-256 keys:
// 128 score registers under the 168 that three blocks an SM leave); two
// passes 110 (head_dim 64) and 143 (128); no other spills.
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
//   visible 64-key chunks of K and V and keeps the row max m, the sum z and
//   the sum of e * dP online (S = Q K^T and dP = dO V^T by wgmma
//   m64n64k16 from shared memory); then delta = that sum / z in fp32 and
//   dO / z rounded to bf16 once per query row, staged in a tile of its own
//   and stored by TMA into the scratch, and m, ln2 / z and delta into the
//   stats; pass 2 streams K and V again: S and dP =
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
// Products per (64 x 64) tile pair: 5 on the query side (S and dP twice,
// dq), 4 on the key side (S^T, dP^T, dv, dk): 9, against 9 plus a row-max
// pass of S in the WMMA version this replaces (the TPU kernel's 5 on a
// whole S x S tile). Causal tiles wholly above the diagonal are never loaded;
// tiles that hold a hidden or out-of-range pair are masked. Each tile's
// dq, dk and dv are staged as bf16 over a tile the block no longer reads
// and stored by TMA.
// What holds it back is latency, not the tensor cores or the bytes: each
// warpgroup runs one chain (wait for a tile, wgmma, wait, exp2 and FMAs,
// wgmma, wait), so time falls with the warpgroups resident on an SM. At
// head_dim 64 three blocks fit (shared memory: kernel A 24 KB of Q / dO /
// dO / z and 3 (K, V) slots of 16 KB, 73 KB with barriers and slack; kernel B
// 16 KB of K / V and 2 slots of (Q, dO, dO / z, stats) of 24.75 KB, 67 KB;
// registers at most 136 a thread, which kernel B's 32-row steps keep). At
// 128 one block fits (kernel A 113 KB, kernel B 131 KB). Issuing the next
// chunk's products before this chunk's last one is waited for needs more
// registers than three blocks leave, and ptxas then serializes the wgmmas;
// persistent blocks gained less than the third block did.
// Registers (ptxas -v): kernel A 122 at head_dim 64, 154 at 128; kernel B
// 128 and 238; no spills.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BT = TILE_ROWS;   // rows of every tile (queries or keys)
constexpr int THREADS = 160;    // one consumer warpgroup, then one producer warp
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ bool visible(int q, int k, int len, int causal) {
  return q < len && k < len && (!causal || k <= q);
}

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

// scores of one 64 x N accumulator (this thread's rows r0 and r0 + 8) of
// the (q0, k0) tile pair: hidden and out-of-range pairs to -inf
template <int N>
__device__ __forceinline__ void mask_scores(float (&sc)[N / 2], int q0, int k0, int r0,
                                            int col_lane, int len, int causal) {
  if (!needs_mask(q0, k0, len, causal)) return;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int q = q0 + r0 + 8 * ((i >> 1) & 1);
    if (!visible(q, k0 + (i / 4) * 8 + col_lane + (i & 1), len, causal)) sc[i] = -INFINITY;
  }
}

// e = exp2(s - m) of one 64 x N accumulator against the rows' final maxima
// mu, summed unrounded into z and rounded to bf16 pairs in the A-operand
// layout of issue_ab
template <int N>
__device__ __forceinline__ void exp_pack(uint32_t (&ea)[N / 4], const float (&sc)[N / 2],
                                         const float (&mu)[2], float (&z)[2]) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const float e0 = ex2(sc[i] - mu[h]), e1 = ex2(sc[i + 1] - mu[h]);
    z[h] += e0 + e1;
    ea[i / 2] = pack_bf16(e0, e1);
  }
}

// O / z of one 64-query tile (this thread's rows r0 and r0 + 8) as bf16
// into `tile` (whose wgmma reads are done), then stored by TMA from the
// first thread (rows past the sequence clipped); rows that saw nothing (z
// = 0) are past the sequence
template <int D>
__device__ __forceinline__ void store_out(float (&o)[D / 2], const float (&z)[2], uint32_t tile,
                                          const CUtensorMap* o_map, int head, int q0, int b,
                                          int r0, int col_lane) {
  float zr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float zh = quad_sum(z[h]);
    zr[h] = zh > 0.f ? zh : 1.f;
  }
  // one division a row, then products: within an fp32 ulp of o / z before
  // the bf16 rounding (a division per value took a third of the time at
  // ViT-B)
  const float inv[2] = {1.f / zr[0], 1.f / zr[1]};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  bar_sync(1, 128);
  stage_rows<D>(tile, o, r0, col_lane);
  fence_async_shared();
  bar_sync(1, 128);
  if (threadIdx.x == 0) {
    store_rows<D>(o_map, tile, head, q0, b);
    bulk_commit();
  }
}

// Resident form: head_dim 64 and S <= 256 keys in NC chunks, the last TW
// wide (16 when it holds at most 16 keys, as ViT's 197 = 3 x 64 + 5 does,
// else 64). One CTA (one warpgroup, no producer warp) per 64-query tile:
// its first thread issues every load at once (the Q tile, every K chunk,
// every V chunk, each on its own barrier); S of all chunks in registers,
// the exact row max, e in place as bf16, O = e V, O / z stored over the Q
// tile. Three CTAs an SM (168 registers a thread).
template <int NC>
struct Res {
  static constexpr int D = 64;
  static constexpr int TILE = BT * D * 2;          // one 64-row tile, 8 KB
  static constexpr int K_OFF = TILE;               // Q (then O), K chunks, V chunks
  static constexpr int V_OFF = (1 + NC) * TILE;
  static constexpr int BAR = (1 + 2 * NC) * TILE;
  static constexpr int SMEM = BAR + 8 * (1 + 2 * NC) + 1024;  // + alignment slack
};

template <int NC, int TW>
__global__ void __launch_bounds__(128, 3)
fused_fwd_resident_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap o_map, int len, int heads,
                          int causal) {
  using C = Res<NC>;
  constexpr int D = C::D;
  constexpr int NF = NC - 1;  // full 64-key chunks before the last
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  auto k_tile = [&](int j) { return base + C::K_OFF + j * C::TILE; };
  auto v_tile = [&](int j) { return base + C::V_OFF + j * C::TILE; };
  const uint32_t q_full = base + C::BAR;
  auto k_full = [&](int j) { return q_full + 8 * (1 + j); };
  auto v_full = [&](int j) { return q_full + 8 * (1 + NC + j); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // longest causal tiles first
  const int bh = blockIdx.y, b = bh / heads, head = bh % heads;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * NC; ++i) mbar_init(q_full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_full, C::TILE);
    load_rows<D>(q_s, &q_map, q_full, head, q0, b);
    for (int j = 0; j < NC; ++j) {
      mbar_expect_tx(k_full(j), C::TILE);
      load_rows<D>(k_tile(j), &k_map, k_full(j), head, j * BT, b);
    }
    for (int j = 0; j < NC; ++j) {
      mbar_expect_tx(v_full(j), C::TILE);
      load_rows<D>(v_tile(j), &v_map, v_full(j), head, j * BT, b);
    }
  }

  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int col_lane = 2 * (lane % 4);        // its first column of each 8
  // S of every chunk (chunks a causal tile cannot see are masked whole)
  float sc[NF > 0 ? NF : 1][32], st[TW / 2];
  mbar_wait(q_full, 0);
#pragma unroll
  for (int j = 0; j < NC; ++j) mbar_wait(k_full(j), 0);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NF; ++j) issue_abt<D, BT>(sc[j], q_s, k_tile(j));
  issue_abt<D, TW>(st, q_s, k_tile(NF));
  wgmma_commit();
  wgmma_wait<0>();
  float mx[2] = {-INFINITY, -INFINITY}, mu[2], z[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    fence_regs(sc[j]);
    mask_scores<BT>(sc[j], q0, j * BT, r0, col_lane, len, causal);
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[j][i]);
  }
  fence_regs(st);
  mask_scores<TW>(st, q0, NF * BT, r0, col_lane, len, causal);
#pragma unroll
  for (int i = 0; i < TW / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], st[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m = quad_max(mx[h]);
    mu[h] = m == -INFINITY ? 0.f : m;  // nothing visible: e = 0
  }
  uint32_t ea[NF > 0 ? NF : 1][16], et[TW / 4];
#pragma unroll
  for (int j = 0; j < NF; ++j) exp_pack<BT>(ea[j], sc[j], mu, z);
  exp_pack<TW>(et, st, mu, z);
#pragma unroll
  for (int j = 0; j < NC; ++j) mbar_wait(v_full(j), 0);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < NF; ++j) fence_regs(ea[j]);
  fence_regs(et);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NF; ++j) issue_ab<D, BT>(o, ea[j], v_tile(j));
  issue_ab<D, TW>(o, et, v_tile(NF));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < NF; ++j) fence_regs(ea[j]);
  fence_regs(et);
  store_out<D>(o, z, q_s, &o_map, head, q0, b, r0, col_lane);
  if (tid == 0) bulk_wait_read();
}

// Two-pass form (S > 256, or head_dim 128): one 64-query tile of one
// (batch, head) a CTA, one consumer warpgroup and a producer warp that
// streams K chunks through a ring of full / empty slots for the row max
// (pass 1), then K and V for e and O += e V chunk by chunk (pass 2).
template <int D>
struct Fwd {
  static constexpr int TILE = BT * D * 2;          // one 64-row tile
  static constexpr int STAGES = D == 64 ? 3 : 2;   // (K, V) slots
  static constexpr int RING = TILE;                // after the Q tile
  static constexpr int BAR = RING + STAGES * 2 * TILE;
  static constexpr int SMEM = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  // blocks per SM, set by registers (at most 136 a thread for three) and
  // shared memory
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 2;
};

template <int D>
__global__ void __launch_bounds__(THREADS, Fwd<D>::MIN_BLOCKS)
fused_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap o_map, int len, int heads, int causal) {
  using C = Fwd<D>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  auto slot = [&](int s) { return base + C::RING + s * 2 * C::TILE; };  // K, then V
  const uint32_t in_full = base + C::BAR;     // then full[ST], empty[ST]
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
      mbar_expect_tx(in_full, C::TILE);
      load_rows<D>(q_s, &q_map, in_full, head, q0, b);
      for (int it = 0; it < 2 * n_chunks; ++it) {
        const int s = it % ST;
        const bool pass2 = it >= n_chunks;
        const int k0 = (pass2 ? it - n_chunks : it) * BT;
        if (it >= ST) mbar_wait(empty(s), ((it / ST) - 1) & 1);
        mbar_expect_tx(full(s), (pass2 ? 2 : 1) * C::TILE);
        load_rows<D>(slot(s), &k_map, full(s), head, k0, b);
        if (pass2) load_rows<D>(slot(s) + C::TILE, &v_map, full(s), head, k0, b);
      }
    }
    return;
  }

  // ---------------- consumer warpgroup ----------------
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int col_lane = 2 * (lane % 4);        // its first column of each 8
  mbar_wait(in_full, 0);

  // pass 1: the row max over the visible chunks
  float m[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < n_chunks; ++j) {
    const int s = j % ST;
    mbar_wait(full(s), (j / ST) & 1);
    float sc[32];
    wgmma_fence();
    issue_abt<D, BT>(sc, q_s, slot(s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(empty(s));
    mask_scores<BT>(sc, q0, j * BT, r0, col_lane, len, causal);
#pragma unroll
    for (int i = 0; i < 32; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], sc[i]);
  }
  float mu[2], z[2] = {0.f, 0.f}, o[D / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mh = quad_max(m[h]);
    mu[h] = mh == -INFINITY ? 0.f : mh;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // pass 2: S again, e against the final max, O += e V
  for (int j = 0; j < n_chunks; ++j) {
    const int it = n_chunks + j, s = it % ST;
    mbar_wait(full(s), (it / ST) & 1);
    float sc[32];
    wgmma_fence();
    issue_abt<D, BT>(sc, q_s, slot(s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mask_scores<BT>(sc, q0, j * BT, r0, col_lane, len, causal);
    uint32_t ea[16];
    exp_pack<BT>(ea, sc, mu, z);
    fence_regs(o);
    fence_regs(ea);
    wgmma_fence();
    issue_ab<D, BT>(o, ea, slot(s) + C::TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ea);
    mbar_arrive(empty(s));
  }
  store_out<D>(o, z, q_s, &o_map, head, q0, b, r0, col_lane);
  if (tid == 0) bulk_wait_read();
}

// --------------------------------------------------------------------- //
// backward (row 13): TMA-fed tiles, wgmma, everything else in registers
// --------------------------------------------------------------------- //

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
  // kernel A: Q, dO, dO / z, and a ring of (K, V) slots
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

// Kernel A: one 64-query tile of one (batch, head). Pass 1 streams the
// visible 64-key chunks of K and V for the row max m, the sum z and the
// sum of e * dP (online). Then delta = rowsum(e * dP) / z and dO / z (bf16,
// stored by TMA into the scratch for kernel B), and m, ln2 / z and delta
// into the stats. Pass 2 streams K and V again: S = Q K^T and dP = dO V^T,
// ds in registers, dq += ds K.
template <int D>
__global__ void __launch_bounds__(THREADS, Bwd<D>::MIN_BLOCKS)
fused_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap don_map,
                    const __grid_constant__ CUtensorMap dq_map, float* __restrict__ stats,
                    int len, int len_pad, int heads, int causal) {
  using C = Bwd<D>;
  constexpr int ST = C::A_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + C::TILE, don_s = base + 2 * C::TILE;
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
      mbar_expect_tx(in_full, 2 * C::TILE);
      load_rows<D>(q_s, &q_map, in_full, head, q0, b);
      load_rows<D>(do_s, &do_map, in_full, head, q0, b);
      for (int it = 0; it < 2 * n_chunks; ++it) {
        const int s = it % ST;
        const int k0 = (it < n_chunks ? it : it - n_chunks) * BT;
        if (it >= ST) mbar_wait(empty(s), ((it / ST) - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::TILE);
        load_rows<D>(ring + s * 2 * C::TILE, &k_map, full(s), head, k0, b);
        load_rows<D>(ring + s * 2 * C::TILE + C::TILE, &v_map, full(s), head, k0, b);
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

  // pass 1: m, z and the sum of e * dp, online over the key chunks
  float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  for (int j = 0; j < n_chunks; ++j) {
    const int s = j % ST, k0 = j * BT;
    const uint32_t ks = ring + s * 2 * C::TILE;
    mbar_wait(full(s), (j / ST) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    issue_abt<D, BT>(sc, q_s, ks);
    wgmma_commit();
    issue_abt<D, BT>(dp, do_s, ks + C::TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
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
      const float r = ex2(m[h] - mu[h]);
      z[h] *= r;
      dl[h] *= r;
      m[h] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float e = ex2(sc[i] - mu[h]);  // 0 where masked: dp there adds nothing
      z[h] += e;
      dl[h] += e * dp[i];
    }
  }

  // delta = rowsum(e * dp) / z; dO / z into its own tile; the rows' statistics
  float mu[2], cz[2], zz[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    z[h] = quad_sum(z[h]);
    dl[h] = quad_sum(dl[h]);
    mu[h] = m[h] == -INFINITY ? 0.f : m[h];
    cz[h] = z[h] > 0.f ? LN2 / z[h] : 0.f;  // rows past the sequence see nothing
    zz[h] = z[h] > 0.f ? z[h] : 1.f;
    dl[h] = dl[h] / zz[h];
  }
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = tile_off(r0 + 8 * h, g * 8 + col_lane);
      const float2 dv = unpack_bf16(ld_shared_b32(do_s + off));
      st_shared_b32(don_s + off, pack_bf16(dv.x / zz[h], dv.y / zz[h]));
    }
  }
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
    store_rows<D>(&don_map, don_s, head, q0, b);
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
__global__ void __launch_bounds__(THREADS, Bwd<D>::MIN_BLOCKS)
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

template <int NC, int TW>
cudaError_t fwd_resident(const CUtensorMap (&maps)[4], int b, int len, int heads, int causal,
                         cudaStream_t st) {
  cudaError_t err = prepare(fused_fwd_resident_kernel<NC, TW>, Res<NC>::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((len + BT - 1) / BT, b * heads);
  fused_fwd_resident_kernel<NC, TW><<<grid, 128, Res<NC>::SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], len, heads, causal);
  return cudaGetLastError();
}

template <int NC>
cudaError_t fwd_resident_tail(const CUtensorMap (&maps)[4], int b, int len, int heads,
                              int causal, cudaStream_t st) {
  // the last chunk's keys: at most 16 take a 16-wide product
  if (len - (NC - 1) * BT <= 16) return fwd_resident<NC, 16>(maps, b, len, heads, causal, st);
  return fwd_resident<NC, BT>(maps, b, len, heads, causal, st);
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, int b, int len,
                int heads, int causal, cudaStream_t st) {
  const void* bases[4] = {q, k, v, o};
  for (const void* p : bases) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;  // TMA
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap maps[4];  // q, k, v, o
  for (int i = 0; i < 4; ++i) {
    if (!make_map(encode, &maps[i], bases[i], D, heads, len, b, BT)) return cudaErrorInvalidValue;
  }
  if constexpr (D == 64) {
    switch ((len + BT - 1) / BT) {  // the key chunks a score row holds
      case 1: return fwd_resident_tail<1>(maps, b, len, heads, causal, st);
      case 2: return fwd_resident_tail<2>(maps, b, len, heads, causal, st);
      case 3: return fwd_resident_tail<3>(maps, b, len, heads, causal, st);
      case 4: return fwd_resident_tail<4>(maps, b, len, heads, causal, st);
      default: break;
    }
  }
  cudaError_t err = prepare(fused_fwd_kernel<D>, Fwd<D>::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((len + BT - 1) / BT, b * heads);
  fused_fwd_kernel<D><<<grid, THREADS, Fwd<D>::SMEM, st>>>(maps[0], maps[1], maps[2], maps[3],
                                                           len, heads, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                void* dk, void* dv, void* scratch, int b, int len, int heads, int causal,
                cudaStream_t st) {
  const int tiles = (len + BT - 1) / BT, len_pad = tiles * BT;
  float* stats = static_cast<float*>(scratch);
  void* don = stats + (size_t)3 * b * heads * len_pad;
  const void* bases[8] = {q, k, v, dout, don, dq, dk, dv};
  for (const void* p : bases) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;  // TMA
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap maps[8];  // q, k, v, do, dO / z, dq, dk, dv
  for (int i = 0; i < 8; ++i) {
    if (!make_map(encode, &maps[i], bases[i], D, heads, len, b, BT)) return cudaErrorInvalidValue;
  }
  cudaError_t err = prepare(fused_bwd_dq_kernel<D>, Bwd<D>::A_SMEM);
  if (err != cudaSuccess) return err;
  err = prepare(fused_bwd_dkv_kernel<D>, Bwd<D>::B_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, b * heads);
  fused_bwd_dq_kernel<D><<<grid, THREADS, Bwd<D>::A_SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], stats, len, len_pad, heads,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_bwd_dkv_kernel<D><<<grid, THREADS, Bwd<D>::B_SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[6], maps[7], stats, len, len_pad,
      heads, causal);
  return cudaGetLastError();
}

}  // namespace

// q (pre-scaled by scale * log2 e), k, v, o: [b, len, heads, d] bf16,
// contiguous, 16-byte aligned; d is 64 or 128. Returns the launch's
// cudaError_t.
extern "C" int fused_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int b, int len, int heads, int d, int causal,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || len <= 0) return 0;
  if (d == 64) return fwd<64>(q, k, v, o, b, len, heads, causal, st);
  if (d == 128) return fwd<128>(q, k, v, o, b, len, heads, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of fused_attention_fwd: q, k, v, dout and the outputs dq, dk,
// dv are [b, len, heads, d] bf16 contiguous, 16-byte aligned; scratch
// holds 3 * b * heads * len_pad floats (m, ln2 / z, delta per query row;
// len_pad = len rounded up to 64) and then b * len * heads * d bf16 (dO /
// z). Launches kernel A then kernel B on `stream`.
extern "C" int fused_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv,
                                   void* scratch, int b, int len, int heads, int d, int causal,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || len <= 0) return 0;
  if (d == 64) return bwd<64>(q, k, v, dout, dq, dk, dv, scratch, b, len, heads, causal, st);
  if (d == 128) return bwd<128>(q, k, v, dout, dq, dk, dv, scratch, b, len, heads, causal, st);
  return (int)cudaErrorInvalidValue;
}
