// FlashAttention-2 backward for Hopper (sm_90a), GQA-aware: a delta pass, a dq
// kernel and a dk/dv kernel.
//
// Replaces: unionml_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (both reached through _flash_bwd_bhsd -> pl.pallas_call), the backward of
// the differentiable flash_attention (attn_impl="flash", long-context
// training), and the XLA expression delta = rowsum(dO * O) before them
// (flash_attention.py:464).
//
// delta is the sum over a row's visible keys of p * dp, in fp32 from the
// backward's own p (the dq kernel in its DELTA mode: S and dP per tile, no
// third product, one sum per query row). The reference takes it from the
// bf16 output instead: where a row's value vectors are nearly equal, dp -
// delta cancels and O's rounding then turns dq and dk (deep blocks of a
// randomly initialised post-LN BERT, ROADMAP.md C7). The pass sums over the
// keys it is given with the lse it is given, so sums over shards of the keys
// under one global lse add up to the whole.
//
// What the dq and dk/dv kernels compute, per (batch, q head) with its kv
// head kvh = head / (H / KVH), from the forward's lse (natural log) and
// delta:
//   s  = q k^T * scale (fp32),   p = exp(s - lse) over the visible pairs,
//   dp = dO v^T (fp32),          ds = bf16(p * (dp - delta) * scale),
//   dq = ds k,   dv_head = bf16(bf16(p)^T dO),   dk_head = bf16(ds^T q),
// every product in bf16 with an fp32 sum, rounded where the TPU kernels
// round (p before p^T dO, ds before both of its products, each q head's dk
// and dv when its kernel writes them). The GQA group's heads are summed
// afterwards by the caller (fp32, rounded once), as the reference sums them
// outside its kernel. Visibility: query i (global position i + Skv - Sq,
// bottom-right causal alignment) sees key j when j <= i + Skv - Sq under
// causal; rows at or past Sq or Skv are masked and never read as data (TMA
// fills them with zeros).
//
// Bound on the H100: at the training shapes (S = 4095 at head_dim 64, S =
// 2048 at 128, causal) the tensor-core operations (dq: 3 products, dk/dv: 4
// products of 2 * D per visible pair and head) far outweigh the bytes, so
// the bound is the bf16 matrix rate (989 TFLOP/s).
//
// Design (the layout of fused_attention.cu's backward, carried to long
// causal sequences): two kernels, no atomics, so a rerun gives the same
// bits. Each CTA is a producer warpgroup (setmaxnreg down to 24 registers)
// of which one thread issues every TMA copy, and consumer warpgroups of 64
// rows each: three at head_dim 64 (setmaxnreg up to 160), two at 128 (up
// to 240). Operands are 64-row tiles of one head read through 4-D tensor
// maps (head_dim, heads, seq, batch), one 128-byte-swizzled box per 64
// columns (hopper.cuh). Every product is a wgmma with fp32 sums in
// registers; S, dP, p and ds never pass through shared memory: an
// accumulator converted to bf16 in place is the register A operand of the
// next product.
// - dq (flash_dq_kernel): one CTA per (batch * q head, 64 queries per
//   consumer), the longest causal tiles first. Q and dO once; then the
//   visible 64-key tiles of K and V (from the kv head, through the map's
//   head coordinate) through a ring of 4 slots with full and empty
//   mbarriers; tiles above the diagonal are never loaded. Per tile and
//   consumer: S = Q K^T and dP = dO V^T by wgmma m64n64k16 (two groups: p =
//   exp2(s scale log2 e - lse log2 e) is computed while dP runs; the mask
//   only on diagonal and ragged tiles), ds in registers, dq += ds K by
//   wgmma with K read MN-major, issued together with the next tile's S and
//   dP. dq is staged once over the consumer's Q rows and stored by TMA.
// - dk/dv (flash_dkv_kernel): one CTA per (batch * q head, 64 keys per
//   consumer), the grid of the reference (a q head, not a kv head: the
//   group's sum leaves the block, so each head's dk and dv round where the
//   TPU kernel rounds them, and the causal work is spread over H and not
//   KVH CTAs). K and V once, then the 64-query stages that see the CTA's
//   keys (Q, dO and their lse log2 e and delta, bulk-copied from a padded
//   copy the caller makes, since rows of Sq floats need not be 16-byte
//   aligned) through a ring of 4 slots; one stage feeds every consumer.
//   Per 32-query step and consumer: S^T = K Q^T and dP^T = V dO^T (wgmma
//   m64n32k16) with the keys as rows, so p^T and ds^T come out as the A
//   operand of dv += p^T dO and dk += ds^T Q (Q and dO read MN-major),
//   issued together with the next step's S^T and dP^T. dk and dv stay in
//   registers, are staged over the consumer's K and V rows once and stored
//   by TMA (per q head; the caller sums a group).
// No wgmma is in flight across a loop's back edge or a branch around a
// named barrier: ptxas then serializes them (C7518 / C7520). What bounds
// the kernels is each consumer's chain (wait for S, exp2, wait for dP, ds,
// issue): neither the exp2 work, the ring depth nor shared-memory reads
// moved their time, more consumers per SM did (PERF.md §6).
// On the TPU the inner grid axis ran in order with scratch carried between
// steps; here the loop inside the CTA takes its place.
// Resources (ptxas -v): 128 registers at entry at head_dim 64
// (512 threads; 160 in the consumers), 168 at 128 (384 threads; 240), no
// spills in either kernel at either head dim (the dq kernel's delta mode
// too); shared memory 113 KB (dq) / 115 KB (dk/dv) at head_dim 64, 193 KB /
// 195 KB at 128, one CTA per SM.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  // consumer warpgroups of 64 rows each, then one producer warpgroup. The
  // consumers' chains (wait for a product, exp2 and FMAs, issue the next)
  // set the time, so more of them run in parallel where registers allow:
  // three at head_dim 64 (160 registers each after setmaxnreg), two at 128
  // (240 each)
  static constexpr int CONSUMERS = D == 64 ? 3 : 2;
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  static constexpr int BLOCK = CONSUMERS * TILE_ROWS;  // query (dq) or key (dk/dv) rows of a CTA
  static constexpr int TILE = TILE_ROWS * D * 2;       // one 64-row tile
  static constexpr int STAGES = 4;                     // ring slots
  static constexpr int BARS = 8 * (1 + 2 * STAGES);    // the once-loaded tiles, full[], empty[]
  // dq: Q and dO (one tile per consumer each), then slots of (K, V)
  static constexpr int DQ_RING = 2 * CONSUMERS * TILE;
  static constexpr int DQ_BAR = DQ_RING + STAGES * 2 * TILE;
  static constexpr int DQ_SMEM = DQ_BAR + BARS + 1024;  // + slack to align the base to 1024
  // dk/dv: K and V (one tile per consumer each), slots of (Q, dO), then
  // each slot's lse log2 e and delta of its 64 queries
  static constexpr int STAT_BYTES = 2 * TILE_ROWS * 4;
  // query rows per step: 32 keeps dk, dv, S^T, dP^T and p^T / ds^T within
  // the consumers' registers at both head dims
  static constexpr int QW = 32;
  static constexpr int DKV_RING = 2 * CONSUMERS * TILE;
  static constexpr int DKV_STAT = DKV_RING + STAGES * 2 * TILE;
  static constexpr int DKV_BAR = DKV_STAT + STAGES * STAT_BYTES;
  static constexpr int DKV_SMEM = DKV_BAR + BARS + 1024;
};

__device__ __forceinline__ bool visible(int qp, int kp, int sq, int skv, int off, int causal) {
  return qp < sq && kp < skv && (!causal || qp + off >= kp);
}

// some pair of queries [q0, q0 + nq) x keys [k0, k0 + nk) is hidden
// (causal, or a row that sees nothing) or past a sequence
__device__ __forceinline__ bool needs_mask(int q0, int nq, int k0, int nk, int sq, int skv,
                                           int off, int causal) {
  return q0 + nq > sq || k0 + nk > skv || (causal && k0 + nk - 1 > q0 + off);
}

__device__ __forceinline__ void init_bars(uint32_t bars, int stages, int consumers) {
  mbar_init(bars, 1);
  for (int s = 0; s < stages; ++s) {
    mbar_init(bars + 8 * (1 + s), 1);                       // full: the producer's transactions
    mbar_init(bars + 8 * (1 + stages + s), consumers * 128);  // empty: every consumer thread
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// dq: one CTA per (batch * q head, BLOCK queries); q/dO/dq [B, Sq, H, D], k/v
// [B, Skv, KVH, D], lse/delta [B, H, Sq]. With DELTA the same walk over the
// key tiles writes delta_out = rowsum(p * dP) (fp32, [B, H, Sq]) and
// neither reads delta nor writes dq (dq_map is not used).
template <int D, bool DELTA>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap dq_map, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ delta_out, int sq, int skv,
                int h, int kvh, float scale, int causal) {
  using C = Cfg<D>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  constexpr int CONSUMERS = C::CONSUMERS, BLOCK = C::BLOCK;
  const uint32_t q_s = base, do_s = base + CONSUMERS * C::TILE;  // one tile per consumer each
  const uint32_t q_full = base + C::DQ_BAR;
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + ST + s); };
  auto k_slot = [&](int s) { return base + C::DQ_RING + s * 2 * C::TILE; };  // K, then V

  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const int kv_head = head / (h / kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK;  // longest causal tiles first
  const int off = skv - sq;                              // bottom-right causal alignment
  const int kv_hi = causal ? min(skv, q0 + BLOCK + off) : skv;
  const int n_tiles = kv_hi > 0 ? (kv_hi + TILE_ROWS - 1) / TILE_ROWS : 0;
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) init_bars(q_full, ST, CONSUMERS);
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---------------- producer: one thread issues every copy ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == CONSUMERS * 128 && n_tiles > 0) {
      mbar_expect_tx(q_full, 2 * CONSUMERS * C::TILE);
      for (int w = 0; w < CONSUMERS; ++w) {
        load_rows<D>(q_s + w * C::TILE, &q_map, q_full, head, q0 + w * TILE_ROWS, b);
        load_rows<D>(do_s + w * C::TILE, &do_map, q_full, head, q0 + w * TILE_ROWS, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(empty(s), ((it / ST) - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::TILE);
        load_rows<D>(k_slot(s), &k_map, full(s), kv_head, it * TILE_ROWS, b);
        load_rows<D>(k_slot(s) + C::TILE, &v_map, full(s), kv_head, it * TILE_ROWS, b);
      }
    }
    return;
  }

  // ---------------- consumers: 64 query rows per warpgroup ----------------
  if constexpr (CONSUMERS == 3) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  }
  const int t = tid % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int col_lane = 2 * (lane % 4);      // its first column of each 8
  const int qw = q0 + wg * TILE_ROWS;
  const uint32_t q_w = q_s + wg * C::TILE, do_w = do_s + wg * C::TILE;
  const int qp[2] = {qw + r0, qw + r0 + 8};
  const float scale_log2 = scale * LOG2E;
  float l2[2], dl[2] = {0.f, 0.f};  // lse log2 e and delta of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = qp[r] < sq;
    l2[r] = ok ? lse[(size_t)bh * sq + qp[r]] * LOG2E : 0.f;
    if constexpr (!DELTA) dl[r] = ok ? delta[(size_t)bh * sq + qp[r]] : 0.f;
  }
  // key tiles holding a position that a real row of this warpgroup sees:
  // a prefix of the CTA's tiles (the rest lie past its causal diagonal)
  const int last = causal ? min(qw + TILE_ROWS - 1, sq - 1) + off : skv - 1;
  const int n_do = qw >= sq || last < 0 ? 0 : min(n_tiles, last / TILE_ROWS + 1);

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[TILE_ROWS / 2], dp[TILE_ROWS / 2];
  uint32_t ds[TILE_ROWS / 4];
  if (n_tiles > 0) mbar_wait(q_full, 0);

  // p of tile `it` in place of S, once S is done (dP may still run)
  auto softmax = [&](int it) {
    const int k0 = it * TILE_ROWS;
    const bool mask = needs_mask(qw, TILE_ROWS, k0, TILE_ROWS, sq, skv, off, causal);
#pragma unroll
    for (int i = 0; i < TILE_ROWS / 2; ++i) {
      const int r = (i >> 1) & 1;
      const bool ok = !mask || visible(qp[r], k0 + (i / 4) * 8 + col_lane + (i & 1), sq, skv,
                                       off, causal);
      sc[i] = ok ? ex2(sc[i] * scale_log2 - l2[r]) : 0.f;
    }
  };
  // ds = bf16(p (dp - delta) scale), the register A operand of dq += ds K
  auto to_ds = [&]() {
#pragma unroll
    for (int i = 0; i < TILE_ROWS / 2; i += 2) {
      const int r = (i >> 1) & 1;
      ds[i / 2] = pack_bf16((sc[i] * (dp[i] - dl[r])) * scale,
                            (sc[i + 1] * (dp[i + 1] - dl[r])) * scale);
    }
  };
  // S = Q K^T and dP = dO V^T of tile `it`, two groups (issued, not waited)
  auto issue_sdp = [&](float (&s_acc)[TILE_ROWS / 2], float (&dp_acc)[TILE_ROWS / 2], int it) {
    issue_abt<D, TILE_ROWS>(s_acc, q_w, k_slot(it % ST));
    wgmma_commit();
    issue_abt<D, TILE_ROWS>(dp_acc, do_w, k_slot(it % ST) + C::TILE);
    wgmma_commit();
  };
  if constexpr (DELTA) {
    // delta: per tile S and dP, then p * dP summed into the two rows; one
    // tile's products at a time (nothing in flight across the back edge)
    float acc[2] = {0.f, 0.f};
    for (int it = 0; it < n_do; ++it) {
      mbar_wait(full(it % ST), (it / ST) & 1);
      wgmma_fence();
      issue_sdp(sc, dp, it);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(it);
      wgmma_wait<0>();
      fence_regs(dp);
      mbar_arrive(empty(it % ST));
#pragma unroll
      for (int i = 0; i < TILE_ROWS / 2; ++i) acc[(i >> 1) & 1] += sc[i] * dp[i];
    }
    for (int it = n_do; it < n_tiles; ++it) {
      mbar_wait(full(it % ST), (it / ST) & 1);
      mbar_arrive(empty(it % ST));
    }
    // the four lanes of a quad hold the columns of the same two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
      if (lane % 4 == 0 && qp[r] < sq) delta_out[(size_t)bh * sq + qp[r]] = acc[r];
    }
    return;
  }

  // Each step issues dq += ds K of the last tile and S, dP of this one
  // together, so the tensor cores run the three back to back while the
  // other warpgroup works on its exp2; nothing is in flight across the
  // loop's back edge (ptxas serializes wgmmas that are).
  if (n_do > 0) {
    mbar_wait(full(0), 0);
    wgmma_fence();
    issue_sdp(sc, dp, 0);
    wgmma_wait<1>();
    fence_regs(sc);
    softmax(0);
    wgmma_wait<0>();
    fence_regs(dp);
    to_ds();
    for (int it = 1; it < n_do; ++it) {
      mbar_wait(full(it % ST), (it / ST) & 1);
      fence_regs(dq);
      fence_regs(ds);
      wgmma_fence();
      issue_ab<D, TILE_ROWS>(dq, ds, k_slot((it - 1) % ST));  // dq += ds K of tile it - 1
      wgmma_commit();
      issue_sdp(sc, dp, it);
      wgmma_wait<1>();  // dq's product and S done; dP may run
      fence_regs(dq);
      fence_regs(ds);
      fence_regs(sc);
      mbar_arrive(empty((it - 1) % ST));
      softmax(it);
      wgmma_wait<0>();
      fence_regs(dp);
      to_ds();
    }
    fence_regs(dq);
    fence_regs(ds);
    wgmma_fence();
    issue_ab<D, TILE_ROWS>(dq, ds, k_slot((n_do - 1) % ST));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(ds);
    mbar_arrive(empty((n_do - 1) % ST));
  }
  // tiles past this warpgroup's rows: release each
  for (int it = n_do; it < n_tiles; ++it) {
    mbar_wait(full(it % ST), (it / ST) & 1);
    mbar_arrive(empty(it % ST));
  }

  // epilogue: dq through the warpgroup's Q rows (its wgmmas are done)
  if (qw >= sq) return;
  bar_sync(1 + wg, 128);
  stage_rows<D>(q_w, dq, r0, col_lane);
  fence_async_shared();
  bar_sync(1 + wg, 128);
  if (t == 0) {
    store_rows<D>(&dq_map, q_w, head, qw, b);
    bulk_commit();
    bulk_wait_read();
  }
}

// dk/dv: one CTA per (batch * q head, BLOCK keys); dk/dv [B, Skv, H, D] (this
// q head's share), stats [2, B * H, sq_pad] (lse log2 e, then delta; rows
// past Sq zero)
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap do_map,
                 const __grid_constant__ CUtensorMap dk_map,
                 const __grid_constant__ CUtensorMap dv_map, const float* __restrict__ stats,
                 int sq, int skv, int h, int kvh, int sq_pad, float scale, int causal) {
  using C = Cfg<D>;
  constexpr int ST = C::STAGES, QW = C::QW, SUB = TILE_ROWS / QW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* stat_s = reinterpret_cast<const float*>(smem_raw + (base - raw) + C::DKV_STAT);
  constexpr int CONSUMERS = C::CONSUMERS, BLOCK = C::BLOCK;
  const uint32_t k_s = base, v_s = base + CONSUMERS * C::TILE;  // one tile per consumer each
  const uint32_t kv_full = base + C::DKV_BAR;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + ST + s); };
  auto q_slot = [&](int s) { return base + C::DKV_RING + s * 2 * C::TILE; };  // Q, then dO

  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const int kv_head = head / (h / kvh);
  const int k0 = blockIdx.y * BLOCK;  // causal: the first keys see the most queries
  const int off = skv - sq;
  // the first query tile that sees key k0, and the tiles from there on
  const int t_lo = causal ? max(0, k0 - off) / TILE_ROWS : 0;
  const int n_q = max(0, (sq + TILE_ROWS - 1) / TILE_ROWS - t_lo);
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) init_bars(kv_full, ST, CONSUMERS);
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---------------- producer: one thread issues every copy ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == CONSUMERS * 128 && n_q > 0) {
      mbar_expect_tx(kv_full, 2 * CONSUMERS * C::TILE);
      for (int w = 0; w < CONSUMERS; ++w) {
        load_rows<D>(k_s + w * C::TILE, &k_map, kv_full, kv_head, k0 + w * TILE_ROWS, b);
        load_rows<D>(v_s + w * C::TILE, &v_map, kv_full, kv_head, k0 + w * TILE_ROWS, b);
      }
      const size_t plane = (size_t)gridDim.x * sq_pad;
      for (int it = 0; it < n_q; ++it) {
        const int s = it % ST, q0 = (t_lo + it) * TILE_ROWS;
        if (it >= ST) mbar_wait(empty(s), ((it / ST) - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::TILE + C::STAT_BYTES);
        load_rows<D>(q_slot(s), &q_map, full(s), head, q0, b);
        load_rows<D>(q_slot(s) + C::TILE, &do_map, full(s), head, q0, b);
        const float* src = stats + (size_t)bh * sq_pad + q0;
        const uint32_t dst = base + C::DKV_STAT + s * C::STAT_BYTES;
        bulk_load(dst, src, TILE_ROWS * 4, full(s));
        bulk_load(dst + TILE_ROWS * 4, src + plane, TILE_ROWS * 4, full(s));
      }
    }
    return;
  }

  // ---------------- consumers: 64 key rows per warpgroup ----------------
  if constexpr (CONSUMERS == 3) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  }
  const int t = tid % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's key rows: r0 and r0 + 8
  const int col_lane = 2 * (lane % 4);
  const int kw = k0 + wg * TILE_ROWS;
  const uint32_t k_w = k_s + wg * C::TILE, v_w = v_s + wg * C::TILE;
  const int kp[2] = {kw + r0, kw + r0 + 8};
  const float scale_log2 = scale * LOG2E;
  // the first stage with a query that sees a real key of this warpgroup
  // (every later stage has one too)
  const int it0 = kw >= skv ? n_q : causal ? min(n_q, max(0, kw - off) / TILE_ROWS - t_lo) : 0;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float st[QW / 2], dpt[QW / 2];
  uint32_t ea[QW / 4], da[QW / 4];
  if (n_q > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < it0; ++it) {
    mbar_wait(full(it % ST), (it / ST) & 1);
    mbar_arrive(empty(it % ST));
  }

  // step t: QW queries of stage it0 + t / SUB, from row (t % SUB) * QW
  auto q_row = [&](int t) {  // the step's Q rows in shared memory (dO's: + TILE)
    return q_slot((it0 + t / SUB) % ST) + (t % SUB) * QW * ROW_BYTES;
  };
  // p^T in place of S^T, once S^T is done (dP^T may still run), then as
  // the bf16 A operand of dv += p^T dO
  auto softmax = [&](int t) {
    const int it = it0 + t / SUB, hq = (t % SUB) * QW;
    const int qh = (t_lo + it) * TILE_ROWS + hq;
    const float* hs = stat_s + (it % ST) * (C::STAT_BYTES / 4) + hq;  // lse log2 e
    const bool mask = needs_mask(qh, QW, kw, TILE_ROWS, sq, skv, off, causal);
#pragma unroll
    for (int i = 0; i < QW / 2; ++i) {
      const int c = (i / 4) * 8 + col_lane + (i & 1);  // the query column
      const bool ok = !mask || visible(qh + c, kp[(i >> 1) & 1], sq, skv, off, causal);
      st[i] = ok ? ex2(st[i] * scale_log2 - hs[c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < QW / 2; i += 2) ea[i / 2] = pack_bf16(st[i], st[i + 1]);
  };
  // ds^T = bf16(p^T (dP^T - delta) scale), the A operand of dk += ds^T Q
  auto to_ds = [&](int t) {
    const int it = it0 + t / SUB;
    const float* dl = stat_s + (it % ST) * (C::STAT_BYTES / 4) + TILE_ROWS + (t % SUB) * QW;
#pragma unroll
    for (int i = 0; i < QW / 2; i += 2) {
      const int c = (i / 4) * 8 + col_lane;
      da[i / 2] = pack_bf16((st[i] * (dpt[i] - dl[c])) * scale,
                            (st[i + 1] * (dpt[i + 1] - dl[c + 1])) * scale);
    }
  };
  // S^T = K Q^T and dP^T = V dO^T of step t, two groups (issued, not waited)
  auto issue_sdp = [&](float (&s_acc)[QW / 2], float (&dp_acc)[QW / 2], int t) {
    issue_abt<D, QW>(s_acc, k_w, q_row(t));
    wgmma_commit();
    issue_abt<D, QW>(dp_acc, v_w, q_row(t) + C::TILE);
    wgmma_commit();
  };
  // dv += p^T dO and dk += ds^T Q of step t, one group (issued, not waited)
  auto issue_dkv = [&](int t) {
    issue_ab<D, QW>(dv, ea, q_row(t) + C::TILE);
    issue_ab<D, QW>(dk, da, q_row(t));
    wgmma_commit();
  };
  // Each step issues the last step's dv and dk products and this step's
  // S^T and dP^T together; nothing is in flight across the loop's back
  // edge (ptxas serializes wgmmas that are).
  const int n_steps = (n_q - it0) * SUB;
  if (n_steps > 0) {
    mbar_wait(full(it0 % ST), (it0 / ST) & 1);
    wgmma_fence();
    issue_sdp(st, dpt, 0);
    wgmma_wait<1>();
    fence_regs(st);
    softmax(0);
    wgmma_wait<0>();
    fence_regs(dpt);
    to_ds(0);
    for (int t = 1; t < n_steps; ++t) {
      const int it = it0 + t / SUB;
      if (t % SUB == 0) mbar_wait(full(it % ST), (it / ST) & 1);
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(ea);
      fence_regs(da);
      wgmma_fence();
      issue_dkv(t - 1);
      issue_sdp(st, dpt, t);
      wgmma_wait<1>();  // the last step's products and S^T done; dP^T may run
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(ea);
      fence_regs(da);
      fence_regs(st);
      if (t % SUB == 0) mbar_arrive(empty((it - 1) % ST));
      softmax(t);
      wgmma_wait<0>();
      fence_regs(dpt);
      to_ds(t);
    }
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(ea);
    fence_regs(da);
    wgmma_fence();
    issue_dkv(n_steps - 1);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(ea);
    fence_regs(da);
    mbar_arrive(empty((n_q - 1) % ST));
  }

  // epilogue: dk and dv through the warpgroup's K and V rows
  if (kw >= skv) return;
  bar_sync(1 + wg, 128);
  stage_rows<D>(k_w, dk, r0, col_lane);
  stage_rows<D>(v_w, dv, r0, col_lane);
  fence_async_shared();
  bar_sync(1 + wg, 128);
  if (t == 0) {
    store_rows<D>(&dk_map, k_w, head, kw, b);
    store_rows<D>(&dv_map, v_w, head, kw, b);
    bulk_commit();
    bulk_wait_read();
  }
}

// --------------------------------------------------------------------- //
// host side: the launches (tensor maps from hopper.cuh)
// --------------------------------------------------------------------- //

template <typename K>
cudaError_t prepare(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int N>
bool aligned(const void* const (&ptrs)[N]) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;  // TMA and bulk copies
  }
  return true;
}

// DELTA: out is delta_out (fp32 [b, h, sq]) and delta is not read; else out
// is dq (bf16 [b, sq, h, D])
template <int D, bool DELTA>
cudaError_t dq_launch(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* out, int b, int sq, int skv,
                      int h, int kvh, float scale, int causal, cudaStream_t st) {
  const void* const bases[5] = {q, k, v, dout, DELTA ? q : out};
  if (!aligned(bases)) return cudaErrorMisalignedAddress;
  if (skv <= 0) return cudaMemsetAsync(out, 0, (size_t)b * sq * h * (DELTA ? 4 : D * 2), st);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map;
  if (!make_map(encode, &q_map, q, D, h, sq, b, TILE_ROWS) ||
      !make_map(encode, &k_map, k, D, kvh, skv, b, TILE_ROWS) ||
      !make_map(encode, &v_map, v, D, kvh, skv, b, TILE_ROWS) ||
      !make_map(encode, &do_map, dout, D, h, sq, b, TILE_ROWS) ||
      !make_map(encode, &dq_map, DELTA ? q : out, D, h, sq, b, TILE_ROWS)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = prepare(flash_dq_kernel<D, DELTA>, Cfg<D>::DQ_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(b * h, (sq + Cfg<D>::BLOCK - 1) / Cfg<D>::BLOCK);
  flash_dq_kernel<D, DELTA><<<grid, Cfg<D>::THREADS, Cfg<D>::DQ_SMEM, st>>>(
      q_map, k_map, v_map, do_map, dq_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), DELTA ? static_cast<float*>(out) : nullptr, sq, skv, h,
      kvh, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                       const void* stats, void* dk, void* dv, int b, int sq, int skv, int h,
                       int kvh, float scale, int causal, cudaStream_t st) {
  const void* const bases[7] = {q, k, v, dout, stats, dk, dv};
  if (!aligned(bases)) return cudaErrorMisalignedAddress;
  if (sq <= 0) {  // no query: zeros
    const size_t bytes = (size_t)b * skv * h * D * 2;
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, st);
    return err != cudaSuccess ? err : cudaMemsetAsync(dv, 0, bytes, st);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map, do_map, dk_map, dv_map;
  if (!make_map(encode, &q_map, q, D, h, sq, b, TILE_ROWS) ||
      !make_map(encode, &k_map, k, D, kvh, skv, b, TILE_ROWS) ||
      !make_map(encode, &v_map, v, D, kvh, skv, b, TILE_ROWS) ||
      !make_map(encode, &do_map, dout, D, h, sq, b, TILE_ROWS) ||
      !make_map(encode, &dk_map, dk, D, h, skv, b, TILE_ROWS) ||
      !make_map(encode, &dv_map, dv, D, h, skv, b, TILE_ROWS)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = prepare(flash_dkv_kernel<D>, Cfg<D>::DKV_SMEM);
  if (err != cudaSuccess) return err;
  const int sq_pad = (sq + TILE_ROWS - 1) / TILE_ROWS * TILE_ROWS;
  dim3 grid(b * h, (skv + Cfg<D>::BLOCK - 1) / Cfg<D>::BLOCK);
  flash_dkv_kernel<D><<<grid, Cfg<D>::THREADS, Cfg<D>::DKV_SMEM, st>>>(
      q_map, k_map, v_map, do_map, dk_map, dv_map, static_cast<const float*>(stats), sq, skv,
      h, kvh, sq_pad, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq: [b, sq, h, d] bf16; k, v: [b, skv, kvh, d] bf16; lse, delta:
// [b, h, sq] fp32; all contiguous on the device, the bf16 tensors 16-byte
// aligned. d must be 64 or 128 and h a multiple of kvh. Returns the
// launch's cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int b, int sq,
                            int skv, int h, int kvh, int d, float scale, int causal,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0) return 0;
  if (d == 64) return dq_launch<64, false>(q, k, v, dout, lse, delta, dq, b, sq, skv, h, kvh, scale, causal, st);
  if (d == 128) return dq_launch<128, false>(q, k, v, dout, lse, delta, dq, b, sq, skv, h, kvh, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// delta_out[b, h, i] = sum over the keys of k / v that query i sees of p * dp,
// p = exp(s - lse) and dp = dO v^T (fp32), with lse given (natural log): the
// operands of flash_bwd_dq but delta, delta_out fp32 [b, h, sq] contiguous.
// Rows that see no key get 0. Sums over shards of the keys (each under the
// same lse) add up to the sum over all of them.
extern "C" int flash_bwd_delta(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, void* delta_out, int b, int sq, int skv, int h,
                               int kvh, int d, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0) return 0;
  if (d == 64) return dq_launch<64, true>(q, k, v, dout, lse, nullptr, delta_out, b, sq, skv, h, kvh, scale, causal, st);
  if (d == 128) return dq_launch<128, true>(q, k, v, dout, lse, nullptr, delta_out, b, sq, skv, h, kvh, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The operands of flash_bwd_dq, with the statistics as stats: [2, b * h,
// sq_pad] fp32 (lse * log2 e, then delta; sq_pad = sq rounded up to 64, the
// rows past sq zero). dk, dv: [b, skv, h, d] bf16, each q head's share
// rounded to bf16 (with kvh == h, the gradients themselves); the caller sums
// each GQA group. Every pointer 16-byte aligned.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* stats, void* dk, void* dv, int b, int sq, int skv,
                             int h, int kvh, int d, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || skv <= 0) return 0;
  if (d == 64) return dkv_launch<64>(q, k, v, dout, stats, dk, dv, b, sq, skv, h, kvh, scale, causal, st);
  if (d == 128) return dkv_launch<128>(q, k, v, dout, stats, dk, dv, b, sq, skv, h, kvh, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
