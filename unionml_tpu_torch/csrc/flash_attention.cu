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
// Bound on the H100: at the prefill shapes (S = 1024, head_dim 128, left
// pads) the bytes of q, k, v and out set the bound; at the training shapes
// (S = 4095 at head_dim 64, S = 2048 at 128, causal) the tensor-core
// operations (4 * visible pairs * D per head) outweigh the bytes, and the
// bound is the bf16 matrix rate (989 TFLOP/s).
//
// Design (the FlashAttention-3 arrangement). One CTA of three warpgroups
// (384 threads) per (batch * head, 128-query tile), q tiles scheduled
// longest-first (grid x = batch * head, y = q tile from the last):
// - a producer warpgroup (setmaxnreg down to 24 registers) of which one
//   thread issues TMA copies: the q tile once, then K and V tiles of 128
//   keys through a ring of STAGES slots in shared memory (4 at head_dim 64,
//   2 at 128), each slot with full barriers for K and V (transaction
//   counts) and empty barriers for K and V that every consumer thread
//   arrives on once its wgmmas have read the tile. Key tiles wholly above
//   the causal diagonal or wholly inside the row's left padding are never
//   loaded. The tensor maps are 4-D (head_dim, heads, seq, batch) with a
//   box of one head, so a tile never crosses a batch row; rows past the
//   sequence read as zeros and the position mask hides them. Each 64-column
//   chunk of head_dim is one 128-byte-swizzled box; the wgmma descriptors
//   use the same swizzle (8-row groups 1024 bytes apart; V's 64-column
//   chunks BKV * 128 bytes apart).
// - two consumer warpgroups (setmaxnreg up to 240), each owning 64 query
//   rows. S = Q K^T by wgmma m64n128k16 from shared memory into fp32
//   registers. The mask only on tiles that need it (the diagonal, the pad
//   boundary, the ragged end: a separate instantiation of the softmax).
//   The online softmax in registers: the row max and sum over the four
//   threads that share a row (__shfl_xor_sync), each thread's part in four
//   independent chains per row, scale * log2(e) folded into exp2
//   (ex2.approx), lse converted back to the natural log. P converted to
//   bf16 in registers, where the accumulator layout of S is the A-operand
//   layout of the next wgmma. O += P V by wgmma with A from registers and
//   V as a transposed (MN-major) operand from shared memory; O and its
//   per-row rescale stay in registers.
// - the order of a consumer iteration: S of tile j and P V of tile j - 1
//   are issued together in the warpgroup's turn, the softmax of tile j runs
//   while P V (and the other warpgroup's products) use the tensor cores;
//   the two consumers take turns through named barriers (ping-pong), so one
//   warpgroup's exp2 work overlaps the other's matrix work.
// - the epilogue writes O / l as bf16 into the warpgroup's own (now free)
//   q rows of shared memory, swizzled, and one TMA store per 64-column chunk
//   copies it out; rows past the sequence are clipped by the tensor map.
//   lse is written by one thread per row.
// Resources (ptxas -v, nvcc 12.9): 168 registers at entry (the bound for
// 384 threads), 240 in the consumers after setmaxnreg, 0 spills at both
// head dims; shared memory 16 KB of q + 4 x 32 KB of K/V ring at head_dim
// 64 (145 KB with barriers and alignment slack), 32 KB + 2 x 64 KB at 128
// (161 KB): one CTA per SM. What holds it back (chip runs, PERF.md): at
// head_dim 64 one tile's exp2 work (8192 on 16 units a cycle) equals its
// matrix work, and the softmax's ALU work does not yet hide behind the
// products. On the TPU the kv grid axis ran in order with scratch carried
// between steps; here the loop over kv tiles inside the block takes its
// place. The PTX helpers and the tensor-map builder are in hopper.cuh,
// shared with fused_attention.cu.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;               // query rows per CTA
constexpr int BKV = 128;              // keys per tile
constexpr int CONSUMERS = 2;          // warpgroups of 64 query rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Config {
  static constexpr int CHUNKS = D / 64;                 // 128-byte column chunks
  static constexpr int STAGES = D == 64 ? 4 : 2;        // K/V ring slots
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;          // one K or one V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BARS = 1 + 4 * STAGES;           // q, then k/v full and empty per slot
  static constexpr int SMEM = BAR_OFF + 8 * BARS + 1024;  // + slack to align the base to 1024
};

// --------------------------------------------------------------------- //
// the kernel
// --------------------------------------------------------------------- //

// Barriers in shared memory (8 bytes each): q_full, then per ring slot s
// k_full, v_full (the producer's transaction counts), k_empty, v_empty
// (every consumer thread arrives once its wgmmas have read the tile).
template <int STAGES>
struct Bars {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t k_full(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t v_full(int s) const { return base + 8 * (1 + STAGES + s); }
  __device__ uint32_t k_empty(int s) const { return base + 8 * (1 + 2 * STAGES + s); }
  __device__ uint32_t v_empty(int s) const { return base + 8 * (1 + 3 * STAGES + s); }
};

// Ping-pong between the two consumer warpgroups: a warpgroup issues its
// wgmmas only in its turn (named barrier 3 + wg) and then hands the turn
// to the other (bar.arrive), so one warpgroup's softmax runs while the
// other's products use the tensor cores.
__device__ __forceinline__ void turn_begin(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(3 + (1 - wg)) : "memory");
}

// Mask (MASK: the diagonal, pad-boundary or ragged tile) and online
// softmax of one 64 x 128 score tile held as this thread's 64 wgmma
// accumulators: scores become p = exp2(s * scale * log2(e) - m) in place;
// returns the rescale factors of the two rows' earlier sums. The row max
// and sum run in CHAINS independent partials per row, so the dependent
// FMNMX / FADD chains stay short at two warps per scheduler.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 2], int k0, int col_lane, int pad_b,
                                             int hi0, int hi1, float scale_log2, float& m0,
                                             float& m1, float& l0, float& l1, float& corr0,
                                             float& corr1) {
  constexpr int CHAINS = 4;
  float mx[2][CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) mx[0][c] = mx[1][c] = -INFINITY;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    float x = sc[i] * scale_log2;
    if (MASK) {
      const int col = k0 + (i / 4) * 8 + col_lane + (i & 1);
      if (col < pad_b || col >= ((i & 2) ? hi1 : hi0)) x = -INFINITY;
    }
    sc[i] = x;
    // element i belongs to row (i >> 1) & 1; chain (i >> 2) % CHAINS
    float& m = mx[(i >> 1) & 1][(i >> 2) % CHAINS];
    m = fmaxf(m, x);
  }
  float mx0 = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
  float mx1 = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
  // the four threads of a row are lanes 4r .. 4r + 3
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float mu0 = mn0 == -INFINITY ? 0.f : mn0;  // nothing visible yet: p = 0
  const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
  corr0 = ex2(m0 - mu0);
  corr1 = ex2(m1 - mu1);
  m0 = mn0;
  m1 = mn1;
  float sum[2][CHAINS];  // partial sums over this thread's columns
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) sum[0][c] = sum[1][c] = 0.f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    const float p = ex2(sc[i] - ((i & 2) ? mu1 : mu0));
    sc[i] = p;
    sum[(i >> 1) & 1][(i >> 2) % CHAINS] += p;
  }
  l0 = l0 * corr0 + ((sum[0][0] + sum[0][1]) + (sum[0][2] + sum[0][3]));
  l1 = l1 * corr1 + ((sum[1][0] + sum[1][1]) + (sum[1][2] + sum[1][3]));
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap o_map, const int* __restrict__ pad,
                 float* __restrict__ lse, int sq, int skv, int h, int kvh, float scale_log2,
                 int causal) {
  using C = Config<D>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::K_OFF;
  const uint32_t v_s = base + C::V_OFF;
  const Bars<ST> bar{base + C::BAR_OFF};

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh % h;
  const int kv_head = head / (h / kvh);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int offset = skv - sq;                             // bottom-right causal alignment
  const int pad_b = pad != nullptr ? pad[b] : 0;
  // kv tiles that hold a visible position for some row of this CTA
  const int kv_lo = (pad_b / BKV) * BKV;
  const int kv_hi = causal ? min(skv, q_start + BQ + offset) : skv;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BKV - 1) / BKV : 0;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(bar.q_full(), 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar.k_full(s), 1);
      mbar_init(bar.v_full(s), 1);
      mbar_init(bar.k_empty(s), CONSUMERS * 128);
      mbar_init(bar.v_empty(s), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---------------- producer: one thread issues every copy ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == CONSUMERS * 128 && n_tiles > 0) {
      mbar_expect_tx(bar.q_full(), C::Q_BYTES);
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) {
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(q_s + (c * BQ + w * 64) * ROW_BYTES, &q_map, bar.q_full(), c * 64, head,
                   q_start + w * 64, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        const uint32_t parity = ((it / ST) - 1) & 1;  // the slot's previous use
        const int k0 = kv_lo + it * BKV;
        if (it >= ST) mbar_wait(bar.k_empty(s), parity);
        mbar_expect_tx(bar.k_full(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(k_s + s * C::KV_BYTES + c * BKV * ROW_BYTES, &k_map, bar.k_full(s), c * 64,
                   kv_head, k0, b);
        }
        if (it >= ST) mbar_wait(bar.v_empty(s), parity);
        mbar_expect_tx(bar.v_full(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(v_s + s * C::KV_BYTES + c * BKV * ROW_BYTES, &v_map, bar.v_full(s), c * 64,
                   kv_head, k0, b);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows per warpgroup ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = tid % 128;
    const int lane = t % 32;
    const int qw = q_start + wg * 64;           // first query row of this warpgroup
    const int r0 = (t / 32) * 16 + lane / 4;    // this thread's rows: r0 and r0 + 8
    const int qp0 = qw + r0;
    const int qp1 = qp0 + 8;
    const int col_lane = 2 * (lane % 4);        // this thread's first column of each 8
    // per row: first invisible kv position (causal) or skv
    const int hi0 = causal ? min(skv, qp0 + offset + 1) : skv;
    const int hi1 = causal ? min(skv, qp1 + offset + 1) : skv;
    const bool active = qw < sq;
    // tiles holding a position that a real row of this warpgroup sees: a
    // prefix of the CTA's tiles (the rest lie past its causal diagonal)
    const int q_hi = causal ? min(qw + 63, sq - 1) + offset : skv - 1;
    const int n_do = !active || q_hi < kv_lo ? 0 : min(n_tiles, (q_hi - kv_lo) / BKV + 1);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units)
    float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums

    // S = Q K^T of tile `it` (issued, not waited)
    auto issue_s = [&](float (&sc)[BKV / 2], int it) {
      const int s = it % ST;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, within = (kk % 4) * 32;
        const uint64_t a = desc_sw128(q_s + (c * BQ + wg * 64) * ROW_BYTES + within, 16, 1024);
        const uint64_t bk = desc_sw128(k_s + s * C::KV_BYTES + c * BKV * ROW_BYTES + within, 16, 1024);
        wgmma_ss_n128(sc, a, bk, kk > 0);
      }
    };
    // O += P V of tile `it` (issued, not waited)
    auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&p)[BKV / 4], int it) {
      const int s = it % ST;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        wgmma_rs(o, a, desc_sw128(v_s + s * C::KV_BYTES + kk * 16 * ROW_BYTES, BKV * ROW_BYTES, 1024));
      }
    };
    // the mask only where some pair of the tile is hidden from some row
    auto softmax = [&](float (&sc)[BKV / 2], int k0, float& corr0, float& corr1) {
      if (k0 >= pad_b && k0 + BKV <= skv && (!causal || k0 + BKV - 1 <= qw + offset)) {
        softmax_tile<false>(sc, k0, col_lane, pad_b, hi0, hi1, scale_log2, m0, m1, l0, l1, corr0,
                            corr1);
      } else {
        softmax_tile<true>(sc, k0, col_lane, pad_b, hi0, hi1, scale_log2, m0, m1, l0, l1, corr0,
                           corr1);
      }
    };
    // P as the bf16 A operand: the accumulator layout of S is the register
    // layout of A, four registers per 16 keys
    auto to_p = [&](uint32_t (&p)[BKV / 4], const float (&sc)[BKV / 2]) {
#pragma unroll
      for (int j = 0; j < BKV / 4; ++j) p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
    };
    // every consumer warpgroup takes n_tiles + 1 turns; warpgroup 1 opens
    // the first for warpgroup 0 and does not pass its last
    int turns = 0;
    auto end_turn = [&]() {
      ++turns;
      if (wg == 0 || turns < n_tiles + 1) turn_pass(wg);
    };

    float sc[BKV / 2];
    uint32_t p[BKV / 4];

    if (n_tiles > 0) {
      if (wg == 1) turn_pass(wg);
      mbar_wait(bar.q_full(), 0);
    }
    if (n_do > 0) {
      // tile 0: S, then its softmax
      mbar_wait(bar.k_full(0), 0);
      turn_begin(wg);
      wgmma_fence();
      issue_s(sc, 0);
      wgmma_commit();
      end_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(bar.k_empty(0));
      float corr0, corr1;
      softmax(sc, kv_lo, corr0, corr1);
      to_p(p, sc);
      // tile it: S of it and P V of it - 1 in one turn, then the softmax of
      // it while P V runs
      for (int it = 1; it < n_do; ++it) {
        const int s = it % ST, sp = (it - 1) % ST;
        const int k0 = kv_lo + it * BKV;
        mbar_wait(bar.k_full(s), (it / ST) & 1);
        mbar_wait(bar.v_full(sp), ((it - 1) / ST) & 1);
        turn_begin(wg);
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
        issue_s(sc, it);
        wgmma_commit();
        issue_pv(o, p, it - 1);
        wgmma_commit();
        end_turn();
        wgmma_wait<1>();  // S done; P V may still run
        fence_regs(sc);
        mbar_arrive(bar.k_empty(s));
        softmax(sc, k0, corr0, corr1);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        mbar_arrive(bar.v_empty(sp));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? corr1 : corr0;
        to_p(p, sc);
      }
      // the last tile's P V
      const int sl = (n_do - 1) % ST;
      mbar_wait(bar.v_full(sl), ((n_do - 1) / ST) & 1);
      turn_begin(wg);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      issue_pv(o, p, n_do - 1);
      wgmma_commit();
      end_turn();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      mbar_arrive(bar.v_empty(sl));
    }
    // tiles past this warpgroup's rows: release each, then take a turn, in
    // the order the computing path does, so neither side waits on the other
    if (n_do == 0 && n_tiles > 0) {
      turn_begin(wg);
      end_turn();
    }
    for (int it = n_do; it < n_tiles; ++it) {
      const int s = it % ST;
      const uint32_t parity = (it / ST) & 1;
      mbar_wait(bar.k_full(s), parity);
      mbar_arrive(bar.k_empty(s));
      mbar_wait(bar.v_full(s), parity);
      mbar_arrive(bar.v_empty(s));
      turn_begin(wg);
      end_turn();
    }

    // ---------------- epilogue ----------------
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (lse != nullptr && lane % 4 == 0) {
      float* row = lse + (size_t)bh * sq;
      if (qp0 < sq) row[qp0] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : 0.f;
      if (qp1 < sq) row[qp1] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : 0.f;
    }
    if (!active) return;
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    // every wgmma of this warpgroup has read its q rows: reuse them for O
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int col = (i / 4) * 8 + col_lane;
      const int row = r0 + ((i & 2) ? 8 : 0);
      const float inv = (i & 2) ? inv1 : inv0;
      const int c = col / 64, cc = col % 64;
      const uint32_t addr = q_s + (c * BQ + wg * 64 + row) * ROW_BYTES +
                            ((((cc / 8) ^ (row % 8)) * 16) | ((cc % 8) * 2));
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(pack_bf16(o[i] * inv, o[i + 1] * inv))
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c) {
        tma_store(&o_map, q_s + (c * BQ + wg * 64) * ROW_BYTES, c * 64, head, qw, b);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// --------------------------------------------------------------------- //
// host side: the launch (tensor maps from hopper.cuh)
// --------------------------------------------------------------------- //

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pad, void* out,
                   float* lse, int b, int sq, int skv, int h, int kvh, float scale, int causal,
                   cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return cudaErrorMisalignedAddress;  // TMA needs 16-byte aligned tensors
  }
  if (skv <= 0) {  // nothing visible anywhere: zeros, and lse 0
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)b * sq * h * D * 2, stream);
    if (err == cudaSuccess && lse != nullptr) {
      err = cudaMemsetAsync(lse, 0, (size_t)b * h * sq * 4, stream);
    }
    return err;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!make_map(encode, &q_map, q, D, h, sq, b, 64) ||
      !make_map(encode, &k_map, k, D, kvh, skv, b, BKV) ||
      !make_map(encode, &v_map, v, D, kvh, skv, b, BKV) ||
      !make_map(encode, &o_map, out, D, h, sq, b, 64)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Config<D>::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(b * h, (sq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, Config<D>::SMEM, stream>>>(
      q_map, k_map, v_map, o_map, pad, lse, sq, skv, h, kvh, scale * LOG2E, causal);
  return cudaGetLastError();
}

}  // namespace

// q, out: [b, sq, h, d] bf16; k, v: [b, skv, kvh, d] bf16; pad: [b] int32
// (first visible kv position per batch row); all contiguous on the device,
// q/k/v/out 16-byte aligned. d must be 64 or 128 and h a multiple of kvh.
// Returns the launch's cudaError_t.
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
// [b, skv, kvh, d] bf16; lse: [b, h, sq] fp32; all contiguous, q/k/v/out
// 16-byte aligned. No padding; causal alignment is bottom-right (query i
// sees keys j <= i + skv - sq). d must be 64 or 128 and h a multiple of
// kvh. Returns the launch's cudaError_t.
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
