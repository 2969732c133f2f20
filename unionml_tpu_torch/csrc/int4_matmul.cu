// Packed-int4 weight-only matmul for Hopper (sm_90a): y[rows, N] = x[rows, K]
// @ W4 for decode-sized row counts (rows <= 64), per-channel or group-wise
// scales, through one C entry (int4_matmul_fwd) and one design for both
// scale forms. It replaces both TPU kernels of
// unionml_tpu/ops/int4_matmul.py:
//
// - ::_kernel, per-channel scales (through _pallas_int4 -> pl.pallas_call):
//   every projection of a weight_bits=4 Llama at the speculative verify's
//   rows, and its fp32 LM head;
// - ::_kernel_grouped, group-wise scales (through _pallas_int4_grouped ->
//   pl.pallas_call): the int4_group=128 engines, every decode-step
//   projection and the fp32 LM head.
//
// What it computes. W4 is the pack_int4 layout: [K, N/2] int8, output
// channels tiled by tile_n; within tile j the low nibbles of packed column
// j*T/2 + o hold channel j*T + o and the high nibbles channel j*T + T/2 + o.
// A nibble is sign-extended as ((q & 15) ^ 8) - 8 (low) and q >> 4 (high, the
// arithmetic shift of the int8 byte). Per-channel: scale is fp32 [N], the
// product is accumulated in fp32 over K and then scaled, as the TPU kernel's
// (y * scale).astype(dtype). Grouped: scale is fp32 [K / group, N]; each
// K-group's fp32 partial product x[:, g] @ W4[g, :] is multiplied by its
// scale row and the product is added to an fp32 total, a separate multiply
// and add (__fmul_rn, __fadd_rn), never one FMA: the reference's o +=
// partial * scale_row. The output is rounded once to the compute dtype.
// Compute dtype bf16: x and the nibbles (exact in bf16) meet in bf16
// tensor-core products with fp32 accumulation. Compute dtype fp32 (the LM
// head's logits contract): fp32 FMA on the CUDA cores, never TF32. A row's
// output bits never depend on how many rows share the launch (the
// speculative verify's 40 rows give each row what an 8-row decode gives
// it): every split of K and every summation order is fixed by (K, N) and
// the group.
//
// Bound on the H100: bytes for bf16. Each weight is read once at 4 bits
// (grouped: plus its fp32 scale, 1/16 of the weight bytes at g = 128); at
// 40 rows a byte of weights feeds 160 operations, under the bf16
// tensor-core balance (about 295 operations per byte) but more than half
// of it, so the products have to run at half the bf16 peak while the
// weights stream. The fp32 form is bound by the CUDA cores' 67 TFLOP/s (the
// 128256-channel LM head: 0.63 ms at 40 rows, 0.25 ms at the grouped
// engine's 16, against 0.08 ms of bytes).
//
// bf16 design (int4_channel_bf16_kernel<NR, GROUPED>). A CTA owns 128
// output channels (64 packed columns) of one of S K-slices; S is the
// smallest power of two that puts (N/128) * S CTAs at or above the card's
// 132 SMs, at most 8 and at most one unit a slice, a unit being a 128-row
// chunk (per-channel) or a whole scale group (ops/int4_matmul.py::_k_splits,
// a function of K, N and the group alone: 8 at the Llama-3-8B k/v, q/o and
// down projections, 2 at gate/up, in both forms at g = 128). The S CTAs of
// one channel tile form a thread block cluster. In each CTA a producer warp
// streams [128 K rows x 64 packed columns] weight tiles (TMA, 64-byte
// swizzle) and x's two [rows x 64] bf16 chunks (TMA, 128-byte swizzle)
// through a ring of stages (72 KB: three CTAs an SM); grouped, each stage
// also holds its chunk's group scales for the tile's 128 channels (two
// 64-float TMA rows), per-channel the producer's other lanes fetch the
// tile's 128 scales once. One consumer warpgroup reads each weight tile with
// ldmatrix.trans: a lane receives two packed columns at two consecutive K
// rows, i.e. for both columns the low and the high nibble at (k, k + 1).
// lop3/prmt and one packed bf16x2 FMA turn two nibbles into the bf16x2 that
// wgmma takes as A in registers, so the products run with the channels as M
// (two m64 tiles: low nibbles, high nibbles) and x^T as B (K-major from the
// swizzled x chunk) at n = rows rounded up to 8: a 40-row verify issues n =
// 40. A chunk runs as four commit groups of 32 K rows, each group's
// dequantization under the group before's products; the chunk ends waiting
// on its products (the stage is released only then), so no product is in
// flight across the loop's back edge. Grouped, that wait is also the group
// end: a thread's accumulators are 4 channels (M rows) x NR/4 rows, so it
// reads 4 scales from the stage, adds acc * scale into an fp32 total held in
// registers and zeroes the accumulators; a group of several chunks scales at
// its last chunk. Epilogue: each CTA writes its fp32 partial (per-channel
// the raw sums, grouped the scaled totals) [rows x 128] to its own shared
// memory; after a cluster barrier each rank takes 1/S of the tile, reads the
// S partials over distributed shared memory and sums them in rank order (no
// atomics: reruns give the same bits), then (per-channel) scales each
// channel, rounds once to bf16 and stores. What bounds it here (PERF.md,
// section 6): a fixed cost of launch, first loads, cluster barriers and
// reduction at every shape, then the warpgroup's chain of dequantization
// and n = 40 products, below the half of the bf16 peak that 40 rows need
// to stay bound by bytes.
//
// fp32 design (int4_channel_fp32_kernel<NR, GROUPED>). A CTA of 128 threads
// owns 128 packed columns (256 channels) and walks all of K (the LM head's
// 501 CTAs fill the card without a split). A ring of 4 stages (TMA) holds
// [32 K rows x 128 packed columns] of weights and [rows x 32] of x. Each
// thread owns one packed column and every row (rows rounded up to 8): it
// unpacks its byte at each k once (the float 2^23 + (v ^ 8), minus 2^23 +
// 8) and reuses both values across all rows, with x read as float4
// broadcasts; each output is one fp32 FMA chain in K order, per-channel
// over all of K, grouped over one group, whose chain is then scaled and
// added (multiply, then add) into a total kept in the thread's own slots of
// shared memory (2 x NR floats; the scales of the next group are loaded
// while this one runs).
//
// The simple path (int4_channel_simple_kernel). TMA needs 16-byte aligned
// bases and row strides: N/2 a multiple of 16, K a multiple of 8 (bf16) or
// 4 (fp32); grouped bf16 also reads a tile's 64 low (high) channels' scales
// as one run, so a half tile is a multiple of 64 channels or the tile is
// all of N. Any other call (ops/int4_matmul.py::_tma_path says which) runs
// one thread per (row, packed column) and one fp32 FMA chain per output and
// group in K order, in both compute dtypes and both scale forms.
//
// On the TPU the K grid axis ran in order with the output block carried
// between steps; here the K split and the in-order cluster sum take its
// place, so the card fills at decode row counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MAX_ROWS = 64;
constexpr int PC = 64;                      // packed columns per CTA: 128 channels
constexpr int CH = 2 * PC;
constexpr int KC = 128;                     // K rows per ring stage and per slice chunk
constexpr int W_TILE = KC * PC;             // packed bytes per stage: 8 KB
constexpr int KG = 32;                      // K rows per wgmma commit group
constexpr int MAX_SPLITS = 8;
constexpr int MAX_STAGES = 8;
constexpr int SCALE_SLOT = CH * 4;          // a stage's group scales (grouped): 512 bytes

constexpr int CONSUMERS = 128;              // one warpgroup
constexpr int THREADS = CONSUMERS + 32;     // and the producer warp
constexpr int PITCH = CH + 8;               // floats per row of the fp32 partial
constexpr int PER_SM = 3;                   // CTAs an SM
constexpr int SMEM_BUDGET = 72 * 1024;      // the ring's share of an SM's shared memory

__device__ __forceinline__ int channel_at(int c, int hi, int tile) {
  const int half_t = tile / 2;
  return (c / half_t) * tile + hi * half_t + (c % half_t);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// bf16x2 v * 1 - 136, exact for v in [128, 143]
__device__ __forceinline__ uint32_t minus_136(uint32_t v) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// One ldmatrix.trans word, bytes (k, c), (k, c + 1), (k + 1, c), (k + 1, c + 1),
// into the bf16x2 A registers (k, k + 1) of: the low nibbles of column c, of
// c + 1, the high nibbles of c, of c + 1. A nibble v becomes the bf16 bits
// 0x4300 | (v ^ 8), i.e. 128 + (v ^ 8), and the subtract of 136 leaves
// (v ^ 8) - 8: the low nibble's ((q & 15) ^ 8) - 8 and the high nibble's
// arithmetic q >> 4.
__device__ __forceinline__ void dequant(uint32_t q, uint32_t& lo0, uint32_t& lo1, uint32_t& hi0,
                                        uint32_t& hi1) {
  const uint32_t ml = (q & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t mh = ((q >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  lo0 = minus_136(prmt(ml, 0x43434343u, 0x4240u));
  lo1 = minus_136(prmt(ml, 0x43434343u, 0x4341u));
  hi0 = minus_136(prmt(mh, 0x43434343u, 0x4240u));
  hi1 = minus_136(prmt(mh, 0x43434343u, 0x4341u));
}

// total += acc * s, rounded after the multiply and after the add (the
// reference's rounding points), then acc = 0
__device__ __forceinline__ void scale_into(float& total, float& acc, float s) {
  total = __fadd_rn(total, __fmul_rn(acc, s));
  acc = 0.f;
}

// NR: rows rounded up to 8, the wgmma n. Grid (splits, ceil(N/2 / PC)), in
// clusters of `splits` CTAs along x: CTA (rank, j) owns channel tile j of
// K-slice `rank`. GROUPED: s_map is the [K / group, N] scale map (boxes of
// 64 channels of one group row), group the group's K rows.
template <int NR, bool GROUPED>
__global__ void __launch_bounds__(THREADS, (GROUPED && NR > 40) ? 2 : PER_SM)
int4_channel_bf16_kernel(const __grid_constant__ CUtensorMap w_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap s_map,
                         const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                         int rows, int k, int n, int tile, int group, int stages) {
  constexpr uint32_t X_CHUNK = NR * 128;  // one 64-column chunk of x, 128-byte swizzle
  constexpr uint32_t STAGE = W_TILE + 2 * X_CHUNK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t group_scales = base + stages * STAGE;  // GROUPED: [stage][CH] fp32
  const uint32_t bars = group_scales + (GROUPED ? stages * SCALE_SLOT : 0);  // full, then empty
  const uint32_t scales = bars + 16u * stages;  // per-channel: the tile's scales, local order

  const int tid = threadIdx.x;
  const int rank = blockIdx.x, splits = gridDim.x;
  const int half_n = n / 2;
  const int c0 = blockIdx.y * PC;
  const int chunks = (k + KC - 1) / KC;
  // the K split cuts whole units: a 128-row chunk per-channel, a whole
  // group (a multiple of 128 rows, or all of K) grouped
  const int per_unit = GROUPED ? (group + KC - 1) / KC : 1;
  const int units = (chunks + per_unit - 1) / per_unit;
  const int first = rank * units / splits * per_unit;
  const int count = min((rank + 1) * units / splits * per_unit, chunks) - first;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8u * s, 1);
      mbar_init(bars + 8u * (stages + s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc_lo[NR / 2], acc_hi[NR / 2], tot_lo[NR / 2], tot_hi[NR / 2];  // tot: grouped
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) acc_lo[i] = acc_hi[i] = tot_lo[i] = tot_hi[i] = 0.f;

  if (tid >= CONSUMERS) {
    // ---------------- producer: one thread issues every copy ----------------
    // (per-channel, the other lanes fetch the tile's scales for the epilogue
    // meanwhile, every load issued before the first store)
    if (!GROUPED && tid > CONSUMERS) {
      constexpr int PER = (CH + 30) / 31;
      float v[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int q = tid - CONSUMERS - 1 + 31 * j;
        const int c = c0 + q % PC;
        v[j] = q < CH && c < half_n ? __ldg(scale + channel_at(c, q / PC, tile)) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int q = tid - CONSUMERS - 1 + 31 * j;
        if (q < CH) st_shared_b32(scales + 4u * q, __float_as_uint(v[j]));
      }
    }
    if (tid == CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&w_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&x_map)) : "memory");
      // a group's 64 low (high) channels are one run of the scale row
      const int lo_run = channel_at(c0, 0, tile), hi_run = channel_at(c0, 1, tile);
      for (int i = 0; i < count; ++i) {
        const int s = i % stages;
        const uint32_t full = bars + 8u * s;
        if (i >= stages) mbar_wait(bars + 8u * (stages + s), ((i / stages) - 1) & 1);
        const uint32_t st = base + s * STAGE;
        const int k0 = (first + i) * KC;
        mbar_expect_tx(full, STAGE + (GROUPED ? SCALE_SLOT : 0));
        tma_load_2d(st, &w_map, full, c0, k0);
        tma_load_2d(st + W_TILE, &x_map, full, k0, 0);
        tma_load_2d(st + W_TILE + X_CHUNK, &x_map, full, k0 + 64, 0);
        if constexpr (GROUPED) {
          const int g = (first + i) / per_unit;
          const uint32_t sc = group_scales + s * SCALE_SLOT;
          tma_load_2d(sc, &s_map, full, lo_run, g);
          tma_load_2d(sc + SCALE_SLOT / 2, &s_map, full, hi_run, g);
        }
      }
    }
  } else {
    // ---------------- consumers: 128 channels x NR rows ----------------
    const int warp = tid / 32, lane = tid % 32;
    for (int i = 0; i < count; ++i) {
      const int s = i % stages;
      mbar_wait(bars + 8u * s, (i / stages) & 1);
      const uint32_t w_s = base + s * STAGE, x_s = w_s + W_TILE;
#pragma unroll
      for (int gi = 0; gi < KC / KG; ++gi) {  // commit groups of KG K rows
        uint32_t alo[KG / 16][4], ahi[KG / 16][4];  // [16-row k step][A register]
#pragma unroll
        for (int b = 0; b < KG / 32; ++b) {
          // lane l addresses K row l of this 32-row block: row l % 8 of
          // matrix l / 8; the warp's 16-byte column chunk under 64-byte swizzle
          const int kr = gi * KG + b * 32 + lane;
          uint32_t q[4];
          ldmatrix_x4_trans(q, w_s + kr * PC + ((warp ^ ((kr >> 1) & 3)) << 4));
#pragma unroll
          for (int m = 0; m < 4; ++m) {  // matrix m: K rows 8m .. 8m + 7 of the block
            const int ks = 2 * b + m / 2, r = 2 * (m % 2);
            dequant(q[m], alo[ks][r], alo[ks][r + 1], ahi[ks][r], ahi[ks][r + 1]);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KG / 16; ++ks) {
          const int kk = gi * (KG / 16) + ks;  // 16-row k step within the stage
          const uint64_t bd = desc_sw128(x_s + (kk / 4) * X_CHUNK + (kk % 4) * 32, 16, 1024);
          wgmma_rs_kmajor(acc_lo, alo[ks], bd);
          wgmma_rs_kmajor(acc_hi, ahi[ks], bd);
        }
        wgmma_commit();
        // the group before is done: its A registers are free for the next
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
      fence_regs(acc_lo);
      fence_regs(acc_hi);
      if (GROUPED && ((first + i + 1) % per_unit == 0 || first + i + 1 == chunks)) {
        // group end. Accumulator (M row 16 warp + g (+ 8), n col 8 j + 2 t
        // (+ 1)): M row 16 warp + g is local column 16 warp + 2 g, + 8 the
        // next, so a thread's channels are two adjacent local columns of
        // each half
        const uint32_t sc = group_scales + s * SCALE_SLOT + 4u * (16 * warp + 2 * (lane / 4));
        const float s_lo0 = __uint_as_float(ld_shared_b32(sc));
        const float s_lo1 = __uint_as_float(ld_shared_b32(sc + 4));
        const float s_hi0 = __uint_as_float(ld_shared_b32(sc + SCALE_SLOT / 2));
        const float s_hi1 = __uint_as_float(ld_shared_b32(sc + SCALE_SLOT / 2 + 4));
#pragma unroll
        for (int j = 0; j < NR / 8; ++j) {
          scale_into(tot_lo[4 * j], acc_lo[4 * j], s_lo0);
          scale_into(tot_lo[4 * j + 1], acc_lo[4 * j + 1], s_lo0);
          scale_into(tot_lo[4 * j + 2], acc_lo[4 * j + 2], s_lo1);
          scale_into(tot_lo[4 * j + 3], acc_lo[4 * j + 3], s_lo1);
          scale_into(tot_hi[4 * j], acc_hi[4 * j], s_hi0);
          scale_into(tot_hi[4 * j + 1], acc_hi[4 * j + 1], s_hi0);
          scale_into(tot_hi[4 * j + 2], acc_hi[4 * j + 2], s_hi1);
          scale_into(tot_hi[4 * j + 3], acc_hi[4 * j + 3], s_hi1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8u * (stages + s));
    }

    // this CTA's fp32 partial [NR][PITCH] over the ring, once every consumer
    // warp is past its last read of it: local column q < 64 is the low nibble
    // of packed column c0 + q, q >= 64 the high nibble of q - 64.
    bar_sync(1, CONSUMERS);
    float* part = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)));
    const int g = lane / 4, t = lane % 4;
    auto store_part = [&](const float (&lo)[NR / 2], const float (&hi)[NR / 2]) {
#pragma unroll
      for (int j = 0; j < NR / 8; ++j) {
        float* p0 = part + (8 * j + 2 * t) * PITCH + 16 * warp + 2 * g;
        float* p1 = p0 + PITCH;
        *reinterpret_cast<float2*>(p0) = make_float2(lo[4 * j], lo[4 * j + 2]);
        *reinterpret_cast<float2*>(p1) = make_float2(lo[4 * j + 1], lo[4 * j + 3]);
        *reinterpret_cast<float2*>(p0 + PC) = make_float2(hi[4 * j], hi[4 * j + 2]);
        *reinterpret_cast<float2*>(p1 + PC) = make_float2(hi[4 * j + 1], hi[4 * j + 3]);
      }
    };
    if constexpr (GROUPED) {
      store_part(tot_lo, tot_hi);
    } else {
      store_part(acc_lo, acc_hi);
    }
  }
  cluster_sync();

  // each rank finishes 1/S of the tile: the S partials summed in rank order,
  // then (per-channel) scaled per channel and rounded once; two units of 4
  // columns a thread at a time, every load of both issued before the sums
  constexpr int QUADS = CH / 4;
  const int outs = rows * QUADS;
  const int u0 = rank * outs / splits, u1 = (rank + 1) * outs / splits;
  for (int u = u0 + tid; u < u1; u += 2 * THREADS) {
    float4 v[2][MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int uj = min(u + j * THREADS, u1 - 1);
      const uint32_t off = base + ((uj / QUADS) * PITCH + (uj % QUADS) * 4) * 4;
#pragma unroll
      for (int src = 0; src < MAX_SPLITS; ++src) {
        if (src < splits) v[j][src] = ld_cluster_f4(cluster_map(off, src));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int uj = u + j * THREADS;
      if (uj >= u1) break;
      float4 tot = v[j][0];
#pragma unroll
      for (int src = 1; src < MAX_SPLITS; ++src) {
        if (src < splits) {
          tot.x += v[j][src].x;
          tot.y += v[j][src].y;
          tot.z += v[j][src].z;
          tot.w += v[j][src].w;
        }
      }
      const int r = uj / QUADS, q0 = (uj % QUADS) * 4;
      const int c = c0 + q0 % PC;
      if (c < half_n) {  // TMA path: N/2 % 16 == 0, so all four columns are real and contiguous
        const int ch = channel_at(c, q0 / PC, tile);
        uint2 packed;
        if constexpr (GROUPED) {
          packed.x = pack_bf16(tot.x, tot.y);
          packed.y = pack_bf16(tot.z, tot.w);
        } else {
          const uint32_t sa = scales + 4u * q0;
          packed.x = pack_bf16(tot.x * __uint_as_float(ld_shared_b32(sa)),
                               tot.y * __uint_as_float(ld_shared_b32(sa + 4)));
          packed.y = pack_bf16(tot.z * __uint_as_float(ld_shared_b32(sa + 8)),
                               tot.w * __uint_as_float(ld_shared_b32(sa + 12)));
        }
        *reinterpret_cast<uint2*>(out + (size_t)r * n + ch) = packed;
      }
    }
  }
  // no CTA leaves while another reads its partial (loads complete before
  // their sums, so the arrival needs no release)
  asm volatile("barrier.cluster.arrive.relaxed;\nbarrier.cluster.wait;" ::: "memory");
}

constexpr int F_THREADS = 128;              // fp32: one packed column a thread
constexpr int F_KC = 32;                    // K rows per stage
constexpr int F_STAGES = 4;
constexpr int F_W_STAGE = F_KC * F_THREADS; // 4 KB

// NR: rows rounded up to 8. Grid ceil(N/2 / 128). GROUPED: after the ring,
// the totals [2][NR][F_THREADS] fp32 (low, high channel), a thread's own
// slots.
template <int NR, bool GROUPED>
__global__ void __launch_bounds__(F_THREADS)
int4_channel_fp32_kernel(const __grid_constant__ CUtensorMap w_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const float* __restrict__ scale, float* __restrict__ out, int rows,
                         int k, int n, int tile, int group) {
  constexpr uint32_t STAGE = F_W_STAGE + NR * F_KC * 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 127u) & ~127u;
  const unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t bars = base + F_STAGES * STAGE;
  float* totals = reinterpret_cast<float*>(
      smem_raw + (base - smem_addr(smem_raw)) + F_STAGES * STAGE + 8 * F_STAGES);

  const int tid = threadIdx.x;
  const int half_n = n / 2;
  const int c0 = blockIdx.x * F_THREADS;
  const int chunks = (k + F_KC - 1) / F_KC;
  const int c = c0 + tid;
  const bool real = c < half_n;
  const int ch_lo = real ? channel_at(c, 0, tile) : 0, ch_hi = real ? channel_at(c, 1, tile) : 0;

  auto issue = [&](int i) {
    const int s = i % F_STAGES;
    const uint32_t st = base + s * STAGE, full = bars + 8u * s;
    mbar_expect_tx(full, STAGE);
    tma_load_2d(st, &w_map, full, c0, i * F_KC);
    tma_load_2d(st + F_W_STAGE, &x_map, full, i * F_KC, 0);
  };
  if (tid == 0) {
    for (int s = 0; s < F_STAGES; ++s) mbar_init(bars + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < F_STAGES && i < chunks; ++i) issue(i);
  }
  if constexpr (GROUPED) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      totals[r * F_THREADS + tid] = 0.f;
      totals[(NR + r) * F_THREADS + tid] = 0.f;
    }
  }
  __syncthreads();

  // grouped: the scales of the group that runs, loaded one group ahead
  float s_lo = 0.f, s_hi = 0.f;
  if (GROUPED && real) {
    s_lo = __ldg(scale + ch_lo);
    s_hi = __ldg(scale + ch_hi);
  }
  float lo[NR], hi[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) lo[r] = hi[r] = 0.f;
  for (int i = 0; i < chunks; ++i) {
    const int s = i % F_STAGES;
    mbar_wait(bars + 8u * s, (i / F_STAGES) & 1);
    const int8_t* ws = reinterpret_cast<const int8_t*>(gbase + s * STAGE);
    const float* xs = reinterpret_cast<const float*>(gbase + s * STAGE + F_W_STAGE);
#pragma unroll 2
    for (int k4 = 0; k4 < F_KC / 4; ++k4) {
      float wl[4], wh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = ws[(4 * k4 + j) * F_THREADS + tid];
        wl[j] = __int_as_float(((q & 15) ^ 8) | 0x4B000000) - 8388616.f;
        wh[j] = __int_as_float((((q >> 4) & 15) ^ 8) | 0x4B000000) - 8388616.f;
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * F_KC + 4 * k4);
        lo[r] = fmaf(xv.x, wl[0], lo[r]);
        hi[r] = fmaf(xv.x, wh[0], hi[r]);
        lo[r] = fmaf(xv.y, wl[1], lo[r]);
        hi[r] = fmaf(xv.y, wh[1], hi[r]);
        lo[r] = fmaf(xv.z, wl[2], lo[r]);
        hi[r] = fmaf(xv.z, wh[2], hi[r]);
        lo[r] = fmaf(xv.w, wl[3], lo[r]);
        hi[r] = fmaf(xv.w, wh[3], hi[r]);
      }
    }
    __syncthreads();  // stage s is free
    if (tid == 0 && i + F_STAGES < chunks) issue(i + F_STAGES);
    if constexpr (GROUPED) {
      if (((i + 1) * F_KC) % group == 0 || i + 1 == chunks) {
        // group end: the chain times its scale row into the totals; the next
        // group's scales are fetched now, used a group later
        const int next = (i + 1) * F_KC / group;
        float n_lo = 0.f, n_hi = 0.f;
        if (real && i + 1 < chunks) {
          n_lo = __ldg(scale + (size_t)next * n + ch_lo);
          n_hi = __ldg(scale + (size_t)next * n + ch_hi);
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          float& t_lo = totals[r * F_THREADS + tid];
          float& t_hi = totals[(NR + r) * F_THREADS + tid];
          t_lo = __fadd_rn(t_lo, __fmul_rn(lo[r], s_lo));
          t_hi = __fadd_rn(t_hi, __fmul_rn(hi[r], s_hi));
          lo[r] = hi[r] = 0.f;
        }
        s_lo = n_lo;
        s_hi = n_hi;
      }
    }
  }

  if (real) {
    float p_lo = 0.f, p_hi = 0.f;
    if (!GROUPED) {
      p_lo = __ldg(scale + ch_lo);
      p_hi = __ldg(scale + ch_hi);
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r < rows) {
        if constexpr (GROUPED) {
          out[(size_t)r * n + ch_lo] = totals[r * F_THREADS + tid];
          out[(size_t)r * n + ch_hi] = totals[(NR + r) * F_THREADS + tid];
        } else {
          out[(size_t)r * n + ch_lo] = lo[r] * p_lo;
          out[(size_t)r * n + ch_hi] = hi[r] * p_hi;
        }
      }
    }
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the simple path: thread (row blockIdx.y, packed column), one fp32 FMA
// chain per output (grouped: per output and group, each chain scaled into
// the total) in K order
template <typename T>
__global__ void __launch_bounds__(128)
int4_channel_simple_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ scale, T* __restrict__ out, int k, int n,
                           int tile, int group) {
  const int half_n = n / 2;
  const int c = blockIdx.x * 128 + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= half_n) return;
  const int ch_lo = channel_at(c, 0, tile), ch_hi = channel_at(c, 1, tile);
  float lo = 0.f, hi = 0.f, tot_lo = 0.f, tot_hi = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    const float xv = to_float(x[(size_t)r * k + kk]);
    const int q = w[(size_t)kk * half_n + c];
    lo = fmaf(xv, (float)(((q & 15) ^ 8) - 8), lo);
    hi = fmaf(xv, (float)(q >> 4), hi);
    if (group && (kk + 1) % group == 0) {
      const size_t g = (size_t)(kk / group) * n;
      scale_into(tot_lo, lo, scale[g + ch_lo]);
      scale_into(tot_hi, hi, scale[g + ch_hi]);
    }
  }
  store(out + (size_t)r * n + ch_lo, group ? tot_lo : lo * scale[ch_lo]);
  store(out + (size_t)r * n + ch_hi, group ? tot_hi : hi * scale[ch_hi]);
}

// the kernels whose shared-memory limit this library has raised, by [bf16
// per-channel, bf16 grouped, fp32 per-channel, fp32 grouped][NR / 8] (a
// library-local table: a static inside a template would be one object
// across every loaded copy of the library)
bool smem_set[4][9];

template <int NR, bool GROUPED>
cudaError_t launch_bf16(const void* x, const void* w, const float* s, void* out, int rows, int k,
                        int n, int tile, int group, int splits, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap w_map, x_map, s_map = {};
  if (!make_map_2d(encode, &w_map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n / 2, k, PC, KC,
                   CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_2d(encode, &x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, rows, 64, NR,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      (GROUPED && !make_map_2d(encode, &s_map, s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, n,
                               k / group, CH / 2, 1, CU_TENSOR_MAP_SWIZZLE_NONE))) {
    return cudaErrorInvalidValue;
  }
  constexpr int STAGE = W_TILE + NR * 256;
  constexpr int SLOT = STAGE + (GROUPED ? SCALE_SLOT : 0);
  constexpr int FIT = SMEM_BUDGET / SLOT;
  constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  constexpr int SMEM = 1024 + STAGES * SLOT + 16 * STAGES + 4 * CH;
  static_assert(NR * PITCH * 4 <= STAGES * STAGE, "the partial fits in the ring");
  bool& ready = smem_set[GROUPED ? 1 : 0][NR / 8];
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(int4_channel_bf16_kernel<NR, GROUPED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (n / 2 + PC - 1) / PC);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one CTA is a cluster of its own
  return cudaLaunchKernelEx(&cfg, int4_channel_bf16_kernel<NR, GROUPED>, w_map, x_map, s_map, s,
                            static_cast<__nv_bfloat16*>(out), rows, k, n, tile, group, STAGES);
}

template <int NR, bool GROUPED>
cudaError_t launch_fp32(const void* x, const void* w, const float* s, void* out, int rows, int k,
                        int n, int tile, int group, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap w_map, x_map;
  if (!make_map_2d(encode, &w_map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n / 2, k, F_THREADS,
                   F_KC, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_2d(encode, &x_map, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, k, rows, F_KC, NR,
                   CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return cudaErrorInvalidValue;
  }
  constexpr int SMEM = 128 + F_STAGES * (F_W_STAGE + NR * F_KC * 4) + 8 * F_STAGES +
                       (GROUPED ? 2 * NR * F_THREADS * 4 : 0);
  bool& ready = smem_set[GROUPED ? 3 : 2][NR / 8];
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(int4_channel_fp32_kernel<NR, GROUPED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  int4_channel_fp32_kernel<NR, GROUPED>
      <<<(n / 2 + F_THREADS - 1) / F_THREADS, F_THREADS, SMEM, stream>>>(
          w_map, x_map, s, static_cast<float*>(out), rows, k, n, tile, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simple(const void* x, const void* w, const float* s, void* out, int rows, int k,
                          int n, int tile, int group, cudaStream_t stream) {
  const dim3 grid((n / 2 + 127) / 128, rows);
  int4_channel_simple_kernel<T><<<grid, 128, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), s, static_cast<T*>(out), k, n,
      tile, group);
  return cudaGetLastError();
}

template <int NR>
cudaError_t launch_tma(const void* x, const void* w, const float* s, void* out, int rows, int k,
                       int n, int tile, int group, int splits, int fp32, cudaStream_t stream) {
  if (fp32) {
    return group ? launch_fp32<NR, true>(x, w, s, out, rows, k, n, tile, group, stream)
                 : launch_fp32<NR, false>(x, w, s, out, rows, k, n, tile, 0, stream);
  }
  return group ? launch_bf16<NR, true>(x, w, s, out, rows, k, n, tile, group, splits, stream)
               : launch_bf16<NR, false>(x, w, s, out, rows, k, n, tile, 0, splits, stream);
}

}  // namespace

// x: [rows, k] (bf16 if fp32 == 0, else fp32); w: [k, n / 2] int8 in the
// pack_int4 tile-slab order of tile_n; scale: fp32 [n] (group == 0,
// per-channel) or [k / group, n] (group divides k and is a multiple of 128
// or all of k); out: [rows, n] in x's dtype; all contiguous on the device.
// 1 <= rows <= 64; n even and a multiple of tile_n. splits: the number of
// K-slices (a power of two, at most 8 and at most the number of units,
// 128-row chunks per-channel or whole groups; 1 for fp32), chosen from (k,
// n, group) by the caller. simple != 0 takes the simple path; otherwise x
// and w must be 16-byte aligned, n / 2 a multiple of 16 and k of 8 (bf16)
// or 4 (fp32), and (grouped bf16) tile_n / 2 a multiple of 64 or tile_n ==
// n and scale 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int int4_matmul_fwd(const void* x, const void* w, const void* scale, void* out,
                               int rows, int k, int n, int tile_n, int group, int splits,
                               int fp32, int simple, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return 0;
  if (rows > MAX_ROWS || k <= 0 || n % 2 || tile_n <= 0 || tile_n % 2 || n % tile_n ||
      group < 0 || (group && (k % group || (group != k && group % KC))))
    return (int)cudaErrorInvalidValue;
  const int chunks = (k + KC - 1) / KC;
  const int per_unit = group ? (group + KC - 1) / KC : 1;
  const int units = (chunks + per_unit - 1) / per_unit;
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) || splits > units ||
      (fp32 && splits != 1))
    return (int)cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale);
  if (simple) {
    return fp32 ? (int)launch_simple<float>(x, w, sp, out, rows, k, n, tile_n, group, st)
                : (int)launch_simple<__nv_bfloat16>(x, w, sp, out, rows, k, n, tile_n, group, st);
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0 ||
      (n / 2) % 16 != 0 || k % (fp32 ? 4 : 8) != 0 ||
      (group && !fp32 &&
       (reinterpret_cast<uintptr_t>(scale) % 16 != 0 ||
        ((tile_n / 2) % (CH / 2) != 0 && tile_n != n))))
    return (int)cudaErrorMisalignedAddress;  // TMA: 16-byte aligned bases and row strides
#define INT4_CASE(R) \
  case R:            \
    return (int)launch_tma<R>(x, w, sp, out, rows, k, n, tile_n, group, splits, fp32, st);
  switch ((rows + 7) / 8 * 8) {
    INT4_CASE(8)
    INT4_CASE(16)
    INT4_CASE(24)
    INT4_CASE(32)
    INT4_CASE(40)
    INT4_CASE(48)
    INT4_CASE(56)
    INT4_CASE(64)
  }
#undef INT4_CASE
  return (int)cudaErrorInvalidValue;
}
