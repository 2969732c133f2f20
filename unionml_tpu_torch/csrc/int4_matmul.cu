// Packed-int4 weight-only matmul for Hopper (sm_90a): y[rows, N] = x[rows, K]
// @ W4 for decode-sized row counts (rows <= 64), per-channel or group-wise
// scales. Two C entries, one per TPU kernel:
//
// - int4_matmul_channel_fwd, per-channel scales. Replaces
//   unionml_tpu/ops/int4_matmul.py::_kernel (reached through _pallas_int4
//   -> pl.pallas_call): every projection of a weight_bits=4 Llama at the
//   speculative verify's rows, and its fp32 LM head.
// - int4_matmul_fwd, group-wise scales. Replaces ::_kernel_grouped (through
//   _pallas_int4_grouped -> pl.pallas_call): the int4_group=128 engines.
//
// What both compute. W4 is the pack_int4 layout: [K, N/2] int8, output
// channels tiled by tile_n; within tile j the low nibbles of packed column
// j*T/2 + o hold channel j*T + o and the high nibbles channel j*T + T/2 + o.
// A nibble is sign-extended as ((q & 15) ^ 8) - 8 (low) and q >> 4 (high, the
// arithmetic shift of the int8 byte). scale is fp32 [K / group, N]: each
// K-group's fp32 partial product x[:, g] @ W4[g, :] is multiplied by its scale
// row before it is added to the output; the per-channel form is one group of
// all of K, so the product is accumulated in fp32 over K and then scaled, as
// the TPU kernel's (y * scale).astype(dtype). The output is rounded once to
// the compute dtype. Compute dtype bf16: x and the nibbles (exact in bf16)
// meet in bf16 tensor-core products with fp32 accumulation. Compute dtype
// fp32 (the LM head's logits contract): fp32 FMA on the CUDA cores, never
// TF32. A row's output bits never depend on how many rows share the launch
// (the speculative verify's 40 rows give each row what an 8-row decode
// gives it): every split of K and every summation order is fixed by (K, N).
//
// Bound on the H100: bytes for bf16. Each weight is read once at 4 bits; at
// 40 rows a byte of weights feeds 160 operations, under the bf16 tensor-core
// balance (about 295 operations per byte) but more than half of it, so the
// products have to run at half the bf16 peak while the weights stream. The
// fp32 form is bound by the CUDA cores' 67 TFLOP/s (40 rows: 0.63 ms at the
// 128256-channel LM head against 0.08 ms of bytes).
//
// Per-channel bf16 design (int4_channel_bf16_kernel). A CTA owns 128 output
// channels (64 packed columns) of one of S K-slices; S is the smallest power
// of two that puts (N/128) * S CTAs at or above the card's 132 SMs, at most
// 8 and at most one 128-row chunk a slice (ops/int4_matmul.py::_k_splits,
// a function of K and N alone: 8 at the Llama-3-8B k/v, q/o and down
// projections, 2 at gate/up). The S CTAs of one channel tile form a thread
// block cluster. In each CTA a producer warp streams [128 K rows x 64 packed
// columns] weight tiles (TMA, 64-byte swizzle) and x's two [rows x 64] bf16
// chunks (TMA, 128-byte swizzle) through a ring of 3-7 stages (72 KB: three
// CTAs an SM), while its other lanes fetch the tile's 128 scales. One
// consumer warpgroup reads each weight tile with ldmatrix.trans: a lane
// receives two packed columns at two consecutive K rows, i.e. for both
// columns the low and the high nibble at (k, k + 1). lop3/prmt and one
// packed bf16x2 FMA turn two nibbles into the bf16x2 that wgmma takes as A
// in registers, so the products run with the channels as M (two m64 tiles:
// low nibbles, high nibbles) and x^T as B (K-major from the swizzled x
// chunk) at n = rows rounded up to 8: a 40-row verify issues n = 40. A
// chunk runs as four commit groups of 32 K rows, each group's
// dequantization under the group before's products; no product is in
// flight across the loop's back edge. Epilogue: each CTA writes its fp32
// partial [rows x 128] to its own shared memory; after a cluster barrier
// each rank takes 1/S of the tile, reads the S partials over distributed
// shared memory and sums them in rank order (no atomics: reruns give the
// same bits), then scales each channel, rounds once to bf16 and stores.
// What bounds it here (PERF.md, section 6): a fixed cost of launch, first
// loads, cluster barriers and reduction at every shape, then the
// warpgroup's chain of dequantization and n = 40 products, below the half
// of the bf16 peak that 40 rows need to stay bound by bytes.
//
// Per-channel fp32 design (int4_channel_fp32_kernel). A CTA of 128 threads
// owns 128 packed columns (256 channels) and walks all of K (the LM head's
// 501 CTAs fill the card without a split). A ring of 4 stages (TMA) holds
// [32 K rows x 128 packed columns] of weights and [rows x 32] of x. Each
// thread owns one packed column and every row (rows rounded up to 8):
// it unpacks its byte at each k once (the float 2^23 + (v ^ 8), minus 2^23
// + 8) and reuses both values across all rows, with x read as float4
// broadcasts; each output is one fp32 FMA chain in K order.
//
// The simple path (int4_channel_simple_kernel). TMA needs 16-byte aligned
// bases and row strides: N/2 a multiple of 16, K a multiple of 8 (bf16) or
// 4 (fp32). Any other per-channel call (ops/int4_matmul.py::_tma_path says
// which) runs one thread per (row, packed column) and one fp32 FMA chain
// per output in K order, in both compute dtypes.
//
// Group-wise design (int4_matmul_bf16_kernel / int4_matmul_fp32_kernel, the
// first version, kept for row 8): each block owns 32 packed columns, i.e.
// 64 output channels (32 low, 32 high, each run contiguous in the output),
// and walks all of K in 128-row chunks, so every output element is reduced
// in the same order whatever the row count. A chunk's packed bytes are
// read from device memory once, with 16-byte loads issued one chunk ahead
// into registers while the current chunk computes, then unpacked and staged
// in shared memory beside x's chunk. bf16: 4 warps, one 16-channel column
// tile each, hold one fp32 WMMA accumulator per 16-row tile (the row-tile
// count is a template parameter, so registers and shared memory follow the
// row count); at each group end the accumulators go through shared memory
// into per-thread fp32 totals, each thread owning one channel and so one
// scale per group. fp32: one thread per (packed column, warp) keeps both
// channels' accumulators for rows warp + 4 i. On the TPU the K grid axis
// ran in order with the output block carried between steps; the loop
// inside the block takes its place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 128;     // 4 warps
constexpr int PC = 32;           // packed columns per block
constexpr int CH = 2 * PC;       // output channels per block
constexpr int MAX_ROWS = 64;

// channel of local column cl (< CH) of the block starting at packed column c0;
// -1 past the packed width
__device__ __forceinline__ int channel_of(int c0, int cl, int half_n, int tile) {
  const int c = c0 + (cl % PC);
  if (c >= half_n) return -1;
  const int half_t = tile / 2;
  return (c / half_t) * tile + (cl / PC) * half_t + (c % half_t);
}

__device__ __forceinline__ int lo_nibble(int q) { return ((q & 15) ^ 8) - 8; }
__device__ __forceinline__ int hi_nibble(int q) { return q >> 4; }  // q: sign-extended int8

// ----------------------------------------------------------------------------
// bf16 compute: WMMA 16x16x16, fp32 accumulation
// ----------------------------------------------------------------------------

constexpr int KC = 128;          // K rows per chunk (divides every routed group)
constexpr int LDX = KC + 8;      // bf16 x chunk stride
constexpr int LDW = CH + 8;      // bf16 unpacked weight stride
constexpr int LDO = CH + 4;      // fp32 partial stride
constexpr int W_VECS = KC * PC / 16 / THREADS;  // 16-byte weight loads per thread per chunk

template <int RT>
struct Bf16Smem {
  static constexpr size_t X = 0;
  static constexpr size_t W = X + (size_t)RT * 16 * LDX * 2;
  static constexpr size_t O = W + (size_t)KC * LDW * 2;
  static constexpr size_t BYTES = O + (size_t)RT * 16 * LDO * 4;
};

// RT 16-row tiles (rows <= 16 * RT). Thread t owns local channel t % CH and
// rows t / CH + 2 j of the totals, so it needs one scale per group.
template <int RT>
__global__ void __launch_bounds__(THREADS)
int4_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                        int rows, int k, int n, int tile, int group) {
  using Lay = Bf16Smem<RT>;
  constexpr int RP = RT * 16;
  constexpr int X_VECS = RP * (KC / 8) / THREADS;  // 16-byte x loads per thread per chunk
  constexpr int PER = RP * CH / THREADS;           // fp32 totals per thread
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::X);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + Lay::W);
  float* os = reinterpret_cast<float*>(smem + Lay::O);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int half_n = n / 2;
  const int c0 = blockIdx.x * PC;
  const int my_cl = tid % CH;
  const int my_r0 = tid / CH;
  const int my_ch = channel_of(c0, my_cl, half_n, tile);
  const bool w_vec = (half_n % 16 == 0) && (c0 + PC <= half_n) &&
                     (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const bool x_vec = (k % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(acc[rt], 0.f);
  float tot[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) tot[j] = 0.f;

  // the next chunk's packed weights and x, loaded into registers while the
  // current chunk computes (vector paths only)
  int4 wreg[W_VECS];
  uint4 xreg[X_VECS];
  auto load_chunk = [&](int k0) {
    if (w_vec) {
#pragma unroll
      for (int v = 0; v < W_VECS; ++v) {
        const int i = tid + v * THREADS;
        const int kr = i / (PC / 16), c = (i % (PC / 16)) * 16;
        wreg[v] = k0 + kr < k
                      ? *reinterpret_cast<const int4*>(w + (size_t)(k0 + kr) * half_n + c0 + c)
                      : make_int4(0, 0, 0, 0);
      }
    }
    if (x_vec) {
#pragma unroll
      for (int v = 0; v < X_VECS; ++v) {
        const int i = tid + v * THREADS;
        const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
        xreg[v] = (r < rows && k0 + c < k)
                      ? *reinterpret_cast<const uint4*>(x + (size_t)r * k + k0 + c)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  load_chunk(0);
  for (int k0 = 0; k0 < k; k0 += KC) {
    // weights: KC x PC packed bytes -> KC x CH bf16 nibbles (low half, high half)
    if (w_vec) {
#pragma unroll
      for (int v = 0; v < W_VECS; ++v) {
        const int i = tid + v * THREADS;
        const int kr = i / (PC / 16), c = (i % (PC / 16)) * 16;
        const int8_t* b = reinterpret_cast<const int8_t*>(&wreg[v]);
        __nv_bfloat16* row = ws + kr * LDW;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int q = b[j];
          row[c + j] = __int2bfloat16_rn(lo_nibble(q));
          row[PC + c + j] = __int2bfloat16_rn(hi_nibble(q));
        }
      }
    } else {
      for (int i = tid; i < KC * PC; i += THREADS) {
        const int kr = i / PC, c = i % PC;
        const int q = (k0 + kr < k && c0 + c < half_n)
                          ? (int)w[(size_t)(k0 + kr) * half_n + c0 + c] : 0;
        ws[kr * LDW + c] = __int2bfloat16_rn(lo_nibble(q));
        ws[kr * LDW + PC + c] = __int2bfloat16_rn(hi_nibble(q));
      }
    }
    // x: RP x KC bf16, zero past rows and past K
    if (x_vec) {
#pragma unroll
      for (int v = 0; v < X_VECS; ++v) {
        const int i = tid + v * THREADS;
        const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
        *reinterpret_cast<uint4*>(xs + r * LDX + c) = xreg[v];
      }
    } else {
      for (int i = tid; i < RP * KC; i += THREADS) {
        const int r = i / KC, c = i % KC;
        xs[r * LDX + c] = (r < rows && k0 + c < k) ? x[(size_t)r * k + k0 + c]
                                                   : __float2bfloat16(0.f);
      }
    }
    const int k_end = k0 + KC;
    const bool flush = k_end >= k || k_end % group == 0;
    const float s = (flush && my_ch >= 0) ? scale[(size_t)(k0 / group) * n + my_ch] : 0.f;
    if (k_end < k) load_chunk(k_end);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, ws + kk * 16 * LDW + warp * 16, LDW);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, xs + rt * 16 * LDX + kk * 16, LDX);
        wmma::mma_sync(acc[rt], af, bf, acc[rt]);
      }
    }

    if (flush) {
      // group end: this group's fp32 partial times its scale row into the totals
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        wmma::store_matrix_sync(os + rt * 16 * LDO + warp * 16, acc[rt], LDO,
                                wmma::mem_row_major);
        wmma::fill_fragment(acc[rt], 0.f);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        tot[j] = fmaf(os[(my_r0 + 2 * j) * LDO + my_cl], s, tot[j]);
      }
    }
    __syncthreads();  // the chunk's tiles are overwritten next
  }

  if (my_ch >= 0) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int r = my_r0 + 2 * j;
      if (r < rows) out[(size_t)r * n + my_ch] = __float2bfloat16(tot[j]);
    }
  }
}

// ----------------------------------------------------------------------------
// fp32 compute: FMA on the CUDA cores
// ----------------------------------------------------------------------------

constexpr int KC32 = 128;
constexpr int W32_VECS = KC32 * PC / 16 / THREADS;

// RPT rows per thread (rows <= 4 * RPT): thread (packed column t % 32, warp)
// owns rows warp + 4 i, both channels of its packed column
template <int RPT>
__global__ void __launch_bounds__(THREADS)
int4_matmul_fp32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ scale, float* __restrict__ out,
                        int rows, int k, int n, int tile, int group) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);         // [KC32][CH]
  float* xs = ws + KC32 * CH;                          // [4 * RPT][KC32]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int pc = tid & 31;            // this thread's packed column
  const int half_n = n / 2;
  const int c0 = blockIdx.x * PC;
  const int ch_lo = channel_of(c0, pc, half_n, tile);
  const int ch_hi = channel_of(c0, PC + pc, half_n, tile);
  const bool w_vec = (half_n % 16 == 0) && (c0 + PC <= half_n) &&
                     (reinterpret_cast<uintptr_t>(w) % 16 == 0);

  float acc_lo[RPT], acc_hi[RPT], tot_lo[RPT], tot_hi[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc_lo[i] = acc_hi[i] = tot_lo[i] = tot_hi[i] = 0.f;

  int4 wreg[W32_VECS];
  auto load_w = [&](int k0) {
    if (!w_vec) return;
#pragma unroll
    for (int v = 0; v < W32_VECS; ++v) {
      const int i = tid + v * THREADS;
      const int kr = i / (PC / 16), c = (i % (PC / 16)) * 16;
      wreg[v] = k0 + kr < k
                    ? *reinterpret_cast<const int4*>(w + (size_t)(k0 + kr) * half_n + c0 + c)
                    : make_int4(0, 0, 0, 0);
    }
  };

  load_w(0);
  for (int k0 = 0; k0 < k; k0 += KC32) {
    if (w_vec) {
#pragma unroll
      for (int v = 0; v < W32_VECS; ++v) {
        const int i = tid + v * THREADS;
        const int kr = i / (PC / 16), c = (i % (PC / 16)) * 16;
        const int8_t* b = reinterpret_cast<const int8_t*>(&wreg[v]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          ws[kr * CH + c + j] = (float)lo_nibble(b[j]);
          ws[kr * CH + PC + c + j] = (float)hi_nibble(b[j]);
        }
      }
    } else {
      for (int i = tid; i < KC32 * PC; i += THREADS) {
        const int kr = i / PC, c = i % PC;
        const int q = (k0 + kr < k && c0 + c < half_n)
                          ? (int)w[(size_t)(k0 + kr) * half_n + c0 + c] : 0;
        ws[kr * CH + c] = (float)lo_nibble(q);
        ws[kr * CH + PC + c] = (float)hi_nibble(q);
      }
    }
    for (int i = tid; i < rows * KC32; i += THREADS) {
      const int r = i / KC32, c = i % KC32;
      xs[i] = (k0 + c < k) ? x[(size_t)r * k + k0 + c] : 0.f;
    }
    const int k_end = k0 + KC32;
    const bool flush = k_end >= k || k_end % group == 0;
    const size_t g = (size_t)(k0 / group) * n;
    const float s_lo = (flush && ch_lo >= 0) ? scale[g + ch_lo] : 0.f;
    const float s_hi = (flush && ch_hi >= 0) ? scale[g + ch_hi] : 0.f;
    if (k_end < k) load_w(k_end);
    __syncthreads();

    const int kn = min(KC32, k - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float wl = ws[kk * CH + pc];
      const float wh = ws[kk * CH + PC + pc];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float xv = xs[(warp + 4 * i) * KC32 + kk];  // rows >= `rows` unused
        acc_lo[i] = fmaf(xv, wl, acc_lo[i]);
        acc_hi[i] = fmaf(xv, wh, acc_hi[i]);
      }
    }

    if (flush) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        tot_lo[i] = fmaf(acc_lo[i], s_lo, tot_lo[i]);
        tot_hi[i] = fmaf(acc_hi[i], s_hi, tot_hi[i]);
        acc_lo[i] = acc_hi[i] = 0.f;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = warp + 4 * i;
    if (r < rows) {
      if (ch_lo >= 0) out[(size_t)r * n + ch_lo] = tot_lo[i];
      if (ch_hi >= 0) out[(size_t)r * n + ch_hi] = tot_hi[i];
    }
  }
}

template <int RT>
cudaError_t launch_bf16(const void* x, const int8_t* w, const float* s, void* out, int rows,
                        int k, int n, int tile, int group, dim3 grid, cudaStream_t stream) {
  const int bytes = (int)Bf16Smem<RT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      int4_matmul_bf16_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int4_matmul_bf16_kernel<RT><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, s, static_cast<__nv_bfloat16*>(out), rows, k, n,
      tile, group);
  return cudaGetLastError();
}

template <int RPT>
cudaError_t launch_fp32(const void* x, const int8_t* w, const float* s, void* out, int rows,
                        int k, int n, int tile, int group, dim3 grid, cudaStream_t stream) {
  const int bytes = (KC32 * CH + 4 * RPT * KC32) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      int4_matmul_fp32_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int4_matmul_fp32_kernel<RPT><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(x), w, s, static_cast<float*>(out), rows, k, n, tile, group);
  return cudaGetLastError();
}

}  // namespace

// x: [rows, k] (bf16 if fp32 == 0, else fp32); w: [k, n / 2] int8 in the
// pack_int4 tile-slab order of tile_n; scale: [k / group, n] fp32 (group = k
// for per-channel scales); out: [rows, n] in x's dtype; all contiguous on the
// device. 1 <= rows <= 64; n even and a multiple of tile_n; group divides k
// and is a multiple of 128 or equal to k. Returns the launch's cudaError_t.
extern "C" int int4_matmul_fwd(const void* x, const void* w, const void* scale, void* out,
                               int rows, int k, int n, int tile_n, int group, int fp32,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return 0;
  if (rows > MAX_ROWS || k <= 0 || n % 2 || tile_n <= 0 || tile_n % 2 || n % tile_n ||
      group <= 0 || k % group || (group != k && group % KC))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n / 2 + PC - 1) / PC);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  if (fp32) {
    if (rows <= 4) return (int)launch_fp32<1>(x, wp, sp, out, rows, k, n, tile_n, group, grid, s);
    if (rows <= 8) return (int)launch_fp32<2>(x, wp, sp, out, rows, k, n, tile_n, group, grid, s);
    if (rows <= 16) return (int)launch_fp32<4>(x, wp, sp, out, rows, k, n, tile_n, group, grid, s);
    if (rows <= 32) return (int)launch_fp32<8>(x, wp, sp, out, rows, k, n, tile_n, group, grid, s);
    return (int)launch_fp32<16>(x, wp, sp, out, rows, k, n, tile_n, group, grid, s);
  }
  if (rows <= 16) return (int)launch_bf16<1>(x, wp, sp, out, rows, k, n, tile_n, group, grid, s);
  if (rows <= 32) return (int)launch_bf16<2>(x, wp, sp, out, rows, k, n, tile_n, group, grid, s);
  if (rows <= 48) return (int)launch_bf16<3>(x, wp, sp, out, rows, k, n, tile_n, group, grid, s);
  return (int)launch_bf16<4>(x, wp, sp, out, rows, k, n, tile_n, group, grid, s);
}

// ============================================================================
// Per-channel scales (the port of _kernel)
// ============================================================================

namespace channel {

using namespace hopper;

constexpr int MAX_ROWS = 64;
constexpr int PC = 64;                      // packed columns per CTA: 128 channels
constexpr int CH = 2 * PC;
constexpr int KC = 128;                     // K rows per ring stage and per slice chunk
constexpr int W_TILE = KC * PC;             // packed bytes per stage: 8 KB
constexpr int KG = 32;                      // K rows per wgmma commit group
constexpr int MAX_SPLITS = 8;
constexpr int MAX_STAGES = 8;

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

// NR: rows rounded up to 8, the wgmma n. Grid (splits, ceil(N/2 / PC)), in
// clusters of `splits` CTAs along x: CTA (rank, j) owns channel tile j of
// K-slice `rank`.
template <int NR>
__global__ void __launch_bounds__(THREADS, PER_SM)
int4_channel_bf16_kernel(const __grid_constant__ CUtensorMap w_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                         int rows, int k, int n, int tile, int stages) {
  constexpr uint32_t X_CHUNK = NR * 128;  // one 64-column chunk of x, 128-byte swizzle
  constexpr uint32_t STAGE = W_TILE + 2 * X_CHUNK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + stages * STAGE;  // full[s], then empty[s]
  const uint32_t scales = bars + 16u * stages;  // the tile's scales, local column order

  const int tid = threadIdx.x;
  const int rank = blockIdx.x, splits = gridDim.x;
  const int half_n = n / 2;
  const int c0 = blockIdx.y * PC;
  const int chunks = (k + KC - 1) / KC;
  const int first = rank * chunks / splits;
  const int count = (rank + 1) * chunks / splits - first;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8u * s, 1);
      mbar_init(bars + 8u * (stages + s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc_lo[NR / 2], acc_hi[NR / 2];
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) acc_lo[i] = acc_hi[i] = 0.f;

  if (tid >= CONSUMERS) {
    // ---------------- producer: one thread issues every copy ----------------
    // (the other lanes fetch the tile's scales for the epilogue meanwhile,
    // every load issued before the first store)
    if (tid > CONSUMERS) {
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
      for (int i = 0; i < count; ++i) {
        const int s = i % stages;
        const uint32_t full = bars + 8u * s;
        if (i >= stages) mbar_wait(bars + 8u * (stages + s), ((i / stages) - 1) & 1);
        const uint32_t st = base + s * STAGE;
        const int k0 = (first + i) * KC;
        mbar_expect_tx(full, STAGE);
        tma_load_2d(st, &w_map, full, c0, k0);
        tma_load_2d(st + W_TILE, &x_map, full, k0, 0);
        tma_load_2d(st + W_TILE + X_CHUNK, &x_map, full, k0 + 64, 0);
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
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8u * (stages + s));
    }

    // this CTA's fp32 partial [NR][PITCH] over the ring, once every consumer
    // warp is past its last read of it: local column q < 64 is the low nibble
    // of packed column c0 + q, q >= 64 the high nibble of q - 64.
    // Accumulator (M row 16 warp + g (+ 8), n col 8 j + 2 t (+ 1)): M row
    // 16 warp + g is packed column 16 warp + 2 g, + 8 is the next column.
    bar_sync(1, CONSUMERS);
    float* part = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)));
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < NR / 8; ++j) {
      float* p0 = part + (8 * j + 2 * t) * PITCH + 16 * warp + 2 * g;
      float* p1 = p0 + PITCH;
      *reinterpret_cast<float2*>(p0) = make_float2(acc_lo[4 * j], acc_lo[4 * j + 2]);
      *reinterpret_cast<float2*>(p1) = make_float2(acc_lo[4 * j + 1], acc_lo[4 * j + 3]);
      *reinterpret_cast<float2*>(p0 + PC) = make_float2(acc_hi[4 * j], acc_hi[4 * j + 2]);
      *reinterpret_cast<float2*>(p1 + PC) = make_float2(acc_hi[4 * j + 1], acc_hi[4 * j + 3]);
    }
  }
  cluster_sync();

  // each rank finishes 1/S of the tile: the S partials summed in rank order,
  // then scaled per channel and rounded once; two units of 4 columns a
  // thread at a time, every load of both issued before the sums
  constexpr int QUADS = CH / 4;
  const int units = rows * QUADS;
  const int u0 = rank * units / splits, u1 = (rank + 1) * units / splits;
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
        const uint32_t sa = scales + 4u * q0;
        uint2 packed;
        packed.x = pack_bf16(tot.x * __uint_as_float(ld_shared_b32(sa)),
                             tot.y * __uint_as_float(ld_shared_b32(sa + 4)));
        packed.y = pack_bf16(tot.z * __uint_as_float(ld_shared_b32(sa + 8)),
                             tot.w * __uint_as_float(ld_shared_b32(sa + 12)));
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

// NR: rows rounded up to 8. Grid ceil(N/2 / 128).
template <int NR>
__global__ void __launch_bounds__(F_THREADS)
int4_channel_fp32_kernel(const __grid_constant__ CUtensorMap w_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const float* __restrict__ scale, float* __restrict__ out, int rows,
                         int k, int n, int tile) {
  constexpr uint32_t STAGE = F_W_STAGE + NR * F_KC * 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 127u) & ~127u;
  const unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t bars = base + F_STAGES * STAGE;

  const int tid = threadIdx.x;
  const int half_n = n / 2;
  const int c0 = blockIdx.x * F_THREADS;
  const int chunks = (k + F_KC - 1) / F_KC;

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
  __syncthreads();

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
  }

  const int c = c0 + tid;
  if (c < half_n) {
    const int ch_lo = channel_at(c, 0, tile), ch_hi = channel_at(c, 1, tile);
    const float s_lo = __ldg(scale + ch_lo), s_hi = __ldg(scale + ch_hi);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r < rows) {
        out[(size_t)r * n + ch_lo] = lo[r] * s_lo;
        out[(size_t)r * n + ch_hi] = hi[r] * s_hi;
      }
    }
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the simple path: thread (row blockIdx.y, packed column), one fp32 FMA
// chain per output in K order
template <typename T>
__global__ void __launch_bounds__(128)
int4_channel_simple_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ scale, T* __restrict__ out, int k, int n,
                           int tile) {
  const int half_n = n / 2;
  const int c = blockIdx.x * 128 + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= half_n) return;
  float lo = 0.f, hi = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    const float xv = to_float(x[(size_t)r * k + kk]);
    const int q = w[(size_t)kk * half_n + c];
    lo = fmaf(xv, (float)(((q & 15) ^ 8) - 8), lo);
    hi = fmaf(xv, (float)(q >> 4), hi);
  }
  const int ch_lo = channel_at(c, 0, tile), ch_hi = channel_at(c, 1, tile);
  store(out + (size_t)r * n + ch_lo, lo * scale[ch_lo]);
  store(out + (size_t)r * n + ch_hi, hi * scale[ch_hi]);
}

// the kernels whose shared-memory limit this library has raised, by [bf16,
// fp32][NR / 8] (a library-local table: a static inside a template would be
// one object across every loaded copy of the library)
namespace {
bool smem_set[2][9];
}  // namespace

template <int NR>
cudaError_t launch_bf16(const void* x, const void* w, const float* s, void* out, int rows, int k,
                        int n, int tile, int splits, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap w_map, x_map;
  if (!make_map_2d(encode, &w_map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n / 2, k, PC, KC,
                   CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_2d(encode, &x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, rows, 64, NR,
                   CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  constexpr int STAGE = W_TILE + NR * 256;
  constexpr int FIT = SMEM_BUDGET / STAGE;
  constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  constexpr int SMEM = 1024 + STAGES * STAGE + 16 * STAGES + 4 * CH;
  static_assert(NR * PITCH * 4 <= STAGES * STAGE, "the partial fits in the ring");
  bool& ready = smem_set[0][NR / 8];
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(int4_channel_bf16_kernel<NR>,
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
  return cudaLaunchKernelEx(&cfg, int4_channel_bf16_kernel<NR>, w_map, x_map, s,
                            static_cast<__nv_bfloat16*>(out), rows, k, n, tile, STAGES);
}

template <int NR>
cudaError_t launch_fp32(const void* x, const void* w, const float* s, void* out, int rows, int k,
                        int n, int tile, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap w_map, x_map;
  if (!make_map_2d(encode, &w_map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n / 2, k, F_THREADS,
                   F_KC, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_2d(encode, &x_map, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, k, rows, F_KC, NR,
                   CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return cudaErrorInvalidValue;
  }
  constexpr int SMEM = 128 + F_STAGES * (F_W_STAGE + NR * F_KC * 4) + 8 * F_STAGES;
  bool& ready = smem_set[1][NR / 8];
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(int4_channel_fp32_kernel<NR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  int4_channel_fp32_kernel<NR><<<(n / 2 + F_THREADS - 1) / F_THREADS, F_THREADS, SMEM, stream>>>(
      w_map, x_map, s, static_cast<float*>(out), rows, k, n, tile);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simple(const void* x, const void* w, const float* s, void* out, int rows, int k,
                          int n, int tile, cudaStream_t stream) {
  const dim3 grid((n / 2 + 127) / 128, rows);
  int4_channel_simple_kernel<T><<<grid, 128, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), s, static_cast<T*>(out), k, n,
      tile);
  return cudaGetLastError();
}

}  // namespace channel

// Per-channel scales. x: [rows, k] (bf16 if fp32 == 0, else fp32); w: [k, n
// / 2] int8 in the pack_int4 tile-slab order of tile_n; scale: [n] fp32;
// out: [rows, n] in x's dtype; all contiguous on the device. 1 <= rows <=
// 64; n even and a multiple of tile_n. splits: the number of K-slices (a
// power of two, at most 8 and at most ceil(k / 128); 1 for fp32), chosen
// from (k, n) by the caller. simple != 0 takes the simple path; otherwise x
// and w must be 16-byte aligned, n / 2 a multiple of 16 and k of 8 (bf16) or
// 4 (fp32). Returns the launch's cudaError_t.
extern "C" int int4_matmul_channel_fwd(const void* x, const void* w, const void* scale, void* out,
                                       int rows, int k, int n, int tile_n, int splits, int fp32,
                                       int simple, void* stream) {
  namespace ch = channel;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return 0;
  const int chunks = (k + ch::KC - 1) / ch::KC;
  if (rows > ch::MAX_ROWS || k <= 0 || n % 2 || tile_n <= 0 || tile_n % 2 || n % tile_n ||
      splits < 1 || splits > ch::MAX_SPLITS || (splits & (splits - 1)) || splits > chunks ||
      (fp32 && splits != 1))
    return (int)cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale);
  if (simple) {
    return fp32 ? (int)ch::launch_simple<float>(x, w, sp, out, rows, k, n, tile_n, st)
                : (int)ch::launch_simple<__nv_bfloat16>(x, w, sp, out, rows, k, n, tile_n, st);
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0 ||
      (n / 2) % 16 != 0 || k % (fp32 ? 4 : 8) != 0)
    return (int)cudaErrorMisalignedAddress;  // TMA: 16-byte aligned bases and row strides
#define INT4_CHANNEL_CASE(R)                                                      \
  case R:                                                                         \
    return fp32 ? (int)ch::launch_fp32<R>(x, w, sp, out, rows, k, n, tile_n, st)  \
                : (int)ch::launch_bf16<R>(x, w, sp, out, rows, k, n, tile_n, splits, st);
  switch ((rows + 7) / 8 * 8) {
    INT4_CHANNEL_CASE(8)
    INT4_CHANNEL_CASE(16)
    INT4_CHANNEL_CASE(24)
    INT4_CHANNEL_CASE(32)
    INT4_CHANNEL_CASE(40)
    INT4_CHANNEL_CASE(48)
    INT4_CHANNEL_CASE(56)
    INT4_CHANNEL_CASE(64)
  }
#undef INT4_CHANNEL_CASE
  return (int)cudaErrorInvalidValue;
}
