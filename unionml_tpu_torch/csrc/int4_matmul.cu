// Packed-int4 weight-only matmul for Hopper (sm_90a): y[rows, N] = x[rows, K]
// @ W4 for decode-sized row counts (rows <= 64), per-channel or group-wise
// scales.
//
// Replaces: unionml_tpu/ops/int4_matmul.py::_kernel (per-channel, reached
// through _pallas_int4 -> pl.pallas_call) and ::_kernel_grouped (group-wise,
// through _pallas_int4_grouped -> pl.pallas_call), the projections of a
// weight_bits=4 Llama at decode and verify row counts.
//
// What it computes. W4 is the pack_int4 layout: [K, N/2] int8, output
// channels tiled by tile_n; within tile j the low nibbles of packed column
// j*T/2 + o hold channel j*T + o and the high nibbles channel j*T + T/2 + o.
// A nibble is sign-extended as ((q & 15) ^ 8) - 8 (low) and q >> 4 (high, the
// arithmetic shift of the int8 byte). scale is fp32 [K / group, N]: each
// K-group's fp32 partial product x[:, g] @ W4[g, :] is multiplied by its scale
// row before it is added to the output; the per-channel form is one group of
// all of K, so the product is accumulated in fp32 over K and then scaled, as
// the TPU kernel's (y * scale).astype(dtype). The output is rounded once to
// the compute dtype. Compute dtype bf16: x and the nibbles (exact in bf16)
// meet in a bf16 tensor-core product with fp32 accumulation (WMMA). Compute
// dtype fp32 (the LM head's logits contract): fp32 FMA on the CUDA cores, never
// TF32.
//
// Bound on the H100: bytes. Each weight is read once at 4 bits; at 16 rows a
// byte of weights feeds 64 operations, far below the bf16 tensor-core balance
// (about 295 operations per byte). The fp32 form at 16 rows is bound by the
// CUDA cores' 67 TFLOP/s instead.
//
// Design (a first, simple version): each block owns 32 packed columns, i.e.
// 64 output channels (32 low, 32 high, each run contiguous in the output),
// and walks all of K in 128-row chunks, so every output element is reduced
// in the same order whatever the row count: a row's result does not depend
// on how many rows share the launch (the speculative verify's 40 rows give
// the same logits per row as an 8-row decode). A chunk's packed bytes are
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
// inside the block takes its place. wgmma, TMA, split-K and more blocks for
// narrow N are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
