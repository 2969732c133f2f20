// Fused RMSNorm / LayerNorm for Hopper (sm_90a): forward, residual-add
// forward, and the shared backward.
//
// Replaces (unionml_tpu/ops/fused_norm.py, each reached through
// pl.pallas_call):
//   - _fwd_kernel via _norm_fwd, rms=True, no beta   (Llama RMSNorm)
//   - _fwd_kernel via _norm_fwd, LayerNorm with beta  (ViT ln1 / ln_final)
//   - _add_fwd_kernel via _norm_add_fwd              (ViT ln2: s = x + r,
//     y = norm(s), statistics from the fp32 sum, s written in x's dtype)
//   - _bwd_kernel via _norm_bwd                       (both modes: dx, and
//     dgamma / dbeta summed over all rows)
//
// What they compute: over the last axis of x [rows, d], fp32 statistics
// (mean and variance E[(x - mu)^2] for LayerNorm; mean(x^2) for RMS, mu = 0),
// y = ((x - mu) * rstd) * g (+ b) cast to x's dtype; nothing else is written
// in the forward. The backward recomputes the statistics from x (the add
// form passes the stored, rounded s), then
//   dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat))   (LayerNorm)
//   dx = rstd * (dyg - xhat * mean(dyg * xhat))               (RMS)
// with dyg = dy * g, and the column sums of dy * xhat (dgamma) and dy
// (dbeta) over every row.
//
// Bound on the H100: memory. Every element is read once and written once
// with a handful of flops, far below the ~295 flops per byte at which the
// card's arithmetic would limit it.
//
// Forward design (norm_fwd_kernel; the RMS, LayerNorm and add forms in one
// kernel). What bounds it is keeping enough bytes in flight with little
// work between them: a row is 1.5 KB at ViT-B (768 bf16 columns) and 8 KB
// at Llama's 4096, and the reductions between a row's load and its store
// are short dependency chains. A CTA of 8 warps walks a run of rows, each
// row owned by R warps, R chosen from d alone: R = 1 up to 128 16-byte
// vectors a row (ViT-B's 96 vectors are three a lane, and every reduction
// is a warp shuffle, with no barrier), else the fewest warps (2, 4 or 8)
// that leave at most two vectors a lane (Llama's 4096 bf16 columns: 8
// warps, two vectors a lane), their sums added in warp order behind a
// named barrier of those warps (R is a power of two, so the index
// arithmetic is shifts: a division by a run-time R cost the 16-row call
// measurable time). Each warp has a two-row cp.async ring of its own in
// shared memory (x, and r in the add form): the next row's bytes are in
// flight while the current row is reduced; a lane copies and reads only
// its own vectors, so the ring needs no barrier. A lane keeps its columns
// of g and b in registers across its rows, loaded once as 16-byte words
// after the first row's copies are issued and converted only where used
// (converted at load time, they held the first row's copies back: 0.55
// us of a 16-row call). The grid follows the row count: the fewest rows a
// row group that fill the card's resident CTAs once, so a 16-row decode
// call spreads over 16 CTAs and ViT-B's 12608 rows give each warp four.
// Arithmetic, as the plain version: fp32 statistics (the mean, then the
// centred variance; RMS the mean square), each sum a tree over a lane's
// vector, then the lane's vectors in order, then the lanes (shuffle) and
// the warps in order, so a row's bits depend on d alone (not on the call's
// row count or the row's place in it); means as sum * (1 / d), as torch's
// mean; rsqrtf(var + eps); ((v - mu) * rstd) * g, then + b, each rounded
// (no FMA); one rounding to x's dtype. The add form writes s in x's dtype
// and normalizes the fp32 sum x + r, recomputed from the ring in every
// pass, never s read back rounded. A register double buffer in place of
// the ring, R = 4 at Llama's width, a three-row ring, streaming stores and
// tighter launch bounds were each no faster (PERF.md, section 6, PR 12).
//
// Backward design (norm_bwd_kernel, then norm_bwd_sum_kernel). A CTA of 8
// warps owns a fixed run of 64 rows. A row belongs to R warps (R = 1 up to
// 128 16-byte vectors a row: ViT-B's 768 bf16 columns are 96 vectors, three
// a lane; wider rows take 2, 4 or 8 warps); with R = 1 every reduction of a
// row is a warp shuffle, with no shared memory and no barrier on the row
// path (R > 1 adds a fixed-order pass over the R warps' sums behind a named
// barrier of those warps). Each warp walks its 8 (R = 1) rows in order
// through a two-row cp.async ring of its own in shared memory: the next
// row's x and dy are in flight while the current row is reduced. A lane
// copies, and later reads, only its own 16-byte vectors, so the ring needs
// no barrier either. The row is reduced from shared memory: the mean, then
// the centred variance (the reference's two passes; RMS: the mean square),
// then the sums of dyg and dyg * xhat, then dx is written; a lane sums
// each 16-byte vector as a tree, so its dependency chains stay short (on
// the H100 that and g in registers took 7% off; a three-row ring and
// 32-row CTAs were slower: PERF.md, section 6). A lane keeps its
// columns of g, and the dgamma / dbeta column partials, in registers
// across the warp's rows (it owns the same columns in every row); at the
// end the CTA's warps write
// them over the ring and one pass sums them in warp order into one fp32
// partial row per CTA. norm_bwd_sum_kernel then sums the CTAs' partial rows
// in CTA order (32 warps a column tile, each a fixed stride of rows, then
// the warps in order): no atomics, and every order is fixed by (rows, d),
// so reruns give the same bits. On the TPU one grid step covered a 256-row
// VMEM block and carried the dgamma / dbeta sums across steps; here rows
// past the end are never visited and the sums cross CTAs in the second
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);
  alignas(16) T v[N];
};

template <typename T>
__device__ __forceinline__ void store_vec(T* row, int i, const float* in) {
  Pack<T> p;
#pragma unroll
  for (int j = 0; j < Pack<T>::N; ++j) p.v[j] = from_f<T>(in[j]);
  reinterpret_cast<uint4*>(row)[i] = *reinterpret_cast<const uint4*>(p.v);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_MAX_NV = 4;       // 16-byte vectors a lane holds of a row
constexpr int BWD_MAX_R = 8;        // warps a row: at most 8 x 32 x 4 = 1024 vectors
constexpr int BWD_DEPTH = 2;        // rows in a warp's ring: one in flight while one is reduced

// Sum of (a, b) over the R warps of this thread's row group, in warp order,
// returned to every thread of the group. R = 1: a warp shuffle. R > 1: lane
// 0 of each warp writes the warp's sums to its slot of `slot` (BWD_WARPS
// float2), a named barrier of the group's warps, then every thread adds the
// R slots in order; successive reductions use other slots, so the next
// write to a slot always follows a barrier every thread of the group
// passed after reading it.
__device__ __forceinline__ float2 group_sum2(float a, float b, int r_warps, float2* slot) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (r_warps == 1) return make_float2(a, b);
  const int warp = threadIdx.x >> 5, first = warp & -r_warps;   // r_warps: a power of two
  if ((threadIdx.x & 31) == 0) slot[warp] = make_float2(a, b);
  asm volatile("bar.sync %0, %1;" ::"r"(1 + (warp >> (__ffs(r_warps) - 1))), "r"(32 * r_warps)
               : "memory");
  float2 t = make_float2(0.f, 0.f);
  for (int w = first; w < first + r_warps; ++w) {
    t.x += slot[w].x;
    t.y += slot[w].y;
  }
  return t;
}

// 16 bytes of TX from shared memory as VEC floats
template <typename TX>
__device__ __forceinline__ void lds_vec(const unsigned char* p, float* out) {
  Pack<TX> v;
  *reinterpret_cast<uint4*>(v.v) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < Pack<TX>::N; ++j) out[j] = to_f(v.v[j]);
}

// the sum of v[0 .. N), as a balanced tree (short dependency chains)
template <int N>
__device__ __forceinline__ float tree_sum(const float* v) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    return tree_sum<N / 2>(v) + tree_sum<N - N / 2>(v + N / 2);
  }
}

constexpr int FWD_THREADS = 256;
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int FWD_MAX_R = 8;        // warps a row: at most 8 x 32 x 8 = 2048 vectors
constexpr int FWD_DEPTH = 2;        // rows in a warp's ring: one in flight while one is reduced

// g (or b) for the VEC columns of one 16-byte vector of x, kept as loaded:
// VEC values of TG in 16-byte words (bf16 beside fp32 x: half a word), so
// the loads never hold the warp up; a value is converted where it is used
template <typename TG, int VEC>
struct Params {
  static constexpr int BYTES = VEC * (int)sizeof(TG);
  static constexpr int WORDS = BYTES >= 16 ? BYTES / 16 : 1;
  uint4 w[WORDS];

  __device__ __forceinline__ void load(const TG* p) {
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int k = 0; k < WORDS; ++k) w[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
    } else {
      static_assert(BYTES == 8, "bf16 g beside fp32 x");
      const uint2 h = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = make_uint4(h.x, h.y, 0u, 0u);
    }
  }

  // value j (j a compile-time constant after unrolling) in fp32, exactly
  __device__ __forceinline__ float operator[](int j) const {
    constexpr int PER_WORD = 16 / (int)sizeof(TG);
    const uint4& q = w[j / PER_WORD];
    const int i = (j % PER_WORD) * (int)sizeof(TG) / 4;
    const uint32_t c = i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
    if constexpr (sizeof(TG) == 4) {
      return __uint_as_float(c);
    } else {   // bf16: the high 16 bits of an fp32
      return __uint_as_float(j % 2 ? c & 0xffff0000u : c << 16);
    }
  }
};

// Forward over rows: y = norm(x) (r == nullptr), or s = x + r written in TX
// and y = norm(x + r) from the fp32 sum; b may be nullptr. Row group i
// (r_warps warps) of the grid's gridDim.x * (8 / r_warps) walks rows i, i +
// that count, ... in order through its warps' rings. Dynamic shared memory:
// the warps' rings [warp][slot][x, r][NV][32] x 16 bytes, then two sets of
// reduction slots (LayerNorm: one set a reduction; RMS: one a row, in
// turn, so a slot is written again only after a barrier that every reader
// of it has passed).
template <typename TX, typename TG, int NV>
__global__ void __launch_bounds__(FWD_THREADS)
norm_fwd_kernel(const TX* __restrict__ x, const TX* __restrict__ r,
                const TG* __restrict__ g, const TG* __restrict__ b,
                TX* __restrict__ s, TX* __restrict__ y, int rows, int d, float inv_d,
                float eps, int rms, int r_warps) {
  constexpr int VEC = Pack<TX>::N;
  constexpr int TENSOR = NV * 32 * 16;          // one tensor's share of a ring slot
  extern __shared__ __align__(16) unsigned char smem[];
  const bool add = r != nullptr;
  const int slot_bytes = add ? 2 * TENSOR : TENSOR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2* red = reinterpret_cast<float2*>(smem + FWD_WARPS * FWD_DEPTH * slot_bytes);
  unsigned char* ring = smem + warp * FWD_DEPTH * slot_bytes;
  const int nvec = d / VEC;
  const int shift = __ffs(r_warps) - 1;         // r_warps: 1, 2, 4 or 8
  const int groups = FWD_WARPS >> shift, group = warp >> shift;
  const int gl = ((warp & (r_warps - 1)) << 5) + lane;  // this lane's index in its row group
  const int stride = 32 * r_warps;              // a lane's vectors: gl, gl + stride, ...

  // a lane's vector u of a row at (slot, tensor, u, lane) in its warp's ring
  auto issue = [&](int row, int slot) {
    const size_t base = (size_t)row * d;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int v = gl + u * stride;
      if (v < nvec) {
        const uint32_t dst = smem_u32(ring + slot * slot_bytes + (u * 32 + lane) * 16);
        cp_async16(dst, x + base + (size_t)v * VEC);
        if (add) cp_async16(dst + TENSOR, r + base + (size_t)v * VEC);
      }
    }
  };

  const int step = gridDim.x * groups;
  const int row0 = blockIdx.x * groups + group;
#pragma unroll
  for (int i = 0; i < FWD_DEPTH - 1; ++i) {
    if (row0 + i * step < rows) issue(row0 + i * step, i);
    cp_async_commit();
  }
  // g and b load while the first rows are in flight
  Params<TG, VEC> gv[NV], bv[NV];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int v = gl + u * stride;
    if (v < nvec) {
      gv[u].load(g + v * VEC);
      if (b != nullptr) bv[u].load(b + v * VEC);
    }
  }
  int slot = 0, turn = 0;
  for (int row = row0; row < rows; row += step) {
    // the ring's free slot held the previous row, whose reads this lane has done
    const int ahead = row + (FWD_DEPTH - 1) * step;
    if (ahead < rows) issue(ahead, (slot + FWD_DEPTH - 1) % FWD_DEPTH);
    cp_async_commit();
    cp_async_wait<FWD_DEPTH - 1>();  // this lane's copies of `row` have landed
    const unsigned char* xs = ring + slot * slot_bytes + lane * 16;
    const size_t base = (size_t)row * d;

    // vector u of the row from the ring: x, or the fp32 sum x + r
    auto load = [&](int u, float* v) {
      lds_vec<TX>(xs + u * 512, v);
      if (add) {
        float rv[VEC];
        lds_vec<TX>(xs + TENSOR + u * 512, rv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = __fadd_rn(v[j], rv[j]);
      }
    };

    // the statistics: LayerNorm the mean, then the centred variance (two
    // passes over the row, as the reference); RMS the mean square. The
    // add form writes s on the first pass.
    float first = 0.f;   // LayerNorm: sum of v; RMS: sum of v^2
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int v = gl + u * stride;
      if (v < nvec) {
        float t[VEC];
        load(u, t);
        if (add) store_vec(s + base, v, t);
        if (rms) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) t[j] = __fmul_rn(t[j], t[j]);
        }
        first += tree_sum<VEC>(t);
      }
    }
    float mu = 0.f, var;
    if (rms) {
      var = __fmul_rn(group_sum2(first, 0.f, r_warps, red + turn * FWD_WARPS).x, inv_d);
      turn ^= 1;
    } else {
      mu = __fmul_rn(group_sum2(first, 0.f, r_warps, red).x, inv_d);
      float c = 0.f;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        if (gl + u * stride < nvec) {
          float t[VEC];
          load(u, t);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float e = __fsub_rn(t[j], mu);
            t[j] = __fmul_rn(e, e);
          }
          c += tree_sum<VEC>(t);
        }
      }
      var = __fmul_rn(group_sum2(c, 0.f, r_warps, red + FWD_WARPS).x, inv_d);
    }
    const float rstd = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int v = gl + u * stride;
      if (v < nvec) {
        float t[VEC];
        load(u, t);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float o = __fmul_rn(__fmul_rn(__fsub_rn(t[j], mu), rstd), gv[u][j]);
          t[j] = b != nullptr ? __fadd_rn(o, bv[u][j]) : o;
        }
        store_vec(y + base, v, t);
      }
    }
    slot = (slot + 1) % FWD_DEPTH;
  }
  cp_async_wait<0>();
}

// Backward over rows [blockIdx.x * rpb, min(rows, (blockIdx.x + 1) * rpb))
// by BWD_WARPS / r_warps row groups of r_warps warps, group i walking rows
// i * rpb / groups onwards in order: dx for each row, and this CTA's column
// sums of dy * xhat (dg_parts) and dy (db_parts, skipped when nullptr), one
// fp32 row each. Dynamic shared memory: the warps' rings [warp][slot][x,
// dy][NV][32] x 16 bytes (reused for the warps' column partials at the
// end), then the reduction slots. A lane keeps its columns of g in
// registers; each row's sums over a lane's 16-byte vector are trees.
template <typename TX, int NV, bool RMS>
__global__ void __launch_bounds__(BWD_THREADS, NV <= 3 ? 2 : 1)
norm_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ g,
                const TX* __restrict__ dy, TX* __restrict__ dx,
                float* __restrict__ dg_parts, float* __restrict__ db_parts,
                int rows, int d, float eps, int rpb, int r_warps) {
  constexpr int VEC = Pack<TX>::N;
  constexpr int TENSOR = NV * 32 * 16;          // one tensor's share of a ring slot
  constexpr int SLOT = 2 * TENSOR;               // x, then dy
  constexpr int RING = BWD_DEPTH * SLOT;         // BWD_DEPTH rows a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2* red = reinterpret_cast<float2*>(smem + BWD_WARPS * RING);   // [3][BWD_WARPS]
  unsigned char* ring = smem + warp * RING;
  const int nvec = d / VEC;
  const int groups = BWD_WARPS / r_warps, group = warp / r_warps;
  const int gl = (warp % r_warps) * 32 + lane;  // this lane's index in its row group

  float gv[NV][VEC];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int v = gl + u * 32 * r_warps;
#pragma unroll
    for (int j = 0; j < VEC; ++j) gv[u][j] = v < nvec ? __ldg(g + v * VEC + j) : 0.f;
  }

  const int per = rpb / groups;
  const int row0 = blockIdx.x * rpb + group * per;
  const int row1 = min(rows, row0 + per);

  // a lane's vectors gl + u * 32 R, u < NV, at (slot, tensor, u, lane) in its warp's ring
  auto issue = [&](int row, int slot) {
    const size_t base = (size_t)row * d;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int v = gl + u * 32 * r_warps;
      if (v < nvec) {
        const uint32_t dst = smem_u32(ring + slot * SLOT + (u * 32 + lane) * 16);
        cp_async16(dst, x + base + v * VEC);
        cp_async16(dst + TENSOR, dy + base + v * VEC);
      }
    }
  };

  float dg[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dg[u][j] = db[u][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BWD_DEPTH - 1; ++i) {
    if (row0 + i < row1) issue(row0 + i, i);
    cp_async_commit();
  }
  for (int row = row0; row < row1; ++row) {
    const int slot = (row - row0) % BWD_DEPTH;
    // the ring's free slot held row - 1, whose reads this lane has done
    const int ahead = row + BWD_DEPTH - 1;
    if (ahead < row1) issue(ahead, (slot + BWD_DEPTH - 1) % BWD_DEPTH);
    cp_async_commit();
    cp_async_wait<BWD_DEPTH - 1>();  // this lane's copies of `row` have landed
    const unsigned char* xs = ring + slot * SLOT + lane * 16;
    const unsigned char* ys = xs + TENSOR;

    // the statistics: LayerNorm the mean, then the centred variance (two
    // passes over the row, as the reference); RMS the mean square
    float first = 0.f;   // LayerNorm: sum of x; RMS: sum of x^2
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      if (gl + u * 32 * r_warps < nvec) {
        float xv[VEC];
        lds_vec<TX>(xs + u * 512, xv);
        if (RMS) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) xv[j] *= xv[j];
        }
        first += tree_sum<VEC>(xv);
      }
    }
    float mu = 0.f, var;
    if (RMS) {
      var = group_sum2(first, 0.f, r_warps, red).x / (float)d;
    } else {
      mu = group_sum2(first, 0.f, r_warps, red).x / (float)d;
      float c = 0.f;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        if (gl + u * 32 * r_warps < nvec) {
          float xv[VEC];
          lds_vec<TX>(xs + u * 512, xv);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float t = xv[j] - mu;
            xv[j] = t * t;
          }
          c += tree_sum<VEC>(xv);
        }
      }
      var = group_sum2(c, 0.f, r_warps, red + BWD_WARPS).x / (float)d;
    }
    const float rstd = rsqrtf(var + eps);

    // the row's sums of dyg and dyg * xhat; the column sums take their share
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int v = gl + u * 32 * r_warps;
      if (v < nvec) {
        float xv[VEC], yv[VEC], t1[VEC], t2[VEC];
        lds_vec<TX>(xs + u * 512, xv);
        lds_vec<TX>(ys + u * 512, yv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (xv[j] - mu) * rstd;
          const float dyg = yv[j] * gv[u][j];
          dg[u][j] += yv[j] * xh;
          db[u][j] += yv[j];
          t1[j] = dyg;
          t2[j] = dyg * xh;
        }
        s1 += tree_sum<VEC>(t1);
        s2 += tree_sum<VEC>(t2);
      }
    }
    const float2 c12 = group_sum2(s1, s2, r_warps, red + 2 * BWD_WARPS);
    const float c1 = RMS ? 0.f : c12.x / (float)d;
    const float c2 = c12.y / (float)d;
    const size_t base = (size_t)row * d;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int v = gl + u * 32 * r_warps;
      if (v < nvec) {
        float xv[VEC], yv[VEC], out[VEC];
        lds_vec<TX>(xs + u * 512, xv);
        lds_vec<TX>(ys + u * 512, yv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (xv[j] - mu) * rstd;
          const float dyg = yv[j] * gv[u][j];
          out[j] = RMS ? rstd * (dyg - xh * c2) : rstd * (dyg - c1 - xh * c2);
        }
        store_vec(dx + base, v, out);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past its ring: it holds the column partials now

  // group i's partials at rows i (dgamma) and groups + i (dbeta) of [2
  // groups][d] fp32, then one pass adds the groups in order
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int v = gl + u * 32 * r_warps;
    if (v < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        part[group * d + v * VEC + j] = dg[u][j];
        part[(groups + group) * d + v * VEC + j] = db[u][j];
      }
    }
  }
  __syncthreads();
  const size_t pbase = (size_t)blockIdx.x * d;
  for (int col = threadIdx.x; col < d; col += BWD_THREADS) {
    float a = part[col], b = part[groups * d + col];
    for (int i = 1; i < groups; ++i) {
      a += part[i * d + col];
      b += part[(groups + i) * d + col];
    }
    dg_parts[pbase + col] = a;
    if (db_parts != nullptr) db_parts[pbase + col] = b;
  }
}

constexpr int SUM_THREADS = 1024;
constexpr int SUM_COLS = 32;

// out[col] = sum over p of parts[p][col], p in a fixed order: warp w adds
// rows w, w + 32, ... in order, then the 32 warps' sums are added in warp
// order. Grid (ceil(d / 32), 1 or 2): y = 0 sums dg_parts into dg, y = 1
// db_parts into db.
__global__ void __launch_bounds__(SUM_THREADS)
norm_bwd_sum_kernel(const float* __restrict__ dg_parts, const float* __restrict__ db_parts,
                    float* __restrict__ dg, float* __restrict__ db, int parts, int d) {
  __shared__ float warp_sums[SUM_THREADS / 32][SUM_COLS];
  const float* src = blockIdx.y ? db_parts : dg_parts;
  float* dst = blockIdx.y ? db : dg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * SUM_COLS + lane;
  float a = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int p = warp; p < parts; p += SUM_THREADS / 32) a += src[(size_t)p * d + col];
  }
  warp_sums[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = warp_sums[0][lane];
    for (int w = 1; w < SUM_THREADS / 32; ++w) t += warp_sums[w][lane];
    dst[col] = t;
  }
}

// which of the forward's kernels have had their shared-memory limit raised,
// and how many CTAs of each (plain, add form) an SM holds (0: not asked
// yet), by [bf16 x][bf16 g][NV index] (library-local tables: a static
// inside a template would be one object across every loaded copy of the
// library)
bool fwd_smem_set[2][2][5];
int fwd_resident[2][2][5][2];

template <typename TX, typename TG, int NV, int NVI>
cudaError_t fwd_rows_launch(const void* x, const void* r, const void* g, const void* b, void* s,
                            void* y, int rows, int d, float eps, int rms, int r_warps,
                            cudaStream_t stream) {
  constexpr int RING = FWD_WARPS * FWD_DEPTH * NV * 32 * 16;   // one tensor's rings
  constexpr int RED = 2 * FWD_WARPS * 8;
  const bool add = r != nullptr;
  const int smem = (add ? 2 : 1) * RING + RED;
  const int bx = sizeof(TX) == 2, bg = sizeof(TG) == 2;
  auto kernel = norm_fwd_kernel<TX, TG, NV>;
  if (!fwd_smem_set[bx][bg][NVI]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           2 * RING + RED);
    if (err != cudaSuccess) return err;
    fwd_smem_set[bx][bg][NVI] = true;
  }
  int& resident = fwd_resident[bx][bg][NVI][add];
  if (resident == 0) {
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, FWD_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the fewest rows a row group that fill the resident CTAs once
  const int groups = FWD_WARPS / r_warps;
  const long long slots = (long long)sms * resident * groups;
  const long long per = (rows + slots - 1) / slots;
  const int blocks = (int)((rows + groups * per - 1) / (groups * per));
  kernel<<<blocks, FWD_THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(r), static_cast<const TG*>(g),
      static_cast<const TG*>(b), static_cast<TX*>(s), static_cast<TX*>(y), rows, d,
      1.f / (float)d, eps, rms, r_warps);
  return cudaGetLastError();
}

// R warps a row (1 up to 128 vectors; else the fewest of 2, 4, 8 leaving at
// most two vectors a lane), then NV = a lane's vectors, rounded up to 1, 2,
// 3, 4 or 8
template <typename TX, typename TG>
cudaError_t fwd_dispatch(const void* x, const void* r, const void* g, const void* b, void* s,
                         void* y, int rows, int d, float eps, int rms, cudaStream_t stream) {
  const int nvec = d / Pack<TX>::N;
  int r_warps = 1;
  if (nvec > 128) {
    r_warps = 2;
    while (r_warps < FWD_MAX_R && 64 * r_warps < nvec) r_warps *= 2;
  }
  const int nv = (nvec + 32 * r_warps - 1) / (32 * r_warps);
  switch (nv) {
#define NORM_FWD_CASE(NV, NVI)                                                                \
  return fwd_rows_launch<TX, TG, NV, NVI>(x, r, g, b, s, y, rows, d, eps, rms, r_warps, stream);
    case 1: NORM_FWD_CASE(1, 0)
    case 2: NORM_FWD_CASE(2, 1)
    case 3: NORM_FWD_CASE(3, 2)
    case 4: NORM_FWD_CASE(4, 3)
    case 5: case 6: case 7: case 8: NORM_FWD_CASE(8, 4)
#undef NORM_FWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

// which of the backward's kernels have had their shared-memory limit raised,
// by [bf16][rms][NV - 1] (a library-local table: a static inside a template
// would be one object across every loaded copy of the library)
bool bwd_smem_set[2][2][BWD_MAX_NV];

template <typename TX, int NV, bool RMS>
cudaError_t bwd_launch(const void* x, const float* g, const void* dy, void* dx,
                       float* dg_parts, float* db_parts, float* dg, float* db, int rows, int d,
                       float eps, int rpb, int r_warps, cudaStream_t stream) {
  constexpr int SMEM = BWD_WARPS * 2 * BWD_DEPTH * NV * 32 * 16 + 3 * BWD_WARPS * 8;
  bool& ready = bwd_smem_set[sizeof(TX) == 2][RMS][NV - 1];
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(norm_bwd_kernel<TX, NV, RMS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int blocks = (rows + rpb - 1) / rpb;
  norm_bwd_kernel<TX, NV, RMS><<<blocks, BWD_THREADS, SMEM, stream>>>(
      static_cast<const TX*>(x), g, static_cast<const TX*>(dy), static_cast<TX*>(dx), dg_parts,
      db_parts, rows, d, eps, rpb, r_warps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  norm_bwd_sum_kernel<<<dim3((d + SUM_COLS - 1) / SUM_COLS, db != nullptr ? 2 : 1), SUM_THREADS,
                        0, stream>>>(dg_parts, db_parts, dg, db, blocks, d);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t bwd_dispatch(const void* x, const float* g, const void* dy, void* dx,
                         float* dg_parts, float* db_parts, float* dg, float* db, int rows, int d,
                         float eps, int rms, int rpb, cudaStream_t stream) {
  const int nvec = d / Pack<TX>::N;
  int r_warps = 1;
  while (r_warps < BWD_MAX_R && 32 * r_warps * BWD_MAX_NV < nvec) r_warps *= 2;
  const int nv = (nvec + 32 * r_warps - 1) / (32 * r_warps);
  switch (nv) {
#define NORM_BWD_CASE(NV)                                                                     \
  case NV:                                                                                    \
    return rms ? bwd_launch<TX, NV, true>(x, g, dy, dx, dg_parts, db_parts, dg, db, rows, d,  \
                                          eps, rpb, r_warps, stream)                          \
               : bwd_launch<TX, NV, false>(x, g, dy, dx, dg_parts, db_parts, dg, db, rows, d, \
                                           eps, rpb, r_warps, stream);
    NORM_BWD_CASE(1)
    NORM_BWD_CASE(2)
    NORM_BWD_CASE(3)
    NORM_BWD_CASE(4)
#undef NORM_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Forward. x, y (and r, s for the add form; else both nullptr): [rows, d]
// contiguous, 16-byte aligned, bf16 (x_bf16 = 1) or fp32; g, b: [d] bf16
// (g_bf16 = 1) or fp32, 16-byte aligned, b may be nullptr. rms = 1 drops the
// mean. d must be a multiple of 16 / sizeof(x element) and at most 2048
// such vectors. Returns the launch's cudaError_t.
extern "C" int norm_fwd(const void* x, const void* r, const void* g, const void* b,
                        void* s, void* y, int rows, int d, float eps, int rms,
                        int x_bf16, int g_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  const int vec = x_bf16 ? 8 : 4;
  if (d <= 0 || d % vec || d / vec > 32 * FWD_MAX_R * 8 || (r == nullptr) != (s == nullptr))
    return (int)cudaErrorInvalidValue;
  if (x_bf16 && g_bf16)
    return fwd_dispatch<__nv_bfloat16, __nv_bfloat16>(x, r, g, b, s, y, rows, d, eps, rms, st);
  if (x_bf16) return fwd_dispatch<__nv_bfloat16, float>(x, r, g, b, s, y, rows, d, eps, rms, st);
  if (g_bf16) return fwd_dispatch<float, __nv_bfloat16>(x, r, g, b, s, y, rows, d, eps, rms, st);
  return fwd_dispatch<float, float>(x, r, g, b, s, y, rows, d, eps, rms, st);
}

// Backward. x, dy, dx: [rows, d] contiguous in one dtype (bf16 when x_bf16),
// 16-byte aligned; g: [d] fp32; dg_parts (and db_parts unless nullptr):
// [ceil(rows / rpb), d] fp32 scratch, one partial row per CTA of rpb rows
// (a multiple of 8); dg (and db, nullptr exactly when db_parts is): [d] fp32,
// the column sums over all rows. d a multiple of 16 / sizeof(x element), at
// most 1024 such vectors. Launches the row kernel, then the sum kernel.
extern "C" int norm_bwd(const void* x, const void* g, const void* dy, void* dx,
                        void* dg_parts, void* db_parts, void* dg, void* db, int rows, int d,
                        float eps, int rms, int x_bf16, int rpb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  const int vec = x_bf16 ? 8 : 4;
  if (rpb <= 0 || rpb % BWD_WARPS || d <= 0 || d % vec ||
      d / vec > 32 * BWD_MAX_R * BWD_MAX_NV || (db_parts == nullptr) != (db == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* gf = static_cast<const float*>(g);
  float* dgp = static_cast<float*>(dg_parts);
  float* dbp = static_cast<float*>(db_parts);
  float* dgo = static_cast<float*>(dg);
  float* dbo = static_cast<float*>(db);
  if (x_bf16) {
    return bwd_dispatch<__nv_bfloat16>(x, gf, dy, dx, dgp, dbp, dgo, dbo, rows, d, eps, rms,
                                       rpb, st);
  }
  return bwd_dispatch<float>(x, gf, dy, dx, dgp, dbp, dgo, dbo, rows, d, eps, rms, rpb, st);
}
