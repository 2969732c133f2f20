// Paged decode attention for Hopper (sm_90a): one query per batch row over a
// block-paged KV pool, addressed through a block table.
//
// Replaces: unionml_tpu/ops/paged_attention.py::_paged_kernel (reached
// through _paged_pallas -> pl.pallas_call), the decode-step attention of the
// engine's paged mode, in its bf16-pool and int8-pool forms.
//
// What it computes, for batch row b and q head hq (kv head h = hq / G, G =
// Hq / Hk): out[b, hq] = sum_j p_j v_j / sum_j p'_j over the visible pool rows
// j < lengths[b], where row j lives in pool block table[b, j / block] at
// offset j % block, s_j = (q . k_j) * scale (times k_scale[j, h] for int8
// pools), p'_j = exp(s_j - max s), and p_j = p'_j * v_scale[j, h] (int8) or
// p'_j (bf16), rounded to q's dtype before the product with v, as the TPU
// kernel casts p to q.dtype. The normaliser sums the unscaled p'. Statistics
// (running max, normaliser, accumulator) stay in fp32 with the TPU kernel's
// NEG_INF guards; a row with nothing visible returns acc / max(l, 1e-30) = 0.
// Output is in q's dtype.
//
// Bound on the H100: bytes. Each visible K/V row is read once (Hk * D * 2
// bytes per row and per tensor for bf16, 1 byte plus a 4-byte scale per head
// for int8) and every row is used by only G queries, so the work is far
// below the card's operations-per-byte balance: the design's aim is many
// bytes in flight on every SM.
//
// Design (flash-decoding). Each row's visible rows are cut into splits of
// `split_blocks` whole pool blocks (the wrapper fixes it from the block size
// alone, about 128 rows), and the grid is one CTA per (batch row, kv head,
// split) of the table's width: the split count never depends on `lengths`,
// so the host never waits for the card, and a CTA whose split starts at or
// past its row's length exits at once.
// - Feed: the CTA's four warps take the split's 16-row tiles in turn, each
//   warp with its own ring of two tiles filled by 16-byte cp.async straight
//   from the pool through the table (no gathered copy; entries clamped to
//   the pool; rows past the length zero-filled and never weighted). At the
//   smoke's split of 128 rows every load of a CTA is issued before its
//   first score: up to 64 KB in flight per CTA, three CTAs an SM. No block
//   barrier until the end.
// - Scores (bf16 q): tensor cores, mma.sync m16n8k16 with fp32 sums: S^T =
//   K Q^T with the tile's 16 rows as M and the G <= 8 query rows as n = 8
//   (zeros past G), K by ldmatrix from rows padded to a conflict-free
//   stride, Q's fragments held in registers. int8 pools are converted to
//   bf16 exactly on the way into the fragments; k_scale folds into s. fp32
//   q keeps the products in fp32 on the CUDA cores (D / 8 lanes per row's
//   dot product and a shuffle reduction).
// - Softmax, per tile: four lanes per query row do the TPU kernel's online
//   update (max, NEG_INF guards, corr, the normaliser over the unscaled p),
//   then p times v_scale (int8), rounded to q's dtype.
// - P.V (bf16 q): O^T += V^T P^T, D as M (V read transposed by ldmatrix),
//   the tile's rows as K, P's rounded weights as the n = 8 side; fp32 q:
//   each lane owns D / 32 output columns of every query row.
// - Combine: the four warps' (m, l, acc) merge in shared memory, and the CTA
//   writes its split's fp32 (m, l, acc[G, D]) to a scratch the wrapper
//   allocates; a second kernel, one CTA per (batch row, q head), merges the
//   used splits in split order (M = max m, l and acc rescaled by exp(m - M))
//   and writes acc / max(l, 1e-30) in q's dtype. No atomics: two runs give
//   the same bits. Tiles past a row's first split round p against their
//   split's running maximum rather than the row's: within one rounding of
//   each p, as before.
// Registers (ptxas -v), split kernel: bf16 q 96 (bf16 pool) and 95 (int8)
// at head_dim 128, 62 and 56 at 64; fp32 q 168 and 161 at 128, 153 and
// 151 at 64; the combine kernel 31; no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TR = 16;       // pool rows a warp takes at a time (one tile)
constexpr int STAGES = 2;    // tiles in flight per warp
constexpr int MAXG = 8;      // q heads per kv head held in registers
constexpr float NEG_INF = -1e30f;

template <int D, typename TKV>
struct Layout {
  static constexpr int RB = D * (int)sizeof(TKV);    // one pool row of one kv head
  static constexpr int RS = RB + 16;                 // its stride in a tile: ldmatrix
                                                     // reads 8 rows conflict-free
  static constexpr int CPR = RB / 16;                // 16-byte copies per row
  static constexpr int LPR = D / 8;                  // fp32 q: lanes per row's dot
  static constexpr int RPP = 32 / LPR;               // fp32 q: rows per score pass
  static constexpr int CPL = D / 32;                 // fp32 q: output columns per lane
  static constexpr int MT = D / 16;                  // bf16 q: 16-wide steps of D
  // a tile: K rows, V rows, k_scale, v_scale
  static constexpr int TILE_BYTES = 2 * TR * RS + 2 * TR * 4;
  // a warp: its ring, then its weights [TR][MAXG]
  static constexpr int WARP_BYTES = STAGES * TILE_BYTES + TR * MAXG * 4;
  // the warps' (m, l, acc) for the merge, over the rings
  static constexpr int MERGE_BYTES = WARPS * MAXG * (D + 2) * 4;
  static constexpr int SMEM = WARPS * WARP_BYTES > MERGE_BYTES ? WARPS * WARP_BYTES : MERGE_BYTES;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or, zero-filled, 0) bytes global -> shared, asynchronous
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

// N consecutive values (N * sizeof(T) bytes, aligned to that) as fp32
template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[N]) {
  struct alignas(N * sizeof(T)) Vec {
    T v[N];
  };
  const Vec u = *reinterpret_cast<const Vec*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = to_float(u.v[i]);
}

// 8 fp32 values: two 16-byte loads
__device__ __forceinline__ void load_vec(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// p cast to q's dtype before the product with v (fp32 q: unchanged)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// int8 pool values converted exactly to a bf16 pair (the low half first):
// two consecutive ones, or one from each of two rows
__device__ __forceinline__ uint32_t pair_bf16(const int8_t* p) {
  const uint16_t u = *reinterpret_cast<const uint16_t*>(p);
  return pack_bf16((float)(int8_t)(u & 0xff), (float)(int8_t)(u >> 8));
}
__device__ __forceinline__ uint32_t pair_bf16(const int8_t* p0, const int8_t* p1) {
  return pack_bf16((float)*p0, (float)*p1);
}

// four 8 x 8 b16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8), plain or transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// One split of one (batch row, kv head): its (m, l, acc) for each of the G
// query rows into the scratch `part` ([3 planes: m, l, acc]). bf16 q runs
// both products on the tensor cores (mma.sync m16n8k16, fp32 sums; the G <=
// 8 query rows are the n = 8 side, padded with zeros): S^T = K Q^T with the
// tile's 16 rows as M, and O^T += V^T P^T with D as M, V read transposed by
// ldmatrix. int8 pools are converted to bf16 exactly on the way into the
// fragments. fp32 q keeps every product in fp32 on the CUDA cores.
template <int D, typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const int* __restrict__ table,
                   const int* __restrict__ lengths, float* __restrict__ part, int hq, int hk,
                   int num_blocks, int block, int width, int split_blocks, int n_splits,
                   float scale) {
  using L = Layout<D, TKV>;
  constexpr bool MMA = sizeof(TQ) == 2;  // bf16 q
  constexpr bool KV16 = sizeof(TKV) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x % n_splits;
  const int h = (blockIdx.x / n_splits) % hk;
  const int b = blockIdx.x / (n_splits * hk);
  // rows past the table's reach do not exist (the gather view is W*block)
  const int length = max(0, min(lengths[b], width * block));
  const int r_begin = split * split_blocks * block;
  if (r_begin >= length) return;  // the whole CTA: nothing of this row here
  const int r_end = min(length, r_begin + split_blocks * block);
  const int n_tiles = (r_end - r_begin + TR - 1) / TR;
  const int g_n = hq / hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = smem + warp * L::WARP_BYTES;
  float* w_s = reinterpret_cast<float*>(ring + STAGES * L::TILE_BYTES);  // [TR][MAXG]

  // q, out: [B, Hq, D]; the G rows of kv head h are contiguous. bf16: this
  // lane's B fragments of Q^T (query lane / 4, zero past G); fp32: this
  // lane's 8 values of each query row
  const size_t q_base = ((size_t)b * hq + (size_t)h * g_n) * D;
  const int fg = lane >> 2, fk = 2 * (lane & 3);  // fragment row / column of this lane
  const int cg = lane % L::LPR, rsub = lane / L::LPR;
  uint32_t qb[MMA ? L::MT : 1][2];
  float qr[MMA ? 1 : MAXG][8];
  if constexpr (MMA) {
#pragma unroll
    for (int kk = 0; kk < L::MT; ++kk) {
      const TQ* qp = q + q_base + (size_t)fg * D + kk * 16 + fk;
      qb[kk][0] = fg < g_n ? *reinterpret_cast<const uint32_t*>(qp) : 0u;
      qb[kk][1] = fg < g_n ? *reinterpret_cast<const uint32_t*>(qp + 8) : 0u;
    }
  } else {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < g_n) {
        load_vec(q + q_base + (size_t)g * D + cg * 8, qr[g]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
      }
    }
  }

  // tile t of this split (rows r_begin + 16 t ..) into ring slot st
  auto issue = [&](int t, int st) {
    unsigned char* kb = ring + st * L::TILE_BYTES;
    unsigned char* vb = kb + TR * L::RS;
    float* ksb = reinterpret_cast<float*>(vb + TR * L::RS);
    const int row0 = r_begin + t * TR;
    // lanes 0-15: the (pool row, kv head) index of the tile's row `lane`
    long long prow = -1;
    if (lane < TR && row0 + lane < r_end) {
      const int j = row0 + lane;
      const int pid = min(max(table[(size_t)b * width + j / block], 0), num_blocks - 1);
      prow = ((long long)pid * block + j % block) * hk + h;
    }
#pragma unroll
    for (int i = lane; i < 2 * TR * L::CPR; i += 32) {
      const int tensor = i / (TR * L::CPR), r = (i / L::CPR) % TR, c = i % L::CPR;
      const long long pr = __shfl_sync(0xffffffffu, prow, r);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(tensor ? v : k);
      unsigned char* dst = (tensor ? vb : kb) + r * L::RS + c * 16;
      cp_async16(dst, src + (pr < 0 ? 0 : pr * L::RB + c * 16), pr >= 0);
    }
    if (QUANT) {
      const long long pr = __shfl_sync(0xffffffffu, prow, lane % TR);
      const float* src = lane < TR ? k_scale : v_scale;
      cp_async4(ksb + lane, src + (pr < 0 ? 0 : pr), pr >= 0);
    }
  };

  float m_run = NEG_INF, l_run = 0.f;  // of query row lane / 4 (lanes 4g .. 4g + 3)
  // bf16: O^T fragments (columns d = 16 mt + lane / 4 (+ 8), queries fk,
  // fk + 1); fp32: this lane's CPL columns of every query row
  float acc_t[MMA ? L::MT : 1][4];
  float acc[MMA ? 1 : MAXG][L::CPL];
#pragma unroll
  for (int i = 0; i < (MMA ? L::MT : 1); ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_t[i][c] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < (MMA ? 1 : MAXG); ++g) {
#pragma unroll
    for (int c = 0; c < L::CPL; ++c) acc[g][c] = 0.f;
  }

  const int n_mine = warp < n_tiles ? (n_tiles - 1 - warp) / WARPS + 1 : 0;
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i < n_mine) issue(warp + i * WARPS, i);
    cp_async_commit();  // one group per slot, empty or not
  }
  for (int i = 0; i < n_mine; ++i) {
    const int st = i % STAGES;
    const int row0 = r_begin + (warp + i * WARPS) * TR;
    const int nrows = min(TR, r_end - row0);
    const unsigned char* kb = ring + st * L::TILE_BYTES;
    const unsigned char* vb = kb + TR * L::RS;
    const float* ksb = reinterpret_cast<const float*>(vb + TR * L::RS);
    cp_async_wait<STAGES - 1>();  // this lane's copies of tile i
    __syncwarp();                 // and every lane's

    // scores s = q . k * scale (* k_scale), -inf-guarded rows past the
    // length, into w_s[row][g]
    if constexpr (MMA) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f};  // rows fg, fg + 8; queries fk, fk + 1
#pragma unroll
      for (int kk = 0; kk < L::MT; ++kk) {
        uint32_t a[4];
        if constexpr (KV16) {
          // matrices: rows 0-7 / 8-15 x columns 0-7 / 8-15 of this step
          const int r = (lane & 7) + 8 * ((lane >> 3) & 1), c = kk * 16 + 8 * (lane >> 4);
          ldsm_x4(a, kb + r * L::RS + c * 2);
        } else {
          const TKV* k0 = reinterpret_cast<const TKV*>(kb + fg * L::RS) + kk * 16 + fk;
          const TKV* k8 = reinterpret_cast<const TKV*>(kb + (fg + 8) * L::RS) + kk * 16 + fk;
          a[0] = pair_bf16(k0), a[1] = pair_bf16(k8), a[2] = pair_bf16(k0 + 8),
          a[3] = pair_bf16(k8 + 8);
        }
        mma_bf16(sc, a, qb[kk][0], qb[kk][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = fg + 8 * (e >> 1), g = fk + (e & 1);
        const float ks = QUANT ? ksb[r] : 1.f;
        if (g < g_n) w_s[r * MAXG + g] = r < nrows ? sc[e] * scale * ks : NEG_INF;
      }
    } else {
      // D / 8 lanes per pool row, RPP rows a pass
#pragma unroll
      for (int pass = 0; pass < TR / L::RPP; ++pass) {
        const int r = pass * L::RPP + rsub;
        float kv[8];
        load_vec(reinterpret_cast<const TKV*>(kb + r * L::RS) + cg * 8, kv);
        float dot[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          dot[g] = 0.f;
          if (g < g_n) {
#pragma unroll
            for (int e = 0; e < 8; ++e) dot[g] = fmaf(qr[g][e], kv[e], dot[g]);
#pragma unroll
            for (int off = L::LPR / 2; off > 0; off >>= 1) {
              dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
            }
          }
        }
        if (cg == 0) {
          const float ks = QUANT ? ksb[r] : 1.f;
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < g_n) w_s[r * MAXG + g] = r < nrows ? dot[g] * scale * ks : NEG_INF;
          }
        }
      }
    }
    __syncwarp();

    // online softmax, the TPU kernel's update: lanes 4g .. 4g + 3 take
    // query row g, four pool rows each
    const int r4 = (lane & 3) * 4;
    float s[4], mx = NEG_INF;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = fg < g_n ? w_s[(r4 + e) * MAXG + fg] : NEG_INF;
      mx = fmaxf(mx, s[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float m_safe = m_new == NEG_INF ? 0.f : m_new;
    const float corr = m_run == NEG_INF ? 0.f : expf(m_run - m_safe);
    float p[4], sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = r4 + e < nrows ? expf(s[e] - m_safe) : 0.f;
      sum += p[e];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * corr + sum;
    m_run = m_new;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // the normaliser summed the unscaled p; v_scale rides the product
      const float pe = QUANT ? p[e] * ksb[TR + r4 + e] : p[e];
      w_s[(r4 + e) * MAXG + fg] = fg < g_n ? round_to(pe, TQ()) : 0.f;
    }
    __syncwarp();

    // acc = acc * corr + p . v
    if constexpr (MMA) {
      const float c0 = __shfl_sync(0xffffffffu, corr, 4 * fk);
      const float c1 = __shfl_sync(0xffffffffu, corr, 4 * fk + 4);
      // B = P^T: rows fk, fk + 1 (and + 8) of query lane / 4, exact in bf16
      const uint32_t b0 = pack_bf16(w_s[fk * MAXG + fg], w_s[(fk + 1) * MAXG + fg]);
      const uint32_t b1 = pack_bf16(w_s[(fk + 8) * MAXG + fg], w_s[(fk + 9) * MAXG + fg]);
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt) {
        acc_t[mt][0] *= c0, acc_t[mt][1] *= c1, acc_t[mt][2] *= c0, acc_t[mt][3] *= c1;
        uint32_t a[4];
        if constexpr (KV16) {
          // A = V^T: matrices rows 0-7 / 8-15 of V x columns 0-7 / 8-15
          const int r = (lane & 7) + 8 * (lane >> 4), c = mt * 16 + 8 * ((lane >> 3) & 1);
          ldsm_x4_t(a, vb + r * L::RS + c * 2);
        } else {
          const TKV* v0 = reinterpret_cast<const TKV*>(vb) + mt * 16 + fg;
          auto at = [&](int row) { return reinterpret_cast<const TKV*>(
                                       reinterpret_cast<const unsigned char*>(v0) + row * L::RS); };
          a[0] = pair_bf16(at(fk), at(fk + 1));
          a[1] = pair_bf16(at(fk) + 8, at(fk + 1) + 8);
          a[2] = pair_bf16(at(fk + 8), at(fk + 9));
          a[3] = pair_bf16(at(fk + 8) + 8, at(fk + 9) + 8);
        }
        mma_bf16(acc_t[mt], a, b0, b1);
      }
    } else {
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg) {
        const float cg_corr = __shfl_sync(0xffffffffu, corr, gg * 4);
        if (gg < g_n) {
#pragma unroll
          for (int c = 0; c < L::CPL; ++c) acc[gg][c] *= cg_corr;
        }
      }
      for (int r = 0; r < nrows; ++r) {
        float vv[L::CPL];
        load_vec(reinterpret_cast<const TKV*>(vb + r * L::RS) + lane * L::CPL, vv);
        const float4* wr = reinterpret_cast<const float4*>(w_s + r * MAXG);
        const float4 w0 = wr[0], w1 = wr[1];
        const float wg[MAXG] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int gg = 0; gg < MAXG; ++gg) {
          if (gg < g_n) {
#pragma unroll
            for (int c = 0; c < L::CPL; ++c) acc[gg][c] = fmaf(wg[gg], vv[c], acc[gg][c]);
          }
        }
      }
    }
    __syncwarp();  // the slot is read: refill it
    if (i + STAGES < n_mine) issue(warp + (i + STAGES) * WARPS, st);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // merge the four warps: (m, l) of query row g from lane 4g, acc from all
  __syncthreads();  // every ring is read
  float* m_s = reinterpret_cast<float*>(smem);   // [WARPS][MAXG]
  float* l_s = m_s + WARPS * MAXG;               // [WARPS][MAXG]
  float* a_s = l_s + WARPS * MAXG;               // [WARPS][MAXG][D]
  if ((lane & 3) == 0 && fg < g_n) {
    m_s[warp * MAXG + fg] = m_run;
    l_s[warp * MAXG + fg] = l_run;
  }
  if constexpr (MMA) {
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = fk + (e & 1), d = mt * 16 + fg + 8 * (e >> 1);
        if (g < g_n) a_s[(warp * MAXG + g) * D + d] = acc_t[mt][e];
      }
    }
  } else {
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg) {
      if (gg < g_n) {
#pragma unroll
        for (int c = 0; c < L::CPL; ++c) {
          a_s[(warp * MAXG + gg) * D + lane * L::CPL + c] = acc[gg][c];
        }
      }
    }
  }
  __syncthreads();
  const size_t bh_total = (size_t)gridDim.x / ((size_t)n_splits * hk) * hq;  // batch * hq
  for (int i = threadIdx.x; i < g_n * D; i += THREADS) {
    const int gq = i / D, c = i % D;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, m_s[w * MAXG + gq]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = m_s[w * MAXG + gq];
      if (mw == NEG_INF) continue;  // a warp that saw no row
      const float f = expf(mw - mm);
      ll += l_s[w * MAXG + gq] * f;
      aa += a_s[(w * MAXG + gq) * D + c] * f;
    }
    const size_t idx = ((size_t)b * hq + (size_t)h * g_n + gq) * n_splits + split;
    part[2 * bh_total * n_splits + idx * D + c] = aa;
    if (c == 0) {
      part[idx] = mm;
      part[bh_total * n_splits + idx] = ll;
    }
  }
}

// One (batch row, q head): merge the splits that hold visible rows, in
// split order, and write acc / max(l, 1e-30) in q's dtype.
template <int D, typename TQ>
__global__ void __launch_bounds__(D)
paged_combine_kernel(const float* __restrict__ part, const int* __restrict__ lengths,
                     TQ* __restrict__ out, int hq, int block, int width, int split_blocks,
                     int n_splits) {
  const int row = blockIdx.x, b = row / hq, c = threadIdx.x;
  const size_t bh_total = gridDim.x;
  const int length = max(0, min(lengths[b], width * block));
  const int split_rows = split_blocks * block;
  const int used = (length + split_rows - 1) / split_rows;
  const float* pm = part + (size_t)row * n_splits;
  const float* pl = pm + bh_total * n_splits;
  const float* pa = part + 2 * bh_total * n_splits + (size_t)row * n_splits * D;
  float mm = NEG_INF;
  for (int s = 0; s < used; ++s) mm = fmaxf(mm, pm[s]);
  float ll = 0.f, aa = 0.f;
  for (int s = 0; s < used; ++s) {
    const float f = expf(pm[s] - mm);
    ll += pl[s] * f;
    aa += pa[(size_t)s * D + c] * f;
  }
  store(out + (size_t)row * D + c, aa / fmaxf(ll, 1e-30f));
}

template <int D, typename TQ, typename TKV, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* table, const void* lengths, void* out,
                   void* part, int b, int hq, int hk, int num_blocks, int block, int width,
                   int split_blocks, float scale, cudaStream_t stream) {
  using L = Layout<D, TKV>;
  auto kernel = paged_split_kernel<D, TQ, TKV, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::SMEM);
  if (err != cudaSuccess) return err;
  const int n_splits = (width + split_blocks - 1) / split_blocks;
  kernel<<<(unsigned)((size_t)b * hk * n_splits), THREADS, L::SMEM, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<float*>(part), hq, hk, num_blocks, block, width, split_blocks, n_splits,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<D, TQ><<<(unsigned)((size_t)b * hq), D, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(lengths), static_cast<TQ*>(out),
      hq, block, width, split_blocks, n_splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* ks,
                     const void* vs, const void* table, const void* lengths, void* out,
                     void* part, int b, int hq, int hk, int num_blocks, int block, int width,
                     int split_blocks, float scale, int q_bf16, int kv_int8, cudaStream_t s) {
  if (q_bf16 && kv_int8)
    return launch<D, __nv_bfloat16, int8_t, true>(q, k, v, ks, vs, table, lengths, out, part, b,
                                                  hq, hk, num_blocks, block, width,
                                                  split_blocks, scale, s);
  if (q_bf16)
    return launch<D, __nv_bfloat16, __nv_bfloat16, false>(q, k, v, ks, vs, table, lengths, out,
                                                          part, b, hq, hk, num_blocks, block,
                                                          width, split_blocks, scale, s);
  if (kv_int8)
    return launch<D, float, int8_t, true>(q, k, v, ks, vs, table, lengths, out, part, b, hq, hk,
                                          num_blocks, block, width, split_blocks, scale, s);
  return launch<D, float, __nv_bfloat16, false>(q, k, v, ks, vs, table, lengths, out, part, b,
                                                hq, hk, num_blocks, block, width, split_blocks,
                                                scale, s);
}

}  // namespace

// q, out: [b, hq, d] (bf16 if q_bf16 else fp32); k, v: [num_blocks, block, hk,
// d] (int8 if kv_int8 else bf16); k_scale, v_scale: [num_blocks, block, hk]
// fp32 (int8 only, else null); table: [b, width] int32; lengths: [b] int32;
// part: fp32 scratch of b * hq * n_splits * (d + 2) values, n_splits =
// ceil(width / split_blocks); all contiguous on the device, q, k, v 16-byte
// aligned. d must be 64 or 128 and hq a multiple of hk with hq / hk <= 8.
// Launches the split kernel, then the combine kernel, on `stream`. Returns
// the launches' cudaError_t.
extern "C" int paged_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* table, const void* lengths, void* out,
                                   void* part, int b, int hq, int hk, int d, int num_blocks,
                                   int block, int width, int split_blocks, float scale,
                                   int q_bf16, int kv_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0) return 0;
  if (hk <= 0 || hq % hk != 0 || hq / hk > MAXG || block <= 0 || width <= 0 ||
      num_blocks <= 0 || split_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (d == 128)
    return dispatch<128>(q, k, v, k_scale, v_scale, table, lengths, out, part, b, hq, hk,
                         num_blocks, block, width, split_blocks, scale, q_bf16, kv_int8, s);
  if (d == 64)
    return dispatch<64>(q, k, v, k_scale, v_scale, table, lengths, out, part, b, hq, hk,
                        num_blocks, block, width, split_blocks, scale, q_bf16, kv_int8, s);
  return (int)cudaErrorInvalidValue;
}
