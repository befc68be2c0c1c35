// Masked window attention backward for Hopper (sm_90a), on the tensor cores.
//
// Replaces treemorph_tpu/ops/attention.py::_window_attention_bwd_kernel (the
// Pallas TPU kernel behind _bwd_call, the custom VJP of window_attention).
// For every window w and head h of q, k, v (W, H, K, D), the output
// cotangent g (W, H, K, D), and P the forward's probabilities over the
// allowed keys (seg[w, i] == seg[w, j] >= 0):
//
//   dv = P^T g,   dp = g V^T,   ds = P * (dp - rowsum(dp * P)),
//   dq = ds K * scale,          dk = ds^T (q * scale).
//
// The TPU kernel holds a window's whole (K, K) probability tile in VMEM
// (4 MB at K = 1024 in f32), 18x the 227 KB of shared memory a block may
// use. Here no (K, K) tile exists anywhere. The forward saves each row's
// log-sum-exp (csrc/window_attention.cu), so P = exp(s * scale - lse) needs
// no pass of its own, and rowsum(dp * P) = g . o comes from the saved
// output o. Two grids of 64-row tiles, 4 warps of 16 rows each; a block
// loads the next streamed tile into registers while it computes on the
// current one in shared memory:
//
// 1. dq_kernel: per (window, head, 64 query rows). Each warp computes
//    delta = g . o for its rows (written out for the second grid), keeps
//    its rows of q and g as mma fragments, and streams the key tiles (k, v,
//    segment ids) through shared memory: per 8 keys S = q K^T, P, dP = g
//    V^T, dS = P (dP - delta), dq += dS K.
// 2. dk_dv_kernel: per (window, head, 64 key rows), its rows of k and v
//    held; the query tiles (q, g, lse, delta, segment ids) stream through:
//    S^T = k q^T, P^T, dP^T = v g^T, dS^T, dv += P^T g, dk += dS^T q.
//
// So per allowed (query, key) pair and head it does 7 D multiply-adds (the
// gradient needs 5 D; the two grids each recompute S and dP) and two exps.
// All five products run on the TF32 tensor cores (mma.sync.m16n8k8, f32
// accumulators) in 3xTF32: a value splits into hi (rounded to TF32, to
// nearest) and lo (the remainder, rounded the same way), and a product is
// lo*hi + hi*lo + hi*hi; the CPU emulation in tests/test_torch_attention.py
// holds one tile's gradients within 1e-6 of their float64 scale. The
// tensor cores round each mma's sum toward zero, so the passes of one 8-key
// step (and of up to two 8-wide k-steps of S and dP) go into a fresh
// fragment that is added to the f32 sum with a rounded add: chaining every
// mma into one accumulator drifted past the 1e-5 gate over a 1024-key
// window on the card. A pass whose lo
// operand is zero is dropped: bf16 q, k and v are exact in TF32, so in
// bf16 S takes one pass, dP, dq and dk two, dv (P and g are f32) three.
// The products' C fragments feed the next product's A fragments in
// registers: the k index of an A fragment is permuted (lane column t holds
// keys 2t and 2t + 1) and the B fragment is read with the same
// permutation, which leaves the sum unchanged. One row per thread, several
// tiles per warp and the tile vote were tried on the card; 16 rows per
// warp, every 8-key tile of a staged tile computed, was the fastest.
//
// What bounds it on an H100: per pair and head 7 D multiply-adds in 3
// passes (f32) on the tensor cores (495 TFLOP/s) against 5 D on the FP32
// FMA rate (67 TFLOP/s) for the plain arithmetic, and two exps on the
// 16-per-clock special function units; the inputs are read once per tile
// of 64 rows. Each output row is written by one warp with no float atomics,
// so runs repeat bit for bit. A row with no allowed key (padding rows, seg
// -1) has P = 0 and exactly zero gradients; blocks whose rows are all
// padding write zeros and stop, and tiles outside the block's segment range
// are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 64;  // rows per block = rows staged per pass
constexpr int WARPS = 4;  // 16 rows each
constexpr int THREADS = WARPS * 32;
constexpr uint32_t TF32_MASK = 0xffffe000u;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// 2^x on the special function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, where the plain version's exp gives a denormal)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to TF32: to nearest, ties away from zero (half a TF32 unit
// added to the magnitude bits, then the low 13 mantissa bits cleared).
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & TF32_MASK;
}

// the remainder x - hi, rounded the same way
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return tf32_hi(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Shared-memory pitch of a staged row: D + 4 floats puts a fragment load's
// 32 lanes on 32 banks, both as B of S = X Y^T (rows g, columns t) and as
// B of X^T Y (rows 2t and 2t + 1, columns g).
template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 4;
}

// A thread's share of a staged tile: TILE rows of D values in float4s
template <int D>
__host__ __device__ constexpr int tile_vec() {
  return TILE * D / (4 * THREADS);
}

// Load this thread's share of the TILE rows of D values (f32 or bf16) at
// src into registers, as f32; store_rows puts them in shared memory.
template <int D, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          float4 (&r)[tile_vec<D>()]) {
#pragma unroll
  for (int i = 0; i < tile_vec<D>(); ++i) {
    r[i] = load4(src + (threadIdx.x + i * THREADS) * 4);
  }
}

// The loaded share into hi (and, SPLIT, lo) rows of the shared tile.
template <int D, bool SPLIT>
__device__ __forceinline__ void store_rows(const float4 (&r)[tile_vec<D>()],
                                           float* hi_s, float* lo_s) {
  constexpr int P = pitch<D>();
#pragma unroll
  for (int i = 0; i < tile_vec<D>(); ++i) {
    const int e = (threadIdx.x + i * THREADS) * 4;
    const int off = (e / D) * P + (e % D);
    const float xs[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t hi = tf32_hi(xs[c]);
      hi_s[off + c] = __uint_as_float(hi);
      if (SPLIT) lo_s[off + c] = __uint_as_float(tf32_lo(xs[c], hi));
    }
  }
}

// A fragments of a warp's 16 rows (row0 + lane/4, + 8) of X (D wide):
// a[ks] = {X[r][8ks + t], X[r + 8][8ks + t], X[r][8ks + t + 4],
// X[r + 8][8ks + t + 4]}, as f32.
template <int D, typename T>
__device__ __forceinline__ void row_fragments(const T* __restrict__ x,
                                              int row0, float (&a)[D / 8][4]) {
  const int lane = threadIdx.x & 31;
  const T* ra = x + (size_t)(row0 + (lane >> 2)) * D + (lane & 3);
  const T* rb = ra + 8 * D;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    a[ks][0] = to_f32(ra[8 * ks]);
    a[ks][1] = to_f32(rb[8 * ks]);
    a[ks][2] = to_f32(ra[8 * ks + 4]);
    a[ks][3] = to_f32(rb[8 * ks + 4]);
  }
}

template <int D>
__device__ __forceinline__ void split_fragments(const float (&a)[D / 8][4],
                                                uint32_t (&hi)[D / 8][4],
                                                uint32_t (&lo)[D / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[ks][i] = tf32_hi(a[ks][i]);
      lo[ks][i] = tf32_lo(a[ks][i], hi[ks][i]);
    }
  }
}

// c += X Y^T for the warp's 16 rows of X (fragments xh, xl) and the 8
// staged rows y0.. of Y (hi, lo in shared memory): one n8 tile of scores.
// X_EXACT / Y_EXACT drop the passes whose lo operand is zero. Up to two
// k-steps go into a fresh fragment per rounded add.
template <int D, bool X_EXACT, bool Y_EXACT>
__device__ __forceinline__ void rows_times_tile(
    float (&c)[4], const uint32_t (&xh)[D / 8][4],
    const uint32_t (&xl)[D / 8][4], const float* yh_s, const float* yl_s,
    int y0) {
  constexpr int P = pitch<D>();
  constexpr int GROUP = D / 8 < 2 ? D / 8 : 2;  // k-steps per fragment
  const int lane = threadIdx.x & 31;
  const int off = (y0 + (lane >> 2)) * P + (lane & 3);
#pragma unroll
  for (int k0 = 0; k0 < D / 8; k0 += GROUP) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = k0; ks < k0 + GROUP; ++ks) {
      const uint32_t bh0 = __float_as_uint(yh_s[off + 8 * ks]);
      const uint32_t bh1 = __float_as_uint(yh_s[off + 8 * ks + 4]);
      if (!X_EXACT) mma_tf32(part, xl[ks], bh0, bh1);
      if (!Y_EXACT) {
        mma_tf32(part, xh[ks], __float_as_uint(yl_s[off + 8 * ks]),
                 __float_as_uint(yl_s[off + 8 * ks + 4]));
      }
      mma_tf32(part, xh[ks], bh0, bh1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += part[i];
  }
}

// acc (16 x D) += A (16 x 8, the C fragment c of a score tile over the
// staged rows y0..y0+7) times Y[y0..y0+7] (8 x D). The A fragment's k index
// is permuted (lane column t holds rows 2t and 2t + 1), and so is B's.
template <int D, bool Y_EXACT>
__device__ __forceinline__ void tile_times_rows(float (&acc)[D / 8][4],
                                                const float (&c)[4],
                                                const float* yh_s,
                                                const float* yl_s, int y0) {
  constexpr int P = pitch<D>();
  const int lane = threadIdx.x & 31;
  const float a[4] = {c[0], c[2], c[1], c[3]};
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = tf32_hi(a[i]);
    al[i] = tf32_lo(a[i], ah[i]);
  }
  const int off = (y0 + 2 * (lane & 3)) * P + (lane >> 2);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const uint32_t bh0 = __float_as_uint(yh_s[off + 8 * nd]);
    const uint32_t bh1 = __float_as_uint(yh_s[off + P + 8 * nd]);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(part, al, bh0, bh1);
    if (!Y_EXACT) {
      mma_tf32(part, ah, __float_as_uint(yl_s[off + 8 * nd]),
               __float_as_uint(yl_s[off + P + 8 * nd]));
    }
    mma_tf32(part, ah, bh0, bh1);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] += part[i];
  }
}

// The segment range [lo, hi] of a block's TILE rows (hi < 0: all padding).
__device__ __forceinline__ void segment_range(const int32_t* seg_rows,
                                              int* s_lo, int* s_hi, int* lo,
                                              int* hi) {
  if (threadIdx.x == 0) {
    *s_lo = INT32_MAX;
    *s_hi = -1;
  }
  __syncthreads();
  if (threadIdx.x < TILE) {
    const int s = seg_rows[threadIdx.x];
    if (s >= 0) {
      atomicMin(s_lo, s);
      atomicMax(s_hi, s);
    }
  }
  __syncthreads();
  *lo = *s_lo;
  *hi = *s_hi;
}

// Zero rows row0.. of a (.., D) f32 output for the warp's 16 rows.
template <int D>
__device__ __forceinline__ void zero_rows(float* out, int row0) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 16 * D; e += 32) out[(size_t)row0 * D + e] = 0.f;
}

// Write the warp's 16 x D accumulator (C fragments over D / 8 column tiles)
// times `mul` to rows row0.. of out.
template <int D>
__device__ __forceinline__ void write_rows(float* out, int row0,
                                           const float (&acc)[D / 8][4],
                                           float mul) {
  const int lane = threadIdx.x & 31;
  float* ra = out + (size_t)(row0 + (lane >> 2)) * D + 2 * (lane & 3);
  float* rb = ra + 8 * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    *reinterpret_cast<float2*>(ra + 8 * nd) =
        make_float2(acc[nd][0] * mul, acc[nd][1] * mul);
    *reinterpret_cast<float2*>(rb + 8 * nd) =
        make_float2(acc[nd][2] * mul, acc[nd][3] * mul);
  }
}

template <typename T, int D>
struct Smem {
  static constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int ROWS = TILE * pitch<D>();  // floats of one tile
  // two operands, each hi and (not EXACT, or always for g) lo
  static constexpr size_t DQ = (size_t)(EXACT ? 2 : 4) * ROWS * sizeof(float);
  static constexpr size_t DKDV = (size_t)(EXACT ? 3 : 4) * ROWS * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int32_t* __restrict__ seg,
          const float* __restrict__ g, const float* __restrict__ o,
          const float* __restrict__ lse, float* __restrict__ dq,
          float* __restrict__ delta, int heads, int kk, float scale) {
  constexpr bool EXACT = Smem<T, D>::EXACT;
  constexpr int KS = D / 8;
  constexpr int ROWS = Smem<T, D>::ROWS;
  extern __shared__ __align__(16) float smem[];
  float* k_hi = smem;
  float* v_hi = smem + ROWS;
  float* k_lo = smem + 2 * ROWS;  // f32 inputs only
  float* v_lo = smem + 3 * ROWS;
  __shared__ int seg_s[TILE];
  __shared__ int s_lo, s_hi;

  const int n_tiles = kk / TILE;
  const int tile = blockIdx.x % n_tiles;
  const int wh = blockIdx.x / n_tiles;  // window * heads + head
  const int w = wh / heads;
  const size_t base = (size_t)wh * kk * D;
  const int32_t* seg_w = seg + (size_t)w * kk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row0 = tile * TILE + warp * 16;  // the warp's first query row
  const int ra = row0 + (lane >> 2), rb = ra + 8;

  int lo, hi;
  segment_range(seg_w + tile * TILE, &s_lo, &s_hi, &lo, &hi);
  if (hi < 0) {  // every query row is padding
    zero_rows<D>(dq + base, row0);
    if (lane < 16) delta[(size_t)wh * kk + row0 + lane] = 0.f;
    return;
  }
  const int seg_a = seg_w[ra], seg_b = seg_w[rb];

  // delta = g . o of rows ra, rb, over the quad's columns, then the quad
  float gf[KS][4], of[KS][4];
  row_fragments<D>(g + base, row0, gf);
  row_fragments<D>(o + base, row0, of);
  float da = 0.f, db = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    da = fmaf(gf[ks][0], of[ks][0], fmaf(gf[ks][2], of[ks][2], da));
    db = fmaf(gf[ks][1], of[ks][1], fmaf(gf[ks][3], of[ks][3], db));
  }
  da += __shfl_xor_sync(FULL, da, 1);
  da += __shfl_xor_sync(FULL, da, 2);
  db += __shfl_xor_sync(FULL, db, 1);
  db += __shfl_xor_sync(FULL, db, 2);
  if (seg_a < 0) da = 0.f;
  if (seg_b < 0) db = 0.f;
  if (t == 0) {
    delta[(size_t)wh * kk + ra] = da;
    delta[(size_t)wh * kk + rb] = db;
  }

  uint32_t g_hi[KS][4], g_lo[KS][4], q_hi[KS][4], q_lo[KS][4];
  split_fragments<D>(gf, g_hi, g_lo);
  {
    float qf[KS][4];
    row_fragments<D>(q + base, row0, qf);
    split_fragments<D>(qf, q_hi, q_lo);
  }
  const float scale2 = scale * LOG2E;
  const float lse_a = seg_a >= 0 ? lse[(size_t)wh * kk + ra] * LOG2E : 0.f;
  const float lse_b = seg_b >= 0 ? lse[(size_t)wh * kk + rb] * LOG2E : 0.f;
  const bool warp_live = __any_sync(FULL, seg_a >= 0 || seg_b >= 0);

  float acc[KS][4];
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  // key tile kt + 1 is loaded into registers while tile kt is computed
  float4 k_next[tile_vec<D>()], v_next[tile_vec<D>()];
  int seg_next = threadIdx.x < TILE ? seg_w[threadIdx.x] : -1;
  load_rows<D>(k + base, k_next);
  load_rows<D>(v + base, v_next);
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile is consumed
    const int key_seg = seg_next;
    if (threadIdx.x < TILE) seg_s[threadIdx.x] = key_seg;
    // a tile with no key in the rows' segment range is not staged
    const bool in_range = __syncthreads_or(key_seg >= lo && key_seg <= hi);
    if (in_range) {
      store_rows<D, !EXACT>(k_next, k_hi, k_lo);
      store_rows<D, !EXACT>(v_next, v_hi, v_lo);
    }
    if (kt + 1 < n_tiles) {
      const size_t next = base + (size_t)(kt + 1) * TILE * D;
      if (threadIdx.x < TILE) seg_next = seg_w[(kt + 1) * TILE + threadIdx.x];
      load_rows<D>(k + next, k_next);
      load_rows<D>(v + next, v_next);
    }
    if (!in_range) continue;
    __syncthreads();
    if (!warp_live) continue;
#pragma unroll 2
    for (int j = 0; j < TILE / 8; ++j) {
      const int s0 = seg_s[8 * j + 2 * t], s1 = seg_s[8 * j + 2 * t + 1];
      const bool ok[4] = {seg_a >= 0 && seg_a == s0, seg_a >= 0 && seg_a == s1,
                          seg_b >= 0 && seg_b == s0, seg_b >= 0 && seg_b == s1};
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      rows_times_tile<D, EXACT, EXACT>(s, q_hi, q_lo, k_hi, k_lo, 8 * j);
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      rows_times_tile<D, false, EXACT>(dp, g_hi, g_lo, v_hi, v_lo, 8 * j);
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lse2 = i < 2 ? lse_a : lse_b;
        const float p =
            ok[i] ? exp2_approx(fmaf(s[i], scale2, -lse2)) : 0.f;
        ds[i] = p * (dp[i] - (i < 2 ? da : db));
      }
      tile_times_rows<D, EXACT>(acc, ds, k_hi, k_lo, 8 * j);
    }
  }
  write_rows<D>(dq + base, row0, acc, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dk_dv_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int32_t* __restrict__ seg,
             const float* __restrict__ g, const float* __restrict__ lse,
             const float* __restrict__ delta, float* __restrict__ dk,
             float* __restrict__ dv, int heads, int kk, float scale) {
  constexpr bool EXACT = Smem<T, D>::EXACT;
  constexpr int KS = D / 8;
  constexpr int ROWS = Smem<T, D>::ROWS;
  extern __shared__ __align__(16) float smem[];
  float* g_hi = smem;
  float* g_lo = smem + ROWS;
  float* q_hi = smem + 2 * ROWS;
  float* q_lo = smem + 3 * ROWS;  // f32 inputs only
  __shared__ int seg_s[TILE];
  __shared__ float lse_s[TILE], delta_s[TILE];
  __shared__ int s_lo, s_hi;

  const int n_tiles = kk / TILE;
  const int tile = blockIdx.x % n_tiles;
  const int wh = blockIdx.x / n_tiles;
  const int w = wh / heads;
  const size_t base = (size_t)wh * kk * D;
  const int32_t* seg_w = seg + (size_t)w * kk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row0 = tile * TILE + warp * 16;  // the warp's first key row
  const int ra = row0 + (lane >> 2), rb = ra + 8;

  int lo, hi;
  segment_range(seg_w + tile * TILE, &s_lo, &s_hi, &lo, &hi);
  if (hi < 0) {  // every key row is padding
    zero_rows<D>(dk + base, row0);
    zero_rows<D>(dv + base, row0);
    return;
  }
  const int seg_a = seg_w[ra], seg_b = seg_w[rb];

  uint32_t k_hi[KS][4], k_lo[KS][4], v_hi[KS][4], v_lo[KS][4];
  {
    float f[KS][4];
    row_fragments<D>(k + base, row0, f);
    split_fragments<D>(f, k_hi, k_lo);
    row_fragments<D>(v + base, row0, f);
    split_fragments<D>(f, v_hi, v_lo);
  }
  const float scale2 = scale * LOG2E;
  const bool warp_live = __any_sync(FULL, seg_a >= 0 || seg_b >= 0);

  float acc_k[KS][4], acc_v[KS][4];
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[nd][i] = acc_v[nd][i] = 0.f;

  // query tile qt + 1 is loaded into registers while tile qt is computed
  float4 q_next[tile_vec<D>()], g_next[tile_vec<D>()];
  int seg_next = -1;
  float lse_next = 0.f, delta_next = 0.f;
  auto load_tile = [&](int qt) {
    const size_t tile_base = base + (size_t)qt * TILE * D;
    if (threadIdx.x < TILE) {
      const size_t r = (size_t)wh * kk + qt * TILE + threadIdx.x;
      seg_next = seg_w[qt * TILE + threadIdx.x];
      lse_next = lse[r];
      delta_next = delta[r];
    }
    load_rows<D>(q + tile_base, q_next);
    load_rows<D>(g + tile_base, g_next);
  };
  load_tile(0);
  for (int qt = 0; qt < n_tiles; ++qt) {
    __syncthreads();  // the previous tile is consumed
    const int query_seg = seg_next;
    if (threadIdx.x < TILE) {
      seg_s[threadIdx.x] = query_seg;
      lse_s[threadIdx.x] = query_seg >= 0 ? lse_next * LOG2E : 0.f;
      delta_s[threadIdx.x] = delta_next;
    }
    // a tile with no query in the rows' segment range is not staged
    const bool in_range =
        __syncthreads_or(query_seg >= lo && query_seg <= hi);
    if (in_range) {
      store_rows<D, !EXACT>(q_next, q_hi, q_lo);
      store_rows<D, true>(g_next, g_hi, g_lo);
    }
    if (qt + 1 < n_tiles) load_tile(qt + 1);
    if (!in_range) continue;
    __syncthreads();
    if (!warp_live) continue;
#pragma unroll 2
    for (int j = 0; j < TILE / 8; ++j) {
      const int c0 = 8 * j + 2 * t;
      const int s0 = seg_s[c0], s1 = seg_s[c0 + 1];
      const bool ok[4] = {seg_a >= 0 && seg_a == s0, seg_a >= 0 && seg_a == s1,
                          seg_b >= 0 && seg_b == s0, seg_b >= 0 && seg_b == s1};
      float st[4] = {0.f, 0.f, 0.f, 0.f};
      rows_times_tile<D, EXACT, EXACT>(st, k_hi, k_lo, q_hi, q_lo, 8 * j);
      float dpt[4] = {0.f, 0.f, 0.f, 0.f};
      rows_times_tile<D, EXACT, false>(dpt, v_hi, v_lo, g_hi, g_lo, 8 * j);
      float pt[4], dst[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c0 + (i & 1);
        pt[i] = ok[i] ? exp2_approx(fmaf(st[i], scale2, -lse_s[col])) : 0.f;
        dst[i] = pt[i] * (dpt[i] - delta_s[col]);
      }
      tile_times_rows<D, false>(acc_v, pt, g_hi, g_lo, 8 * j);
      tile_times_rows<D, EXACT>(acc_k, dst, q_hi, q_lo, 8 * j);
    }
  }
  write_rows<D>(dk + base, row0, acc_k, scale);
  write_rows<D>(dv + base, row0, acc_v, 1.f);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* seg, const float* g, const float* o,
                   const float* lse, float* dq, float* dk, float* dv,
                   float* delta, int n_windows, int heads, int kk,
                   float scale, cudaStream_t stream) {
  const long long blocks = (long long)n_windows * heads * (kk / TILE);
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  constexpr size_t dq_smem = Smem<T, D>::DQ, dkdv_smem = Smem<T, D>::DKDV;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dk_dv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<T, D><<<(unsigned)blocks, THREADS, dq_smem, stream>>>(
      qt, kt, vt, seg, g, o, lse, dq, delta, heads, kk, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dk_dv_kernel<T, D><<<(unsigned)blocks, THREADS, dkdv_smem, stream>>>(
      qt, kt, vt, seg, g, lse, delta, dk, dv, heads, kk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v,
                       const int32_t* seg, const float* g, const float* o,
                       const float* lse, float* dq, float* dk, float* dv,
                       float* delta, int n_windows, int heads, int kk, int d,
                       float scale, cudaStream_t s) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, seg, g, o, lse, dq, dk, dv, delta,
                          n_windows, heads, kk, scale, s);
    case 16:
      return launch<T, 16>(q, k, v, seg, g, o, lse, dq, dk, dv, delta,
                           n_windows, heads, kk, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, seg, g, o, lse, dq, dk, dv, delta,
                           n_windows, heads, kk, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, seg, g, o, lse, dq, dk, dv, delta,
                           n_windows, heads, kk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches both grids on `stream`; returns the CUDA error code (0 = ok).
// q, k, v are (n_windows, heads, kk, d), f32 or (inputs_bf16) bf16, 16-byte
// aligned; seg is (n_windows, kk) int32; g, out (the forward's output), dq,
// dk, dv are (n_windows, heads, kk, d) f32; lse (the forward's log-sum-exp)
// and delta (scratch) are (n_windows, heads, kk) f32. d must be 8, 16, 32
// or 64 and kk a positive multiple of 64.
int window_attention_bwd_launch(const void* q, const void* k, const void* v,
                                const void* seg, const void* g,
                                const void* out, const void* lse,
                                int inputs_bf16, void* dq, void* dk, void* dv,
                                void* delta, int n_windows, int heads, int kk,
                                int d, float scale, void* stream) {
  if (n_windows < 0 || heads < 1 || kk < TILE || kk % TILE != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_windows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sg = static_cast<const int32_t*>(seg);
  const auto* gf = static_cast<const float*>(g);
  const auto* of = static_cast<const float*>(out);
  const auto* lf = static_cast<const float*>(lse);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto* df = static_cast<float*>(delta);
  const cudaError_t err =
      inputs_bf16
          ? launch_dim<__nv_bfloat16>(q, k, v, sg, gf, of, lf, dqf, dkf, dvf,
                                      df, n_windows, heads, kk, d, scale, s)
          : launch_dim<float>(q, k, v, sg, gf, of, lf, dqf, dkf, dvf, df,
                              n_windows, heads, kk, d, scale, s);
  return (int)err;
}

}  // extern "C"
