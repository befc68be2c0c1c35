// Masked window attention forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces treemorph_tpu/ops/attention.py::_window_attention_kernel (the
// Pallas TPU kernel behind _window_attention_fwd_impl, public
// window_attention). For every window w and head h of q, k, v (W, H, K, D):
//
//   out[w, h, i] = sum_j softmax_j(q_i . k_j * D^-1/2) v_j
//
// over the keys j allowed for query i: seg[w, i] == seg[w, j] >= 0. A query
// with no allowed key (padding rows, seg -1) writes 0, never NaN. When the
// caller passes an lse buffer (training: csrc/window_attention_bwd.cu reads
// it), every row also writes its log-sum-exp m + log(l) of the scaled
// scores (0 for a row with no allowed key); inference passes none, and the
// output is the same bit for bit either way.
//
// The TPU kernel holds a window's whole (K, K) score tile in VMEM (4 MB at
// K = 1024), 18x the 227 KB of shared memory a block may use. Here, as in
// flash attention 2, no score tile reaches device memory. A block of 4
// warps owns 128 query rows of one (window, head) at D <= 16 (32 rows a
// warp, two m16 tiles that share every staged B fragment), 64 rows above
// (16 a warp); the warp's q fragments stay in registers. The key, value
// and segment-id tiles of 64 keys stream through shared memory: cp.async
// copies the next tile into one of two raw buffers while the warps compute
// on the current one, which the block first splits into the operands of
// the products. Per staged tile each warp computes its rows' scores
// S = q K^T over the 64 keys, masks them (skipped when the block's rows and
// the tile's keys hold one segment, almost every tile of a level-0
// window), takes each row's max across the quad once, rescales its running
// sum l and output sums O once, forms P = 2^(S c - m c) with
// c = D^-1/2 log2(e) folded into that one FMA (the backward's ex2.approx),
// and adds P V. Each row's statistics are merged across the quad at the
// end; one warp writes each row, no float atomics, so a second call
// repeats bit for bit.
//
// Both products run on the TF32 tensor cores (mma.sync.m16n8k8, f32
// accumulators) in 3xTF32: a value splits into hi (rounded to TF32, to
// nearest) and lo (the remainder, rounded the same way; P's remainder is
// handed over unrounded and the mma reads its TF32 bits), and a product is
// lo*hi + hi*lo + hi*hi. A pass whose lo operand is zero is dropped: bf16
// q, k and v are exact in TF32, so in bf16 S takes one pass and P V two.
// The C fragment of S feeds P V as an A fragment in registers, its k index
// permuted (lane column t holds keys 2t and 2t + 1) and V's B fragment read
// with the same permutation. The tensor cores round each mma's sum toward
// zero, so the passes of up to two 8-wide k-steps of S, and of each 32
// keys of P V, go into a fresh fragment that is added to the f32 sums with
// a rounded add; tests/test_torch_attention.py emulates this arithmetic and
// holds one tile within 1e-6 of its float64 scale.
//
// What bounds it on an H100: per allowed (query, key) pair and head 4 D
// multiply-adds in 3 (f32) or 1 + 2 (bf16) passes at the TF32 rate
// (495 TFLOP/s; mma.sync reaches part of it), one exp on the special
// function units (16 a clock per SM), the splits of P, and the
// shared-memory reads of the staged operands (every warp of a block reads
// the whole tile); each input is read once per block of rows. A block
// whose rows are all padding writes zeros with 16-byte stores and reads no
// q, k or v; a key tile with no key in the rows' segment range is neither
// staged nor computed. At D <= 16 a window whose K is an odd multiple of
// 64 ends in a block of 64 rows, whose last two warps only stage. At D = 16 the kernel
// takes 168 registers, 3 blocks an SM (4 bytes spilled in f32, none in
// bf16).
//
// Tried and dropped (NVIDIA H100 80GB HBM3, 700 W; ms per launch at the
// plot's level-0 shape (530, 2, 1024, 16) in f32 on random inputs of one
// segment, variants side by side within a call): 16 rows a warp, 1.72, against 32, 1.40 (150 and 168
// registers, 3 blocks an SM either way); 8 warps of 16 rows, 1.97;
// registers capped at 80 for 6 blocks an SM, 1.63 (spills); 2 blocks of
// 225 registers, 1.56. Against this design's 1.34: P V per 16 keys a
// fragment with P's remainder rounded, 1.40; one barrier per tile with the
// split operands double-buffered, 1.38 (spills); P split with FP32
// operations only (Veltkamp), 1.39.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 64;   // keys per staged tile
constexpr int WARPS = 4;   // per block
constexpr int THREADS = WARPS * 32;
constexpr int PV_KEYS = 32;  // keys of P V per fresh fragment
constexpr uint32_t TF32_MASK = 0xffffe000u;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive elements of a raw staged tile, as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// m16 tiles of query rows per warp: two (32 rows, 128 per block) up to
// D = 16, where reusing each staged B fragment for both halves the
// shared-memory reads; one above, where two would not fit the registers.
__host__ __device__ constexpr int m_tiles(int d) { return d <= 16 ? 2 : 1; }

// Shared memory of a block, in bytes from its start: the split operands
// (k and v hi, then, f32 only, k and v lo; TILE rows at a pitch of D + 4
// floats, which puts a fragment load's 32 lanes on 32 banks both as B of
// S = q K^T, rows g and columns t, and as B of P V, rows 2t and 2t + 1 and
// columns g), the raw k and v tiles of two stages, their segment ids, the
// computed tile's segment ids and one flag byte per key tile.
template <typename T, int D>
struct Smem {
  static constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int PITCH = D + 4;
  static constexpr int ROWS = TILE * PITCH;           // floats of one operand
  static constexpr int RAW = TILE * D * sizeof(T);    // bytes of one raw tile
  static constexpr int SPLIT = (EXACT ? 2 : 4) * ROWS * 4;
  static constexpr int RAW_SEG = SPLIT + 4 * RAW;     // [stage][TILE] ints
  static constexpr int SEG = RAW_SEG + 2 * TILE * 4;  // [TILE] ints
  static constexpr int FLAGS = SEG + TILE * 4;
  static size_t bytes(int n_tiles) { return FLAGS + ((n_tiles + 15) & ~15); }
};

// Copy key tile kt (k, v and segment ids) into raw stage `stage`.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(unsigned char* smem, const T* k,
                                           const T* v, const int32_t* seg_w,
                                           int kt, int stage) {
  using S = Smem<T, D>;
  const size_t off = (size_t)kt * TILE * D;
  const auto* ks = reinterpret_cast<const unsigned char*>(k + off);
  const auto* vs = reinterpret_cast<const unsigned char*>(v + off);
  unsigned char* kd = smem + S::SPLIT + 2 * stage * S::RAW;
  unsigned char* vd = kd + S::RAW;
  for (int i = threadIdx.x; i < S::RAW / 16; i += THREADS) {
    cp_async16(kd + 16 * i, ks + 16 * i);
    cp_async16(vd + 16 * i, vs + 16 * i);
  }
  if (threadIdx.x < TILE / 4) {
    cp_async16(smem + S::RAW_SEG + stage * TILE * 4 + 16 * threadIdx.x,
               seg_w + kt * TILE + 4 * threadIdx.x);
  }
  cp_async_commit();
}

// Split a raw tile of TILE rows of D values into hi (and, SPLIT, lo) rows.
template <typename T, int D, bool SPLIT>
__device__ __forceinline__ void split_tile(const T* raw, float* hi_s,
                                           float* lo_s) {
  constexpr int P = D + 4;
#pragma unroll
  for (int i = 0; i < TILE * D / (4 * THREADS); ++i) {
    const int e = 4 * (threadIdx.x + i * THREADS);
    const int off = (e / D) * P + (e % D);
    const float4 x = load4(raw + e);
    const uint32_t h0 = tf32_hi(x.x), h1 = tf32_hi(x.y), h2 = tf32_hi(x.z),
                   h3 = tf32_hi(x.w);
    *reinterpret_cast<float4*>(hi_s + off) =
        make_float4(__uint_as_float(h0), __uint_as_float(h1),
                    __uint_as_float(h2), __uint_as_float(h3));
    if (SPLIT) {
      *reinterpret_cast<float4*>(lo_s + off) = make_float4(
          __uint_as_float(tf32_lo(x.x, h0)), __uint_as_float(tf32_lo(x.y, h1)),
          __uint_as_float(tf32_lo(x.z, h2)), __uint_as_float(tf32_lo(x.w, h3)));
    }
  }
}

// c[mt] += q_mt K^T for the warp's m-tiles (fragments xh, xl) and the 8
// staged keys y0..: one n8 tile of scores each, every B fragment loaded
// once for all m-tiles. Up to two k-steps go into a fresh fragment per
// rounded add (into c itself when that is all of D: c starts at 0); EXACT
// drops the passes with a zero lo.
template <int D, bool EXACT, int MT>
__device__ __forceinline__ void scores(float (&c)[MT][4],
                                       const uint32_t (&xh)[MT][D / 8][4],
                                       const uint32_t (&xl)[MT][D / 8][4],
                                       const float* yh_s, const float* yl_s,
                                       int y0) {
  constexpr int P = D + 4;
  constexpr int GROUP = D / 8 < 2 ? D / 8 : 2;  // k-steps per fragment
  constexpr bool DIRECT = GROUP == D / 8;
  const int lane = threadIdx.x & 31;
  const int off = (y0 + (lane >> 2)) * P + (lane & 3);
#pragma unroll
  for (int k0 = 0; k0 < D / 8; k0 += GROUP) {
    float part[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][i] = 0.f;
#pragma unroll
    for (int ks = k0; ks < k0 + GROUP; ++ks) {
      const uint32_t bh0 = __float_as_uint(yh_s[off + 8 * ks]);
      const uint32_t bh1 = __float_as_uint(yh_s[off + 8 * ks + 4]);
      uint32_t bl0 = 0, bl1 = 0;
      if (!EXACT) {
        bl0 = __float_as_uint(yl_s[off + 8 * ks]);
        bl1 = __float_as_uint(yl_s[off + 8 * ks + 4]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float(&acc)[4] = DIRECT ? c[mt] : part[mt];
        if (!EXACT) {
          mma_tf32(acc, xl[mt][ks], bh0, bh1);
          mma_tf32(acc, xh[mt][ks], bl0, bl1);
        }
        mma_tf32(acc, xh[mt][ks], bh0, bh1);
      }
    }
    if (!DIRECT) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[mt][i] += part[mt][i];
    }
  }
}

// part[mt] (16 x D) += P_mt (16 x 8, the C fragment p[mt] of the
// probabilities of the staged keys y0..y0+7) times V[y0..y0+7] (8 x D).
// P splits into hi (rounded to TF32) and lo = p - hi, handed to the mma
// unrounded (it reads the TF32 bits, the top 19). The A fragment's k index
// is permuted (lane column t holds keys 2t and 2t + 1), and so is B's.
template <int D, bool EXACT, int MT>
__device__ __forceinline__ void probs_values(float (&part)[MT][D / 8][4],
                                             const float (&p)[MT][4],
                                             const float* yh_s,
                                             const float* yl_s, int y0) {
  constexpr int P = D + 4;
  const int lane = threadIdx.x & 31;
  uint32_t ah[MT][4], al[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float a[4] = {p[mt][0], p[mt][2], p[mt][1], p[mt][3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[mt][i] = tf32_hi(a[i]);
      al[mt][i] = __float_as_uint(a[i] - __uint_as_float(ah[mt][i]));
    }
  }
  const int off = (y0 + 2 * (lane & 3)) * P + (lane >> 2);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const uint32_t bh0 = __float_as_uint(yh_s[off + 8 * nd]);
    const uint32_t bh1 = __float_as_uint(yh_s[off + P + 8 * nd]);
    uint32_t bl0 = 0, bl1 = 0;
    if (!EXACT) {
      bl0 = __float_as_uint(yl_s[off + 8 * nd]);
      bl1 = __float_as_uint(yl_s[off + P + 8 * nd]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_tf32(part[mt][nd], al[mt], bh0, bh1);
      if (!EXACT) mma_tf32(part[mt][nd], ah[mt], bl0, bl1);
      mma_tf32(part[mt][nd], ah[mt], bh0, bh1);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, m_tiles(D) == 2 ? 3 : 1)
window_attention_kernel(const T* __restrict__ q,          // (W, H, K, D)
                        const T* __restrict__ k,          // (W, H, K, D)
                        const T* __restrict__ v,          // (W, H, K, D)
                        const int32_t* __restrict__ seg,  // (W, K)
                        float* __restrict__ out,          // (W, H, K, D)
                        float* __restrict__ lse,          // (W, H, K) or null
                        int heads, int kk, float scale) {
  using S = Smem<T, D>;
  constexpr bool EXACT = S::EXACT;
  constexpr int KS = D / 8;
  constexpr int MT = m_tiles(D);
  constexpr int QROWS = WARPS * 16 * MT;  // query rows per block
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_hi = reinterpret_cast<float*>(smem);
  float* v_hi = k_hi + S::ROWS;
  float* k_lo = v_hi + S::ROWS;  // f32 inputs only
  float* v_lo = k_lo + S::ROWS;
  int* seg_s = reinterpret_cast<int*>(smem + S::SEG);
  unsigned char* flags = smem + S::FLAGS;
  __shared__ int s_lo, s_hi;

  const int n_tiles = kk / TILE;
  const int n_q = (kk + QROWS - 1) / QROWS;
  const int tile = blockIdx.x % n_q;
  const int wh = blockIdx.x / n_q;  // window * heads + head
  const int w = wh / heads;
  const size_t base = (size_t)wh * kk * D;
  const int32_t* seg_w = seg + (size_t)w * kk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  // the block's rows: QROWS from `first`, or the 64 left at the window's end
  const int first = tile * QROWS;
  const int rows = min(QROWS, kk - first);
  const int row0 = first + warp * 16 * MT;  // the warp's first query row
  const bool warp_in = row0 < kk;  // kk is a multiple of 64: whole warps

  // the segment range [lo, hi] of the block's rows, and whether every row
  // holds one and the same segment
  if (threadIdx.x == 0) {
    s_lo = INT32_MAX;
    s_hi = -1;
  }
  __syncthreads();
  const int my_seg = threadIdx.x < rows ? seg_w[first + threadIdx.x] : 0;
  if (threadIdx.x < rows && my_seg >= 0) {
    atomicMin(&s_lo, my_seg);
    atomicMax(&s_hi, my_seg);
  }
  const bool rows_full = __syncthreads_and(my_seg >= 0);
  const int lo = s_lo, hi = s_hi;
  if (hi < 0) {  // every query row is padding
    float4* o4 = reinterpret_cast<float4*>(out + base + (size_t)first * D);
    for (int i = threadIdx.x; i < rows * D / 4; i += THREADS) {
      o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (lse && threadIdx.x < rows) lse[(size_t)wh * kk + first + threadIdx.x] = 0.f;
    return;
  }
  const bool one_seg = rows_full && lo == hi;

  // per key tile: bit 0, some key in [lo, hi] (else the tile is skipped);
  // bit 1, every key of a one-segment block's segment (no mask needed)
  for (int kt = warp; kt < n_tiles; kt += WARPS) {
    const int2 s2 = *reinterpret_cast<const int2*>(seg_w + kt * TILE + 2 * lane);
    const bool in = (s2.x >= lo && s2.x <= hi) || (s2.y >= lo && s2.y <= hi);
    const bool any_in = __any_sync(FULL, in);
    const bool all_same = __all_sync(FULL, s2.x == lo && s2.y == lo);
    if (lane == 0) flags[kt] = (any_in ? 1 : 0) | (one_seg && all_same ? 2 : 0);
  }
  __syncthreads();
  auto next_live = [&](int kt) {
    while (kt < n_tiles && !(flags[kt] & 1)) ++kt;
    return kt;
  };
  // the block's own key tiles hold its rows, so some tile is live
  int kt = next_live(0);
  stage_tile<T, D>(smem, k + base, v + base, seg_w, kt, 0);

  // rows g and g + 8 of each m-tile, their segments, q split hi/lo
  int seg_r[MT][2];
  bool any_row = false;
  uint32_t q_hi[MT][KS][4], q_lo[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ra = row0 + 16 * mt + (lane >> 2);
    seg_r[mt][0] = warp_in ? seg_w[ra] : -1;
    seg_r[mt][1] = warp_in ? seg_w[ra + 8] : -1;
    any_row |= seg_r[mt][0] >= 0 || seg_r[mt][1] >= 0;
    const T* qa = q + base + (size_t)ra * D + t;
    const T* qb = qa + 8 * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float f[4] = {
          warp_in ? to_f32(qa[8 * ks]) : 0.f, warp_in ? to_f32(qb[8 * ks]) : 0.f,
          warp_in ? to_f32(qa[8 * ks + 4]) : 0.f,
          warp_in ? to_f32(qb[8 * ks + 4]) : 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q_hi[mt][ks][i] = tf32_hi(f[i]);
        q_lo[mt][ks][i] = tf32_lo(f[i], q_hi[mt][ks][i]);
      }
    }
  }
  const bool warp_live = __any_sync(FULL, any_row);
  const float c = scale * LOG2E;
  // per row: the running max of the raw scores (m), the same times c as
  // the exps take it (mc), this thread's share of the running sum (l)
  float m[MT][2], mc[MT][2], l[MT][2];
  float o[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      mc[mt][r] = 0.f;
      l[mt][r] = 0.f;
    }
#pragma unroll
    for (int nd = 0; nd < KS; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][nd][i] = 0.f;
  }

  for (int stage = 0; kt < n_tiles; stage ^= 1) {
    const int next = next_live(kt + 1);
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed; the previous tile is consumed
    const T* raw =
        reinterpret_cast<const T*>(smem + S::SPLIT + 2 * stage * S::RAW);
    split_tile<T, D, !EXACT>(raw, k_hi, k_lo);
    split_tile<T, D, !EXACT>(raw + TILE * D, v_hi, v_lo);
    if (threadIdx.x < TILE) {
      seg_s[threadIdx.x] = reinterpret_cast<const int*>(
          smem + S::RAW_SEG)[stage * TILE + threadIdx.x];
    }
    if (next < n_tiles) {
      stage_tile<T, D>(smem, k + base, v + base, seg_w, next, stage ^ 1);
    }
    __syncthreads();
    const bool masked = !(flags[kt] & 2);
    kt = next;
    if (!warp_live) continue;

    float s[TILE / 8][MT][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][mt][i] = 0.f;
      scores<D, EXACT, MT>(s[j], q_hi, q_lo, k_hi, k_lo, 8 * j);
    }
    if (masked) {
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const int2 sk = *reinterpret_cast<const int2*>(seg_s + 8 * j + 2 * t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int sa = seg_r[mt][0], sb = seg_r[mt][1];
          if (sa < 0 || sa != sk.x) s[j][mt][0] = -INFINITY;
          if (sa < 0 || sa != sk.y) s[j][mt][1] = -INFINITY;
          if (sb < 0 || sb != sk.x) s[j][mt][2] = -INFINITY;
          if (sb < 0 || sb != sk.y) s[j][mt][3] = -INFINITY;
        }
      }
    }
    // per row: one max across the quad, one rescale, the exps
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          mx = fmaxf(mx, fmaxf(s[j][mt][2 * r], s[j][mt][2 * r + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float mn = fmaxf(m[mt][r], mx);
        // no allowed key yet: the exps below give 0 with an offset of 0
        const float off = mn == -INFINITY ? 0.f : mn * c;
        const float al =
            m[mt][r] == -INFINITY ? 0.f : exp2_approx(mc[mt][r] - off);
        m[mt][r] = mn;
        mc[mt][r] = off;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          float(&x)[4] = s[j][mt];
          x[2 * r] = exp2_approx(fmaf(x[2 * r], c, -off));
          x[2 * r + 1] = exp2_approx(fmaf(x[2 * r + 1], c, -off));
          sum += x[2 * r] + x[2 * r + 1];
        }
        l[mt][r] = fmaf(l[mt][r], al, sum);
#pragma unroll
        for (int nd = 0; nd < KS; ++nd) {
          o[mt][nd][2 * r] *= al;
          o[mt][nd][2 * r + 1] *= al;
        }
      }
    }
    // O += P V, PV_KEYS keys per fresh fragment
#pragma unroll
    for (int j = 0; j < TILE / 8; j += PV_KEYS / 8) {
      float part[MT][KS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nd = 0; nd < KS; ++nd)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mt][nd][i] = 0.f;
#pragma unroll
      for (int jj = j; jj < j + PV_KEYS / 8; ++jj) {
        probs_values<D, EXACT, MT>(part, s[jj], v_hi, v_lo, 8 * jj);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nd = 0; nd < KS; ++nd)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[mt][nd][i] += part[mt][nd][i];
    }
  }

  if (!warp_in) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ra = row0 + 16 * mt + (lane >> 2);
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(FULL, lr, 1);
      lr += __shfl_xor_sync(FULL, lr, 2);
      // no allowed key: O = 0 and l = 0, written as 0
      inv[r] = lr > 0.f ? 1.f / lr : 0.f;
      if (lse && t == 0) {
        lse[(size_t)wh * kk + ra + 8 * r] =
            lr > 0.f ? fmaf(mc[mt][r], LN2, logf(lr)) : 0.f;
      }
    }
    float* oa = out + base + (size_t)ra * D + 2 * t;
    float* ob = oa + 8 * D;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd) {
      *reinterpret_cast<float2*>(oa + 8 * nd) =
          make_float2(o[mt][nd][0] * inv[0], o[mt][nd][1] * inv[0]);
      *reinterpret_cast<float2*>(ob + 8 * nd) =
          make_float2(o[mt][nd][2] * inv[1], o[mt][nd][3] * inv[1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* seg, float* out, float* lse, int n_windows,
                   int heads, int kk, float scale, cudaStream_t stream) {
  constexpr int QROWS = WARPS * 16 * m_tiles(D);
  const long long blocks =
      (long long)n_windows * heads * ((kk + QROWS - 1) / QROWS);
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  const size_t smem = Smem<T, D>::bytes(kk / TILE);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  window_attention_kernel<T, D><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, out, lse, heads, kk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v,
                       const int32_t* seg, float* out, float* lse,
                       int n_windows, int heads, int kk, int d, float scale,
                       cudaStream_t s) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, seg, out, lse, n_windows, heads, kk,
                          scale, s);
    case 16:
      return launch<T, 16>(q, k, v, seg, out, lse, n_windows, heads, kk,
                           scale, s);
    case 32:
      return launch<T, 32>(q, k, v, seg, out, lse, n_windows, heads, kk,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, seg, out, lse, n_windows, heads, kk,
                           scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the CUDA error code (0 = ok).
// q, k, v are (n_windows, heads, kk, d), f32 or (inputs_bf16) bf16, and seg
// (n_windows, kk) int32, each 16-byte aligned; out is (n_windows, heads,
// kk, d) f32; lse is null or (n_windows, heads, kk) f32. d must be 8, 16,
// 32 or 64 and kk a positive multiple of 64.
int window_attention_launch(const void* q, const void* k, const void* v,
                            const void* seg, int inputs_bf16, void* out,
                            void* lse, int n_windows, int heads, int kk,
                            int d, float scale, void* stream) {
  if (n_windows < 0 || heads < 1 || kk < TILE || kk % TILE != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_windows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sg = static_cast<const int32_t*>(seg);
  auto* o = static_cast<float*>(out);
  auto* l = static_cast<float*>(lse);
  const cudaError_t err =
      inputs_bf16
          ? launch_dim<__nv_bfloat16>(q, k, v, sg, o, l, n_windows, heads, kk,
                                      d, scale, s)
          : launch_dim<float>(q, k, v, sg, o, l, n_windows, heads, kk, d,
                              scale, s);
  return (int)err;
}

}  // extern "C"
