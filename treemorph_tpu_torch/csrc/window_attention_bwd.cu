// Masked window attention backward for Hopper (sm_90a).
//
// Replaces treemorph_tpu/ops/attention.py::_window_attention_bwd_kernel (the
// Pallas TPU kernel behind _bwd_call, the custom VJP of window_attention).
// For every window w and head h of q, k, v (W, H, K, D) and the output
// cotangent g (W, H, K, D), with P the forward's probabilities over the
// allowed keys (seg[w, i] == seg[w, j] >= 0):
//
//   dv = P^T g,   dp = g V^T,   ds = P * (dp - rowsum(dp * P)),
//   dq = ds K * scale,          dk = ds^T (q * scale).
//
// The TPU kernel holds a window's whole (K, K) probability tile in VMEM
// (4 MB at K = 1024 in f32), 18x the 227 KB of shared memory a block may
// use. Here no (K, K) tile exists anywhere; two grids stream tiles of TILE
// rows through shared memory instead:
//
// 1. row_stats_dq_kernel: one block of TILE threads per (window, head, TILE
//    query rows), one query row per thread. A first pass over the key tiles
//    is the forward's online softmax: the row's max score m, its sum of
//    exponentials l and its output o (f32 registers). Then
//    delta = rowsum(dp * P) = g . o / l, and m, 1 / max(l, 1e-20) and delta
//    are written out for the second grid. A second pass over the key tiles
//    recomputes P = exp(s - m) / l per allowed key and sums
//    dq += P (g . v - delta) k in registers.
// 2. dk_dv_kernel: one block per (window, head, TILE key rows), one key row
//    per thread holding its k, v and its dk, dv sums in f32 registers; the
//    query tiles (q * scale, g, the row statistics, segment ids) stream
//    through shared memory.
//
// Each output row is written by exactly one thread, so there are no float
// atomics and runs repeat bit for bit. A row with no allowed key (padding
// rows, seg -1) has P = 0 and gets zero gradients, never NaN; blocks whose
// rows are all padding write zeros and stop, and tiles outside the block's
// segment range are skipped, as in the forward kernel.
//
// What bounds it on an H100: per allowed (query, key) pair and head it does
// 9 D FMAs (pass 1: 2 D; dq: 3 D; dk and dv: 4 D), against 5 D the
// gradient needs, and three exps, on inputs read a few times per tile: at
// D = 16 and K = 1024 it is bound by FP32 FMA issue (67 TFLOP/s) and the
// shared-memory loads that feed it. Tensor cores (mma / wgmma), TMA, saving
// the forward's log-sum-exp and several rows per thread are left for a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;   // rows per block = rows staged per pass
constexpr int CHUNK = 16;  // keys scored before one rescale (pass 1)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int D>
__device__ __forceinline__ float dot_s(const float* r, const float (&a)[D]) {
  // r: a row of D floats in shared memory, 16-byte aligned
  const float4* r4 = reinterpret_cast<const float4*>(r);
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = r4[d4];
    acc = fmaf(a[4 * d4], x.x, acc);
    acc = fmaf(a[4 * d4 + 1], x.y, acc);
    acc = fmaf(a[4 * d4 + 2], x.z, acc);
    acc = fmaf(a[4 * d4 + 3], x.w, acc);
  }
  return acc;
}

template <int D>
__device__ __forceinline__ void axpy_s(float (&acc)[D], float p,
                                       const float* r) {
  const float4* r4 = reinterpret_cast<const float4*>(r);
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = r4[d4];
    acc[4 * d4] = fmaf(p, x.x, acc[4 * d4]);
    acc[4 * d4 + 1] = fmaf(p, x.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(p, x.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(p, x.w, acc[4 * d4 + 3]);
  }
}

// The segment range [lo, hi] of a block's rows (hi < 0: all padding).
__device__ __forceinline__ void segment_range(int my_seg, int* s_lo, int* s_hi,
                                              int* lo, int* hi) {
  if (threadIdx.x == 0) {
    *s_lo = INT32_MAX;
    *s_hi = -1;
  }
  __syncthreads();
  if (my_seg >= 0) {
    atomicMin(s_lo, my_seg);
    atomicMax(s_hi, my_seg);
  }
  __syncthreads();
  *lo = *s_lo;
  *hi = *s_hi;
}

template <typename T, int D>
__global__ void __launch_bounds__(TILE)
row_stats_dq_kernel(const T* __restrict__ q,          // (W, H, K, D)
                    const T* __restrict__ k,          // (W, H, K, D)
                    const T* __restrict__ v,          // (W, H, K, D)
                    const int32_t* __restrict__ seg,  // (W, K)
                    const float* __restrict__ g,      // (W, H, K, D)
                    float* __restrict__ dq,           // (W, H, K, D)
                    float4* __restrict__ stats,       // (W, H, K)
                    int heads, int kk, float scale) {
  __shared__ __align__(16) float k_s[TILE * D];
  __shared__ __align__(16) float v_s[TILE * D];
  __shared__ int seg_s[TILE];
  __shared__ int s_lo, s_hi;

  const int n_tiles = kk / TILE;
  const int tile = blockIdx.x % n_tiles;
  const int wh = blockIdx.x / n_tiles;  // window * heads + head
  const int w = wh / heads;
  const int row = tile * TILE + threadIdx.x;
  const size_t base = (size_t)wh * kk * D;
  const int32_t* seg_w = seg + (size_t)w * kk;
  const int my_seg = seg_w[row];
  float* dq_row = dq + base + (size_t)row * D;
  float4* stats_row = stats + (size_t)wh * kk + row;

  int lo, hi;
  segment_range(my_seg, &s_lo, &s_hi, &lo, &hi);
  if (hi < 0) {  // every query row is padding
#pragma unroll
    for (int d = 0; d < D; ++d) dq_row[d] = 0.f;
    *stats_row = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  float qf[D], gf[D], acc[D];
  const T* q_row = q + base + (size_t)row * D;
  const float* g_row = g + base + (size_t)row * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qf[d] = to_f32(q_row[d]) * scale;
    gf[d] = g_row[d];
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // pass 1: the forward's online softmax, for m, l and o = acc / l
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the previous tile is consumed
    const size_t tile_base = base + (size_t)t * TILE * D;
    for (int idx = threadIdx.x; idx < TILE * D; idx += TILE) {
      k_s[idx] = to_f32(k[tile_base + idx]);
      v_s[idx] = to_f32(v[tile_base + idx]);
    }
    const int key_seg = seg_w[t * TILE + threadIdx.x];
    seg_s[threadIdx.x] = key_seg;
    if (!__syncthreads_or(key_seg >= lo && key_seg <= hi)) continue;
    if (my_seg < 0) continue;
    for (int c = 0; c < TILE; c += CHUNK) {
      float s[CHUNK];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        s[j] = -INFINITY;
        if (seg_s[c + j] == my_seg) {
          s[j] = dot_s<D>(k_s + (c + j) * D, qf);
          cmax = fmaxf(cmax, s[j]);
        }
      }
      if (cmax == -INFINITY) continue;  // no allowed key in the chunk
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);  // 0 while m is -inf
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        if (s[j] == -INFINITY) continue;
        const float p = expf(s[j] - m_new);
        l += p;
        axpy_s<D>(acc, p, v_s + (c + j) * D);
      }
      m = m_new;
    }
  }
  // a row with no allowed key: l = 0, acc = 0, so delta = 0 and P = 0
  const float inv_l = 1.f / fmaxf(l, 1e-20f);
  float delta = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) delta = fmaf(gf[d], acc[d], delta);
  delta *= inv_l;
  if (m == -INFINITY) m = 0.f;
  *stats_row = make_float4(m, inv_l, delta, 0.f);

  // pass 2: dq = sum_j P_ij (g_i . v_j - delta_i) k_j, times scale
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    const size_t tile_base = base + (size_t)t * TILE * D;
    for (int idx = threadIdx.x; idx < TILE * D; idx += TILE) {
      k_s[idx] = to_f32(k[tile_base + idx]);
      v_s[idx] = to_f32(v[tile_base + idx]);
    }
    const int key_seg = seg_w[t * TILE + threadIdx.x];
    seg_s[threadIdx.x] = key_seg;
    if (!__syncthreads_or(key_seg >= lo && key_seg <= hi)) continue;
    if (my_seg < 0) continue;
    for (int j = 0; j < TILE; ++j) {
      if (seg_s[j] != my_seg) continue;
      const float p = expf(dot_s<D>(k_s + j * D, qf) - m) * inv_l;
      const float ds = p * (dot_s<D>(v_s + j * D, gf) - delta);
      axpy_s<D>(acc, ds, k_s + j * D);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dq_row[d] = acc[d] * scale;
}

template <typename T, int D>
__global__ void __launch_bounds__(TILE)
dk_dv_kernel(const T* __restrict__ q,             // (W, H, K, D)
             const T* __restrict__ k,             // (W, H, K, D)
             const T* __restrict__ v,             // (W, H, K, D)
             const int32_t* __restrict__ seg,     // (W, K)
             const float* __restrict__ g,         // (W, H, K, D)
             const float4* __restrict__ stats,    // (W, H, K)
             float* __restrict__ dk,              // (W, H, K, D)
             float* __restrict__ dv,              // (W, H, K, D)
             int heads, int kk, float scale) {
  __shared__ __align__(16) float q_s[TILE * D];
  __shared__ __align__(16) float g_s[TILE * D];
  __shared__ float4 st_s[TILE];
  __shared__ int seg_s[TILE];
  __shared__ int s_lo, s_hi;

  const int n_tiles = kk / TILE;
  const int tile = blockIdx.x % n_tiles;
  const int wh = blockIdx.x / n_tiles;
  const int w = wh / heads;
  const int row = tile * TILE + threadIdx.x;  // this thread's key row
  const size_t base = (size_t)wh * kk * D;
  const int32_t* seg_w = seg + (size_t)w * kk;
  const int my_seg = seg_w[row];
  float* dk_row = dk + base + (size_t)row * D;
  float* dv_row = dv + base + (size_t)row * D;

  int lo, hi;
  segment_range(my_seg, &s_lo, &s_hi, &lo, &hi);
  if (hi < 0) {  // every key row is padding
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk_row[d] = 0.f;
      dv_row[d] = 0.f;
    }
    return;
  }

  float kf[D], vf[D], dk_acc[D], dv_acc[D];
  const T* k_row = k + base + (size_t)row * D;
  const T* v_row = v + base + (size_t)row * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kf[d] = to_f32(k_row[d]);
    vf[d] = to_f32(v_row[d]);
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the previous tile is consumed
    const size_t tile_base = base + (size_t)t * TILE * D;
    for (int idx = threadIdx.x; idx < TILE * D; idx += TILE) {
      q_s[idx] = to_f32(q[tile_base + idx]) * scale;
      g_s[idx] = g[tile_base + idx];
    }
    st_s[threadIdx.x] = stats[(size_t)wh * kk + t * TILE + threadIdx.x];
    const int query_seg = seg_w[t * TILE + threadIdx.x];
    seg_s[threadIdx.x] = query_seg;
    if (!__syncthreads_or(query_seg >= lo && query_seg <= hi)) continue;
    if (my_seg < 0) continue;
    for (int i = 0; i < TILE; ++i) {
      if (seg_s[i] != my_seg) continue;
      const float4 st = st_s[i];  // m, 1 / l, delta
      const float p = expf(dot_s<D>(q_s + i * D, kf) - st.x) * st.y;
      const float ds = p * (dot_s<D>(g_s + i * D, vf) - st.z);
      axpy_s<D>(dv_acc, p, g_s + i * D);
      axpy_s<D>(dk_acc, ds, q_s + i * D);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk_row[d] = dk_acc[d];
    dv_row[d] = dv_acc[d];
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* seg, const float* g, float* dq, float* dk,
                   float* dv, float4* stats, int n_windows, int heads, int kk,
                   float scale, cudaStream_t stream) {
  const long long blocks = (long long)n_windows * heads * (kk / TILE);
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  row_stats_dq_kernel<T, D><<<(unsigned)blocks, TILE, 0, stream>>>(
      qt, kt, vt, seg, g, dq, stats, heads, kk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dk_dv_kernel<T, D><<<(unsigned)blocks, TILE, 0, stream>>>(
      qt, kt, vt, seg, g, stats, dk, dv, heads, kk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v,
                       const int32_t* seg, const float* g, float* dq,
                       float* dk, float* dv, float4* stats, int n_windows,
                       int heads, int kk, int d, float scale,
                       cudaStream_t s) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, seg, g, dq, dk, dv, stats, n_windows,
                          heads, kk, scale, s);
    case 16:
      return launch<T, 16>(q, k, v, seg, g, dq, dk, dv, stats, n_windows,
                           heads, kk, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, seg, g, dq, dk, dv, stats, n_windows,
                           heads, kk, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, seg, g, dq, dk, dv, stats, n_windows,
                           heads, kk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; returns the CUDA error code (0 = ok).
// q, k, v are (n_windows, heads, kk, d), f32 or (inputs_bf16) bf16; seg is
// (n_windows, kk) int32; g, dq, dk, dv are (n_windows, heads, kk, d) f32;
// stats is (n_windows, heads, kk, 4) f32 scratch. d must be 8, 16, 32 or 64
// and kk a positive multiple of 64.
int window_attention_bwd_launch(const void* q, const void* k, const void* v,
                                const void* seg, const void* g,
                                int inputs_bf16, void* dq, void* dk, void* dv,
                                void* stats, int n_windows, int heads, int kk,
                                int d, float scale, void* stream) {
  if (n_windows < 0 || heads < 1 || kk < TILE || kk % TILE != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_windows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sg = static_cast<const int32_t*>(seg);
  const auto* gf = static_cast<const float*>(g);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto* st = static_cast<float4*>(stats);
  const cudaError_t err =
      inputs_bf16
          ? launch_dim<__nv_bfloat16>(q, k, v, sg, gf, dqf, dkf, dvf, st,
                                      n_windows, heads, kk, d, scale, s)
          : launch_dim<float>(q, k, v, sg, gf, dqf, dkf, dvf, st, n_windows,
                              heads, kk, d, scale, s);
  return (int)err;
}

}  // extern "C"
