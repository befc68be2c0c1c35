// Masked window attention forward for Hopper (sm_90a).
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
// scores (0 for a row with no allowed key); inference passes none.
//
// The TPU kernel holds a window's whole (K, K) score tile in VMEM (4 MB at
// K = 1024), 18x the 227 KB of shared memory a block may use. Here one block
// of TILE threads owns TILE query rows of one (window, head), one row per
// thread: the row's scaled query, its running max, running sum and D output
// accumulators live in registers (f32), and the keys, values and key segment
// ids pass through shared memory one tile of TILE keys at a time, staged as
// f32 (bf16 inputs are widened on load, as the TPU kernel's astype does).
// Each tile is read in chunks of CHUNK keys: the chunk's scores, one
// rescale of the accumulators by exp(m_old - m_new), then the weighted
// values (an online softmax; no score tile reaches device memory). A block
// whose query rows are all padding writes zeros and stops; a key tile with
// no key in the query tile's segment range is skipped.
//
// What bounds it on an H100: per allowed (query, key) pair it does 2 * D
// FMAs (score and value) and one exp, against 3 * D inputs read once per
// query row, so at D = 16 and K = 1024 it sits far above the card's fp32
// ridge: it is bound by operations (FP32 FMA issue at 67 TFLOP/s, and the
// shared-memory loads that feed them; every warp reads the same key row,
// a broadcast). Tensor cores (mma / wgmma on bf16), TMA staging and several
// query rows per thread are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;   // query rows per block = keys staged per pass
constexpr int CHUNK = 16;  // keys scored before one rescale

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(TILE)
window_attention_kernel(const T* __restrict__ q,          // (W, H, K, D)
                        const T* __restrict__ k,          // (W, H, K, D)
                        const T* __restrict__ v,          // (W, H, K, D)
                        const int32_t* __restrict__ seg,  // (W, K)
                        float* __restrict__ out,          // (W, H, K, D)
                        float* __restrict__ lse,          // (W, H, K) or null
                        int heads, int kk, float scale) {
  __shared__ __align__(16) float k_s[TILE * D];
  __shared__ __align__(16) float v_s[TILE * D];
  __shared__ int seg_s[TILE];
  __shared__ int q_lo, q_hi;

  const int n_tiles = kk / TILE;
  const int tile = blockIdx.x % n_tiles;
  const int wh = blockIdx.x / n_tiles;  // window * heads + head
  const int w = wh / heads;
  const int row = tile * TILE + threadIdx.x;
  const size_t base = (size_t)wh * kk * D;
  const int32_t* seg_w = seg + (size_t)w * kk;
  const int my_seg = seg_w[row];
  float* out_row = out + base + (size_t)row * D;

  // segment range of this block's query rows
  if (threadIdx.x == 0) {
    q_lo = INT32_MAX;
    q_hi = -1;
  }
  __syncthreads();
  if (my_seg >= 0) {
    atomicMin(&q_lo, my_seg);
    atomicMax(&q_hi, my_seg);
  }
  __syncthreads();
  const int lo = q_lo, hi = q_hi;
  if (hi < 0) {  // every query row is padding
#pragma unroll
    for (int d = 0; d < D; ++d) out_row[d] = 0.f;
    if (lse) lse[(size_t)wh * kk + row] = 0.f;
    return;
  }

  float qf[D], acc[D];
  const T* q_row = q + base + (size_t)row * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qf[d] = to_f32(q_row[d]) * scale;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

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
          const float4* kr = reinterpret_cast<const float4*>(k_s + (c + j) * D);
          float dot = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 kv = kr[d4];
            dot = fmaf(qf[4 * d4], kv.x, dot);
            dot = fmaf(qf[4 * d4 + 1], kv.y, dot);
            dot = fmaf(qf[4 * d4 + 2], kv.z, dot);
            dot = fmaf(qf[4 * d4 + 3], kv.w, dot);
          }
          s[j] = dot;
          cmax = fmaxf(cmax, dot);
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
        // ptxas spills 12 bytes here at D = 16 and 32; a select in place
        // of the branch spills none but made the plot's forward 5 % slower
        // on the card (24.2 -> 25.4 ms), so the branch stays
        if (s[j] == -INFINITY) continue;
        const float p = expf(s[j] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(v_s + (c + j) * D);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }
  // no allowed key: acc = 0, l = 0, and 0 / 1e-20 = 0
  const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
  for (int d = 0; d < D; ++d) out_row[d] = acc[d] * inv;
  if (lse) lse[(size_t)wh * kk + row] = l > 0.f ? m + logf(l) : 0.f;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* seg, float* out, float* lse, int n_windows,
                   int heads, int kk, float scale, cudaStream_t stream) {
  const long long blocks = (long long)n_windows * heads * (kk / TILE);
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  window_attention_kernel<T, D><<<(unsigned)blocks, TILE, 0, stream>>>(
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
// q, k, v are (n_windows, heads, kk, d), f32 or (inputs_bf16) bf16; seg is
// (n_windows, kk) int32; out is (n_windows, heads, kk, d) f32; lse is null
// or (n_windows, heads, kk) f32. d must be 8, 16, 32 or 64 and kk a
// positive multiple of 64.
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
