// Band submanifold conv backward, weight gradient, for Hopper (sm_90a).
//
// Replaces treemorph_tpu/ops/bandconv.py::_band_bwd_kernel (the Pallas TPU
// kernel behind _band_bwd_padded) together with the forward kernel of
// band_conv.cu. The TPU kernel yields both cotangents from one one-hot pass;
// here the wrapper (ops/bandconv.py::band_conv_bwd_padded) gets d_feats from
// the forward kernel run on (grad, w_bwd), which is the same banded function
// over the same plan, and this kernel computes the weight gradient: for every
// 128-row tile t, row i and offset k whose rulebook entry e = rb[t, k, i] is
// found (e < m) and lies in the window [64 * starts[g(k), t], + win) of the
// entry's (dx, dy) group g(k) = k / 3,
//
//   dw[26 - k] += feats[t*128 + i] (outer) grad[e]
//
// By the rulebook's antisymmetry (rb[i, k] == r  <=>  rb[r, 26 - k] == i)
// this is the forward entry (e, 26 - k) contribution to dW, counted once
// from the side of the row that owns it, as build_band_plan counts entries;
// the found entries outside their window are added by the caller's residual
// repair. Products of bf16 (or f32) values are summed in f32.
//
// What bounds it on an H100: per in-window entry it does Cin * Cout FMAs
// (f32, no tensor cores) and reads a share of the gradient windows, so at
// TreeLearn's widths (Cin, Cout 32..128) it is bound by operations. Design:
// block (x, g, z) owns group g's three filters for a 32 x 32 (Cin, Cout)
// slice z and walks a contiguous run of tiles x. For each tile it stages the
// group's gradient window (win x 32 floats), the tile's own 128 feature rows
// (128 x 32 floats) and the rows' in-window indices in shared memory; each of
// the 256 threads keeps 3 x 4 f32 accumulators (one input channel, four
// output channels, three dz offsets) in registers. Each tile's rows are
// summed on their own and then added to the block's running sums with Kahan
// compensation: a block's sums run over thousands of entries whose terms
// largely cancel (a BatchNorm's backward leaves gradients of zero mean), and
// one sequential f32 chain over them would lose far more of the result than
// a blocked matmul's sums do. A warp shares one row and four output columns,
// so its window reads are broadcasts. Tiles whose rows reach nothing in the
// group stage nothing. Each block writes its own partial sums and the
// wrapper adds the partials up (no float atomics, so runs repeat bit for
// bit). wgmma, TMA and fusing the d_feats pass are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;   // rows per tile
constexpr int ALIGN = 64;   // window anchors are in units of 64 rows
constexpr int KSIZE = 3;    // kernel edge; K = 27 offsets, dz fastest
constexpr int K = 27;
constexpr int CI = 32;      // input channels per block
constexpr int CO = 32;      // output channels per block
constexpr int COLS = 4;     // output channels per thread
constexpr int THREADS = CI * CO / COLS;  // 256

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// sum += x with Kahan compensation: comp carries the low-order part the
// last addition lost (nvcc reassociates no float ops without fast-math)
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
band_conv_bwd_kernel(const int32_t* __restrict__ rb_tiles,  // (n_tiles, 27, 128)
                     const int32_t* __restrict__ starts,    // (9, n_tiles)
                     const T* __restrict__ grad,            // (Mp, cout)
                     const T* __restrict__ feats,           // (Mp, cin)
                     float* __restrict__ partial,  // (gridDim.x, 27, cin, cout)
                     int n_tiles, int tiles_per_block, int cin, int cout,
                     int m, int win) {
  extern __shared__ __align__(16) float smem[];
  float* g_s = smem;                   // [win][CO] gradient window
  float* f_s = smem + win * CO;        // [TILE][CI] the tile's feature rows
  int* loc_s = reinterpret_cast<int*>(f_s + TILE * CI);  // [KSIZE][TILE]

  const int g = blockIdx.y;
  const int n_co = (cout + CO - 1) / CO;
  const int ci0 = (blockIdx.z / n_co) * CI;
  const int co0 = (blockIdx.z % n_co) * CO;
  const int ciw = min(CI, cin - ci0);
  const int cow = min(CO, cout - co0);
  const int ci = threadIdx.x % CI;
  const int cq = (threadIdx.x / CI) * COLS;  // uniform within a warp

  float acc[KSIZE][COLS], comp[KSIZE][COLS];  // running sums, compensation
#pragma unroll
  for (int dz = 0; dz < KSIZE; ++dz) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[dz][j] = comp[dz][j] = 0.f;
  }

  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);
  for (int t = t_begin; t < t_end; ++t) {
    const int base = starts[g * n_tiles + t] * ALIGN;
    bool any = false;
    if (threadIdx.x < TILE) {
#pragma unroll
      for (int dz = 0; dz < KSIZE; ++dz) {
        const int idx =
            rb_tiles[((size_t)t * K + g * KSIZE + dz) * TILE + threadIdx.x];
        const int local = idx - base;
        const bool ok = idx < m && local >= 0 && local < win;
        loc_s[dz * TILE + threadIdx.x] = ok ? local : -1;
        any |= ok;
      }
    }
    // barrier: loc_s is written; a tile no row of which reaches the group
    // stages nothing
    if (!__syncthreads_or(any)) continue;
    for (int e = threadIdx.x; e < win * CO; e += THREADS) {
      const int r = e / CO;
      const int c = e - r * CO;
      g_s[e] = c < cow ? to_f32(grad[(size_t)(base + r) * cout + co0 + c])
                       : 0.f;
    }
    for (int e = threadIdx.x; e < TILE * CI; e += THREADS) {
      const int r = e / CI;
      const int c = e - r * CI;
      f_s[e] = c < ciw
                   ? to_f32(feats[(size_t)(t * TILE + r) * cin + ci0 + c])
                   : 0.f;
    }
    __syncthreads();
    float part[KSIZE][COLS];  // this tile's sums
#pragma unroll
    for (int dz = 0; dz < KSIZE; ++dz) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) part[dz][j] = 0.f;
    }
    for (int r = 0; r < TILE; ++r) {
      const float f = f_s[r * CI + ci];
#pragma unroll
      for (int dz = 0; dz < KSIZE; ++dz) {
        const int l = loc_s[dz * TILE + r];  // uniform within the block
        if (l < 0) continue;
        const float4 gv = *reinterpret_cast<const float4*>(g_s + l * CO + cq);
        part[dz][0] = fmaf(f, gv.x, part[dz][0]);
        part[dz][1] = fmaf(f, gv.y, part[dz][1]);
        part[dz][2] = fmaf(f, gv.z, part[dz][2]);
        part[dz][3] = fmaf(f, gv.w, part[dz][3]);
      }
    }
#pragma unroll
    for (int dz = 0; dz < KSIZE; ++dz) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        kahan_add(acc[dz][j], comp[dz][j], part[dz][j]);
      }
    }
    __syncthreads();  // staged operands and loc_s done before the next tile
  }

  if (ci >= ciw) return;
#pragma unroll
  for (int dz = 0; dz < KSIZE; ++dz) {
    const int kk = K - 1 - (g * KSIZE + dz);
    float* row = partial + (((size_t)blockIdx.x * K + kk) * cin + ci0 + ci) *
                               cout + co0 + cq;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (cq + j < cow) row[j] = acc[dz][j] - comp[dz][j];
    }
  }
}

template <typename T>
cudaError_t launch(const int32_t* rb_tiles, const int32_t* starts,
                   const void* grad, const void* feats, float* partial,
                   int n_blocks, int n_tiles, int tiles_per_block, int cin,
                   int cout, int m, int win, cudaStream_t stream) {
  const int slices = ((cin + CI - 1) / CI) * ((cout + CO - 1) / CO);
  const dim3 grid(n_blocks, K / KSIZE, slices);
  const size_t smem =
      ((size_t)win * CO + (size_t)TILE * CI) * sizeof(float) +
      (size_t)KSIZE * TILE * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      band_conv_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  band_conv_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      rb_tiles, starts, static_cast<const T*>(grad),
      static_cast<const T*>(feats), partial, n_tiles, tiles_per_block, cin,
      cout, m, win);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the CUDA error code (0 = ok).
// Block x covers tiles [x * tiles_per_block, + tiles_per_block) and writes
// partial[x] (27, cin, cout); n_blocks * tiles_per_block must cover n_tiles.
// Takes K = 27 only; `win` must be a multiple of 64 and every window
// [64 * starts, + win) must lie inside the n_tiles * 128 rows, which
// build_band_plan guarantees.
int band_conv_bwd_launch(const void* rb_tiles, const void* starts,
                         const void* grad, const void* feats, int bf16,
                         void* partial, int n_blocks, int n_tiles,
                         int tiles_per_block, int k, int cin, int cout, int m,
                         int win, void* stream) {
  if (k != K || cin < 1 || cout < 1 || win < 1 || win % ALIGN != 0 ||
      n_blocks < 1 || tiles_per_block < 1 ||
      (long long)n_blocks * tiles_per_block < n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rb = static_cast<const int32_t*>(rb_tiles);
  const auto* st = static_cast<const int32_t*>(starts);
  auto* p = static_cast<float*>(partial);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(rb, st, grad, feats, p, n_blocks, n_tiles,
                                   tiles_per_block, cin, cout, m, win, s)
           : launch<float>(rb, st, grad, feats, p, n_blocks, n_tiles,
                           tiles_per_block, cin, cout, m, win, s);
  return (int)err;
}

}  // extern "C"
