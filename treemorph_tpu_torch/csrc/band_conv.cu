// Band submanifold conv forward for Hopper (sm_90a).
//
// Replaces treemorph_tpu/ops/bandconv.py::_band_kernel (the Pallas TPU
// kernel behind _band_conv_padded). It computes that kernel's function, not
// its mechanism: for every 128-row output tile t and row i,
//
//   out[t*128 + i] = sum_k  feats[rb[t, k, i]] @ W[k]
//
// over the found rulebook entries (rb < m) whose row lies in the window
// [64 * starts[g(k), t], + win) of the entry's (dx, dy) group g(k) = k / 3.
// Found entries outside the window are left out; the caller adds them back
// (_residual_repair). The TPU kernel's one-hot MXU select and its bf16 hi/lo
// split of f32 features are TPU workarounds and are not carried over: each
// block indexes its staged window rows directly, f32 mode reads f32
// features, bf16 mode reads bf16 features, and both accumulate in f32.
//
// What bounds it on an H100: per output row the kernel does 27 * Cin * Cout
// FMAs and reads ~27 * 4 bytes of rulebook plus its share of the feature
// windows, so at TreeLearn's widths (Cin 7..192, Cout 32..96) it sits far
// above the card's ~20 FLOP/byte fp32 ridge without tensor cores: it is
// bound by operations (FP32 FMA issue and the shared-memory loads that feed
// them). The design keeps the operands on chip: one block per output tile,
// each (dx, dy) group's window is staged once in shared memory in 32-channel
// chunks (a whole bf16 window at Cin 192 is 172 KB and an f32 one would
// overflow the 227 KB a block may use) and serves the group's 3 dz offsets;
// the group's three filters sit beside it, and each thread keeps 16 f32
// accumulators of one output row in registers. Window rows are padded to 33
// floats so rows of one warp fall on different banks; a warp reads one
// filter row by broadcast. wgmma, TMA and persistent blocks are left for a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;        // output rows per block
constexpr int ALIGN = 64;        // window anchors are in units of 64 rows
constexpr int KSIZE = 3;         // kernel edge; K = 27 offsets, dz fastest
constexpr int GROUPS = 9;        // (dx, dy) groups
constexpr int K = 27;
constexpr int CHUNK = 32;        // input channels staged per pass
constexpr int PITCH = CHUNK + 1; // window row pitch in floats (bank padding)
constexpr int COLS = 16;         // output columns per thread
constexpr int MAX_COL_GROUPS = 4;  // column groups per block (64 columns)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(TILE * MAX_COL_GROUPS)
band_conv_kernel(const int32_t* __restrict__ rb_tiles,  // (n_tiles, 27, 128)
                 const int32_t* __restrict__ starts,    // (9, n_tiles)
                 const T* __restrict__ feats,           // (Mp, cin)
                 const float* __restrict__ weights,     // (27, cin, cout)
                 float* __restrict__ out,               // (Mp, cout)
                 int n_tiles, int cin, int cout, int m, int win,
                 int col_groups) {
  extern __shared__ __align__(16) float smem[];
  const int block_cols = col_groups * COLS;
  float* win_s = smem;                  // [win][PITCH]
  float* w_s = smem + win * PITCH;      // [KSIZE][CHUNK][block_cols]

  const int t = blockIdx.x;
  const int col0 = blockIdx.y * block_cols;
  const int row = threadIdx.x % TILE;
  const int my_col = (threadIdx.x / TILE) * COLS;

  float acc[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) acc[j] = 0.f;

  for (int g = 0; g < GROUPS; ++g) {
    const int base = starts[g * n_tiles + t] * ALIGN;
    int local[KSIZE];
    bool ok[KSIZE];
#pragma unroll
    for (int dz = 0; dz < KSIZE; ++dz) {
      const int idx =
          rb_tiles[((size_t)t * K + g * KSIZE + dz) * TILE + row];
      local[dz] = idx - base;
      ok[dz] = idx < m && local[dz] >= 0 && local[dz] < win;
    }
    // a group none of the tile's rows reaches (padding tiles, gaps in the
    // surface) stages nothing
    if (!__syncthreads_or(ok[0] || ok[1] || ok[2])) continue;
    for (int c0 = 0; c0 < cin; c0 += CHUNK) {
      const int cw = min(CHUNK, cin - c0);
      __syncthreads();  // previous pass done with the staged operands
      for (int e = threadIdx.x; e < win * cw; e += blockDim.x) {
        const int r = e / cw;
        const int c = e - r * cw;
        win_s[r * PITCH + c] = to_f32(feats[(size_t)(base + r) * cin + c0 + c]);
      }
      for (int e = threadIdx.x; e < KSIZE * cw * block_cols;
           e += blockDim.x) {
        const int j = e % block_cols;
        const int rest = e / block_cols;
        const int c = rest % cw;
        const int dz = rest / cw;
        const int col = col0 + j;
        w_s[(dz * CHUNK + c) * block_cols + j] =
            col < cout
                ? weights[((size_t)(g * KSIZE + dz) * cin + c0 + c) * cout + col]
                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dz = 0; dz < KSIZE; ++dz) {
        if (!ok[dz]) continue;
        const float* fr = win_s + local[dz] * PITCH;
        const float* wr = w_s + dz * CHUNK * block_cols + my_col;
        for (int c = 0; c < cw; ++c) {
          const float f = fr[c];
          const float4* w4 =
              reinterpret_cast<const float4*>(wr + c * block_cols);
#pragma unroll
          for (int j4 = 0; j4 < COLS / 4; ++j4) {
            const float4 w = w4[j4];
            acc[4 * j4 + 0] = fmaf(f, w.x, acc[4 * j4 + 0]);
            acc[4 * j4 + 1] = fmaf(f, w.y, acc[4 * j4 + 1]);
            acc[4 * j4 + 2] = fmaf(f, w.z, acc[4 * j4 + 2]);
            acc[4 * j4 + 3] = fmaf(f, w.w, acc[4 * j4 + 3]);
          }
        }
      }
    }
  }

  float* orow = out + (size_t)(t * TILE + row) * cout;
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int col = col0 + my_col + j;
    if (col < cout) orow[col] = acc[j];
  }
}

template <typename T>
cudaError_t launch(const int32_t* rb_tiles, const int32_t* starts,
                   const void* feats, const float* weights, float* out,
                   int n_tiles, int cin, int cout, int m, int win,
                   cudaStream_t stream) {
  const int col_groups = min((cout + COLS - 1) / COLS, MAX_COL_GROUPS);
  const int block_cols = col_groups * COLS;
  const dim3 grid(n_tiles, (cout + block_cols - 1) / block_cols);
  const dim3 block(TILE * col_groups);
  const size_t smem =
      ((size_t)win * PITCH + (size_t)KSIZE * CHUNK * block_cols) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      band_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  band_conv_kernel<T><<<grid, block, smem, stream>>>(
      rb_tiles, starts, static_cast<const T*>(feats), weights, out, n_tiles,
      cin, cout, m, win, col_groups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the CUDA error code (0 = ok).
// Takes K = 27 only; `win` must be a multiple of 64 and every window
// [64 * starts, + win) must lie inside the n_tiles * 128 feature rows,
// which build_band_plan guarantees.
int band_conv_launch(const void* rb_tiles, const void* starts,
                     const void* feats, int feats_bf16, const void* weights,
                     void* out, int n_tiles, int k, int cin, int cout, int m,
                     int win, void* stream) {
  if (k != K || cin < 1 || cout < 1 || win < 1 || win % ALIGN != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rb = static_cast<const int32_t*>(rb_tiles);
  const auto* st = static_cast<const int32_t*>(starts);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  const cudaError_t err =
      feats_bf16
          ? launch<__nv_bfloat16>(rb, st, feats, w, o, n_tiles, cin, cout, m,
                                  win, s)
          : launch<float>(rb, st, feats, w, o, n_tiles, cin, cout, m, win, s);
  return (int)err;
}

}  // extern "C"
