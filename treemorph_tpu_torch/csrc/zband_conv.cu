// Z-packed band submanifold conv forward for Hopper (sm_90a).
//
// Replaces treemorph_tpu/ops/bandconv.py::_zband_kernel (the Pallas TPU
// kernel behind _zband_conv_padded). It computes that kernel's function, not
// its mechanism: for every 128-row output tile t and row i,
//
//   out[t*128 + i] = sum_g  zq[a] @ W2[g],   a = anchors[t, g, i]
//
// over the G = ksize^2 (dx, dy) groups whose anchor (the group's dz = 0
// rulebook entry) is found (a < m) and lies in the window
// [8 * starts[g, t], + win). Row a of zq holds the features of a's ksize
// z-neighbors side by side (ksize * Cin values, dz = -r..r), so one row and
// one (ksize * Cin, Cout) filter carry the group's ksize offsets. A missing
// or out-of-window anchor adds nothing here: the caller's residual repair
// owns those entries, so reading every found anchor would count them twice.
// The TPU kernel selects the anchor row out of a DMA'd window with a one-hot
// MXU product (and splits f32 features into bf16 hi/lo parts for it); a GPU
// thread block reads the row itself, so neither is carried over. f32 mode
// reads f32 rows, bf16 mode bf16 rows; both multiply f32 weights in f32.
//
// What bounds it on an H100: per covered anchor the kernel does
// ksize * Cin * Cout FMAs and reads one ksize * Cin row, so a covered row
// sits above the card's ~20 FLOP/byte fp32 ridge: bound by the FP32 FMA rate
// and the shared-memory loads that feed it. A level whose rows are mostly
// padding or uncovered (the plot's level 0: 58k voxels in 271k rows) is
// bound by reading the packed rows and writing the output instead.
//
// The design: one block per output tile (and 64-column slice of Cout); per
// group the 128 anchors go to shared memory, then in 32-channel chunks the
// block gathers the covered anchors' packed rows (one warp reads 32
// consecutive channels of a row) and the group filter's matching 32 rows;
// each thread keeps 16 f32 accumulators of one output row in registers.
// Rows are padded to 33 floats so a warp's rows fall on different banks; a
// warp reads one filter row by broadcast. Groups no row of the tile covers
// are skipped. Shared memory is ~25 KB whatever the widths. wgmma, TMA and
// window reuse across tiles are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;        // output rows per block
constexpr int ZALIGN = 8;        // window anchors are in units of 8 rows
constexpr int CHUNK = 32;        // packed channels staged per pass
constexpr int PITCH = CHUNK + 1; // staged row pitch in floats (bank padding)
constexpr int COLS = 16;         // output columns per thread
constexpr int MAX_COL_GROUPS = 4;  // column groups per block (64 columns)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(TILE * MAX_COL_GROUPS)
zband_conv_kernel(const int32_t* __restrict__ anchors,  // (n_tiles, G, 128)
                  const int32_t* __restrict__ starts,   // (G, n_tiles)
                  const T* __restrict__ zq,             // (Mp, e)
                  const float* __restrict__ w2,         // (G, e, cout)
                  float* __restrict__ out,              // (Mp, cout)
                  int n_tiles, int groups, int e, int cout, int m, int win,
                  int col_groups) {
  extern __shared__ __align__(16) float smem[];
  const int block_cols = col_groups * COLS;
  float* rows_s = smem;                       // [TILE][PITCH]
  float* w_s = smem + TILE * PITCH;           // [CHUNK][block_cols]
  int* anc_s = reinterpret_cast<int*>(w_s + CHUNK * block_cols);  // [TILE]

  const int t = blockIdx.x;
  const int col0 = blockIdx.y * block_cols;
  const int row = threadIdx.x % TILE;
  const int my_col = (threadIdx.x / TILE) * COLS;

  float acc[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) acc[j] = 0.f;

  for (int g = 0; g < groups; ++g) {
    const int base = starts[g * n_tiles + t] * ZALIGN;
    const int a = anchors[((size_t)t * groups + g) * TILE + row];
    const int local = a - base;
    const bool ok = a < m && local >= 0 && local < win;
    // anc_s is read only while staging, which the previous group finished
    // before its last barrier
    if (threadIdx.x < TILE) anc_s[row] = ok ? a : -1;
    // a group no row of the tile covers stages nothing
    if (!__syncthreads_or(ok)) continue;
    for (int c0 = 0; c0 < e; c0 += CHUNK) {
      const int cw = min(CHUNK, e - c0);
      __syncthreads();  // previous pass done with the staged operands
      for (int idx = threadIdx.x; idx < TILE * cw; idx += blockDim.x) {
        const int r = idx / cw;
        const int c = idx - r * cw;
        const int src = anc_s[r];
        rows_s[r * PITCH + c] =
            src >= 0 ? to_f32(zq[(size_t)src * e + c0 + c]) : 0.f;
      }
      for (int idx = threadIdx.x; idx < cw * block_cols; idx += blockDim.x) {
        const int j = idx % block_cols;
        const int c = idx / block_cols;
        const int col = col0 + j;
        w_s[c * block_cols + j] =
            col < cout ? w2[((size_t)g * e + c0 + c) * cout + col] : 0.f;
      }
      __syncthreads();
      if (!ok) continue;
      const float* fr = rows_s + row * PITCH;
      const float* wr = w_s + my_col;
      for (int c = 0; c < cw; ++c) {
        const float f = fr[c];
        const float4* w4 = reinterpret_cast<const float4*>(wr + c * block_cols);
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

  float* orow = out + (size_t)(t * TILE + row) * cout;
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int col = col0 + my_col + j;
    if (col < cout) orow[col] = acc[j];
  }
}

template <typename T>
cudaError_t launch(const int32_t* anchors, const int32_t* starts,
                   const void* zq, const float* w2, float* out, int n_tiles,
                   int groups, int e, int cout, int m, int win,
                   cudaStream_t stream) {
  const int col_groups = min((cout + COLS - 1) / COLS, MAX_COL_GROUPS);
  const int block_cols = col_groups * COLS;
  const dim3 grid(n_tiles, (cout + block_cols - 1) / block_cols);
  const dim3 block(TILE * col_groups);
  const size_t smem =
      ((size_t)TILE * PITCH + (size_t)CHUNK * block_cols) * sizeof(float) +
      TILE * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      zband_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  zband_conv_kernel<T><<<grid, block, smem, stream>>>(
      anchors, starts, static_cast<const T*>(zq), w2, out, n_tiles, groups,
      e, cout, m, win, col_groups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the CUDA error code (0 = ok).
// Takes G = 9 or 25 groups; `win` must be a multiple of 8. Anchors must be
// rows of zq (< n_tiles * 128) or >= m, which build_zband_plan guarantees.
int zband_conv_launch(const void* anchors, const void* starts, const void* zq,
                      int zq_bf16, const void* w2, void* out, int n_tiles,
                      int groups, int e, int cout, int m, int win,
                      void* stream) {
  if ((groups != 9 && groups != 25) || e < 1 || cout < 1 || win < 1 ||
      win % ZALIGN != 0 || m > n_tiles * TILE) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* an = static_cast<const int32_t*>(anchors);
  const auto* st = static_cast<const int32_t*>(starts);
  const auto* w = static_cast<const float*>(w2);
  auto* o = static_cast<float*>(out);
  const cudaError_t err =
      zq_bf16 ? launch<__nv_bfloat16>(an, st, zq, w, o, n_tiles, groups, e,
                                      cout, m, win, s)
              : launch<float>(an, st, zq, w, o, n_tiles, groups, e, cout, m,
                              win, s);
  return (int)err;
}

}  // extern "C"
