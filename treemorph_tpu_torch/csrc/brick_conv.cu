// 3^3 conv over halo'd 6^3 bricks for Hopper (sm_90a), both variants.
//
// Replaces treemorph_tpu/ops/brick_conv.py::_conv_kernel (core variant) and
// _full_kernel (full variant), the Pallas TPU kernels behind _conv_call.
// A brick is 216 cells f = x*36 + y*6 + z of Cin floats; for every brick b
// and output cell f,
//
//   out[b, f] = sum_k h[b, (f + D_k) mod 216] @ W[k],  D_k = dx*36 + dy*6 + dz
//
// with (dx, dy, dz) in kernel-offset order (dz fastest). The core variant
// writes the 64 cells x, y, z in [1, 5) as out[b, (x-1)*16 + (y-1)*4 + z-1];
// the full variant writes all 216, using the circular index as the TPU
// kernel's roll does, so it equals that kernel on any input, not only on
// the core-masked cotangents of the backward. The TPU kernel rolls whole
// (bricks, 216, Cin) tiles in VMEM and multiplies each rolled copy on the
// MXU; here a thread computes its own cell's neighbor index instead.
//
// What bounds it on an H100: every output cell takes 27 * Cin * Cout FMAs
// and every brick is read once (216 * Cin floats), so at Cin >= 8 it sits
// far above the card's ~20 FLOP/byte fp32 ridge: bound by the FP32 FMA rate
// and the shared-memory loads that feed it. The design: one block per 2 bricks
// (core: 128 output cells) or per brick (full: 216 cells), and per 64-column
// slice of Cout. In 32-channel chunks the block stages its bricks' 216 cells
// in shared memory (the whole tile at Cin >= 64 would not fit beside the
// weights: 27 * Cin * Cout floats are 442 KB at 64 -> 64), then streams the
// weights one (dx, dy) group of 3 offsets at a time; each thread keeps 16
// f32 accumulators of one output cell in registers. Cell rows are padded to
// 33 floats so the cells of a warp fall on different banks; a warp reads one
// filter row by broadcast. wgmma, TMA and keeping the weights resident
// across bricks (a persistent block) are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CELLS = 216;       // 6^3 halo'd brick
constexpr int CORE = 64;         // 4^3 core
constexpr int GROUPS = 9;        // (dx, dy) groups of 3 dz offsets
constexpr int CHUNK = 32;        // input channels staged per pass
constexpr int PITCH = CHUNK + 1; // staged cell pitch in floats (bank padding)
constexpr int COLS = 16;         // output columns per thread
constexpr int MAX_COL_GROUPS = 4;  // column groups per block (64 columns)

template <bool CORE_ONLY>
struct Variant {
  static constexpr int BRICKS = CORE_ONLY ? 2 : 1;  // bricks per block
  static constexpr int OUT_CELLS = CORE_ONLY ? CORE : CELLS;
  static constexpr int ROWS = BRICKS * OUT_CELLS;   // output cells per block
};

template <bool CORE_ONLY>
__global__ void __launch_bounds__(Variant<CORE_ONLY>::ROWS * MAX_COL_GROUPS)
brick_conv_kernel(const float* __restrict__ h,        // (B, 216, cin)
                  const float* __restrict__ weights,  // (27, cin, cout)
                  float* __restrict__ out,            // (B, 64|216, cout)
                  int n_bricks, int cin, int cout, int col_groups) {
  using V = Variant<CORE_ONLY>;
  extern __shared__ __align__(16) float smem[];
  const int block_cols = col_groups * COLS;
  float* h_s = smem;                                  // [BRICKS*216][PITCH]
  float* w_s = smem + V::BRICKS * CELLS * PITCH;      // [3][CHUNK][block_cols]

  const int b0 = blockIdx.x * V::BRICKS;
  const int col0 = blockIdx.y * block_cols;
  const int row = threadIdx.x % V::ROWS;
  const int my_col = (threadIdx.x / V::ROWS) * COLS;
  const int lb = row / V::OUT_CELLS;    // brick within the block
  const int oc = row % V::OUT_CELLS;    // output cell within the brick
  int f = oc;                           // its flat cell in the halo'd brick
  if (CORE_ONLY) {
    f = ((oc >> 4) + 1) * 36 + (((oc >> 2) & 3) + 1) * 6 + (oc & 3) + 1;
  }
  const bool live = b0 + lb < n_bricks;
  const int staged_cells = min(V::BRICKS, n_bricks - b0) * CELLS;

  float acc[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CHUNK) {
    const int cw = min(CHUNK, cin - c0);
    __syncthreads();  // previous chunk done with the staged cells
    for (int e = threadIdx.x; e < V::BRICKS * CELLS * cw; e += blockDim.x) {
      const int r = e / cw;
      const int c = e - r * cw;
      h_s[r * PITCH + c] =
          r < staged_cells ? h[((size_t)b0 * CELLS + r) * cin + c0 + c] : 0.f;
    }
    for (int g = 0; g < GROUPS; ++g) {
      __syncthreads();  // cells staged; previous group done with w_s
      for (int e = threadIdx.x; e < 3 * cw * block_cols; e += blockDim.x) {
        const int j = e % block_cols;
        const int rest = e / block_cols;
        const int c = rest % cw;
        const int dz = rest / cw;
        const int col = col0 + j;
        w_s[(dz * CHUNK + c) * block_cols + j] =
            col < cout
                ? weights[((size_t)(g * 3 + dz) * cin + c0 + c) * cout + col]
                : 0.f;
      }
      __syncthreads();
      const int dxy = (g / 3 - 1) * 36 + (g % 3 - 1) * 6;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const int src = (f + dxy + dz - 1 + CELLS) % CELLS;
        const float* fr = h_s + (lb * CELLS + src) * PITCH;
        const float* wr = w_s + dz * CHUNK * block_cols + my_col;
        for (int c = 0; c < cw; ++c) {
          const float x = fr[c];
          const float4* w4 =
              reinterpret_cast<const float4*>(wr + c * block_cols);
#pragma unroll
          for (int j4 = 0; j4 < COLS / 4; ++j4) {
            const float4 w = w4[j4];
            acc[4 * j4 + 0] = fmaf(x, w.x, acc[4 * j4 + 0]);
            acc[4 * j4 + 1] = fmaf(x, w.y, acc[4 * j4 + 1]);
            acc[4 * j4 + 2] = fmaf(x, w.z, acc[4 * j4 + 2]);
            acc[4 * j4 + 3] = fmaf(x, w.w, acc[4 * j4 + 3]);
          }
        }
      }
    }
  }

  if (!live) return;
  float* orow =
      out + ((size_t)(b0 + lb) * V::OUT_CELLS + oc) * cout;
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int col = col0 + my_col + j;
    if (col < cout) orow[col] = acc[j];
  }
}

template <bool CORE_ONLY>
cudaError_t launch(const float* h, const float* weights, float* out,
                   int n_bricks, int cin, int cout, cudaStream_t stream) {
  using V = Variant<CORE_ONLY>;
  const int col_groups = min((cout + COLS - 1) / COLS, MAX_COL_GROUPS);
  const int block_cols = col_groups * COLS;
  const dim3 grid((n_bricks + V::BRICKS - 1) / V::BRICKS,
                  (cout + block_cols - 1) / block_cols);
  const dim3 block(V::ROWS * col_groups);
  const size_t smem = ((size_t)V::BRICKS * CELLS * PITCH +
                       (size_t)3 * CHUNK * block_cols) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      brick_conv_kernel<CORE_ONLY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  brick_conv_kernel<CORE_ONLY><<<grid, block, smem, stream>>>(
      h, weights, out, n_bricks, cin, cout, col_groups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the core (core_only != 0) or full variant on `stream`; returns
// the CUDA error code (0 = ok).
int brick_conv_launch(const void* h, const void* weights, void* out,
                      int n_bricks, int cin, int cout, int core_only,
                      void* stream) {
  if (n_bricks < 1 || cin < 1 || cout < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* hp = static_cast<const float*>(h);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  const cudaError_t err =
      core_only ? launch<true>(hp, w, o, n_bricks, cin, cout, s)
                : launch<false>(hp, w, o, n_bricks, cin, cout, s);
  return (int)err;
}

}  // extern "C"
