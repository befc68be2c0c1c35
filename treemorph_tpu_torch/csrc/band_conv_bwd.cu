// Band submanifold conv backward, weight gradient, for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces treemorph_tpu/ops/bandconv.py::_band_bwd_kernel (the Pallas TPU
// kernel behind _band_bwd_padded) together with the forward kernel of
// band_conv.cu, at 3x3x3 (K = 27) and 5x5x5 (K = 125) kernels. The TPU
// kernel yields both cotangents from one one-hot pass; here the wrapper
// (ops/bandconv.py::band_conv_bwd_padded) gets d_feats from the forward
// kernel run on (grad, w_bwd), which is the same banded function over the
// same plan, and this kernel computes the weight gradient: for every
// 128-row tile t, row i and offset k whose rulebook entry e = rb[t, k, i] is
// found (e < m) and lies in the window [64 * starts[g(k), t], + win) of the
// entry's (dx, dy) group g(k) = k / ksize,
//
//   dw[K - 1 - k] += feats[t*128 + i] (outer) grad[e]
//
// By the rulebook's antisymmetry (rb[i, k] == r  <=>  rb[r, K - 1 - k] == i)
// this is the forward entry (e, K - 1 - k) contribution to dW, counted once
// from the side of the row that owns it, as build_band_plan counts entries;
// the found entries outside their window are added by the caller's residual
// repair.
//
// What bounds it on an H100: per in-window entry it does Cin * Cout
// multiply-adds and reads a gradient row, so at TreeLearn's widths (Cin,
// Cout 32..128) it is bound by arithmetic, and without tensor cores by FP32
// FMA issue. The design:
//
// - For each tile and offset k, dw[K - 1 - k] += F_t^T (Cin x 128) . G_k
//   (128 x Cout), a GEMM whose k dimension is the tile's rows: F_t is the
//   tile's own 128 contiguous feature rows, G_k its 128 rulebook rows of the
//   gradient, gathered from L2 with cp.async (rows not found, or outside
//   their window, are zero-filled without a read).
// - A block owns UNIT consecutive offsets (one warp each) for a 32 x 32
//   (Cin, Cout) slice and walks a run of tiles; each warp owns one offset's
//   32 x 32 sums. Per tile the block stages the slice of F_t once for its
//   UNIT offsets and each warp gathers its own G_k. A warp's running sums
//   and their Kahan compensation take 64 registers a lane and the tile's
//   fresh fragment 32 more, and a stage (F plus UNIT gathered G, 10 KB
//   each) is double-buffered in shared memory, so the unit is bounded by
//   the 227 KB a block may take:
//   - K = 27: the 9 offsets of one dx plane (three (dx, dy) groups), 288
//     threads, 200 KB; F_t is staged three times per tile in all (where a
//     grid of one group per block would stage it nine times). All 27
//     offsets would need 864 threads on 75 registers each, and a stage a
//     block could not double-buffer.
//   - K = 125: a dx plane holds 25 offsets, 800 threads and a 260 KB stage,
//     over the limit even single-buffered. So the unit is one (dx, dy)
//     group's 5 offsets: 160 threads, 6 buffers of 10 KB double-buffered in
//     120 KB (one block an SM). F_t is staged 25 times per tile, a sixth of
//     the stage's bytes; it is read from L2 after the first group's block.
//     A plane split over blocks would stage it no less often and need a
//     second pass to add the parts.
// - Rows sit at an 80-byte pitch (bf16) or a 40-float pitch (f32), so
//   ldmatrix.trans (bf16) and the lanes' scalar loads (f32) hit 32 distinct
//   banks. Stages are double-buffered with cp.async: a tile's rows load
//   while the previous tile's products run, and each lane loads the next
//   stage's rulebook entries one stage ahead.
// - Precision: bf16 mode multiplies bf16 features by bf16 gradients, so one
//   mma.sync.m16n8k16 bf16 pass gives exact products (A = F_t^T and B = G_k
//   read with ldmatrix.trans, 8 k-steps of 16 rows per tile). f32 mode runs
//   3xTF32 on mma.sync.m16n8k8 (hi = x rounded to TF32 to nearest, lo = the
//   rest rounded the same way; lo*hi + hi*lo + hi*hi), 64 rows per stage.
//   The products of a stage (one tile in bf16 mode, half of one in f32 mode)
//   go into a fresh fragment (the tensor cores round each mma's sum toward
//   zero), which is added to the warp's running sums with Kahan
//   compensation: a block's sums run over thousands of entries whose terms
//   largely cancel (a BatchNorm's backward leaves gradients of zero mean).
//   tests/test_torch_bandconv_bwd.py emulates both modes against float64,
//   at both kernel sizes.
// - Warps whose offset no row of the stage reaches gather nothing and skip
//   their products. Each block writes its own partial sums and the wrapper
//   adds the partials up (no float atomics, so runs repeat bit for bit).
// - d_feats stays a launch of the forward kernel: it sums over offsets per
//   row, this kernel over rows per offset, so a fused pass would need all
//   K offsets' weight slices and sums in one block.
// - The kernel is a template on K and the unit; the K = 27 instances
//   compile to the same machine code as before the template
//   (compare_sass.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // rows per tile
constexpr int ALIGN = 64;     // window anchors are in units of 64 rows
constexpr int CS = 32;        // channels of a slice, input and output
constexpr int BUF_BYTES = 10240;  // one staged operand (F or one G_k)
constexpr uint32_t TF32_MASK = 0xffffe000u;

// per kernel size: the kernel edge (offsets run dz fastest, ksize of them
// to a (dx, dy) group) and the offsets a block owns, one warp each
template <int K>
struct Size;
template <>
struct Size<27> {
  static constexpr int KSIZE = 3;
  static constexpr int UNIT = 9;  // one dx plane
};
template <>
struct Size<125> {
  static constexpr int KSIZE = 5;
  static constexpr int UNIT = 5;  // one (dx, dy) group
};

// a block of UNIT offsets: its threads and one stage's bytes
template <int UNIT>
struct Unit {
  static constexpr int THREADS = UNIT * 32;
  static constexpr int STAGE_BYTES = (UNIT + 1) * BUF_BYTES;
};

// per mode: rows per stage, staged row pitch in bytes, 16-byte segments of
// a slice row, rows a lane gathers per stage
template <bool BF16>
struct Mode {
  static constexpr int ELEM = BF16 ? 2 : 4;
  static constexpr int ROWS = BF16 ? 128 : 64;
  static constexpr int PITCH = BF16 ? 80 : 160;
  static constexpr int SEGS = CS * ELEM / 16;
  static constexpr int LANE_ROWS = ROWS / 32;
  static constexpr int STAGES_PER_TILE = TILE / ROWS;
  static_assert(ROWS * PITCH == BUF_BYTES, "a staged operand fills a buffer");
};

__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & TF32_MASK;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// sum += x with Kahan compensation: comp carries the low-order part the
// last addition lost (nvcc reassociates no float ops without fast-math)
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// `n` channels from `src` (element type of ELEM bytes) into a staged row,
// zero past `n`, for widths that are not a multiple of 16 bytes
template <int ELEM>
__device__ __forceinline__ void copy_elems(unsigned char* dst,
                                           const char* src, int n) {
  for (int c = 0; c < CS; ++c) {
    if (ELEM == 2) {
      reinterpret_cast<unsigned short*>(dst)[c] =
          c < n ? reinterpret_cast<const unsigned short*>(src)[c]
                : (unsigned short)0;
    } else {
      reinterpret_cast<float*>(dst)[c] =
          c < n ? reinterpret_cast<const float*>(src)[c] : 0.f;
    }
  }
}

template <bool BF16, int K, int UNIT>
__global__ void __launch_bounds__(Unit<UNIT>::THREADS, 1)
band_conv_bwd_kernel(const int32_t* __restrict__ rb_tiles,  // (n_tiles, K, 128)
                     const int32_t* __restrict__ starts,    // (G, n_tiles)
                     const char* __restrict__ grad,         // (Mp, cout)
                     const char* __restrict__ feats,        // (Mp, cin)
                     float* __restrict__ partial,  // (gridDim.x, K, cin, cout)
                     int n_tiles, int tiles_per_block, int cin, int cout,
                     int m, int win, int vec_f, int vec_g) {
  using M = Mode<BF16>;
  constexpr int KSIZE = Size<K>::KSIZE;
  constexpr int THREADS = Unit<UNIT>::THREADS;
  constexpr int STAGE_BYTES = Unit<UNIT>::STAGE_BYTES;
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.y * UNIT + warp;  // this warp's offset
  const int n_co = (cout + CS - 1) / CS;
  const int ci0 = (blockIdx.z / n_co) * CS;
  const int co0 = (blockIdx.z % n_co) * CS;
  const int f_bytes = cin * M::ELEM, g_bytes = cout * M::ELEM;

  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);
  const int n_stages = max(t_end - t_begin, 0) * M::STAGES_PER_TILE;

  // this lane's rulebook entries of stage s (rows lane + 32 j of it) and
  // the window anchor, loaded a stage ahead of their use
  int rb_next[M::LANE_ROWS], base_next = 0;
  auto load_rows = [&](int s) {
    if (s >= n_stages) return;
    const int t = t_begin + s / M::STAGES_PER_TILE;
    const int r0 = (s % M::STAGES_PER_TILE) * M::ROWS;
#pragma unroll
    for (int j = 0; j < M::LANE_ROWS; ++j) {
      rb_next[j] = rb_tiles[((size_t)t * K + k) * TILE + r0 + lane + 32 * j];
    }
    base_next = starts[(k / KSIZE) * n_tiles + t] * ALIGN;
  };

  // stage s into buffer buf: F's slice rows (all threads), then this warp's
  // G_k rows; returns whether any of the warp's rows is in its window
  auto issue = [&](int s, int buf) -> bool {
    unsigned char* stage = smem + buf * STAGE_BYTES;
    const int t = t_begin + s / M::STAGES_PER_TILE;
    const size_t row0 =
        (size_t)t * TILE + (s % M::STAGES_PER_TILE) * M::ROWS;
    for (int e = threadIdx.x; e < M::ROWS * M::SEGS; e += THREADS) {
      const int r = e / M::SEGS, sg = e % M::SEGS;
      const int byte = ci0 * M::ELEM + sg * 16;
      const char* src = feats + (row0 + r) * f_bytes + byte;
      unsigned char* dst = stage + r * M::PITCH + sg * 16;
      if (vec_f) {
        cp_async16(dst, byte < f_bytes ? src : feats,
                   byte < f_bytes ? 16 : 0);
      } else if (sg == 0) {
        copy_elems<M::ELEM>(dst, src, cin - ci0);
      }
    }
    unsigned char* g_buf = stage + (1 + warp) * BUF_BYTES;
    int idx[M::LANE_ROWS];
    bool any = false;
#pragma unroll
    for (int j = 0; j < M::LANE_ROWS; ++j) {
      const int local = rb_next[j] - base_next;
      const bool ok = rb_next[j] < m && local >= 0 && local < win;
      idx[j] = ok ? rb_next[j] : -1;
      any |= ok;
    }
    if (!__any_sync(0xffffffffu, any)) return false;
#pragma unroll
    for (int j = 0; j < M::LANE_ROWS; ++j) {
      const int r = lane + 32 * j;
      const char* src = grad + (size_t)max(idx[j], 0) * g_bytes +
                        co0 * M::ELEM;
      unsigned char* dst = g_buf + r * M::PITCH;
      if (vec_g) {
#pragma unroll
        for (int sg = 0; sg < M::SEGS; ++sg) {
          const bool ok = idx[j] >= 0 && co0 * M::ELEM + sg * 16 < g_bytes;
          cp_async16(dst + sg * 16, ok ? src + sg * 16 : grad, ok ? 16 : 0);
        }
      } else {
        copy_elems<M::ELEM>(dst, src, idx[j] >= 0 ? cout - co0 : 0);
      }
    }
    return true;
  };

  float sum[2][4][4], comp[2][4][4];  // [ci m-tile][co n-tile][fragment]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mi][nt][e] = comp[mi][nt][e] = 0.f;

  const int g = lane >> 2, tq = lane & 3;
  auto compute = [&](int buf) {
    const unsigned char* stage = smem + buf * STAGE_BYTES;
    const unsigned char* g_buf = stage + (1 + warp) * BUF_BYTES;
    float part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][nt][e] = 0.f;
    if (BF16) {
      // ldmatrix.trans lane addresses, matrix j = lane / 8: A (F^T) takes
      // rows 8 (j >> 1) and channels 8 (j & 1) of a 16 x 16 block; B (G_k)
      // rows 8 (j & 1) and columns 8 (j >> 1)
      const int j = lane >> 3, r = lane & 7;
      const uint32_t f_addr =
          smem_u32(stage) + (r + 8 * (j >> 1)) * M::PITCH + 16 * (j & 1);
      const uint32_t g_addr =
          smem_u32(g_buf) + (r + 8 * (j & 1)) * M::PITCH + 16 * (j >> 1);
#pragma unroll
      for (int ks = 0; ks < M::ROWS / 16; ++ks) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4_trans(a[mi], f_addr + ks * 16 * M::PITCH + mi * 32);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4_trans(b[np], g_addr + ks * 16 * M::PITCH + np * 32);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(part[mi][nt], a[mi], b[nt >> 1][2 * (nt & 1)],
                     b[nt >> 1][2 * (nt & 1) + 1]);
      }
    } else {
      const float* f_s = reinterpret_cast<const float*>(stage);
      const float* g_s = reinterpret_cast<const float*>(g_buf);
      constexpr int P = M::PITCH / 4;
#pragma unroll 2
      for (int ks = 0; ks < M::ROWS / 8; ++ks) {
        const float* f0 = f_s + (8 * ks + tq) * P + g;
        const float* g0 = g_s + (8 * ks + tq) * P + g;
        uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // a0 = A[g][t] = F[t][g], a1 = F[t][g + 8], a2 = F[t + 4][g],
          // a3 = F[t + 4][g + 8] (channels of m-tile mi)
          split_tf32(f0[16 * mi], ahi[mi][0], alo[mi][0]);
          split_tf32(f0[16 * mi + 8], ahi[mi][1], alo[mi][1]);
          split_tf32(f0[4 * P + 16 * mi], ahi[mi][2], alo[mi][2]);
          split_tf32(f0[4 * P + 16 * mi + 8], ahi[mi][3], alo[mi][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          split_tf32(g0[8 * nt], bhi[nt][0], blo[nt][0]);
          split_tf32(g0[4 * P + 8 * nt], bhi[nt][1], blo[nt][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_tf32(part[mi][nt], alo[mi], bhi[nt][0], bhi[nt][1]);
            mma_tf32(part[mi][nt], ahi[mi], blo[nt][0], blo[nt][1]);
            mma_tf32(part[mi][nt], ahi[mi], bhi[nt][0], bhi[nt][1]);
          }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kahan_add(sum[mi][nt][e], comp[mi][nt][e], part[mi][nt][e]);
  };

  bool live[2] = {false, false};
  load_rows(0);
  if (n_stages > 0) live[0] = issue(0, 0);
  cp_async_commit();
  load_rows(1);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    const bool cur = (s & 1) ? live[1] : live[0];
    if (s + 1 < n_stages) {
      const bool nxt = issue(s + 1, (s + 1) & 1);
      if (s & 1) live[0] = nxt; else live[1] = nxt;
    }
    cp_async_commit();
    load_rows(s + 2);
    if (cur) compute(s & 1);
  }

  float* dst = partial + ((size_t)blockIdx.x * K + (K - 1 - k)) * cin * cout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = ci0 + 16 * mi + g + 8 * (e >> 1);
        const int co = co0 + 8 * nt + 2 * tq + (e & 1);
        if (ci < cin && co < cout) {
          dst[(size_t)ci * cout + co] = sum[mi][nt][e] - comp[mi][nt][e];
        }
      }
}

template <bool BF16, int K>
cudaError_t launch(const int32_t* rb_tiles, const int32_t* starts,
                   const void* grad, const void* feats, float* partial,
                   int n_blocks, int n_tiles, int tiles_per_block, int cin,
                   int cout, int m, int win, cudaStream_t stream) {
  constexpr int ELEM = BF16 ? 2 : 4;
  constexpr int UNIT = Size<K>::UNIT;
  static_assert(K % UNIT == 0, "a grid row per unit of offsets");
  const int slices = ((cin + CS - 1) / CS) * ((cout + CS - 1) / CS);
  const dim3 grid(n_blocks, K / UNIT, slices);
  const size_t smem = 2 * (size_t)Unit<UNIT>::STAGE_BYTES;
  auto kernel = band_conv_bwd_kernel<BF16, K, UNIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec_f = (cin * ELEM) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const int vec_g = (cout * ELEM) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(grad) % 16 == 0;
  kernel<<<grid, Unit<UNIT>::THREADS, smem, stream>>>(
      rb_tiles, starts, static_cast<const char*>(grad),
      static_cast<const char*>(feats), partial, n_tiles, tiles_per_block, cin,
      cout, m, win, vec_f, vec_g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the CUDA error code (0 = ok).
// Block x covers tiles [x * tiles_per_block, + tiles_per_block) and writes
// partial[x] (k, cin, cout); n_blocks * tiles_per_block must cover n_tiles.
// Takes k = 27 or 125; `win` must be a multiple of 64 and every window
// [64 * starts, + win) must lie inside the n_tiles * 128 rows, which
// build_band_plan guarantees.
int band_conv_bwd_launch(const void* rb_tiles, const void* starts,
                         const void* grad, const void* feats, int bf16,
                         void* partial, int n_blocks, int n_tiles,
                         int tiles_per_block, int k, int cin, int cout, int m,
                         int win, void* stream) {
  if ((k != 27 && k != 125) || cin < 1 || cout < 1 || win < 1 ||
      win % ALIGN != 0 || n_blocks < 1 || tiles_per_block < 1 ||
      (long long)n_blocks * tiles_per_block < n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rb = static_cast<const int32_t*>(rb_tiles);
  const auto* st = static_cast<const int32_t*>(starts);
  auto* p = static_cast<float*>(partial);
#define BWD_LAUNCH(B, KK)                                                   \
  launch<B, KK>(rb, st, grad, feats, p, n_blocks, n_tiles, tiles_per_block, \
                cin, cout, m, win, s)
  const cudaError_t err =
      k == 27 ? (bf16 ? BWD_LAUNCH(true, 27) : BWD_LAUNCH(false, 27))
              : (bf16 ? BWD_LAUNCH(true, 125) : BWD_LAUNCH(false, 125));
#undef BWD_LAUNCH
  return (int)err;
}

}  // extern "C"
