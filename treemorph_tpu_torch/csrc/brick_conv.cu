// 3^3 conv over halo'd 6^3 bricks for Hopper (sm_90a), both variants, on
// the tensor cores.
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
// kernel's roll does, so it equals that kernel on any input.
//
// What bounds it on an H100: every output cell takes 27 * Cin * Cout
// multiply-adds against 216 * Cin input floats read once per brick, far
// above the card's ridge at Cin >= 8, so it is bound by arithmetic. The
// FP32 FMA rate (67 TFLOP/s) is the f32 bound; this kernel runs on the TF32
// tensor cores (495 TFLOP/s) in three passes, which bounds it at 3 / 495.
// The design:
//
// - Implicit GEMM with mma.sync.m16n8k8 (TF32 in, f32 accumulators). M is
//   the output cells of a group of bricks (core: 4 bricks of 64 cells; full:
//   1 brick of 216 cells padded to 224), N is Cout (one column slice of up
//   to 96), K is 27 offsets x Cin. Each lane gathers its own A rows from the
//   staged brick through the circular index; the rows of a 16-row tile are
//   chosen so that the 8 rows a load instruction touches differ mod 8 in f,
//   which with a cell pitch of 20 floats puts the warp's 32 loads on 32
//   banks. Each warp owns two 16-row tiles and every column tile of its
//   slice.
// - 3xTF32: a value x splits into hi (x rounded to TF32, to nearest) and
//   lo (the remainder x - hi, rounded the same way); a product is lo*hi +
//   hi*lo + hi*hi into the f32 accumulator, and only lo*lo (~2^-22 of it)
//   is lost. One TF32 pass keeps ~3 digits and misses 1e-5 of the output
//   scale at 32 -> 32; three stay within 1e-6 of float64, as the CPU
//   emulation in tests/test_torch_bricks.py shows. The tensor cores round
//   each mma's sum toward zero, so a long chain of mma into one
//   accumulator drifts with the chain's length (on the card it crossed
//   the 1e-5 gate at 64 and 96 channels); the six mma of an offset's 16
//   channels (two k-steps of three passes) therefore go into a fresh
//   fragment that is added to the f32 accumulator with a rounded add.
// - Weights once per call: split_weights_kernel splits W into hi and lo and
//   lays them out in B-fragment order, one float4 per lane and column tile
//   (hi b0, hi b1, lo b0, lo b1), so a piece of 3 offsets x 16 channels is
//   one contiguous block. A block is persistent (1 per SM for the core
//   variant, 2 for the full) and walks over groups of bricks; it streams
//   the pieces with cp.async, double-buffered, once per group: the weights
//   of an offset are read from L2 once per 4 bricks (core) or 1 brick of
//   224 rows (full), not once per 1-2 bricks.
// - The bricks' 16-channel chunks are double-buffered too: while a chunk's
//   9 weight pieces run through the tensor cores, each step loads a ninth of
//   the next chunk into registers before its products and stores it to the
//   other buffer after them.
// - All-zero bricks skip the products exactly: live_bricks_kernel reads each
//   brick (one warp per brick), and a brick whose whole 6^3 input is zero
//   (every float == 0) gets its output rows written as zeros; the others go
//   on a list that the GEMM grid walks, so its groups hold live bricks only
//   and its warps stay evenly loaded. The test reads the input itself and
//   rests on no count from the caller. A brick's sums do not depend on its
//   place in the list, so runs repeat bit for bit.
//
// One call runs the three grids in order on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CELLS = 216;        // 6^3 halo'd brick
constexpr int CORE = 64;          // 4^3 core
constexpr int CHUNK = 16;         // input channels staged per run
constexpr int PITCH = CHUNK + 4;  // staged cell pitch in floats (banks)
constexpr int KSTEPS = CHUNK / 8; // mma k-steps per chunk
constexpr int GROUPS = 9;         // (dx, dy) groups of 3 dz offsets
constexpr int MAX_NT = 12;        // column tiles of 8 per slice
constexpr int MTW = 2;            // 16-row tiles per warp
constexpr int FLUSH_STEPS = 2;    // k-steps per fresh fragment
static_assert(KSTEPS % FLUSH_STEPS == 0, "k-steps group evenly");
constexpr uint32_t TF32_MASK = 0xffffe000u;

// x rounded to TF32: to nearest, ties away from zero (half a TF32 unit
// added to the magnitude bits, then the low 13 mantissa bits cleared).
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & TF32_MASK;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// W (27, cin, cout) -> wf[slice][chunk][k][ks][nt][lane] float4 of the B
// fragments b0 = W[k][c][n], b1 = W[k][c + 4][n] with c = chunk*16 + ks*8 +
// lane%4 and n = slice*nt_per*8 + nt*8 + lane/4: (hi b0, hi b1, lo b0,
// lo b1); zero past cin or cout.
__global__ void split_weights_kernel(const float* __restrict__ w,
                                     float4* __restrict__ wf, int cin,
                                     int cout, int n_chunks, int nt_per,
                                     int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int lane = i & 31;
  int r = i >> 5;
  const int nt = r % nt_per;
  r /= nt_per;
  const int ks = r % KSTEPS;
  r /= KSTEPS;
  const int k = r % 27;
  r /= 27;
  const int chunk = r % n_chunks;
  const int slice = r / n_chunks;
  const int c = chunk * CHUNK + ks * 8 + (lane & 3);
  const int n = (slice * nt_per + nt) * 8 + (lane >> 2);
  float b0 = 0.f, b1 = 0.f;
  if (n < cout) {
    if (c < cin) b0 = w[((size_t)k * cin + c) * cout + n];
    if (c + 4 < cin) b1 = w[((size_t)k * cin + c + 4) * cout + n];
  }
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  wf[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                      __uint_as_float(l0), __uint_as_float(l1));
}

// One warp per brick: a brick with any non-zero input goes on the live
// list; the output rows of the others are written as zeros here.
__global__ void live_bricks_kernel(const float* __restrict__ h,
                                   float* __restrict__ out,
                                   int* __restrict__ live,
                                   int* __restrict__ n_live, int n_bricks,
                                   int cin, int cout, int out_cells,
                                   int vec) {
  const int b = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= n_bricks) return;  // whole warps leave together
  const float* hb = h + (size_t)b * CELLS * cin;
  const int n = CELLS * cin;
  bool nz = false;
  if (vec) {
    const float4* h4 = reinterpret_cast<const float4*>(hb);
#pragma unroll 6
    for (int i = lane; i < n / 4; i += 32) {
      const float4 x = __ldg(h4 + i);
      nz |= (x.x != 0.f) | (x.y != 0.f) | (x.z != 0.f) | (x.w != 0.f);
    }
  } else {
    for (int i = lane; i < n; i += 32) nz |= __ldg(hb + i) != 0.f;
  }
  if (__any_sync(0xffffffffu, nz)) {
    if (lane == 0) live[atomicAdd(n_live, 1)] = b;
    return;
  }
  float* ob = out + (size_t)b * out_cells * cout;
  if (cout % 4 == 0) {  // out is 16-byte aligned, and so is each brick
    float4* o4 = reinterpret_cast<float4*>(ob);
    for (int i = lane; i < out_cells * cout / 4; i += 32) {
      o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = lane; i < out_cells * cout; i += 32) ob[i] = 0.f;
  }
}

template <bool CORE_ONLY, int NT>
struct Cfg {
  static constexpr int G = CORE_ONLY ? 4 : 1;            // bricks per group
  static constexpr int TILES = CORE_ONLY ? 4 * G : 14;   // 16-row tiles
  static constexpr int WARPS = TILES / MTW;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int OUT_CELLS = CORE_ONLY ? CORE : CELLS;
  static constexpr int A_FLOATS = G * CELLS * PITCH;     // one chunk buffer
  static constexpr int A_VEC = G * CELLS * (CHUNK / 4);  // its float4s
  static constexpr int A_VEC_STEP = A_VEC / GROUPS;      // loaded per step
  static constexpr int A_PER_THREAD = (A_VEC_STEP + THREADS - 1) / THREADS;
  static constexpr int W_VEC = 3 * KSTEPS * NT * 32;     // float4s a piece
  static constexpr size_t SMEM =
      (size_t)2 * A_FLOATS * sizeof(float) + (size_t)2 * W_VEC * 16;
  static_assert(A_VEC % GROUPS == 0, "a chunk splits into 9 steps");
};

// Row r of 16-row tile `tile` of a group: its brick slot, its cell f in the
// halo'd brick (the gather's base) and its output row oc (>= 216: padding).
template <bool CORE_ONLY>
__device__ __forceinline__ void tile_row(int tile, int r, int& slot, int& f,
                                         int& oc) {
  if (CORE_ONLY) {
    // rows r and r + 1..7 of a load span z 0..3 and two x: f mod 8 differs
    const int mt = tile & 3;
    const int z = r & 3;
    const int x = 2 * (mt & 1) + ((r >> 2) & 1);
    const int y = 2 * (mt >> 1) + (r >> 3);
    slot = tile >> 2;
    f = (x + 1) * 36 + (y + 1) * 6 + z + 1;
    oc = x * 16 + y * 4 + z;
  } else {
    slot = 0;
    oc = tile * 16 + r;
    f = oc < CELLS ? oc : oc - CELLS;
  }
}

template <bool CORE_ONLY, int NT>
__global__ void __launch_bounds__(Cfg<CORE_ONLY, NT>::THREADS,
                                  CORE_ONLY ? 1 : 2)
brick_gemm_kernel(const float* __restrict__ h,       // (B, 216, cin)
                  const float4* __restrict__ wf,     // split_weights_kernel
                  const int* __restrict__ live,      // live bricks
                  const int* __restrict__ n_live_p,  // their count
                  float* __restrict__ out,           // (B, 64|216, cout)
                  int cin, int cout, int n_chunks, int vec) {
  using C = Cfg<CORE_ONLY, NT>;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                                           // [2][A_FLOATS]
  float4* w_s = reinterpret_cast<float4*>(smem + 2 * C::A_FLOATS);  // [2][W]

  const int n_live = *n_live_p;
  const int n_groups = (n_live + C::G - 1) / C::G;
  if ((int)blockIdx.x >= n_groups) return;
  const int my_groups = (n_groups - 1 - (int)blockIdx.x) / gridDim.x + 1;
  const int runs = my_groups * n_chunks;  // (group, chunk) pairs
  const int steps = runs * GROUPS;
  const int col0 = blockIdx.y * NT * 8;
  const float4* wf_slice =
      wf + (size_t)blockIdx.y * n_chunks * 27 * KSTEPS * NT * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  int slot[MTW], fr[MTW][2], oc[MTW][2];
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      tile_row<CORE_ONLY>(MTW * warp + mi, g + 8 * hr, slot[mi], fr[mi][hr],
                          oc[mi][hr]);
    }
  }

  // the brick in slot s of this block's group gi, or -1
  auto brick_of = [&](int gi, int s) -> int {
    const int idx = ((int)blockIdx.x + gi * (int)gridDim.x) * C::G + s;
    return idx < n_live ? live[idx] : -1;
  };

  float4 a_regs[C::A_PER_THREAD];
  // part p (of 9) of run `run`'s chunk into registers, zero past cin
  auto load_part = [&](int run, int part) {
    const int gi = run / n_chunks;
    const int c0 = (run - gi * n_chunks) * CHUNK;
#pragma unroll
    for (int j = 0; j < C::A_PER_THREAD; ++j) {
      const int local = j * C::THREADS + threadIdx.x;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (local < C::A_VEC_STEP) {
        const int e = part * C::A_VEC_STEP + local;
        const int s = e / (CELLS * 4);
        const int rem = e - s * CELLS * 4;
        const int ch = c0 + (rem & 3) * 4;
        const int b = brick_of(gi, s);
        if (b >= 0 && ch < cin) {
          const float* src = h + ((size_t)b * CELLS + (rem >> 2)) * cin + ch;
          if (vec) {
            v = __ldg(reinterpret_cast<const float4*>(src));
          } else {
            v.x = __ldg(src);
            if (ch + 1 < cin) v.y = __ldg(src + 1);
            if (ch + 2 < cin) v.z = __ldg(src + 2);
            if (ch + 3 < cin) v.w = __ldg(src + 3);
          }
        }
      }
      a_regs[j] = v;
    }
  };
  auto store_part = [&](int buf, int part) {
#pragma unroll
    for (int j = 0; j < C::A_PER_THREAD; ++j) {
      const int local = j * C::THREADS + threadIdx.x;
      if (local < C::A_VEC_STEP) {
        const int e = part * C::A_VEC_STEP + local;
        const int s = e / (CELLS * 4);
        const int rem = e - s * CELLS * 4;
        *reinterpret_cast<float4*>(
            a_s + buf * C::A_FLOATS + (s * CELLS + (rem >> 2)) * PITCH +
            (rem & 3) * 4) = a_regs[j];
      }
    }
  };
  // the weight piece of step `step` (chunk, (dx, dy) group) into buffer buf
  auto issue_w = [&](int step, int buf) {
    const int run = step / GROUPS;
    const int grp = step - run * GROUPS;
    const int c = run % n_chunks;
    const float4* src =
        wf_slice + (size_t)(c * 27 + grp * 3) * KSTEPS * NT * 32;
    float4* dst = w_s + buf * C::W_VEC;
    for (int i = threadIdx.x; i < C::W_VEC; i += C::THREADS) {
      cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };

  for (int part = 0; part < GROUPS; ++part) {
    load_part(0, part);
    store_part(0, part);
  }
  issue_w(0, 0);

  float acc[MTW][NT][4];
  for (int s = 0; s < steps; ++s) {
    const int run = s / GROUPS;
    const int grp = s - run * GROUPS;
    const int c = run % n_chunks;
    if (grp == 0 && c == 0) {
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
    }
    cp_async_wait_all();
    __syncthreads();  // piece s and the run's chunk landed; step s-1 done
    if (s + 1 < steps) issue_w(s + 1, (s + 1) & 1);
    const bool prefetch = run + 1 < runs;
    if (prefetch) load_part(run + 1, grp);

    const float* a_buf = a_s + (run & 1) * C::A_FLOATS;
    const float4* w_piece = w_s + (s & 1) * C::W_VEC;
    const int dxy = (grp / 3 - 1) * 36 + (grp % 3 - 1) * 6;
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      int row_off[MTW][2];
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          int src = fr[mi][hr] + dxy + dz - 1;
          src = src < 0 ? src + CELLS : (src >= CELLS ? src - CELLS : src);
          row_off[mi][hr] = (slot[mi] * CELLS + src) * PITCH + t;
        }
      }
#pragma unroll
      for (int k0 = 0; k0 < KSTEPS; k0 += FLUSH_STEPS) {
        uint32_t ahi[FLUSH_STEPS][MTW][4], alo[FLUSH_STEPS][MTW][4];
#pragma unroll
        for (int kf = 0; kf < FLUSH_STEPS; ++kf) {
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi) {
            const float* r0 = a_buf + row_off[mi][0] + (k0 + kf) * 8;
            const float* r1 = a_buf + row_off[mi][1] + (k0 + kf) * 8;
            split_tf32(r0[0], ahi[kf][mi][0], alo[kf][mi][0]);
            split_tf32(r1[0], ahi[kf][mi][1], alo[kf][mi][1]);
            split_tf32(r0[4], ahi[kf][mi][2], alo[kf][mi][2]);
            split_tf32(r1[4], ahi[kf][mi][3], alo[kf][mi][3]);
          }
        }
        const float4* wb = w_piece + (dz * KSTEPS + k0) * NT * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float4 b[FLUSH_STEPS];
#pragma unroll
          for (int kf = 0; kf < FLUSH_STEPS; ++kf) {
            b[kf] = wb[(kf * NT + nt) * 32];
          }
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi) {
            // the passes into a fresh fragment, then one rounded add
            float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kf = 0; kf < FLUSH_STEPS; ++kf) {
              const uint32_t bh0 = __float_as_uint(b[kf].x);
              const uint32_t bh1 = __float_as_uint(b[kf].y);
              mma_tf32(part, alo[kf][mi], bh0, bh1);
              mma_tf32(part, ahi[kf][mi], __float_as_uint(b[kf].z),
                       __float_as_uint(b[kf].w));
              mma_tf32(part, ahi[kf][mi], bh0, bh1);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][nt][e] += part[e];
          }
        }
      }
    }

    if (prefetch) store_part((run + 1) & 1, grp);
    if (grp == GROUPS - 1 && c == n_chunks - 1) {
      const int gi = run / n_chunks;
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
        const int b = brick_of(gi, slot[mi]);
        if (b < 0) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (oc[mi][hr] >= C::OUT_CELLS) continue;
          float* orow = out + ((size_t)b * C::OUT_CELLS + oc[mi][hr]) * cout;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = col0 + nt * 8 + 2 * t;
            if (col < cout) orow[col] = acc[mi][nt][2 * hr];
            if (col + 1 < cout) orow[col + 1] = acc[mi][nt][2 * hr + 1];
          }
        }
      }
    }
  }
}

// Column tiles per slice: the smallest instantiation that holds cout, or
// MAX_NT with several slices.
int tiles_per_slice(int cout) {
  const int tiles = (cout + 7) / 8;
  return tiles <= 4 ? 4 : (tiles <= 8 ? 8 : MAX_NT);
}

int n_slices(int cout) {
  const int nt = tiles_per_slice(cout);
  return ((cout + 7) / 8 + nt - 1) / nt;
}

size_t weight_floats(int cin, int cout) {
  const int n_chunks = (cin + CHUNK - 1) / CHUNK;
  return (size_t)n_slices(cout) * n_chunks * 27 * KSTEPS *
         tiles_per_slice(cout) * 32 * 4;
}

template <bool CORE_ONLY, int NT>
cudaError_t launch_gemm(const float* h, const float4* wf, const int* live,
                        const int* n_live, float* out, int n_bricks, int cin,
                        int cout, int n_chunks, int vec, cudaStream_t stream) {
  using C = Cfg<CORE_ONLY, NT>;
  auto kernel = brick_gemm_kernel<CORE_ONLY, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      C::THREADS, C::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int groups = (n_bricks + C::G - 1) / C::G;
  const dim3 grid(groups < sms * per_sm ? groups : sms * per_sm,
                  n_slices(cout));
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(h, wf, live, n_live, out,
                                                cin, cout, n_chunks, vec);
  return cudaGetLastError();
}

template <bool CORE_ONLY>
cudaError_t launch_gemm_nt(const float* h, const float4* wf, const int* live,
                           const int* n_live, float* out, int n_bricks,
                           int cin, int cout, int n_chunks, int vec,
                           cudaStream_t s) {
  switch (tiles_per_slice(cout)) {
    case 4:
      return launch_gemm<CORE_ONLY, 4>(h, wf, live, n_live, out, n_bricks,
                                       cin, cout, n_chunks, vec, s);
    case 8:
      return launch_gemm<CORE_ONLY, 8>(h, wf, live, n_live, out, n_bricks,
                                       cin, cout, n_chunks, vec, s);
    default:
      return launch_gemm<CORE_ONLY, MAX_NT>(h, wf, live, n_live, out,
                                            n_bricks, cin, cout, n_chunks,
                                            vec, s);
  }
}

}  // namespace

extern "C" {

// Bytes of scratch brick_conv_launch needs: the split weights, then the
// live count and list.
size_t brick_conv_workspace_bytes(int n_bricks, int cin, int cout) {
  return weight_floats(cin, cout) * sizeof(float) +
         ((size_t)n_bricks + 1) * sizeof(int);
}

// Launches the core (core_only != 0) or full variant on `stream`: h (B,
// 216, cin) f32, weights (27, cin, cout) f32, out (B, 64|216, cout) f32,
// workspace of brick_conv_workspace_bytes (16-byte aligned). Returns the
// CUDA error code (0 = ok).
int brick_conv_launch(const void* h, const void* weights, void* out,
                      void* workspace, int n_bricks, int cin, int cout,
                      int core_only, void* stream) {
  if (n_bricks < 1 || cin < 1 || cout < 1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(workspace) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* hp = static_cast<const float*>(h);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  auto* wf = static_cast<float4*>(workspace);
  int* n_live = reinterpret_cast<int*>(
      static_cast<float*>(workspace) + weight_floats(cin, cout));
  int* live = n_live + 1;
  const int n_chunks = (cin + CHUNK - 1) / CHUNK;
  const int vec =
      cin % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 ? 1 : 0;

  cudaError_t err = cudaMemsetAsync(n_live, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int total = (int)(weight_floats(cin, cout) / 4);
  split_weights_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      w, wf, cin, cout, n_chunks, tiles_per_slice(cout), total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int out_cells = core_only ? CORE : CELLS;
  live_bricks_kernel<<<(n_bricks + 7) / 8, 256, 0, s>>>(
      hp, o, live, n_live, n_bricks, cin, cout, out_cells, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = core_only ? launch_gemm_nt<true>(hp, wf, live, n_live, o, n_bricks,
                                         cin, cout, n_chunks, vec, s)
                  : launch_gemm_nt<false>(hp, wf, live, n_live, o, n_bricks,
                                          cin, cout, n_chunks, vec, s);
  return (int)err;
}

}  // extern "C"
