// Band submanifold conv forward for Hopper (sm_90a), on the tensor cores,
// and its z-packed variant.
//
// Replaces treemorph_tpu/ops/bandconv.py::_band_kernel (the Pallas TPU
// kernel behind _band_conv_padded). It computes that kernel's function, not
// its mechanism: for every 128-row output tile t and row i,
//
//   out[t*128 + i] = sum_k  feats[rb[t, k, i]] @ W[k]
//
// over the found rulebook entries (rb < m) whose row lies in the window
// [64 * starts[g(k), t], + win) of the entry's (dx, dy) group g(k) =
// k / ksize. Found entries outside the window are left out; the caller adds
// them back (_residual_repair). K = ksize^3 is 27 (every xCPE and TreeLearn
// conv) or 125 (PTv3's stem). The TPU kernel's one-hot MXU select and its
// bf16 hi/lo split of f32 features are TPU workarounds and are not carried
// over.
//
// The same kernel also replaces treemorph_tpu/ops/bandconv.py::_zband_kernel
// (behind _zband_conv_padded), the z-packed band conv:
//
//   out[t*128 + i] = sum_g  zq[a] @ W2[g],   a = anchors[t, g, i]
//
// over the G = ksize^2 groups whose anchor (the group's dz = 0 entry) is
// found (a < m) and lies in [8 * starts[g, t], + win). Row a of zq holds
// the features of a's ksize z-neighbors side by side, so W2[g] is the
// group's (ksize * Cin, Cout) filter. That is the band function with the G
// groups as the offsets, e = ksize * Cin as the channels, each offset its
// own window group and windows in units of 8 rows: the z-band instances
// are band_conv_kernel<G, 1, 8, ...> (G = 9 or 25), launched by
// zband_conv_launch. A missing or out-of-window anchor adds nothing; the
// caller's residual repair owns it.
//
// What bounds it on an H100: per output row the kernel does K * Cin * Cout
// multiply-adds (the in-window share of them is real work) and reads 4 K
// bytes of rulebook plus the rows it gathers, so at TreeLearn's and PTv3's
// xCPE widths (Cin 7..512, Cout 32..512) it is bound by arithmetic, and
// without tensor cores by FP32 FMA issue and the shared-memory loads that
// feed it; PTv3's stem (4 -> 32 at K = 125) is bound by its rulebook's
// bytes. The z-band variant does the same multiply-adds per covered anchor
// (ksize * Cin * Cout for each of G groups) from a rulebook ksize times
// smaller, and its rows are ksize times longer: the k=5 stem's 4 channels
// become one 40-byte (bf16) or 80-byte (f32) row per group, 25 or 50
// stages a tile where K = 125 takes 125. The design:
//
// - A gathered implicit GEMM with mma.sync: M is one 128-row tile, N is a
//   column slice of Cout (all of it up to 128 columns, so nothing is staged
//   twice for the last columns), K is the K offsets x Cin. A block has 8
//   warps, 4 along the rows (32 each) x 2 along the columns, and keeps its
//   128 x N f32 sums in registers across all K offsets.
// - The A operand of offset k is the tile's 128 rulebook rows, gathered
//   straight from L2 into shared memory with cp.async, 64 bytes of each row
//   per stage (32 bf16 or 16 f32 channels); rows that were not found, or lie
//   outside their window, are zero-filled without a read. The plan's
//   windows are not staged: K x 128 gathered rows are fewer than ksize^2
//   windows of win rows, and only the found ones are read. Rows sit at an
//   80-byte pitch, so the 8 row addresses of an ldmatrix hit 32 distinct
//   banks. Stages (offset, 64-byte channel chunk) run through a 3-deep
//   cp.async ring; a prologue marks the offsets some row of the tile
//   reaches (a mask of 32-bit words, one ballot per offset), only those
//   are staged, and a tile that reaches nothing writes zeros. K, the
//   offsets of a window group (GSPAN) and the window unit (UNIT) are
//   template parameters, so the band instances keep their constant
//   offsets, groups and 64-row unit, and K <= 32 keeps one mask word.
// - B is W[k], split once per call by split_weights_kernel into fragment
//   order, so a stage's B is one contiguous block copied with cp.async and
//   read by each lane as 16-byte loads without bank conflicts.
// - Precision, bf16 mode (the main path): bf16 features are exact; each f32
//   weight splits into three bf16 pieces (w1 = bf16(w), w2 = bf16(w - w1),
//   w3 = bf16(w - w1 - w2), rounded to nearest), which carry its whole
//   mantissa. mma.sync.m16n8k16 bf16 runs the three pieces (w3 first), so
//   every product is exact: three bf16 passes at 989 TFLOP/s cost less than
//   two TF32 passes at 495. f32 mode: 3xTF32 with mma.sync.m16n8k8 (hi =
//   x rounded to TF32 to nearest, lo = the rest rounded the same way;
//   lo*hi + hi*lo + hi*hi), A split in registers after its ldmatrix. The
//   tensor cores round each mma's sum toward zero, so each stage's six mma
//   (two k-steps x three passes) go into a fresh fragment that is added to
//   the f32 sums with a rounded add. tests/test_torch_bandconv.py and
//   tests/test_torch_zband.py emulate both modes against float64.
// - Rows that are not a multiple of 16 bytes (the stem's 7 channels; the
//   z-band rows of 20 and 21 bf16 or 21 f32 channels) are staged element
//   by element, all of a stage's loads issued before its stores, and
//   zero-padded in shared memory up to the stage's 64 bytes; that path is
//   an instantiation of its own (VEC false), so the cp.async path keeps its
//   registers and its blocks per SM. PTv3's bf16 stem (4 channels, 8 bytes
//   a row) takes it too: each stage holds 4 real channels of 32, the price
//   of a simple kernel for a conv that is a small share of the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 128;        // output rows per block
constexpr int ALIGN = 64;        // band window anchors: units of 64 rows
constexpr int ZALIGN = 8;        // z-band window anchors: units of 8 rows
constexpr int MAX_K = 125;       // offsets: ksize^3, dz fastest, ksize 3 or 5
constexpr int THREADS = 256;     // 8 warps: 4 along the rows x 2 along N
constexpr int CHUNK_BYTES = 64;  // bytes of a row per stage (two k-steps)
constexpr int A_PITCH = CHUNK_BYTES + 16;  // staged row pitch in bytes
constexpr int A_BYTES = TILE * A_PITCH;
constexpr int STAGES = 3;        // cp.async ring depth
constexpr int MAX_NS = 128;      // columns of one slice
constexpr uint32_t TF32_MASK = 0xffffe000u;

// bytes of one stage's B operand: bf16, two k-steps x three pieces x NS
// columns x 16 channels x 2 bytes; f32, two k-steps x NS columns x 8
// channels x (hi, lo) x 4 bytes
__host__ __device__ constexpr int b_bytes(bool bf16, int ns) {
  return (bf16 ? 192 : 128) * ns;
}
__host__ __device__ constexpr int stage_bytes(bool bf16, int ns) {
  return A_BYTES + b_bytes(bf16, ns);
}
// the ring, the tile's gather rows [k][128] and the mask of live offsets
constexpr size_t smem_bytes(bool bf16, int ns, int k) {
  return (size_t)STAGES * stage_bytes(bf16, ns) + k * TILE * sizeof(int) +
         16;
}

// x rounded to TF32: to nearest, ties away from zero
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bf16 bits of x rounded to nearest (even)
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// piece p (0, 1, 2) of w's three-way bf16 split, as bf16 bits
__device__ __forceinline__ uint32_t bf16_piece(float w, int p) {
  const float w1 = __bfloat162float(__float2bfloat16_rn(w));
  if (p == 0) return bf16_bits(w1);
  const float r1 = w - w1;
  const float w2 = __bfloat162float(__float2bfloat16_rn(r1));
  if (p == 1) return bf16_bits(w2);
  return bf16_bits(r1 - w2);
}

// W (k, cin, cout) f32 -> the B fragments of every stage, in the order the
// GEMM reads them: [slice][k][chunk] blocks of b_bytes(bf16, ns).
// bf16: uint4 [ks][piece][n-tile pair][lane] = (b0, b1 of n-tile 2p, b0, b1
// of n-tile 2p + 1), b0 = W[c][n], W[c + 1][n] and b1 = W[c + 8][n],
// W[c + 9][n] packed low-first, c = chunk*32 + ks*16 + 2*(lane % 4), n =
// slice*ns + n_tile*8 + lane / 4. f32: float4 [ks][n-tile][lane] = (hi b0,
// hi b1, lo b0, lo b1), b0 = W[c][n], b1 = W[c + 4][n], c = chunk*16 +
// ks*8 + lane % 4. Zero past cin or cout.
__global__ void split_weights_kernel(const float* __restrict__ w,
                                     uint4* __restrict__ wf, int kk,
                                     int cin, int cout, int n_chunks, int ns,
                                     int bf16, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int lane = i & 31;
  const int g = lane >> 2, tq = lane & 3;
  int r = i >> 5;
  auto at = [&](int c, int n) -> float {
    return c < cin && n < cout ? w[(size_t)c * cout + n] : 0.f;
  };
  if (bf16) {
    const int pairs = ns / 16;
    const int p = r % pairs;
    r /= pairs;
    const int piece = r % 3;
    r /= 3;
    const int ks = r % 2;
    r /= 2;
    const int chunk = r % n_chunks;
    r /= n_chunks;
    const int k = r % kk;
    const int slice = r / kk;
    w += (size_t)k * cin * cout;
    const int c = chunk * 32 + ks * 16 + 2 * tq;
    uint32_t word[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = slice * ns + (2 * p + h) * 8 + g;
      word[2 * h] = bf16_piece(at(c, n), piece) |
                    bf16_piece(at(c + 1, n), piece) << 16;
      word[2 * h + 1] = bf16_piece(at(c + 8, n), piece) |
                        bf16_piece(at(c + 9, n), piece) << 16;
    }
    wf[i] = make_uint4(word[0], word[1], word[2], word[3]);
  } else {
    const int tiles = ns / 8;
    const int nt = r % tiles;
    r /= tiles;
    const int ks = r % 2;
    r /= 2;
    const int chunk = r % n_chunks;
    r /= n_chunks;
    const int k = r % kk;
    const int slice = r / kk;
    w += (size_t)k * cin * cout;
    const int c = chunk * 16 + ks * 8 + tq;
    const int n = slice * ns + nt * 8 + g;
    uint32_t h0, l0, h1, l1;
    split_tf32(at(c, n), h0, l0);
    split_tf32(at(c + 4, n), h1, l1);
    wf[i] = make_uint4(h0, h1, l0, l1);
  }
}

// K offsets; offset k's window is group k / GSPAN's, anchored in units of
// UNIT rows: <ksize^3, ksize, ALIGN> for the band conv, <ksize^2, 1,
// ZALIGN> for the z-band conv (its offsets are the groups, its rows zq's)
template <int K, int GSPAN, int UNIT, bool BF16, int NS, bool VEC>
__global__ void __launch_bounds__(THREADS, NS <= 96 ? 2 : 1)
band_conv_kernel(const int32_t* __restrict__ rb_tiles,  // (n_tiles, K, 128)
                 const int32_t* __restrict__ starts,    // (K/GSPAN, n_tiles)
                 const char* __restrict__ feats,        // (Mp, cin)
                 const uint4* __restrict__ wf,          // split weights
                 float* __restrict__ out,               // (Mp, cout)
                 int n_tiles, int cin, int cout, int m, int win,
                 int n_chunks) {
  constexpr int WORDS = (K + 31) / 32;    // words of the live-offset mask
  static_assert(WORDS * 4 <= 16, "the mask has 16 bytes of shared memory");
  constexpr int ELEM = BF16 ? 2 : 4;
  constexpr int KC = CHUNK_BYTES / ELEM;  // channels per stage
  constexpr int B_BYTES = b_bytes(BF16, NS);
  constexpr int STAGE = stage_bytes(BF16, NS);
  constexpr int NTW = NS / 16;            // n-tiles of 8 per warp
  extern __shared__ __align__(16) unsigned char smem[];
  int* idx_s = reinterpret_cast<int*>(smem + STAGES * STAGE);  // [K][128]
  unsigned* live_s = reinterpret_cast<unsigned*>(idx_s + K * TILE);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int row_bytes = cin * ELEM;

  // the tile's gather rows (-1: not found or outside the window) and the
  // mask of offsets any row reaches
  if (tid < WORDS) live_s[tid] = 0u;
  __syncthreads();
  {
    // threads 0-127 take the first half of the offsets, 128-255 the rest;
    // every warp lies in one half, so the vote below is warp-uniform
    const int i = tid & (TILE - 1);
    constexpr int HALF = (K + 1) / 2;
    const int k0 = tid < TILE ? 0 : HALF, k1 = tid < TILE ? HALF : K;
    unsigned mask = 0u;  // K <= 32: this thread's bits, reduced once
    for (int k = k0; k < k1; ++k) {
      const int idx = rb_tiles[((size_t)t * K + k) * TILE + i];
      const int local = idx - starts[(k / GSPAN) * n_tiles + t] * UNIT;
      const bool ok = idx < m && local >= 0 && local < win;
      idx_s[k * TILE + i] = ok ? idx : -1;
      if constexpr (WORDS == 1) {
        mask |= (unsigned)ok << k;
      } else if (__any_sync(0xffffffffu, ok) && lane == 0) {
        atomicOr(live_s + (k >> 5), 1u << (k & 31));
      }
    }
    if constexpr (WORDS == 1) {
      mask = __reduce_or_sync(0xffffffffu, mask);
      if (lane == 0 && mask) atomicOr(live_s, mask);
    }
  }
  __syncthreads();
  int n_live = 0;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) n_live += __popc(live_s[w]);
  const int n_stages = n_live * n_chunks;

  // stage (k, c) into ring buffer buf: the gathered A rows and W's piece
  auto issue = [&](int k, int c, int buf) {
    unsigned char* a_dst = smem + buf * STAGE;
    const int* idx_k = idx_s + k * TILE;
    if (VEC) {
      for (int e = tid; e < TILE * 4; e += THREADS) {
        const int r = e >> 2;
        const int byte = c * CHUNK_BYTES + (e & 3) * 16;
        const int idx = idx_k[r];
        const bool ok = idx >= 0 && byte < row_bytes;
        cp_async16(a_dst + r * A_PITCH + (e & 3) * 16,
                   ok ? feats + (size_t)idx * row_bytes + byte : feats,
                   ok ? 16 : 0);
      }
    } else {
      // every load of the stage issued before the first store
      using E = typename std::conditional<BF16, unsigned short, float>::type;
      constexpr int PER = TILE * KC / THREADS;
      E v[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = tid + j * THREADS;
        const int cc = c * KC + e % KC;
        const int idx = idx_k[e / KC];
        v[j] = idx >= 0 && cc < cin
                   ? reinterpret_cast<const E*>(feats)[(size_t)idx * cin + cc]
                   : E(0);
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = tid + j * THREADS;
        reinterpret_cast<E*>(a_dst + (e / KC) * A_PITCH)[e % KC] = v[j];
      }
    }
    const uint4* src =
        wf + ((size_t)(blockIdx.y * K + k) * n_chunks + c) * (B_BYTES / 16);
    uint4* dst = reinterpret_cast<uint4*>(a_dst + A_BYTES);
    for (int e = tid; e < B_BYTES / 16; e += THREADS) {
      cp_async16(dst + e, src + e);
    }
  };

  float acc[2][NTW][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  // ldmatrix lane address: matrix j = lane / 8 is (rows 8 * (j & 1), bytes
  // 16 * (j >> 1)) of a 16-row, 32-byte k-step
  const uint32_t a_lane = (32 * wm + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                              A_PITCH + 16 * (lane >> 4);

  auto compute = [&](int buf) {
    const unsigned char* stage = smem + buf * STAGE;
    const uint32_t a_addr = smem_u32(stage) + a_lane;
    uint32_t a[2][2][4];  // [k-step][m-tile]
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[ks][mi], a_addr + mi * 16 * A_PITCH + ks * 32);
    const uint4* bw = reinterpret_cast<const uint4*>(stage + A_BYTES);
    if (BF16) {
#pragma unroll
      for (int p = 0; p < NTW / 2; ++p) {
        uint4 b[2][3];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int piece = 0; piece < 3; ++piece)
            b[ks][piece] =
                bw[((ks * 3 + piece) * (NS / 16) + wn * (NTW / 2) + p) * 32 +
                   lane];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            // the stage's six mma into a fresh fragment, then one rounded add
            float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
#pragma unroll
              for (int piece = 2; piece >= 0; --piece)
                mma_bf16(part, a[ks][mi], h ? b[ks][piece].z : b[ks][piece].x,
                         h ? b[ks][piece].w : b[ks][piece].y);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][2 * p + h][e] += part[e];
          }
        }
      }
    } else {
      uint32_t ahi[2][2][4], alo[2][2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(a[ks][mi][e]), ahi[ks][mi][e],
                       alo[ks][mi][e]);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        uint4 b[2];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          b[ks] = bw[(ks * (NS / 8) + wn * NTW + nt) * 32 + lane];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            mma_tf32(part, alo[ks][mi], b[ks].x, b[ks].y);
            mma_tf32(part, ahi[ks][mi], b[ks].z, b[ks].w);
            mma_tf32(part, ahi[ks][mi], b[ks].x, b[ks].y);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nt][e] += part[e];
        }
      }
    }
  };

  // stages in order: offsets in the mask ascending (word w, its bits
  // left in `rest`), chunks within each
  int w = 0;
  unsigned rest = live_s[0];
  auto next_offset = [&]() {
    while (rest == 0u && w + 1 < WORDS) rest = live_s[++w];
    return rest ? 32 * w + __ffs(rest) - 1 : 0;
  };
  int ik = next_offset(), ic = 0, issued = 0;
  auto issue_next = [&]() {
    if (issued < n_stages) {
      issue(ik, ic, issued % STAGES);
      if (++ic == n_chunks) {
        ic = 0;
        rest &= rest - 1;
        ik = next_offset();
      }
      ++issued;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue_next();
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    issue_next();     // into stage s - 1's buffer
    compute(s % STAGES);
  }
  cp_async_wait<0>();

  const int g = lane >> 2, tq = lane & 3;
  const bool pairs = (cout & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float* orow = out + ((size_t)t * TILE + 32 * wm + 16 * mi + 8 * hr + g) *
                              cout;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int col = blockIdx.y * NS + wn * (NS / 2) + nt * 8 + 2 * tq;
        const float v0 = acc[mi][nt][2 * hr], v1 = acc[mi][nt][2 * hr + 1];
        if (pairs && col + 1 < cout) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          if (col < cout) orow[col] = v0;
          if (col + 1 < cout) orow[col + 1] = v1;
        }
      }
    }
  }
}

// Columns of one slice: Cout rounded up to 32, in as few slices of at most
// MAX_NS as hold it, each rounded up to 32.
int slice_cols(int cout) {
  const int np = (cout + 31) / 32 * 32;
  const int slices = (np + MAX_NS - 1) / MAX_NS;
  return ((np + slices - 1) / slices + 31) / 32 * 32;
}

int n_slices(int cout) {
  const int ns = slice_cols(cout);
  return (cout + ns - 1) / ns;
}

int n_chunks(int cin, int bf16) {
  return (cin * (bf16 ? 2 : 4) + CHUNK_BYTES - 1) / CHUNK_BYTES;
}

size_t workspace_bytes(int k, int cin, int cout, int bf16) {
  return (size_t)n_slices(cout) * k * n_chunks(cin, bf16) *
         b_bytes(bf16 != 0, slice_cols(cout));
}

// what a GEMM instance reads and writes
struct GemmArgs {
  const int32_t* rb_tiles;  // or the z-band anchors
  const int32_t* starts;
  const char* feats;  // or zq
  const uint4* wf;
  float* out;
  int n_tiles, cin, cout, m, win;
};

template <int K, int GSPAN, int UNIT, bool BF16, int NS, bool VEC>
cudaError_t launch_gemm(const GemmArgs& a, cudaStream_t stream) {
  auto kernel = &band_conv_kernel<K, GSPAN, UNIT, BF16, NS, VEC>;
  const size_t smem = smem_bytes(BF16, NS, K);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_tiles, n_slices(a.cout));
  kernel<<<grid, THREADS, smem, stream>>>(a.rb_tiles, a.starts, a.feats,
                                          a.wf, a.out, a.n_tiles, a.cin,
                                          a.cout, a.m, a.win,
                                          n_chunks(a.cin, BF16));
  return cudaGetLastError();
}

// rows of a multiple of 16 bytes take cp.async; the others (the stem's 7
// channels) a kernel of their own, so the vector path holds no registers
// for element staging
template <int K, int GSPAN, int UNIT, bool BF16, int NS>
cudaError_t launch_vec(const GemmArgs& a, int vec, cudaStream_t s) {
  return vec ? launch_gemm<K, GSPAN, UNIT, BF16, NS, true>(a, s)
             : launch_gemm<K, GSPAN, UNIT, BF16, NS, false>(a, s);
}

template <int K, int GSPAN, int UNIT, bool BF16>
cudaError_t launch_ns(const GemmArgs& a, int vec, cudaStream_t s) {
  switch (slice_cols(a.cout)) {
    case 32:
      return launch_vec<K, GSPAN, UNIT, BF16, 32>(a, vec, s);
    case 64:
      return launch_vec<K, GSPAN, UNIT, BF16, 64>(a, vec, s);
    case 96:
      return launch_vec<K, GSPAN, UNIT, BF16, 96>(a, vec, s);
    default:
      return launch_vec<K, GSPAN, UNIT, BF16, MAX_NS>(a, vec, s);
  }
}

template <int K, int GSPAN, int UNIT>
cudaError_t launch_instance(const GemmArgs& a, int bf16, int vec,
                            cudaStream_t s) {
  return bf16 ? launch_ns<K, GSPAN, UNIT, true>(a, vec, s)
              : launch_ns<K, GSPAN, UNIT, false>(a, vec, s);
}

// The weight split of `weights` (k, cin, cout) into `workspace`, then the
// GEMM instance `gemm`; returns the CUDA error code (0 = ok)
int launch(GemmArgs a, const void* weights, void* workspace, int k,
           int bf16,
           cudaError_t (*gemm)(const GemmArgs&, int, int, cudaStream_t),
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* wf = static_cast<uint4*>(workspace);
  a.wf = wf;
  const int row_bytes = a.cin * (bf16 ? 2 : 4);
  const int vec =
      row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(a.feats) % 16 == 0;
  const int total = (int)(workspace_bytes(k, a.cin, a.cout, bf16) / 16);
  split_weights_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(weights), wf, k, a.cin, a.cout,
      n_chunks(a.cin, bf16), slice_cols(a.cout), bf16, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gemm(a, bf16, vec, s);
}

}  // namespace

extern "C" {

// Bytes of the workspace band_conv_launch needs for the split weights.
size_t band_conv_workspace_bytes(int k, int cin, int cout, int feats_bf16) {
  return workspace_bytes(k, cin, cout, feats_bf16);
}

// Launches the weight split and the GEMM on `stream`; returns the CUDA
// error code (0 = ok). Takes K = 27 or 125; `win` must be a multiple of 64
// and every window [64 * starts, + win) must lie inside the n_tiles * 128
// feature rows, which build_band_plan guarantees. `workspace` holds
// band_conv_workspace_bytes and is 16-byte aligned.
int band_conv_launch(const void* rb_tiles, const void* starts,
                     const void* feats, int feats_bf16, const void* weights,
                     void* out, void* workspace, int n_tiles, int k, int cin,
                     int cout, int m, int win, void* stream) {
  if ((k != 27 && k != MAX_K) || cin < 1 || cout < 1 || win < 1 ||
      win % ALIGN != 0 || n_tiles < 1 ||
      reinterpret_cast<uintptr_t>(workspace) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const GemmArgs a{static_cast<const int32_t*>(rb_tiles),
                   static_cast<const int32_t*>(starts),
                   static_cast<const char*>(feats), nullptr,
                   static_cast<float*>(out), n_tiles, cin, cout, m, win};
  return launch(a, weights, workspace, k, feats_bf16,
                k == 27 ? &launch_instance<27, 3, ALIGN>
                        : &launch_instance<MAX_K, 5, ALIGN>,
                stream);
}

// Bytes of the workspace zband_conv_launch needs for the split weights.
size_t zband_conv_workspace_bytes(int groups, int e, int cout, int zq_bf16) {
  return workspace_bytes(groups, e, cout, zq_bf16);
}

// The z-band conv: `anchors` (n_tiles, G, 128) and `starts` (G, n_tiles)
// int32, zq (n_tiles * 128, e) bf16 or f32, w2 (G, e, cout) f32, out
// (n_tiles * 128, cout) f32. Launches the weight split and the GEMM on
// `stream`; returns the CUDA error code (0 = ok). Takes G = 9 or 25
// groups; `win` must be a multiple of 8 and m at most n_tiles * 128 (found
// anchors are rows of zq), which build_zband_plan guarantees. `workspace`
// holds zband_conv_workspace_bytes and is 16-byte aligned.
int zband_conv_launch(const void* anchors, const void* starts, const void* zq,
                      int zq_bf16, const void* w2, void* out,
                      void* workspace, int n_tiles, int groups, int e,
                      int cout, int m, int win, void* stream) {
  if ((groups != 9 && groups != 25) || e < 1 || cout < 1 || win < 1 ||
      win % ZALIGN != 0 || n_tiles < 1 || m > n_tiles * TILE ||
      reinterpret_cast<uintptr_t>(workspace) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const GemmArgs a{static_cast<const int32_t*>(anchors),
                   static_cast<const int32_t*>(starts),
                   static_cast<const char*>(zq), nullptr,
                   static_cast<float*>(out), n_tiles, e, cout, m, win};
  return launch(a, w2, workspace, groups, zq_bf16,
                groups == 9 ? &launch_instance<9, 1, ZALIGN>
                            : &launch_instance<25, 1, ZALIGN>,
                stream);
}

}  // extern "C"
