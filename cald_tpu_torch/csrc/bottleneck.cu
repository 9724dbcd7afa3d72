// Fused stride-1 ResNet bottlenecks for Hopper (sm_90a), frozen norms folded
// into the convs: 1x1 (C->P) + b1, ReLU -> 3x3 (P->P, zero "SAME") + b2, ReLU
// -> 1x1 (P->C) + b3 + identity, ReLU. Inference only (no backward).
//
// K5, entry cald_bottleneck_block, replaces cald_tpu/ops/pallas_bottleneck.py::
// _block_kernel: one block per launch. K6, entry cald_bottleneck_stage,
// replaces cald_tpu/ops/pallas_bottleneck.py::_stage_kernel: g chained blocks
// per launch, every inter-block activation kept in shared memory. Both are
// the one kernel below, bottleneck_chain_kernel; K5 is K6 with g = 1. The TPU
// formulation does not carry over: no ring-padded ping-pong buffers, no
// aliased outputs, no 8-column alignment pads, no DMA semaphores. Each thread
// block owns one (image, th x tw output tile), reads the input with a
// g-pixel halo straight from global memory (L2), and writes only its tile's
// interior to a separate output, so neighbouring tiles can read the input's
// halo while others write.
//
// Per chained block j of a thread block, with the input region of block j
// the tile plus (g - j) pixels on each side:
//   phase 1  y1 = relu(x . w1 + b1) over the input region, 0 where the pixel
//            lies outside the IMAGE (not the tile: after block 0 the halo of an
//            intermediate holds non-zero values outside the image), rounded to
//            the activation dtype into shared memory;
//   phase 2  z = relu(sum over 9 taps of shifted y1 . w2[tap] + b2) over the
//            region one pixel smaller, rounded into shared memory;
//   phase 3  relu(z . w3 + b3 + x) in f32, rounded once, written to the output
//            (last block) or back into the shared activation buffer in place
//            (each element is read as the identity and written by one thread).
// x comes from global memory for block 0 and from shared memory after.
//
// What bounds it on the H100: the three products, about 5.7 GFLOP per block
// and image at every R50 stage: 548 GFLOP over R50's four stride-1 suffixes
// (12 blocks) at B=8 on the 640x1024 canvas, 0.5537 ms at 989 TFLOP/s bf16
// (the memory traffic, 2 x (B,H,W,C) per launch plus the weights, is far
// below that), plus the recompute of the 1x1 over the halo. The products are
// warp-level bf16 mma.sync m16n8k16 with f32 accumulators.
//
// The bf16 path (C and P multiples of 16, every pointer 16-byte aligned) is a
// thread-block GEMM with its operands in shared memory. What it does about
// the three things that held the pointer-row version at 4% of the bound:
//   - no staging: each product's weights (B) are staged in k-slabs of 64
//     through a ring of kStages shared-memory stages by 16-byte cp.async.cg
//     copies, slab q + kStages - 1 issued before slab q is multiplied; block
//     0's input rides in the same ring, a k-slab of the haloed x rows beside
//     each weight slab, zero-filled by cp.async's src-size 0 outside the
//     image (a whole haloed x tile does not fit beside y1 and z at C =
//     1024-2048). Fragments of A (x, y1's shifted 3x3 windows, z, the chained
//     activation) and B are loaded with ldmatrix.x4 from rows padded by 8
//     elements (16 bytes), which puts the 8 rows of each 8x8 matrix in
//     distinct banks. Two stages measured faster than 3 or 4 on the H100:
//     the shared memory buys larger tiles and two blocks per SM instead;
//   - weights re-read per warp tile: all 8 warps multiply each slab, so a CTA
//     reads each weight once per (M tile, N tile) of a product. The warps'
//     layout (1x8 .. 8x1 warps of 32x32) is chosen per product so that it
//     takes the fewest tile passes, and of those the fewest M tiles; a pass's
//     row addresses are formed once, a slab's by a cursor without divisions;
//   - small tiles at the deep stages: the tile plan (ops/bottleneck.py,
//     MEASURED_TILES) is the fastest measured per R50 stage, 8x16 and 8x8 at
//     two blocks per SM for layer1 and layer2, 8x4 for layer3 and 8x8 (96
//     blocks, one per SM) for layer4, whose blocks each stream all 8.9 MB of
//     a block's weights from L2, so fewer, larger tiles win.
// float32 (the tight checks) and bf16 with ragged C/P or unaligned pointers
// keep the pointer-row GEMM: A rows addressed by pointer, one per pixel, read
// straight from global or shared memory with CUDA-core FMAs (f32) or mma.sync
// on element loads (bf16), a pixel outside the image a null row (zero). The
// launcher chooses the path. Not done yet: wgmma, TMA with an mbarrier ring,
// clusters multicasting the deep stages' weights.
//
// Layout: x and out (B, H, W, C) contiguous (channels-last NCHW); weights in
// the activation dtype, (out, in) per product: w1 (g, P, C), w2 (g, 9, P, P)
// with the tap (dy * 3 + dx) first, w3 (g, C, P); biases f32 b1 (g, P),
// b2 (g, P), b3 (g, C). Any C and P, ragged tiles at the right and bottom
// edges, 64-bit offsets.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;              // shared-memory row pad, elements
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block
// the bf16 path's ring: kStages stages of kRingRows rows of kBK (+ pad) k;
// a stage holds a product's B tile, and in phase 1 of block 0 its A tile
constexpr int kBK = 64;
constexpr int kLds = kBK + kPad;     // 144 bytes: 8 rows in distinct banks
constexpr int kStages = 2;
constexpr int kMI = 2;               // 16-row fragments of a warp tile
constexpr int kNI = 4;               // 8-column fragments of a warp tile
constexpr int kWarpN = 8 * kNI;      // columns of a warp tile
constexpr int kRingRows = 192;       // fits a 2 x 4 warp layout's A and B tiles
constexpr int kARows = 128;          // the largest A tile staged through the ring
constexpr size_t kRingBytes = (size_t)kStages * kRingRows * kLds * sizeof(__nv_bfloat16);
static_assert(kRingRows >= 2 * 16 * kMI + kWarps / 2 * kWarpN, "no warp layout fits the ring");

struct Params {
  const void* x;
  void* out;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const void* w3;
  const float* b3;
  int B, H, W, C, P, th, tw, g, tiles_w;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Elements k, k + 1 of a row as one packed pair (k lowest); 0 past K or for a
// null row.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* row, int k, int K) {
  if (row == nullptr) return 0u;
  const uint32_t lo = k < K ? __bfloat16_as_ushort(row[k]) : 0u;
  const uint32_t hi = k + 1 < K ? __bfloat16_as_ushort(row[k + 1]) : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's 32x32 output tile, one K segment: acc[mi][ni][e] += sum_k
// A[row][k] * B[col][k] with row = mi * 16 + (e >> 1) * 8 + lane / 4 and
// col = n0 + ni * 8 + 2 * (lane % 4) + (e & 1) (the m16n8 accumulator layout).
// pa[mi * 2 + h] is the A row mi * 16 + h * 8 + lane / 4; b is [N][K].
__device__ __forceinline__ void gemm_segment(float (&acc)[2][4][4],
                                             const __nv_bfloat16* const* pa,
                                             const __nv_bfloat16* b, int n0, int N, int K,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* pb[4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + ni * 8 + g;
    pb[ni] = n < N ? b + (size_t)n * K : nullptr;
  }
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      a[mi][0] = ld_pair(pa[mi * 2], k0 + 2 * t, K);
      a[mi][1] = ld_pair(pa[mi * 2 + 1], k0 + 2 * t, K);
      a[mi][2] = ld_pair(pa[mi * 2], k0 + 8 + 2 * t, K);
      a[mi][3] = ld_pair(pa[mi * 2 + 1], k0 + 8 + 2 * t, K);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint32_t b0 = ld_pair(pb[ni], k0 + 2 * t, K);
      const uint32_t b1 = ld_pair(pb[ni], k0 + 8 + 2 * t, K);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
    }
  }
}

// float32: the same accumulator ownership, CUDA-core FMAs in k order.
__device__ __forceinline__ void gemm_segment(float (&acc)[2][4][4], const float* const* pa,
                                             const float* b, int n0, int N, int K, int lane) {
  const int t = lane & 3;
  const float* pb[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + ni * 8 + 2 * t + c;
      pb[ni][c] = n < N ? b + (size_t)n * K : nullptr;
    }
  for (int k = 0; k < K; ++k) {
    float a[4], bv[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = pa[i] ? pa[i][k] : 0.f;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) bv[ni][c] = pb[ni][c] ? pb[ni][c][k] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][ni][e] = fmaf(a[mi * 2 + (e >> 1)], bv[ni][e & 1], acc[mi][ni][e]);
  }
}

// out[m][n] = epi(m, n, sum over segments s and k of A_s[m][k] * B[s][n][k]),
// M x N split into 32x32 warp tiles. arow(s, m) gives row m of segment s's A
// (nullptr for a zero row); B is [nseg][N][K].
template <typename T, class RowFn, class Epi>
__device__ __forceinline__ void block_gemm(int M, int N, int K, int nseg, const T* B,
                                           RowFn arow, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = (M + 31) / 32, nt = (N + 31) / 32;
  for (int tile = warp; tile < mt * nt; tile += kWarps) {
    const int m0 = (tile % mt) * 32, n0 = (tile / mt) * 32;
    float acc[2][4][4] = {};
    for (int s = 0; s < nseg; ++s) {
      const T* pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + (i >> 1) * 16 + (i & 1) * 8 + g;
        pa[i] = m < M ? arow(s, m) : nullptr;
      }
      gemm_segment(acc, pa, B + (size_t)s * N * K, n0, N, K, lane);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + mi * 16 + (e >> 1) * 8 + g;
          const int n = n0 + ni * 8 + 2 * t + (e & 1);
          if (m < M && n < N) epi(m, n, acc[mi][ni][e]);
        }
  }
}

// ------------------- the bf16 path: operands in shared memory -------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; src_size 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The CTA tile of one product: wm x (kWarps / wm) warps of 16 * kMI x kWarpN.
struct Tiling {
  int wm, bm, bn, mt, nt;
};

// The layout whose tiles fit a ring stage (the B tile, and with a_global
// the A tile, at most kARows rows, beside it) with the fewest tile passes,
// of those the fewest M tiles.
__device__ __forceinline__ Tiling choose_tiling(int M, int N, bool a_global) {
  Tiling best{0, 0, 0, 0, 0};
  int passes = 0x7fffffff;
  for (int wm = kWarps; wm >= 1; wm >>= 1) {
    const int bm = wm * 16 * kMI, bn = (kWarps / wm) * kWarpN;
    if (bn + (a_global ? bm : 0) > kRingRows || (a_global && bm > kARows)) continue;
    const int mt = (M + bm - 1) / bm, nt = (N + bn - 1) / bn;
    if (mt * nt < passes) {
      best = Tiling{wm, bm, bn, mt, nt};
      passes = mt * nt;
    }
  }
  return best;
}

// epi(m, n, v[n], v[n + 1]) over M x N (N even) of sum over segments s and k
// of A_s[m][k] * B[s][n][k], B [nseg][N][K] in global memory, K a multiple of
// 16. Without A_GLOBAL, row m < M of segment s is arow(m) + seg_off(s) in
// shared memory (16-byte aligned); with it (nseg = 1), arow(m) is a global
// row or nullptr (a zero row), staged through the ring beside the weights.
// Every thread of the block calls it; it ends with the ring drained and a
// __syncthreads.
template <bool A_GLOBAL, class RowFn, class SegFn, class Epi>
__device__ __forceinline__ void staged_gemm(int M, int N, int K, int nseg,
                                            const __nv_bfloat16* B, __nv_bfloat16* ring,
                                            RowFn arow, SegFn seg_off, Epi epi) {
  using bf16 = __nv_bfloat16;
  constexpr int kChunks = kBK / 8;                    // 16-byte chunks of a slab row
  constexpr int kAPer = kARows * kChunks / kThreads;  // A chunks a thread copies
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Tiling L = choose_tiling(M, N, A_GLOBAL);
  const int kslabs = (K + kBK - 1) / kBK, nslab = nseg * kslabs, total = L.mt * L.nt * nslab;
  const int wm0 = (warp % L.wm) * 16 * kMI, wn0 = (warp / L.wm) * kWarpN;  // in the tile

  // a cursor over the slabs: a pass's nslab slabs (k, then segment), then
  // the next M tile, then the next N tile
  struct Cursor {
    int m0, n0, seg, k0, stage, count;
  };
  auto advance = [&](Cursor& c) {
    c.stage = c.stage + 1 == kStages ? 0 : c.stage + 1;
    if (++c.count == nslab) {  // the next pass
      c.count = c.seg = c.k0 = 0;
      c.m0 += L.bm;
      if (c.m0 < L.mt * L.bm) return;
      c.m0 = 0;
      c.n0 += L.bn;
      return;
    }
    c.k0 += kBK;
    if (c.k0 < K) return;
    c.k0 = 0;
    ++c.seg;
  };

  Cursor in{0, 0, 0, 0, 0, 0};
  const bf16* arows[kAPer];  // A_GLOBAL: the rows this thread copies in the current pass
  auto issue = [&](int q) {
    if (q < total) {
      bf16* dst = ring + (size_t)in.stage * kRingRows * kLds;
      const bf16* src = B + (size_t)in.seg * N * K;
      for (int i = threadIdx.x; i < L.bn * kChunks; i += kThreads) {
        const int r = i / kChunks, k = in.k0 + (i % kChunks) * 8, n = in.n0 + r;
        const bool ok = n < N && k < K;
        cp_async16(dst + r * kLds + k - in.k0, ok ? src + (size_t)n * K + k : src, ok);
      }
      if constexpr (A_GLOBAL) {
#pragma unroll
        for (int j = 0; j < kAPer; ++j) {
          const int i = threadIdx.x + j * kThreads, r = i / kChunks, c = (i % kChunks) * 8;
          if (in.count == 0) arows[j] = r < L.bm && in.m0 + r < M ? arow(in.m0 + r) : nullptr;
          if (r < L.bm) {
            const bool ok = arows[j] != nullptr && in.k0 + c < K;
            cp_async16(dst + (L.bn + r) * kLds + c, ok ? arows[j] + in.k0 + c : src, ok);
          }
        }
      }
      advance(in);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  float acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  Cursor out{0, 0, 0, 0, 0, 0};
  const bf16* pa[kMI];  // this lane's ldmatrix rows of the current pass
  bool busy = false;
  const int boff = (wn0 + (lane & 7) + ((lane >> 4) << 3)) * kLds + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < total; ++q) {
    cp_async_wait<kStages - 2>();  // slab q has landed (this thread's copies)
    __syncthreads();               // everyone's copies, and slab q - 1 is consumed
    issue(q + kStages - 1);        // into slab q - 1's stage
    const bf16* st = ring + (size_t)out.stage * kRingRows * kLds;
    if (out.count == 0) {  // a new pass
      busy = out.m0 + wm0 < M && out.n0 + wn0 < N;
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const int r = wm0 + mi * 16 + (lane & 15);
        if constexpr (A_GLOBAL)
          pa[mi] = ring + (size_t)(L.bn + r) * kLds + (lane >> 4) * 8;  // stage 0's
        else
          pa[mi] = arow(min(out.m0 + r, M - 1)) + (lane >> 4) * 8;
      }
    }
    if (busy) {
      const bf16* a_at[kMI];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
        a_at[mi] = A_GLOBAL ? pa[mi] + (size_t)out.stage * kRingRows * kLds
                            : pa[mi] + seg_off(out.seg) + out.k0;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        if (out.k0 + kk < K) {
          uint32_t a[kMI][4], b[kNI][2];
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi) ldmatrix_x4(a[mi], a_at[mi] + kk);
#pragma unroll
          for (int nj = 0; nj < kNI / 2; ++nj) {
            uint32_t r[4];
            ldmatrix_x4(r, st + boff + nj * 16 * kLds + kk);
            b[2 * nj][0] = r[0];
            b[2 * nj][1] = r[1];
            b[2 * nj + 1][0] = r[2];
            b[2 * nj + 1][1] = r[3];
          }
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
            for (int ni = 0; ni < kNI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }
      }
    }
    if (out.count == nslab - 1) {  // the pass's last slab: its epilogue
      const int m0 = out.m0 + wm0, n0 = out.n0 + wn0;
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + mi * 16 + h * 8 + g, n = n0 + ni * 8 + 2 * t;
            if (busy && m < M && n < N) epi(m, n, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
        }
    }
    advance(out);
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ float2 ld_pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The block's dynamic shared memory: [x (g > 1)] [y1] [z] [ring (bf16)].
size_t smem_bytes(int th, int tw, int g, int C, int P, size_t item) {
  const size_t inner = (size_t)(th + 2 * g - 2) * (tw + 2 * g - 2);
  const size_t x = g > 1 ? align16(inner * (C + kPad) * item) : 0;
  return x + align16((size_t)(th + 2 * g) * (tw + 2 * g) * (P + kPad) * item) +
         align16(inner * (P + kPad) * item) +
         (item == sizeof(__nv_bfloat16) ? kRingBytes : 0);
}

template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 2) bottleneck_chain_kernel(Params p) {
  // bf16 with C, P multiples of 16 and 16-byte aligned pointers: operands in
  // shared memory (staged_gemm); else the pointer-row GEMM (block_gemm)
  constexpr bool kStaged = ALIGNED && std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int th = p.th, tw = p.tw, g = p.g, C = p.C, P = p.P, H = p.H, W = p.W;
  const int ldc = C + kPad, ldp = P + kPad;
  const int ty0 = (int)(blockIdx.x / p.tiles_w) * th;
  const int tx0 = (int)(blockIdx.x % p.tiles_w) * tw;
  const int cx = tw + 2 * g - 2;  // width of the inter-block activation area
  T* X = reinterpret_cast<T*>(smem);
  size_t off = g > 1 ? align16((size_t)(th + 2 * g - 2) * cx * ldc * sizeof(T)) : 0;
  T* Y1 = reinterpret_cast<T*>(smem + off);
  off += align16((size_t)(th + 2 * g) * (tw + 2 * g) * ldp * sizeof(T));
  T* Z = reinterpret_cast<T*>(smem + off);
  off += align16((size_t)(th + 2 * g - 2) * cx * ldp * sizeof(T));
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + off);
  const size_t image = (size_t)blockIdx.y * H * W * C;
  const T* x = static_cast<const T*>(p.x) + image;
  T* out = static_cast<T*>(p.out) + image;

  for (int j = 0; j < g; ++j) {
    const int ri = th + 2 * (g - j), ci = tw + 2 * (g - j);  // block j's input region
    const int ro = ri - 2, co = ci - 2;                      // and its output region
    const int iy0 = ty0 - g + j, ix0 = tx0 - g + j;          // input origin in the image
    const T* w1 = static_cast<const T*>(p.w1) + (size_t)j * P * C;
    const T* w2 = static_cast<const T*>(p.w2) + (size_t)j * 9 * P * P;
    const T* w3 = static_cast<const T*>(p.w3) + (size_t)j * C * P;
    const float* b1 = p.b1 + (size_t)j * P;
    const float* b2 = p.b2 + (size_t)j * P;
    const float* b3 = p.b3 + (size_t)j * C;
    const bool last = j == g - 1;
    auto inside = [=](int iy, int ix) { return iy >= 0 && iy < H && ix >= 0 && ix < W; };
    // phase 1's A: block 0 reads x (nullptr outside the image), later blocks
    // the chained activation (outside the image its rows are masked by the
    // epilogue, so any row will do)
    auto x_row = [=](int m) -> const T* {
      const int iy = iy0 + m / ci, ix = ix0 + m % ci;
      return inside(iy, ix) ? x + ((size_t)iy * W + ix) * C : nullptr;
    };
    auto act_row = [=](int m) -> const T* {
      return X + ((size_t)(m / ci + j - 1) * cx + (m % ci + j - 1)) * ldc;
    };
    // phase 2's A: tap s of the 3x3 is y1 shifted by (s / 3, s % 3)
    auto y1_row = [=](int m) -> const T* { return Y1 + ((size_t)(m / co) * ci + m % co) * ldp; };
    auto tap = [=](int s) { return ((s / 3) * ci + s % 3) * ldp; };
    auto z_row = [=](int m) -> const T* { return Z + (size_t)m * ldp; };

    if constexpr (kStaged) {
      auto none = [](int) { return 0; };
      // phase 1: y1 over the input region, zero outside the image
      auto epi1 = [=](int m, int n, float v0, float v1) {
        const bool in = inside(iy0 + m / ci, ix0 + m % ci);
        st_pair(Y1 + (size_t)m * ldp + n, in ? fmaxf(v0 + b1[n], 0.f) : 0.f,
                in ? fmaxf(v1 + b1[n + 1], 0.f) : 0.f);
      };
      if (j == 0)
        staged_gemm<true>(ri * ci, P, C, 1, w1, ring, x_row, none, epi1);
      else
        staged_gemm<false>(ri * ci, P, C, 1, w1, ring, act_row, none, epi1);
      // phase 2: z, the 3x3 as 9 shifted products of y1
      staged_gemm<false>(ro * co, P, P, 9, w2, ring, y1_row, tap,
                         [=](int m, int n, float v0, float v1) {
                           st_pair(Z + (size_t)m * ldp + n, fmaxf(v0 + b2[n], 0.f),
                                   fmaxf(v1 + b2[n + 1], 0.f));
                         });
      // phase 3: the block output, in f32 until one rounding
      staged_gemm<false>(
          ro * co, C, P, 1, w3, ring, z_row, none, [=](int m, int n, float v0, float v1) {
            const int r = m / co, c = m % co, iy = iy0 + 1 + r, ix = ix0 + 1 + c;
            if (!inside(iy, ix)) return;
            T* shared = X + ((size_t)(r + j) * cx + (c + j)) * ldc + n;
            const size_t at = ((size_t)iy * W + ix) * C + n;
            const float2 id = ld_pair_f(j == 0 ? x + at : shared);
            st_pair(last ? out + at : shared, fmaxf(v0 + b3[n] + id.x, 0.f),
                    fmaxf(v1 + b3[n + 1] + id.y, 0.f));
          });
    } else {
      // phase 1: y1 over the input region, zero outside the image
      block_gemm<T>(
          ri * ci, P, C, 1, w1,
          [&](int, int m) -> const T* {
            if (j == 0) return x_row(m);
            return inside(iy0 + m / ci, ix0 + m % ci) ? act_row(m) : nullptr;
          },
          [&](int m, int n, float v) {
            const bool in = inside(iy0 + m / ci, ix0 + m % ci);
            Y1[(size_t)m * ldp + n] = from_float<T>(in ? fmaxf(v + b1[n], 0.f) : 0.f);
          });
      __syncthreads();

      // phase 2: z, the 3x3 as 9 shifted products of y1
      block_gemm<T>(
          ro * co, P, P, 9, w2, [&](int s, int m) -> const T* { return y1_row(m) + tap(s); },
          [&](int m, int n, float v) {
            Z[(size_t)m * ldp + n] = from_float<T>(fmaxf(v + b2[n], 0.f));
          });
      __syncthreads();

      // phase 3: the block output, in f32 until one rounding
      block_gemm<T>(
          ro * co, C, P, 1, w3, [&](int, int m) { return z_row(m); },
          [&](int m, int n, float v) {
            const int r = m / co, c = m % co, iy = iy0 + 1 + r, ix = ix0 + 1 + c;
            if (!inside(iy, ix)) return;
            T* shared = X + ((size_t)(r + j) * cx + (c + j)) * ldc + n;
            const size_t at = ((size_t)iy * W + ix) * C + n;
            const float id = to_float(j == 0 ? x[at] : *shared);
            const T o = from_float<T>(fmaxf(v + b3[n] + id, 0.f));
            if (last)
              out[at] = o;
            else
              *shared = o;
          });
      __syncthreads();
    }
  }
}

template <typename T, bool ALIGNED>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = bottleneck_chain_kernel<T, ALIGNED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (p.H + p.th - 1) / p.th;
  kernel<<<dim3((unsigned)(tiles_h * p.tiles_w), (unsigned)p.B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

int run(const void* x, void* out, const void* w1, const float* b1, const void* w2,
        const float* b2, const void* w3, const float* b3, int B, int H, int W, int C, int P,
        int th, int tw, int g, int dtype, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || P < 1 || th < 1 || tw < 1 || g < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t item = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const size_t smem = smem_bytes(th, tw, g, C, P, item);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p{x, out, w1, b1, w2, b2, w3, b3, B, H, W, C, P, th, tw, g, (W + tw - 1) / tw};
  const bool al = C % 16 == 0 && P % 16 == 0 && aligned16(x) && aligned16(out) &&
                  aligned16(w1) && aligned16(w2) && aligned16(w3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, false>(p, smem, s);  // f32 has one path
  return (int)(al ? launch<__nv_bfloat16, true>(p, smem, s)
                  : launch<__nv_bfloat16, false>(p, smem, s));
}

}  // namespace

// K5: one folded block (weights with g = 1).
extern "C" int cald_bottleneck_block(const void* x, void* out, const void* w1,
                                     const float* b1, const void* w2, const float* b2,
                                     const void* w3, const float* b3, int B, int H, int W,
                                     int C, int P, int th, int tw, int dtype, void* stream) {
  return run(x, out, w1, b1, w2, b2, w3, b3, B, H, W, C, P, th, tw, 1, dtype, stream);
}

// K6: g chained folded blocks (weights stacked over g).
extern "C" int cald_bottleneck_stage(const void* x, void* out, const void* w1,
                                     const float* b1, const void* w2, const float* b2,
                                     const void* w3, const float* b3, int B, int H, int W,
                                     int C, int P, int th, int tw, int g, int dtype,
                                     void* stream) {
  return run(x, out, w1, b1, w2, b2, w3, b3, B, H, W, C, P, th, tw, g, dtype, stream);
}
