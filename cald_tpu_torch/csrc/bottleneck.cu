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
// and image at every R50 stage (the memory traffic is 2 x (B,H,W,C) per launch
// plus the weights, which stay in L2), plus the recompute of the 1x1 over the
// halo. The products are warp-level bf16 mma.sync m16n8k16 with f32
// accumulators (float32 runs the same fragment ownership on CUDA-core FMAs,
// for the tight checks). A-rows are addressed by pointer, one per pixel, so the
// same GEMM reads a haloed region of the global input, a shifted 3x3 window of
// y1 or z without copying, and a pixel outside the image is a null row (zero).
// Shared-memory rows are padded by 8 elements so that the 8 rows of a fragment
// fall in different banks. Not done yet: wgmma, TMA, staging the
// weights in shared memory, overlapping tiles.
//
// Layout: x and out (B, H, W, C) contiguous (channels-last NCHW); weights in
// the activation dtype, (out, in) per product: w1 (g, P, C), w2 (g, 9, P, P)
// with the tap (dy * 3 + dx) first, w3 (g, C, P); biases f32 b1 (g, P),
// b2 (g, P), b3 (g, C). Any C and P (C and P multiples of 16 take 32-bit
// loads), ragged tiles at the right and bottom edges, 64-bit offsets.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;              // shared-memory row pad, elements
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block

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
template <bool ALIGNED>
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* row, int k, int K) {
  if (row == nullptr) return 0u;
  if (ALIGNED) return *reinterpret_cast<const uint32_t*>(row + k);
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
template <bool ALIGNED>
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
      a[mi][0] = ld_pair<ALIGNED>(pa[mi * 2], k0 + 2 * t, K);
      a[mi][1] = ld_pair<ALIGNED>(pa[mi * 2 + 1], k0 + 2 * t, K);
      a[mi][2] = ld_pair<ALIGNED>(pa[mi * 2], k0 + 8 + 2 * t, K);
      a[mi][3] = ld_pair<ALIGNED>(pa[mi * 2 + 1], k0 + 8 + 2 * t, K);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint32_t b0 = ld_pair<ALIGNED>(pb[ni], k0 + 2 * t, K);
      const uint32_t b1 = ld_pair<ALIGNED>(pb[ni], k0 + 8 + 2 * t, K);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
    }
  }
}

// float32: the same accumulator ownership, CUDA-core FMAs in k order.
template <bool ALIGNED>
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
template <typename T, bool ALIGNED, class RowFn, class Epi>
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
      gemm_segment<ALIGNED>(acc, pa, B + (size_t)s * N * K, n0, N, K, lane);
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

size_t smem_bytes(int th, int tw, int g, int C, int P, size_t item) {
  const size_t inner = (size_t)(th + 2 * g - 2) * (tw + 2 * g - 2);
  const size_t x = g > 1 ? align16(inner * (C + kPad) * item) : 0;
  return x + align16((size_t)(th + 2 * g) * (tw + 2 * g) * (P + kPad) * item) +
         align16(inner * (P + kPad) * item);
}

template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kThreads) bottleneck_chain_kernel(Params p) {
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

    // phase 1: y1 over the input region, zero outside the image
    block_gemm<T, ALIGNED>(
        ri * ci, P, C, 1, w1,
        [&](int, int m) -> const T* {
          const int r = m / ci, c = m % ci, iy = iy0 + r, ix = ix0 + c;
          if (iy < 0 || iy >= H || ix < 0 || ix >= W) return nullptr;
          return j == 0 ? x + ((size_t)iy * W + ix) * C
                        : X + ((size_t)(r + j - 1) * cx + (c + j - 1)) * ldc;
        },
        [&](int m, int n, float v) {
          const int iy = iy0 + m / ci, ix = ix0 + m % ci;
          const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
          Y1[(size_t)m * ldp + n] = from_float<T>(in ? fmaxf(v + b1[n], 0.f) : 0.f);
        });
    __syncthreads();

    // phase 2: z, the 3x3 as 9 shifted products of y1
    block_gemm<T, ALIGNED>(
        ro * co, P, P, 9, w2,
        [&](int s, int m) -> const T* {
          const int r = m / co + s / 3, c = m % co + s % 3;
          return Y1 + ((size_t)r * ci + c) * ldp;
        },
        [&](int m, int n, float v) {
          Z[(size_t)m * ldp + n] = from_float<T>(fmaxf(v + b2[n], 0.f));
        });
    __syncthreads();

    // phase 3: the block output, in f32 until one rounding
    const bool last = j == g - 1;
    block_gemm<T, ALIGNED>(
        ro * co, C, P, 1, w3, [&](int, int m) -> const T* { return Z + (size_t)m * ldp; },
        [&](int m, int n, float v) {
          const int r = m / co, c = m % co, iy = iy0 + 1 + r, ix = ix0 + 1 + c;
          if (iy < 0 || iy >= H || ix < 0 || ix >= W) return;
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
  if (dtype == 0)
    return (int)(al ? launch<float, true>(p, smem, s) : launch<float, false>(p, smem, s));
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
