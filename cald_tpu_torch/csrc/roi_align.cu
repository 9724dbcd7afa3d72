// Multi-scale RoIAlign for Hopper (sm_90a): the inference forward, the
// training forward, the training backward and the grouped training forward.
//
// Every kernel here computes torchvision MultiScaleRoIAlign with
// aligned=False in proposal order, but none carries over the TPU
// formulations: there is no level-sorted slot plan, no full-level matmul and
// no DMA window. Each block reads only the level pixels its rois tap, so
// every roi is exact, however wide (the TPU's training window clamps rois
// wider than 48x56 at their level).
//
// The pooled taps. Along one axis, output bin o of a roi has sr samples; each
// puts 1 - frac on its low pixel and frac on the next. pooled_taps gives the
// bin's 2 * sr taps (pixel, weight): the weight on a pixel is the mean over
// the bin's samples of their weights there, carried by the pixel's first
// tap (0 on the others), 0 outside the level. A bin's output is then
//   out[y, x] = sum_k sum_j wy[y, k] * wx[x, j] * F[row_k, col_j],
// which equals the mean over the bin's sr * sr samples of their four
// bilinear corners exactly in real arithmetic, and to float32 rounding on
// the card. The sample positions keep the plain version's explicit
// roundings (sample_pos).
//
// K1, entry cald_roi_align_fwd, replaces cald_tpu/ops/flm_roi_align.py::
// _flm_kernel (the default inference RoIAlign of the CALD scoring path),
// output in the feature dtype. K2, entry cald_roi_align_train_fwd, replaces
// cald_tpu/ops/pallas_roi_align.py::_roi_kernel (the training forward),
// float32 output whatever the feature dtype. Both are roi_align_fwd_kernel.
// What bounds them on the H100: bytes. At the scoring path's shapes (B = 8,
// N = 1000, C = 256, bf16) K1 must read about 157 MB of tapped level pixels
// and write 200 MB of output, 0.106 ms at 3.35 TB/s; the multiply-adds are
// trivial. A first design (one 256-thread block per (roi, output row), one
// channel a thread, 2-byte loads and stores) took 0.82 ms on an H100 SXM:
// bound by load instructions and L1/L2 requests (112 loads of 64 bytes a
// warp per output row). What this design does about it:
//   * 16-byte accesses: a lane owns 16 bytes of channels (8 bf16 or 4 f32),
//     so a warp covers C = 256 bf16 with one 512-byte request per tap; the
//     sums are f32 registers; outputs leave as 16-byte stores;
//   * one block per roi, one warp per output row: the roi's pooled taps
//     (2 axes x S bins x 2 sr taps) are planned once into shared memory by
//     2 S threads, and each warp keeps its row's taps in registers;
//   * a bin issues all its tap loads (up to 4 x 4 at sr = 2) before its
//     FMAs; taps that weigh 0 (a pixel two samples share, a sample outside
//     the level) are not loaded. Neighbouring samples often share a pixel:
//     FPN's level rule puts most rois at 14-28 pixels across their level,
//     against 14 samples an axis;
//   * an invalid roi writes vector zeros and plans nothing;
//   * consecutive blocks are consecutive rois of one image, so its pyramid
//     (about 28 MB of bf16 at a 640x1024 canvas, C = 256) stays in the 50 MB
//     L2 while its rois are pooled.
// When C is not a multiple of the vector width, or a level or the output is
// not 16-byte aligned, the same kernel runs with one channel a lane (the
// scalar path, V = 1), chosen by the launcher from the shapes and pointers.
//
// K3, entry cald_roi_align_bwd, replaces cald_tpu/ops/pallas_roi_align.py::
// _roi_bwd_kernel: the gradient with respect to the levels, the transpose of
// the forward. The TPU kernel read-add-writes one window per roi into a
// zeroed buffer and is race-free only because its grid runs in order on one
// core. Here blocks run in any order on 132 SMs and rois overlap, so the
// kernel reduces into zeroed float32 channels-last level gradients
// (allocated by the wrapper, cast once to the feature dtype after). What
// bounds it on the H100: bytes, about 326 MB at the training path's shapes
// (B = 4, 512 rois per image, C = 256: the f32 gradient in, 223 MB of f32
// level gradients out), 0.097 ms. A first design added w * g / sr^2 into
// the 4 corners of each of a roi's 196 samples with scalar f32 atomicAdd:
// about 310M atomics into L2, many of them to one pixel (neighbouring
// samples share pixels whenever a roi spans under ~28 pixels at its level,
// most rois under FPN's level rule), and it took 0.58 ms on an H100 SXM.
// This design:
//   * merges before L2: a block per roi computes the transposed separable
//     form dF[u, v] = sum_y Wy[y, u] * sum_x Wx[x, v] * g[y, x] over the
//     roi's distinct tap rows u and columns v (Wy, Wx: the pooled taps by
//     distinct pixel, in shared memory), so each distinct pixel of the
//     roi's footprint gets one reduction instead of one per sample corner
//     (225 instead of 784 for a roi spanning 14 pixels);
//   * keeps loads in flight: a warp takes one distinct column v, sums
//     t[y] = sum_x Wx[x, v] * g[y, x] for all S output rows in registers
//     (the S loads of a bin column issued together), then issues its
//     column's reductions back to back. A first form that summed each
//     (u, v) on its own, load after dependent load, ran almost as long with
//     its reductions removed: it was bound by load latency, not by L2;
//   * wide reductions: a lane owns 4 channels and adds them with one
//     float4 atomicAdd (red.global.add.v4.f32 on sm_90), a warp 512 bytes
//     of one pixel per instruction;
//   * invalid rois and samples outside their level add nothing (they have
//     no tap of nonzero weight). The order of the adds, and so the last bits
//     of the sum, change from run to run.
// When C is not a multiple of 4 or the gradient of the output is not
// 16-byte aligned, the same kernel adds one channel a lane (V = 1).
//
// K4, entry cald_roi_align_group_fwd, replaces cald_tpu/ops/pallas_roi_align.py::
// _roi_group_kernel (the grouped training forward under CALD_TPU_ROI_GROUP=g).
// The TPU kernel pools g rois of one image per grid step only to fill its
// matrix unit with block-diagonal products; the value of a roi does not
// depend on g. So K4 is K2's kernel (roi_align_fwd_kernel, float32 output)
// and g enters neither its arithmetic nor its grid. It already contracts in
// the TPU kernel's separable order: per column tap j,
// t[y, col_j] = sum_k wy[y, k] * F[row_k, col_j], then out[y, x] +=
// wx[x, j] * t[y, col_j]. In "hi" (hi_prec = 1) it is the very instantiation
// K2 runs, and equals K2 bit for bit. In the "bf16" mode (hi_prec = 0) the
// ROUND instantiation adds the TPU kernel's two rounding points: the pooled
// axis weights are rounded to bf16 (pooled_taps), and so is each t before
// its x-contraction; the sums stay f32. A weight rounded to bf16 is never
// rounded to 0 (bf16 keeps float32's exponent range), so a tap of weight 0
// is still the only tap left unloaded. Not carried over: the block-diagonal
// weight matrices, the flat (H, W*C) levels, the 8-aligned DMA windows and
// their size buckets; with no window the result is exact for every roi (the
// TPU kernel clamps rois wider than its 56-row envelope). What bounds it on
// the H100: bytes, as K2, about 155 MB at the training path's shapes (B = 4,
// 512 rois per image, C = 256: the tapped bf16 level pixels and 103 MB of
// f32 output), 0.046 ms at 3.35 TB/s. A first design (one block per group of
// g rois and output row, one channel a thread, 2-byte loads, 4-byte stores,
// each tap loaded again for every output column that uses it, 1,792 long
// blocks at g = 8, 1.7 waves) took 0.47 ms on an H100 SXM; K2's design took
// that function to 0.09 ms.
//
// Layout: level l is (B, H_l, W_l, C) contiguous; rois (B, N, 4) f32 xyxy in
// image coordinates; valid (B, N) bool; levels (B, N) int32 in [0, L);
// pooled / gradient of the output (B, N, S, S, C).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define CALD_MAX_LEVELS 8
#define CALD_MAX_SR 8
#define CALD_FWD_MAX_SR 4     // K1/K2: the bin's taps are unrolled
#define CALD_MAX_OUT 8        // K1/K2: one warp per output row

struct LevelArgs {
  const void* ptr[CALD_MAX_LEVELS];
  int h[CALD_MAX_LEVELS];
  int w[CALD_MAX_LEVELS];
  float scale[CALD_MAX_LEVELS];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// V channels of T read as one access: 16 bytes on the vector path, one
// element on the scalar path (V = 1).
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  using raw = float4;
  static __device__ __forceinline__ raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void unpack(raw u, float* f) {
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using raw = uint4;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void unpack(raw u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <typename T>
struct Vec<T, 1> {
  using raw = T;
  static __device__ __forceinline__ raw load(const T* p) { return *p; }
  static __device__ __forceinline__ raw zero() {
    T z;
    from_float(0.f, &z);
    return z;
  }
  static __device__ __forceinline__ void unpack(raw u, float* f) { f[0] = to_float(u); }
};

// V float sums written to V channels of O: 16-byte stores on the vector path.
template <typename O, int V>
__device__ __forceinline__ void store_vec(O* p, const float* f) {
  if constexpr (V == 1) {
    from_float(f[0], p);
  } else if constexpr (std::is_same<O, float>::value) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else {
    static_assert(V == 8, "bf16 output is stored 8 channels at a time");
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// V float sums added to V float channels: one vector reduction on the vector
// path (float4 atomicAdd, sm_90), else one scalar atomicAdd. The old values
// are not used, so both compile to reductions.
template <int V>
__device__ __forceinline__ void add_vec(float* p, const float* a) {
  if constexpr (V == 1) {
    atomicAdd(p, a[0]);
  } else {
    static_assert(V == 4, "the gradient is reduced 4 channels at a time");
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  }
}

// Sample position i (of s * sr along an axis) of a roi starting at `start`
// with `extent`, each operation rounded as the plain version and the JAX
// points path write it: the explicit roundings keep nvcc from fusing them
// into an FMA. (On the card PyTorch divides by a scalar through its
// reciprocal, so the plain version's positions there can differ by an ulp.)
__device__ __forceinline__ float sample_pos(float start, float extent, int i, int s, int sr) {
  const float step = __fdiv_rn((float)i + 0.5f, (float)sr);
  return __fadd_rn(start, __fmul_rn(step, __fdiv_rn(extent, (float)s)));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The 2 * sr taps of output bin o along one axis of extent n (rows or
// columns of the level): each sample's low pixel and the next, the weight on
// a pixel the mean over the bin's samples of their weights there (carried by
// the pixel's first tap, 0 on the others), 0 outside the level and for an
// invalid roi, rounded to bf16 in the bf16 mode. The order of the sums is the
// plain version's (ops/roi_align.py::_pooled_taps).
__device__ __forceinline__ void pooled_taps(float start, float extent, int n, int o, int s,
                                            int sr, bool keep, bool bf16, int* pix, float* wt) {
  int p[2 * CALD_MAX_SR];
  float w[2 * CALD_MAX_SR];
  for (int i = 0; i < sr; ++i) {
    const float pos = sample_pos(start, extent, o * sr + i, s, sr);
    int lo = 0, hi = 0;
    float wl = 0.f, wh = 0.f;
    if (pos >= -1.f && pos <= (float)n) {
      const float pc = fminf(fmaxf(pos, 0.f), (float)(n - 1));
      lo = (int)floorf(pc);
      hi = min(lo + 1, n - 1);
      const float frac = __fsub_rn(pc, (float)lo);
      wl = __fsub_rn(1.f, frac);
      wh = frac;
    }
    p[2 * i] = lo;     w[2 * i] = wl;
    p[2 * i + 1] = hi; w[2 * i + 1] = wh;
  }
  for (int k = 0; k < 2 * sr; ++k) {
    bool first = true;
    for (int e = 0; e < k; ++e) first = first && p[e] != p[k];
    float sum = 0.f;
    for (int i = 0; i < sr; ++i) {
      float ws = 0.f;
      if (p[2 * i] == p[k]) ws = __fadd_rn(ws, w[2 * i]);
      if (p[2 * i + 1] == p[k]) ws = __fadd_rn(ws, w[2 * i + 1]);
      sum = __fadd_rn(sum, ws);
    }
    float v = (first && keep) ? __fdiv_rn(sum, (float)sr) : 0.f;
    if (bf16) v = round_bf16(v);
    pix[k] = p[k];
    wt[k] = v;
  }
}

// The start and extent of a roi along one axis at its level (0 rows, 1
// columns), as the plain version computes them.
__device__ __forceinline__ void roi_axis(const float* roi, float scale, int axis, float* start,
                                         float* extent) {
  const float lo = __fmul_rn(roi[axis == 0 ? 1 : 0], scale);
  *start = lo;
  *extent = fmaxf(__fsub_rn(__fmul_rn(roi[axis == 0 ? 3 : 2], scale), lo), 1.f);
}

// K1 / K2 / K4. grid: B * N blocks, one per roi; block: s warps, one per
// output row. dynamic shared memory: 2 axes x s bins x 2 SR taps x (int +
// float). ROUND (K4's "bf16" mode) rounds the pooled weights and each t to
// bf16; without it the code is K1's and K2's.
template <typename T, typename O, int V, int SR, bool ROUND>
__global__ void __launch_bounds__(32 * CALD_MAX_OUT)
roi_align_fwd_kernel(LevelArgs lv, const float* __restrict__ rois,
                     const bool* __restrict__ valid, const int* __restrict__ levels,
                     O* __restrict__ out, int n, int c, int s) {
  constexpr int TAPS = 2 * SR;
  using L = Vec<T, V>;
  extern __shared__ int fwd_smem[];
  const int r = blockIdx.x;
  O* o = out + (size_t)r * s * s * c;
  if (!valid[r]) {
    const float zero[V] = {};
    for (int i = threadIdx.x * V; i < s * s * c; i += blockDim.x * V) store_vec<O, V>(o + i, zero);
    return;
  }
  const int b = r / n;
  const int l = levels[r];
  const int h = lv.h[l];
  const int w = lv.w[l];
  int* pix = fwd_smem;                                    // [2 axes][s][TAPS]
  float* wt = reinterpret_cast<float*>(pix + 2 * s * TAPS);
  for (int t = threadIdx.x; t < 2 * s; t += blockDim.x) {
    const int axis = t / s;                               // 0 rows (y), 1 columns (x)
    float start, extent;
    roi_axis(rois + 4 * r, lv.scale[l], axis, &start, &extent);
    pooled_taps(start, extent, axis == 0 ? h : w, t % s, s, SR, true, ROUND, pix + t * TAPS,
                wt + t * TAPS);
  }
  __syncthreads();

  const int py = threadIdx.x >> 5;                        // this warp's output row
  const int lane = threadIdx.x & 31;
  int roff[TAPS];
  float wy[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    roff[k] = pix[py * TAPS + k] * w;
    wy[k] = wt[py * TAPS + k];
  }
  const int* xpix = pix + s * TAPS;
  const float* xwt = wt + s * TAPS;
  const T* f = static_cast<const T*>(lv.ptr[l]) + (size_t)b * h * w * c;
  O* orow = o + (size_t)py * s * c;
  for (int ch = lane * V; ch < c; ch += 32 * V) {
    const T* fc = f + ch;
    for (int px = 0; px < s; ++px) {
      int col[TAPS];
      float wx[TAPS];
#pragma unroll
      for (int j = 0; j < TAPS; ++j) {
        col[j] = xpix[px * TAPS + j];
        wx[j] = xwt[px * TAPS + j];
      }
      // every tap of the bin is loaded before the first FMA; the weights are
      // the same for the whole warp, so a tap of weight 0 costs no request
      typename L::raw v[TAPS][TAPS];
#pragma unroll
      for (int j = 0; j < TAPS; ++j)
#pragma unroll
        for (int k = 0; k < TAPS; ++k)
          v[j][k] = (wx[j] != 0.f && wy[k] != 0.f)
                        ? L::load(fc + (size_t)(roff[k] + col[j]) * c) : L::zero();
      float acc[V] = {};
#pragma unroll
      for (int j = 0; j < TAPS; ++j) {
        float t[V] = {};
#pragma unroll
        for (int k = 0; k < TAPS; ++k) {
          float x[V];
          L::unpack(v[j][k], x);
#pragma unroll
          for (int e = 0; e < V; ++e) t[e] = fmaf(wy[k], x[e], t[e]);
        }
        // t is the same for every output column that taps column col[j], so
        // rounding it here is the plain version's rounding of t[y, col_j]
        if constexpr (ROUND) {
#pragma unroll
          for (int e = 0; e < V; ++e) t[e] = round_bf16(t[e]);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(wx[j], t[e], acc[e]);
      }
      store_vec<O, V>(orow + (size_t)px * c + ch, acc);
    }
  }
}

// K3. grid: B * N blocks, one per roi; block: 256 threads. dynamic shared
// memory: bwd_smem_words(s, sr) 4-byte words, laid out below.
#define CALD_BWD_THREADS 256

static __host__ __device__ int bwd_smem_words(int s, int sr) {
  const int per_axis = s * 2 * sr;
  return 8 * per_axis + CALD_MAX_OUT * per_axis + s * per_axis + 2;
}

template <int V>
__global__ void __launch_bounds__(CALD_BWD_THREADS)
roi_align_bwd_kernel(LevelArgs lv, const float* __restrict__ rois,
                     const bool* __restrict__ valid, const int* __restrict__ levels,
                     const float* __restrict__ grad_out, int n, int c, int s, int sr) {
  extern __shared__ int bwd_smem[];
  const int r = blockIdx.x;
  if (!valid[r]) return;
  const int b = r / n;
  const int l = levels[r];
  const int h = lv.h[l];
  const int w = lv.w[l];
  const int taps = 2 * sr;
  const int per_axis = s * taps;                   // taps of one axis
  // [2 axes (rows 0, columns 1)][per_axis] each:
  int* pix = bwd_smem;                             // tap pixel
  float* wt = reinterpret_cast<float*>(pix + 2 * per_axis);  // tap weight
  int* first = reinterpret_cast<int*>(wt + 2 * per_axis);     // first nonzero tap of its pixel
  int* uniq = first + 2 * per_axis;                // distinct pixels, ascending
  // a bin's weight on a distinct pixel: rows as wy[u][y] (8 floats a row, two
  // 16-byte reads), columns as wx[x][v]
  float* wy = reinterpret_cast<float*>(uniq + 2 * per_axis);
  float* wx = wy + CALD_MAX_OUT * per_axis;
  int* count = reinterpret_cast<int*>(wx + s * per_axis);        // [2] distinct pixels per axis

  for (int t = threadIdx.x; t < (CALD_MAX_OUT + s) * per_axis; t += blockDim.x) wy[t] = 0.f;
  if (threadIdx.x < 2) count[threadIdx.x] = 0;
  for (int t = threadIdx.x; t < 2 * s; t += blockDim.x) {
    const int axis = t / s;
    float start, extent;
    roi_axis(rois + 4 * r, lv.scale[l], axis, &start, &extent);
    pooled_taps(start, extent, axis == 0 ? h : w, t % s, s, sr, true, false, pix + t * taps,
                wt + t * taps);
  }
  __syncthreads();
  // each pixel's first tap of nonzero weight (a bin carries a pixel's whole
  // weight on one tap, but neighbouring bins tap the same pixels)
  for (int t = threadIdx.x; t < 2 * per_axis; t += blockDim.x) {
    const int base = t - t % per_axis;
    bool f = wt[t] != 0.f;
    for (int e = base; e < t && f; ++e) f = !(wt[e] != 0.f && pix[e] == pix[t]);
    first[t] = f;
  }
  __syncthreads();
  // each nonzero tap's rank among its axis's distinct pixels
  for (int t = threadIdx.x; t < 2 * per_axis; t += blockDim.x) {
    if (wt[t] == 0.f) continue;
    const int axis = t / per_axis;
    const int base = axis * per_axis;
    int rank = 0;
    for (int e = base; e < base + per_axis; ++e) rank += first[e] && pix[e] < pix[t];
    const int bin = (t - base) / taps;
    if (axis == 0)
      wy[rank * CALD_MAX_OUT + bin] = wt[t];
    else
      wx[bin * per_axis + rank] = wt[t];
    if (first[t]) {
      uniq[base + rank] = pix[t];
      atomicAdd(count + axis, 1);
    }
  }
  __syncthreads();

  // one warp per (distinct column v, slice of channels) at a time:
  // t[y] = sum_x Wx[x, v] * g[y, x] for every output row y, the s loads of a
  // bin column issued together; then one reduction per distinct row u,
  // dF[u, v] += sum_y Wy[y, u] * t[y]
  const int nu = count[0], nv = count[1];
  const int lane = threadIdx.x & 31;
  const int slices = (c + 32 * V - 1) / (32 * V);
  float* gf = static_cast<float*>(const_cast<void*>(lv.ptr[l])) + (size_t)b * h * w * c;
  const float* g = grad_out + (size_t)r * s * s * c;
  for (int q = threadIdx.x >> 5; q < nv * slices; q += blockDim.x >> 5) {
    const int v = q / slices;
    const int ch = (q % slices) * 32 * V + lane * V;
    if (ch >= c) continue;
    float t[CALD_MAX_OUT][V] = {};
    for (int x = 0; x < s; ++x) {
      const float a = wx[x * per_axis + v];
      if (a == 0.f) continue;                      // the same for the whole warp
      const float* gx = g + (size_t)x * c + ch;
#pragma unroll
      for (int y = 0; y < CALD_MAX_OUT; ++y) {
        if (y < s) {
          float gv[V];
          Vec<float, V>::unpack(Vec<float, V>::load(gx + (size_t)y * s * c), gv);
#pragma unroll
          for (int e = 0; e < V; ++e) t[y][e] = fmaf(a, gv[e], t[y][e]);
        }
      }
    }
    float* col = gf + (size_t)uniq[per_axis + v] * c + ch;
    for (int u = 0; u < nu; ++u) {
      // the row's 8 weights (0 past s and on the bins that do not tap it)
      const float4 a0 = reinterpret_cast<const float4*>(wy + u * CALD_MAX_OUT)[0];
      const float4 a1 = reinterpret_cast<const float4*>(wy + u * CALD_MAX_OUT)[1];
      const float a[CALD_MAX_OUT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float acc[V] = {};
#pragma unroll
      for (int y = 0; y < CALD_MAX_OUT; ++y)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(a[y], t[y][e], acc[e]);
      add_vec<V>(col + (size_t)uniq[u] * w * c, acc);
    }
  }
}

static int fill_levels(LevelArgs* lv, const void* const* level_ptrs, const int* level_h,
                       const int* level_w, const float* level_scale, int num_levels) {
  if (num_levels < 1 || num_levels > CALD_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < CALD_MAX_LEVELS; ++i) {
    const bool used = i < num_levels;
    lv->ptr[i] = used ? level_ptrs[i] : nullptr;
    lv->h[i] = used ? level_h[i] : 0;
    lv->w[i] = used ? level_w[i] : 0;
    lv->scale[i] = used ? level_scale[i] : 0.f;
  }
  return (int)cudaSuccess;
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Whether every level and `extra` are 16-byte aligned and C is a multiple of
// `vec`: the vector path's condition (every pixel row then starts on 16
// bytes, whatever the image).
static bool vector_ok(const LevelArgs& lv, int num_levels, const void* extra, int c, int vec) {
  bool ok = c % vec == 0 && aligned16(extra);
  for (int i = 0; i < num_levels; ++i) ok = ok && aligned16(lv.ptr[i]);
  return ok;
}

template <typename T, typename O, int V, bool ROUND>
static int launch_fwd_v(const LevelArgs& lv, const float* rois, const bool* valid,
                        const int* levels, O* out, int b, int n, int c, int s, int sr,
                        cudaStream_t st) {
  const dim3 grid(b * n);
  const int threads = 32 * s;
  const size_t smem = (size_t)2 * s * 2 * sr * (sizeof(int) + sizeof(float));
  switch (sr) {
    case 1: roi_align_fwd_kernel<T, O, V, 1, ROUND><<<grid, threads, smem, st>>>(lv, rois, valid, levels, out, n, c, s); break;
    case 2: roi_align_fwd_kernel<T, O, V, 2, ROUND><<<grid, threads, smem, st>>>(lv, rois, valid, levels, out, n, c, s); break;
    case 3: roi_align_fwd_kernel<T, O, V, 3, ROUND><<<grid, threads, smem, st>>>(lv, rois, valid, levels, out, n, c, s); break;
    case 4: roi_align_fwd_kernel<T, O, V, 4, ROUND><<<grid, threads, smem, st>>>(lv, rois, valid, levels, out, n, c, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, typename O, bool ROUND>
static int launch_fwd_t(const LevelArgs& lv, int num_levels, const float* rois,
                        const bool* valid, const int* levels, void* out, int b, int n, int c,
                        int s, int sr, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  O* o = static_cast<O*>(out);
  if (vector_ok(lv, num_levels, out, c, VEC))
    return launch_fwd_v<T, O, VEC, ROUND>(lv, rois, valid, levels, o, b, n, c, s, sr, st);
  return launch_fwd_v<T, O, 1, ROUND>(lv, rois, valid, levels, o, b, n, c, s, sr, st);
}

// out_f32: 0 = output in the feature dtype (K1), 1 = float32 output (K2, K4).
// bf16_mode: 1 = K4's "bf16" mode (with out_f32 = 1).
static int launch_fwd(const void* const* level_ptrs, const int* level_h, const int* level_w,
                      const float* level_scale, int num_levels, const float* rois,
                      const bool* valid, const int* levels, void* out, int b, int n, int c,
                      int out_size, int sampling_ratio, int dtype, int out_f32, int bf16_mode,
                      void* stream) {
  LevelArgs lv;
  const int err = fill_levels(&lv, level_ptrs, level_h, level_w, level_scale, num_levels);
  if (err != (int)cudaSuccess) return err;
  if (out_size < 1 || out_size > CALD_MAX_OUT || sampling_ratio < 1
      || sampling_ratio > CALD_FWD_MAX_SR)
    return (int)cudaErrorInvalidValue;
  if (b * n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && bf16_mode)
    return launch_fwd_t<float, float, true>(lv, num_levels, rois, valid, levels, out, b, n, c,
                                            out_size, sampling_ratio, st);
  if (dtype == 0)
    return launch_fwd_t<float, float, false>(lv, num_levels, rois, valid, levels, out, b, n, c,
                                             out_size, sampling_ratio, st);
  if (dtype == 1 && bf16_mode)
    return launch_fwd_t<__nv_bfloat16, float, true>(lv, num_levels, rois, valid, levels, out, b,
                                                    n, c, out_size, sampling_ratio, st);
  if (dtype == 1 && out_f32)
    return launch_fwd_t<__nv_bfloat16, float, false>(lv, num_levels, rois, valid, levels, out, b,
                                                     n, c, out_size, sampling_ratio, st);
  if (dtype == 1)
    return launch_fwd_t<__nv_bfloat16, __nv_bfloat16, false>(lv, num_levels, rois, valid, levels,
                                                             out, b, n, c, out_size,
                                                             sampling_ratio, st);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry points, bound with ctypes. level_ptrs/level_h/level_w/
// level_scale are HOST arrays of num_levels entries; every other pointer is
// device memory. dtype is the feature dtype: 0 = float32, 1 = bfloat16. Each
// launches on `stream` and returns cudaGetLastError() (0 on success); none
// synchronises. All take out_size 1..8; K1, K2 and K4 sampling_ratio 1..4,
// K3 1..8.

// K1: out (B, N, S, S, C) in the feature dtype.
extern "C" int cald_roi_align_fwd(const void* const* level_ptrs, const int* level_h,
                                  const int* level_w, const float* level_scale,
                                  int num_levels, const float* rois, const bool* valid,
                                  const int* levels, void* out, int b, int n, int c,
                                  int out_size, int sampling_ratio, int dtype,
                                  void* stream) {
  return launch_fwd(level_ptrs, level_h, level_w, level_scale, num_levels, rois, valid, levels,
                    out, b, n, c, out_size, sampling_ratio, dtype, 0, 0, stream);
}

// K2: out (B, N, S, S, C) float32.
extern "C" int cald_roi_align_train_fwd(const void* const* level_ptrs, const int* level_h,
                                        const int* level_w, const float* level_scale,
                                        int num_levels, const float* rois, const bool* valid,
                                        const int* levels, float* out, int b, int n, int c,
                                        int out_size, int sampling_ratio, int dtype,
                                        void* stream) {
  return launch_fwd(level_ptrs, level_h, level_w, level_scale, num_levels, rois, valid, levels,
                    out, b, n, c, out_size, sampling_ratio, dtype, 1, 0, stream);
}

// K4: out (B, N, S, S, C) float32; hi_prec 1 = f32 throughout (K2's
// instantiation), 0 = the "bf16" mode. g (the rois per group of the TPU
// kernel, >= 1) is checked and enters neither the arithmetic nor the grid.
extern "C" int cald_roi_align_group_fwd(const void* const* level_ptrs, const int* level_h,
                                        const int* level_w, const float* level_scale,
                                        int num_levels, const float* rois, const bool* valid,
                                        const int* levels, float* out, int b, int n, int c,
                                        int out_size, int sampling_ratio, int dtype, int g,
                                        int hi_prec, void* stream) {
  if (g < 1) return (int)cudaErrorInvalidValue;
  return launch_fwd(level_ptrs, level_h, level_w, level_scale, num_levels, rois, valid, levels,
                    out, b, n, c, out_size, sampling_ratio, dtype, 1, hi_prec ? 0 : 1, stream);
}

// K3: grad_ptrs are the float32 (B, H_l, W_l, C) level gradients, zeroed by
// the caller; grad_out (B, N, S, S, C) float32.
extern "C" int cald_roi_align_bwd(void* const* grad_ptrs, const int* level_h,
                                  const int* level_w, const float* level_scale, int num_levels,
                                  const float* rois, const bool* valid, const int* levels,
                                  const float* grad_out, int b, int n, int c, int out_size,
                                  int sampling_ratio, void* stream) {
  LevelArgs lv;
  const int err = fill_levels(&lv, grad_ptrs, level_h, level_w, level_scale, num_levels);
  if (err != (int)cudaSuccess) return err;
  if (out_size < 1 || out_size > CALD_MAX_OUT || sampling_ratio < 1
      || sampling_ratio > CALD_MAX_SR)
    return (int)cudaErrorInvalidValue;
  if (b * n == 0) return (int)cudaSuccess;
  const dim3 grid(b * n);
  const size_t smem = (size_t)bwd_smem_words(out_size, sampling_ratio) * 4;   // <= 13 KB
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vector_ok(lv, num_levels, grad_out, c, 4)) {
    roi_align_bwd_kernel<4><<<grid, CALD_BWD_THREADS, smem, st>>>(
        lv, rois, valid, levels, grad_out, n, c, out_size, sampling_ratio);
  } else {
    roi_align_bwd_kernel<1><<<grid, CALD_BWD_THREADS, smem, st>>>(
        lv, rois, valid, levels, grad_out, n, c, out_size, sampling_ratio);
  }
  return (int)cudaGetLastError();
}
