// Multi-scale RoIAlign for Hopper (sm_90a): the inference forward, the
// training forward and the training backward.
//
// K1, entry cald_roi_align_fwd, replaces cald_tpu/ops/flm_roi_align.py::
// _flm_kernel (the default inference RoIAlign of the CALD scoring path).
// K2, entry cald_roi_align_train_fwd, replaces cald_tpu/ops/pallas_roi_align.py::
// _roi_kernel (the training forward, WIN_TRAIN window). Both are the same
// gather kernel, roi_align_fwd_kernel, which computes torchvision
// MultiScaleRoIAlign with aligned=False and sampling_ratio 2 in proposal
// order, but not the TPU formulations: there is no level-sorted slot plan, no
// full-level matmul and no DMA window. Each block reads only the feature rows
// its samples touch, so every roi is exact, however wide (the TPU's training
// window clamps rois wider than 48x56 at their level). K1 writes the feature
// dtype, K2 float32 whatever the feature dtype, as the TPU kernels do.
//
// What bounds the forward on the H100: gather traffic. Per roi at a 7x7 output
// and sampling_ratio 2 there are 196 samples x 4 bilinear corners x C channels
// to read (about 400 KB of bf16 at C = 256) against 25 KB of bf16 output, and
// the rows read are scattered over the roi's level. The FLOPs are trivial.
// What the design does about it:
//   * channels-last levels, and threads run across C, so the 4 corner reads
//     of one sample by a warp are contiguous in memory (coalesced);
//   * one block per (roi, output row): the 28 samples of that row are
//     computed once into shared memory (offsets + weights) and reused by
//     every channel, so the inner loop is loads and FMAs only;
//   * blocks of one image are launched together, so that image's pyramid
//     (about 28 MB of bf16 at a 640x1024 canvas, C = 256) stays in the
//     50 MB L2 while its rois are pooled; neighbouring samples share rows;
//   * sums are kept in fp32 and rounded once to the output dtype.
// Invalid rois are written as zeros (the TPU kernel's dead slot).
//
// K3, entry cald_roi_align_bwd, replaces cald_tpu/ops/pallas_roi_align.py::
// _roi_bwd_kernel: the gradient with respect to the levels, the transpose of
// the forward's sample rule. The TPU kernel read-add-writes one window per
// roi into a zeroed buffer and is race-free only because its grid runs in
// order on one core. Here blocks run in any order on 132 SMs and the rois of
// an image overlap, so roi_align_bwd_kernel scatters with fp32 atomicAdd into
// a zeroed float32 channels-last buffer per level (allocated by the wrapper,
// cast once to the feature dtype after). Same grid and shared-memory sample
// plan as the forward: each thread owns channels, takes its bin's gradient
// g / (sr * sr) and adds w * g into the 4 corners of each of the bin's
// samples. Where the clamp at a level's edge makes two corners one pixel,
// both adds land there, as autograd of the plain version gives. Invalid rois
// and samples outside the level add nothing. What bounds it: the atomic
// traffic into L2 (196 samples x 4 corners x C red.add per roi, about
// 200,000 at C = 256); a warp's adds to one corner hit 32 consecutive floats,
// which L2 merges into whole-sector reductions. The order of the adds, and so
// the last bits of the sum, change from run to run.
//
// K4, entry cald_roi_align_group_fwd, replaces cald_tpu/ops/pallas_roi_align.py::
// _roi_group_kernel (the grouped training forward under CALD_TPU_ROI_GROUP=g):
// K2's function in the TPU kernel's separable form, g rois of one image per
// group. Per roi, with the pooled bilinear axis weights (each output row and
// column has 2 * sr taps, a pixel and its weight, a pixel shared by two taps
// of one bin counted once): t[y, col] = sum_k wy[y, k] * F[row_k, col] over
// the roi's sample columns, then out[y, x] = sum_j wx[x, j] * t[y, col_j].
// In the "bf16" mode (hi_prec = 0) the pooled weights and t are rounded to
// bf16 where the TPU kernel rounds them; the sums stay f32. Not carried over:
// the block-diagonal weight matrices, the flat (H, W*C) levels, the 8-aligned
// DMA windows and their size buckets. With no window the result is exact for
// every roi (the TPU kernel clamps rois wider than its 56-row envelope).
// Design: one block per (group, output row), threads across C, the group's
// taps planned once per block into shared memory (g * 2 axes * S * 2sr
// pairs, 3.5 KB at g = 8); each thread sums t for one channel in registers
// and folds it straight into its output column, so t needs no storage (a
// sample column shared by two output columns is summed twice, with the same
// result). What bounds it: like K2, the gather of the taps' feature rows
// (coalesced across C in channels-last levels) and the f32 output; the
// separable form reads each tap pixel once per (output row, column tap).
// Blocks of a group's image run together, so its pyramid stays in L2.
// Invalid rois are written as zeros.
//
// Layout: level l is (B, H_l, W_l, C) contiguous; rois (B, N, 4) f32 xyxy in
// image coordinates; valid (B, N) bool; levels (B, N) int32 in [0, L);
// pooled / gradient of the output (B, N, S, S, C).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define CALD_MAX_LEVELS 8

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

// Sample position i (of s * sr along an axis) of a roi starting at `start`
// with `extent`, each operation rounded as the plain version and the JAX
// points path write it: the explicit roundings keep nvcc from fusing them
// into an FMA. (On the card PyTorch divides by a scalar through its
// reciprocal, so the plain version's positions there can differ by an ulp.)
__device__ __forceinline__ float sample_pos(float start, float extent, int i, int s, int sr) {
  const float step = __fdiv_rn((float)i + 0.5f, (float)sr);
  return __fadd_rn(start, __fmul_rn(step, __fdiv_rn(extent, (float)s)));
}

// The samples of output row py of one roi at level (h, w, scale): for each of
// the sr * (s * sr) samples, 4 corner pixel offsets into the level and their
// bilinear weights (0 for samples outside the level), into shared memory.
// Every thread of the block takes part; the caller synchronises.
__device__ __forceinline__ void plan_row(const float* roi, float scale, int h, int w, int py,
                                         int s, int sr, int* off, float* wt) {
  const int ns = s * sr;           // samples along x for this row
  const int nsamp = sr * ns;       // samples of this output row
  const float x1 = __fmul_rn(roi[0], scale);
  const float y1 = __fmul_rn(roi[1], scale);
  const float roi_w = fmaxf(__fsub_rn(__fmul_rn(roi[2], scale), x1), 1.f);
  const float roi_h = fmaxf(__fsub_rn(__fmul_rn(roi[3], scale), y1), 1.f);
  for (int t = threadIdx.x; t < nsamp; t += blockDim.x) {
    const int iy = t / ns;         // sub-sample row within the output row
    const int ix = t % ns;         // sample column
    const float y = sample_pos(y1, roi_h, py * sr + iy, s, sr);
    const float x = sample_pos(x1, roi_w, ix, s, sr);
    int o4[4] = {0, 0, 0, 0};
    float w4[4] = {0.f, 0.f, 0.f, 0.f};
    if (y >= -1.f && y <= (float)h && x >= -1.f && x <= (float)w) {
      const float yc = fminf(fmaxf(y, 0.f), (float)(h - 1));
      const float xc = fminf(fmaxf(x, 0.f), (float)(w - 1));
      const int y0 = (int)floorf(yc);
      const int x0 = (int)floorf(xc);
      const int y1i = min(y0 + 1, h - 1);
      const int x1i = min(x0 + 1, w - 1);
      const float ly = yc - (float)y0, lx = xc - (float)x0;
      const float hy = 1.f - ly, hx = 1.f - lx;
      o4[0] = y0 * w + x0;  w4[0] = hy * hx;
      o4[1] = y0 * w + x1i; w4[1] = hy * lx;
      o4[2] = y1i * w + x0; w4[2] = ly * hx;
      o4[3] = y1i * w + x1i; w4[3] = ly * lx;
    }
    for (int k = 0; k < 4; ++k) {
      off[4 * t + k] = o4[k];
      wt[4 * t + k] = w4[k];
    }
  }
}

// grid: (B * N, S); block: threads across C.
// dynamic shared memory: sr * S * sr samples x (4 int offsets + 4 weights).
template <typename T, typename O>
__global__ void roi_align_fwd_kernel(LevelArgs lv, const float* __restrict__ rois,
                                     const bool* __restrict__ valid,
                                     const int* __restrict__ levels,
                                     O* __restrict__ out, int n, int c, int s, int sr) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x;        // roi index into B * N
  const int py = blockIdx.y;       // output row
  const int b = r / n;
  O* o = out + ((size_t)r * s + py) * (size_t)s * c;

  if (!valid[r]) {
    for (int i = threadIdx.x; i < s * c; i += blockDim.x) from_float(0.f, o + i);
    return;
  }

  const int l = levels[r];
  const int h = lv.h[l];
  const int w = lv.w[l];
  const T* f = static_cast<const T*>(lv.ptr[l]) + (size_t)b * h * w * c;

  const int ns = s * sr;
  int* off = reinterpret_cast<int*>(smem);                // nsamp x 4 pixel offsets
  float* wt = reinterpret_cast<float*>(off + 4 * sr * ns); // nsamp x 4 weights
  plan_row(rois + 4 * r, lv.scale[l], h, w, py, s, sr, off, wt);
  __syncthreads();

  const float inv = 1.f / (float)(sr * sr);
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const T* fc = f + ch;
    for (int px = 0; px < s; ++px) {
      float acc = 0.f;
      for (int iy = 0; iy < sr; ++iy) {
        for (int jx = 0; jx < sr; ++jx) {
          const int t = iy * ns + px * sr + jx;
          const int* ot = off + 4 * t;
          const float* wq = wt + 4 * t;
          acc += wq[0] * to_float(fc[(size_t)ot[0] * c]) + wq[1] * to_float(fc[(size_t)ot[1] * c])
               + wq[2] * to_float(fc[(size_t)ot[2] * c]) + wq[3] * to_float(fc[(size_t)ot[3] * c]);
        }
      }
      from_float(acc * inv, o + (size_t)px * c + ch);
    }
  }
}

// grid: (B * N, S); block: threads across C; shared memory as the forward.
// lv.ptr[l] points at the float32 gradient of level l (zeroed by the caller).
__global__ void roi_align_bwd_kernel(LevelArgs lv, const float* __restrict__ rois,
                                     const bool* __restrict__ valid,
                                     const int* __restrict__ levels,
                                     const float* __restrict__ grad_out, int n, int c, int s,
                                     int sr) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x;
  const int py = blockIdx.y;
  if (!valid[r]) return;
  const int b = r / n;
  const int l = levels[r];
  const int h = lv.h[l];
  const int w = lv.w[l];
  float* gf = static_cast<float*>(const_cast<void*>(lv.ptr[l])) + (size_t)b * h * w * c;
  const float* g = grad_out + ((size_t)r * s + py) * (size_t)s * c;

  const int ns = s * sr;
  int* off = reinterpret_cast<int*>(smem);
  float* wt = reinterpret_cast<float*>(off + 4 * sr * ns);
  plan_row(rois + 4 * r, lv.scale[l], h, w, py, s, sr, off, wt);
  __syncthreads();

  const float inv = 1.f / (float)(sr * sr);
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float* gc = gf + ch;
    for (int px = 0; px < s; ++px) {
      const float gv = g[(size_t)px * c + ch] * inv;
      for (int iy = 0; iy < sr; ++iy) {
        for (int jx = 0; jx < sr; ++jx) {
          const int t = iy * ns + px * sr + jx;
          for (int k = 0; k < 4; ++k) {
            const float wk = wt[4 * t + k];
            // the same for every thread of the block: no divergence
            if (wk != 0.f) atomicAdd(gc + (size_t)off[4 * t + k] * c, wk * gv);
          }
        }
      }
    }
  }
}

#define CALD_MAX_SR 8

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

// grid: (B * groups_per_image, S); block: threads across C.
// dynamic shared memory: g rois x 2 axes x S bins x 2sr taps x (int + float).
template <typename T>
__global__ void roi_align_group_kernel(LevelArgs lv, const float* __restrict__ rois,
                                       const bool* __restrict__ valid,
                                       const int* __restrict__ levels, float* __restrict__ out,
                                       int n, int c, int s, int sr, int g, int groups_per_image,
                                       int bf16) {
  extern __shared__ unsigned char smem[];
  const int b = blockIdx.x / groups_per_image;
  const int r0 = b * n + (blockIdx.x % groups_per_image) * g;   // first roi of the group
  const int m = min(g, b * n + n - r0);                          // the image's last group is short
  const int y = blockIdx.y;                                      // output row
  const int taps = 2 * sr;
  const int per_axis = s * taps;
  int* pix = reinterpret_cast<int*>(smem);                       // [g][2 axes][S][taps]
  float* wt = reinterpret_cast<float*>(pix + g * 2 * per_axis);

  for (int t = threadIdx.x; t < m * 2 * s; t += blockDim.x) {
    const int j = t / (2 * s);
    const int axis = (t / s) % 2;                                // 0 rows (y), 1 columns (x)
    const int o = t % s;
    const int r = r0 + j;
    const int l = levels[r];
    const float scale = lv.scale[l];
    const float* roi = rois + 4 * r;
    const float lo = __fmul_rn(roi[axis == 0 ? 1 : 0], scale);
    const float extent = fmaxf(__fsub_rn(__fmul_rn(roi[axis == 0 ? 3 : 2], scale), lo), 1.f);
    const int off = (j * 2 + axis) * per_axis + o * taps;
    pooled_taps(lo, extent, axis == 0 ? lv.h[l] : lv.w[l], o, s, sr, valid[r], bf16 != 0,
                pix + off, wt + off);
  }
  __syncthreads();

  for (int j = 0; j < m; ++j) {
    const int r = r0 + j;
    float* o = out + ((size_t)r * s + y) * (size_t)s * c;
    if (!valid[r]) {
      for (int i = threadIdx.x; i < s * c; i += blockDim.x) o[i] = 0.f;
      continue;
    }
    const int l = levels[r];
    const int w = lv.w[l];
    const T* f = static_cast<const T*>(lv.ptr[l]) + (size_t)b * lv.h[l] * w * c;
    const int* yp = pix + (j * 2) * per_axis + y * taps;
    const float* yw = wt + (j * 2) * per_axis + y * taps;
    const int* xp = pix + (j * 2 + 1) * per_axis;
    const float* xw = wt + (j * 2 + 1) * per_axis;
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      for (int x = 0; x < s; ++x) {
        float acc = 0.f;
        for (int jx = 0; jx < taps; ++jx) {
          const float wx = xw[x * taps + jx];
          if (wx == 0.f) continue;                 // the same for every thread
          const T* col = f + (size_t)xp[x * taps + jx] * c + ch;
          float t = 0.f;                           // t[y, col_jx] for this channel
          for (int ky = 0; ky < taps; ++ky) {
            const float wy = yw[ky];
            if (wy != 0.f) t += wy * to_float(col[(size_t)yp[ky] * w * c]);
          }
          if (bf16) t = round_bf16(t);
          acc += wx * t;
        }
        o[(size_t)x * c + ch] = acc;
      }
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

static int threads_for(int c) { return c >= 256 ? 256 : ((c + 31) / 32) * 32; }

static size_t smem_for(int out_size, int sampling_ratio) {
  return (size_t)sampling_ratio * out_size * sampling_ratio * 4 * (sizeof(int) + sizeof(float));
}

// out_f32: 0 = output in the feature dtype (K1), 1 = float32 output (K2).
static int launch_fwd(const void* const* level_ptrs, const int* level_h, const int* level_w,
                      const float* level_scale, int num_levels, const float* rois,
                      const bool* valid, const int* levels, void* out, int b, int n, int c,
                      int out_size, int sampling_ratio, int dtype, int out_f32, void* stream) {
  LevelArgs lv;
  const int err = fill_levels(&lv, level_ptrs, level_h, level_w, level_scale, num_levels);
  if (err != (int)cudaSuccess) return err;
  if (b * n == 0) return (int)cudaSuccess;
  const dim3 grid(b * n, out_size);
  const int threads = threads_for(c);
  const size_t smem = smem_for(out_size, sampling_ratio);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_fwd_kernel<float, float><<<grid, threads, smem, st>>>(
        lv, rois, valid, levels, static_cast<float*>(out), n, c, out_size, sampling_ratio);
  } else if (dtype == 1 && out_f32) {
    roi_align_fwd_kernel<__nv_bfloat16, float><<<grid, threads, smem, st>>>(
        lv, rois, valid, levels, static_cast<float*>(out), n, c, out_size, sampling_ratio);
  } else if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, threads, smem, st>>>(
        lv, rois, valid, levels, static_cast<__nv_bfloat16*>(out), n, c, out_size,
        sampling_ratio);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Plain C entry points, bound with ctypes. level_ptrs/level_h/level_w/
// level_scale are HOST arrays of num_levels entries; every other pointer is
// device memory. dtype is the feature dtype: 0 = float32, 1 = bfloat16. Each
// launches on `stream` and returns cudaGetLastError() (0 on success); none
// synchronises.

// K1: out (B, N, S, S, C) in the feature dtype.
extern "C" int cald_roi_align_fwd(const void* const* level_ptrs, const int* level_h,
                                  const int* level_w, const float* level_scale,
                                  int num_levels, const float* rois, const bool* valid,
                                  const int* levels, void* out, int b, int n, int c,
                                  int out_size, int sampling_ratio, int dtype,
                                  void* stream) {
  return launch_fwd(level_ptrs, level_h, level_w, level_scale, num_levels, rois, valid, levels,
                    out, b, n, c, out_size, sampling_ratio, dtype, 0, stream);
}

// K2: out (B, N, S, S, C) float32.
extern "C" int cald_roi_align_train_fwd(const void* const* level_ptrs, const int* level_h,
                                        const int* level_w, const float* level_scale,
                                        int num_levels, const float* rois, const bool* valid,
                                        const int* levels, float* out, int b, int n, int c,
                                        int out_size, int sampling_ratio, int dtype,
                                        void* stream) {
  return launch_fwd(level_ptrs, level_h, level_w, level_scale, num_levels, rois, valid, levels,
                    out, b, n, c, out_size, sampling_ratio, dtype, 1, stream);
}

// K4: out (B, N, S, S, C) float32; g rois of one image per group (the last
// group of an image may be short); hi_prec 1 = f32 throughout, 0 = the
// "bf16" mode.
extern "C" int cald_roi_align_group_fwd(const void* const* level_ptrs, const int* level_h,
                                        const int* level_w, const float* level_scale,
                                        int num_levels, const float* rois, const bool* valid,
                                        const int* levels, float* out, int b, int n, int c,
                                        int out_size, int sampling_ratio, int dtype, int g,
                                        int hi_prec, void* stream) {
  LevelArgs lv;
  const int err = fill_levels(&lv, level_ptrs, level_h, level_w, level_scale, num_levels);
  if (err != (int)cudaSuccess) return err;
  if (g < 1 || sampling_ratio < 1 || sampling_ratio > CALD_MAX_SR) return (int)cudaErrorInvalidValue;
  if (b * n == 0) return (int)cudaSuccess;
  const int groups = (n + g - 1) / g;
  const dim3 grid(b * groups, out_size);
  const int threads = threads_for(c);
  const size_t smem = (size_t)g * 2 * out_size * 2 * sampling_ratio * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bf16 = hi_prec ? 0 : 1;
  if (dtype == 0) {
    roi_align_group_kernel<float><<<grid, threads, smem, st>>>(
        lv, rois, valid, levels, out, n, c, out_size, sampling_ratio, g, groups, bf16);
  } else if (dtype == 1) {
    roi_align_group_kernel<__nv_bfloat16><<<grid, threads, smem, st>>>(
        lv, rois, valid, levels, out, n, c, out_size, sampling_ratio, g, groups, bf16);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
  if (b * n == 0) return (int)cudaSuccess;
  const dim3 grid(b * n, out_size);
  roi_align_bwd_kernel<<<grid, threads_for(c), smem_for(out_size, sampling_ratio),
                         static_cast<cudaStream_t>(stream)>>>(
      lv, rois, valid, levels, grad_out, n, c, out_size, sampling_ratio);
  return (int)cudaGetLastError();
}
