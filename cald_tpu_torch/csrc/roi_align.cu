// Multi-scale RoIAlign forward for Hopper (sm_90a): a direct bilinear gather.
//
// Replaces the TPU kernel cald_tpu/ops/flm_roi_align.py::_flm_kernel (the
// default inference RoIAlign of the CALD scoring path). It computes the same
// function, torchvision MultiScaleRoIAlign with aligned=False and
// sampling_ratio 2, gathered back to proposal order, but not the TPU
// formulation: there is no level-sorted slot plan and no full-level matmul.
// Each block reads only the feature rows its samples touch.
//
// What bounds it on the H100: gather traffic. Per roi at a 7x7 output and
// sampling_ratio 2 there are 196 samples x 4 bilinear corners x C channels to
// read (about 400 KB of bf16 at C = 256) against 25 KB of bf16 output, and
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
//   * sums are kept in fp32 and rounded once to the feature dtype.
// Invalid rois are written as zeros (the TPU kernel's dead slot).
//
// Layout: level l is (B, H_l, W_l, C) contiguous; rois (B, N, 4) f32 xyxy in
// image coordinates; valid (B, N) bool; levels (B, N) int32 in [0, L);
// out (B, N, S, S, C) in the feature dtype.

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

// grid: (B * N, S); block: threads across C.
// dynamic shared memory: sr * S * sr samples x (4 int offsets + 4 weights).
template <typename T>
__global__ void roi_align_fwd_kernel(LevelArgs lv, const float* __restrict__ rois,
                                     const bool* __restrict__ valid,
                                     const int* __restrict__ levels,
                                     T* __restrict__ out, int n, int c, int s, int sr) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x;        // roi index into B * N
  const int py = blockIdx.y;       // output row
  const int b = r / n;
  T* o = out + ((size_t)r * s + py) * (size_t)s * c;

  if (!valid[r]) {
    for (int i = threadIdx.x; i < s * c; i += blockDim.x) from_float(0.f, o + i);
    return;
  }

  const int l = levels[r];
  const int h = lv.h[l];
  const int w = lv.w[l];
  const float scale = lv.scale[l];
  const T* f = static_cast<const T*>(lv.ptr[l]) + (size_t)b * h * w * c;

  const int ns = s * sr;           // samples along x for this row
  const int nsamp = sr * ns;       // samples of this output row
  int* off = reinterpret_cast<int*>(smem);           // nsamp x 4 pixel offsets
  float* wt = reinterpret_cast<float*>(off + 4 * nsamp);  // nsamp x 4 weights

  const float x1 = rois[4 * r + 0] * scale;
  const float y1 = rois[4 * r + 1] * scale;
  const float roi_w = fmaxf(rois[4 * r + 2] * scale - x1, 1.f);
  const float roi_h = fmaxf(rois[4 * r + 3] * scale - y1, 1.f);

  for (int t = threadIdx.x; t < nsamp; t += blockDim.x) {
    const int iy = t / ns;         // sub-sample row within the output row
    const int ix = t % ns;         // sample column
    const float y = y1 + ((py * sr + iy) + 0.5f) / sr * (roi_h / s);
    const float x = x1 + (ix + 0.5f) / sr * (roi_w / s);
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

// Plain C entry point, bound with ctypes. level_ptrs/level_h/level_w/
// level_scale are HOST arrays of num_levels entries; every other pointer is
// device memory. dtype: 0 = float32, 1 = bfloat16. Launches on `stream` and
// returns cudaGetLastError() (0 on success); it never synchronises.
extern "C" int cald_roi_align_fwd(const void* const* level_ptrs, const int* level_h,
                                  const int* level_w, const float* level_scale,
                                  int num_levels, const float* rois, const bool* valid,
                                  const int* levels, void* out, int b, int n, int c,
                                  int out_size, int sampling_ratio, int dtype,
                                  void* stream) {
  if (num_levels < 1 || num_levels > CALD_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  LevelArgs lv;
  for (int i = 0; i < CALD_MAX_LEVELS; ++i) {
    const bool used = i < num_levels;
    lv.ptr[i] = used ? level_ptrs[i] : nullptr;
    lv.h[i] = used ? level_h[i] : 0;
    lv.w[i] = used ? level_w[i] : 0;
    lv.scale[i] = used ? level_scale[i] : 0.f;
  }
  if (b * n == 0) return (int)cudaSuccess;
  const int threads = c >= 256 ? 256 : ((c + 31) / 32) * 32;
  const dim3 grid(b * n, out_size);
  const size_t smem = (size_t)sampling_ratio * out_size * sampling_ratio * 4 *
                      (sizeof(int) + sizeof(float));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, threads, smem, st>>>(
        lv, rois, valid, levels, static_cast<float*>(out), n, c, out_size, sampling_ratio);
  } else if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, smem, st>>>(
        lv, rois, valid, levels, static_cast<__nv_bfloat16*>(out), n, c, out_size,
        sampling_ratio);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
