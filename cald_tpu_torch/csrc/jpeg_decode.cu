// JPEG decoding on the card for the port's data loader: nvJPEG decodes, and
// a hand-written kernel resizes every image of a batch into one float32
// canvas.
//
// It replaces the JAX package's host path native/dataloader.cc, which
// decodes with libjpeg and runs ResizeIntoCanvas (:80) in one C++ pass
// (cald_decode_resize, :140). That path is C++ on the host, not a Pallas
// kernel: this source is the port's counterpart on the hardware the port
// runs on. The decode is nvJPEG's (a library of the CUDA toolkit, linked
// with -lnvjpeg). The resize is resize_into_canvas_kernel below.
//
// Entry points (C, ctypes):
//   cald_jpeg_info(data, len, &w, &h, &c)          header only: size and
//       components of a JPEG held in host memory;
//   cald_jpeg_decode(data, len, out, w, c, device, stream)  decodes into
//       device memory `out`, h * w * c bytes, rows of w * c: interleaved RGB
//       for c = 3, luma for c = 1 (a grayscale file);
//   cald_resize_into_canvas(pixels, meta, canvas, b, canvas_h, canvas_w,
//       device, stream)  one launch for a whole batch (below).
// `device` is made current first: a loader thread has not set it.
// Each returns 0 on success, CALD_JPEG_REJECTED (-1) for a file nvJPEG
// cannot read (a corrupt or truncated stream, an unsupported coding, or
// components other than 1 or 3: libjpeg refuses CMYK into RGB as well), and
// otherwise 1000 + an nvJPEG status or 2000 + a CUDA error code. The wrapper
// sends a rejected file to Pillow, as the JAX loader does, and raises on the
// rest.
//
// Threads. The loader calls from several threads at once. nvJPEG's handle
// may be shared; a decoder state may not. There is one handle per process,
// created at the first call, and a pool of decoder states under a lock: a
// decode takes a state from the pool (or creates one) and gives it back, so
// no two threads ever hold one state, and the pool holds at most as many
// states as there were concurrent decodes. The stream is the caller's (each
// loader thread passes its own), so the canvas is allocated, written and
// synchronised on one stream. Decoding uses nvjpegDecode, one image a call:
// the batched API must be re-initialised for every batch size and thread
// count and decodes in lockstep, while one call per image lets the loader's
// threads overlap their host-side Huffman decoding freely.
//
// The kernel. It computes ResizeIntoCanvas for every image of a batch into a
// (B, H, W, 3) float32 canvas: bilinear, pixel centres at +0.5, the source
// coordinate clamped to [0, size - 1], the four taps weighted
// (1-ly)(1-lx), (1-ly)lx, ly(1-lx), ly lx and summed in that order. Every
// float operation is written as a round-to-nearest intrinsic (__fdiv_rn,
// __fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts into FMAs, so
// on the same decoded pixels the canvas equals the C++ path bit for bit.
// The resized sizes (nearbyint of size * scale in float32, :145-148) are
// computed by the caller and passed in `meta`.
// What bounds it on the H100: bytes. It writes the whole canvas, 12 bytes a
// pixel (B = 8 at 640x1024: 63 MB, 18.8 us at 3.35 TB/s), and reads each
// decoded image once (8 x 375x500x3: 4.5 MB); it does about 30 float
// operations a pixel. The design: one thread per canvas pixel, a block row
// of the grid per image (grid.y = B), so one launch serves the batch and the
// caller needs no zero fill: a thread outside its image's resized size
// writes zeros. A warp's 32 pixels are 384 contiguous bytes of canvas; the
// 2x2 source taps of neighbouring pixels share rows and mostly columns, so
// the uint8 reads hit L1.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <vector>

#define CALD_JPEG_REJECTED (-1)

namespace {

constexpr int kThreads = 256;
constexpr int kMetaWords = 6;   // per image: byte offset, src h, src w, channels, out h, out w

std::mutex g_mutex;
nvjpegHandle_t g_handle = nullptr;
std::vector<nvjpegJpegState_t> g_states;   // free decoder states

int status_code(nvjpegStatus_t s) {
  switch (s) {
    case NVJPEG_STATUS_SUCCESS:
      return 0;
    case NVJPEG_STATUS_BAD_JPEG:
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED:
    case NVJPEG_STATUS_INCOMPLETE_BITSTREAM:
      return CALD_JPEG_REJECTED;
    default:
      return 1000 + static_cast<int>(s);
  }
}

int get_handle(nvjpegHandle_t* out) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (g_handle == nullptr) {
    const nvjpegStatus_t s = nvjpegCreateSimple(&g_handle);
    if (s != NVJPEG_STATUS_SUCCESS) {
      g_handle = nullptr;
      return 1000 + static_cast<int>(s);
    }
  }
  *out = g_handle;
  return 0;
}

int take_state(nvjpegHandle_t handle, nvjpegJpegState_t* out) {
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (!g_states.empty()) {
      *out = g_states.back();
      g_states.pop_back();
      return 0;
    }
  }
  const nvjpegStatus_t s = nvjpegJpegStateCreate(handle, out);
  return s == NVJPEG_STATUS_SUCCESS ? 0 : 1000 + static_cast<int>(s);
}

void give_state(nvjpegJpegState_t state) {
  std::lock_guard<std::mutex> lock(g_mutex);
  g_states.push_back(state);
}

__global__ void __launch_bounds__(kThreads)
resize_into_canvas_kernel(const uint8_t* __restrict__ pixels,
                          const long long* __restrict__ meta,
                          float* __restrict__ canvas, int canvas_h,
                          int canvas_w) {
  const int b = blockIdx.y;
  const long long plane = static_cast<long long>(canvas_h) * canvas_w;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= plane) return;
  const long long* m = meta + kMetaWords * b;
  const int sh = static_cast<int>(m[1]), sw = static_cast<int>(m[2]);
  const int ch = static_cast<int>(m[3]);
  const int out_h = static_cast<int>(m[4]), out_w = static_cast<int>(m[5]);
  const int oy = static_cast<int>(p / canvas_w);
  const int ox = static_cast<int>(p - static_cast<long long>(oy) * canvas_w);
  float* out = canvas + (b * plane + p) * 3;
  if (oy >= out_h || ox >= out_w) {
    out[0] = 0.0f;
    out[1] = 0.0f;
    out[2] = 0.0f;
    return;
  }
  const uint8_t* src = pixels + m[0];
  const float sx_ratio = __fdiv_rn(static_cast<float>(sw), static_cast<float>(out_w));
  const float sy_ratio = __fdiv_rn(static_cast<float>(sh), static_cast<float>(out_h));
  float sy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(oy), 0.5f), sy_ratio), 0.5f);
  sy = fminf(fmaxf(sy, 0.0f), static_cast<float>(sh - 1));
  const int y0 = static_cast<int>(sy);
  const int y1 = min(y0 + 1, sh - 1);
  const float ly = __fsub_rn(sy, static_cast<float>(y0));
  float sx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(ox), 0.5f), sx_ratio), 0.5f);
  sx = fminf(fmaxf(sx, 0.0f), static_cast<float>(sw - 1));
  const int x0 = static_cast<int>(sx);
  const int x1 = min(x0 + 1, sw - 1);
  const float lx = __fsub_rn(sx, static_cast<float>(x0));
  const float w00 = __fmul_rn(__fsub_rn(1.0f, ly), __fsub_rn(1.0f, lx));
  const float w01 = __fmul_rn(__fsub_rn(1.0f, ly), lx);
  const float w10 = __fmul_rn(ly, __fsub_rn(1.0f, lx));
  const float w11 = __fmul_rn(ly, lx);
  const uint8_t* r0 = src + static_cast<long long>(y0) * sw * ch;
  const uint8_t* r1 = src + static_cast<long long>(y1) * sw * ch;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int k = ch == 3 ? c : 0;   // a grayscale image repeats its luma
    const float v = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(w00, static_cast<float>(r0[x0 * ch + k])),
                            __fmul_rn(w01, static_cast<float>(r0[x1 * ch + k]))),
                  __fmul_rn(w10, static_cast<float>(r1[x0 * ch + k]))),
        __fmul_rn(w11, static_cast<float>(r1[x1 * ch + k])));
    out[c] = v;
  }
}

}  // namespace

extern "C" {

int cald_jpeg_info(const unsigned char* data, size_t len, int* width, int* height,
                   int* channels) {
  nvjpegHandle_t handle;
  int err = get_handle(&handle);
  if (err != 0) return err;
  int n = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
  err = status_code(nvjpegGetImageInfo(handle, data, len, &n, &sub, widths, heights));
  if (err != 0) return err;
  if (n != 1 && n != 3) return CALD_JPEG_REJECTED;
  if (widths[0] <= 0 || heights[0] <= 0) return CALD_JPEG_REJECTED;
  *width = widths[0];
  *height = heights[0];
  *channels = n;
  return 0;
}

int cald_jpeg_decode(const unsigned char* data, size_t len, unsigned char* out, int width,
                     int channels, int device, void* stream) {
  if (channels != 1 && channels != 3) return CALD_JPEG_REJECTED;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return 2000 + static_cast<int>(set);
  nvjpegHandle_t handle;
  int err = get_handle(&handle);
  if (err != 0) return err;
  nvjpegJpegState_t state;
  err = take_state(handle, &state);
  if (err != 0) return err;
  nvjpegImage_t image = {};
  image.channel[0] = out;
  image.pitch[0] = static_cast<size_t>(width) * channels;
  err = status_code(nvjpegDecode(handle, state, data, len,
                                 channels == 3 ? NVJPEG_OUTPUT_RGBI : NVJPEG_OUTPUT_Y, &image,
                                 static_cast<cudaStream_t>(stream)));
  give_state(state);
  return err;
}

// pixels: the batch's decoded images, one after another, each h * w * c
// bytes; meta: (B, 6) int64 on the device, per image its byte offset in
// pixels, h, w, c, and its resized out_h <= canvas_h and out_w <= canvas_w;
// canvas: (B, canvas_h, canvas_w, 3) float32, every element written.
int cald_resize_into_canvas(const unsigned char* pixels, const long long* meta, float* canvas,
                            int b, int canvas_h, int canvas_w, int device, void* stream) {
  if (b <= 0 || canvas_h <= 0 || canvas_w <= 0) return 0;
  if (b > 65535) return 2000 + static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return 2000 + static_cast<int>(set);
  const long long plane = static_cast<long long>(canvas_h) * canvas_w;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads), b);
  resize_into_canvas_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pixels, meta, canvas, canvas_h, canvas_w);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : 2000 + static_cast<int>(e);
}

}  // extern "C"
