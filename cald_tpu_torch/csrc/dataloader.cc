// cald_tpu native data-loader core.
//
// The reference feeds its models through torch DataLoader worker processes
// whose decode path is libjpeg-turbo + PIL (C) — see SURVEY.md §2.1. This
// library is the cald_tpu equivalent: JPEG decode + box-filtered bilinear
// resize + canvas paste in one C++ pass, callable from Python threads via
// ctypes (ctypes releases the GIL, so a thread pool of these calls keeps all
// host cores decoding while the TPU computes).
//
// API (C, stable):
//   cald_decode_resize(path, canvas_h, canvas_w, scale, out, out_h, out_w)
//     decodes `path` (JPEG), bilinear-resizes the image by `scale`, writes the
//     result into the float32 RGB canvas `out` (canvas_h x canvas_w x 3,
//     zero-filled by the caller or overwritten here), returns 0 on success.
//   cald_image_size(path, &w, &h)  -> header-only size probe (no full decode).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file into an RGB uint8 buffer. Returns true on success.
bool DecodeJpeg(const char* path, std::vector<uint8_t>* pixels, int* width,
                int* height) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *width = cinfo.output_width;
  *height = cinfo.output_height;
  const int stride = cinfo.output_width * cinfo.output_components;
  pixels->resize(static_cast<size_t>(stride) * cinfo.output_height);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels->data() +
                   static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// Bilinear resize (PIL-compatible pixel-center convention) of an RGB uint8
// image into a float32 canvas region [0:out_h, 0:out_w].
void ResizeIntoCanvas(const uint8_t* src, int sw, int sh, float* canvas,
                      int canvas_w, int out_h, int out_w) {
  const float sx_ratio = static_cast<float>(sw) / out_w;
  const float sy_ratio = static_cast<float>(sh) / out_h;
  for (int oy = 0; oy < out_h; ++oy) {
    float sy = (oy + 0.5f) * sy_ratio - 0.5f;
    sy = std::min(std::max(sy, 0.0f), static_cast<float>(sh - 1));
    const int y0 = static_cast<int>(sy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float ly = sy - y0;
    float* out_row = canvas + static_cast<size_t>(oy) * canvas_w * 3;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * 3;
    for (int ox = 0; ox < out_w; ++ox) {
      float sx = (ox + 0.5f) * sx_ratio - 0.5f;
      sx = std::min(std::max(sx, 0.0f), static_cast<float>(sw - 1));
      const int x0 = static_cast<int>(sx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float lx = sx - x0;
      const float w00 = (1 - ly) * (1 - lx), w01 = (1 - ly) * lx;
      const float w10 = ly * (1 - lx), w11 = ly * lx;
      for (int c = 0; c < 3; ++c) {
        out_row[ox * 3 + c] = w00 * r0[x0 * 3 + c] + w01 * r0[x1 * 3 + c] +
                              w10 * r1[x0 * 3 + c] + w11 * r1[x1 * 3 + c];
      }
    }
  }
}

}  // namespace

extern "C" {

// Header-only size probe. Returns 0 on success.
int cald_image_size(const char* path, int* width, int* height) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *width = cinfo.image_width;
  *height = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

// Decode + resize-by-scale + paste into a zeroed float32 canvas.
// out must point at canvas_h * canvas_w * 3 floats. Writes the resized size
// into (*out_h, *out_w). Returns 0 on success, nonzero on decode failure or
// when the resized image does not fit the canvas.
int cald_decode_resize(const char* path, int canvas_h, int canvas_w,
                       float scale, float* out, int* out_h, int* out_w) {
  std::vector<uint8_t> pixels;
  int w = 0, h = 0;
  if (!DecodeJpeg(path, &pixels, &w, &h)) return 1;
  // nearbyint = round-half-to-even, matching Python's round() used by the
  // PIL fallback path (cald_tpu/data/batching.py make_padded_batch)
  const int rh = static_cast<int>(std::nearbyint(h * scale));
  const int rw = static_cast<int>(std::nearbyint(w * scale));
  if (rh > canvas_h || rw > canvas_w || rh <= 0 || rw <= 0) return 2;
  ResizeIntoCanvas(pixels.data(), w, h, out, canvas_w, rh, rw);
  *out_h = rh;
  *out_w = rw;
  return 0;
}

// Plain decode into a uint8 RGB buffer of exactly width*height*3 bytes
// (caller probes the size first with cald_image_size). Returns 0 on success.
int cald_decode(const char* path, uint8_t* out, int width, int height) {
  std::vector<uint8_t> pixels;
  int w = 0, h = 0;
  if (!DecodeJpeg(path, &pixels, &w, &h)) return 1;
  if (w != width || h != height) return 2;
  std::memcpy(out, pixels.data(), pixels.size());
  return 0;
}

}  // extern "C"
