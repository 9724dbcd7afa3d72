// K8: the epilogue of every convolution of the detector's trunk (ResNet +
// FPN) on the inference route, one pass over the convolution's output:
//
//   out = act(y + bias [+ r])
//
// computed in float32 and rounded once to the activation dtype, written in
// place over y. y is the convolution's output (cuDNN's, with every frozen
// norm folded into the weights and no bias): (B, C, H, W) contiguous in
// channels-last memory, so element (b, h, w, c) of an NHWC array, bfloat16
// or float32, C a multiple of 8. bias is float32 (C,): the folded norm's
// shift, the conv's own bias, or the sum of two shifts (a bottleneck's conv3
// and its projection shortcut). r is optional and takes one of two forms:
//   mode 1: a tensor of y's shape (the identity or the projection shortcut
//           of a bottleneck, or an FPN level of equal size);
//   mode 2: a level at half the resolution, (B, C, H / 2, W / 2), read at
//           (h / 2, w / 2): nearest-neighbour upsampling with half-pixel
//           centres (F.interpolate(mode="nearest-exact")) for sizes exactly
//           double, the FPN's top-down merge.
// act is ReLU (NaN kept, as torch.relu) or the identity. The additions run
// in the order (y + bias) + r, as the plain version
// (ops/conv_epilogue.py::conv_epilogue) writes them, so the two agree bit
// for bit.
//
// It replaces no TPU kernel: the JAX package leaves these passes to XLA,
// which fuses them into its convolutions. In PyTorch eager mode each was a
// pass of its own over the activations (the frozen norm's multiply and
// add, the ReLUs, the residual add, the conv bias add, the upsample and the
// merge add); this kernel is the one pass that is left once the norms are
// folded into the weights.
//
// What bounds it on the H100: bytes. It reads y (and r) once and writes the
// output once, one or two float32 additions and a max an element; at the
// layer-1 conv3 of R50 on the 640x1024 canvas (B = 16, 160x256, C = 256,
// identity residual) that is 3 x 336 MB, 0.30 ms at 3.35 TB/s. The design:
// each thread moves 16 bytes a load (8 bfloat16 or 4 float32 values of one
// pixel's channels), neighbouring threads on neighbouring channels, so a
// warp reads 512 contiguous bytes. A grid-stride loop over the vectors runs
// as many blocks as the SMs hold at once; when that stride is a multiple of
// the vectors a pixel has (every power-of-two C up to 4096 on 132 SMs) a
// thread stays on its channels, and reads its bias vector once, from L1.
// Otherwise it steps its channel index and reloads the bias each vector.
// No allocation, no synchronisation: one launch on the caller's stream, and
// the entry point returns cudaGetLastError.
//
// Entry point (C, ctypes):
//   cald_conv_epilogue(y, bias, r, mode, relu, dtype, b, h, w, c, stream)
// dtype 0 float32, 1 bfloat16; mode 0 (no r), 1 or 2 as above; the caller
// checks shapes, layouts and 16-byte alignment. Returns 0 or a CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 p = __bfloat1622float2(h[k]);
      f[2 * k] = p.x;
      f[2 * k + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return u;
  }
};

template <int kN>
__device__ inline void load_bias(const float* bias, unsigned c, float* b) {
  const float4* p = reinterpret_cast<const float4*>(bias) + c * (kN / 4);
#pragma unroll
  for (int k = 0; k < kN / 4; ++k) {
    const float4 v = __ldg(p + k);
    b[4 * k] = v.x;
    b[4 * k + 1] = v.y;
    b[4 * k + 2] = v.z;
    b[4 * k + 3] = v.w;
  }
}

// n vectors of 16 bytes in y; cv of them a pixel; the output's h x w pixels
// an image (mode 2 reads r's (h / 2) x (w / 2), r_w = w / 2 pixels a row)
template <typename T, int kMode, bool kRelu>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(uint4* __restrict__ y, const float* __restrict__ bias,
                     const uint4* __restrict__ r, unsigned n, unsigned cv, unsigned h,
                     unsigned w) {
  constexpr int kN = Pack<T>::kN;
  const unsigned stride = gridDim.x * blockDim.x;
  unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned step = stride % cv;
  unsigned c = i % cv;
  float b[kN];
  load_bias<kN>(bias, c, b);
  for (; i < n; i += stride) {
    float v[kN];
    Pack<T>::unpack(y[i], v);
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] += b[k];
    if (kMode != 0) {
      size_t ri = i;
      if (kMode == 2) {
        const unsigned p = i / cv;              // the output pixel
        const unsigned x = p % w, q = p / w;    // its column, image row
        const unsigned row = q % h, img = q / h;
        ri = ((static_cast<size_t>(img) * (h / 2) + row / 2) * (w / 2) + x / 2) * cv + c;
      }
      float s[kN];
      Pack<T>::unpack(__ldg(r + ri), s);
#pragma unroll
      for (int k = 0; k < kN; ++k) v[k] += s[k];
    }
    if (kRelu) {
#pragma unroll
      for (int k = 0; k < kN; ++k) v[k] = v[k] < 0.f ? 0.f : v[k];
    }
    y[i] = Pack<T>::pack(v);
    if (step != 0) {
      c += step;
      if (c >= cv) c -= cv;
      load_bias<kN>(bias, c, b);
    }
  }
}

int blocks_per_sm_cache[2][3][2];     // per instantiation, 0 until asked

template <typename T, int kMode, bool kRelu>
cudaError_t launch(void* y, const float* bias, const void* r, int b, int h, int w, int c,
                   cudaStream_t stream) {
  constexpr int kN = Pack<T>::kN;
  const unsigned cv = static_cast<unsigned>(c / kN);
  const unsigned n = static_cast<unsigned>(b) * h * w * cv;
  if (n == 0) return cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  int& per_sm = blocks_per_sm_cache[sizeof(T) == 2][kMode][kRelu];
  if (per_sm == 0) {
    int got = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &got, conv_epilogue_kernel<T, kMode, kRelu>, kThreads, 0);
    if (e != cudaSuccess) return e;
    per_sm = got > 0 ? got : 1;
  }
  const unsigned needed = (n + kThreads - 1) / kThreads;
  const unsigned resident = static_cast<unsigned>(sms) * per_sm;
  const unsigned blocks = needed < resident ? needed : resident;
  conv_epilogue_kernel<T, kMode, kRelu><<<blocks, kThreads, 0, stream>>>(
      static_cast<uint4*>(y), bias, static_cast<const uint4*>(r), n, cv,
      static_cast<unsigned>(h), static_cast<unsigned>(w));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(void* y, const float* bias, const void* r, int mode, int relu, int b,
                     int h, int w, int c, cudaStream_t s) {
  switch (mode * 2 + (relu ? 1 : 0)) {
    case 0: return launch<T, 0, false>(y, bias, r, b, h, w, c, s);
    case 1: return launch<T, 0, true>(y, bias, r, b, h, w, c, s);
    case 2: return launch<T, 1, false>(y, bias, r, b, h, w, c, s);
    case 3: return launch<T, 1, true>(y, bias, r, b, h, w, c, s);
    case 4: return launch<T, 2, false>(y, bias, r, b, h, w, c, s);
    case 5: return launch<T, 2, true>(y, bias, r, b, h, w, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int cald_conv_epilogue(void* y, const float* bias, const void* r, int mode, int relu,
                       int dtype, int b, int h, int w, int c, void* stream) {
  if (b < 0 || h < 0 || w < 0 || c <= 0 || c % 8 != 0) return cudaErrorInvalidValue;
  if ((mode == 2 && (h % 2 != 0 || w % 2 != 0)) || (mode != 0 && r == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<float>(y, bias, r, mode, relu, b, h, w, c, s);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(y, bias, r, mode, relu, b, h, w, c, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"
