// K10 mask filter: vegetation filter + threshold of a stack of images.
//
// Replaces plant3dvision_tpu/ops/masks.py:compute_mask's filter and
// threshold (rescale01 :17, linear_filter :31, excess_green :38; the
// dilation is K8) with the arithmetic of the host function the JAX Masks
// task runs, compute_mask_numpy (ops/masks.py:110-166), so that the masks
// are the JAX task's:
//   - fast lane (uint8, linear, binarised, one positive coefficient c at
//     channel k): img[..., k] > t, t = threshold*255.0/c as numpy computes
//     it (float32 under NEP 50; the wrapper passes it in);
//   - otherwise each channel is rescaled to [0, 1] (uint8 / 255, uint16 /
//     65535 as IEEE divisions; a float image as (x - lo) / max(hi - lo,
//     1e-12) with its own min and max, which the wrapper reduces first),
//     then filtered:
//       linear: numpy's matmul over the first n <= 4 channels, as its BLAS
//       sums them: fma(x2, c2, fma(x1, c1, x0*c0)) for n <= 3, and
//       (x0*c0 + x1*c1) + (x2*c2 + x3*c3) for n = 4;
//       excess_green: s = max((x0 + x1) + x2, 1e-12), then
//       ((2 (x1/s)) - x0/s) - x2/s;
//     and either compared, value > threshold in float32 (binarised, written
//     as bool), or clipped to [0, 1] (written as float32).
//
// What bounds it on the card: bytes. The stack is read once (3 bytes a
// pixel for RGB uint8) and the mask written once (1 byte a pixel): 270 MB
// + 90 MB for 58 images of 1440x1080. A pixel costs at most ~12 f32
// operations.
//
// Design: one thread per pixel, neighbouring threads on neighbouring
// pixels; the channels of a pixel are read by its thread. The image type is
// a template parameter (uint8, uint16, float32).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { kFast = 0, kLinear = 1, kExcessGreen = 2 };

struct Filter {
  int mode, n, channel, binarize;
  float c[4];
  float threshold;   // float32(threshold): the compare of the float lanes
  float fast_t;      // the fast lane's threshold
  float scale;       // 255 (uint8) or 65535 (uint16); 0 for float images
};

__device__ __forceinline__ float rescale(float v, float scale,
                                         const float* range) {
  if (scale != 0.0f) return __fdiv_rn(v, scale);
  return __fdiv_rn(__fsub_rn(v, range[0]), range[1]);
}

template <typename T>
__global__ void mask_kernel(const T* __restrict__ in, void* __restrict__ out,
                            long long npix, long long plane, int C, Filter f,
                            const float* __restrict__ ranges) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= npix) return;
  const T* px = in + idx * C;
  if (f.mode == kFast) {
    ((uint8_t*)out)[idx] = (float)px[f.channel] > f.fast_t;
    return;
  }
  const float* range = ranges ? ranges + 2 * (idx / plane) : nullptr;
  float x[4];
  const int nc = f.mode == kLinear ? f.n : 3;
  for (int i = 0; i < nc; ++i) x[i] = rescale((float)px[i], f.scale, range);
  float val;
  if (f.mode == kLinear) {
    if (f.n == 4) {
      val = __fadd_rn(__fadd_rn(__fmul_rn(x[0], f.c[0]),
                                __fmul_rn(x[1], f.c[1])),
                      __fadd_rn(__fmul_rn(x[2], f.c[2]),
                                __fmul_rn(x[3], f.c[3])));
    } else {
      val = __fmul_rn(x[0], f.c[0]);
      for (int i = 1; i < f.n; ++i) val = __fmaf_rn(x[i], f.c[i], val);
    }
  } else {
    const float s = fmaxf(__fadd_rn(__fadd_rn(x[0], x[1]), x[2]), 1e-12f);
    val = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, __fdiv_rn(x[1], s)),
                              __fdiv_rn(x[0], s)),
                    __fdiv_rn(x[2], s));
  }
  if (f.binarize)
    ((uint8_t*)out)[idx] = val > f.threshold;
  else
    ((float*)out)[idx] = fminf(fmaxf(val, 0.0f), 1.0f);
}

template <typename T>
cudaError_t launch(const void* in, void* out, long long npix, long long plane,
                   int C, const Filter& f, const float* ranges,
                   cudaStream_t s) {
  if (npix == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (npix + threads - 1) / threads;
  mask_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(
      (const T*)in, out, npix, plane, C, f, ranges);
  return cudaGetLastError();
}

}  // namespace

// in (N, H, W, C) contiguous (dtype 0 uint8, 1 uint16, 2 float32); out
// (N, H, W) uint8 0/1 (binarize or the fast lane) or float32; coefs (host)
// n floats; ranges (device) N (lo, max(hi - lo, 1e-12)) float32 pairs for a
// float image, else null.
extern "C" int p3d_mask(const void* in, void* out, int N, int H, int W, int C,
                        int dtype, int mode, const float* coefs, int n,
                        int channel, int binarize, float threshold,
                        float fast_t, const void* ranges, void* stream) {
  if (mode < kFast || mode > kExcessGreen || n < 0 || n > 4 ||
      (mode == kLinear && (n < 1 || n > C)) ||
      (mode == kExcessGreen && C < 3) || channel < 0 || channel >= C ||
      dtype < 0 || dtype > 2 || (dtype == 2 && ranges == nullptr))
    return (int)cudaErrorInvalidValue;
  Filter f{mode, n, channel, binarize, {0.f, 0.f, 0.f, 0.f}, threshold,
           fast_t, dtype == 0 ? 255.0f : (dtype == 1 ? 65535.0f : 0.0f)};
  for (int i = 0; i < n; ++i) f.c[i] = coefs[i];
  const long long plane = (long long)H * W;
  const long long npix = plane * N;
  const float* r = (const float*)ranges;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch<uint8_t>(in, out, npix, plane, C, f, r, s);
    case 1: return (int)launch<uint16_t>(in, out, npix, plane, C, f, r, s);
    default: return (int)launch<float>(in, out, npix, plane, C, f, r, s);
  }
}
