// K9 undistort: inverse-map OPENCV lens undistortion of a stack of images.
//
// Replaces plant3dvision_tpu/ops/undistort.py:undistort / undistort_batch
// (with distort_delta and bilinear_sample, ops/undistort.py:24-60): for each
// output pixel (u, v), x = (u - cx)/fx, y = (v - cy)/fy, the forward
// distortion displacement gives the source position px = u + dx*fx,
// py = v + dy*fy in the distorted image, which is sampled bilinearly (corner
// clipped to [0, W-2] x [0, H-2], weights to [0, 1]); a source outside
// [0, W-1] x [0, H-1] gives 0. Integer images are rounded half to even and
// clipped to [0, 255] (uint16 too, as the JAX function does); float32
// images are written as they are.
//
// What bounds it on the card: bytes. The stack is read about once (the map
// is close to the identity, so the four taps of neighbouring pixels share
// cache lines) and written once: 2 x 270 MB for 58 RGB images of 1440x1080.
// The map costs ~40 f32 operations per pixel, once for all the images.
//
// Design: one thread per output pixel; it computes the pixel's source
// position and weights once and then walks the N images and C channels, so
// a warp reads neighbouring source pixels and writes neighbouring output
// pixels of one image at a time. Types are a template parameter (uint8,
// uint16, float32).
//
// Exactness: the f32 operations of the JAX function as XLA compiles it on
// the CPU, fused multiply-adds exactly where XLA contracts them (the
// library is built with -fmad=false, so nvcc adds none of its own):
//   r2 = fma(x, x, y*y), rm = r2 * fma(r2, fma(r2, k3, k2), k1)
//   dx = fma(p2, fma(2x, x, r2), fma((2 p1) x, y, x*rm))
//   dy = fma((2 p2) x, y, fma(p1, r2 + (2y)*y, y*rm))
//   px = fma(dx, fx, u), py = fma(dy, fy, v)
//   lerp(a, b, w) = fma(a, 1 - w, b*w); for a 2-D (H, W) image the row
//   lerps are fma(b, w, a*(1 - w)) (XLA fuses them the other way there)
// (tests/test_torch_frontend.py holds the plain version bit-equal to JAX).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Camera {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3;
};

__device__ __forceinline__ float lerp_a(float a, float b, float w) {
  return __fmaf_rn(a, __fsub_rn(1.0f, w), __fmul_rn(b, w));
}

__device__ __forceinline__ float lerp_b(float a, float b, float w) {
  return __fmaf_rn(b, w, __fmul_rn(a, __fsub_rn(1.0f, w)));
}

template <typename T>
__device__ __forceinline__ T store_value(float v);

template <>
__device__ __forceinline__ uint8_t store_value<uint8_t>(float v) {
  return (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

template <>
__device__ __forceinline__ uint16_t store_value<uint16_t>(float v) {
  return (uint16_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

template <>
__device__ __forceinline__ float store_value<float>(float v) {
  return v;
}

template <typename T>
__global__ void undistort_kernel(const T* __restrict__ in,
                                 T* __restrict__ out, int N, int H, int W,
                                 int C, int gray2d, Camera cam) {
  const long long npix = (long long)H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= npix) return;
  const int u = (int)(idx % W);
  const int v = (int)(idx / W);
  const float uf = (float)u;
  const float vf = (float)v;

  const float x = __fdiv_rn(__fsub_rn(uf, cam.cx), cam.fx);
  const float y = __fdiv_rn(__fsub_rn(vf, cam.cy), cam.fy);
  const float r2 = __fmaf_rn(x, x, __fmul_rn(y, y));
  const float rm = __fmul_rn(
      r2, __fmaf_rn(r2, __fmaf_rn(r2, cam.k3, cam.k2), cam.k1));
  const float dx = __fmaf_rn(
      cam.p2, __fmaf_rn(__fmul_rn(2.0f, x), x, r2),
      __fmaf_rn(__fmul_rn(__fmul_rn(2.0f, cam.p1), x), y, __fmul_rn(x, rm)));
  const float dy = __fmaf_rn(
      __fmul_rn(__fmul_rn(2.0f, cam.p2), x), y,
      __fmaf_rn(cam.p1, __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, y), y)),
                __fmul_rn(y, rm)));
  const float px = __fmaf_rn(dx, cam.fx, uf);
  const float py = __fmaf_rn(dy, cam.fy, vf);
  const bool inside = px >= 0.0f && px <= (float)(W - 1) && py >= 0.0f &&
                      py <= (float)(H - 1);
  // fmaxf maps a NaN to 0: such a pixel is outside, and the taps stay in
  // the frame
  const float x0 = fminf(fmaxf(floorf(px), 0.0f), (float)(W - 2));
  const float y0 = fminf(fmaxf(floorf(py), 0.0f), (float)(H - 2));
  const float gx = fminf(fmaxf(__fsub_rn(px, x0), 0.0f), 1.0f);
  const float gy = fminf(fmaxf(__fsub_rn(py, y0), 0.0f), 1.0f);
  const long long t00 = ((long long)y0 * W + (long long)x0) * C;
  const long long t10 = t00 + (long long)W * C;

  for (int n = 0; n < N; ++n) {
    const T* img = in + (long long)n * npix * C;
    T* dst = out + (long long)n * npix * C + idx * C;
    for (int c = 0; c < C; ++c) {
      float val = 0.0f;
      if (inside) {
        const float i00 = (float)img[t00 + c];
        const float i01 = (float)img[t00 + C + c];
        const float i10 = (float)img[t10 + c];
        const float i11 = (float)img[t10 + C + c];
        const float top = gray2d ? lerp_b(i00, i01, gx) : lerp_a(i00, i01, gx);
        const float bot = gray2d ? lerp_b(i10, i11, gx) : lerp_a(i10, i11, gx);
        val = lerp_a(top, bot, gy);
      }
      dst[c] = store_value<T>(val);
    }
  }
}

template <typename T>
cudaError_t launch(const void* in, void* out, int N, int H, int W, int C,
                   int gray2d, Camera cam, cudaStream_t s) {
  const long long npix = (long long)H * W;
  if (npix == 0 || N == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (npix + threads - 1) / threads;
  undistort_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(
      (const T*)in, (T*)out, N, H, W, C, gray2d, cam);
  return cudaGetLastError();
}

}  // namespace

// in, out (N, H, W, C) contiguous, of one type (dtype 0 uint8, 1 uint16,
// 2 float32); gray2d = 1 when the images are 2-D (C = 1, no channel axis).
extern "C" int p3d_undistort(const void* in, void* out, int N, int H, int W,
                             int C, int dtype, int gray2d, float fx,
                             float fy, float cx, float cy, float k1,
                             float k2, float p1, float p2, float k3,
                             void* stream) {
  const Camera cam{fx, fy, cx, cy, k1, k2, p1, p2, k3};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch<uint8_t>(in, out, N, H, W, C, gray2d, cam, s);
    case 1: return (int)launch<uint16_t>(in, out, N, H, W, C, gray2d, cam, s);
    case 2: return (int)launch<float>(in, out, N, H, W, C, gray2d, cam, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
