// K3 gradient + Gaussian: np.gradient differences, then a separable
// Gaussian with scipy's 'reflect' (symmetric) boundary, one axis per launch.
//
// Replaces plant3dvision_tpu/ops/filters.py:gradient and gaussian_filter
// (_conv1d_along, ops/filters.py:24-61), as vol2pcd runs them: three
// gradients of the signed distance, then sigma = 1 (radius 4, 9 taps)
// along x, y, z for each.
//
// What bounds it on the card: the 12 launches stream 4 bytes in and 4 out
// per element each (the ideal fused function reads the signed distance
// once and writes three gradients, 16 bytes per voxel), with 17 f32
// operations per element per Gaussian pass. So it is bound by HBM
// traffic of the unfused passes; the 9-tap window reuse is served by
// L1/L2.
//
// Design: one thread per output element in C order, so the taps along
// any axis are read coalesced across the warp. The taps come from
// gaussian_kernel1d (float64 -> float32) as kernel arguments. The sum runs
// tap 0 to tap 2r with separate multiply and add (no FMA), which is also
// what the plain PyTorch version does; XLA's convolution sums in another
// order, so the result is held to a tolerance against the JAX package.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRadius = 16;

struct Taps {
  float w[2 * kMaxRadius + 1];
};

__device__ __forceinline__ void decompose(long long idx, int nx, int ny,
                                          int nz, int axis, int& len,
                                          int& pos, long long& stride) {
  const int k = (int)(idx % nz);
  const long long r = idx / nz;
  const int j = (int)(r % ny);
  const int i = (int)(r / ny);
  if (axis == 0) {
    len = nx; pos = i; stride = (long long)ny * nz;
  } else if (axis == 1) {
    len = ny; pos = j; stride = nz;
  } else {
    len = nz; pos = k; stride = 1;
  }
}

__global__ void gradient_kernel(const float* __restrict__ x,
                                float* __restrict__ g, int nx, int ny,
                                int nz, int axis) {
  const long long n = (long long)nx * ny * nz;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int len, pos;
  long long stride;
  decompose(idx, nx, ny, nz, axis, len, pos, stride);
  float v;
  if (pos == 0) {
    v = __fsub_rn(x[idx + stride], x[idx]);
  } else if (pos == len - 1) {
    v = __fsub_rn(x[idx], x[idx - stride]);
  } else {
    v = __fmul_rn(__fsub_rn(x[idx + stride], x[idx - stride]), 0.5f);
  }
  g[idx] = v;
}

// symmetric extension of [0, len): -1 -> 0, -2 -> 1, len -> len-1, ...
__device__ __forceinline__ int reflect(int q, int len) {
  const int period = 2 * len;
  q %= period;
  if (q < 0) q += period;
  return q < len ? q : period - 1 - q;
}

__global__ void gauss_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int nx, int ny, int nz,
                             int axis, Taps taps, int radius) {
  const long long n = (long long)nx * ny * nz;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int len, pos;
  long long stride;
  decompose(idx, nx, ny, nz, axis, len, pos, stride);
  const long long base = idx - (long long)pos * stride;
  float acc = 0.0f;
  for (int t = 0; t <= 2 * radius; ++t) {
    const int q = reflect(pos - radius + t, len);
    acc = __fadd_rn(acc, __fmul_rn(taps.w[t], x[base + (long long)q * stride]));
  }
  y[idx] = acc;
}

}  // namespace

extern "C" int p3d_gradient(const void* x, void* g, int nx, int ny, int nz,
                            int axis, void* stream) {
  const long long n = (long long)nx * ny * nz;
  const int threads = 256;
  gradient_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                    (cudaStream_t)stream>>>((const float*)x, (float*)g, nx,
                                            ny, nz, axis);
  return (int)cudaGetLastError();
}

extern "C" int p3d_gauss(const void* x, void* y, int nx, int ny, int nz,
                         int axis, const void* taps, int radius,
                         void* stream) {
  if (radius < 0 || radius > kMaxRadius) return (int)cudaErrorInvalidValue;
  Taps t = {};
  const float* w = (const float*)taps;  // host memory, 2*radius+1 floats
  for (int q = 0; q <= 2 * radius; ++q) t.w[q] = w[q];
  const long long n = (long long)nx * ny * nz;
  const int threads = 256;
  gauss_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                 (cudaStream_t)stream>>>((const float*)x, (float*)y, nx, ny,
                                         nz, axis, t, radius);
  return (int)cudaGetLastError();
}
