// K2 signed distance: capped separable squared EDT, one axis per launch.
//
// Replaces plant3dvision_tpu/ops/edt.py:_minplus_pass / squared_edt /
// signed_distance (ops/edt.py:31-48, 66-78, 85-97).
//
// Semantics kept exactly (not Felzenszwalb's exact envelope, so the whole
// volume stays bit-equal to the JAX package): per axis a windowed min-plus
//     F'[i] = min(F[i], min_{s=1..c} min(F[i+s], F[i-s]) + s^2),
// c = min(cap, n_axis - 1), out-of-range neighbours skipped (JAX fills them
// with INF, which never wins), INF = f32(1e12). All finite values are
// integer sums below 2^24, so the f32 arithmetic is exact and the order of
// the minima does not matter.
//
// What bounds it on the card: per element and axis, 2c+1 reads and ~4c
// f32 operations per channel; with c = 20 that is ~500 operations per
// voxel over the three axes and both channels against 8 bytes of HBM
// traffic (volume in, signed distance out), so the passes are bound by
// instruction throughput and L1/L2 reads of the neighbours, not by HBM.
//
// Design: one thread per output element in C order, so a warp reads 32
// consecutive elements at every shift along any axis (coalesced, and the
// 2c+1 overlapping windows hit L1/L2). signed_distance carries both
// channels (inside and outside distance) through one launch per axis:
// the first pass derives both from the raw volume (> 0.5) on the fly, the
// last pass fuses the sqrt and the signed combine
// where(dist > 0.5, dist - 0.5, -mdist + 0.5).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e12f;

// MODE 0: src_a = raw volume -> out_a (inside), out_b (outside)
// MODE 1: (src_a, src_b) -> (out_a, out_b)
// MODE 2: (src_a, src_b) -> out_a = signed distance
// MODE 3: src_a = x -> out_a, single channel, F0 = x != 0 ? INF : 0
// MODE 4: src_a -> out_a, single channel
template <int MODE>
__global__ void edt_pass_kernel(const float* __restrict__ src_a,
                                const float* __restrict__ src_b,
                                float* __restrict__ out_a,
                                float* __restrict__ out_b, int nx, int ny,
                                int nz, int axis, int cap) {
  const long long n = (long long)nx * ny * nz;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int k = (int)(idx % nz);
  const long long r = idx / nz;
  const int j = (int)(r % ny);
  const int i = (int)(r / ny);
  int len, pos;
  long long stride;
  if (axis == 0) {
    len = nx; pos = i; stride = (long long)ny * nz;
  } else if (axis == 1) {
    len = ny; pos = j; stride = nz;
  } else {
    len = nz; pos = k; stride = 1;
  }
  const int c = cap < len - 1 ? cap : len - 1;
  constexpr bool two = (MODE <= 2);

  auto load = [&](long long q, float& a, float& b) {
    if (MODE == 0) {
      const bool in = src_a[q] > 0.5f;
      a = in ? kInf : 0.0f;
      b = in ? 0.0f : kInf;
    } else if (MODE == 3) {
      a = src_a[q] != 0.0f ? kInf : 0.0f;
    } else {
      a = src_a[q];
      if (two) b = src_b[q];
    }
  };

  float fa, fb = 0.0f;
  load(idx, fa, fb);
  for (int s = 1; s <= c; ++s) {
    const float s2 = (float)(s * s);
    if (pos + s < len) {
      float a, b = 0.0f;
      load(idx + s * stride, a, b);
      fa = fminf(fa, __fadd_rn(a, s2));
      if (two) fb = fminf(fb, __fadd_rn(b, s2));
    }
    if (pos - s >= 0) {
      float a, b = 0.0f;
      load(idx - s * stride, a, b);
      fa = fminf(fa, __fadd_rn(a, s2));
      if (two) fb = fminf(fb, __fadd_rn(b, s2));
    }
  }
  if (MODE == 2) {
    const float dist = __fsqrt_rn(fminf(fa, kInf));
    const float mdist = __fsqrt_rn(fminf(fb, kInf));
    out_a[idx] = dist > 0.5f ? __fsub_rn(dist, 0.5f) : __fadd_rn(-mdist, 0.5f);
  } else {
    out_a[idx] = fa;
    if (two) out_b[idx] = fb;
  }
}

}  // namespace

extern "C" int p3d_edt_pass(const void* src_a, const void* src_b,
                            void* out_a, void* out_b, int nx, int ny, int nz,
                            int axis, int cap, int mode, void* stream) {
  const long long n = (long long)nx * ny * nz;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const float* a = (const float*)src_a;
  const float* b = (const float*)src_b;
  float* oa = (float*)out_a;
  float* ob = (float*)out_b;
  switch (mode) {
    case 0: edt_pass_kernel<0><<<blocks, threads, 0, st>>>(a, b, oa, ob, nx, ny, nz, axis, cap); break;
    case 1: edt_pass_kernel<1><<<blocks, threads, 0, st>>>(a, b, oa, ob, nx, ny, nz, axis, cap); break;
    case 2: edt_pass_kernel<2><<<blocks, threads, 0, st>>>(a, b, oa, ob, nx, ny, nz, axis, cap); break;
    case 3: edt_pass_kernel<3><<<blocks, threads, 0, st>>>(a, b, oa, ob, nx, ny, nz, axis, cap); break;
    case 4: edt_pass_kernel<4><<<blocks, threads, 0, st>>>(a, b, oa, ob, nx, ny, nz, axis, cap); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
