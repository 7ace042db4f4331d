// K6 select: per-voxel multiclass selection of the labels' averaging scores.
//
// Replaces plant3dvision_tpu/ops/multiclass.py:_select (called by
// multiclass_select for the multiclass PointCloud).
//
// Per voxel, over the L label scores s[0..L-1] (s[bg] is the background's,
// when there is one):
//   s[bg] *= prior;
//   organ = first index of the largest s[l], l != bg;
//   res = bg if s[bg] > s[organ] (strictly: ties go to the organ) else organ;
//   for every label i != bg:
//     pred = (res == i) ? s[i] : 0;
//     if contrast_on: pred *= (s[i] > min_contrast * max_{j != i} s[j]);
//     out[i] = pred > min_score;
//   out[bg] = false.
// The scores are finite (averaged probabilities), so the comparisons need no
// NaN rule.
//
// What bounds it on the card: bytes. Each voxel reads L f32 scores and
// writes L bools (30 bytes a voxel at L = 6) against ~2L^2 comparisons, far
// below the card's ~20 operations per byte.
//
// Design: one thread per voxel; L (1..8) is a template parameter, so the
// scores stay in registers. Label planes are contiguous (L, n), so a warp's
// reads and writes of one label are coalesced.
//
// Exactness: the result is boolean and every operation is exact or one
// correctly rounded f32 multiply (-fmad=false), so kernel, plain version and
// JAX are equal.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

template <int L>
__global__ void select_kernel(const float* __restrict__ stack,
                              bool* __restrict__ out, long long n, int bg,
                              float prior, float min_contrast,
                              float min_score, int contrast_on) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s[L];
#pragma unroll
  for (int l = 0; l < L; ++l) s[l] = stack[l * n + idx];
  if (bg >= 0) {
#pragma unroll
    for (int l = 0; l < L; ++l)
      if (l == bg) s[l] = __fmul_rn(s[l], prior);
  }
  // argmax over the organs (the background row counts as -inf): first max
  float best = (bg == 0) ? -CUDART_INF_F : s[0];
  int organ = 0;
#pragma unroll
  for (int l = 1; l < L; ++l) {
    const float v = (l == bg) ? -CUDART_INF_F : s[l];
    if (v > best) {
      best = v;
      organ = l;
    }
  }
  int res = organ;
  if (bg >= 0) {
    float sb = 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l)
      if (l == bg) sb = s[l];
    if (sb > best) res = bg;
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    bool keep = false;
    if (i != bg) {
      float pred = (res == i) ? s[i] : 0.0f;
      if (contrast_on) {
        float others = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < L; ++j)
          if (j != i) others = fmaxf(others, s[j]);
        const bool ok = s[i] > __fmul_rn(min_contrast, others);
        pred = __fmul_rn(pred, ok ? 1.0f : 0.0f);
      }
      keep = pred > min_score;
    }
    out[i * n + idx] = keep;
  }
}

template <int L>
cudaError_t launch(const void* stack, void* out, long long n, int bg,
                   float prior, float min_contrast, float min_score,
                   int contrast_on, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  select_kernel<L><<<(unsigned)blocks, threads, 0, stream>>>(
      (const float*)stack, (bool*)out, n, bg, prior, min_contrast, min_score,
      contrast_on);
  return cudaGetLastError();
}

}  // namespace

// stack (L, n) f32 -> out (L, n) bool; bg = background row or -1. L is 1..8.
extern "C" int p3d_select(const void* stack, void* out, int L, long long n,
                          int bg, float prior, float min_contrast,
                          float min_score, int contrast_on, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define P3D_SEL(NL)                                                        \
  case NL:                                                                 \
    return (int)launch<NL>(stack, out, n, bg, prior, min_contrast,         \
                           min_score, contrast_on, s);
  switch (L) {
    P3D_SEL(1)
    P3D_SEL(2)
    P3D_SEL(3)
    P3D_SEL(4)
    P3D_SEL(5)
    P3D_SEL(6)
    P3D_SEL(7)
    P3D_SEL(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef P3D_SEL
}
