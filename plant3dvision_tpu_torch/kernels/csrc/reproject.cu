// K7 reproject: per-label mask votes of a point cloud, summed over mask files.
//
// Replaces plant3dvision_tpu/ops/reproject.py:score_points_by_masks (the
// jitted scan behind SegmentedPointCloud). Per point n and mask file f, in
// file order: p = R_f p_n + t_f; pz = max(p2, 1e-9); the pixel is
// (trunc(p0/pz*fx + cx), trunc(p1/pz*fy + cy)); if p2 > 0 and the pixel is
// in the frame, scores[n, label_idx[f]] += mask_f[py, px] / 255.
//
// What bounds it on the card: per point-file pair ~20 f32 operations of
// projection and one byte read from the file's mask. The least work is that
// arithmetic over all pairs (operations), against the points and cameras read
// once, the scores written once and the distinct mask bytes the in-frame
// pairs touch (bytes). The 630 uint8 masks of a 126-view, 5-label scan at
// 896x896 (506 MB) do not fit the 50 MB L2; one file's (0.8 MB) does, and
// the threads of a block sweep the files in the same order, so each file is
// fetched from HBM roughly once per wave of blocks.
//
// Design: one thread per point, which holds its L <= 8 label sums in
// registers (L is a template parameter; the label of a file is selected by
// an unrolled compare, so the sums stay in registers), loops over the F files
// in order, projects once per file, reads one uint8 and divides it by 255
// (IEEE division, bit-equal to numpy's float32 mask / 255.0), and writes its
// (L,) row once. No atomics: every sum belongs to one thread and is taken in
// JAX's order (file order), so the scores are bit-equal to JAX's whenever the
// pixels are.
//
// Exactness: XLA on the CPU compiles the projection with the carve's fused
// multiply-adds (tests/test_torch_reproject.py finds the pattern: 0 of
// 900,000 points projected next to a pixel edge land on another pixel):
//   p_j = fma(R_j2, z, fma(R_j1, y, R_j0*x)) + t_j
//   px  = fma(p0/pz, fx, cx)
// The library is built with -fmad=false, so nvcc adds no contraction of its
// own. The f32 -> int32 casts truncate and saturate, as XLA's do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kMinZ = 1e-9f;   // ops/reproject.py: jnp.maximum(p2, 1e-9)

__device__ __forceinline__ float dot3_add(const float* r, float x, float y,
                                          float z, float t) {
  return __fadd_rn(__fmaf_rn(r[2], z, __fmaf_rn(r[1], y, __fmul_rn(r[0], x))),
                   t);
}

template <int L>
__global__ void reproject_kernel(const float* __restrict__ points,
                                 const uint8_t* __restrict__ masks,
                                 const float* __restrict__ cams,
                                 const int* __restrict__ label_idx, int N,
                                 int F, int H, int W,
                                 float* __restrict__ scores) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float x = points[3LL * n];
  const float y = points[3LL * n + 1];
  const float z = points[3LL * n + 2];
  float acc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] = 0.0f;
  const long long hw = (long long)H * W;
  for (int f = 0; f < F; ++f) {
    const float* cam = cams + 16 * f;
    // cam = [fx, fy, cx, cy, r00..r22 (row-major), t0, t1, t2]
    const float p0 = dot3_add(cam + 4, x, y, z, cam[13]);
    const float p1 = dot3_add(cam + 7, x, y, z, cam[14]);
    const float p2 = dot3_add(cam + 10, x, y, z, cam[15]);
    if (!(p2 > 0.0f)) continue;
    const float pz = p2 < kMinZ ? kMinZ : p2;
    const int px = __float2int_rz(__fmaf_rn(__fdiv_rn(p0, pz), cam[0], cam[2]));
    const int py = __float2int_rz(__fmaf_rn(__fdiv_rn(p1, pz), cam[1], cam[3]));
    if (px < 0 || px > W - 1 || py < 0 || py > H - 1) continue;
    const float v = __fdiv_rn((float)masks[f * hw + (long long)py * W + px],
                              255.0f);
    const int lab = label_idx[f];
#pragma unroll
    for (int l = 0; l < L; ++l)
      if (l == lab) acc[l] = __fadd_rn(acc[l], v);
  }
#pragma unroll
  for (int l = 0; l < L; ++l) scores[(long long)n * L + l] = acc[l];
}

template <int L>
cudaError_t launch(const void* points, const void* masks, const void* cams,
                   const void* label_idx, int N, int F, int H, int W,
                   void* scores, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  reproject_kernel<L><<<blocks, threads, 0, stream>>>(
      (const float*)points, (const uint8_t*)masks, (const float*)cams,
      (const int*)label_idx, N, F, H, W, (float*)scores);
  return cudaGetLastError();
}

}  // namespace

// points (N, 3) f32; masks (F, H, W) uint8; cams (F, 16) f32; label_idx (F,)
// int32; scores (N, L) f32 written whole. L is 1..8; a file whose label index
// is outside [0, L) adds nothing (JAX's one_hot of it is all zeros).
extern "C" int p3d_reproject(const void* points, const void* masks,
                             const void* cams, const void* label_idx, int N,
                             int F, int H, int W, int L, void* scores,
                             void* stream) {
  if (N == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define P3D_REP(NL)                                                         \
  case NL:                                                                  \
    return (int)launch<NL>(points, masks, cams, label_idx, N, F, H, W,      \
                           scores, s);
  switch (L) {
    P3D_REP(1)
    P3D_REP(2)
    P3D_REP(3)
    P3D_REP(4)
    P3D_REP(5)
    P3D_REP(6)
    P3D_REP(7)
    P3D_REP(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef P3D_REP
}
