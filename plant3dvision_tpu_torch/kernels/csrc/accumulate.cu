// K5 accumulate: multi-label averaging carve of one batch of CNN outputs.
//
// Replaces plant3dvision_tpu/ops/ml_fused.py:_accumulate_core, as called by
// accumulate_label_views (whole grid) and accumulate_label_views_slab (an
// x-slab of the grid, with the global x offset in the projection); and, in
// its `avg` mode at C = 1 (K5-avg), plant3dvision_tpu/ops/carving.py:average
// and average_chunked (the Voxels(type="averaging") volume of one label's
// masks, the x offset of a slab in the projection, the slab stored alone).
//
// Per voxel and view of the batch: project the voxel centre (the
// projection of ops/carving.py:_project), then, if the view is valid and
// the voxel lands in the frame, add the view's C label values at the
// projection to the voxel's C running sums:
//   bilinear: 4 taps around (x0, y0) = (floor px, floor py), clipped to
//             [0, W-2] x [0, H-2], weighted by the fractional parts;
//   box:      one tap of the 2x2 edge-padded box prefilter of the map,
//             i.e. 0.25 * the sum of the 4 pixels {x0-1, x0} x {y0-1, y0}
//             (edge-clamped), computed here from those 4 pixels;
//   log_mode: every pixel value p is replaced by log(EPS + p) before it is
//             sampled (and before the box prefilter).
//
// What bounds it on the card: per voxel-view, ~24 f32 operations of
// projection and, per label, 4 random reads from the view's (H, W) label
// plane and ~8 operations. One view's 6 planes at 896x896 are 19 MB and stay
// in the 50 MB L2 while the voxels of a launch sweep them; a 32-view batch
// (616 MB) does not, so each view's planes are fetched from HBM about once
// per launch and then served from L2. The least work is the projection and
// tap arithmetic of the in-frame voxel-views (operations), just above the
// bytes (batch read once, volume read and written once); in practice the
// kernel is bound by the latency of the gathers. K5-avg is the same at C = 1:
// one f32 mask plane per view (3.2 MB at 896x896) stays in L2; the 126-view
// stack of one label (405 MB) is read about once per launch.
//
// Design: one thread per voxel of the (slab) grid, flat index in C order (z
// fastest), so a warp's voxels are neighbours along z and project to
// neighbouring pixels (L1/L2 sector reuse on the gathers). The thread holds
// its C sums in registers (C is a template parameter), loops over the
// batch's views in order, projects once per view and gathers a C-vector per
// tap. The volume is read once and written once per launch; no atomics: each
// voxel's sums belong to one thread.
//
// Exactness: the operations and their order are those of the JAX program as
// XLA compiles it on the CPU (the reference the tests hold the port to),
// including where XLA contracts multiply-adds into fused multiply-adds. In
// _accumulate_core that is (found by testing contraction patterns against
// JAX on one-view coordinate maps, tests/test_torch_ml.py):
//   x  = fma(vs, i, origin)                   (unlike the carve's program)
//   pz = fma(r8, z, fma(r7, y, r6*x)) + t2     (likewise for the numerators)
//   px = fma(num/pz, fx, cx)
//   bilinear value = fma(v11, w11, fma(v10, w10, fma(v00, w00, v01*w01)))
// In `average` (avg mode; tests/test_torch_seg.py, bit-equal on one view of
// a 64^3 grid) the x coordinate is unfused, as in the carve, and the value,
// written g00*(1-fx)*(1-fy) + g01*fx*(1-fy) + g10*(1-fx)*fy + g11*fx*fy, is
//   fma(g11*fx, fy, fma(g10*gx, fy, fma(g01*fx, gy, (g00*gx)*gy)))
// with gx = 1-fx, gy = 1-fy; its masks arrive already scaled (and log'd) by
// the caller, so the kernel runs it with log_mode 0.
// The library is built with -fmad=false, so nvcc adds no contraction of its
// own, and the plain version (ops/ml_fused.py) repeats every operation, so
// kernel and plain version agree to the last bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-9f;   // plant3dvision_tpu/ops/carving.py:EPS

__device__ __forceinline__ float dot3_add(float a, float b, float c,
                                          float x, float y, float z,
                                          float t) {
  const float s = __fmaf_rn(c, z, __fmaf_rn(b, y, __fmul_rn(a, x)));
  return __fadd_rn(s, t);
}

__device__ __forceinline__ float tap(const float* __restrict__ p,
                                     long long i, int log_mode) {
  const float v = p[i];
  return log_mode ? logf(__fadd_rn(kEps, v)) : v;
}

__device__ __forceinline__ float grid_coord(float o, float vs, int i,
                                            int avg) {
  return avg ? __fadd_rn(o, __fmul_rn(vs, (float)i))
             : __fmaf_rn(vs, (float)i, o);
}

template <int C>
__global__ void accumulate_kernel(float* __restrict__ vol,
                                  const float* __restrict__ probs,
                                  const float* __restrict__ cams,
                                  const uint8_t* __restrict__ valid, int B,
                                  int H, int W, float ox, float oy, float oz,
                                  float vs, int nx, int ny, int nz,
                                  int x_start, int slab_nx, int log_mode,
                                  int box, int avg, int store_x0) {
  const long long n = (long long)slab_nx * ny * nz;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int k = (int)(idx % nz);
  const long long r = idx / nz;
  const int j = (int)(r % ny);
  const int gi = x_start + (int)(r / ny);          // global x index
  const float x = grid_coord(ox, vs, gi, avg);
  const float y = grid_coord(oy, vs, j, avg);
  const float z = grid_coord(oz, vs, k, avg);

  // the volume stores the x rows [store_x0, store_x0 + nx)
  const long long plane = (long long)nx * ny * nz;  // one label's volume
  const long long off = ((long long)(gi - store_x0) * ny + j) * nz + k;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = vol[c * plane + off];

  const long long hw = (long long)H * W;
  for (int b = 0; b < B; ++b) {
    if (!valid[b]) continue;
    const float* cam = cams + 16 * b;
    // cam = [fx, fy, cx, cy, r00..r22 (row-major), t0, t1, t2]
    const float pz = dot3_add(cam[10], cam[11], cam[12], x, y, z, cam[15]);
    const float nxp = dot3_add(cam[4], cam[5], cam[6], x, y, z, cam[13]);
    const float nyp = dot3_add(cam[7], cam[8], cam[9], x, y, z, cam[14]);
    const float px = __fmaf_rn(__fdiv_rn(nxp, pz), cam[0], cam[2]);
    const float py = __fmaf_rn(__fdiv_rn(nyp, pz), cam[1], cam[3]);
    // in frame: trunc(p) in [0, W-1]  <=>  -1 < p < W
    if (!(pz > 0.0f) || !(px > -1.0f) || !(px < (float)W) ||
        !(py > -1.0f) || !(py < (float)H))
      continue;
    const float fx0 = fminf(fmaxf(floorf(px), 0.0f), (float)(W - 2));
    const float fy0 = fminf(fmaxf(floorf(py), 0.0f), (float)(H - 2));
    const int x0 = (int)fx0;
    const int y0 = (int)fy0;
    const float* pb = probs + (long long)b * C * hw;
    if (box) {
      const long long ym = (long long)max(y0 - 1, 0) * W;
      const long long yc = (long long)y0 * W;
      const int xm = max(x0 - 1, 0);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* p = pb + c * hw;
        const float s = __fadd_rn(
            __fadd_rn(__fadd_rn(tap(p, ym + xm, log_mode),
                                tap(p, ym + x0, log_mode)),
                      tap(p, yc + xm, log_mode)),
            tap(p, yc + x0, log_mode));
        acc[c] = __fadd_rn(acc[c], __fmul_rn(0.25f, s));
      }
    } else {
      const float fx = fminf(fmaxf(__fsub_rn(px, fx0), 0.0f), 1.0f);
      const float fy = fminf(fmaxf(__fsub_rn(py, fy0), 0.0f), 1.0f);
      const float gx = __fsub_rn(1.0f, fx);
      const float gy = __fsub_rn(1.0f, fy);
      const float w00 = __fmul_rn(gx, gy);
      const float w01 = __fmul_rn(fx, gy);
      const float w10 = __fmul_rn(gx, fy);
      const float w11 = __fmul_rn(fx, fy);
      const long long i00 = (long long)y0 * W + x0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* p = pb + c * hw;
        const float v00 = tap(p, i00, log_mode);
        const float v01 = tap(p, i00 + 1, log_mode);
        const float v10 = tap(p, i00 + W, log_mode);
        const float v11 = tap(p, i00 + W + 1, log_mode);
        const float val =
            avg ? __fmaf_rn(
                      __fmul_rn(v11, fx), fy,
                      __fmaf_rn(__fmul_rn(v10, gx), fy,
                                __fmaf_rn(__fmul_rn(v01, fx), gy,
                                          __fmul_rn(__fmul_rn(v00, gx), gy))))
                : __fmaf_rn(v11, w11,
                            __fmaf_rn(v10, w10,
                                      __fmaf_rn(v00, w00,
                                                __fmul_rn(v01, w01))));
        acc[c] = __fadd_rn(acc[c], val);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) vol[c * plane + off] = acc[c];
}

template <int C>
cudaError_t launch(void* vol, const void* probs, const void* cams,
                   const void* valid, int B, int H, int W, float ox,
                   float oy, float oz, float vs, int nx, int ny, int nz,
                   int x_start, int slab_nx, int log_mode, int box, int avg,
                   int store_x0, cudaStream_t stream) {
  const long long n = (long long)slab_nx * ny * nz;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  accumulate_kernel<C><<<(unsigned)blocks, threads, 0, stream>>>(
      (float*)vol, (const float*)probs, (const float*)cams,
      (const uint8_t*)valid, B, H, W, ox, oy, oz, vs, nx, ny, nz, x_start,
      slab_nx, log_mode, box, avg, store_x0);
  return cudaGetLastError();
}

}  // namespace

// vol (C, nx, ny, nz) f32 holds the x rows [store_x0, store_x0 + nx) of
// the grid and is updated in place on the global x rows [x_start, x_start +
// slab_nx); probs (B, C, H, W) f32; cams (B, 16) f32; valid (B,) uint8.
// C is 1..8; avg selects average's coordinates and bilinear association.
extern "C" int p3d_accumulate(void* vol, const void* probs, const void* cams,
                              const void* valid, int B, int C, int H, int W,
                              float ox, float oy, float oz, float vs, int nx,
                              int ny, int nz, int x_start, int slab_nx,
                              int log_mode, int box, int avg, int store_x0,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define P3D_ACC(NC)                                                          \
  case NC:                                                                   \
    return (int)launch<NC>(vol, probs, cams, valid, B, H, W, ox, oy, oz, vs,  \
                           nx, ny, nz, x_start, slab_nx, log_mode, box, avg, \
                           store_x0, s);
  switch (C) {
    P3D_ACC(1)
    P3D_ACC(2)
    P3D_ACC(3)
    P3D_ACC(4)
    P3D_ACC(5)
    P3D_ACC(6)
    P3D_ACC(7)
    P3D_ACC(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef P3D_ACC
}
