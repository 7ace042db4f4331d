// K13 harris_response: Harris corner response, 3x3 non-maximum
// suppression, keypoint mask and border in one pass.
//
// Replaces the dense part of plant3dvision_tpu/ops/sfmlite.py:
// harris_keypoints (lines 64-82; the per-band top-k stays torch). Per
// pixel: central differences ix, iy; 3x3 box sums of ix^2, iy^2, ix*iy; the
// response r = sxx*syy - sxy^2 - kappa (sxx + syy)^2; the output is r where r
// is the maximum of its 3x3 neighbourhood, the mask is set and the pixel is
// at least `border` from the frame, else -inf. JAX's jnp.roll wraps around
// the frame; only pixels at least `border` (16) inside are ever kept, whose
// stencil never reaches the edge, so the kernel clamps reads at the edge.
//
// What bounds it: one f32 read of the image, one byte of mask and one f32
// write per pixel (a 12-view chunk at 1440x1080: 75 MB + 19 MB in, 75 MB
// out, 0.050 ms at the HBM rate) against ~45 f32 operations per pixel
// (0.0125 ms at the f32 rate): bytes.
//
// Design: each pixel's gradient, products, row sums, box sums and response
// are computed once. A warp owns a strip of 128 image columns (4 a lane,
// one 16-byte load a lane and row) whose inner TW = 120 columns it writes,
// and marches down a band of `rows` output rows. Each step loads one image
// row (two rows ahead of its use, in registers) and takes, in registers:
// the gradients of the row above it (the three image rows a lane needs are
// its own columns; the left and right neighbours of its 4 columns come by
// warp shuffles), the three products, their row sums, the box sums and the
// response of the row above that (the last two row sums of each channel
// kept), and the suppression of the row above that (the last two responses
// kept), which it writes with the mask and border tests. No shared memory
// and no barrier: neighbours across lanes are shuffles, and the 4 image
// columns and 6 rows of halo a band re-reads come from L2. A block is 4
// warps, 4 bands of one strip.
//
// Exactness: the f32 operations of XLA's CPU program, fused multiply-adds
// at the same places (the library is built with -fmad=false):
//   row_q(y, x) = fma(a, b, q(y, x-1)) + q(y, x+1)   (q = a*b rounded)
//   s_q = ((row_q(y) + row_q(y-1)) + row_q(y+1)) * rcp(9)
//   r = fma(-((sxx + syy)^2), kappa, fma(sxx, syy, -(sxy*sxy)))

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int CPL = 4;                  // image columns a lane
constexpr int SPAN = 32 * CPL;          // image columns a warp holds
constexpr int PAD = 4;                  // columns left of the first output
constexpr int TW = SPAN - 2 * PAD;      // output columns a strip (lanes 1-30)
constexpr int WARPS = 4;                // bands a block (one strip)

// one image row at columns xc .. xc + 3 (clamped to the frame)
template <bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ img, int y,
                                         int H, int W, int xc,
                                         float (&g)[CPL]) {
  const float* row = img + (long long)min(max(y, 0), H - 1) * W;
  if (VEC && xc >= 0 && xc + CPL <= W) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + xc));
    g[0] = q.x;
    g[1] = q.y;
    g[2] = q.z;
    g[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      g[k] = __ldg(row + min(max(xc + k, 0), W - 1));
  }
}

// the mask bytes of row y at columns xc .. xc + 3 (0 beyond the frame)
template <bool VEC>
__device__ __forceinline__ unsigned load_mask(const uint8_t* __restrict__ m,
                                              int y, int W, int xc) {
  const uint8_t* row = m + (long long)y * W;
  if (VEC && xc + CPL <= W)
    return __ldg(reinterpret_cast<const unsigned*>(row + xc));
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (xc + k < W) bits |= (unsigned)__ldg(row + xc + k) << (8 * k);
  return bits;
}

// v with its left and right neighbours (v[-1] from the lane before, v[4]
// from the lane after): e[k + 1] = v[k]
__device__ __forceinline__ void widen(const float (&v)[CPL],
                                      float (&e)[CPL + 2]) {
  e[0] = __shfl_up_sync(kFull, v[CPL - 1], 1);
  e[CPL + 1] = __shfl_down_sync(kFull, v[0], 1);
#pragma unroll
  for (int k = 0; k < CPL; ++k) e[k + 1] = v[k];
}

template <bool VEC>
__global__ void __launch_bounds__(32 * WARPS)
    harris_kernel(const float* __restrict__ gray,
                  const uint8_t* __restrict__ mask, int H, int W, int rows,
                  int border, float kappa, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int band = blockIdx.y * WARPS + (threadIdx.x >> 5);
  const int y0 = band * rows;
  if (y0 >= H) return;                     // the whole warp
  const int yend = min(y0 + rows, H);      // output rows [y0, yend)
  const int v = blockIdx.z;
  const int xc = blockIdx.x * TW - PAD + CPL * lane;   // the lane's columns
  const long long off = (long long)v * H * W;
  const float* img = gray + off;
  const bool writes = lane >= 1 && lane <= 30 && xc < W;
  const float rcp9 = __fdiv_rn(1.0f, 9.0f);

  // image rows j - 1, j (gm, g0) and the prefetched rows j + 1, j + 2
  float gm[CPL], g0[CPL], p1[CPL], p2[CPL];
  load_row<VEC>(img, y0 - 3, H, W, xc, gm);
  load_row<VEC>(img, y0 - 2, H, W, xc, g0);
  load_row<VEC>(img, y0 - 1, H, W, xc, p1);
  load_row<VEC>(img, y0, H, W, xc, p2);
  // row sums of rows j - 2, j - 1 (a, b) a channel; responses of rows
  // j - 3, j - 2 (ra, rb)
  float axx[CPL] = {}, ayy[CPL] = {}, axy[CPL] = {};
  float bxx[CPL] = {}, byy[CPL] = {}, bxy[CPL] = {};
  float ra[CPL] = {}, rb[CPL] = {};

  for (int j = y0 - 2; j <= yend + 1; ++j) {
    float gp[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      gp[k] = p1[k];
      p1[k] = p2[k];
    }
    if (j + 3 <= yend + 2) load_row<VEC>(img, j + 3, H, W, xc, p2);
    const int yo = j - 2;                  // the row written this step
    const bool out_row = yo >= y0 && writes;
    const unsigned mbits =
        out_row ? load_mask<VEC>(mask + off, yo, W, xc) : 0u;

    // gradients, products and row sums of row j
    float ge[CPL + 2];
    widen(g0, ge);
    float ix[CPL], iy[CPL], qxx[CPL], qyy[CPL], qxy[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      ix[k] = __fmul_rn(__fsub_rn(ge[k + 2], ge[k]), 0.5f);
      iy[k] = __fmul_rn(__fsub_rn(gp[k], gm[k]), 0.5f);
      qxx[k] = __fmul_rn(ix[k], ix[k]);
      qyy[k] = __fmul_rn(iy[k], iy[k]);
      qxy[k] = __fmul_rn(ix[k], iy[k]);
    }
    float exx[CPL + 2], eyy[CPL + 2], exy[CPL + 2];
    widen(qxx, exx);
    widen(qyy, eyy);
    widen(qxy, exy);
    float cxx[CPL], cyy[CPL], cxy[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      cxx[k] = __fadd_rn(__fmaf_rn(ix[k], ix[k], exx[k]), exx[k + 2]);
      cyy[k] = __fadd_rn(__fmaf_rn(iy[k], iy[k], eyy[k]), eyy[k + 2]);
      cxy[k] = __fadd_rn(__fmaf_rn(ix[k], iy[k], exy[k]), exy[k + 2]);
    }

    // box sums and response of row j - 1 (rows j - 2, j - 1, j summed)
    float rc[CPL] = {0.f, 0.f, 0.f, 0.f};
    if (j >= y0) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const float sxx = __fmul_rn(__fadd_rn(__fadd_rn(bxx[k], axx[k]),
                                              cxx[k]), rcp9);
        const float syy = __fmul_rn(__fadd_rn(__fadd_rn(byy[k], ayy[k]),
                                              cyy[k]), rcp9);
        const float sxy = __fmul_rn(__fadd_rn(__fadd_rn(bxy[k], axy[k]),
                                              cxy[k]), rcp9);
        const float tr = __fadd_rn(sxx, syy);
        const float det = __fmaf_rn(sxx, syy, -__fmul_rn(sxy, sxy));
        rc[k] = __fmaf_rn(-__fmul_rn(tr, tr), kappa, det);
      }
    }

    // suppression of row j - 2 (responses of rows j - 3, j - 2, j - 1)
    if (yo >= y0) {
      float cm[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) cm[k] = fmaxf(fmaxf(ra[k], rb[k]), rc[k]);
      float ce[CPL + 2];
      widen(cm, ce);
      if (out_row) {
        const bool yin = yo >= border && yo < H - border;
        float o[CPL];
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const float rmax = fmaxf(fmaxf(ce[k], ce[k + 1]), ce[k + 2]);
          const int x = xc + k;
          const bool ok = rb[k] >= rmax && ((mbits >> (8 * k)) & 0xffu) &&
                          yin && x >= border && x < W - border;
          o[k] = ok ? rb[k] : -CUDART_INF_F;
        }
        float* dst = out + off + (long long)yo * W + xc;
        if (VEC && xc + CPL <= W) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int k = 0; k < CPL; ++k)
            if (xc + k < W) dst[k] = o[k];
        }
      }
    }

#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      gm[k] = g0[k];
      g0[k] = gp[k];
      axx[k] = bxx[k];
      ayy[k] = byy[k];
      axy[k] = bxy[k];
      bxx[k] = cxx[k];
      byy[k] = cyy[k];
      bxy[k] = cxy[k];
      ra[k] = rb[k];
      rb[k] = rc[k];
    }
  }
}

}  // namespace

// K13: gray (V, H, W) f32, mask (V, H, W) uint8 0/1 -> out (V, H, W) f32;
// `rows` output rows a warp's band. The 16-byte lane needs W % 4 == 0 and
// 16-byte aligned gray and out (4-byte aligned mask).
extern "C" int p3d_harris(const void* gray, const void* mask, int V, int H,
                          int W, int rows, int border, float kappa, void* out,
                          void* stream) {
  if (V == 0 || H == 0 || W == 0) return 0;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const int bands = (H + rows - 1) / rows;
  const dim3 block(32 * WARPS);
  const dim3 grid((W + TW - 1) / TW, (bands + WARPS - 1) / WARPS, V);
  const bool vec = W % CPL == 0 && (uintptr_t)gray % 16 == 0 &&
                   (uintptr_t)out % 16 == 0 && (uintptr_t)mask % 4 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    harris_kernel<true><<<grid, block, 0, s>>>(
        (const float*)gray, (const uint8_t*)mask, H, W, rows, border, kappa,
        (float*)out);
  else
    harris_kernel<false><<<grid, block, 0, s>>>(
        (const float*)gray, (const uint8_t*)mask, H, W, rows, border, kappa,
        (float*)out);
  return (int)cudaGetLastError();
}
