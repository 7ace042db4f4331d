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
//             (edge-clamped);
//   log_mode: every pixel value p is replaced by log(EPS + p) before it is
//             sampled (and before the box prefilter).
//
// What bounds it on the card: per voxel-view ~24 f32 operations of
// projection, two divisions, and per label a few more to weigh 4 taps: the
// least work is the operations of the in-frame pairs, just above the bytes
// (batch read once, volume read and written once). A kernel that gathers
// each voxel's 4 taps x C labels from the (B, C, H, W) maps makes 4C
// scattered loads per voxel-view, each its own 32-byte sector, and a
// 32-view batch (616 MB at C = 6, 896x896) does not stay in the 50 MB L2
// while the voxels sweep it.
//
// Design: a block of 512 threads owns a tile of 8 x 8 x 16 voxels (x, y, z;
// 2 voxels a thread, z fastest, so the volume is read and written in
// 64-byte runs). It walks the batch's views in order. For each view it
// first knows (a table built at the block's start, 8 lanes a view) the
// tile's pixel window: the bounding box of the 8 projected corners of the
// tile, widened by 2 pixels for rounding and the +1 / -1 taps, clipped to
// the frame. The
// projection maps the convex tile to a convex set when every corner is in
// front of the camera, so every voxel's projection lies in that box. Then:
// - a view that is invalid, or whose box misses the frame by more than the
//   margin, is skipped (no voxel of the tile can be in frame);
// - a view with a corner behind the camera, or whose window (C labels, with
//   one more row and column for the box prefilter) exceeds kRegion floats,
//   is read from global memory by each voxel, as the one-thread-a-voxel
//   kernel did;
// - otherwise the window of the view's C maps is copied into shared memory
//   with cp.async (16 bytes a unit where label rows are 16-byte aligned,
//   one row segment of one label map at a time, coalesced), log(EPS + p)
//   applied in place once per staged pixel (log mode) and the box
//   prefilter computed once per window pixel (box mode); the voxels then
//   take their taps from shared memory. A ring of kDepth window buffers:
//   the next kDepth - 1 staged views' windows load while a view is summed.
//   A voxel whose taps fall outside the window (rounding beyond the
//   margin) reads them from global memory.
// The volume is read once and written once per launch; no atomics: each
// voxel's sums belong to one thread and take the views in batch order.
// At 0.25 mm on the ML scan's 896x896 views (the fixture's ring, f 371.2)
// a tile's window is 140 pixels at the median, 192 at most, and no
// tile-view overflows (chip_smoke.py phase 6 prints the distribution), so
// a label value staged once serves ~7 voxels' taps.
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
// A staged value is the global one with the same operations applied (the
// same logf, the same prefilter sum order), so the source of a tap does not
// change a bit. The library is built with -fmad=false, so nvcc adds no
// contraction of its own, and the plain version (ops/ml_fused.py) repeats
// every operation, so kernel and plain version agree to the last bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-9f;   // plant3dvision_tpu/ops/carving.py:EPS
constexpr int kTX = 8, kTY = 8, kTZ = 16;      // the voxel tile
constexpr int kThreads = 512;
constexpr int kPerThread = kTX * kTY * kTZ / kThreads;
constexpr int kMargin = 2;                     // pixels around the corners
constexpr int kRegion = 2048;                  // floats a staged window
constexpr int kDepth = 6;                      // windows in flight a block
enum { kSkip = 0, kGlobal = 1, kStaged = 2 };

__device__ __forceinline__ float dot3_add(float a, float b, float c,
                                          float x, float y, float z,
                                          float t) {
  const float s = __fmaf_rn(c, z, __fmaf_rn(b, y, __fmul_rn(a, x)));
  return __fadd_rn(s, t);
}

__device__ __forceinline__ float logt(float v, int log_mode) {
  return log_mode ? logf(__fadd_rn(kEps, v)) : v;
}

__device__ __forceinline__ float grid_coord(float o, float vs, int i,
                                            int avg) {
  return avg ? __fadd_rn(o, __fmul_rn(vs, (float)i))
             : __fmaf_rn(vs, (float)i, o);
}

// cam = [fx, fy, cx, cy, r00..r22 (row-major), t0, t1, t2]
__device__ __forceinline__ void project(const float* cam, float x, float y,
                                        float z, float& pz, float& px,
                                        float& py) {
  pz = dot3_add(cam[10], cam[11], cam[12], x, y, z, cam[15]);
  const float nxp = dot3_add(cam[4], cam[5], cam[6], x, y, z, cam[13]);
  const float nyp = dot3_add(cam[7], cam[8], cam[9], x, y, z, cam[14]);
  px = __fmaf_rn(__fdiv_rn(nxp, pz), cam[0], cam[2]);
  py = __fmaf_rn(__fdiv_rn(nyp, pz), cam[1], cam[3]);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// A view's window for the tile: [x0, x1] x [y0, y1] (pixels), the staged
// region's top-left (rx0, ry0) (one more row and column for the box
// prefilter; rx0 down to a multiple of 4 when rows are copied 16 bytes at
// a time) and width rw, and what the block does with the view.
struct Window {
  int x0, y0, x1, y1, rx0, ry0, rw, status;
};

struct Args {
  float* vol;
  const float* probs;
  const float* cams;
  const uint8_t* valid;
  int B, H, W;
  float ox, oy, oz, vs;
  int nx, ny, nz, x_start, slab_nx, log_mode, box, avg, store_x0;
  int tiles_y, tiles_z;
  int vec4;         // label rows start 16-byte aligned: copy 4 floats a unit
};

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    accumulate_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  // a ring of kDepth staged windows, then the box prefilter's
  float* const R = smem;
  float* const S = smem + kDepth * kRegion;
  Window* win = reinterpret_cast<Window*>(smem + (kDepth + a.box) * kRegion);

  const int tid = threadIdx.x;
  const int tz = blockIdx.x % a.tiles_z;
  const int ty = (blockIdx.x / a.tiles_z) % a.tiles_y;
  const int tx = blockIdx.x / (a.tiles_z * a.tiles_y);
  // the tile's voxel index ranges (x global, y, z)
  const int i0 = a.x_start + tx * kTX;
  const int i1 = a.x_start + min(tx * kTX + kTX - 1, a.slab_nx - 1);
  const int j0 = ty * kTY, j1 = min(j0 + kTY - 1, a.ny - 1);
  const int k0 = tz * kTZ, k1 = min(k0 + kTZ - 1, a.nz - 1);

  // the per-view windows: 8 lanes a view, one a corner, reduced with
  // shuffles (whole warps take part; lanes past the last view idle)
  for (int it = tid; it < ((a.B * 8 + 31) & ~31); it += kThreads) {
    const int b = it >> 3, c = it & 7;
    const bool live = b < a.B && a.valid[b];
    float pz = 1.0f, px = 0.0f, py = 0.0f;
    if (live) {
      const float x = grid_coord(a.ox, a.vs, (c & 1) ? i1 : i0, a.avg);
      const float y = grid_coord(a.oy, a.vs, (c & 2) ? j1 : j0, a.avg);
      const float z = grid_coord(a.oz, a.vs, (c & 4) ? k1 : k0, a.avg);
      project(a.cams + 16 * b, x, y, z, pz, px, py);
    }
    float lx = px, hx = px, ly = py, hy = py;
    int front = pz > 0.0f;
    for (int o = 1; o < 8; o <<= 1) {
      lx = fminf(lx, __shfl_xor_sync(0xffffffffu, lx, o));
      hx = fmaxf(hx, __shfl_xor_sync(0xffffffffu, hx, o));
      ly = fminf(ly, __shfl_xor_sync(0xffffffffu, ly, o));
      hy = fmaxf(hy, __shfl_xor_sync(0xffffffffu, hy, o));
      front &= __shfl_xor_sync(0xffffffffu, front, o);
    }
    if (b >= a.B || c != 0) continue;
    Window w{0, 0, -1, -1, 0, 0, 0, kSkip};
    if (!live) {
      // an invalid view: skipped
    } else if (!front) {
      w.status = kGlobal;
    } else if (hx >= (float)(-1 - kMargin) && lx <= (float)(a.W + kMargin) &&
               hy >= (float)(-1 - kMargin) && ly <= (float)(a.H + kMargin)) {
      // (clamped first: a corner near the camera plane projects far out)
      w.x0 = max((int)floorf(fmaxf(lx, -8.0f)) - kMargin, 0);
      w.x1 = min((int)floorf(fminf(hx, (float)(a.W + 8))) + kMargin + 1,
                 a.W - 1);
      w.y0 = max((int)floorf(fmaxf(ly, -8.0f)) - kMargin, 0);
      w.y1 = min((int)floorf(fminf(hy, (float)(a.H + 8))) + kMargin + 1,
                 a.H - 1);
      w.rx0 = a.box ? max(w.x0 - 1, 0) : w.x0;
      w.ry0 = a.box ? max(w.y0 - 1, 0) : w.y0;
      int rend = w.x1 + 1;
      if (a.vec4) {
        w.rx0 &= ~3;
        rend = (rend + 3) & ~3;          // <= W, a multiple of 4
      }
      w.rw = rend - w.rx0;
      const long long n = (long long)C * (w.y1 - w.ry0 + 1) * w.rw;
      if (w.x1 < w.x0 || w.y1 < w.y0) w.status = kSkip;
      else w.status = n <= kRegion ? kStaged : kGlobal;
    }
    win[b] = w;
  }

  // this thread's voxels
  const long long plane = (long long)a.nx * a.ny * a.nz;   // one label
  float acc[kPerThread][C];
  float vx[kPerThread], vy[kPerThread], vz[kPerThread];
  long long off[kPerThread];
  bool on[kPerThread];
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    const int l = tid + v * kThreads;
    const int gi = i0 + l / (kTY * kTZ);
    const int j = j0 + (l / kTZ) % kTY;
    const int k = k0 + l % kTZ;
    on[v] = gi <= i1 && j <= j1 && k <= k1;
    vx[v] = grid_coord(a.ox, a.vs, gi, a.avg);
    vy[v] = grid_coord(a.oy, a.vs, j, a.avg);
    vz[v] = grid_coord(a.oz, a.vs, k, a.avg);
    off[v] = ((long long)(gi - a.store_x0) * a.ny + j) * a.nz + k;
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[v][c] = on[v] ? a.vol[c * plane + off[v]] : 0.0f;
  }
  __syncthreads();

  const long long hw = (long long)a.H * a.W;
  auto copy_window = [&](int b, float* dst) {
    const Window w = win[b];
    const int rh = w.y1 - w.ry0 + 1;
    const float* pb = a.probs + (long long)b * C * hw;
    const int vw = a.vec4 ? 4 : 1;                // floats a copy unit
    const int uw = w.rw / vw;                     // units a row
    for (int i = tid; i < C * rh * uw; i += kThreads) {
      const int xx = i % uw;
      const int r = i / uw;
      const int yy = r % rh, c = r / rh;
      const float* src =
          pb + c * hw + (long long)(w.ry0 + yy) * a.W + w.rx0 + vw * xx;
      if (a.vec4) cp_async16(dst + 4 * i, src);
      else cp_async4(dst + i, src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto next_staged = [&](int b) {
    while (b < a.B && win[b].status != kStaged) ++b;
    return b;
  };

  // the pipeline: the windows of the next kDepth - 1 staged views are in
  // flight (one cp.async group each, empty groups past the last) while a
  // view is summed
  int nxt = -1;
  for (int d = 0; d < kDepth - 1; ++d) {
    nxt = next_staged(nxt + 1);
    if (nxt < a.B) copy_window(nxt, R + d * kRegion);
    else asm volatile("cp.async.commit_group;\n" ::);
  }
  int slot = 0;                                  // the ring slot of view b
  for (int b = 0; b < a.B; ++b) {
    const Window w = win[b];
    if (w.status == kSkip) continue;
    const bool staged = w.status == kStaged;
    const int rw = w.rw, rh = w.y1 - w.ry0 + 1;
    const int ww = w.x1 - w.x0 + 1, wh = w.y1 - w.y0 + 1;
    float* const Rw = R + slot * kRegion;
    const float* Rb = Rw;
    if (staged) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 2));
      __syncthreads();
      if (a.log_mode) {
        for (int i = tid; i < C * rh * rw; i += kThreads)
          Rw[i] = logf(__fadd_rn(kEps, Rw[i]));
        __syncthreads();
      }
      if (a.box) {
        // S[c][y - y0][x - x0] = 0.25 * (((p(ym, xm) + p(ym, x)) + p(y, xm))
        //                               + p(y, x)), ym = max(y - 1, 0), ...
        for (int i = tid; i < C * wh * ww; i += kThreads) {
          const int xx = i % ww;
          const int r = i / ww;
          const int yy = r % wh, c = r / wh;
          const int x = w.x0 + xx, y = w.y0 + yy;
          const float* p = Rw + c * rh * rw;
          const int rm = (max(y - 1, 0) - w.ry0) * rw, rc = (y - w.ry0) * rw;
          const int cm = max(x - 1, 0) - w.rx0, cc = x - w.rx0;
          S[i] = __fmul_rn(
              0.25f, __fadd_rn(__fadd_rn(__fadd_rn(p[rm + cm], p[rm + cc]),
                                         p[rc + cm]),
                               p[rc + cc]));
        }
        __syncthreads();
      }
      // the slot of the view before this one is free: every thread has
      // passed the barrier above since it summed that view
      const int free_slot = (slot + kDepth - 1) % kDepth;
      nxt = next_staged(nxt + 1);
      if (nxt < a.B) copy_window(nxt, R + free_slot * kRegion);
      else asm volatile("cp.async.commit_group;\n" ::);
    }

    const float* cam = a.cams + 16 * b;
    const float* pb = a.probs + (long long)b * C * hw;
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) {
      if (!on[v]) continue;
      float pz, px, py;
      project(cam, vx[v], vy[v], vz[v], pz, px, py);
      // in frame: trunc(p) in [0, W-1]  <=>  -1 < p < W
      if (!(pz > 0.0f) || !(px > -1.0f) || !(px < (float)a.W) ||
          !(py > -1.0f) || !(py < (float)a.H))
        continue;
      const float fx0 = fminf(fmaxf(floorf(px), 0.0f), (float)(a.W - 2));
      const float fy0 = fminf(fmaxf(floorf(py), 0.0f), (float)(a.H - 2));
      const int x0 = (int)fx0;
      const int y0 = (int)fy0;
      if (a.box) {
        if (staged && x0 >= w.x0 && x0 <= w.x1 && y0 >= w.y0 &&
            y0 <= w.y1) {
          const int i = (y0 - w.y0) * ww + (x0 - w.x0);
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc[v][c] = __fadd_rn(acc[v][c], S[c * wh * ww + i]);
        } else {
          const long long ym = (long long)max(y0 - 1, 0) * a.W;
          const long long yc = (long long)y0 * a.W;
          const int xm = max(x0 - 1, 0);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float* p = pb + c * hw;
            const float s = __fadd_rn(
                __fadd_rn(__fadd_rn(logt(p[ym + xm], a.log_mode),
                                    logt(p[ym + x0], a.log_mode)),
                          logt(p[yc + xm], a.log_mode)),
                logt(p[yc + x0], a.log_mode));
            acc[v][c] = __fadd_rn(acc[v][c], __fmul_rn(0.25f, s));
          }
        }
        continue;
      }
      const float fx = fminf(fmaxf(__fsub_rn(px, fx0), 0.0f), 1.0f);
      const float fy = fminf(fmaxf(__fsub_rn(py, fy0), 0.0f), 1.0f);
      const float gx = __fsub_rn(1.0f, fx);
      const float gy = __fsub_rn(1.0f, fy);
      const float w00 = __fmul_rn(gx, gy);
      const float w01 = __fmul_rn(fx, gy);
      const float w10 = __fmul_rn(gx, fy);
      const float w11 = __fmul_rn(fx, fy);
      const bool in_win = staged && x0 >= w.x0 && x0 + 1 <= w.x1 &&
                          y0 >= w.y0 && y0 + 1 <= w.y1;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v00, v01, v10, v11;
        if (in_win) {
          const float* p = Rb + c * rh * rw + (y0 - w.ry0) * rw + (x0 - w.rx0);
          v00 = p[0]; v01 = p[1]; v10 = p[rw]; v11 = p[rw + 1];
        } else {
          const float* p = pb + c * hw + (long long)y0 * a.W + x0;
          v00 = logt(p[0], a.log_mode);
          v01 = logt(p[1], a.log_mode);
          v10 = logt(p[a.W], a.log_mode);
          v11 = logt(p[a.W + 1], a.log_mode);
        }
        const float val =
            a.avg ? __fmaf_rn(
                        __fmul_rn(v11, fx), fy,
                        __fmaf_rn(__fmul_rn(v10, gx), fy,
                                  __fmaf_rn(__fmul_rn(v01, fx), gy,
                                            __fmul_rn(__fmul_rn(v00, gx),
                                                      gy))))
                  : __fmaf_rn(v11, w11,
                              __fmaf_rn(v10, w10,
                                        __fmaf_rn(v00, w00,
                                                  __fmul_rn(v01, w01))));
        acc[v][c] = __fadd_rn(acc[v][c], val);
      }
    }
    if (staged) slot = (slot + 1) % kDepth;
  }
#pragma unroll
  for (int v = 0; v < kPerThread; ++v)
    if (on[v]) {
#pragma unroll
      for (int c = 0; c < C; ++c) a.vol[c * plane + off[v]] = acc[v][c];
    }
}

template <int C>
cudaError_t launch(const Args& a0, cudaStream_t stream) {
  Args a = a0;
  a.tiles_y = (a.ny + kTY - 1) / kTY;
  a.tiles_z = (a.nz + kTZ - 1) / kTZ;
  const long long blocks = (long long)((a.slab_nx + kTX - 1) / kTX) *
                           a.tiles_y * a.tiles_z;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(kDepth + a.box) * kRegion * sizeof(float) +
                      (size_t)a.B * sizeof(Window);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      accumulate_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  accumulate_kernel<C><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
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
  if (B < 1 || H < 2 || W < 2 || slab_nx < 1 || ny < 1 || nz < 1)
    return (int)cudaErrorInvalidValue;
  const int vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(probs) % 16 == 0;
  const Args a{(float*)vol, (const float*)probs, (const float*)cams,
               (const uint8_t*)valid, B, H, W, ox, oy, oz, vs, nx, ny, nz,
               x_start, slab_nx, log_mode, box, avg, store_x0, 0, 0, vec4};
#define P3D_ACC(NC) \
  case NC:          \
    return (int)launch<NC>(a, s);
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
