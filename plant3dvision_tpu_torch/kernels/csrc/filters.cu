// K3 gradient + Gaussian: np.gradient differences, then a separable
// Gaussian with scipy's 'reflect' (symmetric) boundary.
//
// Replaces plant3dvision_tpu/ops/filters.py:gradient and gaussian_filter
// (_conv1d_along, ops/filters.py:24-61), as vol2pcd runs them
// (plant3dvision_tpu/proc3d.py:60-66): three gradients of the signed
// distance, then sigma = 1 (radius 4, 9 taps) along x, y, z for each.
//
// What bounds it on the card: bytes. The function reads the signed
// distance once and writes three gradients, 16 bytes a voxel; a voxel
// costs 6 + 3 * 3 * 18 f32 operations.
//
// The taps come from gaussian_kernel1d (float64 -> float32) as kernel
// arguments. Every sum runs tap 0 to tap 2r from 0 with separately
// rounded products and sums (no FMA), as the plain PyTorch version does,
// so each kernel equals it bit for bit; XLA's convolution sums in another
// order, so the result is held to a tolerance against the JAX package.
//
// Two routes:
// - `smoothed_gradient` (vol2pcd's): one fused launch. A block of 8 x 64
//   threads owns 8 output rows of x by 64 - 2r output columns of z (the
//   z halo included in its 64) and marches along y over a chunk of rows
//   (sized so the blocks fill the card in few rounds). For each plane of
//   y it computes the three gradient components over its x rows plus an
//   r-row halo from the signed distance (global loads, neighbours served
//   by L1/L2, the next plane's fetched while this one is filtered) into
//   shared memory; each thread then runs the x pass for its (x, z) column
//   into a ring of the last 2r + 1 planes in shared memory, the y pass
//   over that ring (its own column: no barrier), and the block the z
//   pass, 4 outputs a thread from one window of 4 + 2r values. Marching
//   along y, only the z halo (and, for the cheap gradients, the x halo)
//   is computed twice; the loads and stores run along z, coalesced.
//   A position outside the grid takes its value from the reflected
//   in-grid position, through a per-axis table (`_symmetric_index` in
//   ops/filters.py): so the gradient there is the one-sided difference at
//   the edge, not a difference of reflected distances, and an axis
//   shorter than r reflects over several periods. gx, gy, gz are written
//   once. Indexes are 32-bit (the wrapper refuses 2^31 voxels).
// - `gradient` and `gaussian_filter` alone: one thread per output element,
//   one launch per axis (3 + 3 a call).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRadius = 16;
constexpr int kFusedRadius = 4;     // sigma 1 (vol2pcd's), 9 taps

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

// the np.gradient difference at s along an axis of n >= 2 samples: the
// positions it reads and whether it halves
__device__ __forceinline__ void stencil(int s, int n, int& lo, int& hi,
                                        bool& half) {
  lo = s > 0 ? s - 1 : s;
  hi = s < n - 1 ? s + 1 : s;
  half = s > 0 && s < n - 1;
}

__device__ __forceinline__ float diff(float lo, float hi, bool half) {
  const float v = __fsub_rn(hi, lo);
  return half ? __fmul_rn(v, 0.5f) : v;
}

template <int K>
__device__ __forceinline__ float taps_dot(const Taps& taps, const float* v,
                                          int stride) {
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < K; ++t)
    acc = __fadd_rn(acc, __fmul_rn(taps.w[t], v[t * stride]));
  return acc;
}

// The fused kernel's tile: kBX output rows of x by kTZ z columns (its
// r-voxel halo included) a block, marching along y.
constexpr int kBX = 8;
constexpr int kTZ = 64;
constexpr int kFusedThreads = kBX * kTZ;

template <int R>
struct Fused {
  static constexpr int K = 2 * R + 1;           // taps
  static constexpr int HX = kBX + 2 * R;        // x rows with the halo
  static constexpr int BZ = kTZ - 2 * R;        // output z columns
  static constexpr int ZG = 4;                  // z outputs a thread
  static_assert(BZ % ZG == 0, "whole groups of z outputs a tile");
  // gradients of a plane over the halo'd tile, the x pass of the last K
  // planes, the y pass
  static constexpr int kSmem =
      (3 * HX * kTZ + K * 3 * kBX * kTZ + 3 * kBX * kTZ) * 4;
};

// tab: the reflect tables of x, y, z back to back, each n + 2R entries for
// the positions -R .. n + R - 1; yc output rows of y a block
template <int R>
__global__ void __launch_bounds__(kFusedThreads, 2)
smoothed_gradient_kernel(const float* __restrict__ d, float* __restrict__ gx,
                         float* __restrict__ gy, float* __restrict__ gz,
                         int nx, int ny, int nz, int yc,
                         const int* __restrict__ tab, Taps taps) {
  using F = Fused<R>;
  constexpr int K = F::K, HX = F::HX, BZ = F::BZ, ZG = F::ZG;
  static_assert(HX <= 2 * kBX, "a thread computes two rows of the x halo");
  extern __shared__ float smem[];
  float* gs = smem;                         // [3][HX][kTZ]
  float* xr = gs + 3 * HX * kTZ;            // [K][3][kBX][kTZ]
  float* ys = xr + K * 3 * kBX * kTZ;       // [3][kBX][kTZ]
  const int tz = threadIdx.x % kTZ, tx = threadIdx.x / kTZ;
  const int z0 = blockIdx.x * BZ, x0 = blockIdx.y * kBX;
  const int yb = blockIdx.z * yc, ye = min(yb + yc, ny);
  const int* tabx = tab;
  const int* taby = tab + nx + 2 * R;
  const int* tabz = taby + ny + 2 * R;
  const int P = ny * nz;
  // this thread's gradients: z column tz, x rows tx and tx + kBX (when the
  // halo has it) of the halo'd tile, i.e. positions z0 - R + tz, x0 - R +
  // tx, ...; past the grid's far halo only in a ragged last tile, whose
  // outputs there are not written
  const int sz = tabz[min(z0 + tz, nz - 1 + 2 * R)];
  const bool two = tx + kBX < HX;
  const int sxa = tabx[min(x0 + tx, nx - 1 + 2 * R)];
  const int sxb = tabx[min(x0 + tx + kBX, nx - 1 + 2 * R)];
  int zlo, zhi, alo, ahi, blo, bhi;
  bool zhalf, ahalf, bhalf;
  stencil(sz, nz, zlo, zhi, zhalf);
  stencil(sxa, nx, alo, ahi, ahalf);
  stencil(sxb, nx, blo, bhi, bhalf);
  const int ac = sxa * P + sz, a0 = alo * P + sz, a1 = ahi * P + sz;
  const int bc = sxb * P + sz, b0 = blo * P + sz, b1 = bhi * P + sz;
  const int dz0 = zlo - sz, dz1 = zhi - sz;

  // the signed distances the gradients of plane position p read
  float fa[6], fb[6];
  bool yhalf;
  auto fetch = [&](int p) {
    const int sy = taby[p + R];
    int ylo, yhi;
    stencil(sy, ny, ylo, yhi, yhalf);
    const int s = sy * nz, l = ylo * nz, h = yhi * nz;
    fa[0] = __ldg(d + a0 + s);
    fa[1] = __ldg(d + a1 + s);
    fa[2] = __ldg(d + ac + l);
    fa[3] = __ldg(d + ac + h);
    fa[4] = __ldg(d + ac + s + dz0);
    fa[5] = __ldg(d + ac + s + dz1);
    if (two) {
      fb[0] = __ldg(d + b0 + s);
      fb[1] = __ldg(d + b1 + s);
      fb[2] = __ldg(d + bc + l);
      fb[3] = __ldg(d + bc + h);
      fb[4] = __ldg(d + bc + s + dz0);
      fb[5] = __ldg(d + bc + s + dz1);
    }
  };

  fetch(yb - R);
  for (int p = yb - R; p < ye + R; ++p) {
    const int slot = (p - yb + R) % K;    // plane p's place in the ring
    gs[(0 * HX + tx) * kTZ + tz] = diff(fa[0], fa[1], ahalf);
    gs[(1 * HX + tx) * kTZ + tz] = diff(fa[2], fa[3], yhalf);
    gs[(2 * HX + tx) * kTZ + tz] = diff(fa[4], fa[5], zhalf);
    if (two) {
      gs[(0 * HX + tx + kBX) * kTZ + tz] = diff(fb[0], fb[1], bhalf);
      gs[(1 * HX + tx + kBX) * kTZ + tz] = diff(fb[2], fb[3], yhalf);
      gs[(2 * HX + tx + kBX) * kTZ + tz] = diff(fb[4], fb[5], zhalf);
    }
    if (p + 1 < ye + R) fetch(p + 1);     // in flight while p is filtered
    __syncthreads();
    // the x pass at (x0 + tx, p, z0 - R + tz), into the ring
#pragma unroll
    for (int c = 0; c < 3; ++c)
      xr[((slot * 3 + c) * kBX + tx) * kTZ + tz] =
          taps_dot<K>(taps, gs + (c * HX + tx) * kTZ + tz, kTZ);
    if (p - yb < R) {                     // the ring is not full yet
      __syncthreads();                    // gs read before it is rewritten
      continue;
    }
    // the y pass at y = p - R from planes p - 2R .. p, which sit in slots
    // slot + 1, ..., slot + K (mod K); each thread its own column
    const int y = p - R;
    const int s0 = slot + 1 == K ? 0 : slot + 1;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const int q = s0 + t < K ? s0 + t : s0 + t - K;
        acc = __fadd_rn(acc, __fmul_rn(taps.w[t],
                                       xr[((q * 3 + c) * kBX + tx) * kTZ + tz]));
      }
      ys[(c * kBX + tx) * kTZ + tz] = acc;
    }
    __syncthreads();
    // the z pass: ZG consecutive outputs a thread from one window
    for (int e = threadIdx.x; e < 3 * kBX * (BZ / ZG); e += kFusedThreads) {
      const int kg = e % (BZ / ZG), xo = e / (BZ / ZG) % kBX;
      const int c = e / (BZ / ZG * kBX);
      const float* v = ys + (c * kBX + xo) * kTZ + kg * ZG;
      float win[ZG + 2 * R];
#pragma unroll
      for (int q = 0; q < ZG + 2 * R; ++q) win[q] = v[q];
      float o[ZG];
#pragma unroll
      for (int q = 0; q < ZG; ++q) o[q] = taps_dot<K>(taps, win + q, 1);
      const int x = x0 + xo, z = z0 + kg * ZG;
      if (x >= nx) continue;
      float* g = (c == 0 ? gx : c == 1 ? gy : gz) + (x * ny + y) * nz + z;
      if ((nz & 3) == 0 && z + ZG <= nz) {
        *reinterpret_cast<float4*>(g) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int q = 0; q < ZG; ++q)
          if (z + q < nz) g[q] = o[q];
      }
    }
  }
}

// Rows of y a block: the fewest chunks that fill the card in the fewest
// rounds of blocks (two resident a multiprocessor), each chunk costing its
// rows plus the halo's warm-up.
int y_chunk(int blocks_xz, int ny, int R) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long slots = 2ll * sms;
  long long best = -1;
  int best_yc = ny;
  for (int n = 1; n <= ny && n <= 64; ++n) {
    const int yc = (ny + n - 1) / n, chunks = (ny + yc - 1) / yc;
    const long long rounds = (blocks_xz * (long long)chunks + slots - 1) /
                             slots;
    const long long cost = rounds * (yc + R);
    if (best < 0 || cost < best) {
      best = cost;
      best_yc = yc;
    }
  }
  return best_yc;
}

template <int R>
cudaError_t launch_fused(const float* d, float* gx, float* gy, float* gz,
                         int nx, int ny, int nz, const int* tab,
                         const Taps& t, cudaStream_t s) {
  using F = Fused<R>;
  cudaError_t err = cudaFuncSetAttribute(
      smoothed_gradient_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  if (err != cudaSuccess) return err;
  const int bz = (nz + F::BZ - 1) / F::BZ, bx = (nx + kBX - 1) / kBX;
  const int yc = y_chunk(bz * bx, ny, R);
  const dim3 grid(bz, bx, (ny + yc - 1) / yc);
  smoothed_gradient_kernel<R><<<grid, kFusedThreads, F::kSmem, s>>>(
      d, gx, gy, gz, nx, ny, nz, yc, tab, t);
  return cudaGetLastError();
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

// d (nx, ny, nz) float32, every axis >= 2 and fewer than 2^31 voxels; gx,
// gy, gz its smoothed gradients; tab (device) the int32 reflect tables of
// x, y, z for radius r (_symmetric_index), back to back; taps (host) 2r + 1
// floats, r = 4.
extern "C" int p3d_smoothed_gradient(const void* d, void* gx, void* gy,
                                     void* gz, int nx, int ny, int nz,
                                     const void* tab, const void* taps,
                                     int radius, void* stream) {
  if (radius != kFusedRadius || nx < 2 || ny < 2 || nz < 2)
    return (int)cudaErrorInvalidValue;
  Taps t = {};
  const float* w = (const float*)taps;
  for (int q = 0; q <= 2 * radius; ++q) t.w[q] = w[q];
  const float* in = (const float*)d;
  float *ox = (float*)gx, *oy = (float*)gy, *oz = (float*)gz;
  const int* tb = (const int*)tab;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)launch_fused<kFusedRadius>(in, ox, oy, oz, nx, ny, nz, tb, t,
                                         s);
}
