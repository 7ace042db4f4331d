// K14 eikonal_sweep: one Jacobi sweep of the 3-D Godunov upwind update
// (h = 1) inside a voxel mask, with the loop's stop test on the device.
//
// Replaces plant3dvision_tpu/ops/eikonal.py:geodesic_distance (lines
// 58-87; the sweep is _godunov_update, :30, over _axis_min_neighbor, :19).
// Per voxel: the smaller axis neighbour along x, y and z (INF = 1e10 past
// the grid's edges), the 1-, 2- or 3-neighbour quadratic solve, min with
// the old value; INF outside the mask, 0 on the seeds. The loop stops
// after the first sweep whose largest |du| over the voxels with a new
// value below 5e9 is at most tol, or after max_iters sweeps.
//
// What bounds it: per sweep every voxel's mask byte and, for the voxels
// inside the mask, six neighbour reads and one write of u; ~45 f32
// operations per voxel in the mask. The whole solve has to read the mask
// once and write the distances once, and do the operations of every sweep,
// so on paper it is bound by operations; a sweep streams the active bytes
// of the grid through L2, which makes it bound by memory in practice.
//
// Design: simple first. One thread per voxel per sweep (a grid-stride
// loop over a fixed number of blocks), ping-pong buffers chosen by the
// sweep index k (sweep k reads buffer k & 1 and writes the other). Both
// buffers start as the initial field, INF outside the mask and 0 on the
// seeds; those voxels never change, so the kernel skips them (one byte,
// `active`, per voxel). The block's largest |du| goes into the sweep's own
// slot by an atomicMax on its float bits (non-negative floats order as
// their bits). The host queues a batch of sweeps without waiting; sweep k
// first reads the done flag and sweep k-1's slot and, when the loop would
// have stopped, records k as the sweep count, sets the flag and returns,
// so the launches after the stop do nothing.
//
// Exactness: XLA's CPU program's float32 operations, in its order, with
// its fused multiply-adds at the same places (the library is built with
// -fmad=false); sqrtf is IEEE:
//   mid = (((a + b) + c) - lo) - hi
//   d2 = fma(-(lo - mid), lo - mid, (2f)f)
//   d3 = fma(s3, s3, (fma(hi, hi, fma(lo, lo, mid*mid)) - f*f) * -3)
//   u2 = (s2 + sqrt(d2)) * 0.5,  u3 = (s3 + sqrt(d3)) * 0.333333343

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e10f;
constexpr float kFinite = 5e9f;
constexpr int kThreads = 256;

__device__ __forceinline__ float solve(float a, float b, float c, float f,
                                       float u) {
  const float lo = fminf(fminf(a, b), c);
  const float hi = fmaxf(fmaxf(a, b), c);
  const float mid =
      __fsub_rn(__fsub_rn(__fadd_rn(__fadd_rn(a, b), c), lo), hi);
  const float u1 = __fadd_rn(lo, f);
  const float s2 = __fadd_rn(lo, mid);
  const float dm = __fsub_rn(lo, mid);
  const float d2 = __fmaf_rn(-dm, dm, __fmul_rn(__fmul_rn(f, 2.0f), f));
  const float u2 =
      d2 > 0.f ? __fmul_rn(__fadd_rn(s2, __fsqrt_rn(d2)), 0.5f) : kInf;
  const float s3 = __fadd_rn(s2, hi);
  const float sumsq = __fmaf_rn(hi, hi, __fmaf_rn(lo, lo, __fmul_rn(mid, mid)));
  const float q = __fmul_rn(__fsub_rn(sumsq, __fmul_rn(f, f)), -3.0f);
  const float d3 = __fmaf_rn(s3, s3, q);
  const float u3 = d3 > 0.f
                       ? __fmul_rn(__fadd_rn(s3, __fsqrt_rn(d3)), 0.333333343f)
                       : kInf;
  const float cand = u1 <= mid ? u1 : (u2 <= hi ? u2 : u3);
  return fminf(u, cand);
}

__global__ void eikonal_sweep_kernel(const float* __restrict__ src,
                                     float* __restrict__ dst,
                                     const uint8_t* __restrict__ active,
                                     const float* __restrict__ speed_inv,
                                     int nx, int ny, int nz, int k, float tol,
                                     int* ctl) {
  // ctl[0] done, ctl[1] sweeps applied, ctl[2 + k] sweep k's delta bits
  if (*(volatile int*)ctl) return;
  if (k > 0 && !(__int_as_float(((volatile int*)ctl)[1 + k]) > tol)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      ctl[1] = k;
      ctl[0] = 1;
    }
    return;
  }
  const long long syz = (long long)ny * nz;
  const long long n = (long long)nx * syz;
  float local = 0.f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!active[i]) continue;
    const int x = (int)(i / syz);
    const int y = (int)((i / nz) % ny);
    const int z = (int)(i % nz);
    const float ax = fminf(x > 0 ? src[i - syz] : kInf,
                           x < nx - 1 ? src[i + syz] : kInf);
    const float ay = fminf(y > 0 ? src[i - nz] : kInf,
                           y < ny - 1 ? src[i + nz] : kInf);
    const float az = fminf(z > 0 ? src[i - 1] : kInf,
                           z < nz - 1 ? src[i + 1] : kInf);
    const float f = speed_inv ? speed_inv[i] : 1.0f;
    const float u = src[i];
    const float nu = solve(ax, ay, az, f, u);
    dst[i] = nu;
    if (nu < kFinite) local = fmaxf(local, fabsf(__fsub_rn(u, nu)));
  }
  for (int off = 16; off > 0; off >>= 1)
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    if (m > 0.f)
      atomicMax((unsigned int*)&ctl[2 + k], __float_as_uint(m));
  }
}

}  // namespace

// K14: sweeps k0 .. k1-1 of the loop, queued on `stream` without a wait.
// buf0/buf1 (nx, ny, nz) f32 both hold the initial field; active (nx, ny,
// nz) uint8 (mask and not seed); speed_inv (nx, ny, nz) f32 or null
// (speed 1); ctl int32 (2 + max_iters,), zero before the first sweep.
extern "C" int p3d_eikonal_sweeps(void* buf0, void* buf1, const void* active,
                                  const void* speed_inv, int nx, int ny,
                                  int nz, int k0, int k1, float tol, void* ctl,
                                  int blocks, void* stream) {
  const long long n = (long long)nx * ny * nz;
  const long long need = (n + kThreads - 1) / kThreads;
  const int grid = (int)(need < blocks ? (need > 0 ? need : 1) : blocks);
  float* bufs[2] = {(float*)buf0, (float*)buf1};
  for (int k = k0; k < k1; ++k) {
    eikonal_sweep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        bufs[k & 1], bufs[(k + 1) & 1], (const uint8_t*)active,
        (const float*)speed_inv, nx, ny, nz, k, tol, (int*)ctl);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
