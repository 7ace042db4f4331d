// K14 eikonal solve: the whole Jacobi loop of the 3-D Godunov upwind update
// (h = 1) inside a voxel mask, stop test included, in ONE launch over the
// compacted active voxels.
//
// Replaces plant3dvision_tpu/ops/eikonal.py:geodesic_distance (lines
// 58-87; the sweep is _godunov_update, :30, over _axis_min_neighbor, :19).
// Per voxel: the smaller axis neighbour along x, y and z (INF = 1e10 past
// the grid's edges), the 1-, 2- or 3-neighbour quadratic solve, min with
// the old value; INF outside the mask, 0 on the seeds. The loop stops
// after the first sweep whose largest |du| over the voxels with a new
// value below 5e9 is at most tol, or after max_iters sweeps.
//
// What bounds it: the solve has to read the mask once and write the
// distances once (bytes), and do ~45 f32 operations a sweep for each
// active voxel (the mask minus the seeds). On the fim pass's volume (50.8 M
// voxels, ~37.6 K of them active, ~391 sweeps) both are well under a
// millisecond; what takes the time is the chain of sweeps, each of which
// has to see the whole previous sweep: one barrier a sweep.
//
// Design. The wrapper (ops/eikonal.py) compacts the active voxels (C-order
// flat indices of mask & ~seeds) and gives each a row of 6 neighbour
// entries (x-1, x+1, y-1, y+1, z-1, z+1), laid out (6, M): the neighbour's
// compact index, or kNbInf (outside the mask, past the edge) or kNbZero (a
// seed in the mask). Neither sentinel's voxel ever changes value, so a
// sweep never reads the dense grid. The u buffers of the compact voxels
// live in global memory (L2: loads and stores that bypass L1), and the
// kernel is a cooperative launch, one grid.sync() a sweep; its blocks are
// as many as the voxels need (256 threads each), at most as many as the
// card holds at once.
// The stop test: the loop goes on while the largest finite |du| exceeds
// tol, that is while any voxel's new value is below 5e9 with |du| > tol
// (the wrapper launches only for tol > 0, so the max's start at 0 never
// decides). A block ORs that flag with __syncthreads_or, and a block that
// has one sets the sweep's global slot. The OR does not depend on the
// order, so the stop test is exact. Slots rotate over three (sweep k: slot
// k % 3, reset of slot (k+1) % 3 during sweep k): a slot is read after
// barrier k and reset after barrier k+1, and set again only after barrier
// k+2. At the end the kernel writes the sweep count and scatters the final
// buffer into the dense field, which the wrapper filled with INF and the
// seeds' 0.
//
// Exactness: XLA's CPU program's float32 operations, in its order, with
// its fused multiply-adds at the same places (the library is built with
// -fmad=false); sqrtf is IEEE:
//   mid = (((a + b) + c) - lo) - hi
//   d2 = fma(-(lo - mid), lo - mid, (2f)f)
//   d3 = fma(s3, s3, (fma(hi, hi, fma(lo, lo, mid*mid)) - f*f) * -3)
//   u2 = (s2 + sqrt(d2)) * 0.5,  u3 = (s3 + sqrt(d3)) * 0.333333343
// A neighbour's value is the dense grid's (INF, 0 or the active voxel's),
// so the sweep is the dense sweep's, bit for bit (Jacobi: each sweep reads
// one buffer and writes the other).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kInf = 1e10f;
constexpr float kFinite = 5e9f;
constexpr int kNbInf = -1;
constexpr int kNbZero = -2;
constexpr int kGridThreads = 256;

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

__device__ __forceinline__ float sentinel(int j) {
  return j == kNbZero ? 0.0f : kInf;
}

// One voxel's update from its 6 neighbours' values v and its old value u;
// `moved` is set when the new value is below 5e9 and |du| > tol.
__device__ __forceinline__ float update(const float v[6], float f, float u,
                                        float tol, bool& moved) {
  const float nu = solve(fminf(v[0], v[1]), fminf(v[2], v[3]),
                         fminf(v[4], v[5]), f, u);
  moved |= nu < kFinite && fabsf(__fsub_rn(u, nu)) > tol;
  return nu;
}

// u0/u1 (M,) f32 in global memory, both INF; ctl[0..2] the stop flags,
// zero.
__global__ void __launch_bounds__(kGridThreads)
    eikonal_grid_kernel(const int* __restrict__ nbr, int M,
                        const float* __restrict__ speed_inv,
                        const long long* __restrict__ active,
                        float* __restrict__ out, float* u0, float* u1,
                        unsigned* ctl, int max_iters, float tol,
                        int* __restrict__ sweeps_out) {
  cg::grid_group grid = cg::this_grid();
  float* buf[2] = {u0, u1};
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  int n = max_iters;
  for (int k = 0; k < max_iters; ++k) {
    const float* src = buf[k & 1];
    float* dst = buf[(k + 1) & 1];
    bool moved = false;
    for (int g = first; g < M; g += stride) {
      float v[6];
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        const int j = __ldg(nbr + (long long)d * M + g);
        v[d] = j < 0 ? sentinel(j) : __ldcg(src + j);
      }
      __stcg(dst + g, update(v, speed_inv ? __ldg(speed_inv + g) : 1.0f,
                             __ldcg(src + g), tol, moved));
    }
    if (first == 0) ctl[(k + 1) % 3] = 0u;
    if (__syncthreads_or(moved) && threadIdx.x == 0) ctl[k % 3] = 1u;
    grid.sync();
    if (!__ldcg(ctl + k % 3)) {
      n = k + 1;
      break;
    }
  }
  const float* fin = buf[n & 1];
  for (int g = first; g < M; g += stride) out[active[g]] = __ldcg(fin + g);
  if (first == 0) *sweeps_out = n;
}

// An empty grid barrier, `iters` times: the floor of a sweep.
__global__ void __launch_bounds__(kGridThreads) grid_barrier_kernel(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < iters; ++k) grid.sync();
}

// The solve's blocks for M voxels: as many as they need, at most as many
// as the card holds at once (a cooperative launch's limit).
cudaError_t grid_blocks(int M, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, eikonal_grid_kernel, kGridThreads, 0);
  if (err != cudaSuccess) return err;
  const long long need = ((long long)M + kGridThreads - 1) / kGridThreads;
  const long long most = (long long)per_sm * sms;
  *blocks = (int)(need < most ? (need > 0 ? need : 1) : most);
  return cudaSuccess;
}

}  // namespace

// K14: nbr (6, M) int32, speed_inv (M,) f32 or null, active (M,) int64
// flat indices, out the dense (nx, ny, nz) f32 field (INF, 0 on the seeds),
// u0/u1 (M,) f32 filled with INF, ctl (3,) uint32 zero, tol > 0, sweeps
// (1,) int32.
extern "C" int p3d_eikonal_grid(const void* nbr, int M, const void* speed_inv,
                                const void* active, void* out, void* u0,
                                void* u1, void* ctl, int max_iters, float tol,
                                void* sweeps, void* stream) {
  if (!(tol > 0.f)) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = grid_blocks(M, &blocks);
  if (err != cudaSuccess) return (int)err;
  const int* p_nbr = (const int*)nbr;
  const float* p_speed = (const float*)speed_inv;
  const long long* p_active = (const long long*)active;
  float* p_out = (float*)out;
  float* p_u0 = (float*)u0;
  float* p_u1 = (float*)u1;
  unsigned* p_ctl = (unsigned*)ctl;
  int* p_sweeps = (int*)sweeps;
  void* args[] = {(void*)&p_nbr, (void*)&M, (void*)&p_speed,
                  (void*)&p_active, (void*)&p_out, (void*)&p_u0,
                  (void*)&p_u1, (void*)&p_ctl, (void*)&max_iters,
                  (void*)&tol, (void*)&p_sweeps};
  err = cudaLaunchCooperativeKernel((const void*)eikonal_grid_kernel,
                                    dim3(blocks), dim3(kGridThreads), args, 0,
                                    (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// `iters` empty grid barriers over the blocks a solve of M voxels takes,
// for the solve's floor: sweeps x one barrier.
extern "C" int p3d_grid_barriers(int M, int iters, void* stream) {
  int blocks = 0;
  cudaError_t err = grid_blocks(M, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&iters};
  err = cudaLaunchCooperativeKernel((const void*)grid_barrier_kernel,
                                    dim3(blocks), dim3(kGridThreads), args, 0,
                                    (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
