// K15 trace_geodesics: particle descent down a flow field with int32 votes.
//
// Replaces plant3dvision_tpu/ops/geodesics.py:trace_geodesics (lines 42-74,
// with _trilinear, :17). Per particle, up to n_steps steps:
//   g = trilinear(flow, pos); new = clip(pos - step*g, 0, shape - 1.001);
//   val = trilinear(values, new); the particle goes on while
//   val < previous val and val > step, and each step it takes adds one
//   vote at rint(new) (half to even, as jnp.round). A particle that stops
//   never moves again, so its thread leaves the loop.
//
// What bounds it: each step reads 8 corners of the flow (3 floats) and 8
// of the values (1 float), mostly from cache since a particle moves half a
// voxel a step, and does ~100 f32 operations; one int32 atomic per vote.
// The whole call has to read the tips and the two volumes once and write
// the votes once, so on paper it is bound by bytes; in practice it is one
// long dependent chain per particle (latency), with few particles.
//
// Design: one thread per particle, a plain loop; votes by atomicAdd on
// int32, exact in any order.
//
// Exactness: XLA's CPU arithmetic (the library is built with -fmad=false):
// f = p - floor(p) before the corner is clipped to [0, n - 2]; each term
// ((g * wx) * wy) * wz; the sum fma(t1xy, wz1, t2) then fma(tkxy, wzk, s)
// for k = 3..8; the step fma(-step, g, pos); the bound is float32(n) -
// float32(1.001), passed in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Corner {
  long long base;   // linear index of the clipped corner (x0, y0, z0)
  float fx, fy, fz;
};

__device__ __forceinline__ Corner corner(float px, float py, float pz, int nx,
                                         int ny, int nz) {
  const float x0 = floorf(px), y0 = floorf(py), z0 = floorf(pz);
  Corner c;
  c.fx = __fsub_rn(px, x0);
  c.fy = __fsub_rn(py, y0);
  c.fz = __fsub_rn(pz, z0);
  const int ix = min(max((int)x0, 0), nx - 2);
  const int iy = min(max((int)y0, 0), ny - 2);
  const int iz = min(max((int)z0, 0), nz - 2);
  c.base = ((long long)ix * ny + iy) * nz + iz;
  return c;
}

// channel `ch` of a (nx, ny, nz, C) volume at the corner's 8 neighbours
__device__ __forceinline__ float trilinear(const float* __restrict__ vol,
                                           const Corner& c, int C, int ch,
                                           int ny, int nz) {
  const long long sx = (long long)ny * nz, sy = nz;
  const float wx[2] = {__fsub_rn(1.f, c.fx), c.fx};
  const float wy[2] = {__fsub_rn(1.f, c.fy), c.fy};
  const float wz[2] = {__fsub_rn(1.f, c.fz), c.fz};
  // JAX's term order
  const int d[8][3] = {{0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1},
                       {1, 1, 0}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1}};
  float txy[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const long long i = c.base + d[t][0] * sx + d[t][1] * sy + d[t][2];
    txy[t] = __fmul_rn(__fmul_rn(vol[i * C + ch], wx[d[t][0]]), wy[d[t][1]]);
  }
  float s = __fmaf_rn(txy[0], wz[0], __fmul_rn(txy[1], wz[0]));
#pragma unroll
  for (int t = 2; t < 8; ++t) s = __fmaf_rn(txy[t], wz[d[t][2]], s);
  return s;
}

__global__ void trace_kernel(const float* __restrict__ flow,
                             const float* __restrict__ values,
                             const float* __restrict__ tips, int N, int nx,
                             int ny, int nz, float step, int n_steps, float bx,
                             float by, float bz, int* __restrict__ votes) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  float px = tips[3 * p], py = tips[3 * p + 1], pz = tips[3 * p + 2];
  float prev = 1e10f;
  for (int s = 0; s < n_steps; ++s) {
    const Corner c = corner(px, py, pz, nx, ny, nz);
    const float gx = trilinear(flow, c, 3, 0, ny, nz);
    const float gy = trilinear(flow, c, 3, 1, ny, nz);
    const float gz = trilinear(flow, c, 3, 2, ny, nz);
    const float qx = fminf(bx, fmaxf(0.f, __fmaf_rn(-step, gx, px)));
    const float qy = fminf(by, fmaxf(0.f, __fmaf_rn(-step, gy, py)));
    const float qz = fminf(bz, fmaxf(0.f, __fmaf_rn(-step, gz, pz)));
    const Corner cv = corner(qx, qy, qz, nx, ny, nz);
    const float val = trilinear(values, cv, 1, 0, ny, nz);
    if (!(val < prev && val > step)) break;
    const long long lin =
        ((long long)(int)rintf(qx) * ny + (int)rintf(qy)) * nz +
        (int)rintf(qz);
    atomicAdd(&votes[lin], 1);
    px = qx;
    py = qy;
    pz = qz;
    prev = val;
  }
}

}  // namespace

// K15: flow (nx, ny, nz, 3) f32, values (nx, ny, nz) f32, tips (N, 3) f32
// -> votes (nx, ny, nz) int32, zero on entry; (bx, by, bz) the clip's
// upper bounds.
extern "C" int p3d_trace_geodesics(const void* flow, const void* values,
                                   const void* tips, int N, int nx, int ny,
                                   int nz, float step, int n_steps, float bx,
                                   float by, float bz, void* votes,
                                   void* stream) {
  if (N <= 0) return 0;
  const int threads = 128;
  trace_kernel<<<(N + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(
      (const float*)flow, (const float*)values, (const float*)tips, N, nx, ny,
      nz, step, n_steps, bx, by, bz, (int*)votes);
  return (int)cudaGetLastError();
}
