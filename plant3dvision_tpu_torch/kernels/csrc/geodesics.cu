// K15 trace_geodesics: particle descent down a flow field with int32 votes.
//
// Replaces plant3dvision_tpu/ops/geodesics.py:trace_geodesics (lines 42-74,
// with _trilinear, :17). Per particle, up to n_steps steps:
//   g = trilinear(flow, pos); new = clip(pos - step*g, 0, shape - 1.001);
//   val = trilinear(values, new); the particle goes on while
//   val < previous val and val > step, and each step it takes adds one
//   vote at rint(new) (half to even, as jnp.round). A particle that stops
//   never moves again, so its warp leaves the loop.
//
// What bounds it: on paper bytes (the tips and the dense votes once, 8
// corners of flow and values a step); in practice the longest particle's
// chain of dependent steps (669 on phase 14's skeleton, 38 on average).
// The grids of the eikonal skeleton (301x301x561: 610 MB of flow, 203 MB
// of values) are far past the 50 MB L2, so a step whose corners are new
// waits on L2 or device memory. The first design (a thread a particle)
// ran phase 14's 461 particles on 4 of 132 SMs, each step two dependent
// round trips to memory (the flow at pos, then the values at the new
// position), and its warps waited on their slowest lane's misses.
//
// Design: a warp a particle (kWarps a block), so the particles spread
// over the card and no particle waits on another's misses. The corner of
// the new position is the next step's flow corner (the particle moves
// there), so a step samples the flow there together with the value: one
// round trip a step, the next step's flow in hand. The four channels
// (the flow's x, y, z and the value) go to four lanes (lane & 3), each
// loading its 8 corners and running its own sum in JAX's order, and four
// shuffles share them: a step is one instruction stream of 8 loads and
// one 8-term sum, not 32 loads and four sums. Lane 0 votes by atomicAdd
// on int32 (exact in any order, off the chain).
// Tried and dropped (PERF.md §6, tools/trace_gather_ab.py): a brick of the
// volumes in shared memory a particle (8 x 8 x 16 voxels, the next brick
// prefetched along the travel): its steps were quick (0.242 us on chip
// against 0.276 through L1 then) but a warp issuing its own copies spent
// more on staging than it saved (0.755 ms); prefetching the path ahead
// into L1 or L2 (slower in every form tried).
//
// Exactness: XLA's CPU arithmetic (the library is built with -fmad=false):
// f = p - floor(p) before the corner is clipped to [0, n - 2]; each term
// ((g * wx) * wy) * wz; the sum fma(t1xy, wz1, t2) then fma(tkxy, wzk, s)
// for k = 3..8; the step fma(-step, g, pos); the bound is float32(n) -
// float32(1.001), passed in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// particles (warps) a block: one. With 2 or 4 ptxas holds the kernel to
// 32 registers; when a lane summed all four channels that serialised a
// step's 32 loads (0.31-0.33 ms against 0.24-0.25 on phase 14's inputs),
// and it still costs 0.195-0.197 against 0.190-0.191 (H100 SXM,
// tools/trace_gather_ab.py --variants)
constexpr int kWarps = 1;

struct Corner {
  int x, y, z;      // the clipped corner (x0, y0, z0)
  float fx, fy, fz;
};

__device__ __forceinline__ Corner corner(float px, float py, float pz, int nx,
                                         int ny, int nz) {
  const float x0 = floorf(px), y0 = floorf(py), z0 = floorf(pz);
  Corner c;
  c.fx = __fsub_rn(px, x0);
  c.fy = __fsub_rn(py, y0);
  c.fz = __fsub_rn(pz, z0);
  c.x = min(max((int)x0, 0), nx - 2);
  c.y = min(max((int)y0, 0), ny - 2);
  c.z = min(max((int)z0, 0), nz - 2);
  return c;
}

// the lane's channel of the trilinear sample at corner c, in JAX's term
// order: `vol` points at the lane's first value (flow + ch, or values)
// and `stride` is 3 for a flow channel, 1 for the values; the 8 corners
// through L1
__device__ __forceinline__ float sample_lane(const float* __restrict__ vol,
                                             int stride, const Corner& c,
                                             int ny, int nz) {
  const int d[8][3] = {{0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1},
                       {1, 1, 0}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1}};
  const long long sx = (long long)ny * nz * stride, sy = (long long)nz * stride;
  const float* base = vol + (((long long)c.x * ny + c.y) * nz + c.z) * stride;
  float raw[8];
#pragma unroll
  for (int t = 0; t < 8; ++t)
    raw[t] = __ldg(base + d[t][0] * sx + d[t][1] * sy + d[t][2] * stride);
  const float wx[2] = {__fsub_rn(1.f, c.fx), c.fx};
  const float wy[2] = {__fsub_rn(1.f, c.fy), c.fy};
  const float wz[2] = {__fsub_rn(1.f, c.fz), c.fz};
  float txy[8];
#pragma unroll
  for (int t = 0; t < 8; ++t)
    txy[t] = __fmul_rn(__fmul_rn(raw[t], wx[d[t][0]]), wy[d[t][1]]);
  float s = __fmaf_rn(txy[0], wz[0], __fmul_rn(txy[1], wz[0]));
#pragma unroll
  for (int t = 2; t < 8; ++t) s = __fmaf_rn(txy[t], wz[d[t][2]], s);
  return s;
}

// the four channels at (px, py, pz), a lane each (lane & 3: the flow's
// x, y, z, the value), shared with the warp: g the flow, returns the value
__device__ __forceinline__ float sample_all(const float* __restrict__ vol,
                                            int stride, float px, float py,
                                            float pz, float (&g)[3], int nx,
                                            int ny, int nz) {
  const float s =
      sample_lane(vol, stride, corner(px, py, pz, nx, ny, nz), ny, nz);
  g[0] = __shfl_sync(0xffffffffu, s, 0);
  g[1] = __shfl_sync(0xffffffffu, s, 1);
  g[2] = __shfl_sync(0xffffffffu, s, 2);
  return __shfl_sync(0xffffffffu, s, 3);
}

// one step from (px, py, pz), whose flow sample g is in hand: the new
// position into (px, py, pz), the flow there into g (the next step's,
// loaded and sampled with the value); returns the value there
__device__ __forceinline__ float step_once(const float* __restrict__ vol,
                                           int stride, float& px, float& py,
                                           float& pz, float (&g)[3], int nx,
                                           int ny, int nz, float step,
                                           float bx, float by, float bz) {
  px = fminf(bx, fmaxf(0.f, __fmaf_rn(-step, g[0], px)));
  py = fminf(by, fmaxf(0.f, __fmaf_rn(-step, g[1], py)));
  pz = fminf(bz, fmaxf(0.f, __fmaf_rn(-step, g[2], pz)));
  return sample_all(vol, stride, px, py, pz, g, nx, ny, nz);
}

__global__ void __launch_bounds__(32 * kWarps)
trace_kernel(const float* __restrict__ flow, const float* __restrict__ values,
             const float* __restrict__ tips, int N, int nx, int ny, int nz,
             float step, int n_steps, float bx, float by, float bz,
             int* __restrict__ votes) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= N || n_steps <= 0) return;
  const int ch = lane & 3;
  const float* vol = ch == 3 ? values : flow + ch;
  const int stride = ch == 3 ? 1 : 3;
  float px = tips[3 * p], py = tips[3 * p + 1], pz = tips[3 * p + 2];
  float g[3];
  sample_all(vol, stride, px, py, pz, g, nx, ny, nz);
  float prev = 1e10f;
  for (int s = 0; s < n_steps; ++s) {
    const float val = step_once(vol, stride, px, py, pz, g, nx, ny, nz, step,
                                bx, by, bz);
    if (!(val < prev && val > step)) break;
    if (lane == 0) {
      const long long lin =
          ((long long)(int)rintf(px) * ny + (int)rintf(py)) * nz +
          (int)rintf(pz);
      atomicAdd(&votes[lin], 1);
    }
    prev = val;
  }
}

// the floor of a step: one warp takes `iters` dependent steps on a 16^3
// volume of zero flow (vol: the flow, 3 x 16^3 floats, then the values),
// the particle staying put, so every read after the first hits L1
__global__ void step_floor_kernel(const float* __restrict__ vol, int iters,
                                  float* __restrict__ sink) {
  const int ch = threadIdx.x & 3;
  const float* lv = ch == 3 ? vol + 3 * 4096 : vol + ch;
  const int stride = ch == 3 ? 1 : 3;
  float px = 7.25f, py = 7.5f, pz = 7.75f, acc = 0.f;
  float g[3];
  sample_all(lv, stride, px, py, pz, g, 16, 16, 16);
  for (int s = 0; s < iters; ++s) {
    const float val = step_once(lv, stride, px, py, pz, g, 16, 16, 16, 0.5f,
                                14.f, 14.f, 14.f);
    if (val != val) break;
    acc = __fadd_rn(acc, val);
  }
  if ((threadIdx.x & 31) == 0) sink[0] = acc;
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
  trace_kernel<<<(N + kWarps - 1) / kWarps, 32 * kWarps, 0,
                 (cudaStream_t)stream>>>(
      (const float*)flow, (const float*)values, (const float*)tips, N, nx, ny,
      nz, step, n_steps, bx, by, bz, (int*)votes);
  return (int)cudaGetLastError();
}

// `iters` dependent steps of one warp with every read an L1 hit (the floor
// of a step: time it at two counts); scratch 4 x 16^3 float32 on the card
// (the flow zero, the values positive), sink one float on the card
extern "C" int p3d_trace_step_floor(int iters, void* scratch, void* sink,
                                    void* stream) {
  step_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)scratch, iters, (float*)sink);
  return (int)cudaGetLastError();
}
