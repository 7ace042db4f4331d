// K12 ray_coverage: silhouette ray coverage of a hull.
//
// Replaces plant3dvision_tpu/ops/selfcal.py:_ray_coverage (its callers
// _score_batch, _diagnose, _diagnose_cams and _view_delta_coverage). For a
// ray group g (one camera row, the silhouette samples of one view, one
// alive volume): per sample pixel, the viewing ray, its slab entry and exit
// t0, t1 against the grid box, n_steps midpoint samples
// t0 + (s + 0.5)/n_steps (t1 - t0), each floored to a voxel; the sample is
// covered when the segment meets the box and some sample lands in an alive
// voxel. Outputs are integer counts per group: covered-and-valid and valid
// samples. A ray's walk stops once one of its samples hits, which does not
// change `any`.
//
// One launch serves the CEM (a group per candidate and view, each candidate
// with its own volume), the per-view polish (a group per view and search
// delta, one shared volume, each group reading its own view's samples) and
// coverage_for_cameras (a group per view).
//
// What bounds it: ~60 f32 operations per ray for the camera centre,
// direction and slab test, then ~12 per step, with one byte read from the
// alive volume per step until the first hit; the volumes are small (0.1-2 MB
// each) and stay in L2, the samples are read once. Operations bound it. The
// rays cross the grid box mostly through empty space: in the calibration's
// launches 42-89 % of them miss the hull and walk every step, and 2-28 %
// of the steps walked lie in the alive voxels' box (tools/selfcal_walks.py).
//
// Design (for Hopper), two launches:
// 1. alive_box_kernel: the box of each volume's alive voxels (a block a
//    volume, 16-byte loads).
// 2. coverage_kernel: a sub-warp of kLanes lanes walks one ray. The ray's
//    steps that can land in the box are a range [kf, ke): estimated from
//    the ray's slab times against the box grown by a voxel, then proved
//    with the walk's own arithmetic (step_cell): each operation of a step
//    is monotone in the step index, so each axis's voxel index is too, and
//    a step that lies before the box on an axis the ray enters it by puts
//    every earlier step there, one past it on an axis the ray leaves it by
//    every later one. Lanes 0 and 1 check steps kf - 1 and ke; a side that
//    fails its check is walked from step 0 (or to n_steps). Over the range,
//    lane l takes steps kf + l, kf + l + kLanes, ..., so kLanes loads of a
//    ray are in flight; after each round a warp ballot tells every
//    sub-warp whether its ray is covered (steps past the first hit change
//    no count). A block takes whole groups, about kBlockRays rays (so the
//    grid follows the work, not N), and its warps fetch batches of
//    32 / kLanes rays from a shared counter; a group's counts are summed
//    with shared-memory integer atomics (exact in any order) and written
//    once. When the voxel size is a power of two the step multiplies by its
//    reciprocal, which is exact and rounds the same real number as the
//    division (a template parameter, not a branch a step). kLanes = 4,
//    measured against 8, 16 and 32 on an H100 (tools/selfcal_ab.py).
//
// Exactness: the f32 operations that XLA on the CPU compiles _ray_coverage
// to, fused multiply-adds at the same places (the library is built with
// -fmad=false, so nvcc adds none):
//   Cein_i = fma(R2i, t2, fma(R1i, t1, R0i*t0))       (C = -Cein)
//   d_i    = (R0i*dc0 + R1i*dc1) + R2i                 (dc = ((u-cx)/fx, (v-cy)/fy, 1))
//            for the samples of XLA's 8-wide vector loop (the first
//            8 * (N / 8) when N >= 16, by the ray's sample index n),
//            R2i + fma(R1i, dc1, R0i*dc0) for the rest (its scalar tail)
//   inv_i  = 1 / (|d_i| < 1e-12 ? 1e-12 : d_i)
//   ta_i   = (bmin_i + Cein_i) * inv_i, tb_i likewise with bmax_i (the box
//            corners arrive computed, see ops/selfcal.py)
//   ts     = fma(t1 - t0', (s + 0.5) * rcp(n_steps), t0'),  t0' = max(t0, 0)
//   p_i    = fma(d_i, ts, -Cein_i);  idx_i = floor((p_i - o_i) / vs)
//            ((p_i - o_i) * (1 / vs) when vs is a power of two)

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;
constexpr int kBlockRays = 256;           // rays a block takes (whole groups)
constexpr int kBoxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Bit 0 of every L-lane sub-warp.
template <int L>
__host__ __device__ constexpr unsigned sub_warp_heads() {
  unsigned m = 0;
  for (int i = 0; i < 32; i += L) m |= 1u << i;
  return m;
}

// The lanes of every L-lane sub-warp that has a bit set in b.
template <int L>
__device__ __forceinline__ unsigned spread_any(unsigned b) {
  static_assert(L >= 2 && L <= 16 && (L & (L - 1)) == 0,
                "a ray's lanes: a power of two, 2-16 (lanes 0 and 1 check "
                "the range)");
#pragma unroll
  for (int s = 1; s < L; s <<= 1) b |= b >> s;
  return (b & sub_warp_heads<L>()) * ((1u << L) - 1u);
}

// The box of each volume's alive voxels: (lo x, y, z, hi x, y, z) voxel
// indices, lo > hi when the volume is empty. A block a volume: 16-byte
// loads, the few alive voxels' indices reduced per warp, then per block.
__global__ void __launch_bounds__(kBoxThreads)
    alive_box_kernel(const uint8_t* __restrict__ alive, long long nvox,
                     int ny, int nz, int* __restrict__ box) {
  __shared__ int s_box[kBoxThreads / 32][6];
  const uint8_t* vol = alive + blockIdx.x * nvox;
  int b[6] = {INT_MAX, INT_MAX, INT_MAX, -1, -1, -1};
  auto take = [&](int f) {
    const int i = f / (ny * nz), r = f - i * ny * nz;
    const int j = r / nz, k = r - j * nz;
    b[0] = min(b[0], i), b[1] = min(b[1], j), b[2] = min(b[2], k);
    b[3] = max(b[3], i), b[4] = max(b[4], j), b[5] = max(b[5], k);
  };
  const int n = (int)nvox;                   // < 2^31 (the wrapper checks)
  const int head = min(n, (int)((16 - (uintptr_t)vol % 16) % 16));
  const int n16 = (n - head) / 16;
  for (int f = threadIdx.x; f < head; f += blockDim.x)
    if (vol[f]) take(f);
  const uint4* v4 = reinterpret_cast<const uint4*>(vol + head);
  for (int w = threadIdx.x; w < n16; w += blockDim.x) {
    const uint4 x = __ldg(v4 + w);
    if (x.x | x.y | x.z | x.w) {
      const unsigned u[4] = {x.x, x.y, x.z, x.w};
      for (int e = 0; e < 16; ++e)
        if ((u[e >> 2] >> (8 * (e & 3))) & 0xffu) take(head + 16 * w + e);
    }
  }
  for (int f = head + 16 * n16 + threadIdx.x; f < n; f += blockDim.x)
    if (vol[f]) take(f);
  for (int a = 0; a < 3; ++a) {
    b[a] = __reduce_min_sync(kFull, b[a]);
    b[3 + a] = __reduce_max_sync(kFull, b[3 + a]);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
    for (int a = 0; a < 6; ++a) s_box[warp][a] = b[a];
  __syncthreads();
  if (threadIdx.x < 6) {
    int v = s_box[0][threadIdx.x];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      v = threadIdx.x < 3 ? min(v, s_box[w][threadIdx.x])
                          : max(v, s_box[w][threadIdx.x]);
    box[6LL * blockIdx.x + threadIdx.x] = v;
  }
}

// Step k's voxel coordinates floor((fma(d, ts, -cein) - o) / vs) (as
// floats), ts = fma(seg, (k + 0.5) * rcp(n_steps), t0).
template <bool POW2>
__device__ __forceinline__ void step_cell(int k, float rcp_steps, float seg,
                                          float t0, const float* d,
                                          const float* cein, const float* o,
                                          float vs, float inv_vs, float* q) {
  const float step = __fmul_rn(__fadd_rn((float)k, 0.5f), rcp_steps);
  const float ts = __fmaf_rn(seg, step, t0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float p = __fsub_rn(__fmaf_rn(d[i], ts, -cein[i]), o[i]);
    q[i] = floorf(POW2 ? __fmul_rn(p, inv_vs) : __fdiv_rn(p, vs));
  }
}

template <int L, bool POW2>
__global__ void __launch_bounds__(kThreads)
    coverage_kernel(const float* __restrict__ cams,
                    const int* __restrict__ vol_of,
                    const int* __restrict__ view_of,
                    const uint8_t* __restrict__ alive,
                    const int* __restrict__ box,
                    const float* __restrict__ uv,
                    const uint8_t* __restrict__ valid, int G, int N, int gpb,
                    float ox, float oy, float oz, float bx, float by,
                    float bz, float vs, float inv_vs, int nx, int ny, int nz,
                    int n_steps, float rcp_steps,
                    int* __restrict__ covered_out,
                    int* __restrict__ valid_out) {
  constexpr int R = 32 / L;                 // rays a warp walks at once
  __shared__ int s_cov[kBlockRays], s_val[kBlockRays];
  __shared__ int s_next;
  const int g0 = blockIdx.x * gpb;
  const int ng = min(gpb, G - g0);
  const int rays = ng * N;
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    s_cov[i] = 0;
    s_val[i] = 0;
  }
  if (threadIdx.x == 0) s_next = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int sub = lane / L;
  const int j = lane % L;
  const unsigned me = 1u << lane;
  const int nvox = nx * ny * nz;             // < 2^31 (the wrapper checks)
  const float o[3] = {ox, oy, oz};
  const float bmax[3] = {bx, by, bz};
  const int n3[3] = {nx, ny, nz};

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(&s_next, R);
    base = __shfl_sync(kFull, base, 0);
    if (base >= rays) break;
    const int r = base + sub;
    const bool have = r < rays;
    const int gl = have ? r / N : 0;
    const int n = have ? r - gl * N : 0;
    const int g = g0 + gl;
    const float* c = cams + 16LL * g;
    const long long s = (long long)view_of[g] * N + n;
    const bool ok = have && valid[s];

    float cein[3];
    for (int i = 0; i < 3; ++i)
      cein[i] = __fmaf_rn(c[10 + i], c[15], __fmaf_rn(c[7 + i], c[14],
                                                      __fmul_rn(c[4 + i],
                                                                c[13])));
    const float dc0 = __fdiv_rn(__fsub_rn(uv[2 * s], c[2]), c[0]);
    const float dc1 = __fdiv_rn(__fsub_rn(uv[2 * s + 1], c[3]), c[1]);
    float d[3], inv[3];
    float t0 = -CUDART_INF_F, t1 = CUDART_INF_F;
    const bool vec = N >= 16 && n < (N / 8) * 8;
    for (int i = 0; i < 3; ++i) {
      d[i] = vec ? __fadd_rn(__fadd_rn(__fmul_rn(c[4 + i], dc0),
                                       __fmul_rn(c[7 + i], dc1)),
                             c[10 + i])
                 : __fadd_rn(c[10 + i], __fmaf_rn(c[7 + i], dc1,
                                                  __fmul_rn(c[4 + i], dc0)));
      inv[i] = __fdiv_rn(1.0f, fabsf(d[i]) < 1e-12f ? 1e-12f : d[i]);
      const float ta = __fmul_rn(__fadd_rn(o[i], cein[i]), inv[i]);
      const float tb = __fmul_rn(__fadd_rn(bmax[i], cein[i]), inv[i]);
      t0 = fmaxf(t0, fminf(ta, tb));
      t1 = fminf(t1, fmaxf(ta, tb));
    }
    t0 = fmaxf(t0, 0.0f);
    const float seg = __fsub_rn(t1, t0);
    const int vb = vol_of[g];
    const uint8_t* vol = alive + (long long)vb * nvox;

    // the steps [kf, ke) that can land in the volume's alive box: the
    // estimate (any arithmetic will do), then its proof (see the top)
    float lo[3], hi[3];
    for (int i = 0; i < 3; ++i) {
      lo[i] = (float)box[6 * vb + i];
      hi[i] = (float)box[6 * vb + 3 + i];
    }
    const bool live = ok && t1 > t0 && lo[0] <= hi[0];
    int kf = 0, ke = 0;
    if (live) {
      float te = 0.0f, tx = CUDART_INF_F;
      for (int i = 0; i < 3; ++i) {
        const float wl = o[i] + (lo[i] - 1.0f) * vs;
        const float wh = o[i] + (hi[i] + 2.0f) * vs;
        const float ta = (wl + cein[i]) * inv[i];
        const float tb = (wh + cein[i]) * inv[i];
        te = fmaxf(te, fminf(ta, tb));
        tx = fminf(tx, fmaxf(ta, tb));
      }
      const float per = (float)n_steps / seg;
      const float kte = floorf((te - t0) * per - 0.5f) - 1.0f;
      const float ktx = ceilf((tx - t0) * per - 0.5f) + 2.0f;
      kf = (int)fminf(fmaxf(kte, 0.0f), (float)n_steps);   // NaN: 0
      ke = (int)fminf(fmaxf(ktx, 0.0f), (float)n_steps);
      kf = min(kf, ke);
    }
    bool proved = true;
    if (live && j < 2 && (j == 0 ? kf > 0 : ke < n_steps)) {
      float q[3];
      step_cell<POW2>(j == 0 ? kf - 1 : ke, rcp_steps, seg, t0, d, cein, o,
                      vs, inv_vs, q);
      bool out = false;
      for (int i = 0; i < 3; ++i) {
        const bool below = !(q[i] >= lo[i]), above = !(q[i] <= hi[i]);
        if (j == 0)        // before the box (d == 0: outside for every k)
          out = out || (d[i] > 0.0f ? below
                                    : d[i] < 0.0f ? above : below || above);
        else               // past the box
          out = out || (d[i] > 0.0f ? above : d[i] < 0.0f && below);
      }
      proved = out;
    }
    const unsigned failed = __ballot_sync(kFull, !proved);
    if (failed >> (sub * L) & 1u) kf = 0;
    if (failed >> (sub * L + 1) & 1u) ke = n_steps;

    // the walk over [kf, ke): lanes of the rays still walking (and not
    // covered); warp-uniform, as `cov`
    unsigned todo = __ballot_sync(kFull, live && kf < ke);
    unsigned cov = 0u;
    for (int k0 = kf; todo; k0 += L) {
      const int k = k0 + j;
      bool hit = false;
      if ((todo & me) && k < ke) {
        float q[3];
        step_cell<POW2>(k, rcp_steps, seg, t0, d, cein, o, vs, inv_vs, q);
        // out-of-range values are outside the grid whatever the cast gives
        const bool inb = q[0] >= 0.0f && q[0] < (float)n3[0] &&
                         q[1] >= 0.0f && q[1] < (float)n3[1] &&
                         q[2] >= 0.0f && q[2] < (float)n3[2];
        if (inb)
          hit = __ldg(vol + ((int)q[0] * ny + (int)q[1]) * nz + (int)q[2]) != 0;
      }
      const unsigned hits = spread_any<L>(__ballot_sync(kFull, hit));
      cov |= hits;
      todo &= ~hits & ~__ballot_sync(kFull, k0 + L >= ke);
    }
    if (j == 0 && ok) {
      atomicAdd(&s_val[gl], 1);
      if (cov & me) atomicAdd(&s_cov[gl], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    covered_out[g0 + i] = s_cov[i];
    valid_out[g0 + i] = s_val[i];
  }
}

template <bool POW2>
void launch(int blocks, cudaStream_t stream, const float* cams,
            const int* vol_of, const int* view_of, const uint8_t* alive,
            const int* box, const float* uv, const uint8_t* valid, int G,
            int N, int gpb, float ox, float oy, float oz, float bx, float by,
            float bz, float vs, float inv_vs, int nx, int ny, int nz,
            int n_steps, float rcp_steps, int* covered, int* valid_out) {
  coverage_kernel<kLanes, POW2><<<blocks, kThreads, 0, stream>>>(
      cams, vol_of, view_of, alive, box, uv, valid, G, N, gpb, ox, oy, oz, bx,
      by, bz, vs, inv_vs, nx, ny, nz, n_steps, rcp_steps, covered,
      valid_out);
}

}  // namespace

// K12: G ray groups; cams (G, 16) f32, vol_of / view_of (G,) int32, alive
// (NB, nx, ny, nz) uint8 0/1 (nx ny nz < 2^31), box (NB, 6) int32 scratch,
// uv (V, N, 2) f32, valid (V, N) uint8; the grid box's min (ox, oy, oz)
// and max (bx, by, bz); inv_vs = 1 / vs when vs is a power of two (exact),
// else 0; covered / valid (G,) int32 out. Two launches: the alive boxes,
// then the walk.
extern "C" int p3d_ray_coverage(const void* cams, const void* vol_of,
                                const void* view_of, const void* alive,
                                int NB, void* box, const void* uv,
                                const void* valid, int G, int N, float ox,
                                float oy, float oz, float bx, float by,
                                float bz, float vs, float inv_vs, int nx,
                                int ny, int nz, int n_steps, float rcp_steps,
                                void* covered, void* valid_out,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (NB < 1 || G < 1) return (int)cudaErrorInvalidValue;
  alive_box_kernel<<<NB, kBoxThreads, 0, st>>>(
      (const uint8_t*)alive, (long long)nx * ny * nz, ny, nz, (int*)box);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int gpb = N >= kBlockRays ? 1 : kBlockRays / (N > 0 ? N : 1);
  const int blocks = (G + gpb - 1) / gpb;
  (inv_vs != 0.0f ? launch<true> : launch<false>)(
      blocks, st, (const float*)cams, (const int*)vol_of,
      (const int*)view_of, (const uint8_t*)alive, (const int*)box,
      (const float*)uv, (const uint8_t*)valid, G, N, gpb, ox, oy, oz, bx, by,
      bz, vs, inv_vs, nx, ny, nz, n_steps, rcp_steps, (int*)covered,
      (int*)valid_out);
  return (int)cudaGetLastError();
}
