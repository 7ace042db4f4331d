// K1 carve: space carving of a voxel grid from bit-packed binary masks.
//
// Replaces plant3dvision_tpu/ops/carving.py:carve (projection in
// _project, ops/carving.py:34-61) and the engine FusedCarving ships,
// parallel/carving_mp.py:carve_fused, which is bit-exact with it.
//
// Per voxel and view: project the voxel centre, truncate to a pixel, read
// the mask bit. The voxel is -1 if any in-frame view misses, else 1 if any
// in-frame view hits, else 0.
//
// What bounds it on the card: ~24 f32 operations a voxel-view test of
// the least work that any view order needs (ops/carving.py:
// carve_least_work: one test a killed voxel, a test of every valid view
// for each voxel that no view kills), plus the distinct packed-mask bytes
// those tests read (V x ceil(HW/8) bytes of MSB-first np.packbits rows:
// 19.4 MB for a 100-view group at 1440x1080, inside the 50 MB L2; 0.18 MB
// of them read) and the int8 grid written once. The tests' arithmetic
// bounds it: 0.00065 ms for a 100-view group into 81x80x199 voxels
// (1,824,516 tests); chip_smoke.py phase 4 gives it for 60 views into
// 301x301x561.
//
// Design (redesigned for Hopper; the first design was a thread a voxel
// walking the views in ring order, reading `valid` and 16 camera floats
// from global memory at every step, while a warp's 32 z-neighbours walked
// as long as the longest of them, one L2 round trip a view for a hull
// voxel). K1 (carve_kernel) takes K11b's answers below: as many blocks as
// the card holds each stage the valid views' cameras in shared memory once
// (256 spread positions at a time, the invalid ones dropped by a warp
// ballot, so no invalid view is tested) and walk tiles of 256 z runs in
// turn, the views in the spread order k -> k s mod V. Phase 1 tests each
// run against the first 4 staged views, where most voxels die (99.4 % on
// phase 3's group), the (x, y) terms of the numerators reused along the
// run. Phase 2 differs from K11b's: the n open voxels of a tile (a
// shared-memory list) walk the remaining views g threads a voxel (g the
// largest power of two <= 32 with g n <= 256), thread r of a voxel the
// views start + r + g m, in batches of 1, 2, then 4 views a thread whose
// mask loads are in flight together, and all stop after the batch in
// which one of them found a miss (a kill flag in shared memory). K11b's
// chunks of pairs, compacted after each, test every view of a chunk
// before a killed voxel leaves the list. The z run is 1 voxel: runs of 4
// halve phase 1 on phase 4's grid, but a tile of 1024 voxels in a tight
// box gathers up to 692 hull voxels (phase 3's group), more than its
// threads, and their serial walks set the kernel's time
// (tools/undistort_carve_ab.py --variants and --walks, PERF.md). Voxel
// indexes are 32-bit, split once a run.
//
// Exactness: the projection repeats, operation for operation, the f32
// arithmetic that the JAX package's carve compiles to (XLA on the CPU, the
// reference the tests hold the port to). XLA contracts two of _project's
// multiply-adds into fused multiply-adds, so the port does the same at
// exactly those places and nowhere else (the library is built with
// -fmad=false, so nvcc adds no contraction of its own):
//   x  = origin + vs*i                        (multiply, then add)
//   pz = fma(r8, z, fma(r7, y, r6*x)) + t2     (likewise for px, py numerators)
//   px = fma(num/pz, fx, cx)                   (IEEE division)
// then a truncating, saturating f32->int cast and the border test
// 0 <= p <= W-1. A strictly unfused projection moves a few voxels per
// million to a neighbouring pixel (1 of 393,216 on a real_plant crop);
// this pattern matches JAX exactly (tests/test_torch_carve.py).
//
// K11 count_kills / carve_tolerant (kills_kernel below) replaces
// plant3dvision_tpu/ops/carving.py:count_kills and carve_tolerant, the vote
// carve: per voxel, the number of in-frame views that miss it (int16, as
// JAX accumulates) and whether any in-frame view hits it; carve_tolerant's
// verdict is -1 when the count exceeds max_kills, else 1 if seen, else 0.
// The same projection, pixel and packed-bit read as K1. count_kills walks
// every valid view (its counts are merged across flushes by the caller);
// carve_tolerant stops a voxel once its count exceeds max_kills (the
// verdict is -1 whatever the rest says; the wrapper keeps the view count
// below 2^15, so the int16 count cannot wrap back). What bounds it on the
// card: ~24 f32 operations per voxel-view test (count mode tests every
// valid voxel-view pair) and the mask bytes those tests read; the work is
// the tests' arithmetic.
//
// Design (redesigned for the arithmetic): a block stages the valid flags
// and the 16-float cameras in shared memory (256 views at a time), and
// each thread walks a run of consecutive z voxels of one (x, y) column: 8
// in count mode; 1 in verdict mode, where a warp's voxels stop at their
// own kills and a longer run keeps lanes idle. A numerator is dot3_add's
// fma(c, z, fma(b, y, a*x)) + t, whose inner term depends on (x, y) only:
// it is computed once a view and reused for each z, the same operations in
// the same order. A view behind the camera (!(pz > 0)) is out of frame
// whatever the quotients, so they are not computed; the two quotients are
// __fdiv_rn.
//
// K11b carve_candidates (candidates_kernel below) replaces the per-candidate
// hull of plant3dvision_tpu/ops/selfcal.py:_alive_volume / _robust_alive
// (carve_tolerant(...) == 1 under vmap/lax.map over the CEM population):
// B candidate camera sets over ONE shared packed mask stack, every view
// valid. alive[b, voxel] = the voxel is seen and at most max_kills views
// miss it. What bounds it: B x the voxel-view tests of K11's verdict mode
// (a voxel's walk ends at its (max_kills + 1)-th kill; ~24 f32 operations
// each) and one byte per voxel and candidate written; the low-res masks
// (60 x 180x135 bits = 182 KB) sit in L2. Most voxels die within a few
// views, a few (the hull) walk them all, so a thread a voxel leaves most
// lanes of a warp idle behind one alive voxel.
// Design (for Hopper): a block takes one candidate's tile of z runs (256
// threads) and stages the candidate's cameras in shared memory (kCamChunk
// views at a time), in a spread view order, k -> k * s mod V with s the
// integer nearest 0.618 V that is prime to V: views far apart round the
// turntable first, so a voxel outside the hull meets a view that kills it
// sooner than along the ring (2.1 tests a voxel instead of 3.1 on the
// calibration's round 0: tools/selfcal_walks.py). Phase 1: each thread walks its z run, K11's (x, y) terms reused
// along it, over the first kFirstKills (max_kills + 1) views until its
// voxels are killed; runs of 4 voxels at tolerance 0, of 1 under a
// tolerance (a run's thread would walk until all of its voxels had
// max_kills + 1 kills). Phase 2: the voxels still open go to a
// shared-memory list (warp ballots), and their remaining (voxel, view)
// pairs are spread over the block's threads a chunk of views at a time
// (about kCandPairs pairs), kills and "seen" summed with shared-memory
// integer atomics; after each chunk the list is compacted to the voxels
// not yet killed, so the early exit holds at chunk granularity.
// Exactness: the verdict is a function of the set of tests made (a voxel
// stops only once more than max_kills views miss it, whatever the others
// say), so the view order and the chunking change no bit; each test is
// K1's arithmetic, both quotients __fdiv_rn.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ((a*x + b*y) + c*z) + t as XLA compiles it: the 2nd and 3rd products
// fused into the running sum, the translation added last.
__device__ __forceinline__ float dot3_add(float a, float b, float c,
                                          float x, float y, float z,
                                          float t) {
  const float s = __fmaf_rn(c, z, __fmaf_rn(b, y, __fmul_rn(a, x)));
  return __fadd_rn(s, t);
}


constexpr int kKillThreads = 256;
constexpr int kCamChunk = 256;

// max_kills < 0: count mode (kills, seen written); else the verdict (vol).
// Blocks walk tiles of the grid's z runs: thread t takes the run [ZR zc,
// ZR zc + ZR) of column (i, j), t = (i ny + j) nzc + zc, nzc = ceil(nz /
// ZR). The cameras are staged once a block when they fit (V <=
// kCamChunk), else a chunk at a time for each tile.
template <int ZR>
__global__ void __launch_bounds__(kKillThreads)
    kills_kernel(const uint8_t* __restrict__ packed, long long row_bytes,
                 const float* __restrict__ cams,
                 const uint8_t* __restrict__ valid, int V, int H, int W,
                 float ox, float oy, float oz, float vs, int nx, int ny,
                 int nz, int max_kills, int16_t* __restrict__ kills_out,
                 uint8_t* __restrict__ seen_out,
                 int8_t* __restrict__ vol_out) {
  __shared__ float cam_s[kCamChunk * 16];
  __shared__ uint8_t valid_s[kCamChunk];
  const int nzc = (nz + ZR - 1) / ZR;
  const long long nt = (long long)nx * ny * nzc;
  const bool once = V <= kCamChunk;
  if (once) {
    for (int e = threadIdx.x; e < V * 16; e += blockDim.x) cam_s[e] = cams[e];
    for (int e = threadIdx.x; e < V; e += blockDim.x) valid_s[e] = valid[e];
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long tile = (long long)blockIdx.x * blockDim.x; tile < nt;
       tile += stride) {
    const long long t = tile + threadIdx.x;
    const bool live = t < nt;
    const long long tt = live ? t : 0;
    const int zc = (int)(tt % nzc);
    const long long col = tt / nzc;
    const int j = (int)(col % ny);
    const int i = (int)(col / ny);
    const int z0 = zc * ZR;
    const int nq = live ? min(ZR, nz - z0) : 0;
    const float x = __fadd_rn(ox, __fmul_rn(vs, (float)i));
    const float y = __fadd_rn(oy, __fmul_rn(vs, (float)j));
    float z[ZR];
    int kills[ZR];
#pragma unroll
    for (int q = 0; q < ZR; ++q) {
      z[q] = __fadd_rn(oz, __fmul_rn(vs, (float)(z0 + q)));
      kills[q] = 0;
    }
    // bit q: voxel q is seen / needs no more tests (past the run's end, or
    // its verdict is -1)
    unsigned seen = 0u;
    unsigned done = ~((1u << nq) - 1u);

    for (int v0 = 0; v0 < V; v0 += kCamChunk) {
      const int nv = min(kCamChunk, V - v0);
      if (!once) {
        __syncthreads();
        for (int e = threadIdx.x; e < nv * 16; e += blockDim.x)
          cam_s[e] = cams[(long long)v0 * 16 + e];
        for (int e = threadIdx.x; e < nv; e += blockDim.x)
          valid_s[e] = valid[v0 + e];
        __syncthreads();
      }
      for (int vv = 0; vv < nv && done != ~0u; ++vv) {
        if (!valid_s[vv]) continue;
        const float* c = cam_s + 16 * vv;
        const float pz_xy = __fmaf_rn(c[11], y, __fmul_rn(c[10], x));
        const float nx_xy = __fmaf_rn(c[5], y, __fmul_rn(c[4], x));
        const float ny_xy = __fmaf_rn(c[8], y, __fmul_rn(c[7], x));
        const uint8_t* mrow = packed + (long long)(v0 + vv) * row_bytes;
#pragma unroll
        for (int q = 0; q < ZR; ++q) {
          if (done & (1u << q)) continue;
          const float pz = __fadd_rn(__fmaf_rn(c[12], z[q], pz_xy), c[15]);
          if (!(pz > 0.0f)) continue;
          const float nxp = __fadd_rn(__fmaf_rn(c[6], z[q], nx_xy), c[13]);
          const float nyp = __fadd_rn(__fmaf_rn(c[9], z[q], ny_xy), c[14]);
          const float px = __fmaf_rn(__fdiv_rn(nxp, pz), c[0], c[2]);
          const float py = __fmaf_rn(__fdiv_rn(nyp, pz), c[1], c[3]);
          const int pxi = __float2int_rz(px);
          const int pyi = __float2int_rz(py);
          // 0 <= pxi <= W - 1 and 0 <= pyi <= H - 1
          if ((unsigned)pxi >= (unsigned)W || (unsigned)pyi >= (unsigned)H)
            continue;
          const int lin = pyi * W + pxi;
          if ((__ldg(mrow + (lin >> 3)) << (lin & 7)) & 0x80) {
            seen |= 1u << q;
          } else if (++kills[q] > max_kills && max_kills >= 0) {
            done |= 1u << q;
          }
        }
      }
    }
    const long long idx = col * nz + z0;
#pragma unroll
    for (int q = 0; q < ZR; ++q) {
      if (q >= nq) break;
      if (max_kills < 0) {
        kills_out[idx + q] = (int16_t)kills[q];
        seen_out[idx + q] = (seen >> q) & 1u;
      } else {
        vol_out[idx + q] =
            kills[q] > max_kills ? -1 : (((seen >> q) & 1u) ? 1 : 0);
      }
    }
  }
}

// K11b: candidate sets of cameras (B, V, 16) over the shared masks. Block
// blockIdx.x takes candidate blockIdx.x / tiles and that candidate's voxel
// tile blockIdx.x % tiles: kCandThreads z runs of ZR voxels, in K11's run
// order.
constexpr int kCandThreads = 256;
constexpr int kListSlots = 4;                    // list entries a thread
constexpr int kCandTile = kCandThreads * kListSlots;   // ZR <= kListSlots
constexpr int kFirstKills = 4;       // phase 1's views a kill to die by
constexpr int kCandPairs = 64 * kCandThreads;    // phase 2's pairs a chunk
constexpr int kSeen = 1 << 30;                   // list state: seen flag
constexpr int kWarps = kCandThreads / 32;

// The list's entries whose kills are <= max_kills, moved to its front in
// order (each thread holds entries tid + m kCandThreads); returns the new
// length. Entered and left with the block in step.
__device__ __forceinline__ int compact_list(float* lx, float* ly, float* lz,
                                            int* lstate, int* lout, int n,
                                            int max_kills,
                                            int (*s_cnt)[kWarps]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float x[kListSlots], y[kListSlots], z[kListSlots];
  int st[kListSlots], out[kListSlots];
  unsigned bal[kListSlots];
#pragma unroll
  for (int m = 0; m < kListSlots; ++m) {
    const int e = tid + m * kCandThreads;
    bool keep = false;
    if (e < n) {
      x[m] = lx[e];
      y[m] = ly[e];
      z[m] = lz[e];
      st[m] = lstate[e];
      out[m] = lout[e];
      keep = (st[m] & (kSeen - 1)) <= max_kills;
    }
    bal[m] = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_cnt[m][warp] = __popc(bal[m]);
  }
  __syncthreads();
  int total = 0;
  int at[kListSlots];
#pragma unroll
  for (int m = 0; m < kListSlots; ++m) {
    at[m] = total;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) at[m] += s_cnt[m][w];
      total += s_cnt[m][w];
    }
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int m = 0; m < kListSlots; ++m) {
    if (bal[m] >> lane & 1u) {
      const int e = at[m] + __popc(bal[m] & below);
      lx[e] = x[m];
      ly[e] = y[m];
      lz[e] = z[m];
      lstate[e] = st[m];
      lout[e] = out[m];
    }
  }
  __syncthreads();
  return total;
}

// Positions [k0, k0 + nk) of the walk's view order, k -> k * stride mod V
// (V < 2^15, so the product fits 32 bits): their views into view_s, then
// their cameras into cam_s. Entered and left with the block in step.
__device__ __forceinline__ void stage_cameras(float* cam_s, int* view_s,
                                              const float* __restrict__ cb,
                                              int k0, int nk, int V,
                                              int stride) {
  for (int e = threadIdx.x; e < nk; e += blockDim.x)
    view_s[e] = (k0 + e) * stride % V;
  __syncthreads();
  for (int e = threadIdx.x; e < nk * 16; e += blockDim.x)
    cam_s[e] = cb[16 * view_s[e >> 4] + (e & 15)];
  __syncthreads();
}

template <int ZR>
__global__ void __launch_bounds__(kCandThreads)
    candidates_kernel(const uint8_t* __restrict__ packed, long long row_bytes,
                      const float* __restrict__ cams, int V, int H, int W,
                      float ox, float oy, float oz, float vs, int nx, int ny,
                      int nz, int max_kills, int stride, unsigned tiles,
                      uint8_t* __restrict__ alive) {
  extern __shared__ float cam_s[];          // min(V, kCamChunk) x 16
  __shared__ int view_s[kCamChunk];
  __shared__ float lx[kCandTile], ly[kCandTile], lz[kCandTile];
  __shared__ int lstate[kCandTile], lout[kCandTile];
  __shared__ int s_n;
  __shared__ int s_cnt[kListSlots][kWarps];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const float* cb = cams + b * V * 16;
  int c0 = 0, nc = min(V, kCamChunk);       // the staged positions
  if (tid == 0) s_n = 0;
  stage_cameras(cam_s, view_s, cb, 0, nc, V, stride);

  // phase 1: K11's z run with the (x, y) terms reused, the first views
  const int nzc = (nz + ZR - 1) / ZR;
  const long long nt = (long long)nx * ny * nzc;
  const long long t = tile * kCandThreads + tid;
  const bool live = t < nt;
  const long long tt = live ? t : 0;
  const int zc = (int)(tt % nzc);
  const long long col = tt / nzc;
  const int j = (int)(col % ny);
  const int i = (int)(col / ny);
  const int z0 = zc * ZR;
  const int nq = live ? min(ZR, nz - z0) : 0;
  const float x = __fadd_rn(ox, __fmul_rn(vs, (float)i));
  const float y = __fadd_rn(oy, __fmul_rn(vs, (float)j));
  float z[ZR];
  int kills[ZR];
#pragma unroll
  for (int q = 0; q < ZR; ++q) {
    z[q] = __fadd_rn(oz, __fmul_rn(vs, (float)(z0 + q)));
    kills[q] = 0;
  }
  unsigned seen = 0u;
  unsigned done = ~((1u << nq) - 1u);       // past the run, or killed
  // phase 1 walks kFirstKills views for each kill a voxel needs to die
  const int v1 = (int)min((long long)nc, kFirstKills * (max_kills + 1LL));
  for (int v = 0; v < v1 && done != ~0u; ++v) {
    const float* c = cam_s + 16 * v;
    const float pz_xy = __fmaf_rn(c[11], y, __fmul_rn(c[10], x));
    const float nx_xy = __fmaf_rn(c[5], y, __fmul_rn(c[4], x));
    const float ny_xy = __fmaf_rn(c[8], y, __fmul_rn(c[7], x));
    const uint8_t* mrow = packed + (long long)view_s[v] * row_bytes;
#pragma unroll
    for (int q = 0; q < ZR; ++q) {
      if (done & (1u << q)) continue;
      const float pz = __fadd_rn(__fmaf_rn(c[12], z[q], pz_xy), c[15]);
      if (!(pz > 0.0f)) continue;
      const float nxp = __fadd_rn(__fmaf_rn(c[6], z[q], nx_xy), c[13]);
      const float nyp = __fadd_rn(__fmaf_rn(c[9], z[q], ny_xy), c[14]);
      const int pxi = __float2int_rz(__fmaf_rn(__fdiv_rn(nxp, pz), c[0], c[2]));
      const int pyi = __float2int_rz(__fmaf_rn(__fdiv_rn(nyp, pz), c[1], c[3]));
      if ((unsigned)pxi >= (unsigned)W || (unsigned)pyi >= (unsigned)H)
        continue;
      const int lin = pyi * W + pxi;
      if ((__ldg(mrow + (lin >> 3)) << (lin & 7)) & 0x80)
        seen |= 1u << q;
      else if (++kills[q] > max_kills)
        done |= 1u << q;
    }
  }
  // every voxel of the run is 0 unless phase 2 finds it alive; the
  // undecided ones go to the list
  uint8_t* out = alive + b * ((long long)nx * ny * nz);
  const int idx0 = (int)(col * nz + z0);    // nx ny nz < 2^31
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < ZR; ++q) {
    if (q < nq) out[idx0 + q] = 0;
    const bool open = !(done >> q & 1u);
    const unsigned bal = __ballot_sync(0xffffffffu, open);
    int at = 0;
    if (lane == 0 && bal) at = atomicAdd(&s_n, __popc(bal));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (open) {
      const int e = at + __popc(bal & below);
      lx[e] = x;
      ly[e] = y;
      lz[e] = z[q];
      lstate[e] = kills[q] | (seen >> q & 1u ? kSeen : 0);
      lout[e] = idx0 + q;
    }
  }
  __syncthreads();
  int n = s_n;

  // phase 2: the open voxels' remaining (voxel, view) pairs over the
  // block's threads, a chunk of views at a time, then the list compacted
  for (int v = v1; v < V && n > 0;) {
    if (v >= c0 + nc) {                     // the next camera chunk
      c0 = v;
      nc = min(kCamChunk, V - c0);
      stage_cameras(cam_s, view_s, cb, c0, nc, V, stride);
    }
    const int vc = min(c0 + nc - v, max(1, (kCandPairs + n - 1) / n));
#pragma unroll 4
    for (int p = tid; p < n * vc; p += kCandThreads) {
      const int dv = p / n;
      const int e = p - dv * n;
      const float* c = cam_s + 16 * (v - c0 + dv);
      const float ex = lx[e], ey = ly[e], ez = lz[e];
      const float pz = dot3_add(c[10], c[11], c[12], ex, ey, ez, c[15]);
      if (!(pz > 0.0f)) continue;
      const float nxp = dot3_add(c[4], c[5], c[6], ex, ey, ez, c[13]);
      const float nyp = dot3_add(c[7], c[8], c[9], ex, ey, ez, c[14]);
      const int pxi = __float2int_rz(__fmaf_rn(__fdiv_rn(nxp, pz), c[0], c[2]));
      const int pyi = __float2int_rz(__fmaf_rn(__fdiv_rn(nyp, pz), c[1], c[3]));
      if ((unsigned)pxi >= (unsigned)W || (unsigned)pyi >= (unsigned)H)
        continue;
      const int lin = pyi * W + pxi;
      const uint8_t* mrow = packed + (long long)view_s[v - c0 + dv] * row_bytes;
      if ((__ldg(mrow + (lin >> 3)) << (lin & 7)) & 0x80)
        atomicOr(&lstate[e], kSeen);
      else
        atomicAdd(&lstate[e], 1);
    }
    v += vc;
    __syncthreads();
    n = compact_list(lx, ly, lz, lstate, lout, n, max_kills, s_cnt);
  }
  for (int e = tid; e < n; e += kCandThreads) {
    const int st = lstate[e];
    if ((st & kSeen) && (st & (kSeen - 1)) <= max_kills) out[lout[e]] = 1;
  }
}


// K1: the strict carve. A block takes kCarveThreads z runs of ZR voxels
// (K11's run order) and writes their int8 verdicts.
constexpr int kCarveThreads = 256;
constexpr int kCarveWarps = kCarveThreads / 32;
// phase 1's z run: 1 voxel, so that a tile's open voxels (the hull in a
// tight box) never outnumber its threads
constexpr int kCarveRun = 1;
// phase 2's largest batch: views a thread tests before it looks at the
// kill flag
constexpr int kCarveBatch = 4;
constexpr int kCarveList = kCarveThreads * kCarveRun;   // the open voxels
constexpr int kCarveFirst = 4;                  // phase 1's views

// A camera row from shared memory: a = fx fy cx cy, b = r00 r01 r02 r10,
// c = r11 r12 r20 r21, d = r22 t0 t1 t2.
struct Cam {
  float4 a, b, c, d;
};

__device__ __forceinline__ Cam load_cam(const float4* cam_s, int v) {
  return {cam_s[4 * v], cam_s[4 * v + 1], cam_s[4 * v + 2], cam_s[4 * v + 3]};
}

// One voxel-view test: -1 behind the camera or out of frame, else the
// packed mask bit at the voxel's pixel (0 a miss, 1 a hit).
__device__ __forceinline__ int carve_test(const Cam& k,
                                          const uint8_t* __restrict__ mrow,
                                          int H, int W, float x, float y,
                                          float z) {
  const float pz = dot3_add(k.c.z, k.c.w, k.d.x, x, y, z, k.d.w);
  if (!(pz > 0.0f)) return -1;
  const float nxp = dot3_add(k.b.x, k.b.y, k.b.z, x, y, z, k.d.y);
  const float nyp = dot3_add(k.b.w, k.c.x, k.c.y, x, y, z, k.d.z);
  const int pxi = __float2int_rz(__fmaf_rn(__fdiv_rn(nxp, pz), k.a.x, k.a.z));
  const int pyi = __float2int_rz(__fmaf_rn(__fdiv_rn(nyp, pz), k.a.y, k.a.w));
  if ((unsigned)pxi >= (unsigned)W || (unsigned)pyi >= (unsigned)H)
    return -1;
  const int lin = pyi * W + pxi;
  return (__ldg(mrow + (lin >> 3)) >> (7 - (lin & 7))) & 1;
}

// The valid views of spread positions [k0, k0 + nk) (nk <= kCarveThreads),
// k -> k * stride mod V, in order: their views into view_s and cameras
// into cam_s; a warp ballot a position. Returns how many. Entered and left
// with the block in step.
__device__ __forceinline__ int stage_valid_cameras(
    float* cam_s, int* view_s, int* s_warp, const float* __restrict__ cams,
    const uint8_t* __restrict__ valid, int k0, int nk, int V, int stride) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int view = 0;
  bool ok = false;
  if (tid < nk) {
    view = (int)((long long)(k0 + tid) * stride % V);
    ok = valid[view] != 0;
  }
  const unsigned bal = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) s_warp[warp] = __popc(bal);
  __syncthreads();
  int at = 0, n = 0;
  for (int w = 0; w < kCarveWarps; ++w) {
    if (w < warp) at += s_warp[w];
    n += s_warp[w];
  }
  if (ok) view_s[at + __popc(bal & ((1u << lane) - 1u))] = view;
  __syncthreads();
  for (int e = tid; e < n * 16; e += kCarveThreads)
    cam_s[e] = cams[16 * view_s[e >> 4] + (e & 15)];
  __syncthreads();
  return n;
}

template <int ZR>
__global__ void __launch_bounds__(kCarveThreads)
    carve_kernel(const uint8_t* __restrict__ packed, long long row_bytes,
                 const float* __restrict__ cams,
                 const uint8_t* __restrict__ valid, int V, int H, int W,
                 float ox, float oy, float oz, float vs, int x_start, int nx,
                 int ny, int nz, int stride, int tiles,
                 int8_t* __restrict__ vol) {
  extern __shared__ float4 cam4_s[];        // min(V, kCarveThreads) x 4
  __shared__ int view_s[kCarveThreads];
  __shared__ float lx[kCarveList], ly[kCarveList], lz[kCarveList];
  __shared__ int lout[kCarveList];
  __shared__ uint8_t lkill[kCarveList], lseen[kCarveList];
  __shared__ int s_n;
  __shared__ int s_warp[kCarveWarps];
  const int tid = threadIdx.x, lane = tid & 31;
  volatile uint8_t* kill = lkill;
  const int nzc = (nz + ZR - 1) / ZR;
  const int runs = nx * ny * nzc;
  const unsigned below = (1u << lane) - 1u;
  if (tid == 0) s_n = 0;
  int c0 = 0;                               // the staged chunk's position
  int nc = stage_valid_cameras((float*)cam4_s, view_s, s_warp, cams, valid, 0,
                               min(V, kCarveThreads), V, stride);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // phase 1: a z run, the (x, y) terms reused, the first views
    const int t = tile * kCarveThreads + tid;
    const bool live = t < runs;
    const int tt = live ? t : 0;
    const int col = tt / nzc;
    const int zc = tt - col * nzc;
    const int i = col / ny;
    const int j = col - i * ny;
    const int z0 = zc * ZR;
    const int nq = live ? min(ZR, nz - z0) : 0;
    // the voxel's global x index: a slab's rows are those of the grid
    const float x = __fadd_rn(ox, __fmul_rn(vs, (float)(x_start + i)));
    const float y = __fadd_rn(oy, __fmul_rn(vs, (float)j));
    float z[ZR];
#pragma unroll
    for (int q = 0; q < ZR; ++q)
      z[q] = __fadd_rn(oz, __fmul_rn(vs, (float)(z0 + q)));
    unsigned seen = 0u;
    unsigned done = ~((1u << nq) - 1u);       // past the run, or killed
    const int v1 = min(nc, kCarveFirst);
    for (int v = 0; v < v1 && done != ~0u; ++v) {
      const Cam k = load_cam(cam4_s, v);
      const float pz_xy = __fmaf_rn(k.c.w, y, __fmul_rn(k.c.z, x));
      const float nx_xy = __fmaf_rn(k.b.y, y, __fmul_rn(k.b.x, x));
      const float ny_xy = __fmaf_rn(k.c.x, y, __fmul_rn(k.b.w, x));
      const uint8_t* mrow = packed + (long long)view_s[v] * row_bytes;
#pragma unroll
      for (int q = 0; q < ZR; ++q) {
        if (done & (1u << q)) continue;
        const float pz = __fadd_rn(__fmaf_rn(k.d.x, z[q], pz_xy), k.d.w);
        if (!(pz > 0.0f)) continue;
        const float nxp = __fadd_rn(__fmaf_rn(k.b.z, z[q], nx_xy), k.d.y);
        const float nyp = __fadd_rn(__fmaf_rn(k.c.y, z[q], ny_xy), k.d.z);
        const int pxi =
            __float2int_rz(__fmaf_rn(__fdiv_rn(nxp, pz), k.a.x, k.a.z));
        const int pyi =
            __float2int_rz(__fmaf_rn(__fdiv_rn(nyp, pz), k.a.y, k.a.w));
        if ((unsigned)pxi >= (unsigned)W || (unsigned)pyi >= (unsigned)H)
          continue;
        const int lin = pyi * W + pxi;
        if ((__ldg(mrow + (lin >> 3)) << (lin & 7)) & 0x80)
          seen |= 1u << q;
        else
          done |= 1u << q;
      }
    }
    // every voxel of the run is -1 now, and 1 or 0 again if phase 2 finds
    // no miss; the undecided ones go to the list
    const int idx0 = col * nz + z0;
#pragma unroll
    for (int q = 0; q < ZR; ++q) {
      if (q < nq) vol[idx0 + q] = -1;
      const bool open = !(done >> q & 1u);
      const unsigned bal = __ballot_sync(0xffffffffu, open);
      int at = 0;
      if (lane == 0 && bal) at = atomicAdd(&s_n, __popc(bal));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (open) {
        const int e = at + __popc(bal & below);
        lx[e] = x;
        ly[e] = y;
        lz[e] = z[q];
        lout[e] = idx0 + q;
        lkill[e] = 0;
        lseen[e] = (seen >> q) & 1u;
      }
    }
    __syncthreads();
    const int n = s_n;

    // phase 2: g threads an open voxel, thread r of them the views start +
    // r + g m, in batches whose mask loads are in flight together; every
    // walk stops after the batch in which any of its threads found a miss
    if (n > 0) {
      int g = 1;
      while (g < 32 && 2 * g * n <= kCarveThreads) g *= 2;
      const int r = tid & (g - 1);
      for (int start = v1;;) {
        for (int e = tid / g; e < n; e += kCarveThreads / g) {
          const float ex = lx[e], ey = ly[e], ez = lz[e];
          // batches of 1, 2, then kCarveBatch views: a voxel that dies
          // soon wastes few tests, a hull voxel keeps kCarveBatch mask
          // loads in flight
          for (int v = start + r, nb = 1; v < nc && !kill[e];
               v += nb * g, nb = min(2 * nb, kCarveBatch)) {
            int h[kCarveBatch];
#pragma unroll
            for (int u = 0; u < kCarveBatch; ++u) {
              const int vu = v + u * g;
              h[u] = u < nb && vu < nc
                         ? carve_test(load_cam(cam4_s, vu),
                                      packed + (long long)view_s[vu] *
                                                   row_bytes,
                                      H, W, ex, ey, ez)
                         : -1;
            }
            bool miss = false, hit = false;
#pragma unroll
            for (int u = 0; u < kCarveBatch; ++u) {
              miss |= h[u] == 0;
              hit |= h[u] > 0;
            }
            if (miss)
              kill[e] = 1;
            else if (hit)
              lseen[e] = 1;
          }
        }
        if (c0 + kCarveThreads >= V) break;
        c0 += kCarveThreads;                  // the next camera chunk
        nc = stage_valid_cameras((float*)cam4_s, view_s, s_warp, cams, valid,
                                 c0, min(kCarveThreads, V - c0), V, stride);
        start = 0;
      }
      __syncthreads();
      for (int e = tid; e < n; e += kCarveThreads)
        if (!lkill[e]) vol[lout[e]] = lseen[e] ? 1 : 0;
    }
    // the next tile: the list and its count free, the first chunk staged
    __syncthreads();
    if (tid == 0) s_n = 0;
    if (c0 != 0 && tile + (int)gridDim.x < tiles) {
      c0 = 0;
      nc = stage_valid_cameras((float*)cam4_s, view_s, s_warp, cams, valid, 0,
                               min(V, kCarveThreads), V, stride);
    } else {
      __syncthreads();
    }
  }
}

// The walk's view stride for V views: the integer nearest 0.618 V that is
// prime to V, as K11b's (p3d_carve_candidates).
int spread_stride(int V) {
  auto gcd = [](int a, int b) {
    while (b) {
      const int t = a % b;
      a = b;
      b = t;
    }
    return a;
  };
  int stride = (int)(0.618 * V + 0.5);
  while (gcd(stride, V) != 1) ++stride;
  return stride;
}

}  // namespace


// K11b: alive (B, nx, ny, nz) uint8 0/1 of B candidate camera sets; the
// other arguments as p3d_carve's (every view valid; nx ny nz < 2^31).
extern "C" int p3d_carve_candidates(const void* packed, long long row_bytes,
                                    const void* cams, int B, int V, int H,
                                    int W, float ox, float oy, float oz,
                                    float vs, int nx, int ny, int nz,
                                    int max_kills, void* alive,
                                    void* stream) {
  // phase 1's z run: 4 voxels when the first kill decides a voxel (their
  // tests overlap), 1 under a tolerance, where a run's thread would walk
  // until every voxel of it had max_kills + 1 kills
  const int zr = max_kills == 0 ? 4 : 1;
  const long long runs = (long long)nx * ny * ((nz + zr - 1) / zr);
  const long long tiles = (runs + kCandThreads - 1) / kCandThreads;
  if (tiles * B > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * 16 * (size_t)min(V, kCamChunk);
  // the views in the order k -> k * stride mod V, stride the integer
  // nearest 0.618 V that is prime to V: views spread round the turntable
  // early, so a voxel outside the hull meets a view that kills it sooner
  // than along the ring
  int stride = (int)(0.618 * V + 0.5);
  auto gcd = [](int a, int b) {
    while (b) {
      const int t = a % b;
      a = b;
      b = t;
    }
    return a;
  };
  while (gcd(stride, V) != 1) ++stride;
  (zr == 4 ? candidates_kernel<4> : candidates_kernel<1>)
      <<<(unsigned)(tiles * B), kCandThreads, smem, (cudaStream_t)stream>>>(
          (const uint8_t*)packed, row_bytes, (const float*)cams, V, H, W, ox,
          oy, oz, vs, nx, ny, nz, max_kills, stride, (unsigned)tiles,
          (uint8_t*)alive);
  return (int)cudaGetLastError();
}

// K11: count mode (max_kills < 0) writes kills (int16) and seen (uint8
// 0/1); verdict mode writes vol (int8). The arguments as p3d_carve's. A
// thread walks a run of 8 z voxels in count mode and 1 in verdict mode.
extern "C" int p3d_count_kills(const void* packed, long long row_bytes,
                               const void* cams, const void* valid, int V,
                               int H, int W, float ox, float oy, float oz,
                               float vs, int nx, int ny, int nz,
                               int max_kills, void* kills, void* seen,
                               void* vol, void* stream) {
  const int zrun = max_kills < 0 ? 8 : 1;
  void (*kernel)(const uint8_t*, long long, const float*, const uint8_t*,
                 int, int, int, float, float, float, float, int, int, int,
                 int, int16_t*, uint8_t*, int8_t*) =
      max_kills < 0 ? kills_kernel<8> : kills_kernel<1>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kKillThreads, 0);
  if (err != cudaSuccess) return (int)err;
  // count mode: a block a tile; verdict mode, whose voxels stop at their
  // own kills so that tiles take uneven time: as many blocks as the card
  // holds, each taking tiles in turn (measured faster there and slower in
  // count mode on an H100)
  const long long n = (long long)nx * ny * ((nz + zrun - 1) / zrun);
  const long long need = (n + kKillThreads - 1) / kKillThreads;
  const long long most = (long long)per_sm * sms;
  const int blocks = (int)(max_kills < 0 || need < most ? (need > 0 ? need : 1)
                                                         : most);
  kernel<<<blocks, kKillThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, row_bytes, (const float*)cams,
      (const uint8_t*)valid, V, H, W, ox, oy, oz, vs, nx, ny, nz, max_kills,
      (int16_t*)kills, (uint8_t*)seen, (int8_t*)vol);
  return (int)cudaGetLastError();
}


// K1: vol (nx, ny, nz) int8, -1 where an in-frame valid view misses the
// voxel, else 1 where one hits it, else 0: packed (V, row_bytes) mask rows,
// cams (V, 16), valid (V,) 0/1 bytes, all contiguous on the card;
// nx ny nz <= 2^31 - 256 (32-bit voxel indexes). x_start is the global x
// index of the first row: the voxel centres are those of rows [x_start,
// x_start + nx) of a larger grid at the same origin (a slab of a sharded
// carve). One launch.
extern "C" int p3d_carve(const void* packed, long long row_bytes,
                         const void* cams, const void* valid, int V, int H,
                         int W, float ox, float oy, float oz, float vs,
                         int x_start, int nx, int ny, int nz, void* out,
                         void* stream) {
  const int zr = kCarveRun;
  const long long runs = (long long)nx * ny * ((nz + zr - 1) / zr);
  const long long tiles = (runs + kCarveThreads - 1) / kCarveThreads;
  if (tiles * kCarveThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if (tiles == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * 16 * (size_t)std::min(V, kCarveThreads);
  // as many blocks as the card holds, each walking tiles in turn with the
  // cameras staged once (when they fit one chunk)
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, carve_kernel<kCarveRun>, kCarveThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      std::min(tiles, (long long)std::max(per_sm, 1) * sms);
  carve_kernel<kCarveRun>
      <<<(unsigned)blocks, kCarveThreads, smem, (cudaStream_t)stream>>>(
          (const uint8_t*)packed, row_bytes, (const float*)cams,
          (const uint8_t*)valid, V, H, W, ox, oy, oz, vs, x_start, nx, ny,
          nz, spread_stride(V), (int)tiles, (int8_t*)out);
  return (int)cudaGetLastError();
}

// The message of an error code that an entry point of the library (any
// csrc/*.cu) returned.
extern "C" const char* p3d_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

