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
// What bounds it on the card: one random byte read per voxel-view test
// from the packed masks (V x ceil(HW/8) bytes, MSB-first np.packbits rows;
// 19.4 MB for a 100-view group at 1440x1080, inside the 50 MB L2), plus
// ~24 f32 operations for the projection. The grid itself is written once
// (1 byte per voxel). The early exit leaves few tests, and those read
// few distinct mask bytes (0.2 MB on a north-star group), so the least
// work is the tests' arithmetic; in practice the kernel is bound by
// launch overhead and L2 latency, far from HBM bandwidth.
//
// Design: one thread per voxel, flat index in C order (z fastest), so a
// warp's voxels are neighbours along z and project to neighbouring pixels
// (good L1/L2 sector reuse on the mask reads) and the int8 store is
// coalesced. Each thread loops over the views and stops at the first
// kill (-1 dominates). Camera rows are warp-uniform loads (broadcast).
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
// carve_tolerant stops once the count exceeds max_kills (the verdict is -1
// whatever the rest says; the wrapper keeps the view count below 2^15, so
// the int16 count cannot wrap back). What bounds it on the card: the same
// mask reads and ~24 f32 operations per voxel-view test as K1, but without
// K1's early exit in count mode, so every valid voxel-view pair is a test.

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

// The centre of voxel `idx` (flat, C order, z fastest): origin + vs*i.
__device__ __forceinline__ void voxel_centre(long long idx, int ny, int nz,
                                             float ox, float oy, float oz,
                                             float vs, float& x, float& y,
                                             float& z) {
  const int k = (int)(idx % nz);
  const long long r = idx / nz;
  const int j = (int)(r % ny);
  const int i = (int)(r / ny);
  x = __fadd_rn(ox, __fmul_rn(vs, (float)i));
  y = __fadd_rn(oy, __fmul_rn(vs, (float)j));
  z = __fadd_rn(oz, __fmul_rn(vs, (float)k));
}

// One voxel-view test of K1 and K11: -1 out of frame (or behind the
// camera), else the packed mask bit at the voxel's pixel. c = [fx, fy, cx,
// cy, r00..r22 (row-major), t0, t1, t2].
__device__ __forceinline__ int view_test(const uint8_t* __restrict__ packed,
                                         long long row_bytes,
                                         const float* __restrict__ c, int v,
                                         int H, int W, float x, float y,
                                         float z) {
  const float pz = dot3_add(c[10], c[11], c[12], x, y, z, c[15]);
  const float nxp = dot3_add(c[4], c[5], c[6], x, y, z, c[13]);
  const float nyp = dot3_add(c[7], c[8], c[9], x, y, z, c[14]);
  const float px = __fmaf_rn(__fdiv_rn(nxp, pz), c[0], c[2]);
  const float py = __fmaf_rn(__fdiv_rn(nyp, pz), c[1], c[3]);
  const int pxi = __float2int_rz(px);
  const int pyi = __float2int_rz(py);
  if (!(pz > 0.0f) || pxi < 0 || pxi > W - 1 || pyi < 0 || pyi > H - 1)
    return -1;
  const long long lin = (long long)pyi * W + pxi;
  const uint8_t byte = packed[(long long)v * row_bytes + (lin >> 3)];
  return (byte >> (7 - (int)(lin & 7))) & 1;
}

__global__ void carve_kernel(const uint8_t* __restrict__ packed,
                             long long row_bytes,
                             const float* __restrict__ cams,
                             const uint8_t* __restrict__ valid, int V, int H,
                             int W, float ox, float oy, float oz, float vs,
                             int nx, int ny, int nz,
                             int8_t* __restrict__ out) {
  const long long n = (long long)nx * ny * nz;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float x, y, z;
  voxel_centre(idx, ny, nz, ox, oy, oz, vs, x, y, z);

  int8_t label = 0;
  for (int v = 0; v < V; ++v) {
    if (!valid[v]) continue;
    const int t = view_test(packed, row_bytes, cams + 16 * v, v, H, W, x, y,
                            z);
    if (t < 0) continue;
    if (t == 0) {
      label = -1;
      break;
    }
    label = 1;
  }
  out[idx] = label;
}

// max_kills < 0: count mode (kills, seen written); else the verdict (vol).
__global__ void kills_kernel(const uint8_t* __restrict__ packed,
                             long long row_bytes,
                             const float* __restrict__ cams,
                             const uint8_t* __restrict__ valid, int V, int H,
                             int W, float ox, float oy, float oz, float vs,
                             int nx, int ny, int nz, int max_kills,
                             int16_t* __restrict__ kills_out,
                             uint8_t* __restrict__ seen_out,
                             int8_t* __restrict__ vol_out) {
  const long long n = (long long)nx * ny * nz;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float x, y, z;
  voxel_centre(idx, ny, nz, ox, oy, oz, vs, x, y, z);

  int16_t kills = 0;
  bool seen = false;
  for (int v = 0; v < V; ++v) {
    if (!valid[v]) continue;
    const int t = view_test(packed, row_bytes, cams + 16 * v, v, H, W, x, y,
                            z);
    if (t < 0) continue;
    if (t) {
      seen = true;
    } else {
      kills = (int16_t)(kills + 1);
      if (max_kills >= 0 && kills > max_kills) break;
    }
  }
  if (max_kills < 0) {
    kills_out[idx] = kills;
    seen_out[idx] = seen;
  } else {
    vol_out[idx] = kills > max_kills ? -1 : (seen ? 1 : 0);
  }
}

}  // namespace

// K11: count mode (max_kills < 0) writes kills (int16) and seen (uint8
// 0/1); verdict mode writes vol (int8). The arguments as p3d_carve's.
extern "C" int p3d_count_kills(const void* packed, long long row_bytes,
                               const void* cams, const void* valid, int V,
                               int H, int W, float ox, float oy, float oz,
                               float vs, int nx, int ny, int nz,
                               int max_kills, void* kills, void* seen,
                               void* vol, void* stream) {
  const long long n = (long long)nx * ny * nz;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  kills_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, row_bytes, (const float*)cams,
      (const uint8_t*)valid, V, H, W, ox, oy, oz, vs, nx, ny, nz, max_kills,
      (int16_t*)kills, (uint8_t*)seen, (int8_t*)vol);
  return (int)cudaGetLastError();
}

extern "C" int p3d_carve(const void* packed, long long row_bytes,
                         const void* cams, const void* valid, int V, int H,
                         int W, float ox, float oy, float oz, float vs,
                         int nx, int ny, int nz, void* out, void* stream) {
  const long long n = (long long)nx * ny * nz;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  carve_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, row_bytes, (const float*)cams,
      (const uint8_t*)valid, V, H, W, ox, oy, oz, vs, nx, ny, nz,
      (int8_t*)out);
  return (int)cudaGetLastError();
}

// The message of an error code that an entry point of the library (any
// csrc/*.cu) returned.
extern "C" const char* p3d_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
