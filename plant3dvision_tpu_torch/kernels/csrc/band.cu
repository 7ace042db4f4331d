// K4 band compaction: the level-set band of the signed distance as
// (flat index, d, gx, gy, gz) records, in index order.
//
// Replaces plant3dvision_tpu/proc3d.py:_compact_indices and the band part
// of _vol2pcd_dense (proc3d.py:37-76): on_edge = (d > -l) & (d <= -l+sqrt3)
// in f32, then an ordered stream compaction. The JAX package bucketed a
// static band_cap and retried (XLA's static shapes); here the band is
// counted first and the outputs are allocated exactly.
//
// What bounds it on the card: reading d (4 bytes per voxel) twice, and the
// three gradients only at band voxels (a few % of the grid), then writing
// 24 bytes per band record. HBM bandwidth bound.
//
// Design: a tile of 16 x 256 consecutive voxels per block. Pass 1 counts
// the band per tile (warp shuffle + shared-memory reduction). The
// exclusive scan of the few thousand tile counts is a plain scan done by
// the wrapper. Pass 2 re-tests the tile in 16 rounds of 256 voxels; each
// round ranks its members with a warp ballot + popc and a prefix over the
// 8 warp totals, so records land at offset[tile] + running + rank, which
// keeps index order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool on_edge(float d, float lo, float hi) {
  return d > lo && d <= hi;
}

__global__ void band_count_kernel(const float* __restrict__ d, long long n,
                                  float lo, float hi,
                                  long long* __restrict__ counts) {
  __shared__ int warp_sum[kWarps];
  const long long tile = (long long)blockIdx.x * kTile;
  int c = 0;
  for (int r = 0; r < kItems; ++r) {
    const long long q = tile + (long long)r * kThreads + threadIdx.x;
    if (q < n && on_edge(d[q], lo, hi)) ++c;
  }
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w];
    counts[blockIdx.x] = s;
  }
}

__global__ void band_scatter_kernel(
    const float* __restrict__ d, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ gz, long long n,
    float lo, float hi, const long long* __restrict__ offsets,
    long long* __restrict__ idx_out, float* __restrict__ d_out,
    float* __restrict__ g_out) {
  __shared__ int warp_tot[kWarps];
  const long long tile = (long long)blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long running = offsets[blockIdx.x];
  for (int r = 0; r < kItems; ++r) {
    const long long q = tile + (long long)r * kThreads + threadIdx.x;
    float dv = 0.0f;
    bool p = false;
    if (q < n) {
      dv = d[q];
      p = on_edge(dv, lo, hi);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, p);
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_tot[w];
      if (w < warp) before += t;
      total += t;
    }
    if (p) {
      const long long o =
          running + before + __popc(ballot & ((1u << lane) - 1u));
      idx_out[o] = q;
      d_out[o] = dv;
      g_out[3 * o + 0] = gx[q];
      g_out[3 * o + 1] = gy[q];
      g_out[3 * o + 2] = gz[q];
    }
    running += total;
    __syncthreads();
  }
}

}  // namespace

extern "C" int p3d_band_tiles(long long n) {
  return (int)((n + kTile - 1) / kTile);
}

extern "C" int p3d_band_count(const void* d, long long n, float lo, float hi,
                              void* counts, void* stream) {
  const long long blocks = (n + kTile - 1) / kTile;
  band_count_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, n, lo, hi, (long long*)counts);
  return (int)cudaGetLastError();
}

extern "C" int p3d_band_scatter(const void* d, const void* gx, const void* gy,
                                const void* gz, long long n, float lo,
                                float hi, const void* offsets, void* idx_out,
                                void* d_out, void* g_out, void* stream) {
  const long long blocks = (n + kTile - 1) / kTile;
  band_scatter_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)d, (const float*)gx, (const float*)gy, (const float*)gz,
      n, lo, hi, (const long long*)offsets, (long long*)idx_out,
      (float*)d_out, (float*)g_out);
  return (int)cudaGetLastError();
}
