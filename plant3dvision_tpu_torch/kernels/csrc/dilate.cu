// K8 dilate: binary dilation of a stack of masks with an exact Euclidean disk.
//
// Replaces plant3dvision_tpu/ops/masks.py:binary_dilation (the jitted max over
// rolled copies that Segmentation2D runs on every thresholded mask): out[y, x]
// is true when any pixel (y - dy, x - dx) of the disk footprint {dy^2 + dx^2
// <= r^2} (ops/masks.py:_disk_offsets) that lies inside the frame is true;
// pixels outside the frame count as false (no wrap-around).
//
// What bounds it on the card: bytes. It reads the (M, H, W) bool stack once
// and writes it once (M = 756 masks of 896x896 for a 126-view, 6-label scan:
// 607 MB each way); the operations are a few integer compares per offset.
//
// Design: one thread per pixel, neighbouring threads on neighbouring pixels
// of a row, so the reads of an offset are coalesced and the 2r+1 rows a warp
// touches are served from L1/L2. The disk's offsets live in constant memory
// (every thread reads the same offset at the same time: a broadcast), in
// _disk_offsets' order, and the loop stops at the first true pixel, so a
// pixel inside a mask costs one read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOffsets = 4096;   // a disk up to radius 35
__constant__ int2 kOffsets[kMaxOffsets];

__global__ void dilate_kernel(const uint8_t* __restrict__ in,
                              uint8_t* __restrict__ out, long long n, int H,
                              int W, int n_off) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int x = (int)(idx % W);
  const long long r = idx / W;
  const int y = (int)(r % H);
  const uint8_t* plane = in + (r / H) * H * (long long)W;
  uint8_t hit = 0;
  for (int i = 0; i < n_off; ++i) {
    const int yy = y - kOffsets[i].x;
    const int xx = x - kOffsets[i].y;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W &&
        plane[(long long)yy * W + xx]) {
      hit = 1;
      break;
    }
  }
  out[idx] = hit;
}

}  // namespace

// in, out (M, H, W) uint8 (0 = false); offsets (host) n_off (dy, dx) int32
// pairs, copied to constant memory on the stream before the launch.
extern "C" int p3d_dilate(const void* in, void* out, long long M, int H, int W,
                          const void* offsets, int n_off, void* stream) {
  if (n_off < 1 || n_off > kMaxOffsets) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(kOffsets, offsets,
                                            n_off * sizeof(int2), 0,
                                            cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const long long n = M * H * (long long)W;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  dilate_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      (const uint8_t*)in, (uint8_t*)out, n, H, W, n_off);
  return (int)cudaGetLastError();
}
