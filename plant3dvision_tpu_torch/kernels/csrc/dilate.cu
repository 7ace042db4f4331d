// K8 dilate: binary dilation of a stack of masks with an exact Euclidean disk.
//
// Replaces plant3dvision_tpu/ops/masks.py:binary_dilation (the jitted max over
// rolled copies that Segmentation2D runs on every thresholded mask): out[y, x]
// is true when any pixel (y - dy, x - dx) of the disk footprint {dy^2 + dx^2
// <= r^2} (ops/masks.py:_disk_offsets) that lies inside the frame is true;
// pixels outside the frame count as false (no wrap-around).
//
// What bounds it on the card: bytes. It reads the (M, H, W) bool stack once
// and writes it once (60 keypoint masks of 1440x1080: 93 MB each way; 756
// masks of 896x896: 607 MB); the operations are a few bit operations a
// 32-pixel word.
//
// Design: the disk is the union of its 2r + 1 horizontal chords, the chord
// at dy spanning |dx| <= w(dy) = isqrt(r^2 - dy^2) (the wrapper's table,
// passed by value). So out[y] = OR over dy of H_w(dy)[y - dy], where H_w is
// the row dilated by w pixels either way. A block takes one (mask, band of
// kRows rows, strip of S words) tile:
//   1. pack: the band's rows plus r halo rows above and below, the strip's
//      words plus ceil(r / 32) halo words either side, into shared memory as
//      32-bit words (bit b = pixel 32 * word + b): a thread a word, two
//      16-byte loads where the 32 pixels are whole and aligned (a byte at a
//      time at a ragged row end). Rows and words outside the frame are 0.
//   2. row pass: H_w = H_(w-1) | H_(w-1) shifted one pixel either way (the
//      carry from the neighbouring word), in place of the packed rows, one
//      step a level, w = 0 .. r. The tile's outer words take 0 from beyond
//      it; that error moves in a pixel a step and never reaches the strip.
//   3. column pass: walking |dy| from r down to 0 (w(dy) rising), each
//      output word ORs in H_w(dy) at rows y - dy and y + dy.
//   4. unpack: each output word back to 32 bytes, two 16-byte stores.
// HBM traffic is the stack once in (the halo rows come again from L2) and
// once out. Indexes are 32-bit below 2^31 bytes, 64-bit above.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRadius = 36;     // the old per-offset kernel's limit
constexpr int kRows = 32;          // output rows a block
constexpr int kMaxStrip = 64;      // output words a block (2048 pixels)
constexpr int kThreads = 256;
constexpr int kStaticSmem = 48 << 10;

struct Chords {
  int w[2 * kMaxRadius + 1];       // w[dy + r] = isqrt(r^2 - dy^2)
};

// 4 bytes -> 4 bits (byte != 0), byte k to bit k
__device__ __forceinline__ uint32_t bits4(uint32_t v) {
  return ((__vcmpne4(v, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// 4 bits -> 4 bytes of 0 / 1, bit k to byte k
__device__ __forceinline__ uint32_t bytes4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t bits16(uint4 q) {
  return bits4(q.x) | bits4(q.y) << 4 | bits4(q.z) << 8 | bits4(q.w) << 12;
}

__device__ __forceinline__ uint4 bytes16(uint32_t b) {
  return make_uint4(bytes4(b & 15u), bytes4(b >> 4 & 15u),
                    bytes4(b >> 8 & 15u), bytes4(b >> 12 & 15u));
}

// the 32 pixels from x0 of a row of W, as a word (pixels past W are 0)
__device__ __forceinline__ uint32_t pack(const uint8_t* row, int x0, int W) {
  const uint8_t* p = row + x0;
  if (x0 + 32 <= W && ((uintptr_t)p & 15u) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
    return bits16(__ldg(v)) | bits16(__ldg(v + 1)) << 16;
  }
  uint32_t word = 0;
  const int n = min(32, W - x0);
  for (int b = 0; b < n; ++b) word |= (uint32_t)(p[b] != 0) << b;
  return word;
}

__device__ __forceinline__ void unpack(uint8_t* row, int x0, int W,
                                       uint32_t word) {
  uint8_t* p = row + x0;
  if (x0 + 32 <= W && ((uintptr_t)p & 15u) == 0) {
    uint4* v = reinterpret_cast<uint4*>(p);
    v[0] = bytes16(word & 0xffffu);
    v[1] = bytes16(word >> 16);
    return;
  }
  const int n = min(32, W - x0);
  for (int b = 0; b < n; ++b) p[b] = (uint8_t)(word >> b & 1u);
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
dilate_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
              int H, int W, int nwords, int S, int nstrips, int nbands,
              int r, int hw, Chords ch) {
  extern __shared__ uint32_t smem[];
  const int R = kRows + 2 * r;     // buffer rows: the band and its halo
  const int P = S + 2 * hw;        // buffer words a row
  uint32_t* cur = smem;
  uint32_t* nxt = smem + R * P;
  uint32_t* acc = smem + 2 * R * P;
  int b = blockIdx.x;
  const int strip = b % nstrips;
  b /= nstrips;
  const int band = b % nbands;
  const Idx plane = (Idx)(b / nbands) * H * W;
  const int y0 = band * kRows, w0 = strip * S;

  // 1. pack (buffer row i is frame row y0 - r + i, word j is w0 - hw + j)
  for (int e = threadIdx.x; e < R * P; e += kThreads) {
    const int i = e / P, j = e - i * P;
    const int y = y0 - r + i, gw = w0 - hw + j;
    cur[e] = (y >= 0 && y < H && gw >= 0 && gw < nwords)
                 ? pack(in + plane + (Idx)y * W, 32 * gw, W)
                 : 0u;
  }
  for (int e = threadIdx.x; e < kRows * S; e += kThreads) acc[e] = 0u;
  __syncthreads();

  // 2-3. levels w = 0 .. r, each output word taking the chords of its level
  int level = 0;
  for (int a = r; a >= 0; --a) {
    for (const int target = ch.w[a + r]; level < target; ++level) {
      for (int e = threadIdx.x; e < R * P; e += kThreads) {
        const int j = e % P;
        const uint32_t v = cur[e];
        const uint32_t lo = j > 0 ? cur[e - 1] : 0u;       // pixels left
        const uint32_t hi = j < P - 1 ? cur[e + 1] : 0u;   // pixels right
        nxt[e] = v | v << 1 | lo >> 31 | v >> 1 | hi << 31;
      }
      __syncthreads();
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
    for (int e = threadIdx.x; e < kRows * S; e += kThreads) {
      const int t = e / S, c = e - t * S + hw;
      acc[e] |= cur[(t + r - a) * P + c] | cur[(t + r + a) * P + c];
    }
  }

  // 4. unpack (each thread its own words of acc)
  for (int e = threadIdx.x; e < kRows * S; e += kThreads) {
    const int t = e / S, c = e - t * S;
    const int y = y0 + t, gw = w0 + c;
    if (y < H && gw < nwords)
      unpack(out + plane + (Idx)y * W, 32 * gw, W, acc[e]);
  }
}

int smem_bytes(int r, int S) {
  const int hw = (r + 31) / 32;
  return (2 * (kRows + 2 * r) * (S + 2 * hw) + kRows * S) * 4;
}

template <typename Idx>
cudaError_t launch(const uint8_t* in, uint8_t* out, long long M, int H, int W,
                   int r, const Chords& ch, cudaStream_t s) {
  const int nwords = (W + 31) / 32;
  int S = nwords < kMaxStrip ? nwords : kMaxStrip;
  while (S > 1 && smem_bytes(r, S) > kStaticSmem) S = (S + 1) / 2;
  const int nstrips = (nwords + S - 1) / S;
  S = (nwords + nstrips - 1) / nstrips;
  const int nbands = (H + kRows - 1) / kRows;
  const long long blocks = M * nbands * nstrips;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  dilate_kernel<Idx><<<(unsigned)blocks, kThreads, smem_bytes(r, S), s>>>(
      in, out, H, W, nwords, S, nstrips, nbands, r, (r + 31) / 32, ch);
  return cudaGetLastError();
}

}  // namespace

// in, out (M, H, W) uint8 (0 = false); chords (host) the 2r + 1 int32
// half-widths w(dy) for dy = -r .. r, 1 <= r <= 36.
extern "C" int p3d_dilate(const void* in, void* out, long long M, int H, int W,
                          const void* chords, int r, void* stream) {
  if (r < 1 || r > kMaxRadius) return (int)cudaErrorInvalidValue;
  if (M == 0 || H == 0 || W == 0) return 0;
  Chords ch = {};
  const int* w = (const int*)chords;
  for (int i = 0; i <= 2 * r; ++i) ch.w[i] = w[i];
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* src = (const uint8_t*)in;
  uint8_t* dst = (uint8_t*)out;
  if (M * H * (long long)W < (1ll << 31))
    return (int)launch<int>(src, dst, M, H, W, r, ch, s);
  return (int)launch<long long>(src, dst, M, H, W, r, ch, s);
}
