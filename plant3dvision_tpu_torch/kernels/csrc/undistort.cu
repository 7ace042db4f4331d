// K9 undistort: inverse-map OPENCV lens undistortion of a stack of images.
//
// Replaces plant3dvision_tpu/ops/undistort.py:undistort / undistort_batch
// (with distort_delta and bilinear_sample, ops/undistort.py:24-60): for each
// output pixel (u, v), x = (u - cx)/fx, y = (v - cy)/fy, the forward
// distortion displacement gives the source position px = u + dx*fx,
// py = v + dy*fy in the distorted image, which is sampled bilinearly (corner
// clipped to [0, W-2] x [0, H-2], weights to [0, 1]); a source outside
// [0, W-1] x [0, H-1] gives 0. Integer images are rounded half to even and
// clipped to [0, 255] (uint16 too, as the JAX function does); float32
// images are written as they are.
//
// What bounds it on the card: bytes. The stack is read once and written
// once: 2 x 270 MB for 58 RGB images of 1440x1080, 0.162 ms at 3.35 TB/s.
// The map costs ~40 f32 operations a pixel, once for all the images. A
// thread a pixel walking the images (the first design) lost its time to
// instruction issue: four one-byte global gathers, four u8 -> f32 and one
// f32 -> u8 conversion (a quarter of the f32 rate on sm_90) and 64-bit
// address arithmetic for every output value, and one-byte stores.
//
// Design: a block owns an output tile of kRows rows x TW columns (TW =
// 128, 64 or 32 pixels, so that a tile row is at most 512 bytes; a warp a
// row, a thread TW / 32 consecutive pixels of it) and a group of
// consecutive images. Each thread computes its pixels' source corner,
// weights and `inside` flag once and keeps them in registers for the
// whole group. The block reduces the tile's source bounding box over
// its inside pixels (the taps x0 .. x0 + 1, y0 .. y0 + 1, clamped as
// below); the map is close to the identity, so this window is a little
// larger than the tile. For each image it stages the window's rows in
// shared memory with 16-byte cp.async copies, aligned down to 16 bytes,
// kStages images deep, so that the next images' windows arrive while image
// n is sampled; the taps are read from shared memory with 32-bit offsets
// (uint8 RGB whose rows are a multiple of 16 bytes: a tap row's 6 bytes
// from three 32-bit loads and two funnel shifts, each byte made a float by
// one byte permute and one add), the
// results written into a shared output tile laid out at the global rows'
// 16-byte phase, and the tile's rows are stored with 16-byte stores (bytes
// one at a time only in the partial chunks at a row's ends). A window over
// the shared-memory budget (strong distortion that folds the map) makes
// the block read its taps from global memory instead (the global-load
// lane, same arithmetic, same stores); a tile with no inside pixel writes
// zeros. Bytes become floats and back without the conversion pipe:
//   b -> float: __uint_as_float(0x4B000000 | b) - 2^23 (exact, b < 2^23)
//   v -> byte:  __float_as_uint(min(max(v, 0), 255) + 1.5 * 2^23) & 0xFF
// Adding 1.5 * 2^23 rounds half to even at unit spacing, and clamping
// before rounding gives the same integer as rintf then clamping, for every
// float32 v (NaN, +-inf and -0 give 0, 255 and 0, as fmaxf/fminf give).
// Global addresses are 64-bit a row or a copy chunk, never a value, so
// stacks of more than 2^31 bytes need no other path.
//
// Exactness: the f32 operations of the JAX function as XLA compiles it on
// the CPU, fused multiply-adds exactly where XLA contracts them (the
// library is built with -fmad=false, so nvcc adds none of its own):
//   r2 = fma(x, x, y*y), rm = r2 * fma(r2, fma(r2, k3, k2), k1)
//   dx = fma(p2, fma(2x, x, r2), fma((2 p1) x, y, x*rm))
//   dy = fma((2 p2) x, y, fma(p1, r2 + (2y)*y, y*rm))
//   px = fma(dx, fx, u), py = fma(dy, fy, v)
//   lerp(a, b, w) = fma(a, 1 - w, b*w); for one channel (a 2-D (H, W)
//   image or an (H, W, 1) one, of any type) the row lerps are
//   fma(b, w, a*(1 - w)) (XLA fuses them the other way there)
// (tests/test_torch_frontend.py holds the plain version bit-equal to JAX;
// tests/test_torch_undistort_tiles.py the windows and conversions).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Camera {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3;
};

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;           // a tile's rows: a warp each
constexpr int kMaxPix = 4;                     // pixels a thread (TW 128)
constexpr int kWaves = 4;         // image groups: blocks for 4 waves
constexpr int kStages = 3;        // images whose windows are in flight
constexpr int kMinBlocks = 4;     // blocks an SM the registers leave room for

__device__ __forceinline__ float lerp_a(float a, float b, float w, float w1) {
  return __fmaf_rn(a, w1, __fmul_rn(b, w));
}

__device__ __forceinline__ float lerp_b(float a, float b, float w, float w1) {
  return __fmaf_rn(b, w, __fmul_rn(a, w1));
}

__device__ __forceinline__ float byte_to_float(unsigned b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f);
}

// the low byte of the result is the byte; the upper bits are 0x4B40xx
__device__ __forceinline__ unsigned float_to_byte_bits(float v) {
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(v, 0.0f), 255.0f), 12582912.0f));
}

template <typename T>
struct Pixel;

template <>
struct Pixel<uint8_t> {
  __device__ static float load(const uint8_t* p) { return byte_to_float(*p); }
  __device__ static void store(uint8_t* p, float v) {
    *p = (uint8_t)(float_to_byte_bits(v) & 0xFFu);
  }
};

template <>
struct Pixel<uint16_t> {
  __device__ static float load(const uint16_t* p) {
    return byte_to_float(*p);
  }
  __device__ static void store(uint16_t* p, float v) {
    *p = (uint16_t)(float_to_byte_bits(v) & 0xFFu);
  }
};

template <>
struct Pixel<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned phase16(const void* p) {
  return (unsigned)((uintptr_t)p & 15u);
}

// The window's rows into `win` (a row every `pitch` bytes, each at its
// global row's 16-byte phase): row r's needed bytes start at g0 + r *
// rowbytes and are `wb` long; only the aligned chunks that hold one of them
// are read.
__device__ __forceinline__ void stage_window(unsigned char* win,
                                             const unsigned char* g0,
                                             long long rowbytes, int rows,
                                             int wb, int chunks, int pitch) {
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks;
    const int k = e - r * chunks;
    const unsigned char* g = g0 + r * rowbytes;
    const unsigned ph = phase16(g);
    if (k * 16 < (int)ph + wb)
      cp_async16(win + r * pitch + k * 16, g - ph + k * 16);
  }
}

// A tap row of a uint8 RGB pixel pair, the 6 bytes at win + a, as floats:
// three 32-bit shared loads, two funnel shifts, a byte permute and an add
// a byte (the permute builds 0x4B0000bb).
__device__ __forceinline__ void rgb8_pair(const unsigned char* win, int a,
                                          float* f) {
  const unsigned* w = (const unsigned*)(win + (a & ~3));
  const unsigned sh = (unsigned)(a & 3) * 8u;
  const unsigned w0 = w[0], w1 = w[1], w2 = w[2];
  const unsigned lo = __funnelshift_r(w0, w1, sh);
  const unsigned hi = __funnelshift_r(w1, w2, sh);
  f[0] = __fsub_rn(__uint_as_float(__byte_perm(lo, 0x4B00u, 0x5440)),
                   8388608.0f);
  f[1] = __fsub_rn(__uint_as_float(__byte_perm(lo, 0x4B00u, 0x5441)),
                   8388608.0f);
  f[2] = __fsub_rn(__uint_as_float(__byte_perm(lo, 0x4B00u, 0x5442)),
                   8388608.0f);
  f[3] = __fsub_rn(__uint_as_float(__byte_perm(lo, 0x4B00u, 0x5443)),
                   8388608.0f);
  f[4] = __fsub_rn(__uint_as_float(__byte_perm(hi, 0x4B00u, 0x5440)),
                   8388608.0f);
  f[5] = __fsub_rn(__uint_as_float(__byte_perm(hi, 0x4B00u, 0x5441)),
                   8388608.0f);
}

// The uint8 RGB lane of a staged tile whose rows all lie at the window's
// 16-byte phase iph0 (rowbytes % 16 == 0, as for 1440 RGB pixels), so that
// a tap's offset is one add: a thread's 4 pixels, their 12 output bytes
// into the shared tile; tap[k] is pixel k's tap (x0, y0) in the window
// without the phase. Rows at other phases take the generic lane, which is
// as fast as this lane would be at each row's own phase.
__device__ __forceinline__ void sample_rgb8(
    const unsigned char* win, unsigned char* o, const int* tap,
    const float* wx, const float* wy, unsigned in, int pitch,
    unsigned iph0) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v[3] = {0.0f, 0.0f, 0.0f};
    if (in >> k & 1u) {
      const int a0 = tap[k] + (int)iph0;
      float t0[6], t1[6];
      rgb8_pair(win, a0, t0);
      rgb8_pair(win, a0 + pitch, t1);
      const float gx = wx[k], gy = wy[k];
      const float gx1 = __fsub_rn(1.0f, gx), gy1 = __fsub_rn(1.0f, gy);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float top = lerp_a(t0[ch], t0[3 + ch], gx, gx1);
        const float bot = lerp_a(t1[ch], t1[3 + ch], gx, gx1);
        v[ch] = lerp_a(top, bot, gy, gy1);
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      o[3 * k + ch] = (unsigned char)(float_to_byte_bits(v[ch]) & 0xFFu);
  }
}

// One image of the tile, any type and channel count: each thread's pixels
// into the shared output tile (a row every `opitch` bytes, at the output
// rows' phase). STAGED reads the taps from the staged window `win`, else
// from the image in global memory.
template <typename T, int CT, bool GRAY, bool STAGED>
__device__ __forceinline__ void sample_image(
    const unsigned char* win, const T* __restrict__ img, unsigned char* o,
    const int* px0, const int* py0, const float* wx, const float* wy,
    unsigned live, unsigned in, int C, int W, int pitch, unsigned iph0,
    unsigned irb15) {
  const int cc = CT > 0 ? CT : C;        // a constant but in the C lane
  const int pb = cc * (int)sizeof(T);
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    if (!(live >> k & 1u)) continue;
    T* ok = (T*)(o + k * pb);
    if (!(in >> k & 1u)) {
      for (int ch = 0; ch < cc; ++ch) Pixel<T>::store(ok + ch, 0.0f);
      continue;
    }
    const T* t0;
    const T* t1;
    if (STAGED) {               // px0: the tap in the window, py0: its row
      t0 = (const T*)(win + px0[k] + ((iph0 + py0[k] * irb15) & 15u));
      t1 = (const T*)(win + px0[k] + pitch +
                      ((iph0 + (py0[k] + 1) * irb15) & 15u));
    } else {
      t0 = img + ((long long)py0[k] * W + px0[k]) * cc;
      t1 = t0 + (long long)W * cc;
    }
    const float gx = wx[k], gy = wy[k];
    const float gx1 = __fsub_rn(1.0f, gx), gy1 = __fsub_rn(1.0f, gy);
#pragma unroll
    for (int ch = 0; ch < cc; ++ch) {
      const float i00 = Pixel<T>::load(t0 + ch);
      const float i01 = Pixel<T>::load(t0 + cc + ch);
      const float i10 = Pixel<T>::load(t1 + ch);
      const float i11 = Pixel<T>::load(t1 + cc + ch);
      const float top = GRAY ? lerp_b(i00, i01, gx, gx1)
                             : lerp_a(i00, i01, gx, gx1);
      const float bot = GRAY ? lerp_b(i10, i11, gx, gx1)
                             : lerp_a(i10, i11, gx, gx1);
      Pixel<T>::store(ok + ch, lerp_a(top, bot, gy, gy1));
    }
  }
}

// The shared output tile's rows to global memory: a row's `segb` bytes
// start at ob0 + r * rowbytes; whole 16-byte chunks with one store, the
// partial chunks at the ends a byte at a time.
__device__ __forceinline__ void store_tile(unsigned char* ob0,
                                           long long rowbytes, int rows,
                                           int segb,
                                           const unsigned char* out_s,
                                           int opitch) {
  const int chunks = (15 + segb + 15) >> 4;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks;
    const int k = e - r * chunks;
    unsigned char* g = ob0 + r * rowbytes;
    const int ph = (int)phase16(g);
    const int lo = k * 16, end = ph + segb;
    if (lo >= end) continue;
    unsigned char* ga = g - ph;
    const unsigned char* s = out_s + r * opitch;
    if (lo >= ph && lo + 16 <= end) {
      *(uint4*)(ga + lo) = *(const uint4*)(s + lo);
    } else {
      for (int b = max(lo, ph); b < min(lo + 16, end); ++b) ga[b] = s[b];
    }
  }
}

// Block blockIdx.x: tile blockIdx.x % tiles (tiles_x across), images
// [g per_block, (g + 1) per_block) of group g = blockIdx.x / tiles. The
// dynamic shared memory holds kStages windows of win_budget bytes and the
// output tile. lanes (optional): tiles that staged, read
// from global memory, had no inside pixel (counted by the blocks of image
// group 0).
template <typename T, int CT, bool GRAY>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    undistort_kernel(const T* __restrict__ in, T* __restrict__ out, int N,
                     int H, int W, int C, int lgtw, int tiles_x, int tiles,
                     int per_block, int win_budget, Camera cam,
                     int* __restrict__ lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_box[4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = (int)(blockIdx.x % (unsigned)tiles);
  const int n0 = (int)(blockIdx.x / (unsigned)tiles) * per_block;
  const int n1 = min(N, n0 + per_block);
  const int u0 = (tile % tiles_x) << lgtw;
  const int v0 = (tile / tiles_x) * kRows;
  const int TW = 1 << lgtw;
  const int ppt = TW >> 5;                  // pixels a thread: 4, 2 or 1
  const int pb = C * (int)sizeof(T);
  const int v = v0 + warp;                  // this thread's row

  // the pixels' source corners and weights, once for the group
  int px0[kMaxPix], py0[kMaxPix];
  float wx[kMaxPix], wy[kMaxPix];
  unsigned live = 0u, in_mask = 0u;
  int bx0 = INT_MAX, bx1 = -1, by0 = INT_MAX, by1 = -1;
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    const int u = u0 + lane * ppt + k;
    px0[k] = py0[k] = 0;
    wx[k] = wy[k] = 0.0f;
    if (k >= ppt || u >= W || v >= H) continue;
    live |= 1u << k;
    const float uf = (float)u;
    const float vf = (float)v;
    const float x = __fdiv_rn(__fsub_rn(uf, cam.cx), cam.fx);
    const float y = __fdiv_rn(__fsub_rn(vf, cam.cy), cam.fy);
    const float r2 = __fmaf_rn(x, x, __fmul_rn(y, y));
    const float rm = __fmul_rn(
        r2, __fmaf_rn(r2, __fmaf_rn(r2, cam.k3, cam.k2), cam.k1));
    const float dx = __fmaf_rn(
        cam.p2, __fmaf_rn(__fmul_rn(2.0f, x), x, r2),
        __fmaf_rn(__fmul_rn(__fmul_rn(2.0f, cam.p1), x), y,
                  __fmul_rn(x, rm)));
    const float dy = __fmaf_rn(
        __fmul_rn(__fmul_rn(2.0f, cam.p2), x), y,
        __fmaf_rn(cam.p1, __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, y), y)),
                  __fmul_rn(y, rm)));
    const float px = __fmaf_rn(dx, cam.fx, uf);
    const float py = __fmaf_rn(dy, cam.fy, vf);
    const bool inside = px >= 0.0f && px <= (float)(W - 1) && py >= 0.0f &&
                        py <= (float)(H - 1);
    // fmaxf maps a NaN to 0: such a pixel is outside, and the taps stay in
    // the frame
    const float x0 = fminf(fmaxf(floorf(px), 0.0f), (float)(W - 2));
    const float y0 = fminf(fmaxf(floorf(py), 0.0f), (float)(H - 2));
    wx[k] = fminf(fmaxf(__fsub_rn(px, x0), 0.0f), 1.0f);
    wy[k] = fminf(fmaxf(__fsub_rn(py, y0), 0.0f), 1.0f);
    px0[k] = (int)x0;
    py0[k] = (int)y0;
    if (inside) {
      in_mask |= 1u << k;
      bx0 = min(bx0, px0[k]);
      bx1 = max(bx1, px0[k]);
      by0 = min(by0, py0[k]);
      by1 = max(by1, py0[k]);
    }
  }

  // the tile's source window: the taps of its inside pixels
  if (tid == 0) {
    s_box[0] = INT_MAX;
    s_box[1] = -1;
    s_box[2] = INT_MAX;
    s_box[3] = -1;
  }
  __syncthreads();
  bx0 = __reduce_min_sync(0xffffffffu, bx0);
  bx1 = __reduce_max_sync(0xffffffffu, bx1);
  by0 = __reduce_min_sync(0xffffffffu, by0);
  by1 = __reduce_max_sync(0xffffffffu, by1);
  if (lane == 0) {
    atomicMin(&s_box[0], bx0);
    atomicMax(&s_box[1], bx1);
    atomicMin(&s_box[2], by0);
    atomicMax(&s_box[3], by1);
  }
  __syncthreads();
  const bool any = s_box[1] >= 0;
  const int xlo = s_box[0], ylo = s_box[2];
  const int wrows = any ? s_box[3] + 2 - ylo : 0;      // rows ylo .. y0max+1
  const int wb = any ? (s_box[1] + 2 - xlo) * pb : 0;  // bytes a row
  const int wchunks = (15 + wb + 15) >> 4;
  const int pitch = wchunks * 16;
  const bool staged = any && (long long)wrows * pitch <= win_budget;
  if (lanes != nullptr && tid == 0 && n0 == 0)
    atomicAdd(lanes + (staged ? 0 : any ? 1 : 2), 1);
  if (staged) {
    // a staged tile's taps as offsets in the window (px0) and window rows
    // (py0), once for the group
#pragma unroll
    for (int k = 0; k < kMaxPix; ++k) {
      py0[k] -= ylo;
      px0[k] = py0[k] * pitch + (px0[k] - xlo) * pb;
    }
  }

  unsigned char* out_s = smem + kStages * win_budget;
  const int opitch = (TW * pb) + 16;
  const long long rowbytes = (long long)W * pb;
  const long long imgbytes = rowbytes * H;
  const unsigned rb15 = (unsigned)(rowbytes & 15);
  const int rows = min(kRows, H - v0);
  const int segb = min(TW, W - u0) * pb;
  const unsigned char* in_b = (const unsigned char*)in;
  unsigned char* out_b = (unsigned char*)out;
  // the first needed byte of the window's row 0, and of the tile's row 0
  const long long win0 = ((long long)ylo * W + xlo) * pb;
  const long long tile0 = ((long long)v0 * W + u0) * pb;
  const bool rgb8 = sizeof(T) == 1 && CT == 3 && ppt == 4;

  // kStages - 1 images' windows in flight before the first is sampled
  if (staged) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (n0 + s < n1)
        stage_window(smem + s * win_budget, in_b + (n0 + s) * imgbytes + win0,
                     rowbytes, wrows, wb, wchunks, pitch);
      cp_async_commit();
    }
  }
  for (int n = n0; n < n1; ++n) {
    const int slot = (n - n0) % kStages;
    const unsigned char* win = smem + slot * win_budget;
    if (staged) {
      // image n + kStages - 1 into the slot image n - 1 left (every
      // thread is past its sampling)
      const int m = n + kStages - 1;
      if (m < n1)
        stage_window(smem + ((m - n0) % kStages) * win_budget,
                     in_b + m * imgbytes + win0, rowbytes, wrows, wb,
                     wchunks, pitch);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
    }
    const unsigned iph0 = phase16(in_b + n * imgbytes + win0);
    unsigned char* ob0 = out_b + n * imgbytes + tile0;
    unsigned char* o = out_s + warp * opitch +
                       ((phase16(ob0) + warp * rb15) & 15u) +
                       lane * ppt * pb;
    if (staged && rgb8 && rb15 == 0)
      sample_rgb8(win, o, px0, wx, wy, in_mask, pitch, iph0);
    else if (staged)
      sample_image<T, CT, GRAY, true>(win, nullptr, o, px0, py0, wx, wy,
                                      live, in_mask, C, W, pitch, iph0, rb15);
    else
      sample_image<T, CT, GRAY, false>(
          nullptr, (const T*)(in_b + n * imgbytes), o, px0, py0, wx, wy,
          live, in_mask, C, W, pitch, iph0, rb15);
    __syncthreads();
    store_tile(ob0, rowbytes, rows, segb, out_s, opitch);
    if (!staged) __syncthreads();
  }
}

template <typename T, int CT, bool GRAY>
cudaError_t launch(const void* in, void* out, int N, int H, int W, int C,
                   Camera cam, int* lanes, cudaStream_t s) {
  const int pb = C * (int)sizeof(T);
  const int lgtw = pb <= 4 ? 7 : pb <= 8 ? 6 : 5;
  const int TW = 1 << lgtw;
  const long long tiles_x = (W + TW - 1) / TW;
  const long long tiles = tiles_x * ((H + kRows - 1) / kRows);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // a window may take three times the tile's bytes (the map stretches it
  // little), at most 48 KB
  const int tile_bytes = TW * kRows * pb;
  const int win_budget =
      (std::min(std::max(3 * tile_bytes, 2048), 48 << 10) + 15) & ~15;
  const size_t smem =
      (size_t)kStages * win_budget + (size_t)kRows * (TW * pb + 16);
  void (*kernel)(const T*, T*, int, int, int, int, int, int, int, int, int,
                 Camera, int*) = undistort_kernel<T, CT, GRAY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  // image groups: enough blocks for kWaves waves of the card
  const long long want = (long long)kWaves * sms * std::max(per_sm, 1);
  long long groups = (want + tiles - 1) / tiles;
  groups = std::max(1LL, std::min((long long)N, groups));
  const int per_block = (int)((N + groups - 1) / groups);
  groups = (N + per_block - 1) / per_block;
  if (tiles * groups > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)(tiles * groups), kThreads, smem, s>>>(
      (const T*)in, (T*)out, N, H, W, C, lgtw, (int)tiles_x, (int)tiles,
      per_block, win_budget, cam, lanes);
  return cudaGetLastError();
}

// one channel takes the 2-D image's row lerps (GRAY), as XLA fuses them
template <typename T>
cudaError_t launch_type(const void* in, void* out, int N, int H, int W,
                        int C, Camera cam, int* lanes, cudaStream_t s) {
  switch (C) {
    case 1: return launch<T, 1, true>(in, out, N, H, W, 1, cam, lanes, s);
    case 3: return launch<T, 3, false>(in, out, N, H, W, 3, cam, lanes, s);
    case 4: return launch<T, 4, false>(in, out, N, H, W, 4, cam, lanes, s);
    default: return launch<T, 0, false>(in, out, N, H, W, C, cam, lanes, s);
  }
}

}  // namespace

// in, out (N, H, W, C) contiguous, of one type (dtype 0 uint8, 1 uint16,
// 2 float32); C = 1 for 2-D images; C * the type's bytes <= 256. lanes: null, or 3 int32 on the card that
// the launch adds its blocks to: staged, global-load lane, no inside pixel.
extern "C" int p3d_undistort(const void* in, void* out, int N, int H, int W,
                             int C, int dtype, float fx,
                             float fy, float cx, float cy, float k1,
                             float k2, float p1, float p2, float k3,
                             void* lanes, void* stream) {
  if ((long long)H * W == 0 || N == 0) return (int)cudaSuccess;
  const Camera cam{fx, fy, cx, cy, k1, k2, p1, p2, k3};
  const cudaStream_t s = (cudaStream_t)stream;
  int* l = (int*)lanes;
  switch (dtype) {
    case 0:
      return (int)launch_type<uint8_t>(in, out, N, H, W, C, cam, l, s);
    case 1:
      return (int)launch_type<uint16_t>(in, out, N, H, W, C, cam, l, s);
    case 2:
      return (int)launch_type<float>(in, out, N, H, W, C, cam, l, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
