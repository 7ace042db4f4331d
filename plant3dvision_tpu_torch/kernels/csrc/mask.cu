// K10 mask filter: vegetation filter + threshold of a stack of images.
//
// Replaces plant3dvision_tpu/ops/masks.py:compute_mask's filter and
// threshold (rescale01 :17, linear_filter :31, excess_green :38; the
// dilation is K8) with the arithmetic of the host function the JAX Masks
// task runs, compute_mask_numpy (ops/masks.py:110-166), so that the masks
// are the JAX task's:
//   - fast lane (uint8, linear, binarised, one positive coefficient c at
//     channel k): img[..., k] > t, t = threshold*255.0/c as numpy computes
//     it (float32 under NEP 50; the wrapper passes it in);
//   - otherwise each channel is rescaled to [0, 1] (uint8 / 255, uint16 /
//     65535 as IEEE divisions; a float image as (x - lo) / max(hi - lo,
//     1e-12) with its own min and max, which the wrapper reduces first),
//     then filtered:
//       linear: numpy's matmul over the first n <= 4 channels, as its BLAS
//       sums them: fma(x2, c2, fma(x1, c1, x0*c0)) for n <= 3, and
//       (x0*c0 + x1*c1) + (x2*c2 + x3*c3) for n = 4;
//       excess_green: s = max((x0 + x1) + x2, 1e-12), then
//       ((2 (x1/s)) - x0/s) - x2/s;
//     and either compared, value > threshold in float32 (binarised, written
//     as bool), or clipped to [0, 1] (written as float32).
//
// What bounds it on the card: bytes. The stack is read once (3 bytes a
// pixel for RGB uint8) and the mask written once (1 byte a pixel): 270 MB
// + 90 MB for 58 images of 1440x1080, 0.108 ms at 3.35 TB/s. A pixel costs
// at most ~12 f32 operations. A one-image call (live carving) is a few us
// of bytes, so there the launch sets the time.
//
// Design: a thread takes a run of 16 consecutive pixels. For gray, RGB and
// RGBA images the run's 16 * C * sizeof(T) bytes (48 for RGB uint8) are a
// whole number of 16-byte vectors, read with uint4 loads on the read-only
// path, and the channels are pulled out of the registers; the run's 16
// mask bytes go out as one 16-byte store (a float32 output as four). A
// warp reads 1.5-2 KB of contiguous bytes a run (RGB / RGBA uint8). The
// uint8 fast lane has one kernel per channel: chosen at run time, the
// channel made the pixel's registers a local-memory array. The other
// lanes keep the arithmetic above, the same __f*_rn operations in the same
// order, so a run gives the bits of 16 one-pixel evaluations. A float
// image's range is looked up once a run; a run that spans two images
// takes each pixel's own. Pixels before the first 16-byte-aligned pixel
// (a view into a stack) and after the last whole run go one at a time in
// the same launch, as do all pixels of an image whose alignment never
// lines up or that has 2 or more than 4 channels. Indexes are 32-bit
// below 2^31 bytes and 64-bit above.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

enum Mode { kFast = 0, kLinear = 1, kExcessGreen = 2 };

constexpr int kRun = 16;      // pixels a thread
constexpr int kThreads = 256;

struct Filter {
  int mode, n, channel, binarize;
  float c[4];
  float threshold;   // float32(threshold): the compare of the float lanes
  float fast_t;      // the fast lane's threshold
  float scale;       // 255 (uint8) or 65535 (uint16); 0 for float images
};

__device__ __forceinline__ float rescale(float v, float scale,
                                         const float* range) {
  if (scale != 0.0f) return __fdiv_rn(v, scale);
  return __fdiv_rn(__fsub_rn(v, range[0]), range[1]);
}

// Mask value of one pixel in the linear or excess-green lane: px holds
// its first K channels (K >= the channels the lane reads). Writes the bit
// of a binarised lane and the clipped value of the others.
template <int K, typename T>
__device__ __forceinline__ void pixel(const T* px, const Filter& f,
                                      const float* range, uint8_t& bit,
                                      float& clip) {
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  const int nc = f.mode == kLinear ? f.n : 3;
#pragma unroll
  for (int i = 0; i < (K < 4 ? K : 4); ++i)
    if (i < nc) x[i] = rescale((float)px[i], f.scale, range);
  float val;
  if (f.mode == kLinear) {
    if (f.n == 4) {
      val = __fadd_rn(__fadd_rn(__fmul_rn(x[0], f.c[0]),
                                __fmul_rn(x[1], f.c[1])),
                      __fadd_rn(__fmul_rn(x[2], f.c[2]),
                                __fmul_rn(x[3], f.c[3])));
    } else {
      val = __fmul_rn(x[0], f.c[0]);
#pragma unroll
      for (int i = 1; i < 3; ++i)
        if (i < f.n) val = __fmaf_rn(x[i], f.c[i], val);
    }
  } else {
    const float s = fmaxf(__fadd_rn(__fadd_rn(x[0], x[1]), x[2]), 1e-12f);
    val = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, __fdiv_rn(x[1], s)),
                              __fdiv_rn(x[0], s)),
                    __fdiv_rn(x[2], s));
  }
  bit = val > f.threshold;
  clip = fminf(fmaxf(val, 0.0f), 1.0f);
}

// Element e of a run held as 16-byte vectors; e is a constant once the
// caller's loops are unrolled, so this folds to a register and a shift.
template <typename T>
__device__ __forceinline__ T elem(const uint4* raw, int e) {
  constexpr int per_word = 4 / sizeof(T);
  const int w = e / per_word;
  const uint4 q = raw[w / 4];
  const uint32_t word = (w & 3) == 0 ? q.x : (w & 3) == 1 ? q.y
                        : (w & 3) == 2 ? q.z : q.w;
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(word);
  } else {
    constexpr int bits = 8 * sizeof(T);
    return (T)(word >> (bits * (e % per_word)));
  }
}

// 16-byte vectors a run of kRun pixels of VC channels of T
template <typename T, int VC>
constexpr int kVecs = kRun * VC * (int)sizeof(T) / 16;

// One run of kRun pixels from pixel p, its bytes in raw. Ch >= 0: the
// fast lane on channel Ch (a constant, so that the channel is a register
// and not an index into a local array); Ch < 0: the lane of f.mode.
template <typename T, int VC, typename I, int Ch>
__device__ __forceinline__ void run(const uint4 (&raw)[kVecs<T, VC>],
                                   void* out, I p, I plane, const Filter& f,
                                   const float* __restrict__ ranges,
                                   bool out_vec) {
  const float* r0 = nullptr;
  const float* r1 = nullptr;
  I split = p + kRun;      // the first pixel that takes r1
  if constexpr (std::is_same<T, float>::value) {
    const I img = p / plane;
    r0 = ranges + 2 * img;
    r1 = r0;
    if ((p + kRun - 1) / plane != img) {
      split = (img + 1) * plane;
      r1 = r0 + 2;
    }
  }
  uint8_t bits[kRun];
  float clips[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if constexpr (Ch >= 0) {
      bits[i] = (float)elem<T>(raw, i * VC + Ch) > f.fast_t;
    } else {
      T px[VC];
#pragma unroll
      for (int c = 0; c < VC; ++c) px[c] = elem<T>(raw, i * VC + c);
      const float* range = r0;
      if constexpr (std::is_same<T, float>::value) {
        if (p + i >= split) range = r1;
        // plane < kRun: the run may span more than two images
        if (plane < kRun) range = ranges + 2 * ((p + i) / plane);
      }
      pixel<VC>(px, f, range, bits[i], clips[i]);
    }
  }

  if (Ch >= 0 || f.binarize) {
    uint8_t* o = (uint8_t*)out + p;
    if (out_vec) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        w[i / 4] |= (uint32_t)bits[i] << (8 * (i % 4));
      *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i) o[i] = bits[i];
    }
  } else {
    float* o = (float*)out + p;
    if (out_vec) {
#pragma unroll
      for (int k = 0; k < kRun / 4; ++k)
        reinterpret_cast<float4*>(o)[k] =
            make_float4(clips[4 * k], clips[4 * k + 1], clips[4 * k + 2],
                        clips[4 * k + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i) o[i] = clips[i];
    }
  }
}

// Items [0, nruns) are runs of pixels head + kRun * j; the items after
// them are the head's pixels and then the tail's, one a thread. VC = 0:
// no runs (2 or more than 4 channels). Ch: as in run.
template <typename T, int VC, typename I, int Ch>
__global__ void __launch_bounds__(kThreads)
mask_kernel(const T* __restrict__ in, void* __restrict__ out, I npix,
            I plane, int C, Filter f, const float* __restrict__ ranges,
            I head, I nruns, bool out_vec) {
  const I j = (I)blockIdx.x * kThreads + threadIdx.x;
  if constexpr (VC > 0) {
    if (j < nruns) {
      const I p = head + kRun * j;
      uint4 raw[kVecs<T, VC>];
      const uint4* src = reinterpret_cast<const uint4*>(in + p * VC);
#pragma unroll
      for (int k = 0; k < kVecs<T, VC>; ++k) raw[k] = __ldg(src + k);
      run<T, VC, I, Ch>(raw, out, p, plane, f, ranges, out_vec);
      return;
    }
  }
  const I s = j - nruns;
  const I body = kRun * nruns;
  const I q = s < head ? s : s + body;
  if (q >= npix) return;
  const T* px = in + q * C;
  const float* range = ranges ? ranges + 2 * (q / plane) : nullptr;
  uint8_t bit;
  float clip = 0.0f;
  if (f.mode == kFast)
    bit = (float)px[f.channel] > f.fast_t;
  else
    pixel<4>(px, f, range, bit, clip);
  if (f.binarize)
    ((uint8_t*)out)[q] = bit;
  else
    ((float*)out)[q] = clip;
}

template <typename T, int VC, typename I, int Ch = -1>
cudaError_t launch_as(const void* in, void* out, long long npix,
                      long long plane, int C, const Filter& f,
                      const float* ranges, long long head, long long nruns,
                      bool out_vec, cudaStream_t s) {
  const long long items = nruns + (npix - kRun * nruns);
  const long long blocks = (items + kThreads - 1) / kThreads;
  mask_kernel<T, VC, I, Ch><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const T*)in, out, (I)npix, (I)plane, C, f, ranges, (I)head, (I)nruns,
      out_vec);
  return cudaGetLastError();
}

// The uint8 fast lane's runs take their channel as a constant (Ch).
template <typename T, int VC, typename I>
cudaError_t launch_ch(const void* in, void* out, long long npix,
                      long long plane, int C, const Filter& f,
                      const float* ranges, long long head, long long nruns,
                      bool out_vec, cudaStream_t s) {
  if constexpr (std::is_same<T, uint8_t>::value && VC > 0) {
    if (f.mode == kFast) {
      switch (f.channel) {
        case 0: return launch_as<T, VC, I, 0>(in, out, npix, plane, C, f,
                                              ranges, head, nruns, out_vec,
                                              s);
        case 1: if constexpr (VC > 1)
            return launch_as<T, VC, I, 1>(in, out, npix, plane, C, f,
                                          ranges, head, nruns, out_vec, s);
          break;
        case 2: if constexpr (VC > 2)
            return launch_as<T, VC, I, 2>(in, out, npix, plane, C, f,
                                          ranges, head, nruns, out_vec, s);
          break;
        case 3: if constexpr (VC > 3)
            return launch_as<T, VC, I, 3>(in, out, npix, plane, C, f,
                                          ranges, head, nruns, out_vec, s);
          break;
      }
      return cudaErrorInvalidValue;
    }
  }
  return launch_as<T, VC, I>(in, out, npix, plane, C, f, ranges, head,
                             nruns, out_vec, s);
}

template <typename T, int VC>
cudaError_t launch_vc(const void* in, void* out, long long npix,
                      long long plane, int C, const Filter& f,
                      const float* ranges, cudaStream_t s) {
  // head: the pixels before the first one at a 16-byte boundary of `in`
  // (all of them when no pixel lies on one)
  const long long pb = (long long)C * sizeof(T);
  const long long osz = f.binarize ? 1 : 4;
  const uintptr_t a = (uintptr_t)in;
  long long head = npix, nruns = 0;
  if (VC > 0) {
    for (long long h = 0; h < kRun && h <= npix; ++h)
      if ((a + h * pb) % 16 == 0) {
        head = h;
        break;
      }
    nruns = (npix - head) / kRun;
  }
  const bool out_vec = ((uintptr_t)out + head * osz) % 16 == 0;
  const long long bytes = npix * (pb > osz ? pb : osz);
  if (bytes < (1ll << 31))
    return launch_ch<T, VC, int>(in, out, npix, plane, C, f, ranges, head,
                                 nruns, out_vec, s);
  return launch_ch<T, VC, long long>(in, out, npix, plane, C, f, ranges,
                                     head, nruns, out_vec, s);
}

template <typename T>
cudaError_t launch(const void* in, void* out, long long npix, long long plane,
                   int C, const Filter& f, const float* ranges,
                   cudaStream_t s) {
  if (npix == 0) return cudaSuccess;
  switch (C) {
    case 1: return launch_vc<T, 1>(in, out, npix, plane, C, f, ranges, s);
    case 3: return launch_vc<T, 3>(in, out, npix, plane, C, f, ranges, s);
    case 4: return launch_vc<T, 4>(in, out, npix, plane, C, f, ranges, s);
    default: return launch_vc<T, 0>(in, out, npix, plane, C, f, ranges, s);
  }
}

}  // namespace

// in (N, H, W, C) contiguous (dtype 0 uint8, 1 uint16, 2 float32); out
// (N, H, W) uint8 0/1 (binarize or the fast lane) or float32; coefs (host)
// n floats; ranges (device) N (lo, max(hi - lo, 1e-12)) float32 pairs for a
// float image, else null.
extern "C" int p3d_mask(const void* in, void* out, int N, int H, int W, int C,
                        int dtype, int mode, const float* coefs, int n,
                        int channel, int binarize, float threshold,
                        float fast_t, const void* ranges, void* stream) {
  if (mode < kFast || mode > kExcessGreen || n < 0 || n > 4 ||
      (mode == kLinear && (n < 1 || n > C)) ||
      (mode == kExcessGreen && C < 3) || channel < 0 || channel >= C ||
      (mode == kFast && dtype != 0) ||
      dtype < 0 || dtype > 2 || (dtype == 2 && ranges == nullptr))
    return (int)cudaErrorInvalidValue;
  Filter f{mode, n, channel, binarize, {0.f, 0.f, 0.f, 0.f}, threshold,
           fast_t, dtype == 0 ? 255.0f : (dtype == 1 ? 65535.0f : 0.0f)};
  for (int i = 0; i < n; ++i) f.c[i] = coefs[i];
  const long long plane = (long long)H * W;
  const long long npix = plane * N;
  const float* r = (const float*)ranges;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch<uint8_t>(in, out, npix, plane, C, f, r, s);
    case 1: return (int)launch<uint16_t>(in, out, npix, plane, C, f, r, s);
    default: return (int)launch<float>(in, out, npix, plane, C, f, r, s);
  }
}
