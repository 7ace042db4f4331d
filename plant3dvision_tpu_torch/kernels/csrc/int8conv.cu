// K16 int8 conv: the dynamic int8 serving lane's convolution, in two entry
// points, each with its own launch count.
//
// Replaces plant3dvision_tpu/models/quant.py:int8_conv_general_dilated (the
// flax `nn.Conv(conv_general_dilated=...)` hook of Segmentation2D's
// conv_mode="int8"): a per-tensor activation scale, a per-output-channel
// weight scale, round and clip to +-127, an int8 x int8 -> int32
// convolution, dequantisation to float32, then flax's bias add.
//
// p3d_int8_quantize (count "int8_quantize"): the absmax of each group as an
// atomicMax on the float bits (every value is >= 0, so the bits order as the
// floats do), then one pass that writes
//   q = clamp(rint(x / (max(absmax, floor) * f32(1/127))), -127, 127)
// as int8 into a zero-padded (G, H + pt + pb, W + pl + pr, Cp) layout, Cp =
// C rounded up to 4. An activation (B, C, H, W) is one group over the
// whole tensor with the conv's SAME pads (floor 1e-8); a weight (K, Cin, kh,
// kw) is K groups without pads (floor 1e-12): (K, kh, kw, Cp).
//
// p3d_int8_conv (count "int8_conv"): a direct convolution of the padded
// int8 activation with the int8 weights, int32 sums of __dp4a over quads of
// input channels, then
//   y = fma(float(acc), max(wmax[k], 1e-12) * (max(xmax, 1e-8) * c2), bias[k])
// with c2 = f32(1/127^2), into (B, K, OH, OW) float32.
//
// Exactness: what XLA compiles on the CPU (its optimized HLO and x86 code):
// `/ 127.0` becomes a product by f32(1/127); x / sx stays an IEEE division
// (__fdiv_rn); round is half to even (rintf); the dequantisation scale sx *
// sw[k] is reassociated to max_w[k] * (max_x * f32(1/127^2)); inside the
// model flax's bias add is contracted with that product into one fma. The
// int32 sums are exact (|sum| <= 127^2 * kh * kw * Cin < 2^31), so with
// equal quantised inputs the output is bit-equal to the plain version
// (models/quant.py:int8_conv_plain) and to XLA's. -fmad=false keeps every
// other product unfused.
//
// What bounds it on the card: bytes at the nets' widths. A 3x3 conv at 24
// channels does 216 MACs a pixel and channel, ~2.2 int8 operations per byte
// moved (the float32 output dominates), far below the H100's ~590 int8
// tensor-core operations per byte; at TPUSegNet's 256 channels it is ~10x
// more, still bytes-bound. The quantise pass is a pure stream (2 bytes of
// bf16 in, 1 byte out per value, read twice: absmax, then quantise).
//
// Design (simple first; wgmma and int8 tensor cores are later work): one
// thread per output pixel and a tile of KT = 8 output channels, KT int32
// accumulators in registers; the block's KT weight filters are staged in
// shared memory (dynamic, up to 227 KB: kh * kw * Cp * KT bytes, 36 KB at
// Cin 512 and 3x3), read by every thread of the block as broadcasts; the
// activation quads come from global memory through L1 (a pixel's Cp
// channels are contiguous). The absmax never leaves the card: the conv and
// the quantise pass read it from device memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kInv127 = 0.00787401572f;     // f32(1/127)
constexpr float kInv127Sq = 6.20001229e-05f;  // f32(1/127^2)
constexpr int kKT = 8;
constexpr int kMaxSmem = 232448;              // 227 KB a block on sm_90

__device__ __forceinline__ float load_f(const void* p, long long i,
                                        int dtype) {
  if (dtype == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// grid (blocks, G): block b of group g folds a strided part of the group's
// `inner` values into slot (per_group ? g : 0).
__global__ void absmax_kernel(const void* __restrict__ x, int dtype,
                              long long inner, int per_group,
                              unsigned int* __restrict__ maxbits) {
  const int g = blockIdx.y;
  const long long base = (long long)g * inner;
  float m = 0.0f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < inner; i += (long long)gridDim.x * blockDim.x)
    m = fmaxf(m, fabsf(load_f(x, base + i, dtype)));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = (lane < (int)((blockDim.x + 31) >> 5)) ? warp_max[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) atomicMax(maxbits + (per_group ? g : 0), __float_as_uint(m));
  }
}

// one thread per output quad (g, yp, xp, q) of the padded layout; xp
// varies fastest across threads, so the reads of one channel row coalesce
__global__ void quantize_kernel(const void* __restrict__ x, int dtype, int G,
                                int C, int H, int W, int pt, int pl, int Hp,
                                int Wp, int nq, int per_group, float eps,
                                const unsigned int* __restrict__ maxbits,
                                int* __restrict__ out) {
  const long long n = (long long)G * Hp * Wp * nq;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int xp = (int)(idx % Wp);
  long long r = idx / Wp;
  const int q = (int)(r % nq);
  r /= nq;
  const int yp = (int)(r % Hp);
  const int g = (int)(r / Hp);
  const int y = yp - pt, xx = xp - pl;
  int word = 0;
  if (y >= 0 && y < H && xx >= 0 && xx < W) {
    const float s = __fmul_rn(
        fmaxf(__uint_as_float(maxbits[per_group ? g : 0]), eps), kInv127);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * q + j;
      if (c < C) {
        const float v = load_f(x, (((long long)g * C + c) * H + y) * W + xx,
                               dtype);
        const float rq = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
        word |= ((int)rq & 0xff) << (8 * j);
      }
    }
  }
  out[(((long long)g * Hp + yp) * Wp + xp) * nq + q] = word;
}

// one thread per output pixel (b, oy, ox), KT output channels from
// blockIdx.y * KT; the block's filters in dynamic shared memory
template <int KT>
__global__ void conv_kernel(const int* __restrict__ xq,
                            const int* __restrict__ wq,
                            const unsigned int* __restrict__ xmax,
                            const unsigned int* __restrict__ wmax,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int B, int Hp, int Wp,
                            int nq, int K, int kh, int kw, int stride, int OH,
                            int OW, float xfloor, float wfloor) {
  extern __shared__ int ws[];                 // [KT][kh][kw][nq]
  const int taps = kh * kw * nq;
  const int k0 = blockIdx.y * KT;
  for (int i = threadIdx.x; i < KT * taps; i += blockDim.x) {
    const int t = i / taps;
    ws[i] = (k0 + t < K) ? wq[(long long)(k0 + t) * taps + (i - t * taps)]
                         : 0;
  }
  __syncthreads();
  const long long npix = (long long)B * OH * OW;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const int ox = (int)(p % OW);
  const long long r = p / OW;
  const int oy = (int)(r % OH);
  const int b = (int)(r / OH);
  int acc[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) acc[t] = 0;
  for (int ky = 0; ky < kh; ++ky) {
    const int* row = xq + ((long long)b * Hp + (long long)oy * stride + ky) *
                              Wp * nq;
    for (int kx = 0; kx < kw; ++kx) {
      const int* px = row + ((long long)ox * stride + kx) * nq;
      const int* wt = ws + (ky * kw + kx) * nq;
      for (int q = 0; q < nq; ++q) {
        const int xv = px[q];
#pragma unroll
        for (int t = 0; t < KT; ++t) acc[t] = __dp4a(xv, wt[t * taps + q], acc[t]);
      }
    }
  }
  const float sx = __fmul_rn(fmaxf(__uint_as_float(*xmax), xfloor), kInv127Sq);
  const long long plane = (long long)OH * OW;
  float* o = out + (long long)b * K * plane + (long long)oy * OW + ox;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int k = k0 + t;
    if (k < K) {
      const float sc = __fmul_rn(fmaxf(__uint_as_float(wmax[k]), wfloor), sx);
      const float a = __int2float_rn(acc[t]);
      o[k * plane] = bias ? __fmaf_rn(a, sc, bias[k]) : __fmul_rn(a, sc);
    }
  }
}

}  // namespace

// x (G, C, H, W) float32 (dtype 0) or bfloat16 (dtype 1) -> maxbits
// (per_group ? G : 1) float32 absmaxes, out (G, H + pt + pb, W + pl + pr,
// Cp) int8 (Cp a multiple of 4, >= C). Both outputs are written here.
extern "C" int p3d_int8_quantize(const void* x, int dtype, int G, int C,
                                 int H, int W, int pt, int pb, int pl,
                                 int pr, int Cp, int per_group, float eps,
                                 void* maxbits, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if ((dtype != 0 && dtype != 1) || Cp % 4 != 0 || Cp < C || G < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(maxbits, 0,
                                  sizeof(unsigned int) * (per_group ? G : 1),
                                  s);
  if (e != cudaSuccess) return (int)e;
  const long long inner = (long long)C * H * W;
  const int threads = 256;
  long long bx = (inner + threads * 8 - 1) / (threads * 8);
  if (bx > 4096) bx = 4096;
  if (bx < 1) bx = 1;
  absmax_kernel<<<dim3((unsigned)bx, (unsigned)G), threads, 0, s>>>(
      x, dtype, inner, per_group, (unsigned int*)maxbits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int Hp = H + pt + pb, Wp = W + pl + pr, nq = Cp / 4;
  const long long n = (long long)G * Hp * Wp * nq;
  quantize_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      x, dtype, G, C, H, W, pt, pl, Hp, Wp, nq, per_group, eps,
      (const unsigned int*)maxbits, (int*)out);
  return (int)cudaGetLastError();
}

// xq (B, Hp, Wp, Cp) int8 (padded), wq (K, kh, kw, Cp) int8, xmax (1,) and
// wmax (K,) absmaxes, bias (K,) float32 or null -> out (B, K, OH, OW)
// float32.
extern "C" int p3d_int8_conv(const void* xq, const void* wq, const void* xmax,
                             const void* wmax, const void* bias, void* out,
                             int B, int Hp, int Wp, int Cp, int K, int kh,
                             int kw, int stride, int OH, int OW, float xfloor,
                             float wfloor, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (Cp % 4 != 0 || stride < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kKT * kh * kw * Cp;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_kernel<kKT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = 128;
  const long long npix = (long long)B * OH * OW;
  const dim3 grid((unsigned)((npix + threads - 1) / threads),
                  (unsigned)((K + kKT - 1) / kKT));
  conv_kernel<kKT><<<grid, threads, smem, s>>>(
      (const int*)xq, (const int*)wq, (const unsigned int*)xmax,
      (const unsigned int*)wmax, (const float*)bias, (float*)out, B, Hp, Wp,
      Cp / 4, K, kh, kw, stride, OH, OW, xfloor, wfloor);
  return (int)cudaGetLastError();
}
