// K16 int8 conv: the dynamic int8 serving lane's convolution, in three
// entry points, each with its own launch count.
//
// Replaces plant3dvision_tpu/models/quant.py:int8_conv_general_dilated (the
// flax `nn.Conv(conv_general_dilated=...)` hook of Segmentation2D's
// conv_mode="int8"): a per-tensor activation scale, a per-output-channel
// weight scale, round and clip to +-127, an int8 x int8 -> int32
// convolution, dequantisation to float32, then flax's bias add.
//
// p3d_int8_quantize_weights (count "int8_quantize"): every compute weight
// of a model in one launch (models/quant.py:quantize_weights, once per
// `segmentation_inference` call, models/quant.py:int8_lane). A table of up
// to kMaxWeights descriptors, a kernel parameter, names each weight (K,
// Cin, kh, kw) and its places in one output arena; a block takes one row
// (weight, output channel k): the row's absmax in registers and warp
// shuffles (no atomics), then
//   q = clamp(rint(w / (max(absmax, 1e-12) * f32(1/127))), -127, 127)
// written in the conv's packed layout (K_pad / NT, nch, NT, DC), the only
// copy the conv reads (models/quant.py:pack_weight), zeros in every pad;
// the packed layout's rows past K are blocks of their own that write
// zeros. What bounds it: the host (a launch, the table); the bytes are a
// few MB.
//
// p3d_int8_absmax (count "int8_absmax"): the activation's per-tensor
// absmax, read by the conv from device memory.
//
// p3d_int8_conv (count "int8_conv"): an implicit GEMM on the int8 tensor
// cores (mma.sync m16n8k32 s8 x s8 -> s32) that reads the bf16 or float32
// activation (B, Cin, H, W) itself and quantises it while it stages it:
//   q = clamp(rint(x / (max(xmax, 1e-8) * f32(1/127))), -127, 127)
// (the conv's SAME pads become zeros there), then
//   y = fma(float(acc), max(wmax[k], 1e-12) * (max(xmax, 1e-8) * c2), bias[k])
// with c2 = f32(1/127^2), into (B, K, OH, OW) float32. No quantised copy of
// the activation is written to device memory.
//
// Exactness: what XLA compiles on the CPU (its optimized HLO and x86 code):
// `/ 127.0` becomes a product by f32(1/127); x / sx stays an IEEE division
// (__fdiv_rn); round is half to even (rintf); the dequantisation scale sx *
// sw[k] is reassociated to max_w[k] * (max_x * f32(1/127^2)); inside the
// model flax's bias add is contracted with that product into one fma. The
// int32 sums are exact in any order (|sum| <= 127^2 * kh * kw * Cin < 2^31),
// so the output is bit-equal to the plain version
// (models/quant.py:int8_conv_plain) and to XLA's. -fmad=false keeps every
// other product unfused.
//
// What bounds it on the card: bytes at the nets' widths. A 3x3 conv at 24
// channels does 216 MACs a pixel and channel, ~2.2 int8 operations per byte
// moved (the float32 output dominates), far below the H100's ~590 int8
// tensor-core operations per byte; at TPUSegNet's 256 channels it is ~10x
// more, still bytes-bound. The function's least bytes: the activation read
// once, the weights, the float32 output written once (the absmax reads the
// activation before the conv can start, so it is read twice).
//
// Design. The GEMM is M = B*OH*OW output pixels, N = K output channels,
// depth = kh*kw*Cp. A block of 4 warps owns a tile of TM output pixels (TR
// rows x TC columns, TC >= 32) and NT output channels (all of K for K <=
// 256): five tile configurations, NT = 16, 32, 64, 128, 256 (warps side by
// side along M, or 2 x 2 for NT >= 128), chosen by the wrapper
// (models/quant.py:conv_plan). The depth is cut into chunks of CC <= 64
// input channels x all kh*kw taps (the chunk's depth DC = kh*kw*CC rounded
// up to 32, the fragment's depth); the weights are packed once, by the
// wrapper, as (K/NT, chunks, NT, DC) int8 with zeros in every pad, so each
// chunk's NT x DC slice is one contiguous copy. As many blocks as fit on
// the card each walk their share of the tiles, one step a tile and chunk:
// - the step's SR = (TR - 1) * stride + kh input rows under the tile, CC
//   channels, TW columns with the halo, are copied raw (bf16 or float32,
//   16-byte cp.async where rows are 16-byte aligned) into shared memory,
//   and with several chunks the step's weight slice too (one of two
//   buffers). The next step's copies are issued as soon as this step's
//   rows are quantised, so they arrive while this step multiplies and
//   stores; with one chunk the weights are copied once per block;
// - the raw rows are quantised in shared memory into (SR, TW, CS) int8
//   words of 4 channels (CS >= CC pads the pixel stride so that a
//   fragment's 8 rows spread over the banks), zeros off the image and past
//   C (the SAME pads), without a division (quantize_r);
// - the kh*kw shifted operands are never formed: each A word (4 channels
//   of one tap) is read from the staged rows at the pixel's offset plus a
//   per-depth-word offset (tap row, tap column, channel) from a table
//   built once per block. Each warp holds MF x NF accumulator fragments of
//   16 x 8 int32 in registers; the epilogue dequantises them with the
//   block's scales and biases (staged once) and writes 8 consecutive
//   output pixels of one channel per store (whole 32-byte sectors).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kInv127 = 0.00787401572f;     // f32(1/127)
constexpr float kInv127Sq = 6.20001229e-05f;  // f32(1/127^2)
constexpr int kThreads = 128;                 // 4 warps a conv block
constexpr int kMaxSmem = 232448;              // 227 KB a block on sm_90

__device__ __forceinline__ float load_f(const void* p, long long i,
                                        int dtype) {
  if (dtype == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ int quantize4(const float v[4], float s) {
  int word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float rq = fminf(fmaxf(rintf(__fdiv_rn(v[j], s)), -127.0f), 127.0f);
    word |= ((int)rq & 0xff) << (8 * j);
  }
  return word;
}

// The same quantisation without a division, for the conv's staging: q1 is
// x / s correctly rounded (Markstein: r = RN(1/s), q0 = RN(x r), then
// RN(q0 + RN(x - s q0) r) with exact fused residuals is RN(x / s) in binary
// floating point), and adding 1.5 * 2^23 rounds it half to even into the
// low bits. It needs |x / s| < 2^22: the activation's absmax sets s, so
// |x / s| <= 127 (1 + 2^-23) for every finite x, and a non-finite s takes
// quantize4. A NaN quotient clamps to -127 as fminf(fmaxf(NaN, -127), 127)
// does. tests/test_torch_quant.py holds the emulated arithmetic to the
// division at every bf16 value and adversarial float32 ones.
__device__ __forceinline__ int quantize_r(float v, float s, float r) {
  const float q0 = __fmul_rn(v, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, v), r, q0);
  const int k = __float_as_int(__fadd_rn(q1, 12582912.0f)) - 0x4B400000;
  return q1 != q1 ? -127 : max(-127, min(127, k));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* c, int a0, int a1, int a2, int a3,
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid (blocks, G): block b of group g folds a strided part of the group's
// `inner` values into slot (per_group ? g : 0); 16 bytes a load where the
// group starts 16-byte aligned and holds whole 16-byte runs.
__global__ void absmax_kernel(const void* __restrict__ x, int dtype,
                              long long inner, int per_group,
                              unsigned int* __restrict__ maxbits) {
  const int g = blockIdx.y;
  const long long base = (long long)g * inner;
  const int esz = dtype == 1 ? 2 : 4, per16 = 16 / esz;
  const char* start = static_cast<const char*>(x) + base * esz;
  float m = 0.0f;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (reinterpret_cast<uintptr_t>(start) % 16 == 0 && inner % per16 == 0) {
    const int4* v = reinterpret_cast<const int4*>(start);
    for (; i < inner / per16; i += stride) {
      const int4 q = __ldg(v + i);
      const unsigned w[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z,
                             (unsigned)q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (dtype == 1) {
          m = fmaxf(m, fabsf(__uint_as_float(w[k] << 16)));
          m = fmaxf(m, fabsf(__uint_as_float(w[k] & 0xffff0000u)));
        } else {
          m = fmaxf(m, fabsf(__uint_as_float(w[k])));
        }
      }
    }
  } else {
    for (; i < inner; i += stride)
      m = fmaxf(m, fabsf(load_f(x, base + i, dtype)));
  }
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

cudaError_t launch_absmax(const void* x, int dtype, int G, long long inner,
                          int per_group, void* maxbits, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(
      maxbits, 0, sizeof(unsigned int) * (per_group ? G : 1), s);
  if (e != cudaSuccess) return e;
  const int threads = 256;
  long long bx = (inner + threads * 32 - 1) / (threads * 32);
  if (bx > 8192) bx = 8192;
  if (bx < 1) bx = 1;
  absmax_kernel<<<dim3((unsigned)bx, (unsigned)G), threads, 0, s>>>(
      x, dtype, inner, per_group, (unsigned int*)maxbits);
  return cudaGetLastError();
}

constexpr int kMaxWeights = 48;   // descriptors a launch (4 KB of parameters)
constexpr int kQThreads = 128;

struct WeightDesc {
  const void* w;                     // (K, C, kh, kw) bf16 or f32
  long long p_off, a_off;            // arena bytes: packed, amax
  int row0;                          // the weight's first row (block)
  int dtype, K, C, taps, NT, CC, nch, DC;
};

struct WeightTable {
  WeightDesc d[kMaxWeights];
  int n;
};

__global__ void __launch_bounds__(kQThreads)
quantize_weights_kernel(const __grid_constant__ WeightTable tab,
                        char* __restrict__ arena, float eps) {
  int i = 0;
  while (i + 1 < tab.n && tab.d[i + 1].row0 <= (int)blockIdx.x) ++i;
  const WeightDesc& d = tab.d[i];
  const int k = (int)blockIdx.x - d.row0;
  const bool real = k < d.K;
  const long long inner = (long long)d.C * d.taps;
  const long long base = (long long)k * inner;
  float m = 0.0f;
  if (real)
    for (long long e = threadIdx.x; e < inner; e += kQThreads)
      m = fmaxf(m, fabsf(load_f(d.w, base + e, d.dtype)));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kQThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
  if (real && threadIdx.x == 0)
    reinterpret_cast<float*>(arena + d.a_off)[k] = m;
  const float s = __fmul_rn(fmaxf(m, eps), kInv127);

  // four channels c0 .. c0 + 3 of tap t, zeros past C
  auto quad = [&](int t, int c0) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = c0 + j < d.C
                 ? load_f(d.w, base + (long long)(c0 + j) * d.taps + t,
                          d.dtype)
                 : 0.0f;
    return quantize4(v, s);
  };
  // the packed row: block k / NT, lane k % NT, depth tap * CC + channel
  const int nb = k / d.NT, dq = d.DC / 4;
  int* p = reinterpret_cast<int*>(arena + d.p_off);
  for (int e = threadIdx.x; e < d.nch * dq; e += kQThreads) {
    const int ch = e / dq, d4 = 4 * (e - ch * dq);
    int word = 0;
    if (real && d4 < d.taps * d.CC) {
      const int t = d4 / d.CC;
      word = quad(t, ch * d.CC + d4 - t * d.CC);
    }
    p[(((long long)nb * d.nch + ch) * d.NT + k - nb * d.NT) * dq + d4 / 4] =
        word;
  }
}

struct ConvArgs {
  const void* x;             // (B, C, H, W) bf16 or f32
  const int4* wp;            // packed int8 weights (K/NT, nch, NT, DC)
  const unsigned int* xmax;  // (1,) activation absmax bits
  const unsigned int* wmax;  // (K,) weight absmax bits
  const float* bias;         // (K,) or null
  float* out;                // (B, K, OH, OW) f32
  int dtype, B, C, H, W, K, kh, kw, stride, pt, pl, OH, OW;
  int CC, nch, DC;
  // the pixel tile: TR output rows x TC output columns; SR staged input
  // rows of TW pixels at a stride of CS bytes; RU bytes a raw row of
  // UB-byte copy units
  int TR, TC, SR, TW, CS, RU, UB, tiles_x, tiles_y;
  float xfloor, wfloor;
};

// resident conv blocks an SM is built for, per configuration (registers)
template <int MF, int NF>
struct MinBlocks {
  static constexpr int value = MF * NF >= 32 ? 2 : (MF * NF >= 16 ? 3 : 4);
};

// TM = (4 / WN) * MF * 16 output pixels (TR rows x TC columns), NT = WN *
// NF * 8 output channels from blockIdx.y * NT; warp w computes pixels
// (w % WM) * MF * 16 ... and channels (w / WM) * NF * 8 ... . A block walks
// the pixel tiles blockIdx.x, blockIdx.x + gridDim.x, ..., each in nch
// steps (one a depth chunk).
template <int MF, int NF, int WN>
__global__ void __launch_bounds__(kThreads, (MinBlocks<MF, NF>::value))
    conv_kernel(const ConvArgs a) {
  constexpr int WM = 4 / WN;
  constexpr int NT = WN * NF * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int DC = a.DC, DCS = a.DC + 16;
  const int asz = (a.SR * a.TW * a.CS + 15) & ~15;
  const int nq = a.CC / 4, n_rows = a.SR * nq;
  const int esz = a.dtype == 1 ? 2 : 4;         // bytes an element
  const int eu = a.UB / esz;                    // elements a copy unit
  const int n_units = a.RU / a.UB;              // units a raw row
  int* offs = reinterpret_cast<int*>(smem);             // DC / 4 words
  unsigned char* const wbuf = smem + DC;                // 2 x NT x DCS
  unsigned char* const abuf = wbuf + 2 * NT * DCS;      // asz
  unsigned char* const raw = abuf + asz;                // SR x CC x RU
  int2* rows = reinterpret_cast<int2*>(raw + a.SR * a.CC * a.RU);
  float* scale = reinterpret_cast<float*>(rows + n_rows);  // NT
  float* shift = scale + NT;                                // NT

  const int tid = threadIdx.x;
  const int nb = blockIdx.y;
  const int taps = a.kh * a.kw;
  const long long numel = (long long)a.B * a.C * a.H * a.W;

  // depth word -> offset of its 4 channels from a pixel's base in the rows
  for (int dw = tid; dw < DC / 4; dw += kThreads) {
    const int d = 4 * dw, tap = d / a.CC, c = d - tap * a.CC;
    offs[dw] = tap < taps
                   ? ((tap / a.kw) * a.TW + tap % a.kw) * a.CS + c
                   : 0;                                   // zero weights
  }
  // quantised row rr = (sy, q): its input row and first channel (x), and
  // its words' offset in the staged rows (y)
  for (int rr = tid; rr < n_rows; rr += kThreads) {
    const int sy = rr / nq, q = rr - sy * nq;
    rows[rr] = make_int2(sy * 65536 + 4 * q, sy * a.TW * a.CS + 4 * q);
  }
  const float xs =
      __fmul_rn(fmaxf(__uint_as_float(*a.xmax), a.xfloor), kInv127);
  const float xr = __frcp_rn(xs);
  const bool exact_r = isfinite(xs);            // quantize_r's condition
  const float sx =
      __fmul_rn(fmaxf(__uint_as_float(*a.xmax), a.xfloor), kInv127Sq);
  // the block's channels' dequantisation scales and biases
  for (int n = tid; n < NT; n += kThreads) {
    const int k = nb * NT + n;
    scale[n] = k < a.K
                   ? __fmul_rn(fmaxf(__uint_as_float(a.wmax[k]), a.wfloor), sx)
                   : 0.0f;
    shift[n] = k < a.K && a.bias ? a.bias[k] : 0.0f;
  }
  const int4* wsrc = a.wp + (long long)nb * a.nch * NT * DC / 16;
  // a thread's quantised items advance by kThreads: dr columns, dq rows
  const int dq = kThreads / a.TW, dr = kThreads - dq * a.TW;
  const int xc0 = tid % a.TW, rr0 = tid / a.TW;
  const int n_tiles = a.B * a.tiles_y * a.tiles_x;
  const int n_steps = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                      (int)gridDim.x * a.nch;

  // step -> (image, first input row, first input column, chunk)
  auto step_of = [&](int st, int& b, int& y0, int& x0, int& ch) {
    const int tile = blockIdx.x + (st / a.nch) * gridDim.x;
    ch = st % a.nch;
    const int tx = tile % a.tiles_x, r = tile / a.tiles_x;
    const int ty = r % a.tiles_y;
    b = r / a.tiles_y;
    y0 = ty * a.TR * a.stride - a.pt;
    x0 = tx * a.TC * a.stride - a.pl;
  };
  auto copy_w = [&](int ch, unsigned char* dst) {
    const int4* src = wsrc + (long long)ch * NT * DC / 16;
    const int row16 = DC / 16;
    for (int u = tid; u < NT * row16; u += kThreads) {
      const int n = u / row16, col = u - n * row16;
      cp_async16(dst + n * DCS + col * 16, src + u);
    }
  };
  // the step's SR input rows x CC channels, each a run of whole UB-byte
  // units (16 when every row starts 16-byte aligned, else 4) from the unit
  // holding column x0, copied as they are (raw row (sy, c) at (sy * CC +
  // c) * RU); rows off the image or past C are skipped (their values
  // become zeros when quantised). Thread t copies units t, t + kThreads,
  // ... of the step's SR * CC * n_units.
  const int du = kThreads % n_units, drow = kThreads / n_units;
  auto copy_raw = [&](int b, int y0, int x0, int ch) {
    int k = tid % n_units, row = tid / n_units;
    int sy = row / a.CC, cc = row - sy * a.CC;
    while (sy < a.SR) {
      const int c = ch * a.CC + cc, y = y0 + sy;
      if (c < a.C && y >= 0 && y < a.H) {
        const long long gi =
            (((long long)b * a.C + c) * a.H + y) * a.W + x0;
        const long long e = gi - (gi & (eu - 1)) + (long long)k * eu;
        unsigned char* dst = raw + (sy * a.CC + cc) * a.RU + a.UB * k;
        const char* src = static_cast<const char*>(a.x) + e * esz;
        if (e >= 0 && e + eu <= numel) {
          if (a.UB == 16) cp_async16(dst, src);
          else cp_async4(dst, src);
        } else if (e >= 0 && e < numel) {   // a bf16 tensor's odd last element
          *reinterpret_cast<uint16_t*>(dst) =
              static_cast<const uint16_t*>(a.x)[e];
        }
      }
      k += du;
      cc += drow;
      if (k >= n_units) {
        k -= n_units;
        ++cc;
      }
      while (cc >= a.CC) {
        cc -= a.CC;
        ++sy;
      }
    }
  };
  // the raw rows quantised into (SR, TW, CS) words of 4 channels; zeros
  // off the image and past C (the conv's SAME pads)
  const unsigned hwu = (unsigned)a.H * (unsigned)a.W;
  auto quantize_raw = [&](int b, int y0, int x0, int ch) {
    const int c0 = ch * a.CC;
    int xc = xc0, rr = rr0;
    while (rr < n_rows) {
      const int2 t = rows[rr];
      const int sy = t.x >> 16, q4 = t.x & 0xffff;
      const int y = y0 + sy, xx = x0 + xc, c = c0 + q4;
      const bool in = (unsigned)y < (unsigned)a.H &&
                      (unsigned)xx < (unsigned)a.W;
      // channel c + j's raw row starts sh_j elements before column x0
      const unsigned gi = (((unsigned)b * a.C + c) * a.H + y) * a.W + x0;
      const unsigned char* p = raw + (sy * a.CC + q4) * a.RU + xc * esz;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* pj = p + j * a.RU;
        float e;
        if (esz == 2)
          e = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
              pj + 2 * ((gi + j * hwu) & (unsigned)(eu - 1))));
        else
          e = *reinterpret_cast<const float*>(
              pj + 4 * ((gi + j * hwu) & (unsigned)(eu - 1)));
        v[j] = in && c + j < a.C ? e : 0.0f;
      }
      int word;
      if (exact_r) {
        word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= (quantize_r(v[j], xs, xr) & 0xff) << (8 * j);
      } else {
        word = quantize4(v, xs);
      }
      *reinterpret_cast<int*>(abuf + t.y + xc * a.CS) = word;
      xc += dr;
      rr += dq;
      if (xc >= a.TW) {
        xc -= a.TW;
        ++rr;
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  // this thread's fragment pixels: tile row and column, staged offset
  int abase[MF][2], prow[MF][2], pcol[MF][2];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm * MF * 16 + mf * 16 + g + 8 * h;
      prow[mf][h] = m / a.TC;
      pcol[mf][h] = m % a.TC;
      abase[mf][h] =
          (prow[mf][h] * a.stride * a.TW + pcol[mf][h] * a.stride) * a.CS;
    }
  const long long plane = (long long)a.OH * a.OW;
  int acc[MF][NF][4];

  // the pipeline: step s's raw rows (and, with several chunks, its
  // weights, in buffer s % 2) arrive while step s-1 multiplies and stores;
  // with one chunk the weights are copied once
  if (n_steps > 0) {
    int b, y0, x0, ch;
    step_of(0, b, y0, x0, ch);
    copy_w(0, wbuf);
    copy_raw(b, y0, x0, 0);
    cp_async_commit();
  }
  for (int st = 0; st < n_steps; ++st) {
    int b, y0, x0, ch;
    step_of(st, b, y0, x0, ch);
    cp_async_wait_all();
    __syncthreads();            // raw rows and weights in; products done
    quantize_raw(b, y0, x0, ch);
    __syncthreads();            // the raw rows are free again
    if (st + 1 < n_steps) {
      int b1, y1, x1, ch1;
      step_of(st + 1, b1, y1, x1, ch1);
      if (a.nch > 1) copy_w(ch1, wbuf + ((st + 1) & 1) * NT * DCS);
      copy_raw(b1, y1, x1, ch1);
      cp_async_commit();
    }
    if (ch == 0) {
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mf][nf][j] = 0;
    }
    const unsigned char* Wt = wbuf + (a.nch > 1 ? st & 1 : 0) * NT * DCS +
                              (wn * NF * 8 + g) * DCS + tig * 4;
    for (int ks = 0; ks < DC / 32; ++ks) {
      const int o0 = offs[ks * 8 + tig], o1 = offs[ks * 8 + 4 + tig];
      int af[MF][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        af[mf][0] = *reinterpret_cast<const int*>(abuf + abase[mf][0] + o0);
        af[mf][1] = *reinterpret_cast<const int*>(abuf + abase[mf][1] + o0);
        af[mf][2] = *reinterpret_cast<const int*>(abuf + abase[mf][0] + o1);
        af[mf][3] = *reinterpret_cast<const int*>(abuf + abase[mf][1] + o1);
      }
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        const unsigned char* bp = Wt + nf * 8 * DCS + ks * 32;
        const int b0 = *reinterpret_cast<const int*>(bp);
        const int b1 = *reinterpret_cast<const int*>(bp + 16);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
          mma_s8(acc[mf][nf], af[mf][0], af[mf][1], af[mf][2], af[mf][3],
                 b0, b1);
      }
    }
    if (ch + 1 < a.nch) continue;

    // epilogue: fragment element j is pixel g (+8 for j >= 2), channel
    // 2 * tig + (j & 1)
    const int tile = blockIdx.x + (st / a.nch) * gridDim.x;
    const int tx = tile % a.tiles_x, r = tile / a.tiles_x;
    const int oy0 = (r % a.tiles_y) * a.TR, ox0 = tx * a.TC;
    float* o = a.out + (long long)b * a.K * plane;
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        const int n = wn * NF * 8 + nf * 8 + 2 * tig + j2;
        const int k = nb * NT + n;
        if (k >= a.K) continue;
        const float sc = scale[n], bk = shift[n];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int oy = oy0 + prow[mf][h], ox = ox0 + pcol[mf][h];
            if (oy >= a.OH || ox >= a.OW) continue;
            const float v = __int2float_rn(acc[mf][nf][2 * h + j2]);
            o[k * plane + (long long)oy * a.OW + ox] =
                a.bias ? __fmaf_rn(v, sc, bk) : __fmul_rn(v, sc);
          }
        }
      }
    }
  }
}

template <int MF, int NF, int WN>
cudaError_t launch_conv(ConvArgs a, int n_blocks_n, cudaStream_t s) {
  constexpr int TM = (4 / WN) * MF * 16;
  constexpr int NT = WN * NF * 8;
  // TM pixels as TR rows of TC >= 32 columns (TR <= 4): the rows share
  // their staged halo, and a fragment's 16 pixels lie in one row
  a.TR = TM >= 128 ? 4 : TM / 32;
  if (a.TR > a.OH) a.TR = a.OH < 2 ? 1 : (a.OH < 4 ? 2 : a.TR);
  a.TC = TM / a.TR;
  a.SR = (a.TR - 1) * a.stride + a.kh;
  a.TW = (a.TC - 1) * a.stride + a.kw;
  a.tiles_x = (a.OW + a.TC - 1) / a.TC;
  a.tiles_y = (a.OH + a.TR - 1) / a.TR;
  // the staged pixel stride: CC, or a little more so that the 8 pixels of
  // a fragment's rows (m * stride * CS apart) spread over the banks
  a.CS = a.CC;
  for (int t = 0; t < 4; ++t, a.CS += 4) {
    const int w = a.stride * (a.CS / 4);
    if (w % 2 == 1 || w % 8 == 4) break;
  }
  {
    const int w = a.stride * (a.CS / 4);
    if (!(w % 2 == 1 || w % 8 == 4)) a.CS = a.CC;
  }
  // a raw row: the copy units from the one holding column x0 on, enough
  // for TW elements after a shift of up to a unit less one element
  const int esz = a.dtype == 1 ? 2 : 4;
  a.UB = ((long long)a.W * esz) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(a.x) % 16 == 0
             ? 16
             : 4;
  a.RU = a.UB * ((a.TW * esz + a.UB - 1) / a.UB + (a.UB > esz ? 1 : 0));
  const size_t asz = ((size_t)a.SR * a.TW * a.CS + 15) & ~(size_t)15;
  const size_t smem = (size_t)a.DC + 2 * (size_t)NT * (a.DC + 16) + asz +
                      (size_t)a.SR * a.CC * a.RU +
                      sizeof(int2) * a.SR * (a.CC / 4) + 2 * sizeof(float) * NT;
  if (smem > (size_t)kMaxSmem || a.SR > 32767 || a.CC > 65532)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv_kernel<MF, NF, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)a.B * a.tiles_y * a.tiles_x;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // as many blocks as fit on the card at once, each walking its tiles
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv_kernel<MF, NF, WN>, kThreads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long grid = (long long)sms * per_sm / n_blocks_n;
  if (grid < 1) grid = 1;
  if (grid > tiles) grid = tiles;
  conv_kernel<MF, NF, WN><<<dim3((unsigned)grid, (unsigned)n_blocks_n),
                            kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (B, C, H, W) float32 (dtype 0) or bfloat16 (dtype 1) -> maxbits (1,)
// float32: the absmax of the whole tensor.
extern "C" int p3d_int8_absmax(const void* x, int dtype, long long n,
                               void* maxbits, void* stream) {
  if ((dtype != 0 && dtype != 1) || n < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_absmax(x, dtype, 1, n, 0, maxbits, (cudaStream_t)stream);
}

// desc: n rows of 16 int64 (w, p_off, a_off, dtype, K, C, taps, NT, CC,
// nch, DC, 0, 0, 0, 0, 0), n <= kMaxWeights; arena: the outputs, packed
// (ceil(K / NT), nch, NT, DC) int8 at 16-byte offsets, amax (K,) float32 at
// 4-byte ones.
extern "C" int p3d_int8_quantize_weights(const long long* desc, int n,
                                         void* arena, float eps,
                                         void* stream) {
  if (n < 1 || n > kMaxWeights) return (int)cudaErrorInvalidValue;
  WeightTable tab{};
  tab.n = n;
  long long rows = 0;
  for (int i = 0; i < n; ++i) {
    const long long* r = desc + 16 * i;
    WeightDesc& d = tab.d[i];
    d.w = reinterpret_cast<const void*>(r[0]);
    d.p_off = r[1];
    d.a_off = r[2];
    d.dtype = (int)r[3];
    d.K = (int)r[4];
    d.C = (int)r[5];
    d.taps = (int)r[6];
    d.NT = (int)r[7];
    d.CC = (int)r[8];
    d.nch = (int)r[9];
    d.DC = (int)r[10];
    d.row0 = (int)rows;
    if ((d.dtype != 0 && d.dtype != 1) || d.K < 1 || d.C < 1 || d.taps < 1 ||
        d.NT < 1 || d.CC < 4 || d.CC % 4 != 0 ||
        (long long)d.nch * d.CC < d.C || d.DC % 32 != 0 ||
        d.DC < d.taps * d.CC || d.p_off % 16 != 0 || d.a_off % 4 != 0)
      return (int)cudaErrorInvalidValue;
    rows += (long long)(d.K + d.NT - 1) / d.NT * d.NT;
  }
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  quantize_weights_kernel<<<(unsigned)rows, kQThreads, 0,
                            (cudaStream_t)stream>>>(tab, (char*)arena, eps);
  return (int)cudaGetLastError();
}

// x (B, C, H, W) bf16 or f32 (dtype 1 / 0), wp the packed weights
// (K_pad / NT, nch, NT, DC) int8 of tile configuration `cfg` (NT = 16, 32,
// 64, 128, 256 for cfg 0..4; K_pad = n_blocks_n * NT), CC input channels a
// chunk (nch * CC >= C), xmax (1,) and wmax (K,) absmaxes, bias (K,) float32
// or null, SAME pads (pt, pl) at the top and left -> out (B, K, OH, OW)
// float32.
extern "C" int p3d_int8_conv(const void* x, int dtype, const void* wp,
                             const void* xmax, const void* wmax,
                             const void* bias, void* out, int B, int C, int H,
                             int W, int K, int kh, int kw, int stride, int pt,
                             int pl, int OH, int OW, int cfg, int CC, int nch,
                             int DC, int n_blocks_n, float xfloor,
                             float wfloor, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  static const int kNT[5] = {16, 32, 64, 128, 256};
  if ((dtype != 0 && dtype != 1) || stride < 1 || cfg < 0 || cfg > 4 ||
      CC < 4 || CC % 4 != 0 || (long long)CC * nch < C || DC % 32 != 0 ||
      DC < kh * kw * CC || n_blocks_n < 1 ||
      (long long)n_blocks_n * kNT[cfg] < K || OH < 1 || OW < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  ConvArgs a{x, (const int4*)wp, (const unsigned int*)xmax,
             (const unsigned int*)wmax, (const float*)bias, (float*)out,
             dtype, B, C, H, W, K, kh, kw, stride, pt, pl, OH, OW,
             CC, nch, DC, 0, 0, 0, 0, 0, 0, 0, 0, 0, xfloor, wfloor};
  switch (cfg) {
    case 0: return (int)launch_conv<4, 2, 1>(a, n_blocks_n, s);
    case 1: return (int)launch_conv<2, 4, 1>(a, n_blocks_n, s);
    case 2: return (int)launch_conv<2, 8, 1>(a, n_blocks_n, s);
    case 3: return (int)launch_conv<2, 8, 2>(a, n_blocks_n, s);
    default: return (int)launch_conv<2, 16, 2>(a, n_blocks_n, s);
  }
}
