// The training kernels: K20 batch gather, K21 weighted cross-entropy (the
// loss and its gradient in one pass, and the general backward), K22
// clipped AdamW in one launch (two and a gather on a rank of a tp group),
// K23 IoU counts.
//
// They replace the jitted training programs of the JAX package
// (ROADMAP Queue B, Q22), which XLA fused on the TPU:
//   K20 plant3dvision_tpu/models/train_synth.py:273-287 (run_chunk's batch
//       draw, gather and flip) and :257-260 (loss_fn's u8 / 255 * gains and
//       clip);
//   K21 train_synth.py:257-271 and train.py:99-103 (optax
//       softmax_cross_entropy_with_integer_labels x w[y], the mean or the
//       keep-weighted sum / max(sum(keep), 1)) and XLA's autodiff of it;
//   K22 train_synth.py:220-222, :289-290 and train.py:81, :104-105
//       (optax.chain(clip_by_global_norm(1), adamw(cosine)) or adamw(lr),
//       then apply_updates);
//   K23 train_synth.py:297-309 (val_metrics) and
//       plant3dvision_tpu/models/distill.py:264 (_heldout_iou's counts).
//
// What bounds them on this card: bytes. Each is an elementwise pass or a
// reduction at a few operations a byte (K22: ~20 float32 operations for 28
// bytes an element; K21: ~6C + 8 operations and one exp a class for 8C + 1
// bytes a pixel, the logits read and the gradient written), far below the
// ~20 operations a byte where float32 math would start to bound.
//
// Determinism: no float atomics. Every float sum runs in a fixed order
// (a thread's fixed run of elements, then a fixed shared-memory tree, then
// the per-block or per-chunk partials in their order), so two runs on one
// card give the same bits and a resumed training run equals an
// uninterrupted one. Integer counts (K21's kept pixels, K23) use integer
// atomics, exact in any order. Every
// float operation is written out (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn; the library builds with -fmad=false), in the order of the
// JAX program's operations, so the kernels equal their plain versions
// elementwise; the sums differ from the plain versions' only by order.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// elements a thread sums in order before the block's tree (K22's norm)
constexpr int kRun = 16;
constexpr int kChunk = kThreads * kRun;

// Sum of the block's kThreads values in a fixed tree; the result is in
// s[0] after the call (all threads must call it).
__device__ __forceinline__ void block_tree_sum(float* s) {
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    __syncthreads();
    if (threadIdx.x < w)
      s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + w]);
  }
  __syncthreads();
}

// Sum of `n` partials that other blocks of the launch wrote, in a fixed
// order (thread t adds t, t + kThreads, ... in order, then the tree),
// broadcast to every thread of the block; read from L2 (__ldcg), the
// loop unrolled so that a thread's loads are in flight together.
__device__ float sum_partials(const float* part, int n, float* s) {
  float acc = 0.0f;
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += kThreads)
    acc = __fadd_rn(acc, __ldcg(part + i));
  s[threadIdx.x] = acc;
  block_tree_sum(s);
  const float r = s[0];
  __syncthreads();
  return r;
}

// ------------------------------------------------------------------ K20
// x (B, 3, c, c) f32 = clip(rgb[idx[b], h, w'] * (gains[b] * f32(1/255)),
// 0, 1) (XLA folds the constant into the smaller operand: `x / 255 *
// gains` compiles to that product order) and y (B, c, c) u8 =
// lab[idx[b], h, w'], w' = c - 1 - w where flip[0] (one flip a step for
// the whole batch, as the JAX step draws it). A thread a pixel: three bytes and a label read, three floats and a
// byte written; consecutive threads on consecutive pixels of a row.
__global__ void gather_batch_kernel(const uint8_t* __restrict__ rgb,
                                    const uint8_t* __restrict__ lab,
                                    const long long* __restrict__ idx,
                                    const uint8_t* __restrict__ flip,
                                    const float* __restrict__ gains,
                                    float* __restrict__ x,
                                    uint8_t* __restrict__ y, int B, int c,
                                    float inv255) {
  const long long hw = (long long)c * c;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * hw) return;
  const int b = (int)(t / hw);
  const long long p = t - (long long)b * hw;
  const int h = (int)(p / c);
  const int w = (int)(p - (long long)h * c);
  const int ws = flip[0] ? c - 1 - w : w;
  const long long src = (long long)idx[b] * hw + (long long)h * c + ws;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float v = __fmul_rn((float)rgb[src * 3 + ch],
                        __fmul_rn(gains[b * 3 + ch], inv255));
    v = fminf(fmaxf(v, 0.0f), 1.0f);
    x[((long long)b * 3 + ch) * hw + p] = v;
  }
  y[t] = lab[src];
}

// ------------------------------------------------------------------ K21
// One pass over the logits (B, C, HW) gives the loss and, at incoming
// gradient 1, its gradient, as the JAX step's value_and_grad computes both
// in one program. Per pixel: m = max_c l_c, e_c = exp(l_c - m), sum = the
// e_c added in class order, lse = log(sum) + m (jax.nn.logsumexp), term =
// (lse - l_y) * w[y]; with sc = (1 / denom) * w[y], d_c = e_c * (sc / sum)
// - [c == y] sc: the operations of ce_backward_kernel at grad = 1, so the
// gradient equals that kernel's bit for bit. A pixel whose label is
// `ignore` adds nothing and gets a zero gradient; a label >= C that is not
// ignored counts as C - 1 (as XLA clamps the index of w[y]; nothing is
// read past w or the C logits). denom = n, or with an ignored label
// max(kept, 1), kept counted before the pass by ce_keep_kernel (labels
// only; integer atomics, exact in any order).
//
// A thread takes kCeQuads quads of 4 consecutive pixels, quad q = block *
// kThreads * kCeQuads + r * kThreads + thread, r = 0 .. kCeQuads - 1, and
// issues every load of its quads before it computes: C 16-byte loads and
// one 4-byte label load a quad where HW % 4 == 0 and the tensors are
// aligned (the VEC lane), else one pixel at a time. The loss's sum order
// is fixed: a thread's pixels in (r, pixel) order, the block's tree, then
// the blocks' partials in block order. The last block to finish (a ticket:
// an atomic count taken after __threadfence) adds the partials, writes
// out = [loss, denom] and resets the ticket and the kept count to 0 for
// the next call on the stream: one launch without an ignored label, two
// with one, and no float atomics. One quad a thread (60 registers at C =
// 6, four blocks an SM): 2 and 4 quads took 9-12 % longer at phase 22's
// shape on the H100 (tools/train_kernels_ab.py --variants).
constexpr int kCeQuads = 1;
constexpr int kCeChunk = kThreads * kCeQuads * 4;   // pixels a block

// The logits and labels of pixels p0 .. p0 + 3 (y = -1 past n).
template <int C, bool VEC>
__device__ __forceinline__ void ce_load_quad(
    const float* __restrict__ logits, const uint8_t* __restrict__ labels,
    long long HW, long long n, long long p0, float (&x)[4][C], int (&y)[4]) {
  if (VEC) {
    // n % 4 == 0 and HW % 4 == 0: a quad is whole and in one image
    if (p0 >= n) {
      y[0] = y[1] = y[2] = y[3] = -1;
      return;
    }
    const long long b = p0 / HW;
    const float* l = logits + b * C * HW + (p0 - b * HW);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(l + c * HW);
      x[0][c] = v.x;
      x[1][c] = v.y;
      x[2][c] = v.z;
      x[3][c] = v.w;
    }
    const uchar4 lb = *reinterpret_cast<const uchar4*>(labels + p0);
    y[0] = lb.x;
    y[1] = lb.y;
    y[2] = lb.z;
    y[3] = lb.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = p0 + k;
      y[k] = -1;
      if (i < n) {
        const long long b = i / HW;
        const float* l = logits + b * C * HW + (i - b * HW);
#pragma unroll
        for (int c = 0; c < C; ++c) x[k][c] = l[c * HW];
        y[k] = labels[i];
      }
    }
  }
}

template <int C, bool VEC>
__device__ __forceinline__ void ce_store_quad(float* __restrict__ dlogits,
                                              long long HW, long long n,
                                              long long p0,
                                              const float (&d)[4][C]) {
  if (VEC) {
    if (p0 >= n) return;
    const long long b = p0 / HW;
    float* o = dlogits + b * C * HW + (p0 - b * HW);
#pragma unroll
    for (int c = 0; c < C; ++c)
      *reinterpret_cast<float4*>(o + c * HW) =
          make_float4(d[0][c], d[1][c], d[2][c], d[3][c]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = p0 + k;
      if (i >= n) continue;
      const long long b = i / HW;
      float* o = dlogits + b * C * HW + (i - b * HW);
#pragma unroll
      for (int c = 0; c < C; ++c) o[c * HW] = d[k][c];
    }
  }
}

// ctl[0] the ticket, ctl[1] the kept count (both 0 between calls); part
// one float a block; dlogits null when no gradient is wanted (GRAD false).
template <int C, bool VEC, bool GRAD>
__global__ void __launch_bounds__(kThreads)
    ce_fused_kernel(const float* __restrict__ logits,
                    const uint8_t* __restrict__ labels,
                    const float* __restrict__ w, long long HW, long long n,
                    int ignore, unsigned long long* ctl, float* part,
                    float* __restrict__ out, float* __restrict__ dlogits) {
  __shared__ float s[kThreads];
  __shared__ bool last;
  const float denom =
      ignore >= 0 ? fmaxf((float)__ldcg(ctl + 1), 1.0f) : (float)n;
  const float inv = __fdiv_rn(1.0f, denom);
  const long long q0 =
      (long long)blockIdx.x * (kThreads * kCeQuads) + threadIdx.x;
  float x[kCeQuads][4][C];
  int y[kCeQuads][4];
#pragma unroll
  for (int r = 0; r < kCeQuads; ++r)
    ce_load_quad<C, VEC>(logits, labels, HW, n, (q0 + r * kThreads) * 4,
                         x[r], y[r]);
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kCeQuads; ++r) {
    float d[4][C];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) d[k][c] = 0.0f;
      if (y[r][k] < 0 || y[r][k] == ignore) continue;
      const int yy = min(y[r][k], C - 1);
      const float(&v)[C] = x[r][k];
      float m = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < C; ++c) m = fmaxf(m, v[c]);
      float e[C];
      float sum = 0.0f;
      float ly = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        e[c] = expf(__fsub_rn(v[c], m));
        sum = __fadd_rn(sum, e[c]);
        if (c == yy) ly = v[c];
      }
      const float wy = __ldg(w + yy);
      const float lse = __fadd_rn(logf(sum), m);
      acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(lse, ly), wy));
      if (GRAD) {
        const float sc = __fmul_rn(inv, wy);
        const float q = __fdiv_rn(sc, sum);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float t = __fmul_rn(e[c], q);
          if (c == yy) t = __fadd_rn(t, -sc);
          d[k][c] = t;
        }
      }
    }
    if (GRAD)
      ce_store_quad<C, VEC>(dlogits, HW, n, (q0 + r * kThreads) * 4, d);
  }
  s[threadIdx.x] = acc;
  block_tree_sum(s);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s[0];
    __threadfence();
    last = atomicAdd(ctl, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float total = sum_partials(part, gridDim.x, s);
  if (threadIdx.x == 0) {
    out[0] = __fdiv_rn(total, denom);
    out[1] = denom;
    ctl[0] = 0;
    ctl[1] = 0;
  }
}

// ctl[1] += the pixels whose label is not `ignore`: 16 labels a load
// (__vcmpeq4 marks the ignored bytes), the bytes before the first 16-byte
// boundary and after the last whole word one a thread; a block's count
// through shared memory, then one integer atomic a block.
__global__ void __launch_bounds__(kThreads)
    ce_keep_kernel(const uint8_t* __restrict__ labels, long long n,
                   int ignore, unsigned long long* ctl) {
  __shared__ unsigned long long warp_sum[kThreads / 32];
  const long long head =
      min((long long)((16 - ((uintptr_t)labels & 15)) & 15), n);
  const long long words = (n - head) / 16;
  const long long tail0 = head + words * 16;
  const unsigned pat = 0x01010101u * (unsigned)ignore;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const uint4* w16 = reinterpret_cast<const uint4*>(labels + head);
  unsigned long long kept = 0;
  for (long long j = t; j < words; j += stride) {
    const uint4 v = w16[j];
    const int same = __popc(__vcmpeq4(v.x, pat)) + __popc(__vcmpeq4(v.y, pat)) +
                     __popc(__vcmpeq4(v.z, pat)) + __popc(__vcmpeq4(v.w, pat));
    kept += 16 - same / 8;
  }
  if (t < head) kept += labels[t] != ignore;
  if (t < n - tail0) kept += labels[tail0 + t] != ignore;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    kept += __shfl_down_sync(0xffffffffu, kept, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long b = 0;
    for (int i = 0; i < kThreads / 32; ++i) b += warp_sum[i];
    if (b) atomicAdd(ctl + 1, b);
  }
}

// The general backward, dlogits (B, C, HW): with g = grad[0] and sc = (g /
// denom) * w[y] (0 for an ignored pixel), d_c = exp(l_c - m) * (sc / sum)
// - [c == y] sc, the terms of XLA's autodiff of the forward in its order.
// A grid-stride loop, a thread a pixel at a time. With skip_one, dlogits
// holds the fused pass's gradient at g = 1: the kernel leaves it as it is
// when g == 1 (read on the card, no host read) and recomputes it in place
// otherwise.
template <int C>
__global__ void ce_backward_kernel(const float* __restrict__ logits,
                                   const uint8_t* __restrict__ labels,
                                   const float* __restrict__ w,
                                   const float* __restrict__ fwd,
                                   const float* __restrict__ grad,
                                   long long HW, long long n, int ignore,
                                   int skip_one,
                                   float* __restrict__ dlogits) {
  const float g = grad[0];
  if (skip_one && g == 1.0f) return;
  const float scale = __fdiv_rn(g, fwd[1]);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int y = labels[i];
    const long long b = i / HW;
    const long long px = i - b * HW;
    const float* l = logits + b * C * HW + px;
    float* d = dlogits + b * C * HW + px;
    if (y == ignore) {
#pragma unroll
      for (int c = 0; c < C; ++c) d[c * HW] = 0.0f;
      continue;
    }
    y = min(y, C - 1);
    const float sc = __fmul_rn(scale, w[y]);
    float e[C];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      e[c] = l[c * HW];
      m = fmaxf(m, e[c]);
    }
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      e[c] = expf(__fsub_rn(e[c], m));
      sum = __fadd_rn(sum, e[c]);
    }
    const float q = __fdiv_rn(sc, sum);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v = __fmul_rn(e[c], q);
      if (c == y) v = __fadd_rn(v, -sc);
      d[c * HW] = v;
    }
  }
}

// ------------------------------------------------------------------ K22
// optax's chain, clip_by_global_norm then adamw, in one launch over the
// four arenas (parameters p, gradients g, moments mu, nu), per element:
//   g' = g if g_norm < max_norm else (g / g_norm) * max_norm   (clip mode)
//   mu = (1 - b1) g' + b1 mu;  nu = (1 - b2) g'^2 + b2 nu
//   u = (mu / bc1) / (sqrt(nu / bc2 + eps_root) + eps) + wd p
//   p = p + (-lr) u
// The arena is cut into chunks of kChunk elements, and each block of the
// grid (every block resident at once, kAdamBlocksPerSm an SM at most)
// takes a fixed, contiguous run of chunks. In clip mode the launch is
// cooperative: each block first writes each of its chunks' sum of g^2
// (thread t adds elements t, t + kThreads, ... of the chunk in order, then
// the block's tree) to part[chunk]; grid.sync(); then every block adds
// the chunks' sums in one fixed order (sum_partials) to the same g_norm:
// an order that does not depend on the grid or the card's SM count. Then
// each block updates its chunks, 16 bytes a load and a store where every
// arena is 16-byte aligned (else, and in the last, partial chunk, one
// element at a time), g read again from L2. Without the clip the same
// kernel skips the sums and the barrier, and is launched normally.
//
// A rank of a tp group holds part of the parameters, and the norm is the
// whole gradient's: the tp lane runs kClip's two halves as two kernels of
// their own with the tp group's sums gathered between them, and equals the
// cooperative launch over the tp ranks' arenas laid end to end bit for
// bit (the same sums in the same order). A rank's arena is small (516,096
// elements for a dp 2 x tp 4 rank of the ResUNet: 126 chunks), so the
// one-device kernel's grid of a block a chunk would leave the card mostly
// idle behind its barriers; the lane's design:
// - adamw_chunk_sums_kernel: a warp a chunk, no shared memory and no
//   barrier. The block tree's leaf j is thread j's run, the elements j +
//   kThreads * r in r order; lane l loads the chunk's elements 128 m + 4 l
//   + q (m = 0 .. 31, q = 0 .. 3) 16 bytes at a time, which are leaves
//   128 (m % 2) + 4 l + q at r = m / 2: each lane holds 8 leaves and adds
//   each in r order. The tree's levels pair leaf j with j + w: w = 128
//   within a lane, w = 64 .. 4 in lanes 16 .. 1 apart (__shfl_down_sync),
//   w = 2, 1 within lane 0 again: the same pairs as block_tree_sum.
// - adamw_tp_update_kernel: a grid of its own, kUpdShare elements a block
//   (several blocks an SM), no order to keep. Every thread issues its
//   16-byte loads of p, g, mu and nu first; while they are in flight warp
//   0 adds the gathered sums in sum_partials' order (warp_sum_partials:
//   lane l holds the leaves l + 32 k, the tree's w >= 32 levels in
//   registers, the rest by shuffles) and hands g_norm to the block through
//   shared memory; one barrier, then the elements.
struct AdamScalars {
  float b1, b2, omb1, omb2;     // decays and f32(1 - decay)
  float bc1, bc2;               // 1 - b^count, computed by the caller
  float eps, eps_root, wd;      // adam's eps, eps_root, weight decay
  float neg_lr;                 // -lr at this step's schedule count
  float max_norm;               // clip threshold (clip mode only)
};

// the 16-byte lane's 96 registers hold an SM to two blocks of kThreads
// anyway; one block an SM took 25 % longer (--variants)
constexpr int kAdamBlocksPerSm = 2;
// the tp lane: warps (chunks) a block of its first kernel, and quads of 4
// elements a thread of its update (kUpdShare elements a block)
constexpr int kSumWarps = 1;
constexpr int kUpdQuads = 2;
constexpr int kUpdShare = kThreads * 4 * kUpdQuads;

// x / y and sqrt(x) rounded to nearest: __fdiv_rn and __fsqrt_rn, and
// with ZEROS a zero x taken apart. Both sequences leave their fast path
// for a zero x, and each quotient of an element whose g, mu and nu are 0
// has one: the tp lane's arena pads each region with zeros (3204 in a dp 2
// x tp 4 rank of the ResUNet), which took its update 1.7x as long. 0 / y
// is the zero of sign(x) ^ sign(y) for a finite y != 0, sqrt(+-0) = +-0:
// the same bits. The one-device modes keep the plain sequences, which the
// checks slowed by 12-28 % on an arena without zeros (PERF.md, K22).
template <bool ZEROS>
__device__ __forceinline__ float quot(float x, float y) {
  if (ZEROS && x == 0.0f && fabsf(y) < CUDART_INF_F && y != 0.0f)
    return __int_as_float((__float_as_int(x) ^ __float_as_int(y)) &
                          0x80000000);
  return __fdiv_rn(x, y);
}

template <bool ZEROS>
__device__ __forceinline__ float root(float x) {
  return ZEROS && x == 0.0f ? x : __fsqrt_rn(x);
}

template <bool ZEROS>
__device__ __forceinline__ void adam_element(float& p, float g, float& mu,
                                             float& nu, bool clip,
                                             float gnorm,
                                             const AdamScalars& a) {
  if (clip) g = __fmul_rn(quot<ZEROS>(g, gnorm), a.max_norm);
  const float m = __fadd_rn(__fmul_rn(a.omb1, g), __fmul_rn(a.b1, mu));
  const float v = __fadd_rn(__fmul_rn(a.omb2, __fmul_rn(g, g)),
                            __fmul_rn(a.b2, nu));
  const float mh = quot<ZEROS>(m, a.bc1);
  const float vh = quot<ZEROS>(v, a.bc2);
  float u = quot<ZEROS>(
      mh, __fadd_rn(root<ZEROS>(__fadd_rn(vh, a.eps_root)), a.eps));
  u = __fadd_rn(u, __fmul_rn(a.wd, p));
  p = __fadd_rn(p, __fmul_rn(a.neg_lr, u));
  mu = m;
  nu = v;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(float* __restrict__ p, const float* __restrict__ g,
                 float* __restrict__ mu, float* __restrict__ nu, long long n,
                 float* part, int clip, AdamScalars a) {
  __shared__ float s[kThreads];
  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long c0 = chunks * blockIdx.x / gridDim.x;
  const long long c1 = chunks * (blockIdx.x + 1) / gridDim.x;
  bool clipped = false;
  float gnorm = 0.0f;
  if (clip) {
    for (long long c = c0; c < c1; ++c) {
      const long long base = c * kChunk + threadIdx.x;
      float v[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const long long i = base + r * kThreads;
        v[r] = i < n ? g[i] : 0.0f;
      }
      // past n the square is +0: adding it leaves the sum's bits as they are
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < kRun; ++r)
        acc = __fadd_rn(acc, __fmul_rn(v[r], v[r]));
      s[threadIdx.x] = acc;
      block_tree_sum(s);
      if (threadIdx.x == 0) part[c] = s[0];
    }
    cg::this_grid().sync();
    gnorm = __fsqrt_rn(sum_partials(part, (int)chunks, s));
    clipped = !(gnorm < a.max_norm);
  }
  for (long long c = c0; c < c1; ++c) {
    const long long base = c * kChunk;
    if (VEC && base + kChunk <= n) {
      float4 pv[kRun / 4], gv[kRun / 4], mv[kRun / 4], vv[kRun / 4];
#pragma unroll
      for (int r = 0; r < kRun / 4; ++r) {
        const long long e = base + (long long)(r * kThreads + threadIdx.x) * 4;
        pv[r] = *reinterpret_cast<const float4*>(p + e);
        gv[r] = *reinterpret_cast<const float4*>(g + e);
        mv[r] = *reinterpret_cast<const float4*>(mu + e);
        vv[r] = *reinterpret_cast<const float4*>(nu + e);
      }
#pragma unroll
      for (int r = 0; r < kRun / 4; ++r) {
        const long long e = base + (long long)(r * kThreads + threadIdx.x) * 4;
        adam_element<false>(pv[r].x, gv[r].x, mv[r].x, vv[r].x, clipped,
                            gnorm, a);
        adam_element<false>(pv[r].y, gv[r].y, mv[r].y, vv[r].y, clipped,
                            gnorm, a);
        adam_element<false>(pv[r].z, gv[r].z, mv[r].z, vv[r].z, clipped,
                            gnorm, a);
        adam_element<false>(pv[r].w, gv[r].w, mv[r].w, vv[r].w, clipped,
                            gnorm, a);
        *reinterpret_cast<float4*>(p + e) = pv[r];
        *reinterpret_cast<float4*>(mu + e) = mv[r];
        *reinterpret_cast<float4*>(nu + e) = vv[r];
      }
    } else {
      // an unaligned arena, or the last, partial chunk
      for (int j = threadIdx.x; j < kChunk; j += kThreads) {
        const long long i = base + j;
        if (i >= n) break;
        float pi = p[i], m = mu[i], v = nu[i];
        adam_element<false>(pi, g[i], m, v, clipped, gnorm, a);
        p[i] = pi;
        mu[i] = m;
        nu[i] = v;
      }
    }
  }
}

// x[e .. e + 3] one element at a time, 0 past n; and the store of those
// below n
__device__ __forceinline__ float4 load4(const float* x, long long e,
                                        long long n) {
  return make_float4(e < n ? x[e] : 0.0f, e + 1 < n ? x[e + 1] : 0.0f,
                     e + 2 < n ? x[e + 2] : 0.0f, e + 3 < n ? x[e + 3] : 0.0f);
}

__device__ __forceinline__ void store4(float* x, long long e, long long n,
                                       float4 v) {
  if (e < n) x[e] = v.x;
  if (e + 1 < n) x[e + 1] = v.y;
  if (e + 2 < n) x[e + 2] = v.z;
  if (e + 3 < n) x[e + 3] = v.w;
}

// The tp lane's first kernel: part[c] = the sum of g^2 over chunk c, a
// warp a chunk (kChunk / 128 = 32 loads of 16 bytes a lane, all issued
// before the first add), bit-equal to adamw_kernel's chunk sums.
template <bool VEC>
__global__ void __launch_bounds__(kSumWarps * 32)
    adamw_chunk_sums_kernel(const float* __restrict__ g, long long n,
                            float* __restrict__ part) {
  constexpr int kM = kChunk / 128;
  const int lane = threadIdx.x & 31;
  const long long c =
      (long long)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (c * kChunk >= n) return;
  const long long base = c * kChunk + 4 * lane;
  // acc[h][q]: leaf 128 h + 4 lane + q; past n the square is +0
  float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  if (VEC && c * kChunk + kChunk <= n) {
    float4 v[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m)
      v[m] = __ldg(reinterpret_cast<const float4*>(g + base + 128 * m));
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      float(&t)[4] = acc[m & 1];
      t[0] = __fadd_rn(t[0], __fmul_rn(v[m].x, v[m].x));
      t[1] = __fadd_rn(t[1], __fmul_rn(v[m].y, v[m].y));
      t[2] = __fadd_rn(t[2], __fmul_rn(v[m].z, v[m].z));
      t[3] = __fadd_rn(t[3], __fmul_rn(v[m].w, v[m].w));
    }
  } else {
    // an unaligned arena, or the last, partial chunk: m = 2 r + h
    for (int r = 0; r < kM / 2; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = load4(g, base + 128 * (2 * r + h), n);
        acc[h][0] = __fadd_rn(acc[h][0], __fmul_rn(v.x, v.x));
        acc[h][1] = __fadd_rn(acc[h][1], __fmul_rn(v.y, v.y));
        acc[h][2] = __fadd_rn(acc[h][2], __fmul_rn(v.z, v.z));
        acc[h][3] = __fadd_rn(acc[h][3], __fmul_rn(v.w, v.w));
      }
    }
  }
  // the tree: w = 128 in the lane, 64 .. 4 by shuffles, 2 and 1 in lane 0
  float t[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) t[q] = __fadd_rn(acc[0][q], acc[1][q]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      t[q] = __fadd_rn(t[q], __shfl_down_sync(0xffffffffu, t[q], o));
  }
  if (lane == 0)
    part[c] = __fadd_rn(__fadd_rn(t[0], t[2]), __fadd_rn(t[1], t[3]));
}

// sum_partials' sum of the n partials by one warp, in every lane: lane l
// holds leaves l + 32 k (k = 0 .. 7), each adding partials j, j +
// kThreads, ... in order; the tree's w = 128, 64, 32 levels pair leaves k
// and k + 4, k + 2, k + 1 in a lane, w = 16 .. 1 by shuffles.
__device__ float warp_sum_partials(const float* part, int n) {
  const int lane = threadIdx.x & 31;
  float t[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int r = 0; r < n; r += kThreads) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = r + lane + 32 * k;
      v[k] = i < n ? __ldcg(part + i) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (r + lane + 32 * k < n) t[k] = __fadd_rn(t[k], v[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = __fadd_rn(t[k], t[k + 4]);
  t[0] = __fadd_rn(t[0], t[2]);
  t[1] = __fadd_rn(t[1], t[3]);
  float x = __fadd_rn(t[0], t[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  return __shfl_sync(0xffffffffu, x, 0);
}

// The tp lane's update: g_norm = sqrt of the n_sums sums (the whole
// gradient's chunk sums in the norm's order), the clip, then adam_element;
// block b takes elements b * kUpdShare + 4 (r * kThreads + t) + 0 .. 3.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    adamw_tp_update_kernel(float* __restrict__ p, const float* __restrict__ g,
                           float* __restrict__ mu, float* __restrict__ nu,
                           long long n, const float* sums, int n_sums,
                           AdamScalars a) {
  __shared__ float norm;
  const long long base = (long long)blockIdx.x * kUpdShare + 4 * threadIdx.x;
  float4 pv[kUpdQuads], gv[kUpdQuads], mv[kUpdQuads], vv[kUpdQuads];
#pragma unroll
  for (int r = 0; r < kUpdQuads; ++r) {
    const long long e = base + (long long)r * kThreads * 4;
    if (VEC && e + 4 <= n) {
      pv[r] = *reinterpret_cast<const float4*>(p + e);
      gv[r] = *reinterpret_cast<const float4*>(g + e);
      mv[r] = *reinterpret_cast<const float4*>(mu + e);
      vv[r] = *reinterpret_cast<const float4*>(nu + e);
    } else {
      pv[r] = load4(p, e, n);
      gv[r] = load4(g, e, n);
      mv[r] = load4(mu, e, n);
      vv[r] = load4(nu, e, n);
    }
  }
  if (threadIdx.x < 32) {
    const float gn = __fsqrt_rn(warp_sum_partials(sums, n_sums));
    if (threadIdx.x == 0) norm = gn;
  }
  __syncthreads();
  const float gnorm = norm;
  const bool clipped = !(gnorm < a.max_norm);
#pragma unroll
  for (int r = 0; r < kUpdQuads; ++r) {
    const long long e = base + (long long)r * kThreads * 4;
    adam_element<true>(pv[r].x, gv[r].x, mv[r].x, vv[r].x, clipped,
                       gnorm, a);
    adam_element<true>(pv[r].y, gv[r].y, mv[r].y, vv[r].y, clipped,
                       gnorm, a);
    adam_element<true>(pv[r].z, gv[r].z, mv[r].z, vv[r].z, clipped,
                       gnorm, a);
    adam_element<true>(pv[r].w, gv[r].w, mv[r].w, vv[r].w, clipped,
                       gnorm, a);
    if (VEC && e + 4 <= n) {
      *reinterpret_cast<float4*>(p + e) = pv[r];
      *reinterpret_cast<float4*>(mu + e) = mv[r];
      *reinterpret_cast<float4*>(nu + e) = vv[r];
    } else {
      store4(p, e, n, pv[r]);
      store4(mu, e, n, mv[r]);
      store4(nu, e, n, vv[r]);
    }
  }
}

// ------------------------------------------------------------------ K23
// Per pixel kept (label l != ignore), pred = the first argmax of the C
// logits (or the given u8 prediction):
//   tp[c] = #(pred == l == c), lab[c] = #(l == c), prd[c] = #(pred == c)
// and counts = [tp, lab + prd - tp (the union), lab], (3, C): a label >= C
// counts only in prd (its prediction's union), a prediction >= C only in
// lab. Integer counts, exact in any order, and linear: a block's union is
// its own lab + prd - tp.
//
// What bounds it: bytes at the logits' 4C + 1 bytes a pixel; with given
// predictions (2 bytes a pixel) the integer operations a pixel come close
// to the bytes' time, so a pixel's counting is ~11 operations whatever C
// is: each of tp, prd and lab is one 32-bit word of 8 nibble counters, the
// pixel adding 1 << 4 v (v = l or pred; 0 for v >= 8: PTX clamps the
// shift), with no test of the ignored label but prd's (an ignored label
// >= 8 adds nothing to lab and tp; one below 8 adds to its own class's,
// which the block drops); the nibbles are moved into byte counters every
// 8 pixels, into 16-bit ones before the warp's sums (__reduce_add_sync),
// summed over the block's warps in shared memory, then one global atomic
// a nonzero count a block into the counts. A thread takes 16 consecutive
// pixels: one 16-byte load of labels (and of predictions), and C float4
// loads of logits a quad where HW % 4 == 0, all issued before the first
// count; a pixel at a time at a tail or where HW % 4 != 0. The logits'
// grid is 2-D (tiles of HW, images), so no pixel divides by HW. The
// counts are zeroed by a memset on the launch's stream just before it.
constexpr int kIouPx = 16;

template <bool LOGITS>
struct IouShape {
  static constexpr int kThreads = LOGITS ? 128 : 256;
};

// 1 << a (a = 4 v: v's nibble), 0 for a >= 32 (shl.b32 clamps the shift)
__device__ __forceinline__ uint32_t nibble_at(uint32_t a) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(1u), "r"(a));
  return r;
}

// a thread's counters: nib[h] 8 nibbles (h = 0 tp, 1 prd, 2 lab), ev[h] /
// od[h] the even / odd classes in bytes
struct IouAcc {
  uint32_t nib[3] = {0u, 0u, 0u}, ev[3] = {0u, 0u, 0u}, od[3] = {0u, 0u, 0u};

  // al, ap = 4 l, 4 pred; aign = 4 ignore (or ~0u: none)
  __device__ __forceinline__ void pixel(uint32_t al, uint32_t ap,
                                        uint32_t aign) {
    const uint32_t ol = nibble_at(al);
    nib[2] += ol;
    if (al == ap) nib[0] += ol;
    if (al != aign) nib[1] += nibble_at(ap);
  }
  // every 8 pixels: a nibble holds at most 15
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      ev[h] += nib[h] & 0x0F0F0F0Fu;
      od[h] += (nib[h] >> 4) & 0x0F0F0F0Fu;
      nib[h] = 0u;
    }
  }
};

// 4 x byte k of w
__device__ __forceinline__ uint32_t byte_x4(uint32_t w, int k) {
  return k == 0 ? (w << 2) & 0x3FCu : (w >> (8 * k - 2)) & 0x3FCu;
}

// the first maximum of x, as the plain version's argmax
template <int C>
__device__ __forceinline__ int first_argmax(const float (&x)[C]) {
  float best = x[0];
  int pr = 0;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    if (x[c] > best) {
      best = x[c];
      pr = c;
    }
  }
  return pr;
}

// 16 bytes at q as 4 words: one 16-byte load where q is aligned
__device__ __forceinline__ void load16(const uint8_t* q, uint32_t (&w)[4]) {
  if (((uintptr_t)q & 15) == 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(q));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = q[4 * j] | (uint32_t)q[4 * j + 1] << 8 |
             (uint32_t)q[4 * j + 2] << 16 | (uint32_t)q[4 * j + 3] << 24;
  }
}

// the word of class c's 16-bit counter after the widening: words (0 |
// 4), (2 | 6), (1 | 5), (3 | 7), the higher class in the high half
__device__ __forceinline__ constexpr int iou_word(int c) {
  return ((c & 1) << 1) | ((c >> 1) & 1);
}

// counts (3, C) int64, zero on entry. VEC (the logits): HW % 4 == 0 and
// the logits 16-byte aligned.
template <int C, bool LOGITS, bool VEC>
__global__ void __launch_bounds__(IouShape<LOGITS>::kThreads)
    iou_counts_kernel(const float* __restrict__ logits,
                      const uint8_t* __restrict__ preds,
                      const uint8_t* __restrict__ labels, long long HW,
                      long long n, int ignore,
                      unsigned long long* __restrict__ counts) {
  constexpr int T = IouShape<LOGITS>::kThreads;
  constexpr int kWarps = T / 32;
  __shared__ uint32_t sw[kWarps][12];
  IouAcc acc;
  const uint32_t aign = ignore >= 0 ? 4u * ignore : ~0u;
  // the thread's pixels: o .. o + 15 of image blockIdx.y (logits), or of
  // the flat B * HW pixels (predictions)
  const long long o = ((long long)blockIdx.x * T + threadIdx.x) * kIouPx;
  const long long len = LOGITS ? HW : n;
  const uint8_t* lab = labels + (LOGITS ? blockIdx.y * HW : 0) + o;
  const float* x = LOGITS ? logits + blockIdx.y * C * HW + o : nullptr;
  const uint8_t* pp = LOGITS ? nullptr : preds + o;
  if (VEC && o + kIouPx <= len) {
    uint32_t lv[4];
    load16(lab, lv);
    if (LOGITS) {
      float4 v[4][C];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c)
          v[q][c] = __ldg(reinterpret_cast<const float4*>(x + c * HW + 4 * q));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float x0[C], x1[C], x2[C], x3[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          x0[c] = v[q][c].x;
          x1[c] = v[q][c].y;
          x2[c] = v[q][c].z;
          x3[c] = v[q][c].w;
        }
        acc.pixel(byte_x4(lv[q], 0), 4 * first_argmax<C>(x0), aign);
        acc.pixel(byte_x4(lv[q], 1), 4 * first_argmax<C>(x1), aign);
        acc.pixel(byte_x4(lv[q], 2), 4 * first_argmax<C>(x2), aign);
        acc.pixel(byte_x4(lv[q], 3), 4 * first_argmax<C>(x3), aign);
        if (q & 1) acc.flush();
      }
    } else {
      uint32_t pv[4];
      load16(pp, pv);
#pragma unroll
      for (int k = 0; k < kIouPx; ++k) {
        acc.pixel(byte_x4(lv[k >> 2], k & 3), byte_x4(pv[k >> 2], k & 3),
                  aign);
        if ((k & 7) == 7) acc.flush();
      }
    }
  } else if (o < len) {
    // a pixel at a time: the tail, or logits without VEC
    for (int k = 0; k < kIouPx && o + k < len; ++k) {
      int pr;
      if (LOGITS) {
        float xs[C];
#pragma unroll
        for (int c = 0; c < C; ++c) xs[c] = x[c * HW + k];
        pr = first_argmax<C>(xs);
      } else {
        pr = pp[k];
      }
      acc.pixel(4u * lab[k], 4u * pr, aign);
      if ((k & 7) == 7) acc.flush();
    }
    acc.flush();
  }
  // 16-bit counters a class pair, summed over the warp, then the block
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < 3; ++h) {
    const uint32_t w[4] = {acc.ev[h] & 0x00FF00FFu,
                           (acc.ev[h] >> 8) & 0x00FF00FFu,
                           acc.od[h] & 0x00FF00FFu,
                           (acc.od[h] >> 8) & 0x00FF00FFu};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // word j's lower class is 2 (j & 1) + (j >> 1): skip words past C
      if (2 * (j & 1) + (j >> 1) >= C) continue;
      const uint32_t s = __reduce_add_sync(0xffffffffu, w[j]);
      if ((threadIdx.x & 31) == 0) sw[warp][4 * h + j] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < C) {
    // a warp's counter is at most 512, a block's 4096: no carry between
    // the halves
    const int c = threadIdx.x;
    uint32_t v[3];
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      uint32_t sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sw[w][4 * h + iou_word(c)];
      v[h] = (sum >> (16 * (c >> 2))) & 0xFFFFu;
    }
    // an ignored label below 8 counted in its own class's tp and lab
    if (c == ignore) v[0] = v[2] = 0;
    const uint32_t add[3] = {v[0], v[2] + v[1] - v[0], v[2]};
#pragma unroll
    for (int h = 0; h < 3; ++h)
      if (add[h]) atomicAdd(counts + h * C + c, (unsigned long long)add[h]);
  }
}

int grid_for(long long n, int per_block, int cap) {
  long long b = (n + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (cap > 0 && b > cap) b = cap;
  return (int)b;
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess) return sms;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cached[dev] = sms;
  return sms;
}

// K21's fused pass for one class count, in its lane.
template <int C>
void launch_ce(bool vec, bool grad, int nb, cudaStream_t st,
               const float* logits, const uint8_t* labels, const float* w,
               long long HW, long long n, int ignore,
               unsigned long long* ctl, float* part, float* out,
               float* dlogits) {
  if (vec && grad)
    ce_fused_kernel<C, true, true><<<nb, kThreads, 0, st>>>(
        logits, labels, w, HW, n, ignore, ctl, part, out, dlogits);
  else if (vec)
    ce_fused_kernel<C, true, false><<<nb, kThreads, 0, st>>>(
        logits, labels, w, HW, n, ignore, ctl, part, out, dlogits);
  else if (grad)
    ce_fused_kernel<C, false, true><<<nb, kThreads, 0, st>>>(
        logits, labels, w, HW, n, ignore, ctl, part, out, dlogits);
  else
    ce_fused_kernel<C, false, false><<<nb, kThreads, 0, st>>>(
        logits, labels, w, HW, n, ignore, ctl, part, out, dlogits);
}

// K22's blocks for `chunks` chunks: at most kAdamBlocksPerSm an SM, and
// no more than the card holds at once (a cooperative launch's limit).
template <bool VEC>
cudaError_t adamw_blocks(long long chunks, int* blocks) {
  static int per_sm = 0;
  if (per_sm == 0) {
    int occ = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, adamw_kernel<VEC>, kThreads, 0);
    if (err != cudaSuccess) return err;
    per_sm = occ < kAdamBlocksPerSm ? occ : kAdamBlocksPerSm;
  }
  const long long most = (long long)per_sm * sm_count();
  *blocks = (int)(chunks < most ? (chunks > 0 ? chunks : 1) : most);
  return cudaSuccess;
}

bool aligned16(const void* q) { return ((uintptr_t)q & 15) == 0; }

}  // namespace

// K20. rgb (N, c, c, 3) u8, lab (N, c, c) u8, idx (B,) int64, flip (1,)
// u8, gains (B, 3) f32 -> x (B, 3, c, c) f32, y (B, c, c) u8.
extern "C" int p3d_gather_batch(const void* rgb, const void* lab,
                                const void* idx, const void* flip,
                                const void* gains, void* x, void* y, int B,
                                int c, float inv255, void* stream) {
  const long long n = (long long)B * c * c;
  if (n == 0) return 0;
  gather_batch_kernel<<<grid_for(n, kThreads, 0), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)rgb, (const uint8_t*)lab, (const long long*)idx,
      (const uint8_t*)flip, (const float*)gains, (float*)x, (uint8_t*)y, B,
      c, inv255);
  return (int)cudaGetLastError();
}

#define P3D_BY_C(MACRO) \
  MACRO(2) MACRO(3) MACRO(4) MACRO(5) MACRO(6) MACRO(7) MACRO(8)

// Number of partials (blocks) K21's pass writes for n pixels.
extern "C" int p3d_ce_blocks(long long n) {
  return grid_for(n, kCeChunk, 0);
}

// K21 in one pass. logits (B, C, HW) f32, labels (B, HW) u8, w (C,) f32;
// ignore = the ignored label or -1; ctl (2,) uint64 zero between calls
// (the kernel leaves it so), part p3d_ce_blocks(n) floats; out (2,) f32 =
// [loss, denom]; dlogits (B, C, HW) f32 for the gradient at incoming
// gradient 1, or null for the loss alone. One launch, two with an ignored
// label (its kept count first).
extern "C" int p3d_ce(const void* logits, const void* labels, const void* w,
                      int C, long long HW, long long n, int ignore, void* ctl,
                      void* part, void* out, void* dlogits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C < 2 || C > 8) return (int)cudaErrorInvalidValue;
  unsigned long long* c = (unsigned long long*)ctl;
  if (ignore >= 0) {
    ce_keep_kernel<<<grid_for(n / 16 + 1, kThreads, 2 * sm_count()),
                     kThreads, 0, st>>>((const uint8_t*)labels, n, ignore, c);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = HW % 4 == 0 && aligned16(logits) &&
                   ((uintptr_t)labels & 3) == 0 &&
                   (dlogits == nullptr || aligned16(dlogits));
  const bool grad = dlogits != nullptr;
  const int nb = p3d_ce_blocks(n);
  switch (C) {
#define P3D_CE(NC)                                                          \
  case NC:                                                                  \
    launch_ce<NC>(vec, grad, nb, st, (const float*)logits,                  \
                  (const uint8_t*)labels, (const float*)w, HW, n, ignore, c, \
                  (float*)part, (float*)out, (float*)dlogits);              \
    break;
    P3D_BY_C(P3D_CE)
#undef P3D_CE
  }
  cudaError_t e = cudaGetLastError();
  // a pass that did not launch leaves the kept count for the next call
  if (e != cudaSuccess && ignore >= 0) cudaMemsetAsync(ctl, 0, 16, st);
  return (int)e;
}

// K21's general backward. fwd = the pass's out (2,), grad (1,) = d loss;
// skip_one: dlogits holds the pass's gradient at 1, kept as it is when
// grad == 1 and recomputed in place otherwise.
extern "C" int p3d_ce_backward(const void* logits, const void* labels,
                               const void* w, const void* fwd,
                               const void* grad, int C, long long HW,
                               long long n, int ignore, int skip_one,
                               void* dlogits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = grid_for(n, kThreads, 8 * sm_count());
  switch (C) {
#define P3D_CEB(NC)                                                          \
  case NC:                                                                   \
    ce_backward_kernel<NC><<<nb, kThreads, 0, st>>>(                         \
        (const float*)logits, (const uint8_t*)labels, (const float*)w,       \
        (const float*)fwd, (const float*)grad, HW, n, ignore, skip_one,      \
        (float*)dlogits);                                                    \
    break;
    P3D_BY_C(P3D_CEB)
#undef P3D_CEB
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Number of chunk sums K22's norm writes for n elements.
extern "C" int p3d_adamw_partials(long long n) {
  return grid_for(n, kChunk, 0);
}

namespace {

// One K22 launch (cooperative with the clip); 0 or the CUDA error.
int launch_adamw(void* p, const void* g, void* mu, void* nu, long long n,
                 void* part, int clip, const AdamScalars& a,
                 cudaStream_t st) {
  if (n == 0) return 0;
  const bool vec = aligned16(p) && aligned16(g) && aligned16(mu) &&
                   aligned16(nu);
  const long long chunks = grid_for(n, kChunk, 0);
  int blocks = 0;
  cudaError_t err = vec ? adamw_blocks<true>(chunks, &blocks)
                        : adamw_blocks<false>(chunks, &blocks);
  if (err != cudaSuccess) return (int)err;
  float* pp = (float*)p;
  const float* pg = (const float*)g;
  float* pm = (float*)mu;
  float* pv = (float*)nu;
  float* ppart = (float*)part;
  AdamScalars sa = a;
  if (!clip) {
    if (vec)
      adamw_kernel<true><<<blocks, kThreads, 0, st>>>(pp, pg, pm, pv, n,
                                                      ppart, 0, sa);
    else
      adamw_kernel<false><<<blocks, kThreads, 0, st>>>(pp, pg, pm, pv, n,
                                                       ppart, 0, sa);
    return (int)cudaGetLastError();
  }
  void* args[] = {(void*)&pp, (void*)&pg,    (void*)&pm,   (void*)&pv,
                  (void*)&n,  (void*)&ppart, (void*)&clip, (void*)&sa};
  err = cudaLaunchCooperativeKernel(
      vec ? (const void*)adamw_kernel<true> : (const void*)adamw_kernel<false>,
      dim3(blocks), dim3(kThreads), args, 0, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// K22. Arenas p, g, mu, nu of n f32 each; part p3d_adamw_partials(n)
// floats (clip mode; else unused, may be null); clip = 1: the cooperative
// launch with the norm, 0: a plain launch without it. One launch either
// way; a cooperative launch the card refuses returns its error. Scalars
// as AdamScalars, in its order.
extern "C" int p3d_adamw(void* p, const void* g, void* mu, void* nu,
                         long long n, void* part, int clip, float b1,
                         float b2, float omb1, float omb2, float bc1,
                         float bc2, float eps, float eps_root, float wd,
                         float neg_lr, float max_norm, void* stream) {
  AdamScalars a{b1, b2, omb1, omb2, bc1, bc2, eps, eps_root, wd, neg_lr,
                max_norm};
  return launch_adamw(p, g, mu, nu, n, part, clip ? 1 : 0, a,
                      (cudaStream_t)stream);
}

// K22's tp lane, first launch: part[c] = the sum of g^2 over chunk c of
// the arena (p3d_adamw_partials(n) floats), in the cooperative launch's
// order.
extern "C" int p3d_adamw_tp_partials(const void* g, long long n, void* part,
                                     void* stream) {
  if (n == 0) return 0;
  const int nb = grid_for(grid_for(n, kChunk, 0), kSumWarps, 0);
  const cudaStream_t st = (cudaStream_t)stream;
  if (aligned16(g))
    adamw_chunk_sums_kernel<true><<<nb, kSumWarps * 32, 0, st>>>(
        (const float*)g, n, (float*)part);
  else
    adamw_chunk_sums_kernel<false><<<nb, kSumWarps * 32, 0, st>>>(
        (const float*)g, n, (float*)part);
  return (int)cudaGetLastError();
}

// K22's tp lane, second launch: the clipped update of the arenas with
// g_norm = sqrt of the n_sums chunk sums in `sums` (the whole gradient's,
// in the norm's order), added as the cooperative launch adds its own.
extern "C" int p3d_adamw_tp_update(void* p, const void* g, void* mu,
                                   void* nu, long long n, const void* sums,
                                   int n_sums, float b1, float b2,
                                   float omb1, float omb2, float bc1,
                                   float bc2, float eps, float eps_root,
                                   float wd, float neg_lr, float max_norm,
                                   void* stream) {
  if (n == 0) return 0;
  AdamScalars a{b1, b2, omb1, omb2, bc1, bc2, eps, eps_root, wd, neg_lr,
                max_norm};
  const int nb = grid_for(n, kUpdShare, 0);
  const cudaStream_t st = (cudaStream_t)stream;
  if (aligned16(p) && aligned16(g) && aligned16(mu) && aligned16(nu))
    adamw_tp_update_kernel<true><<<nb, kThreads, 0, st>>>(
        (float*)p, (const float*)g, (float*)mu, (float*)nu, n,
        (const float*)sums, n_sums, a);
  else
    adamw_tp_update_kernel<false><<<nb, kThreads, 0, st>>>(
        (float*)p, (const float*)g, (float*)mu, (float*)nu, n,
        (const float*)sums, n_sums, a);
  return (int)cudaGetLastError();
}

// K23. logits (B, C, HW) f32 or null, preds (B, HW) u8 (when logits is
// null), labels (B, HW) u8, B = n / HW; counts (3, C) int64, zeroed here
// on `stream`, then the one launch.
extern "C" int p3d_iou_counts(const void* logits, const void* preds,
                              const void* labels, int C, long long HW,
                              long long n, int ignore, void* counts,
                              void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C < 2 || C > 8) return (int)cudaErrorInvalidValue;
  const cudaError_t zero = cudaMemsetAsync(counts, 0, 3 * C * 8, st);
  if (zero != cudaSuccess || n == 0) return (int)zero;
  const bool lg = logits != nullptr;
  const int T = lg ? IouShape<true>::kThreads : IouShape<false>::kThreads;
  const long long per_block = (long long)T * kIouPx;
  const dim3 grid = lg ? dim3((unsigned)grid_for(HW, (int)per_block, 0),
                              (unsigned)(n / HW))
                       : dim3((unsigned)grid_for(n, (int)per_block, 0));
  // the predictions' lane loads 16 bytes at a time wherever it may
  const bool vec = !lg || (HW % 4 == 0 && aligned16(logits));
  const float* lp = (const float*)logits;
  const uint8_t* pp = (const uint8_t*)preds;
  const uint8_t* lb = (const uint8_t*)labels;
  unsigned long long* out = (unsigned long long*)counts;
  switch (C) {
#define P3D_IOU(NC)                                                          \
  case NC:                                                                   \
    if (lg && vec)                                                           \
      iou_counts_kernel<NC, true, true><<<grid, T, 0, st>>>(                 \
          lp, pp, lb, HW, n, ignore, out);                                   \
    else if (lg)                                                             \
      iou_counts_kernel<NC, true, false><<<grid, T, 0, st>>>(                \
          lp, pp, lb, HW, n, ignore, out);                                   \
    else                                                                     \
      iou_counts_kernel<NC, false, true><<<grid, T, 0, st>>>(                \
          lp, pp, lb, HW, n, ignore, out);                                   \
    break;
    P3D_BY_C(P3D_IOU)
#undef P3D_IOU
  }
  return (int)cudaGetLastError();
}
