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
// kernel skips the sums and the barrier, and is launched normally. A rank
// of a tp group runs the two halves as two launches with the tp group's
// sums gathered between them (AdamMode), which equals the cooperative
// launch over the tp ranks' arenas laid end to end.
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

__device__ __forceinline__ void adam_element(float& p, float g, float& mu,
                                             float& nu, bool clip,
                                             float gnorm,
                                             const AdamScalars& a) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, gnorm), a.max_norm);
  const float m = __fadd_rn(__fmul_rn(a.omb1, g), __fmul_rn(a.b1, mu));
  const float v = __fadd_rn(__fmul_rn(a.omb2, __fmul_rn(g, g)),
                            __fmul_rn(a.b2, nu));
  const float mh = __fdiv_rn(m, a.bc1);
  const float vh = __fdiv_rn(v, a.bc2);
  float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(__fadd_rn(vh, a.eps_root)),
                                    a.eps));
  u = __fadd_rn(u, __fmul_rn(a.wd, p));
  p = __fadd_rn(p, __fmul_rn(a.neg_lr, u));
  mu = m;
  nu = v;
}

// The kernel's modes. kNoClip and kClip are the one-device step (kClip a
// cooperative launch); the tp lane (a rank of a tp group holds part of
// the parameters) is kPartials, which writes the chunk sums and stops,
// then kClipGiven, which takes the norm of the n_part sums in `part` (the
// tp group's, gathered between the two launches in the norm's order) and
// updates: kClip's two halves without its grid barrier.
enum AdamMode { kNoClip = 0, kClip = 1, kPartials = 2, kClipGiven = 3 };

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(float* __restrict__ p, const float* __restrict__ g,
                 float* __restrict__ mu, float* __restrict__ nu, long long n,
                 float* part, int n_part, int mode, AdamScalars a) {
  __shared__ float s[kThreads];
  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long c0 = chunks * blockIdx.x / gridDim.x;
  const long long c1 = chunks * (blockIdx.x + 1) / gridDim.x;
  bool clipped = false;
  float gnorm = 0.0f;
  if (mode == kClip || mode == kPartials) {
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
    if (mode == kPartials) return;
    cg::this_grid().sync();
  }
  if (mode != kNoClip) {
    gnorm = __fsqrt_rn(sum_partials(part, n_part, s));
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
        adam_element(pv[r].x, gv[r].x, mv[r].x, vv[r].x, clipped, gnorm, a);
        adam_element(pv[r].y, gv[r].y, mv[r].y, vv[r].y, clipped, gnorm, a);
        adam_element(pv[r].z, gv[r].z, mv[r].z, vv[r].z, clipped, gnorm, a);
        adam_element(pv[r].w, gv[r].w, mv[r].w, vv[r].w, clipped, gnorm, a);
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
        adam_element(pi, g[i], m, v, clipped, gnorm, a);
        p[i] = pi;
        mu[i] = m;
        nu[i] = v;
      }
    }
  }
}

// ------------------------------------------------------------------ K23
// Per pixel with keep (label != ignore): pred = first argmax of the C
// logits (or the given u8 prediction), l = its label;
// counts[0*C + pred] += (pred == l)   intersection
// counts[1*C + l] += 1, counts[1*C + pred] += (pred != l)   union
// counts[2*C + l] += 1   the label's pixels
// (a label >= C counts only its prediction's union). Integer counts in
// shared memory, then one global add a class a block.
template <int C>
__global__ void iou_counts_kernel(const float* __restrict__ logits,
                                  const uint8_t* __restrict__ preds,
                                  const uint8_t* __restrict__ labels,
                                  long long HW, long long n, int ignore,
                                  unsigned long long* __restrict__ counts) {
  __shared__ unsigned int sc[3 * C];
  for (int j = threadIdx.x; j < 3 * C; j += blockDim.x) sc[j] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int l = labels[i];
    if (l == ignore) continue;
    int pr;
    if (logits != nullptr) {
      const long long b = i / HW;
      const float* x = logits + b * C * HW + (i - b * HW);
      float best = x[0];
      pr = 0;
#pragma unroll
      for (int c = 1; c < C; ++c) {
        const float v = x[c * HW];
        if (v > best) {
          best = v;
          pr = c;
        }
      }
    } else {
      pr = preds[i];
    }
    if (pr < C) atomicAdd(&sc[pr == l ? pr : C + pr], 1u);
    if (l < C) {
      atomicAdd(&sc[C + l], 1u);
      atomicAdd(&sc[2 * C + l], 1u);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * C; j += blockDim.x)
    if (sc[j]) atomicAdd(&counts[j], (unsigned long long)sc[j]);
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

// One K22 launch in `mode` (cooperative for kClip); 0 or the CUDA error.
int launch_adamw(void* p, const void* g, void* mu, void* nu, long long n,
                 void* part, int n_part, int mode, const AdamScalars& a,
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
  if (mode != kClip) {
    if (vec)
      adamw_kernel<true><<<blocks, kThreads, 0, st>>>(pp, pg, pm, pv, n,
                                                      ppart, n_part, mode, sa);
    else
      adamw_kernel<false><<<blocks, kThreads, 0, st>>>(pp, pg, pm, pv, n,
                                                       ppart, n_part, mode,
                                                       sa);
    return (int)cudaGetLastError();
  }
  void* args[] = {(void*)&pp,    (void*)&pg,     (void*)&pm,   (void*)&pv,
                  (void*)&n,     (void*)&ppart,  (void*)&n_part,
                  (void*)&mode,  (void*)&sa};
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
  return launch_adamw(p, g, mu, nu, n, part, (int)grid_for(n, kChunk, 0),
                      clip ? kClip : kNoClip, a, (cudaStream_t)stream);
}

// K22's tp lane, first launch: part[c] = the sum of g^2 over chunk c of
// the arena (p3d_adamw_partials(n) floats), in the cooperative launch's
// order.
extern "C" int p3d_adamw_tp_partials(const void* g, long long n, void* part,
                                     void* stream) {
  AdamScalars a{};
  return launch_adamw(nullptr, g, nullptr, nullptr, n, part, 0, kPartials,
                      a, (cudaStream_t)stream);
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
  AdamScalars a{b1, b2, omb1, omb2, bc1, bc2, eps, eps_root, wd, neg_lr,
                max_norm};
  return launch_adamw(p, g, mu, nu, n, (void*)sums, n_sums, kClipGiven, a,
                      (cudaStream_t)stream);
}

// K23. logits (B, C, HW) f32 or null, preds (B, HW) u8 (when logits is
// null), labels (B, HW) u8; counts (3, C) uint64, zeroed by the caller.
extern "C" int p3d_iou_counts(const void* logits, const void* preds,
                              const void* labels, int C, long long HW,
                              long long n, int ignore, void* counts,
                              void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) return 0;
  const int nb = grid_for(n, kThreads, 8 * sm_count());
  switch (C) {
#define P3D_IOU(NC)                                                        \
  case NC:                                                                 \
    iou_counts_kernel<NC><<<nb, kThreads, 0, st>>>(                        \
        (const float*)logits, (const uint8_t*)preds,                       \
        (const uint8_t*)labels, HW, n, ignore,                             \
        (unsigned long long*)counts);                                      \
    break;
    P3D_BY_C(P3D_IOU)
#undef P3D_IOU
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
