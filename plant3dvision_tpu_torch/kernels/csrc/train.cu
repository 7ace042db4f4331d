// The training kernels: K20 batch gather, K21 weighted cross-entropy (its
// forward and its backward), K22 clipped AdamW, K23 IoU counts.
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
// bytes an element; K21: ~4C + 8 operations and one exp a class for 4C + 1
// bytes a pixel), far below the ~20 operations a byte where float32 math
// would start to bound.
//
// Determinism: no float atomics. Every float sum runs in a fixed order
// (a thread's fixed run of elements, then a fixed shared-memory tree, then
// the per-block partials in block order), so two runs on one card give the
// same bits and a resumed training run equals an uninterrupted one. K23's
// counts are integers (integer atomics are exact in any order). Every
// float operation is written out (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn; the library builds with -fmad=false), in the order of the
// JAX program's operations, so the kernels equal their plain versions
// elementwise; the sums differ from the plain versions' only by order.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
// elements a thread sums in order before the block's tree (K21, K22)
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

// Sum of `n` partials in a fixed order (thread t adds t, t + kThreads, ...
// in order, then the tree), broadcast to every thread of the block.
__device__ float sum_partials(const float* __restrict__ part, int n,
                              float* s) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads)
    acc = __fadd_rn(acc, part[i]);
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
// Per pixel (b, s) of logits (B, C, HW): lse = log(sum_c exp(l_c - m)) + m
// with m the largest logit (jax.nn.logsumexp), ce = lse - l_y, term =
// ce * w[y]; a pixel whose label is `ignore` adds nothing and is not
// counted, and a label >= C that is not ignored counts as C - 1 (as XLA
// clamps the index of w[y]; nothing is read past w or the C logits). Each block sums a chunk of kChunk pixels (thread t its pixels
// t, t + kThreads, ... in order, then the tree) into part[block] and
// counts its kept pixels into keep[block].
template <int C>
__global__ void ce_partial_kernel(const float* __restrict__ logits,
                                  const uint8_t* __restrict__ labels,
                                  const float* __restrict__ w, long long HW,
                                  long long n, int ignore,
                                  float* __restrict__ part,
                                  int* __restrict__ keep) {
  __shared__ float s[kThreads];
  __shared__ int k[kThreads];
  const long long base = (long long)blockIdx.x * kChunk;
  float acc = 0.0f;
  int kept = 0;
  for (int r = 0; r < kRun; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    if (i >= n) break;
    int y = labels[i];
    if (y == ignore) continue;
    y = min(y, C - 1);
    const long long b = i / HW;
    const long long px = i - b * HW;
    const float* l = logits + b * C * HW + px;
    float v[C];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = l[c * HW];
      m = fmaxf(m, v[c]);
    }
    float sum = 0.0f;
    float ly = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sum = __fadd_rn(sum, expf(__fsub_rn(v[c], m)));
      if (c == y) ly = v[c];
    }
    const float lse = __fadd_rn(logf(sum), m);
    acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(lse, ly), w[y]));
    ++kept;
  }
  s[threadIdx.x] = acc;
  k[threadIdx.x] = kept;
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (threadIdx.x < h) {
      s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + h]);
      k[threadIdx.x] += k[threadIdx.x + h];
    }
  }
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s[0];
    keep[blockIdx.x] = k[0];
  }
}

// One block: the partials in block order -> out[0] = loss = sum / denom,
// out[1] = denom (n as float, or max(kept, 1) with an ignore label).
__global__ void ce_final_kernel(const float* __restrict__ part,
                                const int* __restrict__ keep, int n_part,
                                long long n, int has_ignore,
                                float* __restrict__ out) {
  __shared__ float s[kThreads];
  __shared__ long long k[kThreads];
  const float total = sum_partials(part, n_part, s);
  long long kept = 0;
  for (int i = threadIdx.x; i < n_part; i += kThreads) kept += keep[i];
  k[threadIdx.x] = kept;
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (threadIdx.x < h) k[threadIdx.x] += k[threadIdx.x + h];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float denom =
        has_ignore ? fmaxf((float)k[0], 1.0f) : (float)n;
    out[0] = __fdiv_rn(total, denom);
    out[1] = denom;
  }
}

// dlogits (B, C, HW): with g = grad[0] and sc = (g / denom) * w[y] (0 for
// an ignored pixel), d_c = exp(l_c - m) * (sc / sum) - [c == y] sc, the
// terms of XLA's autodiff of the forward in its order. A thread a pixel.
template <int C>
__global__ void ce_backward_kernel(const float* __restrict__ logits,
                                   const uint8_t* __restrict__ labels,
                                   const float* __restrict__ w,
                                   const float* __restrict__ fwd,
                                   const float* __restrict__ grad,
                                   long long HW, long long n, int ignore,
                                   float* __restrict__ dlogits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int y = labels[i];
  const long long b = i / HW;
  const long long px = i - b * HW;
  const float* l = logits + b * C * HW + px;
  float* d = dlogits + b * C * HW + px;
  if (y == ignore) {
#pragma unroll
    for (int c = 0; c < C; ++c) d[c * HW] = 0.0f;
    return;
  }
  y = min(y, C - 1);
  const float sc = __fmul_rn(__fdiv_rn(grad[0], fwd[1]), w[y]);
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

// ------------------------------------------------------------------ K22
// Pass 1: part[block] = sum of g^2 over the block's chunk of kChunk
// elements of the gradient arena (fixed order).
__global__ void sqnorm_partial_kernel(const float* __restrict__ g,
                                      long long n,
                                      float* __restrict__ part) {
  __shared__ float s[kThreads];
  const long long base = (long long)blockIdx.x * kChunk;
  float acc = 0.0f;
  for (int r = 0; r < kRun; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    if (i >= n) break;
    const float v = g[i];
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  s[threadIdx.x] = acc;
  block_tree_sum(s);
  if (threadIdx.x == 0) part[blockIdx.x] = s[0];
}

struct AdamScalars {
  float b1, b2, omb1, omb2;     // decays and f32(1 - decay)
  float bc1, bc2;               // 1 - b^count, computed by the caller
  float eps, eps_root, wd;      // adam's eps, eps_root, weight decay
  float neg_lr;                 // -lr at this step's schedule count
  float max_norm;               // clip threshold (clip mode only)
};

// Pass 2 over the arenas (grid-stride; the grid is fixed by the caller):
// every block first reduces pass 1's partials in the same fixed order
// (g_norm = sqrt(sum)), then, per element, optax's chain:
//   g' = g if g_norm < max_norm else (g / g_norm) * max_norm   (clip mode)
//   mu = (1 - b1) g' + b1 mu;  nu = (1 - b2) g'^2 + b2 nu
//   u = (mu / bc1) / (sqrt(nu / bc2 + eps_root) + eps) + wd p
//   p = p + (-lr) u
__global__ void adamw_kernel(float* __restrict__ p,
                             const float* __restrict__ g,
                             float* __restrict__ mu, float* __restrict__ nu,
                             long long n, const float* __restrict__ part,
                             int n_part, AdamScalars a) {
  __shared__ float s[kThreads];
  bool clip = false;
  float gnorm = 0.0f;
  if (n_part > 0) {
    gnorm = __fsqrt_rn(sum_partials(part, n_part, s));
    clip = !(gnorm < a.max_norm);
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float gi = g[i];
    if (clip) gi = __fmul_rn(__fdiv_rn(gi, gnorm), a.max_norm);
    const float m = __fadd_rn(__fmul_rn(a.omb1, gi), __fmul_rn(a.b1, mu[i]));
    const float v = __fadd_rn(__fmul_rn(a.omb2, __fmul_rn(gi, gi)),
                              __fmul_rn(a.b2, nu[i]));
    const float mh = __fdiv_rn(m, a.bc1);
    const float vh = __fdiv_rn(v, a.bc2);
    float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(__fadd_rn(vh, a.eps_root)),
                                      a.eps));
    const float pi = p[i];
    u = __fadd_rn(u, __fmul_rn(a.wd, pi));
    p[i] = __fadd_rn(pi, __fmul_rn(a.neg_lr, u));
    mu[i] = m;
    nu[i] = v;
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
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

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

// Number of partials K21's forward and K22's norm write for n elements.
extern "C" int p3d_train_partials(long long n) {
  return grid_for(n, kChunk, 0);
}

#define P3D_BY_C(MACRO) \
  MACRO(2) MACRO(3) MACRO(4) MACRO(5) MACRO(6) MACRO(7) MACRO(8)

// K21 forward. logits (B, C, HW) f32, labels (B, HW) u8, w (C,) f32;
// ignore = the ignored label or -1; part (p3d_train_partials(B*HW)) f32
// and keep int32 scratch; out (2,) f32 = [loss, denom]. Two launches.
extern "C" int p3d_ce_forward(const void* logits, const void* labels,
                              const void* w, int C, long long HW,
                              long long n, int ignore, void* part,
                              void* keep, void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = grid_for(n, kChunk, 0);
  switch (C) {
#define P3D_CE(NC)                                                         \
  case NC:                                                                 \
    ce_partial_kernel<NC><<<nb, kThreads, 0, st>>>(                        \
        (const float*)logits, (const uint8_t*)labels, (const float*)w, HW, \
        n, ignore, (float*)part, (int*)keep);                              \
    break;
    P3D_BY_C(P3D_CE)
#undef P3D_CE
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ce_final_kernel<<<1, kThreads, 0, st>>>((const float*)part,
                                          (const int*)keep, nb, n,
                                          ignore >= 0, (float*)out);
  return (int)cudaGetLastError();
}

// K21 backward. fwd = the forward's out (2,), grad (1,) = d loss.
extern "C" int p3d_ce_backward(const void* logits, const void* labels,
                               const void* w, const void* fwd,
                               const void* grad, int C, long long HW,
                               long long n, int ignore, void* dlogits,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = grid_for(n, kThreads, 0);
  switch (C) {
#define P3D_CEB(NC)                                                          \
  case NC:                                                                   \
    ce_backward_kernel<NC><<<nb, kThreads, 0, st>>>(                         \
        (const float*)logits, (const uint8_t*)labels, (const float*)w,       \
        (const float*)fwd, (const float*)grad, HW, n, ignore,                \
        (float*)dlogits);                                                    \
    break;
    P3D_BY_C(P3D_CEB)
#undef P3D_CEB
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K22. Arenas p, g, mu, nu of n f32 each; part scratch of
// p3d_train_partials(n) floats; clip = 1 runs pass 1 (two launches), 0
// skips it (one launch). Scalars as AdamScalars, in its order.
extern "C" int p3d_adamw(void* p, const void* g, void* mu, void* nu,
                         long long n, void* part, int clip, float b1,
                         float b2, float omb1, float omb2, float bc1,
                         float bc2, float eps, float eps_root, float wd,
                         float neg_lr, float max_norm, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) return 0;
  int n_part = 0;
  if (clip) {
    n_part = grid_for(n, kChunk, 0);
    sqnorm_partial_kernel<<<n_part, kThreads, 0, st>>>((const float*)g, n,
                                                       (float*)part);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  AdamScalars a{b1, b2, omb1, omb2, bc1, bc2, eps, eps_root, wd, neg_lr,
                max_norm};
  adamw_kernel<<<grid_for(n, kThreads, 4 * sm_count()), kThreads, 0, st>>>(
      (float*)p, (const float*)g, (float*)mu, (float*)nu, n,
      (const float*)part, n_part, a);
  return (int)cudaGetLastError();
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
