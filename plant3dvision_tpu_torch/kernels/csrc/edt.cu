// K2 signed distance: the capped separable squared EDT in two launches, the
// first axis by a march along x, the other two fused in shared memory.
//
// Replaces plant3dvision_tpu/ops/edt.py:_minplus_pass / squared_edt /
// signed_distance (ops/edt.py:31-48, 66-78, 85-97).
//
// Semantics kept exactly (not Felzenszwalb's exact envelope, so the whole
// volume stays bit-equal to the JAX package): per axis a windowed min-plus
//     F'[i] = min(F[i], min_{s=1..c} min(F[i+s], F[i-s]) + s^2),
// c = min(cap, n_axis - 1), out-of-range neighbours skipped (JAX fills them
// with INF, which never wins), INF = f32(1e12). Every value is either INF
// or an integer sum s0^2 + s1^2 + s2^2 (the minimum includes F[i] <= INF,
// and INF + s^2 rounds to >= INF), so the order of the minima is free and
// any exact integer method gives the same bits.
//
// What bounds it on the card: the windowed min-plus's operations, ~4c f32
// operations per element, axis and channel (~0.08 ms on the ML grid at
// c = 20); the bytes (the volume in, the signed distance out) are 8 a voxel.
// The design does less work than that count:
//
// - Launch 1 (edt_x_kernel), the first axis in O(1) a voxel. Its input is
//   binary ({0, INF} per channel), so its min-plus is d^2, d the distance
//   along x to the nearest voxel of the other state, when d <= c0, else INF
//   (the voxel's own channel is 0). A thread marches along one x column
//   (threads on consecutive columns: coalesced) in chunks of kXChunk:
//   forward to find each voxel's left distance, kept in shared memory (the
//   last voxel of each state carried from chunk to chunk), then a look
//   ahead past the chunk, at most c0 and only until both states are seen,
//   and backward for the right one. Both channels leave as one word.
// - Launch 2 (edt_yz_kernel), axes y and z fused. A block owns an x-plane,
//   ty rows and whole z rows: the y pass (its rows' c1 halo read through
//   L1/L2) fills G in shared memory, then the z pass reads G and the
//   epilogue (sqrt and the signed combine where(dist > 0.5, dist - 0.5,
//   -mdist + 0.5), or the squared distance) fills an output tile that is
//   stored coalesced. With whole rows no column of G is computed twice (a
//   tile of 64 columns would compute its c2 halo too: 1.6x the y pass at
//   cap 20). A z row too long for one row of G and its tile in shared
//   memory (~29000 voxels in Lane16, ~19000 in Lane32) keeps G in a global
//   buffer instead and stores its outputs directly: the same passes.
// - Each thread of a pass keeps kR consecutive outputs and a ring of kR
//   inputs in registers (`window`): one load a step for kR candidates.
// - Two lanes, by range. Lane16 when c0^2 + c1^2 + c2^2 < 16384: both
//   channels as int16 halves of one 32-bit word, INF as the sentinel 16384;
//   every value is <= 16384 and every shift <= 127^2, so a sum never passes
//   32767, and one Hopper DPX instruction, __viaddmin_s16x2 (VIADDMNMX,
//   min(a + b, c) a halfword), is the min-plus step of both channels; kR =
//   16. Otherwise Lane32: the float32 pair and the plain version's own
//   arithmetic (fminf(acc, a + s^2)), exact for every cap and grid; kR = 8.
//
// On the ML grid at cap 20 that is 82 DPX instructions a voxel (41 a pass),
// 31 M warp instructions, which the loads, bound tests and the occupancy of
// 65 KB blocks keep from the DPX unit's peak (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e12f;
constexpr int kSent16 = 16384;       // Lane16's INF
constexpr int kFar = 1 << 30;        // "no voxel of that state seen"
constexpr unsigned kNone = 0xffffffffu;  // "none ahead within c0"
constexpr int kXThreads = 128;       // columns a block of launch 1
constexpr int kXChunk = 192;         // x positions a chunk (48 KB)
constexpr int kBefore = 0x7fff;      // the other state last seen before the chunk
constexpr int kYZThreads = 256;
constexpr int kMaxSmem = 232448;     // 227 KB a block on sm_90

struct Lane16 {
  using Word = unsigned int;          // channel a low, channel b high
  using Step = unsigned int;
  static constexpr int kR = 16;       // outputs a thread, along its pass
  static __device__ __forceinline__ Word sent() { return 0x40004000u; }
  static __device__ __forceinline__ Word first(bool in, int d, int c) {
    const unsigned v = d <= c ? (unsigned)(d * d) : (unsigned)kSent16;
    return in ? v : v << 16;
  }
  static __device__ __forceinline__ Step step(int t) {
    return (unsigned)(t * t) * 0x00010001u;
  }
  static __device__ __forceinline__ Word addmin(Word w, Step s, Word acc) {
    return __viaddmin_s16x2(w, s, acc);
  }
  static __device__ __forceinline__ float decode(unsigned h) {
    return h == (unsigned)kSent16 ? kInf : (float)h;
  }
  static __device__ __forceinline__ float a(Word w) {
    return decode(w & 0xffffu);
  }
  static __device__ __forceinline__ float b(Word w) { return decode(w >> 16); }
};

struct Lane32 {
  using Word = float2;                // (channel a, channel b)
  using Step = float;
  static constexpr int kR = 8;
  static __device__ __forceinline__ Word sent() { return {kInf, kInf}; }
  static __device__ __forceinline__ Word first(bool in, int d, int c) {
    const float v = d <= c ? (float)((long long)d * d) : kInf;
    return in ? make_float2(v, 0.0f) : make_float2(0.0f, v);
  }
  static __device__ __forceinline__ Step step(int t) {
    return (float)((long long)t * t);
  }
  static __device__ __forceinline__ Word addmin(Word w, Step s, Word acc) {
    return {fminf(acc.x, __fadd_rn(w.x, s)), fminf(acc.y, __fadd_rn(w.y, s))};
  }
  static __device__ __forceinline__ float a(Word w) { return w.x; }
  static __device__ __forceinline__ float b(Word w) { return w.y; }
};

// Launch 1. One thread an x column (col = y * nz + z). `nonzero`: the
// voxel is "in" where v != 0 (squared_edt), else where v > 0.5. Channel a
// is the distance of an in voxel to the nearest out voxel (0 for out
// voxels), channel b the reverse. Shared memory: a chunk's 16-bit entries
// (the left distance when the other state was last seen inside the chunk,
// else kBefore, and the state in the top bit), (chunk, thread) so that a
// warp's entries are adjacent. Distances are unsigned, at most c0 + 1
// where the other state is farther (or nowhere).
template <class L>
__global__ void __launch_bounds__(kXThreads)
edt_x_kernel(const float* __restrict__ vol, typename L::Word* __restrict__ out,
             int nx, long long ncol, int c0, int nonzero, int chunk) {
  extern __shared__ unsigned short left_of[];
  const long long col = (long long)blockIdx.x * kXThreads + threadIdx.x;
  if (col >= ncol) return;
  unsigned short* mine = left_of + threadIdx.x;
  const float* v = vol + col;
  auto inside = [&](int i) {
    const float x = __ldg(v + (long long)i * ncol);
    return nonzero ? x != 0.0f : x > 0.5f;
  };
  int last_in = -kFar, last_out = -kFar;     // carried from chunk to chunk
  for (int x0 = 0; x0 < nx; x0 += chunk) {
    const int x1 = min(nx, x0 + chunk);
    // from x0 back to the last voxel of each state before the chunk
    const unsigned back_in =
        (unsigned)min((long long)x0 - last_in, (long long)c0 + 1);
    const unsigned back_out =
        (unsigned)min((long long)x0 - last_out, (long long)c0 + 1);
    // forward: each voxel's left distance
    for (int i0 = x0; i0 < x1; i0 += 8) {
      bool ins[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) ins[k] = i0 + k < x1 && inside(i0 + k);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k;
        if (i >= x1) break;
        const bool in = ins[k];
        const int other = in ? last_out : last_in;
        mine[(i - x0) * kXThreads] = (unsigned short)(
            (other >= x0 ? i - other : kBefore) | (in ? 0x8000 : 0));
        last_in = in ? i : last_in;
        last_out = in ? last_out : i;
      }
    }
    // ahead: the first voxel of each state past the chunk, within c0
    unsigned next_in = kNone, next_out = kNone;
    const int end = (int)min((long long)nx, (long long)x1 + c0);
    for (int i0 = x1; i0 < end && (next_in == kNone || next_out == kNone);
         i0 += 8) {
      bool ins[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) ins[k] = i0 + k < end && inside(i0 + k);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k;
        if (i >= end) break;
        next_in = ins[k] && next_in == kNone ? i : next_in;
        next_out = !ins[k] && next_out == kNone ? i : next_out;
      }
    }
    // backward: the right distance, and the word
    for (int i1 = x1; i1 > x0; i1 -= 8) {
      unsigned es[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        es[k] = i1 - 1 - k >= x0 ? mine[(i1 - 1 - k - x0) * kXThreads] : 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i1 - 1 - k;
        if (i < x0) break;
        const bool in = (es[k] & 0x8000u) != 0;
        const unsigned l = es[k] & kBefore;
        const unsigned left =
            l != kBefore ? l : (unsigned)(i - x0) + (in ? back_out : back_in);
        const unsigned d = min(left, (in ? next_out : next_in) - (unsigned)i);
        out[(long long)i * ncol + col] =
            L::first(in, (int)min(d, (unsigned)c0 + 1u), c0);
        next_in = in ? i : next_in;
        next_out = in ? next_out : i;
      }
    }
  }
}

// L::kR consecutive outputs of one windowed min-plus pass: output r is
// min_{|t| <= c} in[r + t] + t^2, where load(k) = in[k - c] (k = 0 .. 2c +
// kR - 1). The ring holds in[t .. t + kR - 1] at step t, slot (j + r) % kR
// for output r at step t = s + j, so each step loads one input and makes
// kR candidates; the last group of steps (at most kR) is peeled off, so
// the others test nothing.
template <class L, class Load>
__device__ __forceinline__ void window(const Load& load, int c,
                                       typename L::Word (&acc)[L::kR]) {
  constexpr int R = L::kR;
  typename L::Word ring[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = L::sent();
    ring[r] = load(r);
  }
  int s = -c;
  for (; s + R - 1 < c; s += R) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const typename L::Step sq = L::step(s + j);
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = L::addmin(ring[(j + r) % R], sq, acc[r]);
      ring[j] = load(s + j + c + R);
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int t = s + j;
    if (t <= c) {
      const typename L::Step sq = L::step(t);
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = L::addmin(ring[(j + r) % R], sq, acc[r]);
      if (t < c) ring[j] = load(t + c + R);
    }
  }
}

// Launch 2. Block b: y tile b % tiles_y (ty rows), x-plane b / tiles_y;
// the block takes whole z rows, so no column of G is computed twice. The y
// pass reads its rows' c1 halo from global memory (L1/L2) into G (ty rows
// of gp words, gp odd so that the z pass's rows fall in distinct banks),
// the z pass reads G, and the epilogue fills the output tile O (ty rows of
// tz + 1 floats, tz = nz rounded up to kR) that is stored coalesced. With
// kSpill G is the block's rows in `spill` (a buffer shaped as `words`,
// gp = nz) and the outputs go straight to `out`. mode 0: the signed
// distance; 1: channel a, squared.
template <class L, bool kSpill>
__global__ void __launch_bounds__(kYZThreads)
edt_yz_kernel(const typename L::Word* __restrict__ words,
              float* __restrict__ out, typename L::Word* __restrict__ spill,
              int ny, int nz, int c1, int c2, int ty, int tiles_y, int mode) {
  using W = typename L::Word;
  constexpr int R = L::kR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int x = blockIdx.x / tiles_y;
  const int y0 = (blockIdx.x % tiles_y) * ty;
  const int tz = (nz + R - 1) / R * R, op = tz + 1;
  const int gp = kSpill ? nz : nz | 1;
  const W* plane = words + (long long)x * ny * nz;
  W* G;
  if constexpr (kSpill)
    G = spill + ((long long)x * ny + y0) * nz;
  else
    G = reinterpret_cast<W*>(smem);
  float* O = reinterpret_cast<float*>(
      smem + (((size_t)ty * gp * sizeof(W) + 15) & ~(size_t)15));

  // the y pass: R rows of one column a thread
  const int groups = (ty + R - 1) / R;
  for (int it = threadIdx.x; it < groups * nz; it += kYZThreads) {
    const int z = it % nz;
    const int yf = y0 + (it / nz) * R;
    W acc[R];
    window<L>(
        [&](int k) -> W {
          const int row = yf - c1 + k;
          return row >= 0 && row < ny ? plane[(long long)row * nz + z]
                                      : L::sent();
        },
        c1, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (yf - y0 + r < ty && yf + r < ny) G[(yf - y0 + r) * gp + z] = acc[r];
  }
  __syncthreads();

  // the z pass: R columns of one row a thread, and the epilogue
  for (int it = threadIdx.x; it < ty * (tz / R); it += kYZThreads) {
    const int yy = it % ty;
    const int zf = (it / ty) * R;
    if (y0 + yy >= ny) continue;
    const W* grow = G + yy * gp;
    W acc[R];
    window<L>(
        [&](int k) -> W {
          const int z = zf - c2 + k;
          return z >= 0 && z < nz ? grow[z] : L::sent();
        },
        c2, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v;
      if (mode == 0) {
        const float dist = __fsqrt_rn(fminf(L::a(acc[r]), kInf));
        const float mdist = __fsqrt_rn(fminf(L::b(acc[r]), kInf));
        v = dist > 0.5f ? __fsub_rn(dist, 0.5f) : __fadd_rn(-mdist, 0.5f);
      } else {
        v = L::a(acc[r]);
      }
      if constexpr (!kSpill)
        O[yy * op + zf + r] = v;
      else if (zf + r < nz)
        out[((long long)x * ny + y0 + yy) * nz + zf + r] = v;
    }
  }
  if constexpr (kSpill) return;
  __syncthreads();

  for (int e = threadIdx.x; e < ty * nz; e += kYZThreads) {
    const int yy = e / nz, z = e - yy * nz;
    if (y0 + yy < ny)
      out[((long long)x * ny + y0 + yy) * nz + z] = O[yy * op + z];
  }
}

template <class L>
cudaError_t launch_x(const float* vol, void* words, int nx, int ny, int nz,
                     int c0, int nonzero, cudaStream_t st) {
  const long long ncol = (long long)ny * nz;
  const int chunk = nx < kXChunk ? nx : kXChunk;
  const long long blocks = (ncol + kXThreads - 1) / kXThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  edt_x_kernel<L><<<(unsigned)blocks, kXThreads,
                    sizeof(unsigned short) * chunk * kXThreads, st>>>(
      vol, static_cast<typename L::Word*>(words), nx, ncol, c0, nonzero,
      chunk);
  return cudaGetLastError();
}

// The block's shared memory at ty rows: G and the output tile.
template <class L>
size_t yz_smem(int nz, int ty) {
  const int tz = (nz + L::kR - 1) / L::kR * L::kR;
  return (((size_t)ty * (nz | 1) * sizeof(typename L::Word) + 15) &
          ~(size_t)15) +
         (size_t)ty * (tz + 1) * sizeof(float);
}

// Whether a z row of nz is too long for one row of G and its tile in
// shared memory, so that launch 2 needs its spill buffer.
template <class L>
bool yz_spills(int nz) {
  return yz_smem<L>(nz, 1) > (size_t)kMaxSmem;
}

// The block's rows: kR (the pass's outputs a thread), or fewer where a z
// row is long; kR rows with G in `spill` where one row does not fit.
template <class L>
cudaError_t launch_yz(const void* words, float* out, void* spill, int nx,
                      int ny, int nz, int c1, int c2, int mode,
                      cudaStream_t st) {
  constexpr int R = L::kR;
  using W = typename L::Word;
  const bool spills = yz_spills<L>(nz);
  if (spills && !spill) return cudaErrorInvalidValue;
  int ty = R;
  while (!spills && yz_smem<L>(nz, ty) > (size_t)kMaxSmem) ty /= 2;
  const size_t smem = spills ? 0 : yz_smem<L>(nz, ty);
  const int tiles_y = (ny + ty - 1) / ty;
  const long long blocks = (long long)tiles_y * nx;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const W* w = static_cast<const W*>(words);
  if (spills) {
    edt_yz_kernel<L, true><<<(unsigned)blocks, kYZThreads, 0, st>>>(
        w, out, static_cast<W*>(spill), ny, nz, c1, c2, ty, tiles_y, mode);
    return cudaGetLastError();
  }
  cudaError_t e = cudaFuncSetAttribute(
      edt_yz_kernel<L, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  edt_yz_kernel<L, false><<<(unsigned)blocks, kYZThreads, smem, st>>>(
      w, out, nullptr, ny, nz, c1, c2, ty, tiles_y, mode);
  return cudaGetLastError();
}

bool bad_args(int nx, int ny, int nz, int c, int mode) {
  return nx < 1 || ny < 1 || nz < 1 || c < 0 || (mode != 0 && mode != 1);
}

}  // namespace

// Launch 1: vol (nx, ny, nz) float32 -> words (nx, ny, nz) of the lane
// (wide 0: Lane16, 32-bit words; 1: Lane32, float2). nonzero 0: in = v >
// 0.5 (signed distance); 1: in = v != 0 (squared EDT). c0 = min(cap, nx -
// 1).
extern "C" int p3d_edt_x(const void* vol, void* words, int nx, int ny, int nz,
                         int c0, int nonzero, int wide, void* stream) {
  if (bad_args(nx, ny, nz, c0, nonzero) || c0 > nx - 1 ||
      (!wide && c0 > 127))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* v = (const float*)vol;
  return (int)(wide ? launch_x<Lane32>(v, words, nx, ny, nz, c0, nonzero, st)
                    : launch_x<Lane16>(v, words, nx, ny, nz, c0, nonzero, st));
}

// Launch 2: words -> out (nx, ny, nz) float32: mode 0 the signed distance,
// mode 1 the squared distance of channel a. c1, c2 = min(cap, n - 1) of
// axes y and z; Lane16 needs c0^2 + c1^2 + c2^2 < 16384 (the wrapper's
// choice, ops/edt.py:lane16). spill: a buffer shaped as words where
// p3d_edt_yz_spills(nz, wide), else ignored (may be null).
extern "C" int p3d_edt_yz(const void* words, void* out, void* spill, int nx,
                          int ny, int nz, int c1, int c2, int mode, int wide,
                          void* stream) {
  if (bad_args(nx, ny, nz, c1 < c2 ? c1 : c2, mode) || c1 > ny - 1 ||
      c2 > nz - 1 || (!wide && (c1 > 127 || c2 > 127)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  return (int)(wide ? launch_yz<Lane32>(words, o, spill, nx, ny, nz, c1, c2,
                                        mode, st)
                    : launch_yz<Lane16>(words, o, spill, nx, ny, nz, c1, c2,
                                        mode, st));
}

// 1 where a z row of nz in lane `wide` does not fit in shared memory and
// p3d_edt_yz needs its spill buffer, else 0.
extern "C" int p3d_edt_yz_spills(int nz, int wide) {
  return wide ? (int)yz_spills<Lane32>(nz) : (int)yz_spills<Lane16>(nz);
}
