// K17-K19: the three gather probes, lookups from on-chip memory.
//
// Replace the Pallas probes of exp_pallas_gather.py (TPU in-VMEM gathers):
// K17 `probe_axis1` (pallas_call :66), K18 `probe_axis0_rows` (:96), K19
// `probe_select32` (:132). No task calls them: they measure how fast a
// kernel can look up a table it holds on chip.
//
//   K17  out[r, n] = sum_{i<reps} tab[r, (idx[r, n] + i) % L]   tab (R, L)
//   K18  out[p, c] = sum_{i<reps} tab[(rows[p] + i) % R, c]     tab (R, 32)
//   K19  out[p]    = sum_{i<reps} T[p, (dy[p] + i) % 32]          T (P, 32)
//
// int32 values and int32 sums with wraparound (added as unsigned), as the
// Pallas kernels' int32 adds give them; the plain versions
// (tools/gather_probe.py) wrap the same way, so the outputs are equal.
//
// What bounds them on the card: the lookups, not device memory. Each
// input is read once at best (a 4 MB table at most), while every lookup is
// an index computation and a load from shared memory, L1 or L2.
//
// K17: a warp takes 32 columns n of a row at a time and reads each
// column's window (idx + i) % L, i < reps, 32 consecutive entries an
// instruction (lane l the entry i = 32 q + l): one load is 32 lookups on
// consecutive addresses, conflict-free in shared memory, one or two
// 128-byte lines in L1/L2. The wrap is one compare and subtract a load
// (the window's start advances by 32 and wraps once a load; L < 32 takes a
// modulo a lookup). Each lane keeps 32 partial sums, one a column, in
// registers, and a transpose reduction (31 shuffles) leaves column l's
// sum in lane l. The first design (a thread 4 columns, a % L a lookup, 8
// blocks of a row each staging the whole row, 64 blocks on 132 SMs)
// issued ~20 instructions a lookup. Two lanes by L, chosen on the card
// (tools/trace_gather_ab.py --variants): a row of L <= kStageMaxL is
// staged in shared memory by one block an SM (floor(SMs / R) blocks a
// row, each staging it once with 16-byte loads where aligned); a longer
// row is read through L1/L2, where the lookups read about as many bytes
// as the copies would (at L = 32K the copies of 128 blocks, 16.8 MB from
// L2, cost more than the lookups saved). Sharing one copy of a row over
// a thread-block cluster (multicast bulk copies into 2 or 8 blocks) was
// measured slower at every probe size and dropped.
//
// K18's table does not fit a block at either probe size (R = 4K is 512 KB,
// R = 32K 4 MB), so it is read through L1/L2, a warp a lookup row p. Its
// window is reps consecutive table rows (wrapping at R), walked in order
// 4 rows an instruction: lane l reads row 4 q + l / 8 of the window,
// columns 4 (l % 8) .. 4 (l % 8) + 3, one 16-byte load (four 4-byte loads
// where the table's base is off 16 bytes), so a load is 512 consecutive
// bytes unless it wraps. A lane's row advances by 4 a load with one
// compare and subtract (a modulo a load only where R < 4); kRowsUnroll
// loads a lane are issued before any is summed. Each lane keeps four
// partial sums, one a column of its group; two xor-shuffle levels (8, 16)
// add the four rows of a group and lanes 0-7 store the 128-byte output
// row, 16 bytes each. The first design (lane c column c, a runtime % R and
// one 128-byte load a lookup, each feeding the sum before the next) had
// about one load a warp in flight. A lane that staged each block's
// windows in shared memory (a block an SM, the p whose window starts in
// its bucket of rows listed while the copies flew) was slower at R = 4K,
// as fast at 32K, and 45x slower when every window starts in one bucket:
// dropped (tools/trace_gather_ab.py --variants).
//
// K19 keeps each 32-wide row in the registers of one warp (a lane a
// column) and picks a column with a warp shuffle, the register-file
// counterpart of the Pallas 5-level select tree. The lanes split the
// lookups: in round m lane l takes i = 32 m + (l + m) % 32 below reps, a
// shuffle of column (dy + i) % 32, and five xor-shuffle levels add the
// warp. The rotation gives a lane a new column each round: with i = 32 m
// + l a lane's column repeats every round and ptxas merged the repeats
// (one shuffle for four rounds), reading a column once for several
// lookups. The first design had every lane take all reps shuffles, the
// warp doing 32 times the work, one shuffle waiting on the last.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStageMaxL = 16384;          // the longest staged row (64 KB)
constexpr int kWarpsStaged = 16;           // warps a block, staged lane
constexpr int kWarpsDirect = 8;            // warps a block, L1/L2 lane
constexpr int kRowsWarps = 8;              // K18: warps (rows p) a block
constexpr int kRowsUnroll = 8;             // K18: loads a lane in flight
constexpr int kSelectWarps = 8;            // K19: warps (rows p) a block
// a level of the transpose reduction: lanes with bit OFF keep v[OFF..2 OFF)
// and take their partner's, the others keep v[0..OFF); a template, so
// every index is a constant and v stays in registers
template <int OFF>
__device__ __forceinline__ void transpose_level(unsigned (&v)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const unsigned send = upper ? v[i] : v[i + OFF];
    const unsigned keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if constexpr (OFF > 1) transpose_level<OFF / 2>(v, lane);
}

// lane l of the warp ends with the sum over the warp's lanes of v[l]
__device__ __forceinline__ unsigned transpose_sum(unsigned (&v)[32],
                                                  int lane) {
  transpose_level<16>(v, lane);
  return v[0];
}

// grid (blocks a row, R): STAGED copies row r into shared memory first,
// else the row is read through L1/L2; each warp then takes groups of 32
// columns, strided over the row's blocks
template <bool STAGED>
__global__ void axis1_kernel(const int* __restrict__ tab,
                             const int* __restrict__ idx,
                             int* __restrict__ out, int L, int N, int reps) {
  extern __shared__ int4 row_s4[];
  int* rs = (int*)row_s4;
  const int r = blockIdx.y;
  const int* row = tab + (long long)r * L;
  if (STAGED) {
    if ((((uintptr_t)row) & 15) == 0) {
      const int n4 = L >> 2;
      for (int i = threadIdx.x; i < n4; i += blockDim.x)
        row_s4[i] = __ldg((const int4*)row + i);
      for (int i = (n4 << 2) + threadIdx.x; i < L; i += blockDim.x)
        rs[i] = row[i];
    } else {
      for (int i = threadIdx.x; i < L; i += blockDim.x) rs[i] = row[i];
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int full = reps >> 5, rem = reps & 31;
  for (long long n0 = ((long long)blockIdx.x * warps + (threadIdx.x >> 5)) * 32;
       n0 < N; n0 += (long long)gridDim.x * warps * 32) {
    const long long n = n0 + lane;
    const int mine = n < N ? idx[(long long)r * N + n] : 0;
    unsigned acc[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] = 0u;
    if (L >= 32) {
      // lane l: its own column's window start, advanced 32 a load
      int kw = mine;                         // in [0, L)
      for (int q = 0; q < full; ++q) {
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          int k = __shfl_sync(0xffffffffu, kw, c) + lane;
          if (k >= L) k -= L;
          acc[c] += (unsigned)(STAGED ? rs[k] : __ldg(row + k));
        }
        kw += 32;
        if (kw >= L) kw -= L;
      }
      if (rem > 0) {
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          int k = __shfl_sync(0xffffffffu, kw, c) + lane;
          if (k >= L) k -= L;
          if (lane < rem)
            acc[c] += (unsigned)(STAGED ? rs[k] : __ldg(row + k));
        }
      }
    } else {                                 // a modulo a lookup
      for (int i0 = 0; i0 < reps; i0 += 32) {
        const int i = i0 + lane;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          const int k = (__shfl_sync(0xffffffffu, mine, c) + i) % L;
          if (i < reps)
            acc[c] += (unsigned)(STAGED ? rs[k] : __ldg(row + k));
        }
      }
    }
    const unsigned s = transpose_sum(acc, lane);
    if (n < N) out[(long long)r * N + n] = (int)s;
  }
}

// K18's 16-byte (VEC) or four 4-byte loads of table row k, columns
// 4 g .. 4 g + 3
template <bool VEC>
__device__ __forceinline__ uint4 row_quad(const int* __restrict__ tab,
                                          int k, int g) {
  const int* q = tab + (long long)k * 32 + 4 * g;
  if (VEC) {
    const int4 v = __ldg((const int4*)q);
    return make_uint4(v.x, v.y, v.z, v.w);
  }
  return make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
}

// a warp a lookup row p (MOD: R < 4, a modulo a load)
template <bool VEC, bool MOD>
__global__ void __launch_bounds__(32 * kRowsWarps)
rows_kernel(const int* __restrict__ tab, const int* __restrict__ rows,
            int* __restrict__ out, int R, int P, int reps) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
  if (p >= P) return;                     // whole warps leave together
  const int sub = lane >> 3, g = lane & 7;
  int k = rows[p] % R;
  if (k < 0) k += R;                      // the plain version's modulo
  // this lane's row of the window: 4 q + sub past the start
  k += sub;
  if (MOD) k %= R;
  else if (k >= R) k -= R;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int left = reps; left > 0; left -= 4 * kRowsUnroll) {
    uint4 v[kRowsUnroll];
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) {
      v[u] = 4 * u + sub < left ? row_quad<VEC>(tab, k, g)
                                : make_uint4(0u, 0u, 0u, 0u);
      k += 4;
      if (MOD) k %= R;
      else if (k >= R) k -= R;
    }
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) {
      acc.x += v[u].x;
      acc.y += v[u].y;
      acc.z += v[u].z;
      acc.w += v[u].w;
    }
  }
  // the four rows of a column group added; lanes 0-7 store the row
#pragma unroll
  for (int off = 8; off <= 16; off <<= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
  }
  if (sub == 0) ((uint4*)(out + p * 32))[g] = acc;
}

// a warp a row p: lane c holds T[p, c]; in round m lane l looks up i =
// 32 m + (l + m) % 32
__global__ void __launch_bounds__(32 * kSelectWarps)
select32_kernel(const int* __restrict__ T, const int* __restrict__ dy,
                int* __restrict__ out, int P, int reps) {
  const int lane = threadIdx.x & 31;
  const long long p =
      (long long)blockIdx.x * kSelectWarps + (threadIdx.x >> 5);
  if (p >= P) return;                     // whole warps leave together
  const int v = T[p * 32 + lane];
  const unsigned d = (unsigned)dy[p];
  unsigned acc = 0u;
  // every lane shuffles in every round (a full mask); lanes past the
  // last lookup drop what they got
  unsigned m = 0u;
  for (int left = reps; left > 0; left -= 32, ++m) {
    const unsigned j = (lane + m) & 31u;  // i = 32 m + j
    const int got = __shfl_sync(0xffffffffu, v, (d + j) & 31u);
    if ((int)j < left) acc += (unsigned)got;
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[p] = (int)acc;
}

}  // namespace

// tab (R, L) int32, idx (R, N) int32 in [0, L) -> out (R, N) int32
extern "C" int p3d_gather_axis1(const void* tab, const void* idx, void* out,
                                int R, int L, int N, int reps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (R < 1 || R > 65535 || L < 1 || N < 1 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const long long groups = (N + 31LL) / 32;        // 32 columns a warp
  if (L <= kStageMaxL) {
    int dev = 0, sms = 0;
    const size_t smem = sizeof(int) * (size_t)L;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(axis1_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    // a block an SM: each block of a row stages the row once
    const long long per_row = std::max(
        1LL, std::min((long long)(sms / R),
                      (groups + kWarpsStaged - 1) / kWarpsStaged));
    axis1_kernel<true><<<dim3((unsigned)per_row, (unsigned)R),
                         32 * kWarpsStaged, smem, s>>>(
        (const int*)tab, (const int*)idx, (int*)out, L, N, reps);
  } else {
    const long long per_row = (groups + kWarpsDirect - 1) / kWarpsDirect;
    axis1_kernel<false><<<dim3((unsigned)per_row, (unsigned)R),
                          32 * kWarpsDirect, 0, s>>>(
        (const int*)tab, (const int*)idx, (int*)out, L, N, reps);
  }
  return (int)cudaGetLastError();
}

// 1 when p3d_gather_axis1 stages a row of length L in shared memory
extern "C" int p3d_gather_axis1_staged(int L) {
  return L <= kStageMaxL ? 1 : 0;
}

// tab (R, 32) int32, rows (P,) int32 -> out (P, 32) int32 (16-byte
// aligned, as torch.empty gives it)
extern "C" int p3d_gather_rows(const void* tab, const void* rows, void* out,
                               int R, int P, int reps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (R < 1 || P < 1 || reps < 0 || (((uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((P + kRowsWarps - 1LL) / kRowsWarps);
  const bool vec = (((uintptr_t)tab) & 15) == 0;
  auto kernel = vec ? (R < 4 ? rows_kernel<true, true>
                             : rows_kernel<true, false>)
                    : (R < 4 ? rows_kernel<false, true>
                             : rows_kernel<false, false>);
  kernel<<<blocks, 32 * kRowsWarps, 0, s>>>(
      (const int*)tab, (const int*)rows, (int*)out, R, P, reps);
  return (int)cudaGetLastError();
}

// T (P, 32) int32, dy (P,) int32 -> out (P,) int32
extern "C" int p3d_gather_select32(const void* T, const void* dy, void* out,
                                   int P, int reps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (P < 1 || reps < 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((P + kSelectWarps - 1LL) / kSelectWarps);
  select32_kernel<<<blocks, 32 * kSelectWarps, 0, s>>>(
      (const int*)T, (const int*)dy, (int*)out, P, reps);
  return (int)cudaGetLastError();
}
