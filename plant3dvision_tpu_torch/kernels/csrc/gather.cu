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
// a dependent index computation and a load from shared memory, L1 or L2.
//
// Where the tables live: K17 stages one table row per block in shared
// memory when the row fits a block (4 L bytes up to 227 KB, L <= 56K: the
// probe's L = 8K and 32K) and reads the row through L1/L2 (__ldg) when it
// does not (L = 128K, a 512 KB row of a 4 MB table). K18's table does not
// fit a block at either probe size (R = 4K is 512 KB, R = 32K 4 MB): a warp
// reads one 128-byte table row a lookup through L1/L2, all 32 lanes at
// once. K19 keeps each 32-wide row in the registers of one warp (a lane a
// column) and picks the column with a warp shuffle, the register-file
// counterpart of the Pallas 5-level select tree.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;   // 227 KB a block on sm_90

// grid (ceil(N / (threads * per)), R): block stages row r when smem, then
// each thread sums `per` columns n
template <bool kSmem>
__global__ void axis1_kernel(const int* __restrict__ tab,
                             const int* __restrict__ idx,
                             int* __restrict__ out, int L, int N, int reps,
                             int per) {
  extern __shared__ int row_s[];
  const int r = blockIdx.y;
  const int* row = tab + (long long)r * L;
  if (kSmem) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) row_s[i] = row[i];
    __syncthreads();
  }
  const long long n0 = (long long)blockIdx.x * blockDim.x * per;
  for (int j = 0; j < per; ++j) {
    const long long n = n0 + (long long)j * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const int base = idx[(long long)r * N + n];
    unsigned int acc = 0u;
    for (int i = 0; i < reps; ++i) {
      const int k = (base + i) % L;
      acc += (unsigned int)(kSmem ? row_s[k] : __ldg(row + k));
    }
    out[(long long)r * N + n] = (int)acc;
  }
}

// one warp per lookup row p: lane c sums column c
__global__ void rows_kernel(const int* __restrict__ tab,
                            const int* __restrict__ rows,
                            int* __restrict__ out, int R, int P, int reps) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p = t >> 5;
  const int c = (int)(t & 31);
  if (p >= P) return;
  const int base = rows[p];
  unsigned int acc = 0u;
  for (int i = 0; i < reps; ++i)
    acc += (unsigned int)__ldg(tab + (long long)((base + i) % R) * 32 + c);
  out[p * 32 + c] = (int)acc;
}

// one warp per row p: lane c holds T[p, c]; each step shuffles column
// (dy + i) % 32 to every lane
__global__ void select32_kernel(const int* __restrict__ T,
                                const int* __restrict__ dy,
                                int* __restrict__ out, int P, int reps) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p = t >> 5;
  const int lane = (int)(t & 31);
  if (p >= P) return;             // whole warps leave together (P * 32 threads)
  const int v = T[p * 32 + lane];
  const int d = dy[p];
  unsigned int acc = 0u;
  for (int i = 0; i < reps; ++i)
    acc += (unsigned int)__shfl_sync(0xffffffffu, v, (d + i) & 31);
  if (lane == 0) out[p] = (int)acc;
}

}  // namespace

// tab (R, L) int32, idx (R, N) int32 in [0, L) -> out (R, N) int32
extern "C" int p3d_gather_axis1(const void* tab, const void* idx, void* out,
                                int R, int L, int N, int reps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (R < 1 || L < 1 || N < 1 || reps < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256, per = 4;
  const dim3 grid((unsigned)((N + threads * per - 1) / (threads * per)),
                  (unsigned)R);
  const size_t smem = sizeof(int) * (size_t)L;
  if (smem <= (size_t)kMaxSmem) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          axis1_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    axis1_kernel<true><<<grid, threads, smem, s>>>(
        (const int*)tab, (const int*)idx, (int*)out, L, N, reps, per);
  } else {
    axis1_kernel<false><<<grid, threads, 0, s>>>(
        (const int*)tab, (const int*)idx, (int*)out, L, N, reps, per);
  }
  return (int)cudaGetLastError();
}

// 1 when p3d_gather_axis1 stages a row of length L in shared memory
extern "C" int p3d_gather_axis1_staged(int L) {
  return sizeof(int) * (size_t)L <= (size_t)kMaxSmem ? 1 : 0;
}

// tab (R, 32) int32, rows (P,) int32 in [0, R) -> out (P, 32) int32
extern "C" int p3d_gather_rows(const void* tab, const void* rows, void* out,
                               int R, int P, int reps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (R < 1 || P < 1 || reps < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long n = (long long)P * 32;
  rows_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      (const int*)tab, (const int*)rows, (int*)out, R, P, reps);
  return (int)cudaGetLastError();
}

// T (P, 32) int32, dy (P,) int32 in [0, 32) -> out (P,) int32
extern "C" int p3d_gather_select32(const void* T, const void* dy, void* out,
                                   int P, int reps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (P < 1 || reps < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long n = (long long)P * 32;
  select32_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      (const int*)T, (const int*)dy, (int*)out, P, reps);
  return (int)cudaGetLastError();
}
