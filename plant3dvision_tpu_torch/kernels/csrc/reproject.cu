// K7 reproject: per-label mask votes of a point cloud, summed over mask files.
//
// Replaces plant3dvision_tpu/ops/reproject.py:score_points_by_masks (the
// jitted scan behind SegmentedPointCloud). Per point n and mask file f, in
// file order: p = R_f p_n + t_f; pz = max(p2, 1e-9); the pixel is
// (trunc(p0/pz*fx + cx), trunc(p1/pz*fy + cy)); if p2 > 0 and the pixel is
// in the frame, scores[n, label_idx[f]] += mask_f[py, px] / 255.
//
// What bounds it on the card: per point-file pair ~20 f32 operations of
// projection and one byte read from the file's mask. The least work is that
// arithmetic over all pairs (operations), against the points and cameras read
// once, the scores written once and the distinct mask bytes the in-frame
// pairs touch (bytes). Segmentation2D writes its files image-major with the
// image's camera on each label's file, so the L files of a view hold one
// camera: projecting once a camera run (a stretch of consecutive files whose
// 16 floats are equal bit for bit) leaves ~1/L of the projections.
//
// Design: a block owns P = 256 points (a thread each) and walks the files in
// chunks of FC = 64. First the block orders its points by their pixel in
// file 0 (a bitonic sort of 256 keys in shared memory): the points come in
// C order of their voxels, so a warp's 32 would lie along one z column
// and touch ~18 32-byte sectors a gather; in pixel order ~9. The gathers
// hit L1 and L2 (the distinct mask bytes are a few MB), so their sectors,
// not HBM, are what they cost. For each chunk:
//   - the chunk's cameras are staged in shared memory, and the block finds
//     its camera runs (a file starts one where its row differs from the
//     file before it, or at the chunk's start) and, for each label, its
//     files in file order (warp ballots and one block-wide offset);
//   - phase 1: each thread projects its point once a run and reads the byte
//     of every file of the run at that pixel (0 out of frame) into a
//     [FC][P] byte table;
//   - phase 2: each thread walks each label's files in file order and adds
//     v / 255 (exact f32 division by three FMAs) to its register sum. The
//     sums carry across chunks.
// No atomics: every sum belongs to one thread and is taken in JAX's order
// (file order; adding 0 for a pair out of frame changes no sum), so the
// scores are bit-equal to JAX's whenever the pixels are. A run that crosses
// a chunk's edge is projected again in the next chunk, exactly.
//
// Exactness: XLA on the CPU compiles the projection with the carve's fused
// multiply-adds (tests/test_torch_reproject.py finds the pattern: 0 of
// 900,000 points projected next to a pixel edge land on another pixel):
//   p_j = fma(R_j2, z, fma(R_j1, y, R_j0*x)) + t_j
//   px  = fma(p0/pz, fx, cx)
// The library is built with -fmad=false, so nvcc adds no contraction of its
// own. The f32 -> int32 casts truncate and saturate, as XLA's do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kMinZ = 1e-9f;   // ops/reproject.py: jnp.maximum(p2, 1e-9)
constexpr unsigned kFull = 0xffffffffu;
constexpr int P = 256;           // points (and threads) a block
constexpr int FC = 64;           // files a chunk
constexpr int FW = FC / 32;      // warps that rank a chunk's files
static_assert(P >= FC && FC % 32 == 0 && FC <= 256, "layout");
static_assert((P & (P - 1)) == 0, "the sort takes a power of two");

__device__ __forceinline__ float dot3_add(const float* r, float x, float y,
                                          float z, float t) {
  return __fadd_rn(__fmaf_rn(r[2], z, __fmaf_rn(r[1], y, __fmul_rn(r[0], x))),
                   t);
}

// float32(v) / 255 correctly rounded (numpy's float32 mask / 255.0): the
// product with float32(1/255) and one fused correction, exact for every
// byte (tests/test_torch_reproject_runs.py)
__device__ __forceinline__ float div255(unsigned v) {
  const float r = 0.003921568859368563f;   // 0x3b808081
  const float x = (float)v;
  const float m = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-m, 255.0f, x), r, m);
}

// the flat pixel index of a point in a staged camera row, or -1 when it is
// behind the camera or out of frame:
// cam = [fx, fy, cx, cy, r00..r22 (row-major), t0, t1, t2]
__device__ __forceinline__ long long pixel(const float* cam, float x, float y,
                                           float z, int H, int W) {
  const float4 k = reinterpret_cast<const float4*>(cam)[0];
  const float4 a = reinterpret_cast<const float4*>(cam)[1];
  const float4 b = reinterpret_cast<const float4*>(cam)[2];
  const float4 c = reinterpret_cast<const float4*>(cam)[3];
  const float p0 = __fadd_rn(
      __fmaf_rn(a.z, z, __fmaf_rn(a.y, y, __fmul_rn(a.x, x))), c.y);
  const float p1 = __fadd_rn(
      __fmaf_rn(b.y, z, __fmaf_rn(b.x, y, __fmul_rn(a.w, x))), c.z);
  const float p2 = __fadd_rn(
      __fmaf_rn(c.x, z, __fmaf_rn(b.w, y, __fmul_rn(b.z, x))), c.w);
  if (!(p2 > 0.0f)) return -1;
  const float pz = p2 < kMinZ ? kMinZ : p2;
  const int px = __float2int_rz(__fmaf_rn(__fdiv_rn(p0, pz), k.x, k.z));
  const int py = __float2int_rz(__fmaf_rn(__fdiv_rn(p1, pz), k.y, k.w));
  if (px < 0 || px > W - 1 || py < 0 || py > H - 1) return -1;
  return (long long)py * W + px;
}

// a sort key of point n: its pixel in camera `cam` (global memory),
// row-major; behind the camera, out of frame or past N last
__device__ __forceinline__ unsigned long long sort_key(
    const float* __restrict__ points, const float* __restrict__ cam, int n,
    int N, int H, int W, int slot) {
  unsigned key = 0xffffffffu;
  if (n < N) {
    const float x = points[3LL * n], y = points[3LL * n + 1],
                z = points[3LL * n + 2];
    const float p2 = dot3_add(cam + 10, x, y, z, cam[15]);
    if (p2 > 0.0f) {
      const float u = __fmaf_rn(__fdiv_rn(dot3_add(cam + 4, x, y, z, cam[13]),
                                          p2), cam[0], cam[2]);
      const float v = __fmaf_rn(__fdiv_rn(dot3_add(cam + 7, x, y, z, cam[14]),
                                          p2), cam[1], cam[3]);
      if (u >= 0.0f && u < (float)W && v >= 0.0f && v < (float)H)
        key = (unsigned)(int)v * (unsigned)W + (unsigned)(int)u;
    }
  }
  return ((unsigned long long)key << 32) | (unsigned)slot;
}

template <int L>
__global__ void __launch_bounds__(P)
    reproject_kernel(const float* __restrict__ points,
                     const uint8_t* __restrict__ masks,
                     const float* __restrict__ cams,
                     const int* __restrict__ label_idx, int N, int F, int H,
                     int W, float* __restrict__ scores) {
  __shared__ __align__(16) float s_cam[FC][16];
  __shared__ uint8_t s_tab[FC][P];
  __shared__ uint8_t s_run[FC];        // run starts, chunk-relative
  __shared__ uint8_t s_list[L][FC];    // each label's files, in file order
  __shared__ int s_cnt[FW][L + 1];     // a warp's files of each label; runs
  __shared__ unsigned long long s_key[P];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n0 = blockIdx.x * P;
  int n = n0 + t;
  if (F > 0) {
    // the block's points in the order of their pixels in file 0: thread t
    // takes the t-th (t is its point's column of the table)
    s_key[t] = sort_key(points, cams, n, N, H, W, t);
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {          // bitonic sort of the keys
      for (int j = k >> 1; j > 0; j >>= 1) {
        if ((t ^ j) > t) {
          const unsigned long long a = s_key[t], b = s_key[t ^ j];
          if ((a > b) == ((t & k) == 0)) {
            s_key[t] = b;
            s_key[t ^ j] = a;
          }
        }
        __syncthreads();
      }
    }
    n = n0 + (int)(s_key[t] & 0xffffffffu);
  }
  const bool live = n < N;
  float x = 0.f, y = 0.f, z = 0.f;
  if (live) {
    x = points[3LL * n];
    y = points[3LL * n + 1];
    z = points[3LL * n + 2];
  }
  float acc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] = 0.0f;
  const long long hw = (long long)H * W;
  const unsigned below = (1u << lane) - 1;

  for (int f0 = 0; f0 < F; f0 += FC) {
    const int nf = min(FC, F - f0);
    // (this barrier also ends the last chunk's phase 2)
    for (int i = t; i < nf * 16; i += P)
      s_cam[i >> 4][i & 15] = cams[16LL * f0 + i];
    __syncthreads();

    // rank the chunk's run starts and each label's files
    bool start = false, valid = false;
    int lab = -1, rank = 0;
    unsigned runs = 0;
    if (t < FC) {
      if (t < nf) {
        lab = label_idx[f0 + t];
        valid = lab >= 0 && lab < L;
        start = t == 0;
        for (int w = 0; w < 16 && !start; ++w)
          start = __float_as_uint(s_cam[t][w]) !=
                  __float_as_uint(s_cam[t - 1][w]);
      }
      runs = __ballot_sync(kFull, start);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const unsigned b = __ballot_sync(kFull, valid && lab == l);
        if (lab == l) rank = __popc(b & below);
        if (lane == 0) s_cnt[warp][l] = __popc(b);
      }
      if (lane == 0) s_cnt[warp][L] = __popc(runs);
    }
    __syncthreads();
    if (t < nf) {
      int run_off = 0, lab_off = 0;
      for (int w = 0; w < warp; ++w) {
        run_off += s_cnt[w][L];
        if (valid) lab_off += s_cnt[w][lab];
      }
      if (start) s_run[run_off + __popc(runs & below)] = (uint8_t)t;
      if (valid) s_list[lab][lab_off + rank] = (uint8_t)t;
    }
    __syncthreads();
    int nruns = 0;
#pragma unroll
    for (int w = 0; w < FW; ++w) nruns += s_cnt[w][L];

    // phase 1: a projection a run; the byte of each of the run's files at
    // the point's pixel into the table
    if (live) {
      for (int r = 0; r < nruns; ++r) {
        const int fa = s_run[r];
        const int fb = r + 1 < nruns ? s_run[r + 1] : nf;
        const long long lin = pixel(s_cam[fa], x, y, z, H, W);
        if (lin >= 0) {
          const uint8_t* m = masks + (f0 + fa) * hw + lin;
          for (int f = fa; f < fb; ++f, m += hw) s_tab[f][t] = __ldg(m);
        } else {
          for (int f = fa; f < fb; ++f) s_tab[f][t] = 0;
        }
      }
    }
    __syncthreads();

    // phase 2: each label's files in file order
    if (live) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        int c = 0;
#pragma unroll
        for (int w = 0; w < FW; ++w) c += s_cnt[w][l];
#pragma unroll 4
        for (int i = 0; i < c; ++i)
          acc[l] = __fadd_rn(acc[l], div255(s_tab[s_list[l][i]][t]));
      }
    }
  }
  if (live) {
#pragma unroll
    for (int l = 0; l < L; ++l) scores[(long long)n * L + l] = acc[l];
  }
}

template <int L>
cudaError_t launch(const void* points, const void* masks, const void* cams,
                   const void* label_idx, int N, int F, int H, int W,
                   void* scores, cudaStream_t stream) {
  const int blocks = (N + P - 1) / P;
  reproject_kernel<L><<<blocks, P, 0, stream>>>(
      (const float*)points, (const uint8_t*)masks, (const float*)cams,
      (const int*)label_idx, N, F, H, W, (float*)scores);
  return cudaGetLastError();
}

}  // namespace

// points (N, 3) f32; masks (F, H, W) uint8; cams (F, 16) f32; label_idx (F,)
// int32; scores (N, L) f32 written whole. L is 1..8; a file whose label index
// is outside [0, L) adds nothing (JAX's one_hot of it is all zeros).
extern "C" int p3d_reproject(const void* points, const void* masks,
                             const void* cams, const void* label_idx, int N,
                             int F, int H, int W, int L, void* scores,
                             void* stream) {
  if (N == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define P3D_REP(NL)                                                         \
  case NL:                                                                  \
    return (int)launch<NL>(points, masks, cams, label_idx, N, F, H, W,      \
                           scores, s);
  switch (L) {
    P3D_REP(1)
    P3D_REP(2)
    P3D_REP(3)
    P3D_REP(4)
    P3D_REP(5)
    P3D_REP(6)
    P3D_REP(7)
    P3D_REP(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef P3D_REP
}
