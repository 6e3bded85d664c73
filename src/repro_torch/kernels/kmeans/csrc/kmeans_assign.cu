// K-Means assignment (nearest centroid) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `assign_pallas` (body `_kernel`) in
// src/repro/kernels/kmeans/kmeans.py, with its wrapper `_assign` in
// src/repro/kernels/kmeans/ops.py.  It computes what those compute, not
// the TPU's tiling: for each point p (f32) the index of the nearest
// centroid (the first index wins a tie) and the squared distance to it,
// as the least score s(c) = |c|^2 - 2 p.c plus |p|^2, added in f32 after
// the argmin as the reference's wrapper adds it.
//
// Two kernels.  `kmeans_assign_kernel<D, R>` scans a contiguous centroid
// range per block; `kmeans_merge_kernel` merges the ranges' partial
// (minimum, index) pairs when k is split across blocks.
//
// Design of the scan, for Hopper's SMs:
// - Register tiling: a thread holds R points (R = 4 for D <= 8, fewer for
//   wider D, to stay clear of spills), so each centroid read from shared
//   memory feeds R * D FMAs.  A block holds bn * R points.  R = 4 rather
//   than 8 at D = 3: the scan is bound by its instruction issue, not by its
//   shared loads, and the smaller R leaves room for more resident warps
//   (tools/k1_probe.py times both).
// - Packed centroids: a tile of bk centroids is staged in shared memory as
//   (-2 c_0, ..., -2 c_{D-1}, |c|^2), padded to whole float4s, and read
//   with 16-byte broadcast loads: one LDS.128 per centroid at D = 3.
//   Scaling by -2 is exact, and the score is a chain of D FMAs from |c|^2
//   in a fixed j order, so a pair's score does not depend on the tile or
//   the split.
// - Cheap argmin: centroids come in groups of KM_GROUP = 4.  For each
//   point a thread takes the fminf of a group's four scores and keeps,
//   branch-free, the best score and the first index of the group that
//   reached it (a strict `<`, so the earlier group wins a tie).  After the
//   scan it recomputes the winning group's scores with the same arithmetic
//   (branch-free, every load issued at once) and takes the first centroid
//   whose score equals the best: the index a strict `<` scan in index
//   order keeps.  A pair costs D FMAs, 3/4 fminf and 3/4 of a
//   compare-and-select, whatever the data: a per-point "rescan on
//   improvement" branch measured slower, since a warp holds 128 points and
//   nearly every warp takes it in every group of a short range.
// - k split across blocks where n alone cannot fill the card: the grid is
//   (point blocks, splits); split s scans the centroid groups
//   [s * G / splits, (s + 1) * G / splits) of G = ceil(k / 4), in tiles of
//   bk from the range's start.  Group boundaries are multiples of 4 in
//   every configuration, so every (bn, bk, splits) scores the same pairs
//   in the same groups.  With one split the block writes the result; with
//   more it writes a partial (minimum without |p|^2, index) to a (splits,
//   n) scratch that the merge kernel reduces in split order with a strict
//   `<` (the first index wins) before adding |p|^2.  Either way the result
//   is bitwise the same for every block size and split count.
//
// Bound on an H100 SXM: per (point, centroid) pair D FMAs and one compare
// or min, i.e. D + 1 FP32-pipe instructions, against 4 * D + 8 bytes moved
// per point (points read, index and distance written).  At the paper's
// shapes (D = 3) that is 4 instructions a pair at 4 warp-instructions per
// clock per SM: k = 500 and k = 5000 are bound by the FP32 pipe, and at
// 1M x 50 the pipe and the 20 MB of traffic are about even (~6 us each).
// The scan issues D FMAs and 1.5 more FP32-pipe instructions a pair (3/4
// fminf, 3/4 compare-and-select), so it cannot pass (D + 1) / (D + 1.5) of
// that bound: 89 % at D = 3.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KM_MAX_THREADS 512
#define KM_MAX_D 32
#define KM_SMEM_MAX 49152  // bytes of dynamic shared memory without opt-in
#define KM_GROUP 4         // centroids per argmin group; bk is a multiple
#define KM_MAX_SPLITS 65535

// points a thread holds at width d
__host__ __device__ constexpr int km_rows(int d) {
  return d <= 8 ? 4 : d <= 16 ? 2 : 1;
}

// float4s per packed centroid: ceil((d + 1) / 4)
__host__ __device__ constexpr int km_quads(int d) { return (d + 4) / 4; }

// |x|^2 in one fixed order; both kernels and the staging use it, so |p|^2
// and |c|^2 do not depend on which kernel computes them
__device__ __forceinline__ float sq_norm(const float* x, int d) {
  float s = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int j = 1; j < d; ++j) s = fmaf(x[j], x[j], s);
  return s;
}

template <int D, int R>
__global__ void __launch_bounds__(KM_MAX_THREADS)
kmeans_assign_kernel(const float* __restrict__ points,
                     const float* __restrict__ centroids,
                     int n, int k, int bk, int splits,
                     int32_t* __restrict__ idx_out,
                     float* __restrict__ min_out) {
  constexpr int Q = km_quads(D);
  extern __shared__ float4 tile[];  // (bk, Q) packed centroids
  const int bn = blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * bn * R + threadIdx.x;
  const int split = blockIdx.y;
  const int groups = (k + KM_GROUP - 1) / KM_GROUP;
  const int c_lo = KM_GROUP * (int)((int64_t)split * groups / splits);
  const int c_hi =
      min(k, KM_GROUP * (int)((int64_t)(split + 1) * groups / splits));

  float p[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = first + (int64_t)r * bn;
#pragma unroll
    for (int j = 0; j < D; ++j) p[r][j] = i < n ? points[i * D + j] : 0.f;
  }
  // best score so far and the first index of the group that reached it
  float best[R];
  int group[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best[r] = INFINITY;
    group[r] = c_lo;
  }

  for (int t0 = c_lo; t0 < c_hi; t0 += bk) {
    const int tn = min(bk, c_hi - t0);
    const int tg = (tn + KM_GROUP - 1) / KM_GROUP * KM_GROUP;
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < tg; e += bn) {
      float pk[4 * Q];
      if (e < tn) {
        float c[D];
#pragma unroll
        for (int j = 0; j < D; ++j) c[j] = centroids[(size_t)(t0 + e) * D + j];
#pragma unroll
        for (int j = 0; j < D; ++j) pk[j] = -2.f * c[j];
        pk[D] = sq_norm(c, D);
      } else {  // the group's tail past k: a score of +inf never wins
#pragma unroll
        for (int j = 0; j < D; ++j) pk[j] = 0.f;
        pk[D] = INFINITY;
      }
#pragma unroll
      for (int j = D + 1; j < 4 * Q; ++j) pk[j] = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        tile[e * Q + q] = make_float4(pk[4 * q], pk[4 * q + 1],
                                      pk[4 * q + 2], pk[4 * q + 3]);
    }
    __syncthreads();
    for (int g = 0; g < tg; g += KM_GROUP) {
      float m[R];
#pragma unroll
      for (int c = 0; c < KM_GROUP; ++c) {
        float pk[4 * Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 v = tile[(g + c) * Q + q];
          pk[4 * q] = v.x;
          pk[4 * q + 1] = v.y;
          pk[4 * q + 2] = v.z;
          pk[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = pk[D];
#pragma unroll
          for (int j = 0; j < D; ++j) s = fmaf(pk[j], p[r][j], s);
          m[r] = c ? fminf(m[r], s) : s;
        }
      }
      // branch-free: a strict `<` keeps the earlier group on a tie
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool better = m[r] < best[r];
        best[r] = better ? m[r] : best[r];
        group[r] = better ? t0 + g : group[r];
      }
    }
  }

  // Which centroid of the winning group: the first whose score equals the
  // best, recomputed from the centroids with the staging's and the scan's
  // own arithmetic (so bitwise the same score); if none of the first
  // GROUP - 1 does, the last.  That is the index a strict `<` scan in
  // index order keeps.  Branch-free, so all the loads go out together: a
  // slot past the range reads the range's last centroid, which sits
  // earlier in the same group and so never displaces it.  A point that
  // never beat +inf keeps its range's first index, as such a scan would.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s[KM_GROUP - 1];
#pragma unroll
    for (int e = 0; e < KM_GROUP - 1; ++e) {
      const int ci = min(group[r] + e, c_hi - 1);
      float c[D];
#pragma unroll
      for (int j = 0; j < D; ++j) c[j] = __ldg(centroids + (size_t)ci * D + j);
      s[e] = sq_norm(c, D);
#pragma unroll
      for (int j = 0; j < D; ++j) s[e] = fmaf(-2.f * c[j], p[r][j], s[e]);
    }
    int off = KM_GROUP - 1;
#pragma unroll
    for (int e = KM_GROUP - 2; e >= 0; --e) off = s[e] == best[r] ? e : off;
    const int arg = best[r] < INFINITY ? group[r] + off : group[r];
    const int64_t i = first + (int64_t)r * bn;
    if (i < n) {
      if (splits == 1) {
        min_out[i] = __fadd_rn(best[r], sq_norm(p[r], D));
        idx_out[i] = arg;
      } else {
        min_out[(int64_t)split * n + i] = best[r];
        idx_out[(int64_t)split * n + i] = arg;
      }
    }
  }
}

// one thread per point: the splits' partials in split order, replaced only
// on a strict `<` (the lower range, so the first index, wins a tie), then
// |p|^2 added in f32 with the scan's own arithmetic
__global__ void __launch_bounds__(256)
kmeans_merge_kernel(const float* __restrict__ points,
                    const int32_t* __restrict__ part_idx,
                    const float* __restrict__ part_min, int n, int d,
                    int splits, int32_t* __restrict__ idx_out,
                    float* __restrict__ min_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best = part_min[i];
  int from = 0;
#pragma unroll 8
  for (int s = 1; s < splits; ++s) {  // independent loads, batched
    const float v = part_min[(int64_t)s * n + i];
    from = v < best ? s : from;
    best = v < best ? v : best;
  }
  min_out[i] = __fadd_rn(best, sq_norm(points + i * d, d));
  idx_out[i] = part_idx[(int64_t)from * n + i];
}

extern "C" {

int kmeans_assign_max_d(void) { return KM_MAX_D; }

int kmeans_assign_max_threads(void) { return KM_MAX_THREADS; }

int kmeans_assign_smem_max(void) { return KM_SMEM_MAX; }

int kmeans_assign_group(void) { return KM_GROUP; }

int kmeans_assign_rows(int d) { return km_rows(d); }

long kmeans_assign_smem_bytes(int bk, int d) {
  return (long)bk * km_quads(d) * (long)sizeof(float4);
}

// points (n, d) f32 and the (splits, n) partials of the scan -> idx_out
// (n,) int32 and min_out (n,) f32, the squared distance.  Launches on
// `stream` and does not synchronise; returns cudaGetLastError() after the
// launch.
int kmeans_merge_f32(const void* points, const void* part_idx,
                     const void* part_min, int n, int d, int splits,
                     void* idx_out, void* min_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > KM_MAX_D || splits < 1 || splits > KM_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  kmeans_merge_kernel<<<(n + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)points, (const int32_t*)part_idx,
      (const float*)part_min, n, d, splits, (int32_t*)idx_out,
      (float*)min_out);
  return (int)cudaGetLastError();
}

// points (n, d) and centroids (k, d): contiguous f32 on the current
// device.  bn threads per block (a multiple of 32, at most
// KM_MAX_THREADS), each holding km_rows(d) points; bk centroids per
// shared-memory tile (a multiple of KM_GROUP, within KM_SMEM_MAX bytes);
// k split into `splits` ranges (1..ceil(k / bk)).  Writes idx_out (n,)
// int32 and min_out (n,) f32, the squared distance: with one split the
// scan writes them; with more it writes (splits, n) partials to part_idx
// and part_min (the least score without |p|^2), which the merge kernel,
// launched next, reduces into them.  One call, so the host pays for one
// crossing into the library.  Launches on `stream` and does not
// synchronise.  Returns cudaGetLastError() after the launches (0 on
// success).
int kmeans_assign_f32(const void* points, const void* centroids, int n,
                      int k, int d, int bn, int bk, int splits,
                      void* part_idx, void* part_min, void* idx_out,
                      void* min_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k <= 0 || d <= 0 || d > KM_MAX_D || bn < 32 || bn > KM_MAX_THREADS
      || bn % 32 || bk < KM_GROUP || bk % KM_GROUP
      || kmeans_assign_smem_bytes(bk, d) > KM_SMEM_MAX || splits < 1
      || splits > KM_MAX_SPLITS || splits > (k + bk - 1) / bk
      || (splits > 1 && (!part_idx || !part_min)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kmeans_assign_smem_bytes(bk, d);
  const int64_t per_block = (int64_t)bn * km_rows(d);
  const dim3 grid((unsigned)((n + per_block - 1) / per_block), splits);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)points;
  const float* c = (const float*)centroids;
  int32_t* idx = (int32_t*)(splits == 1 ? idx_out : part_idx);
  float* mn = (float*)(splits == 1 ? min_out : part_min);
  switch (d) {
#define KM_CASE(D)                                                    \
  case D:                                                             \
    kmeans_assign_kernel<D, km_rows(D)><<<grid, bn, smem, s>>>(       \
        p, c, n, k, bk, splits, idx, mn);                             \
    break;
    KM_CASE(1) KM_CASE(2) KM_CASE(3) KM_CASE(4) KM_CASE(5) KM_CASE(6)
    KM_CASE(7) KM_CASE(8) KM_CASE(9) KM_CASE(10) KM_CASE(11) KM_CASE(12)
    KM_CASE(13) KM_CASE(14) KM_CASE(15) KM_CASE(16) KM_CASE(17) KM_CASE(18)
    KM_CASE(19) KM_CASE(20) KM_CASE(21) KM_CASE(22) KM_CASE(23) KM_CASE(24)
    KM_CASE(25) KM_CASE(26) KM_CASE(27) KM_CASE(28) KM_CASE(29) KM_CASE(30)
    KM_CASE(31) KM_CASE(32)
#undef KM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  return kmeans_merge_f32(points, part_idx, part_min, n, d, splits, idx_out,
                          min_out, stream);
}

}  // extern "C"
