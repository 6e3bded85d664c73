// K-Means assignment (nearest centroid) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `assign_pallas` (body `_kernel`) in
// src/repro/kernels/kmeans/kmeans.py, with its wrapper `_assign` in
// src/repro/kernels/kmeans/ops.py.  It computes what those compute, not
// the TPU's tiling: for each point p (f32) the score
// s(c) = -2 * p.c + |c|^2 over the centroids c, the index of the least
// score (the first index wins a tie) and that least score.  The caller
// adds |p|^2 back in f32, as ops.py does, so the returned minimum is the
// squared distance with the reference's arithmetic.
//
// Design: one thread per point, its D coordinates in registers (D is a
// template parameter, 1..KM_MAX_D).  The block stages tiles of KM_TILE
// centroids in shared memory, computes each tile's |c|^2 once, and each
// thread walks the tile in increasing index keeping (best, arg) in
// registers, replaced only on a strict `<`: that is the reference's
// first-index tie rule.  No padding: the loops stop at n and k.
//
// Bound on an H100 SXM: k*(D+1) FP32 FMAs per point against 4*D + 8
// bytes moved per point (points read, index and minimum written).  At
// D=3 that is 20 bytes per point; at k=500 and k=5000 the kernel is
// bound by the FP32 cores (67 TFLOP/s), and at 1M x 50 the two bounds
// are about even (2e8 FMAs and 20 MB are each ~6 us at 67 TFLOP/s and
// 3.35 TB/s).  Shared-memory reads are broadcasts (every thread of a warp
// reads the same centroid), so they do not conflict.
//
// Known weakness: parallelism is n / KM_THREADS blocks.  The 10k x 5000
// shape launches only ceil(10000 / 256) = 40 blocks on 132 SMs.  Splitting
// k across blocks with a second argmin pass is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KM_THREADS 256
#define KM_TILE 256
#define KM_MAX_D 32

template <int D>
__global__ void __launch_bounds__(KM_THREADS)
kmeans_assign_kernel(const float* __restrict__ points,
                     const float* __restrict__ centroids,
                     int n, int k,
                     int32_t* __restrict__ idx_out,
                     float* __restrict__ min_out) {
  __shared__ float c_tile[KM_TILE * D];
  __shared__ float c_norm[KM_TILE];

  const int i = blockIdx.x * KM_THREADS + threadIdx.x;
  const bool live = i < n;
  float p[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    p[j] = live ? points[(size_t)i * D + j] : 0.f;
  }

  float best = INFINITY;
  int arg = 0;
  for (int t0 = 0; t0 < k; t0 += KM_TILE) {
    const int tn = min(KM_TILE, k - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < tn * D; e += KM_THREADS) {
      c_tile[e] = centroids[(size_t)t0 * D + e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < tn; c += KM_THREADS) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        s = fmaf(c_tile[c * D + j], c_tile[c * D + j], s);
      }
      c_norm[c] = s;
    }
    __syncthreads();
    for (int c = 0; c < tn; ++c) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        dot = fmaf(p[j], c_tile[c * D + j], dot);
      }
      const float score = fmaf(-2.f, dot, c_norm[c]);
      if (score < best) {
        best = score;
        arg = t0 + c;
      }
    }
  }
  if (live) {
    idx_out[i] = arg;
    min_out[i] = best;
  }
}

extern "C" {

int kmeans_assign_max_d(void) { return KM_MAX_D; }

int kmeans_assign_threads(void) { return KM_THREADS; }

// points (n, d) and centroids (k, d): contiguous f32 on the current
// device.  Writes idx_out (n,) int32 and min_out (n,) f32, the least
// score without |p|^2.  Launches on `stream` and does not synchronise.
// Returns cudaGetLastError() after the launch (0 on success).
int kmeans_assign_f32(const void* points, const void* centroids, int n,
                      int k, int d, void* idx_out, void* min_out,
                      void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k <= 0 || d <= 0 || d > KM_MAX_D) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + KM_THREADS - 1) / KM_THREADS);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)points;
  const float* c = (const float*)centroids;
  int32_t* idx = (int32_t*)idx_out;
  float* mn = (float*)min_out;
  switch (d) {
#define KM_CASE(D) \
  case D: kmeans_assign_kernel<D><<<grid, KM_THREADS, 0, s>>>(p, c, n, k, idx, mn); break;
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
  return (int)cudaGetLastError();
}

}  // extern "C"
