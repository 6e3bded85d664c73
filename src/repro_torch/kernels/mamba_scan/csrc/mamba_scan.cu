// Mamba selective scan for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `mamba_scan_pallas` (body `_kernel`) in
// src/repro/kernels/mamba_scan/mamba_scan.py, with its wrapper `scan` in
// src/repro/kernels/mamba_scan/ops.py.  It computes what those compute:
//   h_t = a_t * h_{t-1} + b_t     over (di, st), h carried in f32
//   y_t = sum_st h_t * C_t        the readout over the state dim
// for a, b (B, S, di, st), C (B, S, st), h0 (B, di, st), f32 or bf16
// (upcast to f32), giving y (B, S, di) f32 and h_last (B, di, st) f32.
//
// Design: one lane per (b, di row, st) element.  A row's st lanes are
// neighbouring threads (STP of them, st rounded up to a power of two),
// so for each t a warp reads a contiguous run of a and b.  h lives in a
// register for the whole sequence: the TPU's sequential grid axis over
// sequence chunks becomes a loop over t inside the thread, and nothing is
// carried between blocks.  The readout is a butterfly of __shfl_xor_sync
// over the row's lanes; its first lane writes y.  The loads of BS time
// steps are issued together, one chunk ahead of the recurrence (double
// buffered in registers), so that enough bytes are in flight.
//
// Bound on an H100 SXM: bytes.  Every element of a and b is read once and
// used for one FMA; at Hymba-1.5B width (B=1, S=4096, di=3200, st=16, f32)
// a and b are 839 MB each, about 0.52 ms at 3.35 TB/s.  The FLOPs are
// negligible.  No shared memory is used.
//
// A block holds `bdi` rows: round_up(bdi * STP, 32) threads, so that the
// shuffles always see full warps; lanes past st, rows past bdi and rows
// past di hold h = 0 and store nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// at most 512 threads a block, so ptxas may give a thread 128 registers:
// under a 1024-thread bound (64 registers) the double buffer spilled
#define MS_MAX_THREADS 512
#define MS_MAX_ST 32

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int STP, int BS, typename T>
__global__ void __launch_bounds__(MS_MAX_THREADS)
mamba_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ C, const T* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ h_last, int S,
                  int di, int st, int bdi) {
  const int lane_s = threadIdx.x % STP;
  const int row_in_block = threadIdx.x / STP;
  const int row = blockIdx.x * bdi + row_in_block;
  const int bb = blockIdx.y;
  const bool row_live = row_in_block < bdi && row < di;
  const bool live = row_live && lane_s < st;

  const size_t step = (size_t)di * st;  // elements of a, b per time step
  const size_t elem = live ? (size_t)row * st + lane_s : 0;
  const T* a_p = a + (size_t)bb * S * step + elem;
  const T* b_p = b + (size_t)bb * S * step + elem;
  const T* c_p = C + (size_t)bb * S * st + (live ? lane_s : 0);
  float* y_p = y + (size_t)bb * S * di + row;

  float h = live ? to_f(h0[(size_t)bb * step + elem]) : 0.f;

  float ra[BS], rb[BS], rc[BS];
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    const bool ok = live && i < S;
    ra[i] = ok ? to_f(a_p[(size_t)i * step]) : 0.f;
    rb[i] = ok ? to_f(b_p[(size_t)i * step]) : 0.f;
    rc[i] = ok ? to_f(c_p[(size_t)i * st]) : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += BS) {
    // the next chunk's loads go out before this chunk's recurrence
    float na[BS], nb[BS], nc[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      const int t = t0 + BS + i;
      const bool ok = live && t < S;
      na[i] = ok ? to_f(a_p[(size_t)t * step]) : 0.f;
      nb[i] = ok ? to_f(b_p[(size_t)t * step]) : 0.f;
      nc[i] = ok ? to_f(c_p[(size_t)t * st]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      const int t = t0 + i;
      if (t < S) {  // the same for every thread: the shuffles stay full
        h = fmaf(ra[i], h, rb[i]);
        float part = h * rc[i];
#pragma unroll
        for (int o = STP / 2; o > 0; o >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, o, STP);
        }
        if (lane_s == 0 && row_live) y_p[(size_t)t * di] = part;
      }
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      ra[i] = na[i];
      rb[i] = nb[i];
      rc[i] = nc[i];
    }
  }
  if (live) h_last[(size_t)bb * step + elem] = h;
}

template <int STP, int BS, typename T>
static void launch(dim3 grid, int threads, cudaStream_t s, const void* a,
                   const void* b, const void* C, const void* h0, float* y,
                   float* h_last, int S, int di, int st, int bdi) {
  mamba_scan_kernel<STP, BS, T><<<grid, threads, 0, s>>>(
      (const T*)a, (const T*)b, (const T*)C, (const T*)h0, y, h_last, S, di,
      st, bdi);
}

template <int STP, typename T>
static int launch_bs(int bs, dim3 grid, int threads, cudaStream_t s,
                     const void* a, const void* b, const void* C,
                     const void* h0, float* y, float* h_last, int S, int di,
                     int st, int bdi) {
  switch (bs) {
    case 4: launch<STP, 4, T>(grid, threads, s, a, b, C, h0, y, h_last, S, di, st, bdi); break;
    case 8: launch<STP, 8, T>(grid, threads, s, a, b, C, h0, y, h_last, S, di, st, bdi); break;
    case 16: launch<STP, 16, T>(grid, threads, s, a, b, C, h0, y, h_last, S, di, st, bdi); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

template <typename T>
static int launch_st(int stp, int bs, dim3 grid, int threads, cudaStream_t s,
                     const void* a, const void* b, const void* C,
                     const void* h0, float* y, float* h_last, int S, int di,
                     int st, int bdi) {
  switch (stp) {
    case 2: return launch_bs<2, T>(bs, grid, threads, s, a, b, C, h0, y, h_last, S, di, st, bdi);
    case 4: return launch_bs<4, T>(bs, grid, threads, s, a, b, C, h0, y, h_last, S, di, st, bdi);
    case 8: return launch_bs<8, T>(bs, grid, threads, s, a, b, C, h0, y, h_last, S, di, st, bdi);
    case 16: return launch_bs<16, T>(bs, grid, threads, s, a, b, C, h0, y, h_last, S, di, st, bdi);
    case 32: return launch_bs<32, T>(bs, grid, threads, s, a, b, C, h0, y, h_last, S, di, st, bdi);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int mamba_scan_max_threads(void) { return MS_MAX_THREADS; }

int mamba_scan_max_st(void) { return MS_MAX_ST; }

// a, b (B, S, di, st), C (B, S, st), h0 (B, di, st): contiguous, all of
// one dtype (0 = f32, 1 = bf16), on the current device.  Writes y
// (B, S, di) f32 and h_last (B, di, st) f32.  bdi rows per block
// (round_up(bdi * pow2(st), 32) <= MS_MAX_THREADS threads), bs in
// {4, 8, 16} time steps loaded ahead.  Launches on `stream` and does not
// synchronise.  Returns cudaGetLastError() after the launch (0 on
// success).
int mamba_scan_fwd(const void* a, const void* b, const void* C,
                   const void* h0, void* y, void* h_last, int B, int S,
                   int di, int st, int dtype, int bdi, int bs,
                   void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || st <= 0
      || st > MS_MAX_ST || bdi <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  int stp = 2;
  while (stp < st) stp *= 2;
  const long threads = ((long)bdi * stp + 31) / 32 * 32;
  if (threads > MS_MAX_THREADS) return (int)cudaErrorInvalidValue;
  const dim3 grid((di + bdi - 1) / bdi, B);
  const cudaStream_t s = (cudaStream_t)stream;
  const int err =
      dtype == 0
          ? launch_st<float>(stp, bs, grid, (int)threads, s, a, b, C, h0,
                             (float*)y, (float*)h_last, S, di, st, bdi)
          : launch_st<__nv_bfloat16>(stp, bs, grid, (int)threads, s, a, b,
                                     C, h0, (float*)y, (float*)h_last, S,
                                     di, st, bdi);
  if (err != (int)cudaSuccess) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
