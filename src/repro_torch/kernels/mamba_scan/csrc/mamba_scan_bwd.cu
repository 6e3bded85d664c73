// Backward of the Mamba selective scan for NVIDIA Hopper, sm_90a (K3-bwd).
//
// The JAX package has no kernel for this: its model differentiates its own
// chunked associative scan (src/repro/models/layers/mamba.py, `_chunk_scan`
// inside `lax.scan` in `mamba_forward`) with JAX autodiff.  The port runs
// the forward recurrence in K3 (csrc/mamba_scan.cu), so its gradient is this
// kernel.  For the forward
//   h_t = a_t * h_{t-1} + b_t,   y_t = sum_st h_t * C_t,   h_{-1} = h0
// and cotangents dy (B, S, di) and dh_last (B, di, st), with
//   g_t = dL/dh_t = dy_t * C_t + a_{t+1} * g_{t+1},  a_S * g_S := dh_last,
// it writes
//   da_t = g_t * h_{t-1},  db_t = g_t,  dh0 = a_0 * g_0,
//   dC_t[st] = sum_di dy_t[di] * h_t[di, st].
// a, b, C, h0 are f32 or bf16 (upcast); h, g and every sum are f32; da, db,
// dC and dh0 are stored in the inputs' dtype.
//
// Design: one lane per (b, di row, st) element, a row's st lanes neighbouring
// threads, as in K3.  h is never recovered as (h_t - b_t) / a_t: a = exp(dt A)
// underflows to 0 at large dt.  Instead the kernel
//   1. walks h forward over the whole sequence and stores it at every chunk
//      start (h_{cT-1}, h0 for c = 0) into `hck` (B, ceil(S/T), di, st) f32,
//      T = MSB_T steps a chunk;
//   2. walks the chunks from last to first: rebuilds the chunk's h_t into
//      registers from its checkpoint, then runs the reverse recurrence over
//      the chunk, carrying a_t * g_t from one step (and chunk) to the next.
// The same thread writes and reads its own checkpoints, so no grid-wide
// synchronisation is needed.
//
// dC reduces over di, which spans blocks.  There are no float atomics: the
// rows of a warp are summed by shuffles, the warps of a block in order
// through shared memory, and each block writes its partial sums to
// `dC_part` (B, S, n_blocks, st); a second kernel adds the partials in block
// order.  The result is the same bit for bit on every run.
//
// Bound on an H100 SXM: bytes.  a, b, C and dy are read once and da, db
// written once at the least; this kernel reads a and b twice (the forward
// walk and the rebuild), so it moves about 1.5x its bound.  At Hymba-1.5B
// training width (B=4, S=2048, di=3200, st=16, f32) a is 1.68 GB: the bound
// is ~2.0 ms at 3.35 TB/s.  The FLOPs are negligible.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSB_THREADS 256  // threads a block (at most), so 8 warps
#define MSB_MAX_ST 32
#define MSB_T 16         // time steps between checkpoints of h

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int STP, typename T>
__global__ void __launch_bounds__(MSB_THREADS)
mamba_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ C, const T* __restrict__ h0,
                      const float* __restrict__ dy,
                      const float* __restrict__ dh_last, T* __restrict__ da,
                      T* __restrict__ db, T* __restrict__ dh0,
                      float* __restrict__ hck, float* __restrict__ dC_part,
                      int S, int di, int st, int bdi, int nblk) {
  __shared__ float red[MSB_THREADS / 32][MSB_T][STP];
  const int lane_s = threadIdx.x % STP;
  const int row_in_block = threadIdx.x / STP;
  const int row = blockIdx.x * bdi + row_in_block;
  const int bb = blockIdx.y;
  const bool row_live = row_in_block < bdi && row < di;
  const bool live = row_live && lane_s < st;
  const int warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const int nc = (S + MSB_T - 1) / MSB_T;

  const size_t step = (size_t)di * st;  // elements of a, b per time step
  const size_t elem = live ? (size_t)row * st + lane_s : 0;
  const size_t base = (size_t)bb * S * step + elem;
  const T* a_p = a + base;
  const T* b_p = b + base;
  T* da_p = da + base;
  T* db_p = db + base;
  const T* c_p = C + (size_t)bb * S * st + (live ? lane_s : 0);
  const float* dy_p =
      dy ? dy + (size_t)bb * S * di + (row_live ? row : 0) : nullptr;
  float* hck_p = hck + (size_t)bb * nc * step + elem;

  // 1. h forward over the sequence, h_{cT-1} stored at each chunk start
  float h = live ? to_f(h0[(size_t)bb * step + elem]) : 0.f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * MSB_T;
    if (live) hck_p[(size_t)c * step] = h;
    if (c == nc - 1) break;  // the last chunk's h is rebuilt in pass 2
    float ra[MSB_T], rb[MSB_T];
#pragma unroll
    for (int i = 0; i < MSB_T; ++i) {
      ra[i] = live ? to_f(a_p[(size_t)(t0 + i) * step]) : 1.f;
      rb[i] = live ? to_f(b_p[(size_t)(t0 + i) * step]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MSB_T; ++i) h = fmaf(ra[i], h, rb[i]);  // as K3
  }

  // 2. the reverse recurrence, chunk by chunk from the last
  float carry = (live && dh_last) ? dh_last[(size_t)bb * step + elem] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * MSB_T;
    const float hprev = live ? hck_p[(size_t)c * step] : 0.f;
    float ra[MSB_T], hb[MSB_T], rdy[MSB_T], rc[MSB_T];
    {
      float rb[MSB_T];
#pragma unroll
      for (int i = 0; i < MSB_T; ++i) {
        const int t = t0 + i;
        const bool ok = live && t < S;
        ra[i] = ok ? to_f(a_p[(size_t)t * step]) : 1.f;
        rb[i] = ok ? to_f(b_p[(size_t)t * step]) : 0.f;
        rc[i] = ok ? to_f(c_p[(size_t)t * st]) : 0.f;
        rdy[i] = (dy_p && row_live && t < S) ? dy_p[(size_t)t * di] : 0.f;
      }
      float hh = hprev;
#pragma unroll
      for (int i = 0; i < MSB_T; ++i) {
        hh = fmaf(ra[i], hh, rb[i]);
        hb[i] = hh;
      }
    }
#pragma unroll
    for (int i = MSB_T - 1; i >= 0; --i) {
      const int t = t0 + i;
      if (t < S) {  // the same for every thread: the shuffles stay full
        const float g = fmaf(rdy[i], rc[i], carry);
        const float hp = i > 0 ? hb[i - 1] : hprev;
        if (live) {
          put(da_p + (size_t)t * step, g * hp);
          put(db_p + (size_t)t * step, g);
        }
        carry = ra[i] * g;
        if (dC_part) {
          // this row's part of dC_t, summed over the warp's rows
          float p = rdy[i] * hb[i];
#pragma unroll
          for (int o = STP; o < 32; o <<= 1) {
            p += __shfl_xor_sync(0xffffffffu, p, o);
          }
          if (threadIdx.x % 32 < STP) red[warp][i][lane_s] = p;
        }
      }
    }
    if (dC_part) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < MSB_T * STP; idx += blockDim.x) {
        const int i = idx / STP;
        const int s = idx % STP;
        const int t = t0 + i;
        if (s < st && t < S) {
          float acc = 0.f;
          for (int w = 0; w < nwarps; ++w) acc += red[w][i][s];
          dC_part[(((size_t)bb * S + t) * nblk + blockIdx.x) * st + s] = acc;
        }
      }
      __syncthreads();
    }
  }
  if (dh0 && live) put(dh0 + (size_t)bb * step + elem, carry);
}

// dC[bs, s] = sum over blocks k, in order, of dC_part[bs, k, s]
template <typename T>
__global__ void mamba_scan_dc_kernel(const float* __restrict__ dC_part,
                                     T* __restrict__ dC, long n, int nblk,
                                     int st) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * st) return;
  const long bs = idx / st;
  const int s = (int)(idx % st);
  const float* p = dC_part + (size_t)bs * nblk * st + s;
  float acc = 0.f;
  for (int k = 0; k < nblk; ++k) acc += p[(size_t)k * st];
  put(dC + idx, acc);
}

template <int STP, typename T>
static int launch(dim3 grid, int threads, cudaStream_t s, const void* a,
                  const void* b, const void* C, const void* h0,
                  const float* dy, const float* dh_last, void* da, void* db,
                  void* dC, void* dh0, float* hck, float* dC_part, int B,
                  int S, int di, int st, int bdi) {
  const int nblk = (int)grid.x;
  mamba_scan_bwd_kernel<STP, T><<<grid, threads, 0, s>>>(
      (const T*)a, (const T*)b, (const T*)C, (const T*)h0, dy, dh_last,
      (T*)da, (T*)db, (T*)dh0, hck, dC ? dC_part : nullptr, S, di, st, bdi,
      nblk);
  if (dC) {
    const long n = (long)B * S;
    const long blocks = (n * st + 255) / 256;
    mamba_scan_dc_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(
        dC_part, (T*)dC, n, nblk, st);
  }
  return (int)cudaSuccess;
}

template <typename T>
static int launch_st(int stp, dim3 grid, int threads, cudaStream_t s,
                     const void* a, const void* b, const void* C,
                     const void* h0, const float* dy, const float* dh_last,
                     void* da, void* db, void* dC, void* dh0, float* hck,
                     float* dC_part, int B, int S, int di, int st, int bdi) {
  switch (stp) {
    case 2: return launch<2, T>(grid, threads, s, a, b, C, h0, dy, dh_last, da, db, dC, dh0, hck, dC_part, B, S, di, st, bdi);
    case 4: return launch<4, T>(grid, threads, s, a, b, C, h0, dy, dh_last, da, db, dC, dh0, hck, dC_part, B, S, di, st, bdi);
    case 8: return launch<8, T>(grid, threads, s, a, b, C, h0, dy, dh_last, da, db, dC, dh0, hck, dC_part, B, S, di, st, bdi);
    case 16: return launch<16, T>(grid, threads, s, a, b, C, h0, dy, dh_last, da, db, dC, dh0, hck, dC_part, B, S, di, st, bdi);
    case 32: return launch<32, T>(grid, threads, s, a, b, C, h0, dy, dh_last, da, db, dC, dh0, hck, dC_part, B, S, di, st, bdi);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int mamba_scan_bwd_threads(void) { return MSB_THREADS; }

int mamba_scan_bwd_max_st(void) { return MSB_MAX_ST; }

int mamba_scan_bwd_chunk(void) { return MSB_T; }

// a, b (B, S, di, st), C (B, S, st), h0 (B, di, st): contiguous, all of one
// dtype (0 = f32, 1 = bf16).  dy (B, S, di) and dh_last (B, di, st) are f32
// or null (a zero cotangent).  Writes da, db (B, S, di, st) and, unless
// null, dC (B, S, st) and dh0 (B, di, st), all in the inputs' dtype.
// Scratch: hck (B, ceil(S / MSB_T), di, st) f32 and, when dC is wanted,
// dC_part (B, S, ceil(di / bdi), st) f32.  bdi rows a block,
// round_up(bdi * pow2(st), 32) <= MSB_THREADS threads.  Launches on
// `stream` and does not synchronise.  Returns cudaGetLastError() after the
// launches (0 on success).
int mamba_scan_bwd(const void* a, const void* b, const void* C,
                   const void* h0, const void* dy, const void* dh_last,
                   void* da, void* db, void* dC, void* dh0, void* hck,
                   void* dC_part, int B, int S, int di, int st, int dtype,
                   int bdi, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || st <= 0
      || st > MSB_MAX_ST || bdi <= 0 || (dtype != 0 && dtype != 1)
      || (dC && !dC_part))
    return (int)cudaErrorInvalidValue;
  int stp = 2;
  while (stp < st) stp *= 2;
  const long threads = ((long)bdi * stp + 31) / 32 * 32;
  if (threads > MSB_THREADS) return (int)cudaErrorInvalidValue;
  const dim3 grid((di + bdi - 1) / bdi, B);
  const cudaStream_t s = (cudaStream_t)stream;
  const int err =
      dtype == 0
          ? launch_st<float>(stp, grid, (int)threads, s, a, b, C, h0,
                             (const float*)dy, (const float*)dh_last, da, db,
                             dC, dh0, (float*)hck, (float*)dC_part, B, S, di,
                             st, bdi)
          : launch_st<__nv_bfloat16>(stp, grid, (int)threads, s, a, b, C,
                                     h0, (const float*)dy,
                                     (const float*)dh_last, da, db, dC, dh0,
                                     (float*)hck, (float*)dC_part, B, S, di,
                                     st, bdi);
  if (err != (int)cudaSuccess) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
