// Flash attention (forward) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_kernel`) in
// src/repro/kernels/flash_attention/flash_attention.py, with its wrapper
// `attention` in src/repro/kernels/flash_attention/ops.py.  It computes
// what those compute: attention with an online softmax, f32 running max
// m, denominator l and accumulator acc, scale hd^-0.5, the causal mask
// (q >= k) and the sliding-window mask (q - k < window) with positions
// from 0 on both sides, masked scores set to the finite NEG_INF = -1e30,
// and the output acc / max(l, 1e-30) in q's dtype.  q and k are upcast to
// f32; p is rounded to v's dtype before the PV product, as the reference
// does; l sums the unrounded p.
//
// Layout: q (B, S_q, H, hd) and k, v (B, S_k, H, hd), contiguous, read
// through their strides, so the reference's swapaxes copies are gone.
// GQA callers repeat KV first.
//
// Design (a first kernel that is right, on the FP32 cores): one thread
// per query row, `bq` rows (threads) per block, grid (ceil(S_q/bq), B*H).
// The block stages its query tile in shared memory once (rows padded by 4
// floats so that a quarter-warp's float4 reads hit distinct banks), then
// walks tiles of `bk` keys: K and V tiles are staged in shared memory as
// f32, and every thread reads them as float4 broadcasts.  Each thread
// takes 8 keys at a time: 8 dot products, the mask, one online-softmax
// update, and the PV FMAs into acc[hd] in registers.
//   * The TPU kernel's skip of fully masked KV blocks (`pl.when(live)`)
//     becomes the bounds of the key-tile loop: keys past the block's last
//     query (causal) and keys at or before its first query's window edge
//     are never loaded.  Inside a tile, a thread skips 8-key chunks that
//     are fully masked for its own row.
//   * NEG_INF stays finite: a row whose first chunk is masked keeps
//     m = -1e30 and exp(0) = 1, which the next live chunk's correction
//     exp(-1e30 - m) = 0 wipes out, as in the reference.  Keys past S_k
//     (the ragged edge; no block size need divide S) score -inf instead,
//     so they add nothing even then.
//
// Bound on an H100 SXM: operations.  Each live (q, k) pair costs 4*hd
// FLOPs (QK^T and PV); Hymba-1.5B's windowed layer (25 heads, S = 4096,
// window 2048, hd 64) is 4.0e10 FLOPs, ~0.60 ms at 67 TFLOP/s FP32.  The
// reference's f32 tolerance (2e-4) rules out TF32 tensor cores; moving to
// wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FA_MAX_THREADS 256
#define FA_KC 8                  // keys a thread takes at a time
#define FA_QPAD 4                // floats of padding per staged query row
#define FA_SMEM_MAX 232448       // bytes a block may use after opt-in
#define FA_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// p rounded to v's dtype before the PV product
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int HD, typename T>
__global__ void __launch_bounds__(FA_MAX_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int S_q, int S_k, int bk, int causal, int window,
                       float scale) {
  constexpr int QP = HD + FA_QPAD;
  extern __shared__ __align__(16) float smem[];
  const int bq = blockDim.x;
  const int bkp = (bk + FA_KC - 1) / FA_KC * FA_KC;
  float* qs = smem;              // (bq, QP)
  float* ks = qs + bq * QP;      // (bkp, HD)
  float* vs = ks + bkp * HD;     // (bkp, HD)

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * bq;
  const int r = q0 + threadIdx.x;               // this thread's query row
  const size_t rs = (size_t)H * HD;             // stride of a sequence step
  const T* qb = q + (size_t)b * S_q * rs + (size_t)h * HD;
  const T* kb = k + (size_t)b * S_k * rs + (size_t)h * HD;
  const T* vb = v + (size_t)b * S_k * rs + (size_t)h * HD;
  T* ob = o + (size_t)b * S_q * rs + (size_t)h * HD;

  for (int e = threadIdx.x; e < bq * HD; e += bq) {
    const int rr = e / HD, dd = e % HD;
    qs[rr * QP + dd] =
        q0 + rr < S_q ? to_f(qb[(size_t)(q0 + rr) * rs + dd]) : 0.f;
  }

  // the keys any row of this block can see
  int kv_lo = 0, kv_hi = S_k;
  if (causal) kv_hi = min(S_k, q0 + bq);
  if (window) kv_lo = max(0, q0 - window + 1);

  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = FA_NEG_INF, l = 0.f;
  const float* qrow = qs + threadIdx.x * QP;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += bk) {
    const int tn = min(bk, kv_hi - t0);
    const int tnp = (tn + FA_KC - 1) / FA_KC * FA_KC;
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < tnp * HD; e += bq) {
      const int jj = e / HD, dd = e % HD;
      const bool in = jj < tn;   // rows past the tile are zero
      const size_t g = (size_t)(t0 + jj) * rs + dd;
      ks[e] = in ? to_f(kb[g]) : 0.f;
      vs[e] = in ? to_f(vb[g]) : 0.f;
    }
    __syncthreads();
    if (r >= S_q) continue;
    for (int j0 = 0; j0 < tn; j0 += FA_KC) {
      const int kp0 = t0 + j0;
      if (causal && kp0 > r) break;                            // all later
      if (window && r - (kp0 + FA_KC - 1) >= window) continue;  // all past
      float s[FA_KC];
#pragma unroll
      for (int jj = 0; jj < FA_KC; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
        for (int jj = 0; jj < FA_KC; ++jj) {
          const float4 kv =
              *reinterpret_cast<const float4*>(ks + (j0 + jj) * HD + d);
          s[jj] = fmaf(qv.x, kv.x, s[jj]);
          s[jj] = fmaf(qv.y, kv.y, s[jj]);
          s[jj] = fmaf(qv.z, kv.z, s[jj]);
          s[jj] = fmaf(qv.w, kv.w, s[jj]);
        }
      }
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < FA_KC; ++jj) {
        const int kp = kp0 + jj;
        float x = s[jj] * scale;
        if (causal && r < kp) x = FA_NEG_INF;
        if (window && r - kp >= window) x = FA_NEG_INF;
        s[jj] = j0 + jj < tn ? x : -INFINITY;
        m_new = fmaxf(m_new, s[jj]);
      }
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < FA_KC; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
        s[jj] = round_as(s[jj], v);
      }
      l = l * corr + psum;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        float a0 = acc[d] * corr, a1 = acc[d + 1] * corr;
        float a2 = acc[d + 2] * corr, a3 = acc[d + 3] * corr;
#pragma unroll
        for (int jj = 0; jj < FA_KC; ++jj) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + (j0 + jj) * HD + d);
          a0 = fmaf(s[jj], vv.x, a0);
          a1 = fmaf(s[jj], vv.y, a1);
          a2 = fmaf(s[jj], vv.z, a2);
          a3 = fmaf(s[jj], vv.w, a3);
        }
        acc[d] = a0;
        acc[d + 1] = a1;
        acc[d + 2] = a2;
        acc[d + 3] = a3;
      }
      m = m_new;
    }
  }
  if (r < S_q) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = ob + (size_t)r * rs;
#pragma unroll
    for (int d = 0; d < HD; ++d) store(orow + d, acc[d] / den);
  }
}

template <int HD, typename T>
static int launch(dim3 grid, int bq, size_t smem, cudaStream_t s,
                  const void* q, const void* k, const void* v, void* o,
                  int H, int S_q, int S_k, int bk, int causal, int window,
                  float scale) {
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)flash_attention_kernel<HD, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_attention_kernel<HD, T><<<grid, bq, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, S_q, S_k, bk, causal,
      window, scale);
  return (int)cudaGetLastError();
}

extern "C" {

int flash_attention_max_threads(void) { return FA_MAX_THREADS; }

int flash_attention_key_chunk(void) { return FA_KC; }

int flash_attention_smem_max(void) { return FA_SMEM_MAX; }

// Shared memory of one block: the padded query tile and the K and V
// tiles (bk rounded up to the key chunk), all f32.
long flash_attention_smem_bytes(int bq, int bk, int hd) {
  const long bkp = (bk + FA_KC - 1) / FA_KC * FA_KC;
  return 4L * ((long)bq * (hd + FA_QPAD) + 2L * bkp * hd);
}

// q (B, S_q, H, hd), k and v (B, S_k, H, hd): contiguous, one dtype
// (0 = f32, 1 = bf16), on the current device.  Writes o (B, S_q, H, hd)
// in that dtype.  hd in {32, 64, 128}; bq query rows (threads) per block,
// 1..FA_MAX_THREADS; bk >= 1 keys per tile; window 0 means none.
// Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError() after the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int B, int H, int S_q, int S_k, int hd,
                        int dtype, int bq, int bk, int causal, int window,
                        float scale, void* stream) {
  if (B <= 0 || H <= 0 || (long)B * H > 65535 || S_q <= 0 || S_k <= 0
      || bq <= 0 || bq > FA_MAX_THREADS || bk <= 0 || window < 0
      || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long smem = flash_attention_smem_bytes(bq, bk, hd);
  if (smem > FA_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((S_q + bq - 1) / bq, B * H);
  const cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(HD_)                                                        \
  case HD_:                                                                 \
    return dtype == 0                                                       \
        ? launch<HD_, float>(grid, bq, smem, s, q, k, v, o, H, S_q, S_k,   \
                             bk, causal, window, scale)                     \
        : launch<HD_, __nv_bfloat16>(grid, bq, smem, s, q, k, v, o, H, S_q, \
                                     S_k, bk, causal, window, scale);
  switch (hd) {
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // extern "C"
