// Flash attention (forward) for NVIDIA Hopper, sm_90a, on the tensor cores.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_kernel`) in
// src/repro/kernels/flash_attention/flash_attention.py, with its wrapper
// `attention` in src/repro/kernels/flash_attention/ops.py.  It computes
// what those compute: attention with an online softmax, f32 running max
// m, denominator l and accumulator acc, scale hd^-0.5, the causal mask
// (q >= k) and the sliding-window mask (q - k < window) with positions
// from 0 on both sides, masked scores set to the finite NEG_INF = -1e30,
// and the output acc / max(l, 1e-30) in q's dtype.  q and k enter the
// scores at f32 precision; p is rounded to v's dtype before the PV
// product, as the reference does; l sums the unrounded p.  A row that no
// key may see (only with a window, when S_q > S_k) is outside the
// contract, as in the TPU kernel, whose answer for it depends on its
// block size.
//
// Layout: q (B, S_q, H, hd) and k, v (B, S_k, H, hd), contiguous, read
// through their strides, so the reference's swapaxes copies are gone.
// GQA callers repeat KV first.
//
// Bound on an H100 SXM: operations.  Each live (q, k) pair costs 4*hd
// FLOPs (QK^T and PV).  In f32 the products run on the tensor cores as
// 3xTF32: every operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi), and lo*hi + hi*lo, then hi*hi, are summed into
// an f32 accumulator (CUTLASS's OpMultiplyAddFastF32 order).  That keeps
// ~22 bits of each operand, enough for the reference's f32 tolerance
// (2e-4), where one TF32 product is not; it costs three m16n8k8 products
// per product, so the f32 peak is 495/3 = 165 TFLOP/s (bf16: one
// m16n8k16 product, 989 TFLOP/s).  Through mma.sync the card delivers
// 320 TFLOP/s TF32 and 640 bf16 (tools/mma_rate.py), so this kernel's
// ceiling is ~107 TFLOP/s in f32; wgmma is the way past it.  Hymba-1.5B's
// windowed layer (25 heads, S = 4096, window 2048, hd 64) is 4.0e10
// FLOPs: 0.24 ms at 165 TFLOP/s.
//
// Design (mma.sync, the FA-2 shape; wgmma + TMA is the next step):
//   * One warp owns 16 query rows, a block bq / 16 warps; the grid is
//     (ceil(S_q / bq), B*H), heaviest (latest) query blocks first.
//   * Q is staged in shared memory once.  In f32 each k-step reads and
//     splits its fragment there (the hi and lo fragments of a whole row
//     would take 128 registers a thread at hd 128); in bf16 the warp's
//     fragments live in registers (32 a thread at hd 128).
//   * K and V tiles of BK keys go through a 2-stage ring in shared
//     memory, loaded with 16-byte cp.async.cg (zero-filled past S_k)
//     while the previous tile is computed, one barrier per tile.  Rows
//     are padded by 16 bytes, so every fragment load (32-bit loads,
//     ldmatrix) hits 32 distinct banks.
//   * The TF32 split is integer arithmetic with cvt.rna's rounding (the
//     conversion instruction runs on a slow pipe), and each of the three
//     products runs over all of a k-step's accumulators before the next,
//     so dependent mma.sync are NT issues apart.
//   * P stays in registers.  The m16n8 score accumulator gives thread
//     (g, t) keys {2t, 2t+1} of each 8-key tile; the tf32 A fragment of
//     PV wants k-columns {t, t+4}.  PV sums over keys, so the k-column c
//     is taken to be key pi(c) = {0,2,4,6,1,3,5,7}[c] and V's rows are
//     read in the same order: the score fragment is the A fragment, with
//     no shuffle.  In bf16 two 8-key score tiles make one k16 A fragment
//     (FA-2's layout) and V's fragments come from ldmatrix.trans.
//   * The softmax runs in registers in log2 units, x = s * hd^-0.5 *
//     log2(e) and p = 2^(x - m) by ex2.approx (one SFU op; expf took ~8
//     instructions).  Its error, ~1e-7 relative in p, stays far inside
//     the f32 tolerance (max |err| ~2e-6 at every width on the card).
//     Row max and row sum go over the 4 threads of a quad (shuffles 1,
//     2); l is kept per thread and summed over the quad at the end.
//   * The TPU kernel's skip of fully masked KV blocks (`pl.when(live)`)
//     becomes the bounds of the block's key-tile loop, and a warp skips
//     the tiles no row of its own sees.  Per-element masks run only on
//     tiles that cross the diagonal, the window edge or S_k.
//   * NEG_INF stays finite: a row whose first tile is masked keeps
//     m = -1e30 and 2^0 = 1, which the next live tile's correction
//     2^(-1e30 - m) = 0 wipes out, as in the reference, so a window
//     narrower than one tile still gives the reference's answer.  Keys
//     past S_k score -inf, so they add nothing even then.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FA_MAX_BQ 128            // query rows per block: 8 warps of 16
#define FA_WARP_ROWS 16          // query rows per warp (one m16 tile)
#define FA_PAD_BYTES 16          // padding per staged shared-memory row
#define FA_SMEM_MAX 232448       // bytes a block may use after opt-in
#define FA_NEG_INF (-1e30f)

static const int FA_BK_BUILT[] = {32, 64};   // keys per tile, instantiated

// ------------------------------------------------------------ primitives
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, both TF32 rounded to nearest, ties away (cvt.rna.tf32's
// rounding) by integer ops: adding half a TF32 ulp to the bits and
// dropping the low 13 gives rna for any finite x.  lo keeps its low bits,
// which the tensor core ignores, as CUTLASS's small part does.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// 2^x on the SFU (relative error ~2^-22; 2^-inf = 0, 2^0 = 1)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a * b in 3xTF32: the small products first, then the big one
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Stage `rows` rows of hd elements, starting at sequence row r0, into
// shared rows of RS elements; rows at or past `limit` are zero-filled.
template <int HD, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, size_t rs,
                                          int r0, int rows, int limit) {
  constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int CPR = HD / EPC;         // chunks per row
  constexpr int RS = HD + FA_PAD_BYTES / sizeof(T);
  for (int c = threadIdx.x; c < rows * CPR; c += blockDim.x) {
    const int row = c / CPR, col = (c % CPR) * EPC;
    const bool in = r0 + row < limit;
    const T* from = src + (in ? (size_t)(r0 + row) * rs : 0) + col;
    cp_async16(dst + row * RS + col, from, in ? 16 : 0);
  }
}

// ---------------------------------------------------------------- kernel
// hd <= 64: registers capped so that two 8-warp blocks fit on an SM
template <int HD, int BK, typename T>
__global__ void __launch_bounds__(2 * FA_MAX_BQ, HD <= 64 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int S_q, int S_k, int causal, int window,
                       float scale) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int RS = HD + FA_PAD_BYTES / sizeof(T);   // padded row stride
  constexpr int NT = BK / 8;    // 8-key score tiles per key tile
  constexpr int ND = HD / 8;    // 8-column output tiles
  constexpr int NC = ND < 8 ? ND : 8;   // V fragments split at a time (f32)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bq = blockDim.x / 32 * FA_WARP_ROWS;
  const float scale_log2 = scale * 1.4426950408889634f;   // scale * log2(e)
  T* qs = reinterpret_cast<T*>(smem_raw);             // (bq, RS)
  T* kv = qs + bq * RS;         // stage s: K at kv + 2s*BK*RS, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;              // quad row, column
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  // the latest query blocks see the most keys: schedule them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const size_t rs = (size_t)H * HD;                   // sequence-step stride
  const T* qb = q + (size_t)b * S_q * rs + (size_t)h * HD;
  const T* kb = k + (size_t)b * S_k * rs + (size_t)h * HD;
  const T* vb = v + (size_t)b * S_k * rs + (size_t)h * HD;
  T* ob = o + (size_t)b * S_q * rs + (size_t)h * HD;

  // the keys any row of this block can see, and those of this warp
  int kv_lo = 0, kv_hi = S_k;
  if (causal) kv_hi = min(S_k, q0 + bq);
  if (window) kv_lo = max(0, q0 - window + 1);
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;
  const int r_lo = q0 + warp * FA_WARP_ROWS;          // the warp's first row
  int w_lo = kv_lo, w_hi = r_lo < S_q ? kv_hi : kv_lo;
  if (causal) w_hi = min(w_hi, r_lo + FA_WARP_ROWS);
  if (window) w_lo = max(w_lo, r_lo - window + 1);
  const int row0 = r_lo + g, row1 = row0 + 8;         // this thread's rows

  load_rows<HD>(qs, qb, rs, q0, bq, S_q);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows<HD>(kv, kb, rs, kv_lo, BK, S_k);
    load_rows<HD>(kv + BK * RS, vb, rs, kv_lo, BK, S_k);
  }
  cp_async_commit();
  cp_async_wait<1>();           // Q has landed
  __syncthreads();

  // bf16: the warp's Q fragments in registers, one k16 step each
  constexpr int QF = F32 ? 1 : HD / 16;
  uint32_t qf[QF][4];
  const T* qw = qs + warp * FA_WARP_ROWS * RS;
  if constexpr (!F32) {
#pragma unroll
    for (int kk = 0; kk < QF; ++kk) {
      const T* p = qw + g * RS + 16 * kk + 2 * t;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * RS);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * RS + 8);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m0 = FA_NEG_INF, m1 = FA_NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = kv_lo + it * BK;
    cp_async_wait<0>();         // this tile has landed ...
    __syncthreads();            // ... for all, and the other stage is free
    if (it + 1 < n_tiles) {     // the next tile flies while this one runs
      T* nxt = kv + ((it + 1) & 1) * 2 * BK * RS;
      load_rows<HD>(nxt, kb, rs, t0 + BK, BK, S_k);
      load_rows<HD>(nxt + BK * RS, vb, rs, t0 + BK, BK, S_k);
    }
    cp_async_commit();
    if (t0 >= w_hi || t0 + BK <= w_lo) continue;   // no row of the warp's
    const T* ks = kv + (it & 1) * 2 * BK * RS;
    const T* vs = ks + BK * RS;

    // ---- S = Q K^T on the tensor cores: s[nt] is keys 8nt..8nt+7
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t ahi[4], alo[4], bhi[NT][2], blo[NT][2];
        const float* qp = reinterpret_cast<const float*>(qw) + g * RS
                          + 8 * kk + t;
        split_tf32(qp[0], ahi[0], alo[0]);
        split_tf32(qp[8 * RS], ahi[1], alo[1]);
        split_tf32(qp[4], ahi[2], alo[2]);
        split_tf32(qp[8 * RS + 4], ahi[3], alo[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* kp = reinterpret_cast<const float*>(ks)
                            + (8 * nt + g) * RS + 8 * kk + t;
          split_tf32(kp[0], bhi[nt][0], blo[nt][0]);
          split_tf32(kp[4], bhi[nt][1], blo[nt][1]);
        }
        // lo*hi + hi*lo, then hi*hi: each pass over every accumulator,
        // so that dependent products are NT issues apart
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(s[nt], alo, bhi[nt]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(s[nt], ahi, blo[nt]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(s[nt], ahi, bhi[nt]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const T* kp = ks + (8 * nt + g) * RS + 16 * kk + 2 * t;
          const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kp),
                                  *reinterpret_cast<const uint32_t*>(kp + 8)};
          mma_bf16(s[nt], qf[kk], bf);
        }
      }
    }

    // ---- scale, mask (edge tiles only) and the online softmax, in log2
    // units: x = s * scale * log2(e), so p = 2^(x - m) is one SFU op
    const bool edge = t0 + BK > S_k
                      || (causal && t0 + BK - 1 > r_lo)
                      || (window && t0 <= r_lo + FA_WARP_ROWS - 1 - window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int row = e < 2 ? row0 : row1;
          const int kp = t0 + 8 * nt + 2 * t + (e & 1);
          if (causal && row < kp) x = FA_NEG_INF;
          if (window && row - kp >= window) x = FA_NEG_INF;
          if (kp >= S_k) x = -INFINITY;
        }
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = exp2_approx(m0 - mx0), c1 = exp2_approx(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2_approx(s[nt][0] - m0);
      s[nt][1] = exp2_approx(s[nt][1] - m0);
      s[nt][2] = exp2_approx(s[nt][2] - m1);
      s[nt][3] = exp2_approx(s[nt][3] - m1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= c0;
      acc[nd][1] *= c0;
      acc[nd][2] *= c1;
      acc[nd][3] *= c1;
    }

    // ---- acc += P V on the tensor cores, P straight from registers
    if constexpr (F32) {
#pragma unroll
      for (int kt = 0; kt < NT; ++kt) {
        // k-columns t, t+4 are keys 2t, 2t+1: the accumulator's own
        uint32_t ahi[4], alo[4];
        split_tf32(s[kt][0], ahi[0], alo[0]);   // row g,   key 2t
        split_tf32(s[kt][2], ahi[1], alo[1]);   // row g+8, key 2t
        split_tf32(s[kt][1], ahi[2], alo[2]);   // row g,   key 2t+1
        split_tf32(s[kt][3], ahi[3], alo[3]);   // row g+8, key 2t+1
        const float* vp = reinterpret_cast<const float*>(vs)
                          + (8 * kt + 2 * t) * RS + g;
#pragma unroll
        for (int n0 = 0; n0 < ND; n0 += NC) {
          uint32_t bhi[NC][2], blo[NC][2];
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            split_tf32(vp[8 * (n0 + j)], bhi[j][0], blo[j][0]);       // 2t
            split_tf32(vp[RS + 8 * (n0 + j)], bhi[j][1], blo[j][1]);  // 2t+1
          }
#pragma unroll
          for (int j = 0; j < NC; ++j) mma_tf32(acc[n0 + j], alo, bhi[j]);
#pragma unroll
          for (int j = 0; j < NC; ++j) mma_tf32(acc[n0 + j], ahi, blo[j]);
#pragma unroll
          for (int j = 0; j < NC; ++j) mma_tf32(acc[n0 + j], ahi, bhi[j]);
        }
      }
    } else {
#pragma unroll
      for (int kt = 0; kt < NT / 2; ++kt) {
        // p rounded to bf16 before PV (l summed it unrounded)
        const uint32_t a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                               pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                               pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                               pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
        // lanes 8j..8j+7 address rows of matrix j: keys +8*(j&1),
        // columns of output tile nd + (j>>1)
        const T* vp = vs + (16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8)
                               * RS + 8 * (lane >> 4);
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vp + 8 * nd);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16(acc[nd], a, b0);
          mma_bf16(acc[nd + 1], a, b1);
        }
      }
    }
  }

  // ---- epilogue: the quad's partial denominators, then acc / l
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = 8 * nd + 2 * t;
    if (row0 < S_q)
      store2(ob + (size_t)row0 * rs + col, acc[nd][0] / d0, acc[nd][1] / d0);
    if (row1 < S_q)
      store2(ob + (size_t)row1 * rs + col, acc[nd][2] / d1, acc[nd][3] / d1);
  }
}

template <int HD, int BK, typename T>
static int launch(int B, int H, int S_q, int S_k, int bq, size_t smem,
                  cudaStream_t s, const void* q, const void* k,
                  const void* v, void* o, int causal, int window,
                  float scale) {
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)flash_attention_kernel<HD, BK, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S_q + bq - 1) / bq, B * H);
  flash_attention_kernel<HD, BK, T><<<grid, bq / FA_WARP_ROWS * 32, smem,
                                      s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, S_q, S_k, causal,
      window, scale);
  return (int)cudaGetLastError();
}

extern "C" {

int flash_attention_max_bq(void) { return FA_MAX_BQ; }

int flash_attention_warp_rows(void) { return FA_WARP_ROWS; }

int flash_attention_smem_max(void) { return FA_SMEM_MAX; }

// The i-th key-tile size the kernel is instantiated for, 0 past the end.
int flash_attention_bk_built(int i) {
  const int n = sizeof(FA_BK_BUILT) / sizeof(FA_BK_BUILT[0]);
  return i >= 0 && i < n ? FA_BK_BUILT[i] : 0;
}

// Shared memory of one block for elements of `es` bytes: the query tile
// and two stages of K and V tiles, every row padded by 16 bytes.
long flash_attention_smem_bytes(int bq, int bk, int hd, int es) {
  return ((long)bq + 4L * bk) * ((long)hd * es + FA_PAD_BYTES);
}

// q (B, S_q, H, hd), k and v (B, S_k, H, hd): contiguous, 16-byte
// aligned, one dtype (0 = f32, 1 = bf16), on the current device.  Writes
// o (B, S_q, H, hd) in that dtype.  hd in {32, 64, 128}; bq query rows per
// block, a multiple of 16 up to FA_MAX_BQ (bq / 16 warps); bk keys per
// tile, one of FA_BK_BUILT; window 0 means none.  Launches on `stream`
// and does not synchronise.  Returns cudaGetLastError() after the launch
// (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int B, int H, int S_q, int S_k, int hd,
                        int dtype, int bq, int bk, int causal, int window,
                        float scale, void* stream) {
  if (B <= 0 || H <= 0 || (long)B * H > 65535 || S_q <= 0 || S_k <= 0
      || bq < FA_WARP_ROWS || bq > FA_MAX_BQ || bq % FA_WARP_ROWS
      || window < 0 || (dtype != 0 && dtype != 1)
      || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  const long smem = flash_attention_smem_bytes(bq, bk, hd, dtype ? 2 : 4);
  if (smem > FA_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(HD_, BK_)                                                   \
  if (hd == HD_ && bk == BK_)                                               \
    return dtype == 0                                                       \
        ? launch<HD_, BK_, float>(B, H, S_q, S_k, bq, smem, s, q, k, v, o,  \
                                  causal, window, scale)                    \
        : launch<HD_, BK_, __nv_bfloat16>(B, H, S_q, S_k, bq, smem, s, q, k, \
                                          v, o, causal, window, scale);
  FA_CASE(32, 32)
  FA_CASE(32, 64)
  FA_CASE(64, 32)
  FA_CASE(64, 64)
  FA_CASE(128, 32)
  FA_CASE(128, 64)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
