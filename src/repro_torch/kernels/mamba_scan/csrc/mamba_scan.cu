// Mamba selective scan for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `mamba_scan_pallas` (body `_kernel`) in
// src/repro/kernels/mamba_scan/mamba_scan.py, with its wrapper `scan` in
// src/repro/kernels/mamba_scan/ops.py.  It computes what those compute:
//   h_t = a_t * h_{t-1} + b_t     over (di, st), h carried in f32
//   y_t = sum_st h_t * C_t        the readout over the state dim
// giving y (B, S, di) f32 and h_last (B, di, st) f32.  Two input modes
// run this one recurrence and readout; they differ in how a step's a_t
// and b_t reach a lane's registers:
//
//   (a, b) mode, `mamba_scan_kernel`: a, b (B, S, di, st), C (B, S, st),
//   h0 (B, di, st), f32 or bf16 (upcast to f32), read as they lie.
//   fused mode, `mamba_scan_kernel_fused`: the layer's own inputs, dt and
//   u (B, S, di), A (di, st), Bc and C (B, S, st), h0 (B, di, st), all
//   f32; each lane forms a_t = expf(dt_t A) and b_t = u_t Bc_t in
//   registers (expf, not __expf, on the product rounded first, as
//   torch.exp(dt * A) and mamba_ssm_bwd.cu compute it), so no
//   (B, S, di, st) tensor is written or read.
//
// The readout is K3's butterfly over a row's states, every product and sum
// rounded on its own (no contraction into an FMA), so on the same a and b
// both modes give y and h_last bit for bit (lane_sum, rows_sum).
//
// (a, b) mode.  One lane per (b, di row, st) element.  A row's st lanes are
// neighbouring threads (STP of them, st rounded up to a power of two),
// so for each t a warp reads a contiguous run of a and b.  h lives in a
// register for the whole sequence: the TPU's sequential grid axis over
// sequence chunks becomes a loop over t inside the thread, and nothing is
// carried between blocks.  The readout is a butterfly of __shfl_xor_sync
// over the row's lanes; its first lane writes y.  The loads of BS time
// steps are issued together, one chunk ahead of the recurrence (double
// buffered in registers), so that enough bytes are in flight.
// Bound on an H100 SXM: bytes.  Every element of a and b is read once and
// used for one FMA; at Hymba-1.5B width (B=1, S=4096, di=3200, st=16, f32)
// a and b are 839 MB each, about 0.52 ms at 3.35 TB/s.  The FLOPs are
// negligible.  No shared memory is used.  A block holds `bdi` rows:
// round_up(bdi * STP, 32) threads, so that the shuffles always see full
// warps; lanes past st, rows past bdi and rows past di hold h = 0 and
// store nothing.
//
// Fused mode.  A row's STP states are held P to a lane by L = STP / P
// neighbouring lanes (P = MSF_P = 4, fewer where STP is smaller), lane k
// holding states k, k + L, ..., k + (P - 1) L: the butterfly's levels of
// distance L and more are sums inside the lane, in K3's order.  The steps
// go G = min(L, MSF_G) at a time: their 4 G exps first (independent of
// each other and of h), then h's multiply-adds, then one reduce-scatter of
// the G steps' parts over the row's lanes (log2 L shuffles for G steps,
// against 4 a step for each state in the (a, b) mode), which leaves each
// lane one step's y to store, by a predicated store (no branch, so a
// chunk is straight-line code).  dt and u (one value a row and a step)
// and Bc and C (one value a step for the block) are staged T steps at a
// time in a two-stage ring in shared memory, filled by cp.async one chunk
// ahead; Bc and C are laid out so that a lane's P states are one 16-byte
// load.  A block holds R rows; by default (ops.selective_scan, bdi 0) R
// spreads the B x di rows evenly over the SMs, one block an SM
// (mamba_scan.py's balanced_rows: 128 blocks of 100 rows at 4 x 3200).
// Steps past S leave h as it is and store nothing; rows past di and
// states past st hold h = 0 and store nothing.
// Bound on an H100 SXM.  Bytes: dt, u, y (B, S, di) and the (B, S, st),
// (di, st), (B, di, st) terms, read or written once: 316 MB, 0.0943 ms at
// 4 x 2048 x 3200 x 16 (bench/lib/bounds.py's scan_bound, 0.0948 ms with
// its operations: 7 an element at the FP32 peak is 0.044 ms).  The kernel
// cannot reach that: it is bound by instruction issue and latency.  A
// lane issues ~70 instructions a step for its 4 states (cuobjdump -sass:
// 44 FP32 ones, of which expf takes 4 FFMA, an FADD and an FMUL a state,
// and 4 MUFU.EX2, 4 shared-memory loads, the rest addresses, selects and
// shuffles), 2.3e8 warp instructions at that shape: 0.22 ms at 4 a clock
// on 132 SMs at 1.98 GHz.  tools/k3_fused_probe.py times altered copies
// (no exp, no readout, no store, other layouts).
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

// The readout y_t = sum_s h_t[s] C_t[s] of a row whose STP states are
// held P to a lane by L neighbouring lanes, lane k holding states k + L j,
// is K3's butterfly over the states (distance STP / 2 first), split in
// two: lane_sum takes the levels of distance L P / 2, ..., L inside the
// lane, rows_sum the levels below L over the lanes.  Every product and
// sum is rounded on its own and every pair summed is the butterfly's
// (addition commutes bit for bit), so any (L, P) gives the sum of the
// (a, b) mode's one-state lanes (L = STP, P = 1), bit for bit.
template <int P>
__device__ __forceinline__ float lane_sum(const float (&h)[P],
                                          const float (&c)[P]) {
  float v[P];
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = __fmul_rn(h[j], c[j]);
#pragma unroll
  for (int n = P / 2; n > 0; n /= 2) {
#pragma unroll
    for (int j = 0; j < n; ++j) v[j] = __fadd_rn(v[j], v[j + n]);
  }
  return v[0];
}

// The levels below L for G steps at once (v[i]: this lane's part of step
// i): at lane distance M a lane keeps the half of its steps picked by bit
// M of k and adds its partner's copy of that half (one shuffle moves two
// values' worth), until one step is left; the remaining levels are the
// butterfly's.  Lane k returns the sum of step k / (L / G).
template <int L, int G, int M = L / 2>
__device__ __forceinline__ float rows_sum(float (&v)[G], int k) {
  if constexpr (M == 0) {
    return v[0];
  } else if constexpr (G > 1) {
    constexpr int H = G / 2;
    const bool up = (k & M) != 0;
    float w[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = up ? v[j] : v[j + H];
      const float keep = up ? v[j + H] : v[j];
      w[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, M, L));
    }
    return rows_sum<L, H, M / 2>(w, k);
  } else {
    v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], M, L));
    return rows_sum<L, 1, M / 2>(v, k);
  }
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
        float part[1] = {__fmul_rn(h, rc[i])};
        const float yv = rows_sum<STP, 1>(part, lane_s);
        if (lane_s == 0 && row_live) y_p[(size_t)t * di] = yv;
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

// ---------------------------------------------------------------- fused

#define MSF_P 4  // states a lane in the fused mode (fewer where STP < 4)
#define MSF_G 4  // steps a readout group in the fused mode (at most L)
// the shared memory a block may take after opting in (H100: 227 KB)
#define MSF_MAX_SMEM 232448

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// decay(dt, A) = exp(dt * A): the product rounded on its own, then the
// accurate expf, as PyTorch computes torch.exp(dt[..., None] * A)
__device__ __forceinline__ float decay(float dt, float A) {
  return expf(__fmul_rn(dt, A));
}

// Where a thread's copies of a (T x R) tile of dt or u go: it starts at
// step i0 and copy c0 of a step and moves on by di steps and dc copies a
// round (the block's threads over the step's nv copies), so the tile
// needs no division.  nv copies of v floats (4, or 1 where the rows are
// not 16-byte aligned) fill a step's R floats.
struct RowCopies {
  int i0, c0, di, dc, nv, v;
};

__device__ __forceinline__ RowCopies row_copies(int R, bool vec) {
  RowCopies rc;
  rc.v = vec ? 4 : 1;
  rc.nv = R / rc.v;
  rc.i0 = threadIdx.x / rc.nv;
  rc.c0 = threadIdx.x % rc.nv;
  rc.di = blockDim.x / rc.nv;
  rc.dc = blockDim.x % rc.nv;
  return rc;
}

// tile[i * R + c] = x[(bb * S + t0 + i) * di + r0 + c] for i < T, c < R:
// one chunk of dt or u for the block's R rows, by 16-byte copies where
// rc.v is 4 (R, r0 and di multiples of 4, x 16-byte aligned), else 4-byte
// ones; zero past S and past di
template <int T>
__device__ __forceinline__ void stage_rows(float* tile, const float* x,
                                           const RowCopies& rc, int R,
                                           int r0, int di, int bb, int t0,
                                           int S) {
  int i = rc.i0, q = rc.c0;
  while (i < T) {
    const int c = q * rc.v;
    const int t = t0 + i;
    const bool ok = t < S && r0 + c < di;
    const float* src = ok ? x + ((size_t)bb * S + t) * di + r0 + c : x;
    if (rc.v == 4) {
      cp_async16(tile + i * R + c, src, ok);
    } else {
      cp_async4(tile + i * R + c, src, ok);
    }
    i += rc.di;
    q += rc.dc;
    if (q >= rc.nv) {
      q -= rc.nv;
      ++i;
    }
  }
}

// tile[i * STP + (s % L) * P + s / L] = x[(bb * S + t0 + i) * st + s] for
// i < T, s < STP = L * P: one chunk of Bc or C, each step's states
// permuted so that lane k's P states k + L j lie together; zero past S
// and past st
template <int T, int L, int P>
__device__ __forceinline__ void stage_states(float* tile, const float* x,
                                             int st, int bb, int t0,
                                             int S) {
  constexpr int STP = L * P;
  for (int e = threadIdx.x; e < T * STP; e += blockDim.x) {
    const int i = e / STP;
    const int s = e % STP;
    const int t = t0 + i;
    const bool ok = t < S && s < st;
    const float* src = ok ? x + ((size_t)bb * S + t) * st + s : x;
    cp_async4(tile + i * STP + (s % L) * P + s / L, src, ok);
  }
}

// *p = v where ok, as one predicated store: no branch, so a chunk's steps
// stay one block of straight-line code for the scheduler
__device__ __forceinline__ void store_if(float* p, float v, bool ok) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q st.global.f32 [%0], %1;\n\t}\n" ::"l"(p),
      "f"(v), "r"((int)ok));
}

template <int P>
__device__ __forceinline__ void load_p(const float* p, float (&v)[P]) {
  if constexpr (P == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (P == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = p[j];
  }
}

// Steps a readout group of the fused mode: at most L, so that after
// rows_sum each lane of a row holds one step's y (or L / G lanes hold it)
template <int L>
__host__ __device__ constexpr int fused_group() {
  return L < MSF_G ? L : MSF_G;
}

// One staged chunk: the recurrence and readout of its steps, G at a time:
// the G steps' a and b first (their exps independent of each other and of
// h), then h's G multiply-adds, the lane's parts and one rows_sum, which
// leaves lane k with step k / (L / G)'s y to store (TAIL: the last chunk,
// which may end before T steps; the test is the same for every thread, so
// the shuffles stay full)
template <int L, int P, int T, bool TAIL>
__device__ __forceinline__ void fused_chunk(const float* sg, int R, int rs,
                                            int k, float (&h)[P],
                                            const float (&Ar)[P],
                                            float* y_p, int t0, int S,
                                            int di, bool write) {
  constexpr int STP = L * P;
  constexpr int G = fused_group<L>();
  const float* s_dt = sg + rs;
  const float* s_u = sg + T * R + rs;
  const float* s_b = sg + 2 * T * R;
  const float* s_c = s_b + T * STP;
  const int tk = k / (L / G);  // the step of a group this lane stores
  float* yq = y_p + (size_t)(t0 + tk) * di;
#pragma unroll
  for (int g = 0; g < T; g += G, yq += (size_t)G * di) {
    if (TAIL && t0 + g >= S) break;
    float a[G][P], b[G][P], c[G][P];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int ii = g + i;
      const float dtv = s_dt[ii * R];
      const float uv = s_u[ii * R];
      float bv[P];
      load_p<P>(s_b + ii * STP + k * P, bv);
      load_p<P>(s_c + ii * STP + k * P, c[i]);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        a[i][j] = decay(dtv, Ar[j]);
        b[i][j] = __fmul_rn(uv, bv[j]);
      }
    }
    float part[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (!TAIL || t0 + g + i < S) {
#pragma unroll
        for (int j = 0; j < P; ++j) h[j] = fmaf(a[i][j], h[j], b[i][j]);
      }
      part[i] = lane_sum<P>(h, c[i]);
    }
    const float yv = rows_sum<L, G>(part, k);
    store_if(yq, yv, write && (!TAIL || t0 + g + tk < S));
  }
}

// Floats of one stage of the ring: dt, u (T x rows) and Bc, C (T x STP)
__host__ __device__ constexpr int fused_stage_floats(int T, int rows,
                                                     int stp) {
  return 2 * T * rows + 2 * T * stp;
}

// L lanes a row, P states a lane, T steps a chunk; a block of R rows
template <int L, int P, int T>
__global__ void __launch_bounds__(MS_MAX_THREADS)
mamba_scan_kernel_fused(const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ u,
                        const float* __restrict__ Bc,
                        const float* __restrict__ C,
                        const float* __restrict__ h0, float* __restrict__ y,
                        float* __restrict__ h_last, int S, int di, int st,
                        int R, int vec_rows) {
  constexpr int STP = L * P;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int k = threadIdx.x % L;
  const int r_in = threadIdx.x / L;
  const int row0 = blockIdx.x * R;
  const int row = row0 + r_in;
  const int bb = blockIdx.y;
  const bool row_live = r_in < R && row < di;
  const int rs = r_in < R ? r_in : 0;  // the tile column a lane reads
  const int sn = fused_stage_floats(T, R, STP);
  const int nc = (S + T - 1) / T;

  float Ar[P], h[P];
  const size_t hrow = ((size_t)bb * di + (row_live ? row : 0)) * st;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int s = k + L * j;
    const bool live = row_live && s < st;
    Ar[j] = live ? A[(size_t)row * st + s] : 0.f;
    h[j] = live ? h0[hrow + s] : 0.f;
  }
  float* y_p = y + (size_t)bb * S * di + (row_live ? row : 0);
  // L / G lanes of a row hold each stored y; the first of them stores it
  const bool write = k % (L / fused_group<L>()) == 0 && row_live;

  const RowCopies rc = row_copies(R, vec_rows);
  auto stage = [&](int c) {
    float* sg = smem + (c & 1) * sn;
    const int t0 = c * T;
    stage_rows<T>(sg, dt, rc, R, row0, di, bb, t0, S);
    stage_rows<T>(sg + T * R, u, rc, R, row0, di, bb, t0, S);
    stage_states<T, L, P>(sg + 2 * T * R, Bc, st, bb, t0, S);
    stage_states<T, L, P>(sg + 2 * T * R + T * STP, C, st, bb, t0, S);
    cp_commit();
  };
  stage(0);
  for (int c = 0; c < nc; ++c) {
    // the next chunk's copies go out before this chunk's recurrence
    if (c + 1 < nc) {
      stage(c + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sg = smem + (c & 1) * sn;
    const int t0 = c * T;
    if (t0 + T <= S) {
      fused_chunk<L, P, T, false>(sg, R, rs, k, h, Ar, y_p, t0, S, di,
                                  write);
    } else {
      fused_chunk<L, P, T, true>(sg, R, rs, k, h, Ar, y_p, t0, S, di,
                                 write);
    }
    __syncthreads();  // the stage is refilled two chunks on
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int s = k + L * j;
    if (row_live && s < st) h_last[hrow + s] = h[j];
  }
}

template <int L, int P, int T>
static int launch_fused(dim3 grid, int threads, size_t smem, cudaStream_t s,
                        const float* const* f, float* y, float* h_last,
                        int S, int di, int st, int R, int vec_rows) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_scan_kernel_fused<L, P, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mamba_scan_kernel_fused<L, P, T><<<grid, threads, smem, s>>>(
      f[0], f[1], f[2], f[3], f[4], f[5], y, h_last, S, di, st, R,
      vec_rows);
  return (int)cudaSuccess;
}

template <int L, int P>
static int launch_fused_bs(int bs, dim3 grid, int threads, size_t smem,
                           cudaStream_t s, const float* const* f, float* y,
                           float* h_last, int S, int di, int st, int R,
                           int vec_rows) {
  switch (bs) {
    case 16: return launch_fused<L, P, 16>(grid, threads, smem, s, f, y, h_last, S, di, st, R, vec_rows);
    case 32: return launch_fused<L, P, 32>(grid, threads, smem, s, f, y, h_last, S, di, st, R, vec_rows);
    case 64: return launch_fused<L, P, 64>(grid, threads, smem, s, f, y, h_last, S, di, st, R, vec_rows);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Lanes a row of STP states takes in the fused mode: MSF_P states a lane,
// or all STP in one where STP is narrower
template <int STP>
constexpr int fused_lanes() {
  return STP < MSF_P ? 1 : STP / MSF_P;
}

// STP: st rounded up to a power of two, at least 2
static int state_lanes_pow2(int st) {
  int stp = 2;
  while (stp < st) stp *= 2;
  return stp;
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
  const int stp = state_lanes_pow2(st);
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

// The fused mode's block for state width st and R rows: out = {lanes a
// row, states a lane, threads, bytes of dynamic shared memory for chunks
// of bs steps}.  Returns 0, or cudaErrorInvalidValue for a width or block
// the kernel is not built for.
int mamba_scan_fused_layout(int st, int R, int bs, int* out) {
  if (st <= 0 || st > MS_MAX_ST || R <= 0 || R > MS_MAX_THREADS
      || (bs != 16 && bs != 32 && bs != 64))
    return (int)cudaErrorInvalidValue;
  const int stp = state_lanes_pow2(st);
  const int p = stp < MSF_P ? stp : MSF_P;
  const int lanes = stp / p;
  const long threads = ((long)lanes * R + 31) / 32 * 32;
  const long smem = 2L * fused_stage_floats(bs, R, stp) * sizeof(float);
  if (threads > MS_MAX_THREADS || smem > MSF_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  out[0] = lanes;
  out[1] = p;
  out[2] = (int)threads;
  out[3] = (int)smem;
  return 0;
}

// dt, u (B, S, di), A (di, st), Bc, C (B, S, st), h0 (B, di, st): f32,
// contiguous, on the current device.  Writes y (B, S, di) and h_last
// (B, di, st), f32.  R rows a block (mamba_scan_fused_layout's threads
// <= MS_MAX_THREADS), bs in {16, 32, 64} steps a staged chunk.
// Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError() after the launch (0 on success).
int mamba_scan_fused_fwd(const void* dt, const void* A, const void* u,
                         const void* Bc, const void* C, const void* h0,
                         void* y, void* h_last, int B, int S, int di, int st,
                         int R, int bs, void* stream) {
  int lay[4];
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0
      || mamba_scan_fused_layout(st, R, bs, lay) != 0)
    return (int)cudaErrorInvalidValue;
  const int lanes = lay[0], p = lay[1], threads = lay[2];
  const size_t smem = (size_t)lay[3];
  const dim3 grid((di + R - 1) / R, B);
  const cudaStream_t s = (cudaStream_t)stream;
  auto al16 = [](const void* q) { return ((uintptr_t)q & 15) == 0; };
  const int vec_rows = di % 4 == 0 && R % 4 == 0 && al16(dt) && al16(u);
  const float* f[6] = {(const float*)dt, (const float*)A, (const float*)u,
                       (const float*)Bc, (const float*)C, (const float*)h0};
  float* yo = (float*)y;
  float* ho = (float*)h_last;
  int err = (int)cudaErrorInvalidValue;
  switch (lanes * p) {
    case 2: err = launch_fused_bs<fused_lanes<2>(), 2 / fused_lanes<2>()>(bs, grid, threads, smem, s, f, yo, ho, S, di, st, R, vec_rows); break;
    case 4: err = launch_fused_bs<fused_lanes<4>(), 4 / fused_lanes<4>()>(bs, grid, threads, smem, s, f, yo, ho, S, di, st, R, vec_rows); break;
    case 8: err = launch_fused_bs<fused_lanes<8>(), 8 / fused_lanes<8>()>(bs, grid, threads, smem, s, f, yo, ho, S, di, st, R, vec_rows); break;
    case 16: err = launch_fused_bs<fused_lanes<16>(), 16 / fused_lanes<16>()>(bs, grid, threads, smem, s, f, yo, ho, S, di, st, R, vec_rows); break;
    case 32: err = launch_fused_bs<fused_lanes<32>(), 32 / fused_lanes<32>()>(bs, grid, threads, smem, s, f, yo, ho, S, di, st, R, vec_rows); break;
    default: break;
  }
  if (err != (int)cudaSuccess) return err;
  return (int)cudaGetLastError();
}

int mamba_scan_fused_states(void) { return MSF_P; }

}  // extern "C"
