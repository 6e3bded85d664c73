// Fused backward of the Mamba selective scan and its input tail, for
// NVIDIA Hopper, sm_90a.
//
// The JAX package has no kernel for this: its model differentiates
// `_ssm_inputs` (src/repro/models/layers/mamba.py:46-59: a = exp(dt A),
// b = (dt x1) B) and `_chunk_scan` (:62-70, inside `lax.scan`) with JAX
// autodiff.  The port's forward builds a and b in PyTorch and runs K3
// (csrc/mamba_scan.cu) on them; this kernel is the gradient of the whole
// chain (dt, A, u, Bc, C, h0) -> (y, h_last), with u = dt x1:
//   a_t = exp(dt_t A),  b_t = u_t Bc_t,  h_t = a_t h_{t-1} + b_t,
//   y_t = sum_st h_t C_t.
// For cotangents dy (B, S, di) and dh_last (B, di, st), either null (zero),
// with g_t = dy_t C_t + a_{t+1} g_{t+1} and a_S g_S := dh_last, it writes
//   ddt_t[r]  = sum_s g_t h_{t-1} a_t A[r, s]
//   du_t[r]   = sum_s g_t Bc_t[s]
//   dBc_t[s]  = sum_r g_t u_t[r]
//   dC_t[s]   = sum_r dy_t[r] h_t[r, s]
//   dA[r, s]  = sum_{b, t} g_t h_{t-1} a_t dt_t[r]
//   dh0       = a_0 g_0
// All inputs and outputs are f32.  No (B, S, di, st) tensor is read or
// written: every lane rebuilds a_t and b_t in registers from dt, A, u, Bc
// (expf, not __expf, and the product rounded first, as torch.exp(dt * A)).
//
// Design.  A d_inner row's states are split over L neighbouring lanes of P
// states each (L * P = st rounded up to a power of two, at least P), so a
// warp holds 32 / L rows.  h is never recovered as (h_t - b_t) / a_t (a
// underflows to 0 at large dt).  Instead
//   1. a forward walk keeps h at every chunk start (h_{cT-1}, h0 for c = 0)
//      in `hck` (B, ceil(S / T), di, st) f32, T = MSS_T;
//   2. a backward walk over the chunks, last first, rebuilds the chunk's h_t
//      in registers from its checkpoint (prefetched one chunk ahead), then
//      runs the reverse recurrence over it, carrying a_t g_t.
// dt, u, dy (one value a row and a step) and Bc, C (one value a step for
// the block) are staged a chunk at a time (T steps x the block's rows, and
// T x st) in a two-stage ring in shared memory, filled by cp.async one
// chunk ahead, so a row's lanes read shared memory and the next chunk's
// loads overlap this chunk's work.
// Sums over st (ddt, du) are a lane's own P states, then a butterfly over
// the row's L lanes.  Sums over d_inner (dBc, dC) use no float atomics:
// a reduce-scatter of shuffles over the warp's rows, the warps of a block
// in order through shared memory, the blocks of a thread-block cluster (up
// to 8) in rank order through distributed shared memory, so one partial a
// cluster reaches memory (`part`, (B, S, n_clusters, 2 * STP)); dA is
// summed over t in a register per (b, row, state) into `dA_part`
// (B, di, st).  A second small kernel adds the cluster partials and dA's
// batch partials in order.  Every result is the same bit for bit on every
// run.
//
// Bound on an H100 SXM.  Bytes: dt, u, dy read once and ddt, du written
// once ((B, S, di) f32 each), plus the (B, S, st), (di, st) and (B, di, st)
// terms: ~0.53 GB, 0.157 ms at 4 x 2048 x 3200 x 16 at 3.35 TB/s.
// Operations: 22 FP32 operations and 2 exp an element (one exp a walk);
// exp runs on the SFU (16 a clock an SM), so the operations bound it
// there: ~0.20 ms.  This kernel evaluates exp three times an element (the
// forward walk, the rebuild and the reverse step, to keep a out of
// registers).  On the card it is bound by instruction issue, not by
// either: its time moves with the instructions a chunk issues (exps, the
// row sums' shuffles and selects, address arithmetic), which
// tools/ssm_bwd_probe.py measures by taking each out.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MSS_T 16            // time steps a chunk (between checkpoints of h)
#define MSS_MAX_ST 32
#define MSS_THREADS 128     // threads a block: 4 warps
#define MSS_MAX_CLUSTER 8
// States a lane and the blocks an SM the registers must allow (so at most
// 128 registers a thread).  At 4 x 2048 x 3200 x 16 this gives 400 blocks
// in one wave (4 resident an SM, 124 clusters at once); 2 states a lane
// makes 800 blocks, 1.6 waves, more shuffles an element and a slower
// kernel (tools/ssm_bwd_probe.py).
#define MSS_P 4
#define MSS_MINB 4

// a_t = exp(dt_t * A): the product rounded on its own, then the accurate
// expf, as PyTorch computes torch.exp(dt[..., None] * A)
__device__ __forceinline__ float decay(float dt, float A) {
  return expf(__fmul_rn(dt, A));
}

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

// the two halves of a cluster barrier: arrive releases this thread's
// writes to shared memory, wait acquires every block's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// tile[i * W + c] = x[(bb * S + t0 + i) * ld + c0 + c] for i < MSS_T and
// c < W, by cp.async of V floats; zero past S, past the row end ld, and
// where x is null.  V = 4 needs ld, c0 and W multiples of 4 and x aligned
// to 16 bytes.
template <int W, int V>
__device__ __forceinline__ void stage_v(float* tile, const float* x, int c0,
                                        int ld, int bb, int t0, int S) {
  for (int e = threadIdx.x; e < MSS_T * W / V; e += MSS_THREADS) {
    const int i = e / (W / V);
    const int c = e % (W / V) * V;
    const int t = t0 + i;
    const bool ok = t < S && c0 + c < ld;
    const float* src = ok ? x + ((size_t)bb * S + t) * ld + c0 + c : x;
    if constexpr (V == 4) {
      cp_async16(tile + i * W + c, src, ok);
    } else {
      cp_async4(tile + i * W + c, src, ok);
    }
  }
}

template <int W>
__device__ __forceinline__ void stage(float* tile, const float* x, int c0,
                                      int ld, int bb, int t0, int S,
                                      bool vec) {
  if (x == nullptr) {
    for (int e = threadIdx.x; e < MSS_T * W; e += MSS_THREADS) tile[e] = 0.f;
  } else if constexpr (W % 4 == 0) {
    if (vec) {
      stage_v<W, 4>(tile, x, c0, ld, bb, t0, S);
    } else {
      stage_v<W, 1>(tile, x, c0, ld, bb, t0, S);
    }
  } else {
    stage_v<W, 1>(tile, x, c0, ld, bb, t0, S);
  }
}

template <int P>
__device__ __forceinline__ void load_p(const float* p, float (&v)[P]) {
  static_assert(P == 2 || P == 4, "a lane holds 2 or 4 states");
  if constexpr (P == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

// v[0 .. N) summed over the warp's 32 / L rows (lanes L * M apart), by
// halving: at row distance M a lane keeps the half of its window picked by
// bit M of its row g and adds its partner's copy of that half.  On return
// a lane holds max(1, V / rows) sums, of the values first_sum(g), ...
template <int L, int V, int N, int M>
__device__ __forceinline__ void sum_rows(float (&v)[V], int g) {
  if constexpr (M < 32 / L) {
    const bool up = (g & M) != 0;
    if constexpr (N > 1) {
      constexpr int H = N / 2;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = up ? v[j] : v[j + H];
        const float keep = up ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, M * L);
      }
      sum_rows<L, V, H, 2 * M>(v, g);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M * L);
      sum_rows<L, V, 1, 2 * M>(v, g);
    }
  }
}

// the first value whose sum sum_rows leaves with row g
template <int L, int V>
__device__ __forceinline__ int first_sum(int g) {
  int idx = 0;
#pragma unroll
  for (int m = 1, n = V; m < 32 / L && n > 1; m <<= 1) {
    n /= 2;
    if (g & m) idx += n;
  }
  return idx;
}

// Floats of one stage of the ring: dt, u, dy (T x R) and Bc, C (T x STP).
// After the two stages the dynamic shared memory holds the warps' sums and
// the block's sums (double buffered for the cluster).
__host__ __device__ constexpr int stage_floats(int R, int stp) {
  return 3 * MSS_T * R + 2 * MSS_T * stp;
}

// L lanes a row, each holding P of its states
template <int L, int P = MSS_P>
__global__ void __launch_bounds__(MSS_THREADS, MSS_MINB)
mamba_ssm_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ u, const float* __restrict__ Bc,
                     const float* __restrict__ C, const float* __restrict__ h0,
                     const float* __restrict__ dy,
                     const float* __restrict__ dh_last,
                     float* __restrict__ ddt, float* __restrict__ du,
                     float* __restrict__ dh0, float* __restrict__ dA_part,
                     float* __restrict__ part, float* __restrict__ hck, int S,
                     int di, int st, int vec_rows, int vec_st) {
  constexpr int STP = L * P;   // states a row, padded
  constexpr int G = 32 / L;    // rows a warp
  constexpr int V = 2 * P;     // a lane's values summed over d_inner
  constexpr int NV = V >= G ? V / G : 1;  // of which it keeps this many
  constexpr int W2 = 2 * STP;  // dBc's and dC's columns a step
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();

  constexpr int NW = MSS_THREADS / 32;  // warps a block
  constexpr int R = NW * G;             // rows a block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / L;
  const int k = lane % L;
  const int r_in = warp * G + g;
  const int row0 = blockIdx.x * R;
  const int row = row0 + r_in;
  const int bb = blockIdx.y;
  const bool row_live = row < di;
  const int rowc = row_live ? row : 0;
  const int nc = (S + MSS_T - 1) / MSS_T;
  constexpr int sn = stage_floats(R, STP);
  float* red = smem + 2 * sn;           // [NW][T][W2]
  float* clb = red + NW * MSS_T * W2;   // [2][T][W2]

  float Ar[P];
  bool sl[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int s = k * P + j;
    sl[j] = row_live && s < st;
    Ar[j] = sl[j] ? A[(size_t)rowc * st + s] : 0.f;
  }
  const size_t hbase = ((size_t)bb * di + rowc) * st + k * P;  // (B, di, st)
  const size_t hstep = (size_t)di * st;
  float* hck_p = hck + ((size_t)bb * nc * di + rowc) * st + k * P;

  // ---- 1. h forward, h at each chunk start kept; the last chunk's start
  // stays in registers
  float h[P];
#pragma unroll
  for (int j = 0; j < P; ++j) h[j] = sl[j] ? h0[hbase + j] : 0.f;
  if (nc > 1) {
    float* sg = smem;
    stage<R>(sg, dt, row0, di, bb, 0, S, vec_rows);
    stage<R>(sg + MSS_T * R, u, row0, di, bb, 0, S, vec_rows);
    stage<STP>(sg + 3 * MSS_T * R, Bc, 0, st, bb, 0, S, vec_st);
    cp_commit();
  }
  for (int c = 0; c < nc - 1; ++c) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (sl[j]) hck_p[(size_t)c * hstep + j] = h[j];
    if (c + 1 < nc - 1) {
      float* sg = smem + ((c + 1) & 1) * sn;
      const int t1 = (c + 1) * MSS_T;
      stage<R>(sg, dt, row0, di, bb, t1, S, vec_rows);
      stage<R>(sg + MSS_T * R, u, row0, di, bb, t1, S, vec_rows);
      stage<STP>(sg + 3 * MSS_T * R, Bc, 0, st, bb, t1, S, vec_st);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sg = smem + (c & 1) * sn;
#pragma unroll
    for (int i = 0; i < MSS_T; ++i) {
      const float dtv = sg[i * R + r_in];
      const float uv = sg[MSS_T * R + i * R + r_in];
      float bv[P];
      load_p<P>(sg + 3 * MSS_T * R + i * STP + k * P, bv);
#pragma unroll
      for (int j = 0; j < P; ++j)
        h[j] = fmaf(decay(dtv, Ar[j]), h[j], __fmul_rn(uv, bv[j]));  // as K3
    }
    __syncthreads();  // the stage is refilled two chunks on
  }

  // ---- 2. the reverse recurrence, chunk by chunk from the last.  The
  // columns of the warp's sums this lane holds after sum_rows (< STP: dBc
  // of that state, else dC); rows past the halving hold the same sums, and
  // one of them writes
  int col[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int x = first_sum<L, V>(g) + j;
    col[j] = (x < P ? 0 : STP) + k * P + x % P;
  }
  const bool writer = G <= V || (g & ~(V - 1)) == 0;
  float carry[P], dAacc[P], hnext[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    carry[j] = (sl[j] && dh_last) ? dh_last[hbase + j] : 0.f;
    dAacc[j] = 0.f;
    hnext[j] = h[j];
  }
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ncl = gridDim.x / cs;
  const int cl_id = blockIdx.x / cs;
  // chunk cc's sums over the cluster's blocks, in rank order, into part:
  // each block sums a slice of the chunk's T x W2 values
  auto flush = [&](int cc) {
    const int n = MSS_T * W2;
    const int per = (n + cs - 1) / cs;
    const int lo = rank * per;
    const int hi = min(n, lo + per);
    const int off = (cc & 1) * n;
    for (int e = lo + threadIdx.x; e < hi; e += MSS_THREADS) {
      const int t = cc * MSS_T + e / W2;
      float x[MSS_MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < MSS_MAX_CLUSTER; ++q)
        x[q] = q < cs ? cluster.map_shared_rank(clb, q)[off + e] : 0.f;
      float acc = x[0];
#pragma unroll
      for (int q = 1; q < MSS_MAX_CLUSTER; ++q)
        if (q < cs) acc += x[q];
      if (t < S)
        part[(((size_t)bb * S + t) * ncl + cl_id) * W2 + e % W2] = acc;
    }
  };
  {
    float* sg = smem + 0;
    const int t1 = (nc - 1) * MSS_T;
    stage<R>(sg, dt, row0, di, bb, t1, S, vec_rows);
    stage<R>(sg + MSS_T * R, u, row0, di, bb, t1, S, vec_rows);
    stage<R>(sg + 2 * MSS_T * R, dy, row0, di, bb, t1, S, vec_rows);
    stage<STP>(sg + 3 * MSS_T * R, Bc, 0, st, bb, t1, S, vec_st);
    stage<STP>(sg + 3 * MSS_T * R + MSS_T * STP, C, 0, st, bb, t1, S,
               vec_st);
    cp_commit();
  }
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * MSS_T;
    const int sidx = (nc - 1 - c) & 1;
    float hprev[P];
#pragma unroll
    for (int j = 0; j < P; ++j) hprev[j] = hnext[j];
    if (c > 0) {
      // the next chunk's checkpoint and tile go out before this chunk's work
#pragma unroll
      for (int j = 0; j < P; ++j)
        hnext[j] = sl[j] ? hck_p[(size_t)(c - 1) * hstep + j] : 0.f;
      float* sg = smem + (sidx ^ 1) * sn;
      const int t1 = t0 - MSS_T;
      stage<R>(sg, dt, row0, di, bb, t1, S, vec_rows);
      stage<R>(sg + MSS_T * R, u, row0, di, bb, t1, S, vec_rows);
      stage<R>(sg + 2 * MSS_T * R, dy, row0, di, bb, t1, S, vec_rows);
      stage<STP>(sg + 3 * MSS_T * R, Bc, 0, st, bb, t1, S, vec_st);
      stage<STP>(sg + 3 * MSS_T * R + MSS_T * STP, C, 0, st, bb, t1, S,
                 vec_st);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sg = smem + sidx * sn;
    const float* s_dt = sg;
    const float* s_u = sg + MSS_T * R;
    const float* s_dy = sg + 2 * MSS_T * R;
    const float* s_b = sg + 3 * MSS_T * R;
    const float* s_c = s_b + MSS_T * STP;
    float* ddt_c = ddt + ((size_t)bb * S + t0) * di + rowc;
    float* du_c = du + ((size_t)bb * S + t0) * di + rowc;

    // rebuild the chunk's h_t
    float hb[MSS_T][P];
    {
      float hh[P];
#pragma unroll
      for (int j = 0; j < P; ++j) hh[j] = hprev[j];
#pragma unroll
      for (int i = 0; i < MSS_T; ++i) {
        const float dtv = s_dt[i * R + r_in];
        const float uv = s_u[i * R + r_in];
        float bv[P];
        load_p<P>(s_b + i * STP + k * P, bv);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          hh[j] = fmaf(decay(dtv, Ar[j]), hh[j], __fmul_rn(uv, bv[j]));
          hb[i][j] = hh[j];
        }
      }
    }
    // the previous chunk's cluster sum, its barrier's latency hidden by the
    // rebuild
    if (c < nc - 1) {
      cluster_wait();
      flush(c + 1);
    }
    // walk it backwards
#pragma unroll
    for (int i = MSS_T - 1; i >= 0; --i) {
      const int t = t0 + i;
      if (t < S) {  // the same for every thread: the shuffles stay full
        const float dtv = s_dt[i * R + r_in];
        const float uv = s_u[i * R + r_in];
        const float dyv = s_dy[i * R + r_in];
        float bv[P], cv[P], v[V];
        load_p<P>(s_b + i * STP + k * P, bv);
        load_p<P>(s_c + i * STP + k * P, cv);
        float ddt_p = 0.f, du_p = 0.f;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float gj = fmaf(dyv, cv[j], carry[j]);
          const float hp = i > 0 ? hb[i - 1][j] : hprev[j];
          carry[j] = decay(dtv, Ar[j]) * gj;      // a_t g_t
          const float q = carry[j] * hp;          // g_t h_{t-1} a_t
          ddt_p = fmaf(q, Ar[j], ddt_p);
          dAacc[j] = fmaf(q, dtv, dAacc[j]);
          du_p = fmaf(gj, bv[j], du_p);
          v[j] = gj * uv;                         // dBc's part
          v[P + j] = dyv * hb[i][j];              // dC's part
        }
#pragma unroll
        for (int o = 1; o < L; o <<= 1) {
          ddt_p += __shfl_xor_sync(0xffffffffu, ddt_p, o);
          du_p += __shfl_xor_sync(0xffffffffu, du_p, o);
        }
        if (k == 0 && row_live) {
          ddt_c[(size_t)i * di] = ddt_p;
          du_c[(size_t)i * di] = du_p;
        }
        sum_rows<L, V, V, 1>(v, g);
        if (writer) {
#pragma unroll
          for (int j = 0; j < NV; ++j)
            red[(warp * MSS_T + i) * W2 + col[j]] = v[j];
        }
      }
    }
    __syncthreads();
    // the block's warps, in order.  Every block of the cluster has read
    // this buffer's previous chunk (c + 2) before it arrived after chunk
    // c + 1, which the wait above saw.
    float* cb = clb + (c & 1) * MSS_T * W2;
    for (int e = threadIdx.x; e < MSS_T * W2; e += MSS_THREADS) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) acc += red[w * MSS_T * W2 + e];
      cb[e] = acc;
    }
    cluster_arrive();
  }
  cluster_wait();
  flush(0);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (sl[j]) {
      dA_part[hbase + j] = dAacc[j];
      if (dh0) dh0[hbase + j] = carry[j];
    }
  }
  // no block leaves while another reads its shared memory
  cluster_arrive();
  cluster_wait();
}

// dBc[bs, s] and dC[bs, s]: part summed over the clusters in order;
// dA[r, s]: dA_part summed over the batch in order
__global__ void mamba_ssm_bwd_sum_kernel(const float* __restrict__ part,
                                         const float* __restrict__ dA_part,
                                         float* __restrict__ dBc,
                                         float* __restrict__ dC,
                                         float* __restrict__ dA, long nbs,
                                         int ncl, int stp, int st, int B,
                                         int di) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long n1 = nbs * st;
  if (idx < n1) {
    const long bs = idx / st;
    const int s = (int)(idx - bs * st);
    const float* p = part + (size_t)bs * ncl * 2 * stp + s;
    float ab = 0.f, ac = 0.f;
    for (int q = 0; q < ncl; ++q) {
      ab += p[(size_t)q * 2 * stp];
      ac += p[(size_t)q * 2 * stp + stp];
    }
    dBc[idx] = ab;
    dC[idx] = ac;
  } else if (idx < n1 + (long)di * st) {
    const long j = idx - n1;
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += dA_part[(size_t)b * di * st + j];
    dA[j] = acc;
  }
}

// a = decay(dt, A) over (n, di, st): the exp the kernel computes, for a
// check against torch.exp(dt[..., None] * A)
__global__ void mamba_ssm_decay_kernel(const float* __restrict__ dt,
                                       const float* __restrict__ A,
                                       float* __restrict__ a, long n, int di,
                                       int st) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * di * st) return;
  const long ds = (long)di * st;
  const long r = idx % ds;
  a[idx] = decay(dt[(idx / ds) * di + r / st], A[r]);
}

static int state_pad(int st, int p) {
  int stp = p;
  while (stp < st) stp *= 2;
  return stp;
}

template <int L>
struct Lanes {};

// f(Lanes<L>()) for a row of `lanes` lanes
template <typename F>
static int dispatch(int lanes, F&& f) {
  switch (lanes) {
    case 1: return f(Lanes<1>());
    case 2: return f(Lanes<2>());
    case 4: return f(Lanes<4>());
    case 8: return f(Lanes<8>());
    default: return (int)cudaErrorInvalidValue;
  }
}

static cudaLaunchConfig_t config(dim3 grid, int cs, size_t smem,
                                 cudaStream_t s, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(MSS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int L>
static int launch(Lanes<L>, dim3 grid, int cs, size_t smem, cudaStream_t s,
                  const float* const* f, float* ddt, float* du, float* dh0,
                  float* dA_part, float* part, float* hck, int S, int di,
                  int st, int vec_rows, int vec_st) {
  auto kern = mamba_ssm_bwd_kernel<L>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(grid, cs, smem, s, &attr);
  return (int)cudaLaunchKernelEx(&cfg, kern, f[0], f[1], f[2], f[3], f[4],
                                 f[5], f[6], f[7], ddt, du, dh0, dA_part,
                                 part, hck, S, di, st, vec_rows, vec_st);
}

template <int L>
static int occupancy(Lanes<L>, int cs, size_t smem, int* out) {
  auto kern = mamba_ssm_bwd_kernel<L>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern,
                                                        MSS_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3(cs), cs, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(&out[1], kern, &cfg);
}

extern "C" {

int mamba_ssm_bwd_max_st(void) { return MSS_MAX_ST; }

int mamba_ssm_bwd_chunk(void) { return MSS_T; }

int mamba_ssm_bwd_threads(void) { return MSS_THREADS; }

// The launch's layout for d_inner di and state width st: out = {rows a
// block, blocks along d_inner, blocks a cluster, clusters along d_inner,
// bytes of dynamic shared memory, padded state width, states a lane}.
// Returns 0, or cudaErrorInvalidValue for a width the kernel is not built
// for.
int mamba_ssm_bwd_layout(int di, int st, int* out) {
  const int stp = state_pad(st, MSS_P);
  if (di <= 0 || st <= 0 || st > MSS_MAX_ST
      || dispatch(stp / MSS_P, [](auto) { return 0; }) != 0)
    return (int)cudaErrorInvalidValue;
  const int nwarps = MSS_THREADS / 32;
  const int R = nwarps * (32 / (stp / MSS_P));
  const int nbx = (di + R - 1) / R;
  int cs = MSS_MAX_CLUSTER;
  while (nbx % cs != 0) cs /= 2;
  const long floats = 2L * stage_floats(R, stp)
                      + (long)nwarps * MSS_T * 2 * stp
                      + 2L * MSS_T * 2 * stp;
  out[0] = R;
  out[1] = nbx;
  out[2] = cs;
  out[3] = nbx / cs;
  out[4] = (int)(floats * sizeof(float));
  out[5] = stp;
  out[6] = MSS_P;
  return 0;
}

// dt, u (B, S, di), A (di, st), Bc, C (B, S, st), h0 (B, di, st): f32,
// contiguous, on the current device.  dy (B, S, di) and dh_last
// (B, di, st): f32 or null (a zero cotangent).  Writes ddt, du (B, S, di),
// dBc, dC (B, S, st), dA (di, st) and, unless null, dh0 (B, di, st), all
// f32.  Scratch: hck (B, ceil(S / MSS_T), di, st), part (B, S, clusters,
// 2 * padded st) and dA_part (B, di, st), f32, sized by
// mamba_ssm_bwd_layout.  Launches on `stream` and does not synchronise.
// Returns cudaGetLastError() after the launches (0 on success).
int mamba_ssm_bwd(const void* dt, const void* A, const void* u,
                  const void* Bc, const void* C, const void* h0,
                  const void* dy, const void* dh_last, void* ddt, void* du,
                  void* dBc, void* dC, void* dA, void* dh0, void* hck,
                  void* part, void* dA_part, int B, int S, int di, int st,
                  void* stream) {
  int lay[7];
  if (B <= 0 || B > 65535 || S <= 0 || mamba_ssm_bwd_layout(di, st, lay) != 0)
    return (int)cudaErrorInvalidValue;
  const int R = lay[0], nbx = lay[1], cs = lay[2], ncl = lay[3];
  const size_t smem = (size_t)lay[4];
  const int stp = lay[5];
  const cudaStream_t s = (cudaStream_t)stream;
  auto al16 = [](const void* q) { return ((uintptr_t)q & 15) == 0; };
  const int vec_rows = di % 4 == 0 && R % 4 == 0 && al16(dt) && al16(u)
                       && (dy == nullptr || al16(dy));
  const int vec_st = st % 4 == 0 && al16(Bc) && al16(C);
  const float* f[8] = {(const float*)dt, (const float*)A, (const float*)u,
                       (const float*)Bc, (const float*)C, (const float*)h0,
                       (const float*)dy, (const float*)dh_last};
  const int err = dispatch(stp / MSS_P, [&](auto lanes) {
    return launch(lanes, dim3(nbx, B), cs, smem, s, f, (float*)ddt,
                  (float*)du, (float*)dh0, (float*)dA_part, (float*)part,
                  (float*)hck, S, di, st, vec_rows, vec_st);
  });
  if (err != (int)cudaSuccess) return err;
  const long nbs = (long)B * S;
  const long n = nbs * st + (long)di * st;
  mamba_ssm_bwd_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)part, (const float*)dA_part, (float*)dBc, (float*)dC,
      (float*)dA, nbs, ncl, stp, st, B, di);
  return (int)cudaGetLastError();
}

// For the launch mamba_ssm_bwd makes at (di, st): out = {blocks of the
// kernel resident on one SM, clusters resident on the card at once}.
// Returns 0 or the CUDA error.
int mamba_ssm_bwd_occupancy(int di, int st, int* out) {
  int lay[7];
  if (mamba_ssm_bwd_layout(di, st, lay) != 0)
    return (int)cudaErrorInvalidValue;
  return dispatch(lay[5] / MSS_P, [&](auto lanes) {
    return occupancy(lanes, lay[2], (size_t)lay[4], out);
  });
}

// a (n, di, st) = the kernel's exp(dt * A) for dt (n, di), A (di, st).
int mamba_ssm_bwd_decay(const void* dt, const void* A, void* a, long n,
                        int di, int st, void* stream) {
  if (n <= 0 || di <= 0 || st <= 0) return (int)cudaErrorInvalidValue;
  const long total = n * di * st;
  mamba_ssm_decay_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                           (cudaStream_t)stream>>>(
      (const float*)dt, (const float*)A, (float*)a, n, di, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
