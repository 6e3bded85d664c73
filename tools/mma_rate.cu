// Throughput of one warp-level tensor-core product (mma.sync) on the card:
// every warp issues `iters` rounds of 8 independent products (8
// accumulators, so each accumulator's chain has 7 other products between
// its steps), and the caller times the launch.  Used to read the ceiling
// of the mma.sync path that K2 (flash_attention.cu) runs on: m16n8k8 TF32
// (three per f32 product, 3xTF32) and m16n8k16 bf16.
#include <cuda_runtime.h>
#include <stdint.h>

template <bool TF32>
__global__ void mma_rate_kernel(float* out, int iters) {
  float d[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
  const uint32_t x = threadIdx.x * 0x01000193u;
  const uint32_t a[4] = {x, x ^ 1u, x ^ 2u, x ^ 3u}, b[2] = {x ^ 4u, x ^ 5u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" {

// kind 0: m16n8k8 TF32, 1: m16n8k16 bf16.  out holds blocks*threads
// floats.  Returns cudaGetLastError() after the launch.
int mma_rate(int kind, float* out, int blocks, int threads, int iters,
             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    mma_rate_kernel<true><<<blocks, threads, 0, s>>>(out, iters);
  else
    mma_rate_kernel<false><<<blocks, threads, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
