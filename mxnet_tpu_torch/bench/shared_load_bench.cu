// Throughput of warp-wide 16-byte shared-memory loads (ld.shared.v4.f32)
// under several lane -> row patterns: the cost, in wavefronts, of the
// operand layouts the dK/dV kernel (csrc/flash_attention_bwd.cu) chooses
// between.  Rows are 68 floats apart (the kernel's D + 4 stride at D = 64),
// so distinct rows never share a bank group.  Each SM holds 64 warps that
// do nothing but load; the SM serves one 128-byte wavefront a clock, so the
// clocks per warp-wide load (printed as wavefronts, counted at 1.98 GHz)
// are the cost of one pattern.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o build/shared_load_bench mxnet_tpu_torch/bench/shared_load_bench.cu
//   build/shared_load_bench
#include <cstdio>
#include <cuda_runtime.h>

constexpr int LD = 68;
constexpr int WORDS = 64 * LD + 128;

__global__ void bench(const int* rows, float* out, int iters) {
  __shared__ __align__(16) float s[WORDS];
  for (int i = threadIdx.x; i < WORDS; i += blockDim.x) s[i] = i * 1e-3f;
  __syncthreads();
  const int off = rows[threadIdx.x & 31] * LD;
  float4 acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int it = 0; it < iters; ++it) {
    const int d = (it & 7) * 4;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float4 x;
      const unsigned a =
          (unsigned)__cvta_generic_to_shared(s + off + d + 4 * u);
      asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];"
                   : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
                   : "r"(a));
      acc[u].x += x.x;
      acc[u].y += x.y;
      acc[u].z += x.z;
      acc[u].w += x.w;
    }
  }
  float t = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) t += acc[u].x + acc[u].y + acc[u].z + acc[u].w;
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

struct Pattern {
  const char* name;
  int (*row)(int lane);
};

int main() {
  const int iters = 4096, blocks = 132 * 8, threads = 512;
  float* out;
  int* rows;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  cudaMalloc(&rows, sizeof(int) * 32);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const Pattern patterns[] = {
      {"all lanes one address", [](int l) { return 0; }},
      {"1 row a quarter-warp, quarters differ", [](int l) { return l >> 3; }},
      {"2 rows a quarter-warp, quarters differ",
       [](int l) { return 2 * (l >> 3) + ((l >> 2) & 1); }},
      {"2 rows a quarter-warp, the same in each",
       [](int l) { return (l >> 2) & 1; }},
      {"4 rows a quarter-warp, the same in each", [](int l) { return l & 3; }},
      {"4 rows a quarter-warp, quarters of a half differ",
       [](int l) { return (l & 3) + 4 * ((l >> 3) & 1); }},
      {"8 rows a quarter-warp, the same in each", [](int l) { return l & 7; }},
      {"32 distinct rows", [](int l) { return l; }},
  };
  for (int rep = 0; rep < 2; ++rep)
    for (const Pattern& p : patterns) {
      int h[32];
      for (int l = 0; l < 32; ++l) h[l] = p.row(l);
      cudaMemcpy(rows, h, sizeof(h), cudaMemcpyHostToDevice);
      bench<<<blocks, threads>>>(rows, out, iters);
      cudaEventRecord(e0);
      bench<<<blocks, threads>>>(rows, out, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      const double loads_per_sm = (double)blocks * (threads / 32) * iters * 8
                                  / 132;
      printf("%-50s ms=%.3f wavefronts=%.2f\n", p.name, ms,
             ms * 1e6 * 1.98 / loads_per_sm);
    }
  return cudaGetLastError() != cudaSuccess;
}
