// How fast can a CTA stream its slice of a (rows, obs) fp32 matrix from
// device memory into shared memory?  The access pattern of the per-sweep
// Algorithm-2 kernel (csrc/bakp_sweep.cu): CTA q owns the positions
// [q·L, q·L + L) of every row and walks the rows in chunks of R rows × P
// positions through a ring of S stages in shared memory; the consumer adds
// up each stage (so the copies cannot be skipped).  Four ways to fill a
// stage:
//   cpasync  16-byte cp.async.cg by every thread, one commit group a chunk
//   bulk     one cp.async.bulk (TMA) a row, by warp 0, onto the stage's
//            mbarrier
//   ldg      no ring: every thread loads float4s of the chunk into
//            registers (the reads a kernel without a ring would issue)
// Prints GB/s over the whole matrix (read once) for each configuration.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o ring_bench tools/ring_bench.cu
//   ./ring_bench
#include <cstdio>
#include <cuda_runtime.h>

#define THREADS 256

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void wait_n(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n"); break;
    default: asm volatile("cp.async.wait_group 5;\n"); break;
  }
}

__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nW:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra W;\n}\n" ::"r"(bar), "r"(parity & 1) : "memory");
}

struct Args {
  const float* x;
  float* out;
  int rows, obs, L, R, P, S, mode;
};

__global__ void __launch_bounds__(THREADS) ring_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bars[8];
  const int o0 = blockIdx.x * a.L;
  const int n = min(a.L, a.obs - o0);
  const int npc = (n + a.P - 1) / a.P;
  const int ngr = a.rows / a.R;
  const long long total = (long long)ngr * npc;
  const unsigned bar0 = (unsigned)__cvta_generic_to_shared(bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 8; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8 * s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float acc = 0.f;
  auto fetch = [&](long long q) {
    if (q < total) {
      const int g = (int)(q / npc), pc = (int)(q % npc);
      const int p0 = pc * a.P, np = min(a.P, n - p0);
      float* st = smem + (size_t)(q % a.S) * a.R * a.P;
      const float* src = a.x + (size_t)g * a.R * a.obs + o0 + p0;
      if (a.mode == 0) {
        const int n4 = np / 4;
        for (int i = threadIdx.x; i < a.R * n4; i += THREADS) {
          const int r = i / n4, c = i - r * n4;
          cp16(st + (size_t)r * a.P + 4 * c, src + (size_t)r * a.obs + 4 * c);
        }
      } else if (threadIdx.x < 32) {
        const unsigned bar = bar0 + 8 * (unsigned)(q % a.S);
        if (threadIdx.x == 0)
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                       ::"r"(bar), "r"(a.R * np * 4) : "memory");
        __syncwarp();
        for (int r = threadIdx.x; r < a.R; r += 32) {
          const unsigned d = (unsigned)__cvta_generic_to_shared(st + (size_t)r * a.P);
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
              " [%0], [%1], %2, [%3];\n"
              ::"r"(d), "l"(src + (size_t)r * a.obs), "r"(np * 4), "r"(bar) : "memory");
        }
      }
    }
    if (a.mode == 0) asm volatile("cp.async.commit_group;\n");
  };
  if (a.mode == 2) {
    for (long long q = 0; q < total; ++q) {
      const int g = (int)(q / npc), pc = (int)(q % npc);
      const int p0 = pc * a.P, np = min(a.P, n - p0);
      const float* src = a.x + (size_t)g * a.R * a.obs + o0 + p0;
      const int n4 = np / 4;
#pragma unroll 4
      for (int i = threadIdx.x; i < a.R * n4; i += THREADS) {
        const int r = i / n4, c = i - r * n4;
        const float4 v = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * a.obs) + c);
        acc += v.x + v.y + v.z + v.w;
      }
    }
  } else {
    for (int s = 0; s < a.S - 1; ++s) fetch(s);
    for (long long q = 0; q < total; ++q) {
      if (a.mode == 0) wait_n(a.S - 2);
      else mbar_wait(bar0 + 8 * (unsigned)(q % a.S), (int)(q / a.S));
      __syncthreads();
      fetch(q + a.S - 1);
      const float* st = smem + (size_t)(q % a.S) * a.R * a.P;
      for (int i = threadIdx.x; i < a.R * a.P; i += THREADS) acc += st[i];
    }
    if (a.mode == 0) wait_n(0);
  }
  if (acc == 12345.f) a.out[blockIdx.x] = acc;   // keeps the sums live
}

int main() {
  const int rows = 1024, obs = 262144;
  float* x;
  float* out;
  cudaMalloc(&x, (size_t)rows * obs * 4);
  cudaMemset(x, 0, (size_t)rows * obs * 4);
  cudaMalloc(&out, 4096);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaFuncSetAttribute(ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  const char* names[] = {"cpasync", "bulk", "ldg"};
  struct Cfg { int mode, ctas, R, P, S; } cfgs[] = {
      {0, 112, 32, 256, 3}, {0, 112, 32, 256, 4}, {0, 112, 32, 256, 6},
      {0, 132, 32, 256, 4}, {0, 112, 8, 1024, 4}, {0, 112, 4, 2368, 4},
      {1, 112, 32, 256, 4}, {1, 112, 4, 2368, 4}, {1, 112, 2, 2368, 6},
      {1, 132, 4, 2016, 4}, {2, 112, 32, 256, 1}, {2, 132, 32, 256, 1},
      {2, 264, 32, 256, 1}, {2, 396, 32, 256, 1}};
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (const Cfg& c : cfgs) {
    int L = (obs + c.ctas - 1) / c.ctas;
    L = (L + 31) / 32 * 32;
    const int P = c.P < L ? c.P : L;
    Args a{x, out, rows, obs, L, c.R, P, c.S, c.mode};
    const size_t smem = c.mode == 2 ? 0 : (size_t)c.S * c.R * P * 4;
    for (int it = 0; it < 2; ++it) ring_kernel<<<c.ctas, THREADS, smem>>>(a);
    cudaEventRecord(e0);
    const int iters = 10;
    for (int it = 0; it < iters; ++it) ring_kernel<<<c.ctas, THREADS, smem>>>(a);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    ms /= iters;
    const cudaError_t err = cudaGetLastError();
    printf("{\"fill\": \"%s\", \"ctas\": %d, \"rows\": %d, \"positions\": %d, \"stages\": %d, "
           "\"smem\": %zu, \"ms\": %.4f, \"gb_per_s\": %.1f, \"err\": %d}\n",
           names[c.mode], c.ctas, c.R, P, c.S, smem, ms,
           (double)rows * obs * 4 / (ms * 1e-3) / 1e9, (int)err);
  }
  printf("SMs %d\n", sms);
  return 0;
}
