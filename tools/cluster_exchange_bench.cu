// Per-step latency of the exchange primitives a thread-block cluster offers
// on Hopper, as the Algorithm-1 column step (src/repro_torch/kernels/csrc/
// bak_column.cuh) would use them: one cluster of C CTAs of 256 threads, one
// CTA per SM, runs a loop of dependent steps, and the time per step is
// printed for
//   syncthreads       __syncthreads alone;
//   cluster barrier   barrier.cluster.arrive.release + wait.acquire;
//   push+wait         lane q writes k floats into CTA q's shared memory with
//                     st.shared::cluster and arrives on its mbarrier with
//                     mbarrier.arrive.release.cluster; every thread waits on
//                     its own mbarrier;
//   st.async          the same k floats written with st.async, whose bytes
//                     complete on the remote mbarrier (complete_tx), the
//                     receiver expecting them with arrive.expect_tx;
//   reduce+push+wait  a warp and CTA reduction, then push+wait.
// Build and run on one H100:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o cluster_exchange_bench tools/cluster_exchange_bench.cu
//   ./cluster_exchange_bench
#include <cstdio>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned mapa(unsigned a, int r) { unsigned o; asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(o) : "r"(a), "r"(r)); return o; }
__device__ __forceinline__ void csync() { asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;" ::: "memory"); }
__device__ __forceinline__ void wait_par(unsigned a, unsigned p) {
  asm volatile("{\n.reg .pred d;\nW:\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 d, [%0], %1;\n@!d bra W;\n}\n" :: "r"(a), "r"(p) : "memory"); }

template <int MODE>
__global__ void __launch_bounds__(256) kern(int steps, float* out, int k) {
  __shared__ __align__(16) unsigned long long bar[2];
  __shared__ __align__(16) float rx[2][16][8];
  __shared__ float red[8];
  cg::cluster_group cl = cg::this_cluster();
  const int C = cl.num_blocks(), rank = cl.block_rank();
  const unsigned b0 = (unsigned)__cvta_generic_to_shared(&bar[0]);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      unsigned cnt = MODE == 3 ? 1 : C;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(b0 + 8 * b), "r"(cnt));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  csync();
  float acc = threadIdx.x;
  for (int s = 0; s < steps; ++s) {
    const int p = s & 1;
    if (MODE == 0) {           // __syncthreads only
      __syncthreads();
    } else if (MODE == 1) {    // cluster barrier
      csync();
    } else if (MODE == 2) {    // push (st.shared::cluster + arrive.release) + wait
      if (threadIdx.x < C) {
        const int q = threadIdx.x;
        const unsigned dst = mapa((unsigned)__cvta_generic_to_shared(&rx[p][rank][0]), q);
        for (int r = 0; r < k; ++r) asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(dst + 4 * r), "f"(acc) : "memory");
        asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" :: "r"(mapa(b0 + 8 * p, q)) : "memory");
      }
      wait_par(b0 + 8 * p, (s >> 1) & 1);
      acc += rx[p][(rank + 1) % C][0];
    } else if (MODE == 3) {    // st.async complete_tx + expect_tx
      if (threadIdx.x == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(b0 + 8 * p), "r"(C * k * 4) : "memory");
      if (threadIdx.x < C) {
        const int q = threadIdx.x;
        const unsigned dst = mapa((unsigned)__cvta_generic_to_shared(&rx[p][rank][0]), q);
        const unsigned rb = mapa(b0 + 8 * p, q);
        for (int r = 0; r < k; ++r)
          asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" :: "r"(dst + 4 * r), "r"(__float_as_uint(acc)), "r"(rb) : "memory");
      }
      wait_par(b0 + 8 * p, (s >> 1) & 1);
      acc += rx[p][(rank + 1) % C][0];
    } else if (MODE == 4) {    // CTA reduce (warp sum + smem + syncthreads) + push + wait
      float v = acc;
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
      __syncthreads();
      if (threadIdx.x < C) {
        float t = 0; for (int w = 0; w < 8; ++w) t += red[w];
        const int q = threadIdx.x;
        const unsigned dst = mapa((unsigned)__cvta_generic_to_shared(&rx[p][rank][0]), q);
        for (int r = 0; r < k; ++r) asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(dst + 4 * r), "f"(t) : "memory");
        asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" :: "r"(mapa(b0 + 8 * p, q)) : "memory");
      }
      wait_par(b0 + 8 * p, (s >> 1) & 1);
      float g = 0; for (int q = 0; q < C; ++q) g += rx[p][q][0];
      acc += g * 1e-9f;
    }
  }
  csync();
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

template <int MODE>
float run(int C, int steps, int k) {
  float* out; cudaMalloc(&out, 1024 * 4);
  auto fn = kern<MODE>;
  if (C > 8) cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 116 * 1024);
  cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(C); cfg.blockDim = dim3(256); cfg.dynamicSmemBytes = 116 * 1024;
  cudaLaunchAttribute a; a.id = cudaLaunchAttributeClusterDimension; a.val.clusterDim.x = C; a.val.clusterDim.y = 1; a.val.clusterDim.z = 1;
  cfg.attrs = &a; cfg.numAttrs = 1;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaLaunchKernelEx(&cfg, fn, steps, out, k);
  cudaEventRecord(e0);
  for (int i = 0; i < 5; ++i) cudaLaunchKernelEx(&cfg, fn, steps, out, k);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  cudaError_t err = cudaGetLastError();
  if (err) printf("err %d\n", err);
  cudaFree(out);
  return ms / 5 * 1e6 / steps;   // ns per step
}

int main() {
  const int steps = 20000;
  for (int C : {2, 4, 8, 16}) {
    printf("C=%2d syncthreads %.0f ns, cluster barrier %.0f ns, push+wait k1 %.0f k8 %.0f ns, st.async k1 %.0f k8 %.0f ns, reduce+push+wait k1 %.0f ns\n", C,
           run<0>(C, steps, 1), run<1>(C, steps, 1), run<2>(C, steps, 1), run<2>(C, steps, 8),
           run<3>(C, steps, 1), run<3>(C, steps, 8), run<4>(C, steps, 1));
  }
  return 0;
}
