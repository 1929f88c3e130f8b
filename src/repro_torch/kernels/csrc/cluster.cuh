// Thread-block cluster primitives shared by the Algorithm-1 column step
// (bak_column.cuh) and the Algorithm-2 block step (bakp_cluster.cuh):
// distributed shared memory addresses, the cluster barrier, mbarriers that
// count the bytes of st.async pushes, 64-bit step-tagged words through L2
// for the exchange across clusters, and the clustered (optionally
// cooperative) launch with its occupancy query.
#pragma once

#include <stdint.h>

#include "bakp_block.cuh"

// The shared::cluster address of `addr` (a shared::cta address) in the CTA
// of cluster rank `rank`.
__device__ __forceinline__ unsigned cl_mapa(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void cl_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Thread 0: initialise `n` consecutive mbarriers at `bar` (8 bytes apart),
// one arrival a phase, visible to the cluster's st.async before any CTA
// of the cluster passes the caller's cluster barrier.
__device__ __forceinline__ void cl_mbar_init(unsigned bar, int n) {
  for (int b = 0; b < n; ++b)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar + 8 * b));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of the mbarrier's current phase, which also has it
// expect `bytes` more bytes (complete_tx of the pushes; they may land
// before or after it).
__device__ __forceinline__ void cl_mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of the given parity completed.  The bytes complete
// on this CTA's own mbarrier, so the default CTA-scope acquire makes them
// visible (a cluster-scope one would also invalidate the L1).
__device__ __forceinline__ void cl_mbar_wait(unsigned bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "CL_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra CL_WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity & 1) : "memory");
}

// Write 16 bytes to `dst` (shared::cluster) and complete them on the
// mbarrier `rbar` of the same CTA (shared::cluster).
__device__ __forceinline__ void cl_push4(unsigned dst, float4 v, unsigned rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
      " [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(rbar)
      : "memory");
}

__device__ __forceinline__ void cl_push1(unsigned dst, float v, unsigned rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
      ::"r"(dst), "r"(__float_as_uint(v)), "r"(rbar) : "memory");
}

__device__ __forceinline__ void cl_push8(unsigned dst, double v, unsigned rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n"
      ::"r"(dst), "l"(__double_as_longlong(v)), "r"(rbar) : "memory");
}

// A 64-bit exchange word: the step's tag above the value's 32 bits, in one
// single-copy-atomic store, so a reader that sees the tag sees the value.
__device__ __forceinline__ void cl_publish(unsigned long long* p, unsigned seq, unsigned bits) {
  const unsigned long long w = ((unsigned long long)seq << 32) | bits;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long cl_ld_word(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// The value bits of the exchange word at p once it carries tag seq.
__device__ __forceinline__ unsigned cl_poll(const unsigned long long* p, unsigned seq) {
  unsigned long long w = cl_ld_word(p);
  while ((unsigned)(w >> 32) != seq) w = cl_ld_word(p);
  return (unsigned)w;
}

// ------------------------------------------------------------- host side
// Shared memory a CTA asks for: at least half an SM's, so that one CTA
// runs on each SM and the clusters spread over the card.
static inline cudaError_t cl_launch_smem(size_t need, size_t* out) {
  int dev = 0, sm_smem = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  *out = need > (size_t)sm_smem / 2 ? need : (size_t)sm_smem / 2;
  return cudaSuccess;
}

template <typename F>
static cudaError_t cl_func_attrs(F fn, size_t smem, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || cluster <= 8) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Clusters of `cluster` CTAs the card holds at once at `smem` bytes a CTA.
template <typename F>
static cudaError_t cl_max_clusters(F fn, int cluster, size_t smem, int* out) {
  cudaError_t err = cl_func_attrs(fn, smem, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(BAKP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

// Launch fn as clusters of `cluster` CTAs, cooperatively when `coop`.  A
// refused launch returns the runtime's error; nothing falls back.
template <typename F, typename P>
static cudaError_t cl_launch(F fn, const P& params, int ctas, int cluster,
                             bool coop, size_t smem, void* stream) {
  cudaError_t err = cl_func_attrs(fn, smem, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(BAKP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = coop ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, fn, params);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
