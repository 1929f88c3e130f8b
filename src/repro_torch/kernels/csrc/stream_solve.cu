// Whole SolveBakP solve (paper Algorithm 2) with x left in device memory:
// every column block's tile streams through a two-stage shared-memory ring
// while the residual, the coefficients and the stop state stay on chip, and
// the sweeps, the SSE and the stopping rule all run in one launch with a
// true early exit.
//
// Replaces the TPU kernel repro/kernels/stream_solve.py::_stream_kernel
// (pallas_call in _stream_call).
//
// What bounds it on an H100.  x crosses device memory once per sweep, so
// at k ≤ 16 the bound is bytes: n_sweeps·vars·obs·4 over 3.35 TB/s.  The
// per-sweep kernel (bakp_sweep.cu) reads each block twice, and the
// whole-solve kernel (fused_solve.cu) keeps x in shared memory or in the
// L2, which needs the design within its 40 MiB budget.  Here each CTA copies its
// (block × L) slice of a block's tile into shared memory once and both
// phases of the block step read it there.  At the shapes the port runs the
// block step's latency, not bytes, sets the time, so the step runs on
// thread-block clusters with no grid-wide barrier (bakp_cluster.cuh).
//
// Decomposition: bakp_cluster.cuh's clusters of C CTAs, one CTA per SM,
// CTA q owning the obs slice [o0, o0 + L); the loop is bakp_solve.cuh's
// with tiles through its two-stage ring (BAKP_X_RING), every right-hand
// side in one group.  Shared memory of a CTA, all dynamic: the block step's
// exchange arrays (bakp_hdr_floats), then
//   ring   2 · block · L   two stages of the tile, row c at c·L
//   e      k · L           the CTA's residual slice, for the whole solve
//
// C interface (ctypes; pointers and stream void*-sized; cudaError_t return):
//   stream_solve_clusters(k, cluster, smem, &n)  clusters the card holds
//   stream_solve_launch(...)                     one whole solve on `stream`
#include "bakp_solve.cuh"

template <int KC>
__global__ void __launch_bounds__(BAKP_THREADS) stream_solve_kernel(BakpSolveParams p) {
  extern __shared__ __align__(16) float smem[];
  bakp_solve<KC, BAKP_X_RING>(p, smem);
}

static void* stream_pick(int k) {
  switch (bakp_pick_kc(k)) {
    case 1: return (void*)stream_solve_kernel<1>;
    case 2: return (void*)stream_solve_kernel<2>;
    case 4: return (void*)stream_solve_kernel<4>;
    default: return (void*)stream_solve_kernel<8>;
  }
}

extern "C" int stream_solve_clusters(int k, int cluster, int smem, int* n) {
  if (cluster < 1 || cluster > BAKP_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  size_t s = 0;
  cudaError_t err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  return (int)cl_max_clusters((void (*)(BakpSolveParams))stream_pick(k), cluster, s, n);
}

extern "C" int stream_solve_launch(const float* x_t, const float* inv_cn,
                                   const float* e0, const float* a0,
                                   float* coef, float* e, float* hist,
                                   float* sse_out, int* n_out, int* conv_out,
                                   void* xchg, unsigned tag0, int nvars, int obs, int k,
                                   int block, int max_iter, float atol_sse,
                                   float rtol, float omega, int regime,
                                   int ctas, int cluster, int smem,
                                   void* stream) {
  // The plan the caller made must leave room for what the kernel carves.
  const size_t need = sizeof(float) * bakp_solve_smem_floats(BAKP_X_RING, nvars, obs, ctas,
                                                             cluster, k, k, block);
  cudaError_t err = bakp_plan_check(obs, regime, ctas, cluster, xchg, need, (size_t)smem);
  size_t s = 0;
  if (err == cudaSuccess) err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  const int vec16 = obs % 4 == 0 && ((uintptr_t)x_t & 15) == 0;
  BakpSolveParams p{x_t, inv_cn, e0, a0, coef, e, hist, sse_out, n_out, conv_out,
                    regime == BAKP_SINGLE_CLUSTER ? nullptr : xchg, tag0, nvars, obs, k,
                    block, k, max_iter, atol_sse, rtol, omega, vec16};
  return (int)cl_launch((void (*)(BakpSolveParams))stream_pick(k), p, ctas, cluster,
                        regime != BAKP_SINGLE_CLUSTER, s, stream);
}
