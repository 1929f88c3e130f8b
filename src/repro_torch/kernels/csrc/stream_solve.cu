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
// at k ≤ 16 the bound is bytes: n_sweeps·vars·obs·itemsize over 3.35 TB/s.  The
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
// x is fp32 or bf16 (TX, precision "bf16"): a bf16 tile takes half the
// ring and half the bytes a sweep, widened to fp32 in the block step.
//
// C interface (ctypes; pointers and stream void*-sized; cudaError_t return):
//   stream_solve_clusters(k, cluster, smem, &n)  clusters the card holds
//   stream_solve_launch(x_t, x_bytes, ...)       one whole solve on `stream`; x_t
//                                                fp32 (x_bytes 4) or bf16 (2)
#include "bakp_solve.cuh"

template <int KC, typename TX>
__global__ void BAKP_BOUNDS(TX) stream_solve_kernel(BakpSolveParams p) {
  extern __shared__ __align__(16) float smem[];
  bakp_solve<KC, BAKP_X_RING, TX>(p, smem);
}

template <typename TX>
static void* stream_pick(int k) {
  switch (bakp_pick_kc(k)) {
    case 1: return (void*)stream_solve_kernel<1, TX>;
    case 2: return (void*)stream_solve_kernel<2, TX>;
    case 4: return (void*)stream_solve_kernel<4, TX>;
    default: return (void*)stream_solve_kernel<8, TX>;
  }
}

// Asked of the fp32 kernel: one CTA an SM whatever x's type.
extern "C" int stream_solve_clusters(int k, int cluster, int smem, int* n) {
  if (cluster < 1 || cluster > BAKP_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  size_t s = 0;
  cudaError_t err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  return (int)cl_max_clusters((void (*)(BakpSolveParams))stream_pick<float>(k), cluster, s, n);
}

template <typename TX>
static int stream_launch(const TX* x_t, const float* inv_cn, const float* e0, const float* a0,
                         float* coef, float* e, float* hist, float* sse_out, int* n_out,
                         int* conv_out, void* xchg, unsigned tag0, int nvars, int obs, int k,
                         int block, int max_iter, float atol_sse, float rtol, float omega,
                         int regime, int ctas, int cluster, int smem, void* stream) {
  // The plan the caller made must leave room for what the kernel carves.
  const size_t need = sizeof(float) * bakp_solve_smem_floats(BAKP_X_RING, nvars, obs, ctas,
                                                             cluster, k, k, block, sizeof(TX));
  cudaError_t err = bakp_plan_check(obs, regime, ctas, cluster, xchg, need, (size_t)smem);
  size_t s = 0;
  if (err == cudaSuccess) err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  BakpSolveParams p{x_t, inv_cn, e0, a0, coef, e, hist, sse_out, n_out, conv_out,
                    regime == BAKP_SINGLE_CLUSTER ? nullptr : xchg, tag0, nvars, obs, k,
                    block, k, max_iter, atol_sse, rtol, omega,
                    cp_bytes(x_t, (long long)obs * sizeof(TX), 16)};
  return (int)cl_launch((void (*)(BakpSolveParams))stream_pick<TX>(k), p, ctas, cluster,
                        regime != BAKP_SINGLE_CLUSTER, s, stream);
}

extern "C" int stream_solve_launch(const void* x_t, int x_bytes, const float* inv_cn,
                                   const float* e0, const float* a0,
                                   float* coef, float* e, float* hist,
                                   float* sse_out, int* n_out, int* conv_out,
                                   void* xchg, unsigned tag0, int nvars, int obs, int k,
                                   int block, int max_iter, float atol_sse,
                                   float rtol, float omega, int regime,
                                   int ctas, int cluster, int smem,
                                   void* stream) {
  return bakp_with_x(x_t, x_bytes, [&](auto x) {
    return stream_launch(x, inv_cn, e0, a0, coef, e, hist, sse_out, n_out, conv_out, xchg,
                         tag0, nvars, obs, k, block, max_iter, atol_sse, rtol, omega, regime,
                         ctas, cluster, smem, stream);
  });
}
