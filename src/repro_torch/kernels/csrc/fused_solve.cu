// Whole SolveBakP solve (paper Algorithm 2) in one launch with the design
// kept on chip: sweeps over x's column blocks, the per-sweep SSE and the
// stopping rule all on the card, with a true early exit and no host
// synchronisation per sweep.
//
// Replaces the TPU kernel repro/kernels/fused_solve.py::_fused_kernel with
// variant="bakp" (pallas_call in _fused_call), which keeps the whole design
// resident in VMEM.
//
// What bounds it on an H100.  The work is 4·n_sweeps·vars·obs·k FLOP; the
// bytes that must cross device memory are x once per solve plus the small
// vectors, so the roofline bound is the FLOP one at several sweeps.  At the
// shapes the port runs, the latency of a block step sets the time: each
// step reduces the block's inner products across the whole grid before any
// CTA can update its residual.  So the step is bakp_cluster.cuh's, on
// thread-block clusters with no grid-wide barrier (a reduce-scatter and an
// all-gather over distributed shared memory, step-tagged words through L2
// between clusters), and the loop is bakp_solve.cuh's, shared with
// stream_solve.cu.
//
// Where x lives (x_in, the counterpart of the TPU kernel's VMEM-resident
// x): dispatch (fused_fits) admits a design whose working set fits a 40 MiB
// L2 budget.
//   x_shared (BAKP_X_SHARED)  each CTA keeps its (vars × L) slice of x in
//       shared memory for the whole launch, copied once with cp.async; the
//       plan takes as many CTAs as that needs (up to one an SM).
//   x_l2 (BAKP_X_RING)  over that (about 23 MB of x on 112-132 CTAs), each
//       block's tile streams from the L2 through the two-stage ring.
//   x_l2, direct (BAKP_X_DIRECT)  where not even the ring fits a CTA
//       (large blocks, or a residual slice too large for shared memory), x
//       and the residual are read in place from the L2.
// Where the exchange arrays of every right-hand side do not fit beside the
// rest (block 256 at k 64, say), each block step runs its right-hand sides
// in groups, in one launch with one joint stop (bakp_solve.cuh).
//
// x is fp32 or bf16 (TX): a bf16 x (precision "bf16") is read as it is
// stored, half the bytes, and widened to fp32 in the block step; its
// x_shared slice takes half the shared memory, so designs twice as wide
// keep their slice on chip.  Every kernel is instantiated for both types.
//
// C interface (ctypes; pointers and stream void*-sized; cudaError_t return):
//   bakp_fused_clusters(k, cluster, smem, &n)  clusters the card holds
//   bakp_fused_launch(x_t, x_bytes, ...)        one whole solve on `stream`; x_t
//                                               fp32 (x_bytes 4) or bf16 (2)
#include "bakp_solve.cuh"

template <int KC, int SRC, typename TX>
__global__ void BAKP_BOUNDS(TX) bakp_fused_kernel(BakpSolveParams p) {
  extern __shared__ __align__(16) float smem[];
  bakp_solve<KC, SRC, TX>(p, smem);
}

template <int KC, typename TX>
static void* fused_kernel(int src) {
  switch (src) {
    case BAKP_X_SHARED: return (void*)bakp_fused_kernel<KC, BAKP_X_SHARED, TX>;
    case BAKP_X_RING: return (void*)bakp_fused_kernel<KC, BAKP_X_RING, TX>;
    default: return (void*)bakp_fused_kernel<KC, BAKP_X_DIRECT, TX>;
  }
}

// The kernel for `group` right-hand sides a step and tile source src.
template <typename TX>
static void* fused_pick(int group, int src) {
  switch (bakp_pick_kc(group)) {
    case 1: return fused_kernel<1, TX>(src);
    case 2: return fused_kernel<2, TX>(src);
    case 4: return fused_kernel<4, TX>(src);
    default: return fused_kernel<8, TX>(src);
  }
}

// Clusters of `cluster` CTAs the card holds at once with `smem` bytes a
// CTA (at least half an SM's, so one CTA an SM whatever the tile source
// and x's type; asked of the fp32 x_shared kernel for `k` right-hand sides
// a step).
extern "C" int bakp_fused_clusters(int k, int cluster, int smem, int* n) {
  if (cluster < 1 || cluster > BAKP_MAX_CLUSTER || k < 1) return (int)cudaErrorInvalidValue;
  size_t s = 0;
  cudaError_t err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  return (int)cl_max_clusters((void (*)(BakpSolveParams))fused_pick<float>(k, BAKP_X_SHARED),
                              cluster, s, n);
}

template <typename TX>
static int fused_launch(const TX* x_t, const float* inv_cn, const float* e0, const float* a0,
                        float* coef, float* e, float* hist, float* sse_out, int* n_out,
                        int* conv_out, void* xchg, unsigned tag0, int nvars, int obs, int k,
                        int block, int group, int max_iter, float atol_sse, float rtol,
                        float omega, int x_in, int regime, int ctas, int cluster, int smem,
                        void* stream) {
  // The plan the caller made must leave room for what the kernel carves.
  if (x_in < BAKP_X_SHARED || x_in > BAKP_X_DIRECT || group < 1 || group > k || block < 1 ||
      nvars % block != 0)
    return (int)cudaErrorInvalidValue;
  const size_t need = sizeof(float) * bakp_solve_smem_floats(x_in, nvars, obs, ctas, cluster,
                                                             k, group, block, sizeof(TX));
  cudaError_t err = bakp_plan_check(obs, regime, ctas, cluster, xchg, need, (size_t)smem);
  size_t s = 0;
  if (err == cudaSuccess) err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  BakpSolveParams p{x_t, inv_cn, e0, a0, coef, e, hist, sse_out, n_out, conv_out,
                    regime == BAKP_SINGLE_CLUSTER ? nullptr : xchg, tag0, nvars, obs, k,
                    block, group, max_iter, atol_sse, rtol, omega,
                    cp_bytes(x_t, (long long)obs * sizeof(TX), 16)};
  return (int)cl_launch((void (*)(BakpSolveParams))fused_pick<TX>(group, x_in), p, ctas,
                        cluster, regime != BAKP_SINGLE_CLUSTER, s, stream);
}

extern "C" int bakp_fused_launch(const void* x_t, int x_bytes, const float* inv_cn,
                                 const float* e0, const float* a0, float* coef,
                                 float* e, float* hist, float* sse_out,
                                 int* n_out, int* conv_out, void* xchg,
                                 unsigned tag0, int nvars, int obs, int k,
                                 int block, int group, int max_iter,
                                 float atol_sse, float rtol, float omega,
                                 int x_in, int regime, int ctas, int cluster,
                                 int smem, void* stream) {
  return bakp_with_x(x_t, x_bytes, [&](auto x) {
    return fused_launch(x, inv_cn, e0, a0, coef, e, hist, sse_out, n_out, conv_out, xchg, tag0,
                        nvars, obs, k, block, group, max_iter, atol_sse, rtol, omega, x_in,
                        regime, ctas, cluster, smem, stream);
  });
}
