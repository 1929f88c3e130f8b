// Whole SolveBak solve (paper Algorithm 1) in one launch: sweeps x columns
// in strict order, the per-sweep SSE and the stopping rule all on the card,
// with a true early exit and no host synchronisation per sweep.
//
// Replaces the TPU kernel repro/kernels/fused_solve.py::_fused_kernel with
// variant="bak" (the sequential per-column body of block_step, pallas_call
// in _fused_call).
//
// What bounds it on an H100.  4·n_sweeps·vars·obs·k FLOP against x read
// once per solve, so the roofline bound is the FLOP one.  In fact each
// column is a dependent reduction-then-update step (bak_column.cuh: one
// exchange through the cluster's shared memory per column, plus one step
// per sweep for the SSE), so n_sweeps·vars step latencies set its time.
// Each CTA's residual slice stays on chip (registers or shared memory) for
// the whole solve when it fits; x streams through the L2 every sweep into
// a cp.async ring one column ahead, and dispatch admits the solve only
// within the L2 budget (fused_fits).
//
// The column step is bak_column.cuh's, shared with bak_sweep.cu.  Every CTA
// computes the same SSE bits and so the same stop decision; CTA 0 (rank 0
// of cluster 0) owns the coefficients, the history and the scalar outputs.
//
// x is fp32 or bf16 (TX, precision "bf16"): the ring holds x_j in its own
// type, widened to fp32 in the dot and the update.
//
// C interface (ctypes; pointers and stream void*-sized; cudaError_t return):
//   bak_fused_grid(obs, k, min_obs, cluster, x_bytes, plan)  launch plan, 6 ints
//   bak_fused_launch(x_t, x_bytes, ...)              one whole solve
// x_bytes is x's element size: 4 for fp32, 2 for bf16.
#include <math.h>

#include "bak_column.cuh"

struct BakFusedParams {
  const void* x_t;      // (vars, obs) of TX
  const float* inv_cn;  // (vars,)
  const float* e0;      // (k, obs) initial residual
  const float* a0;      // (vars, k) initial coefficients
  float* coef;          // (vars, k)
  float* e;             // (k, obs)
  float* hist;          // (max_iter,)
  float* sse_out;       // (1,)
  int* n_out;           // (1,)
  int* conv_out;        // (1,)
  float* xchg;          // device exchange slots, or nullptr (one cluster)
  int nvars, obs, k, max_iter;
  int xw;               // bytes of one copy of x (bak_fetch)
  float atol_sse, rtol;
};

template <int KC, int EG, typename TX>
__global__ void BAKP_BOUNDS(TX) bak_fused_kernel(BakFusedParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[(BAKP_THREADS / 32) * 8];
  const BakCta c = bak_cta(smem, p.e, p.obs, p.k, EG == 0, p.xchg, sizeof(TX));
  const TX* x_t = static_cast<const TX*>(p.x_t);
  const bool owner = blockIdx.x == 0;
  BakRegs<KC, EG> er;
  if constexpr (EG != -2) bak_fetch(c, bak_stage<TX>(c, 0), x_t + c.o0, p.xw);  // x_0
  if (owner) {
    for (int i = threadIdx.x; i < p.nvars * p.k; i += blockDim.x) p.coef[i] = p.a0[i];
    for (int i = threadIdx.x; i < p.max_iter; i += blockDim.x) p.hist[i] = nanf("");
  }
  if constexpr (EG > 0) bak_load_regs<KC, EG>(c, p.e0, p.obs, p.k, er);
  bak_load_slice(c, p.e0, p.obs, EG > 0 ? 0 : p.k);  // its barrier orders coef too

  int step = 0, col = 0;              // steps (columns and SSEs); columns
  const float sse0 = bak_sse<KC, EG>(c, er, p.k, step++, s_red);
  float sse = sse0;
  bool converged = false, stop = false;
  int n = 0;
  while (n < p.max_iter && !stop) {
    for (int j = 0; j < p.nvars; ++j, ++col, ++step) {
      const float inv_j = __ldg(p.inv_cn + j);
      float* coef_j = p.coef + (size_t)j * p.k;
      // CTA 0 reads coef_j before the step, whose latency hides the read.
      const float cj = owner && (int)threadIdx.x < p.k ? coef_j[threadIdx.x] : 0.f;
      // The last column prefetches column 0 of a next sweep that may not
      // run; that copy is waited for below.
      bak_column_step<KC, EG>(c, er, x_t, p.obs, x_t + (size_t)j * p.obs + c.o0,
                              j + 1 < p.nvars ? j + 1 : 0, col, step, inv_j, p.k, p.xw,
                              s_red);
      if (owner)
        for (int r = threadIdx.x; r < p.k; r += blockDim.x)
          coef_j[r] = (r == (int)threadIdx.x ? cj : coef_j[r]) + c.s_g[r] * inv_j;
    }
    const float sse_new = bak_sse<KC, EG>(c, er, p.k, step++, s_red);
    if (owner && threadIdx.x == 0) p.hist[n] = sse_new;
    sweep_stop_flags(sse_new, sse, sse0, p.atol_sse, p.rtol, &converged, &stop);
    sse = sse_new;
    ++n;
  }
  cp_async_wait<0>();
  if constexpr (EG > 0) bak_store_regs<KC, EG>(c, p.e, p.obs, p.k, er);
  else bak_store_slice<EG == 0>(c, p.e, p.obs, p.k);
  if (owner && threadIdx.x == 0) {
    *p.sse_out = sse;
    *p.n_out = n;
    *p.conv_out = converged ? 1 : 0;
  }
  cl_cluster_sync();                  // no CTA leaves while the cluster reads it
}

template <int KC, typename TX>
static BakKernels<void (*)(BakFusedParams)> fused_kernels() {
  return {bak_fused_kernel<KC, -2, TX>, bak_fused_kernel<KC, -1, TX>, bak_fused_kernel<KC, 0, TX>,
          bak_fused_kernel<KC, 1, TX>, bak_fused_kernel<KC, BAK_REG_GROUPS, TX>};
}

template <int KC, typename TX>
static cudaError_t fused_launch(const BakFusedParams& p, int regime, int ctas,
                                int cluster, void* stream) {
  int eg = 0;
  size_t smem = 0;
  cudaError_t err = bak_launch_check(p.obs, p.k, regime, ctas, cluster, p.xchg, sizeof(TX),
                                     &eg, &smem);
  if (err != cudaSuccess) return err;
  return cl_launch(fused_kernels<KC, TX>().pick(eg), p, ctas, cluster,
                    regime != BAK_SINGLE_CLUSTER, smem, stream);
}

template <typename TX>
static int fused_grid(const TX*, int obs, int k, int min_obs, int cluster, int* plan) {
  switch (bakp_pick_kc(k)) {
    case 1: return bak_plan(fused_kernels<1, TX>(), obs, k, min_obs, cluster, sizeof(TX), plan);
    case 2: return bak_plan(fused_kernels<2, TX>(), obs, k, min_obs, cluster, sizeof(TX), plan);
    case 4: return bak_plan(fused_kernels<4, TX>(), obs, k, min_obs, cluster, sizeof(TX), plan);
    default: return bak_plan(fused_kernels<8, TX>(), obs, k, min_obs, cluster, sizeof(TX), plan);
  }
}

template <typename TX>
static int fused_run(const TX* x_t, const float* inv_cn, const float* e0, const float* a0,
                     float* coef, float* e, float* hist, float* sse_out, int* n_out,
                     int* conv_out, float* xchg, int nvars, int obs, int k, int max_iter,
                     float atol_sse, float rtol, int regime, int ctas, int cluster,
                     void* stream) {
  if (regime != BAK_SINGLE_CLUSTER && xchg == nullptr) return cudaErrorInvalidValue;
  BakFusedParams p{x_t, inv_cn, e0, a0, coef, e, hist, sse_out, n_out,
                   conv_out, regime == BAK_SINGLE_CLUSTER ? nullptr : xchg,
                   nvars, obs, k, max_iter,
                   cp_bytes(x_t, (long long)obs * sizeof(TX), 4 * sizeof(TX)), atol_sse, rtol};
  switch (bakp_pick_kc(k)) {
    case 1: return fused_launch<1, TX>(p, regime, ctas, cluster, stream);
    case 2: return fused_launch<2, TX>(p, regime, ctas, cluster, stream);
    case 4: return fused_launch<4, TX>(p, regime, ctas, cluster, stream);
    default: return fused_launch<8, TX>(p, regime, ctas, cluster, stream);
  }
}

extern "C" int bak_fused_grid(int obs, int k, int min_obs, int cluster, int x_bytes,
                              int* plan) {
  return bakp_with_x(nullptr, x_bytes, [&](auto x) {
    return fused_grid(x, obs, k, min_obs, cluster, plan);
  });
}

extern "C" int bak_fused_launch(const void* x_t, int x_bytes, const float* inv_cn,
                                const float* e0, const float* a0, float* coef,
                                float* e, float* hist, float* sse_out,
                                int* n_out, int* conv_out, float* xchg,
                                int nvars, int obs, int k, int max_iter,
                                float atol_sse, float rtol, int regime,
                                int ctas, int cluster, void* stream) {
  return bakp_with_x(x_t, x_bytes, [&](auto x) {
    return fused_run(x, inv_cn, e0, a0, coef, e, hist, sse_out, n_out, conv_out, xchg, nvars,
                     obs, k, max_iter, atol_sse, rtol, regime, ctas, cluster, stream);
  });
}
