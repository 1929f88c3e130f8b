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
// column is a grid-wide barrier (bak_column.cuh: one per column, plus one
// per sweep for the SSE), so n_sweeps·vars barrier latencies set its time.
// Each CTA's residual slice stays in shared memory for the whole solve when
// it fits; x is read through the L2 every sweep, as in fused_solve.cu, and
// dispatch admits the solve only within the same L2 budget (fused_fits).
//
// The column step is bak_column.cuh's, shared with bak_sweep.cu.  Every CTA
// computes the same SSE bits and so the same stop decision; CTA 0 owns the
// coefficients, the history and the scalar outputs.
//
// C interface (ctypes; pointers and stream void*-sized; cudaError_t return):
//   bak_fused_grid(obs, k, min_obs, &grid, &e_smem)  launch plan
//   bak_fused_launch(...)                             one whole solve
#include <math.h>

#include "bak_column.cuh"

struct BakFusedParams {
  const float* x_t;     // (vars, obs)
  const float* inv_cn;  // (vars,)
  const float* e0;      // (k, obs) initial residual
  const float* a0;      // (vars, k) initial coefficients
  float* coef;          // (vars, k)
  float* e;             // (k, obs)
  float* hist;          // (max_iter,)
  float* sse_out;       // (1,)
  int* n_out;           // (1,)
  int* conv_out;        // (1,)
  float* partials;      // (2, grid, k) scratch
  float* sse_part;      // (grid,) scratch
  int nvars, obs, k, max_iter, e_smem;
  float atol_sse, rtol;
};

template <int KC, int XB>
__global__ void __launch_bounds__(BAKP_THREADS) bak_fused_kernel(BakFusedParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float s_red[(BAKP_THREADS / 32) * 8];
  const BakCta c = bak_cta(smem, p.e, p.obs, p.k, p.e_smem != 0);
  const bool owner = blockIdx.x == 0;
  if (owner) {
    for (int i = threadIdx.x; i < p.nvars * p.k; i += blockDim.x) p.coef[i] = p.a0[i];
    for (int i = threadIdx.x; i < p.max_iter; i += blockDim.x) p.hist[i] = nanf("");
  }
  bak_load_slice(c, p.e0, p.obs, p.k);

  const float sse0 = bak_grid_sse(grid, c, p.k, p.sse_part, s_red);
  float sse = sse0;
  bool converged = false, stop = false;
  int n = 0, step = 0;
  while (n < p.max_iter && !stop) {
    for (int j = 0; j < p.nvars; ++j, ++step) {
      const float inv_j = __ldg(p.inv_cn + j);
      bak_column_step<KC, XB>(grid, p.x_t + (size_t)j * p.obs, inv_j, c,
                              p.k, p.partials, step, s_red);
      if (owner)
        for (int r = threadIdx.x; r < p.k; r += blockDim.x)
          p.coef[(size_t)j * p.k + r] += c.s_g[r] * inv_j;
    }
    const float sse_new = bak_grid_sse(grid, c, p.k, p.sse_part, s_red);
    if (owner && threadIdx.x == 0) p.hist[n] = sse_new;
    sweep_stop_flags(sse_new, sse, sse0, p.atol_sse, p.rtol, &converged, &stop);
    sse = sse_new;
    ++n;
  }
  bak_store_slice(c, p.e, p.obs, p.k);
  if (owner && threadIdx.x == 0) {
    *p.sse_out = sse;
    *p.n_out = n;
    *p.conv_out = converged ? 1 : 0;
  }
}

template <int KC>
static cudaError_t fused_plan(int obs, int k, int min_obs, int* grid, int* e_smem) {
  return bak_plan(bak_fused_kernel<KC, BAK_X_BATCH>, obs, k, min_obs, grid, e_smem);
}

template <int KC>
static cudaError_t fused_launch(const BakFusedParams& p, int grid, void* stream) {
  const int L = bakp_slice_len(p.obs, grid);
  const size_t smem = bak_smem_bytes(L, p.k, p.e_smem != 0);
  if (bak_x_batched(L))
    return bakp_launch_coop(bak_fused_kernel<KC, BAK_X_BATCH>, p, grid, smem, stream);
  return bakp_launch_coop(bak_fused_kernel<KC, 1>, p, grid, smem, stream);
}

extern "C" int bak_fused_grid(int obs, int k, int min_obs, int* grid, int* e_smem) {
  switch (bakp_pick_kc(k)) {
    case 1: return fused_plan<1>(obs, k, min_obs, grid, e_smem);
    case 2: return fused_plan<2>(obs, k, min_obs, grid, e_smem);
    case 4: return fused_plan<4>(obs, k, min_obs, grid, e_smem);
    default: return fused_plan<8>(obs, k, min_obs, grid, e_smem);
  }
}

extern "C" int bak_fused_launch(const float* x_t, const float* inv_cn,
                                const float* e0, const float* a0, float* coef,
                                float* e, float* hist, float* sse_out,
                                int* n_out, int* conv_out, float* partials,
                                float* sse_part, int nvars, int obs, int k,
                                int max_iter, float atol_sse, float rtol,
                                int grid, int e_smem, void* stream) {
  BakFusedParams p{x_t, inv_cn, e0, a0, coef, e, hist, sse_out, n_out,
                   conv_out, partials, sse_part, nvars, obs, k, max_iter,
                   e_smem, atol_sse, rtol};
  switch (bakp_pick_kc(k)) {
    case 1: return fused_launch<1>(p, grid, stream);
    case 2: return fused_launch<2>(p, grid, stream);
    case 4: return fused_launch<4>(p, grid, stream);
    default: return fused_launch<8>(p, grid, stream);
  }
}
