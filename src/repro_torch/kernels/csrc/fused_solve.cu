// Whole SolveBakP solve (paper Algorithm 2) in one launch: sweeps x column
// blocks, the per-sweep SSE and the stopping rule all on the card, with a
// true early exit and no host synchronisation per sweep.
//
// Replaces the TPU kernel repro/kernels/fused_solve.py::_fused_kernel with
// variant="bakp" (pallas_call in _fused_call).
//
// What bounds it on an H100.  The work is 4·n_sweeps·vars·obs·k FLOP; the
// bytes that must cross device memory are x once per solve plus the small
// vectors, so the roofline bound is the FLOP one at several sweeps.  This
// first version does not stage x in shared memory: it reads x through the
// 50 MB L2 every sweep, and dispatch (fused_fits) admits it only when the
// whole working set fits an L2 budget, so after the first sweep x comes
// from L2.  Each column block costs two grid-wide barriers and each sweep
// one more for the SSE, so at small designs the barriers, not bytes or
// FLOP, set its time.
//
// The block step is bakp_block.cuh's, shared with bakp_sweep.cu.  Every CTA
// computes the same SSE bits (fixed-order reduction) and so the same stop
// decision; CTA 0 writes the history and the scalar outputs.
//
// C interface (ctypes; pointers and stream void*-sized; cudaError_t return):
//   bakp_fused_grid(k, block, &grid_max)  largest cooperative grid
//   bakp_fused_launch(...)                 one whole solve on `stream`
#include <math.h>

#include "bakp_block.cuh"

struct FusedParams {
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
  float* partials;      // (grid, block, k) scratch
  float* da_buf;        // (block, k) scratch
  float* sse_part;      // (grid,) scratch
  int nvars, obs, k, block, max_iter;
  float atol_sse, rtol, omega;
};

template <int KC>
__global__ void __launch_bounds__(BAKP_THREADS) bakp_fused_kernel(FusedParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float s_da[];
  __shared__ float s_red[33];
  const BakpSlice s = bakp_slice(p.obs);
  for (int r = 0; r < p.k; ++r)
    for (int o = s.o0 + threadIdx.x; o < s.o1; o += blockDim.x)
      p.e[(size_t)r * p.obs + o] = p.e0[(size_t)r * p.obs + o];
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int gs = gridDim.x * blockDim.x;
  for (int i = gt; i < p.nvars * p.k; i += gs) p.coef[i] = p.a0[i];
  for (int i = gt; i < p.max_iter; i += gs) p.hist[i] = nanf("");
  __syncthreads();

  const float sse0 = bakp_grid_sse(grid, p.e, p.obs, s.o0, s.o1, p.k,
                                   p.sse_part, s_red);
  float sse = sse0;
  bool converged = false, stop = false;
  int n = 0;
  const int nblocks = p.nvars / p.block;
  while (n < p.max_iter && !stop) {
    for (int b = 0; b < nblocks; ++b)
      bakp_block_step<KC>(grid, p.x_t, p.inv_cn, p.e, p.coef, true,
                          p.partials, p.da_buf, s_da, p.obs, p.k, p.block, b,
                          p.omega, s);
    const float sse_new =
        bakp_grid_sse(grid, p.e, p.obs, s.o0, s.o1, p.k, p.sse_part, s_red);
    if (gt == 0) p.hist[n] = sse_new;
    sweep_stop_flags(sse_new, sse, sse0, p.atol_sse, p.rtol, &converged, &stop);
    sse = sse_new;
    ++n;
  }
  if (gt == 0) {
    *p.sse_out = sse;
    *p.n_out = n;
    *p.conv_out = converged ? 1 : 0;
  }
}

template <int KC>
static cudaError_t fused_grid(int k, int block, int* out) {
  return bakp_max_grid(bakp_fused_kernel<KC>, (size_t)block * k * sizeof(float), out);
}

template <int KC>
static cudaError_t fused_launch(const FusedParams& p, int grid, void* stream) {
  return bakp_launch_coop(bakp_fused_kernel<KC>, p, grid,
                          (size_t)p.block * p.k * sizeof(float), stream);
}

extern "C" int bakp_fused_grid(int k, int block, int* grid_max) {
  switch (bakp_pick_kc(k)) {
    case 1: return fused_grid<1>(k, block, grid_max);
    case 2: return fused_grid<2>(k, block, grid_max);
    case 4: return fused_grid<4>(k, block, grid_max);
    default: return fused_grid<8>(k, block, grid_max);
  }
}

extern "C" int bakp_fused_launch(const float* x_t, const float* inv_cn,
                                 const float* e0, const float* a0, float* coef,
                                 float* e, float* hist, float* sse_out,
                                 int* n_out, int* conv_out, float* partials,
                                 float* da_buf, float* sse_part, int nvars,
                                 int obs, int k, int block, int max_iter,
                                 float atol_sse, float rtol, float omega,
                                 int grid, void* stream) {
  FusedParams p{x_t, inv_cn, e0, a0, coef, e, hist, sse_out, n_out, conv_out,
                partials, da_buf, sse_part, nvars, obs, k, block, max_iter,
                atol_sse, rtol, omega};
  switch (bakp_pick_kc(k)) {
    case 1: return fused_launch<1>(p, grid, stream);
    case 2: return fused_launch<2>(p, grid, stream);
    case 4: return fused_launch<4>(p, grid, stream);
    default: return fused_launch<8>(p, grid, stream);
  }
}
