// One SolveBakP sweep (paper Algorithm 2) over every column block, in order.
//
// Replaces the TPU kernel repro/kernels/cd_sweep.py::_bakp_sweep_kernel
// (pallas_call in _sweep_call, entry bakp_sweep).
//
// What bounds it on an H100: device-memory bytes.  It does 4·vars·obs·k
// FLOP against vars·obs·4 bytes of x, under one FLOP per byte at k = 1 and
// two at k = 8, far below the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s, about 20).  This is the path for designs over the whole-solve
// budget, so x does not stay on chip between sweeps; within a sweep each
// block is read twice (once for the inner products, once for the residual
// update), because a whole (block, obs) tile cannot stay on chip across the
// grid-wide reduction between them.  The block math lives in
// bakp_block.cuh; a cooperative grid splits obs across CTAs (see there).
//
// C interface (loaded with ctypes; every pointer and the stream are
// void*-sized; each entry returns a cudaError_t, 0 on success):
//   bakp_sweep_grid(k, block, &grid_max)  largest cooperative grid
//   bakp_sweep_launch(...)                 one sweep on `stream`
#include "bakp_block.cuh"

struct SweepParams {
  const float* x_t;     // (vars, obs)
  const float* inv_cn;  // (vars,)
  const float* e_in;    // (k, obs)
  float* e_out;         // (k, obs)
  float* da;            // (vars, k)
  float* partials;      // (grid, block, k) scratch
  float* da_buf;        // (block, k) scratch
  int nvars, obs, k, block;
  float omega;
};

template <int KC>
__global__ void __launch_bounds__(BAKP_THREADS) bakp_sweep_kernel(SweepParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float s_da[];
  const BakpSlice s = bakp_slice(p.obs);
  for (int r = 0; r < p.k; ++r)
    for (int o = s.o0 + threadIdx.x; o < s.o1; o += blockDim.x)
      p.e_out[(size_t)r * p.obs + o] = p.e_in[(size_t)r * p.obs + o];
  __syncthreads();
  const int nblocks = p.nvars / p.block;
  for (int b = 0; b < nblocks; ++b)
    bakp_block_step<KC>(grid, p.x_t, p.inv_cn, p.e_out, p.da, false,
                        p.partials, p.da_buf, s_da, p.obs, p.k, p.block, b,
                        p.omega, s);
}

template <int KC>
static cudaError_t sweep_grid(int k, int block, int* out) {
  return bakp_max_grid(bakp_sweep_kernel<KC>, (size_t)block * k * sizeof(float), out);
}

template <int KC>
static cudaError_t sweep_launch(const SweepParams& p, int grid, void* stream) {
  return bakp_launch_coop(bakp_sweep_kernel<KC>, p, grid,
                          (size_t)p.block * p.k * sizeof(float), stream);
}

extern "C" int bakp_sweep_grid(int k, int block, int* grid_max) {
  switch (bakp_pick_kc(k)) {
    case 1: return sweep_grid<1>(k, block, grid_max);
    case 2: return sweep_grid<2>(k, block, grid_max);
    case 4: return sweep_grid<4>(k, block, grid_max);
    default: return sweep_grid<8>(k, block, grid_max);
  }
}

extern "C" int bakp_sweep_launch(const float* x_t, const float* inv_cn,
                                 const float* e_in, float* e_out, float* da,
                                 float* partials, float* da_buf, int nvars,
                                 int obs, int k, int block, float omega,
                                 int grid, void* stream) {
  SweepParams p{x_t, inv_cn, e_in, e_out, da, partials, da_buf,
                nvars, obs, k, block, omega};
  switch (bakp_pick_kc(k)) {
    case 1: return sweep_launch<1>(p, grid, stream);
    case 2: return sweep_launch<2>(p, grid, stream);
    case 4: return sweep_launch<4>(p, grid, stream);
    default: return sweep_launch<8>(p, grid, stream);
  }
}
