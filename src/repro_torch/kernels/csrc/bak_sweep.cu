// One SolveBak sweep (paper Algorithm 1): every column in order, each one's
// update seeing all the updates before it.
//
// Replaces the TPU kernel repro/kernels/cd_sweep.py::_cd_sweep_kernel
// (pallas_call in _sweep_call, entry cd_sweep).
//
// What bounds it on an H100.  The work is 4·vars·obs·k FLOP against
// vars·obs·4 bytes of x, so the roofline bound is the bytes one (x read
// once).  But every column is a full reduction over obs followed by an
// update that depends on it, so the sweep is a chain of vars grid-wide
// barriers: at the shapes the port runs, their latency, not bytes or FLOP,
// sets its time.  The design keeps that chain at one barrier per column
// (bak_column.cuh) and keeps each CTA's residual slice in shared memory
// when it fits, so the only device-memory traffic per column is x_j.
//
// C interface (loaded with ctypes; every pointer and the stream are
// void*-sized; each entry returns a cudaError_t, 0 on success):
//   bak_sweep_grid(obs, k, min_obs, &grid, &e_smem)  launch plan
//   bak_sweep_launch(...)                             one sweep on `stream`
#include "bak_column.cuh"

struct BakSweepParams {
  const float* x_t;     // (vars, obs)
  const float* inv_cn;  // (vars,)
  const float* e_in;    // (k, obs)
  float* e_out;         // (k, obs)
  float* da;            // (vars, k)
  float* partials;      // (2, grid, k) scratch
  int nvars, obs, k, e_smem;
};

template <int KC, int XB>
__global__ void __launch_bounds__(BAKP_THREADS) bak_sweep_kernel(BakSweepParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float s_red[(BAKP_THREADS / 32) * 8];
  const BakCta c = bak_cta(smem, p.e_out, p.obs, p.k, p.e_smem != 0);
  bak_load_slice(c, p.e_in, p.obs, p.k);
  for (int j = 0; j < p.nvars; ++j) {
    const float inv_j = __ldg(p.inv_cn + j);
    bak_column_step<KC, XB>(grid, p.x_t + (size_t)j * p.obs, inv_j, c,
                            p.k, p.partials, j, s_red);
    if (blockIdx.x == 0)
      for (int r = threadIdx.x; r < p.k; r += blockDim.x)
        p.da[(size_t)j * p.k + r] = c.s_g[r] * inv_j;
  }
  bak_store_slice(c, p.e_out, p.obs, p.k);
}

template <int KC>
static cudaError_t sweep_plan(int obs, int k, int min_obs, int* grid, int* e_smem) {
  return bak_plan(bak_sweep_kernel<KC, BAK_X_BATCH>, obs, k, min_obs, grid, e_smem);
}

template <int KC>
static cudaError_t sweep_launch(const BakSweepParams& p, int grid, void* stream) {
  const int L = bakp_slice_len(p.obs, grid);
  const size_t smem = bak_smem_bytes(L, p.k, p.e_smem != 0);
  if (bak_x_batched(L))
    return bakp_launch_coop(bak_sweep_kernel<KC, BAK_X_BATCH>, p, grid, smem, stream);
  return bakp_launch_coop(bak_sweep_kernel<KC, 1>, p, grid, smem, stream);
}

extern "C" int bak_sweep_grid(int obs, int k, int min_obs, int* grid, int* e_smem) {
  switch (bakp_pick_kc(k)) {
    case 1: return sweep_plan<1>(obs, k, min_obs, grid, e_smem);
    case 2: return sweep_plan<2>(obs, k, min_obs, grid, e_smem);
    case 4: return sweep_plan<4>(obs, k, min_obs, grid, e_smem);
    default: return sweep_plan<8>(obs, k, min_obs, grid, e_smem);
  }
}

extern "C" int bak_sweep_launch(const float* x_t, const float* inv_cn,
                                const float* e_in, float* e_out, float* da,
                                float* partials, int nvars, int obs, int k,
                                int grid, int e_smem, void* stream) {
  BakSweepParams p{x_t, inv_cn, e_in, e_out, da, partials, nvars, obs, k, e_smem};
  switch (bakp_pick_kc(k)) {
    case 1: return sweep_launch<1>(p, grid, stream);
    case 2: return sweep_launch<2>(p, grid, stream);
    case 4: return sweep_launch<4>(p, grid, stream);
    default: return sweep_launch<8>(p, grid, stream);
  }
}
