// One SolveBak sweep (paper Algorithm 1): every column in order, each one's
// update seeing all the updates before it.
//
// Replaces the TPU kernel repro/kernels/cd_sweep.py::_cd_sweep_kernel
// (pallas_call in _sweep_call, entry cd_sweep).
//
// What bounds it on an H100.  The work is 4·vars·obs·k FLOP against
// vars·obs·4 bytes of x, so the roofline bound is the bytes one (x read
// once).  But every column is a full reduction over obs followed by an
// update that depends on it, so the sweep is a chain of vars dependent
// steps: at the shapes the port runs, their latency, not bytes or FLOP,
// sets its time.  The design (bak_column.cuh) takes each step's x_j slice
// from a cp.async ring filled one column ahead, reduces over a thread-block
// cluster through distributed shared memory, with no grid-wide barrier,
// and keeps each CTA's residual slice on chip (registers or shared memory)
// when it fits.
//
// C interface (loaded with ctypes; every pointer and the stream are
// void*-sized; each entry returns a cudaError_t, 0 on success):
//   bak_sweep_grid(obs, k, min_obs, cluster, plan)  launch plan, 6 ints
//   bak_sweep_launch(...)                            one sweep on `stream`
#include "bak_column.cuh"

struct BakSweepParams {
  const float* x_t;     // (vars, obs)
  const float* inv_cn;  // (vars,)
  const float* e_in;    // (k, obs)
  float* e_out;         // (k, obs)
  float* da;            // (vars, k)
  float* xchg;          // device exchange slots, or nullptr (one cluster)
  int nvars, obs, k, vec16;
};

template <int KC, int EG>
__global__ void __launch_bounds__(BAKP_THREADS) bak_sweep_kernel(BakSweepParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[(BAKP_THREADS / 32) * 8];
  const BakCta c = bak_cta(smem, p.e_out, p.obs, p.k, EG == 0, p.xchg);
  const bool vec16 = p.vec16 != 0;
  BakRegs<KC, EG> er;
  if constexpr (EG != -2) bak_fetch(c, c.ring, p.x_t + c.o0, vec16);  // x_0
  if constexpr (EG > 0) bak_load_regs<KC, EG>(c, p.e_in, p.obs, p.k, er);
  else bak_load_slice(c, p.e_in, p.obs, p.k);
  for (int j = 0; j < p.nvars; ++j) {
    const float inv_j = __ldg(p.inv_cn + j);
    bak_column_step<KC, EG>(c, er, p.x_t, p.obs, p.x_t + (size_t)j * p.obs + c.o0,
                            j + 1 < p.nvars ? j + 1 : -1, j, j, inv_j, p.k, vec16,
                            s_red);
    if (blockIdx.x == 0)
      for (int r = threadIdx.x; r < p.k; r += blockDim.x)
        p.da[(size_t)j * p.k + r] = c.s_g[r] * inv_j;
  }
  cp_async_wait<0>();
  if constexpr (EG > 0) bak_store_regs<KC, EG>(c, p.e_out, p.obs, p.k, er);
  else bak_store_slice<EG == 0>(c, p.e_out, p.obs, p.k);
  cl_cluster_sync();                  // no CTA leaves while the cluster reads it
}

template <int KC>
static BakKernels<void (*)(BakSweepParams)> sweep_kernels() {
  return {bak_sweep_kernel<KC, -2>, bak_sweep_kernel<KC, -1>, bak_sweep_kernel<KC, 0>, bak_sweep_kernel<KC, 1>,
          bak_sweep_kernel<KC, BAK_REG_GROUPS>};
}

template <int KC>
static cudaError_t sweep_launch(const BakSweepParams& p, int regime, int ctas,
                                int cluster, void* stream) {
  int eg = 0;
  size_t smem = 0;
  cudaError_t err = bak_launch_check(p.obs, p.k, regime, ctas, cluster, p.xchg, &eg, &smem);
  if (err != cudaSuccess) return err;
  return cl_launch(sweep_kernels<KC>().pick(eg), p, ctas, cluster,
                    regime != BAK_SINGLE_CLUSTER, smem, stream);
}

extern "C" int bak_sweep_grid(int obs, int k, int min_obs, int cluster, int* plan) {
  switch (bakp_pick_kc(k)) {
    case 1: return bak_plan(sweep_kernels<1>(), obs, k, min_obs, cluster, plan);
    case 2: return bak_plan(sweep_kernels<2>(), obs, k, min_obs, cluster, plan);
    case 4: return bak_plan(sweep_kernels<4>(), obs, k, min_obs, cluster, plan);
    default: return bak_plan(sweep_kernels<8>(), obs, k, min_obs, cluster, plan);
  }
}

extern "C" int bak_sweep_launch(const float* x_t, const float* inv_cn,
                                const float* e_in, float* e_out, float* da,
                                float* xchg, int nvars, int obs, int k,
                                int regime, int ctas, int cluster, void* stream) {
  const int vec16 = obs % 4 == 0 && ((uintptr_t)x_t & 15) == 0;
  BakSweepParams p{x_t, inv_cn, e_in, e_out, da,
                   regime == BAK_SINGLE_CLUSTER ? nullptr : xchg,
                   nvars, obs, k, vec16};
  if (regime != BAK_SINGLE_CLUSTER && xchg == nullptr) return cudaErrorInvalidValue;
  switch (bakp_pick_kc(k)) {
    case 1: return sweep_launch<1>(p, regime, ctas, cluster, stream);
    case 2: return sweep_launch<2>(p, regime, ctas, cluster, stream);
    case 4: return sweep_launch<4>(p, regime, ctas, cluster, stream);
    default: return sweep_launch<8>(p, regime, ctas, cluster, stream);
  }
}
