// One SolveBak sweep (paper Algorithm 1): every column in order, each one's
// update seeing all the updates before it.
//
// Replaces the TPU kernel repro/kernels/cd_sweep.py::_cd_sweep_kernel
// (pallas_call in _sweep_call, entry cd_sweep).
//
// What bounds it on an H100.  The work is 4·vars·obs·k FLOP against
// vars·obs·itemsize bytes of x, so the roofline bound is the bytes one (x read
// once).  But every column is a full reduction over obs followed by an
// update that depends on it, so the sweep is a chain of vars dependent
// steps: at the shapes the port runs, their latency, not bytes or FLOP,
// sets its time.  The design (bak_column.cuh) takes each step's x_j slice
// from a cp.async ring filled one column ahead, reduces over a thread-block
// cluster through distributed shared memory, with no grid-wide barrier,
// and keeps each CTA's residual slice on chip (registers or shared memory)
// when it fits.
//
// x is fp32 or bf16 (TX, precision "bf16"): the ring holds x_j in its own
// type, widened to fp32 in the dot and the update.
//
// C interface (loaded with ctypes; every pointer and the stream are
// void*-sized; each entry returns a cudaError_t, 0 on success):
//   bak_sweep_grid(obs, k, min_obs, cluster, x_bytes, plan)  launch plan, 6 ints
//   bak_sweep_launch(x_t, x_bytes, ...)              one sweep on `stream`
// x_bytes is x's element size: 4 for fp32, 2 for bf16.
#include "bak_column.cuh"

struct BakSweepParams {
  const void* x_t;      // (vars, obs) of TX
  const float* inv_cn;  // (vars,)
  const float* e_in;    // (k, obs)
  float* e_out;         // (k, obs)
  float* da;            // (vars, k)
  float* xchg;          // device exchange slots, or nullptr (one cluster)
  int nvars, obs, k;
  int xw;               // bytes of one copy of x (bak_fetch)
};

template <int KC, int EG, typename TX>
__global__ void BAKP_BOUNDS(TX) bak_sweep_kernel(BakSweepParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[(BAKP_THREADS / 32) * 8];
  const BakCta c = bak_cta(smem, p.e_out, p.obs, p.k, EG == 0, p.xchg, sizeof(TX));
  const TX* x_t = static_cast<const TX*>(p.x_t);
  BakRegs<KC, EG> er;
  if constexpr (EG != -2) bak_fetch(c, bak_stage<TX>(c, 0), x_t + c.o0, p.xw);  // x_0
  if constexpr (EG > 0) bak_load_regs<KC, EG>(c, p.e_in, p.obs, p.k, er);
  else bak_load_slice(c, p.e_in, p.obs, p.k);
  for (int j = 0; j < p.nvars; ++j) {
    const float inv_j = __ldg(p.inv_cn + j);
    bak_column_step<KC, EG>(c, er, x_t, p.obs, x_t + (size_t)j * p.obs + c.o0,
                            j + 1 < p.nvars ? j + 1 : -1, j, j, inv_j, p.k, p.xw, s_red);
    if (blockIdx.x == 0)
      for (int r = threadIdx.x; r < p.k; r += blockDim.x)
        p.da[(size_t)j * p.k + r] = c.s_g[r] * inv_j;
  }
  cp_async_wait<0>();
  if constexpr (EG > 0) bak_store_regs<KC, EG>(c, p.e_out, p.obs, p.k, er);
  else bak_store_slice<EG == 0>(c, p.e_out, p.obs, p.k);
  cl_cluster_sync();                  // no CTA leaves while the cluster reads it
}

template <int KC, typename TX>
static BakKernels<void (*)(BakSweepParams)> sweep_kernels() {
  return {bak_sweep_kernel<KC, -2, TX>, bak_sweep_kernel<KC, -1, TX>, bak_sweep_kernel<KC, 0, TX>,
          bak_sweep_kernel<KC, 1, TX>, bak_sweep_kernel<KC, BAK_REG_GROUPS, TX>};
}

template <int KC, typename TX>
static cudaError_t sweep_launch(const BakSweepParams& p, int regime, int ctas,
                                int cluster, void* stream) {
  int eg = 0;
  size_t smem = 0;
  cudaError_t err = bak_launch_check(p.obs, p.k, regime, ctas, cluster, p.xchg, sizeof(TX),
                                     &eg, &smem);
  if (err != cudaSuccess) return err;
  return cl_launch(sweep_kernels<KC, TX>().pick(eg), p, ctas, cluster,
                    regime != BAK_SINGLE_CLUSTER, smem, stream);
}

template <typename TX>
static int sweep_grid(const TX*, int obs, int k, int min_obs, int cluster, int* plan) {
  switch (bakp_pick_kc(k)) {
    case 1: return bak_plan(sweep_kernels<1, TX>(), obs, k, min_obs, cluster, sizeof(TX), plan);
    case 2: return bak_plan(sweep_kernels<2, TX>(), obs, k, min_obs, cluster, sizeof(TX), plan);
    case 4: return bak_plan(sweep_kernels<4, TX>(), obs, k, min_obs, cluster, sizeof(TX), plan);
    default: return bak_plan(sweep_kernels<8, TX>(), obs, k, min_obs, cluster, sizeof(TX), plan);
  }
}

template <typename TX>
static int sweep_run(const TX* x_t, const float* inv_cn, const float* e_in, float* e_out,
                     float* da, float* xchg, int nvars, int obs, int k, int regime, int ctas,
                     int cluster, void* stream) {
  BakSweepParams p{x_t, inv_cn, e_in, e_out, da,
                   regime == BAK_SINGLE_CLUSTER ? nullptr : xchg, nvars, obs, k,
                   cp_bytes(x_t, (long long)obs * sizeof(TX), 4 * sizeof(TX))};
  if (regime != BAK_SINGLE_CLUSTER && xchg == nullptr) return cudaErrorInvalidValue;
  switch (bakp_pick_kc(k)) {
    case 1: return sweep_launch<1, TX>(p, regime, ctas, cluster, stream);
    case 2: return sweep_launch<2, TX>(p, regime, ctas, cluster, stream);
    case 4: return sweep_launch<4, TX>(p, regime, ctas, cluster, stream);
    default: return sweep_launch<8, TX>(p, regime, ctas, cluster, stream);
  }
}

extern "C" int bak_sweep_grid(int obs, int k, int min_obs, int cluster, int x_bytes,
                              int* plan) {
  return bakp_with_x(nullptr, x_bytes, [&](auto x) {
    return sweep_grid(x, obs, k, min_obs, cluster, plan);
  });
}

extern "C" int bak_sweep_launch(const void* x_t, int x_bytes, const float* inv_cn,
                                const float* e_in, float* e_out, float* da,
                                float* xchg, int nvars, int obs, int k,
                                int regime, int ctas, int cluster, void* stream) {
  return bakp_with_x(x_t, x_bytes, [&](auto x) {
    return sweep_run(x, inv_cn, e_in, e_out, da, xchg, nvars, obs, k, regime, ctas, cluster,
                     stream);
  });
}
