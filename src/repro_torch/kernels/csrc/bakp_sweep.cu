// One SolveBakP sweep (paper Algorithm 2) over every column block, in order.
//
// Replaces the TPU kernel repro/kernels/cd_sweep.py::_bakp_sweep_kernel
// (pallas_call in _sweep_call, entry bakp_sweep).
//
// What bounds it on an H100: device-memory bytes.  It does 4·vars·obs·k
// FLOP against vars·obs·4 bytes of fp32 x (half that in bf16), under one
// FLOP per byte at k = 1 and two at k = 8, far below the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s, about 20).  This is the path for designs over the whole-solve
// budget, so x does not stay on chip between sweeps; within a sweep each
// block is read twice (once for the inner products, once for the residual
// update), because a whole (block, obs) tile cannot stay on chip across the
// reduction between them: at best two reads of x a sweep.  The block step
// is bakp_cluster.cuh's, on thread-block clusters with no grid-wide
// barrier.
//
// x (fp32 or bf16, TX; a bf16 x is widened to fp32 in the block step)
// reaches the step through a shared-memory ring of NS chunks (3 to
// SWEEP_MAX_STAGES, as many as fit beside the rest), each SWEEP_ROWS rows
// of the block × P positions of the CTA's slice (P = min(L, SWEEP_POS)),
// copied with 16-byte cp.async (4-byte where rows are not 16-byte
// aligned, 2-byte plain copies for a bf16 row of odd length: cp_bytes),
// one commit group a chunk, NS - 1 chunks ahead of the one in use: 64-224
// KB of fp32 a CTA in flight, across the exchanges too, since the
// update's chunks do not depend on da.  A block's chunks, in
// order: the partials pass (for each KC chunk of the right-hand sides, each
// row group, each position chunk; warp w carries rows 4w..4w+3 of the
// group, its accumulators kept across the group's position chunks), then
// the update pass (each row group, each position chunk).  A chunk's stage
// is refilled only after the __syncthreads at the top of the next chunk,
// which every reader of the stage has passed.  The residual slice lives in
// shared memory for the whole sweep when it fits beside the ring (read once
// from e_in, written once to e_out), else in e_out in device memory.
//
// C interface (loaded with ctypes; every pointer and the stream are
// void*-sized; each entry returns a cudaError_t, 0 on success):
//   bakp_sweep_clusters(k, cluster, smem, &n)  clusters the card holds
//   bakp_sweep_launch(x_t, x_bytes, ...)        one sweep on `stream`; x_t fp32
//                                               (x_bytes 4) or bf16 (2)
#include <stdint.h>

#include "bakp_cluster.cuh"

#define SWEEP_ROWS 32
#define SWEEP_POS 256
#define SWEEP_MIN_STAGES 3
#define SWEEP_MAX_STAGES 8

struct SweepParams {
  const void* x_t;      // (vars, obs) of TX
  const float* inv_cn;  // (vars,)
  const float* e_in;    // (k, obs)
  float* e_out;         // (k, obs)
  float* da;            // (vars, k)
  void* xchg;           // device exchange words (several clusters)
  unsigned tag0;        // the launch's exchange tags count from here
  int nvars, obs, k, block;
  float omega;
  int xw;               // bytes of one copy of x (cp_bytes: 16, 4 or 2)
  int stages;           // ring depth NS
};

// Floats of a CTA's dynamic shared memory: the exchange arrays, the ring
// of `stages` chunks of x (xsize bytes an element; P is a multiple of 32)
// and, when e_smem, the residual slice.
static inline size_t sweep_smem_floats(int obs, int ctas, int cluster, int k, int CB,
                                       bool e_smem, int stages, int xsize) {
  const int L = bakp_slice_len(obs, ctas);
  const int P = L < SWEEP_POS ? L : SWEEP_POS;
  return (size_t)bakp_hdr_floats(CB, k, cluster) +
         (size_t)stages * SWEEP_ROWS * P * xsize / 4 + (e_smem ? (size_t)k * L : 0);
}

template <int KC, bool E_SMEM, typename TX>
__global__ void BAKP_BOUNDS(TX) bakp_sweep_kernel(SweepParams p) {
  extern __shared__ __align__(16) float smem[];
  const int CB = p.block, k = p.k, obs = p.obs;
  const BakpCta c = bakp_cta(smem, obs, CB, k, p.xchg, p.tag0);
  const int L = c.L, n = c.n;
  const int P = L < SWEEP_POS ? L : SWEEP_POS;
  const int NS = p.stages;
  const TX* x_t = static_cast<const TX*>(p.x_t);
  TX* ring = reinterpret_cast<TX*>(c.rest);
  float* eb;                           // the residual slice, row stride es
  int es;
  if constexpr (E_SMEM) {
    eb = reinterpret_cast<float*>(ring + (size_t)NS * SWEEP_ROWS * P);
    es = L;
  } else {
    eb = p.e_out + c.o0;
    es = obs;
  }
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      eb[(size_t)r * es + i] = p.e_in[(size_t)r * obs + c.o0 + i];

  const int nblocks = p.nvars / CB;
  const int NG = (CB + SWEEP_ROWS - 1) / SWEEP_ROWS;
  const int NPC = (n + P - 1) / P;     // 0 for a CTA past the end
  const int nrc = (k + KC - 1) / KC;
  const int per = NG * NPC;            // chunks of one pass over the block
  const int Q = (nrc + 1) * per;       // chunks of a block
  const long long total = (long long)nblocks * Q;

  // Issue the copies of chunk q into its stage, as one commit group (an
  // empty one past the last chunk).
  auto fetch = [&](long long q) {
    if (q < total) {
      const int b = (int)(q / Q);
      int w = (int)(q - (long long)b * Q);
      w = w < nrc * per ? w % per : w - nrc * per;
      const int g = w / NPC, pc = w - g * NPC;
      const int rows = CB - g * SWEEP_ROWS < SWEEP_ROWS ? CB - g * SWEEP_ROWS : SWEEP_ROWS;
      const int p0 = pc * P;
      const int np = n - p0 < P ? n - p0 : P;
      TX* stage = ring + (size_t)(q % NS) * SWEEP_ROWS * P;
      const TX* src = x_t + (size_t)(b * CB + g * SWEEP_ROWS) * obs + c.o0 + p0;
      cp_async_rows_b(stage, P, src, obs, rows, np, p.xw);
    }
    cp_async_commit();
  };
  // Wait for chunk q, free the stage of chunk q - 1 and refill it with
  // chunk q + NS - 1; returns chunk q's stage.
  auto take = [&](long long q) -> const TX* {
    cp_async_wait_n(NS - 2);
    __syncthreads();
    fetch(q + NS - 1);
    return ring + (size_t)(q % NS) * SWEEP_ROWS * P;
  };

  for (int s = 0; s < NS - 1; ++s) fetch(s);
  __syncthreads();                     // the residual slice is in place
  const int warp = threadIdx.x >> 5;
  long long q = 0;
  for (int b = 0; b < nblocks; ++b) {
    BAKP_CLOCK_START;
#ifdef BAKP_PHASE_CLOCKS
    long long fma_ = 0, wait_ = 0;
#endif
    for (int r0 = 0; r0 < k; r0 += KC) {
      const int kc = k - r0 < KC ? k - r0 : KC;
      for (int g = 0; g < NG; ++g) {
        const int c0 = g * SWEEP_ROWS + warp * BAKP_CT;
        const int rows = CB - c0 < BAKP_CT ? CB - c0 : BAKP_CT;
        float acc[BAKP_CT][KC] = {};
        for (int pc = 0; pc < NPC; ++pc, ++q) {
#ifdef BAKP_PHASE_CLOCKS
          const long long w0_ = clock64();
#endif
          const TX* stage = take(q);
#ifdef BAKP_PHASE_CLOCKS
          const long long f0_ = clock64();
          wait_ += f0_ - w0_;
#endif
          const int p0 = pc * P;
          const int np = n - p0 < P ? n - p0 : P;
          if (rows > 0)
            bakp_acc<KC, E_SMEM>(stage + (size_t)warp * BAKP_CT * P, P, rows,
                                 eb + (size_t)r0 * es + p0, es, np, kc, acc);
#ifdef BAKP_PHASE_CLOCKS
          fma_ += clock64() - f0_;
#endif
        }
        if (rows > 0) bakp_warp_scatter<KC>(acc, c0, rows, r0, kc, c.kp, c.part);
      }
    }
    __syncthreads();
#ifdef BAKP_PHASE_CLOCKS
    {
      const long long t_ = clock64();
      BAKP_CLOCK_ADD(0, wait_);
      BAKP_CLOCK_ADD(1, fma_);
      BAKP_CLOCK_ADD(2, t_ - bakp_t0_ - fma_ - wait_);
      bakp_t0_ = t_;
    }
#endif
    bakp_exchange(c, b, b, p.inv_cn, p.da, k, k, false, p.omega);
#ifdef BAKP_PHASE_CLOCKS
    bakp_t0_ = clock64();
#endif
    for (int g = 0; g < NG; ++g) {
      const int rows = CB - g * SWEEP_ROWS < SWEEP_ROWS ? CB - g * SWEEP_ROWS : SWEEP_ROWS;
      for (int pc = 0; pc < NPC; ++pc, ++q) {
        const TX* stage = take(q);
        const int p0 = pc * P;
        const int np = n - p0 < P ? n - p0 : P;
        bakp_update<BAKP_KG(KC)>(stage, P, rows, eb + p0, es,
                                 c.da + (size_t)g * SWEEP_ROWS * c.kp, c.kp, k, np);
      }
    }
    BAKP_CLOCK(6);
    BAKP_CLOCK_STEP();
  }
  cp_async_wait<0>();                  // the empty groups past the last chunk
  if constexpr (E_SMEM) {
    __syncthreads();
    for (int r = 0; r < k; ++r)
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        p.e_out[(size_t)r * obs + c.o0 + i] = eb[(size_t)r * es + i];
  }
  cl_cluster_sync();                   // no CTA leaves while the cluster pushes to it
}

template <int KC, typename TX>
static void* sweep_kernel(bool e_smem) {
  return e_smem ? (void*)bakp_sweep_kernel<KC, true, TX> : (void*)bakp_sweep_kernel<KC, false, TX>;
}

template <typename TX>
static void* sweep_pick(int k, bool e_smem) {
  switch (bakp_pick_kc(k)) {
    case 1: return sweep_kernel<1, TX>(e_smem);
    case 2: return sweep_kernel<2, TX>(e_smem);
    case 4: return sweep_kernel<4, TX>(e_smem);
    default: return sweep_kernel<8, TX>(e_smem);
  }
}

// Asked of the fp32 kernel: one CTA an SM whatever x's type.
extern "C" int bakp_sweep_clusters(int k, int cluster, int smem, int* n) {
  if (cluster < 1 || cluster > BAKP_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  size_t s = 0;
  cudaError_t err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  return (int)cl_max_clusters((void (*)(SweepParams))sweep_pick<float>(k, true), cluster, s, n);
}

template <typename TX>
static int sweep_launch(const TX* x_t, const float* inv_cn, const float* e_in, float* e_out,
                        float* da, void* xchg, unsigned tag0, int nvars, int obs, int k,
                        int block, float omega, int regime, int ctas, int cluster, int e_smem,
                        int stages, int smem, void* stream) {
  const size_t need = sizeof(float) * sweep_smem_floats(obs, ctas, cluster, k, block,
                                                        e_smem != 0, stages, sizeof(TX));
  cudaError_t err = bakp_plan_check(obs, regime, ctas, cluster, xchg, need, (size_t)smem);
  if (stages < SWEEP_MIN_STAGES || stages > SWEEP_MAX_STAGES) err = cudaErrorInvalidValue;
  size_t s = 0;
  if (err == cudaSuccess) err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  SweepParams p{x_t, inv_cn, e_in, e_out, da,
                regime == BAKP_SINGLE_CLUSTER ? nullptr : xchg, tag0,
                nvars, obs, k, block, omega,
                cp_bytes(x_t, (long long)obs * sizeof(TX), 16), stages};
  return (int)cl_launch((void (*)(SweepParams))sweep_pick<TX>(k, e_smem != 0), p, ctas,
                        cluster, regime != BAKP_SINGLE_CLUSTER, s, stream);
}

extern "C" int bakp_sweep_launch(const void* x_t, int x_bytes, const float* inv_cn,
                                 const float* e_in, float* e_out, float* da,
                                 void* xchg, unsigned tag0, int nvars, int obs,
                                 int k, int block, float omega, int regime, int ctas,
                                 int cluster,
                                 int e_smem, int stages, int smem, void* stream) {
  return bakp_with_x(x_t, x_bytes, [&](auto x) {
    return sweep_launch(x, inv_cn, e_in, e_out, da, xchg, tag0, nvars, obs, k, block, omega,
                        regime, ctas, cluster, e_smem, stages, smem, stream);
  });
}
