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
// at k ≤ 16 the bound is bytes: n_sweeps·vars·obs·4 over 3.35 TB/s.  The
// per-sweep kernel (bakp_sweep.cu) reads each block twice, and the
// whole-solve kernel (fused_solve.cu) reads it twice through L2, which
// holds the design only within its 40 MiB budget.  Here each CTA copies its
// (block × L) slice of a block's tile into shared memory once and both
// phases of the block step read it there.  At the shapes the port runs the
// block step's latency, not bytes, sets the time, so the step runs on
// thread-block clusters with no grid-wide barrier (bakp_cluster.cuh).
//
// Decomposition: bakp_cluster.cuh's clusters of C CTAs, one CTA per SM,
// CTA q owning the obs slice [o0, o0 + L).  Shared memory of a CTA, all
// dynamic: the block step's exchange arrays (bakp_hdr_floats), then
//   ring   2 · block · L   two stages of the tile, row c at c·L
//   e      k · L           the CTA's residual slice, for the whole solve
// The SSE is bakp_cluster_sse's fixed-order sum: every CTA holds the same
// bits and takes the same stop decision.  Cluster 0's CTAs own the
// coefficients (each its slice of every block's, from a0 on), CTA 0 the
// history and the scalar outputs.
//
// The stream: cp.async (16-byte cp.async.cg when rows and the base are
// 16-byte aligned, else 4-byte cp.async.ca) with one commit group per
// tile.  At the top of block step t a CTA issues the copy of step
// t+1's tile (the next block, or block 0 of the next sweep) into the other
// stage, then waits for step t's tile: the fetch overlaps the whole of step
// t, its exchanges included.  The other stage last held step t-1's tile,
// which every thread finished reading before the __syncthreads that closes
// step t-1, so the copy never overwrites a tile still in use.  The copy
// issued in the last step of the last sweep is waited for and unused.
//
// C interface (ctypes; pointers and stream void*-sized; cudaError_t return):
//   stream_solve_clusters(k, cluster, smem, &n)  clusters the card holds
//   stream_solve_launch(...)                     one whole solve on `stream`
#include <math.h>
#include <stdint.h>

#include "bakp_cluster.cuh"

struct StreamParams {
  const float* x_t;     // (vars, obs), device memory
  const float* inv_cn;  // (vars,)
  const float* e0;      // (k, obs) initial residual
  const float* a0;      // (vars, k) initial coefficients
  float* coef;          // (vars, k)
  float* e;             // (k, obs)
  float* hist;          // (max_iter,)
  float* sse_out;       // (1,)
  int* n_out;           // (1,)
  int* conv_out;        // (1,)
  void* xchg;           // device exchange words (several clusters)
  unsigned tag0;        // the launch's exchange tags count from here
  int nvars, obs, k, block, max_iter;
  float atol_sse, rtol, omega;
  int vec16;            // rows and base 16-byte aligned: 16-byte copies
};

// Issue the copies of this CTA's slice (n positions from o0) of rows
// [row0, row0 + CB) of x_t into ring stage s (row stride L), as one commit
// group.
__device__ __forceinline__ void stream_fetch(const BakpCta& c, float* ring, int s,
                                             const float* x_t, int obs, int row0, int CB,
                                             bool vec16) {
  float* stage = ring + (size_t)s * CB * c.L;
  const float* src = x_t + (size_t)row0 * obs + c.o0;
  if (vec16) cp_async_rows<4>(stage, c.L, src, obs, CB, c.n);  // n % 4 == 0 here
  else cp_async_rows<1>(stage, c.L, src, obs, CB, c.n);
  cp_async_commit();
}

// Floats of a CTA's dynamic shared memory.
static inline size_t stream_smem_floats(int obs, int ctas, int cluster, int k, int CB) {
  const size_t L = (size_t)bakp_slice_len(obs, ctas);
  return (size_t)bakp_hdr_floats(CB, k, cluster) + 2 * (size_t)CB * L + (size_t)k * L;
}

template <int KC>
__global__ void __launch_bounds__(BAKP_THREADS) stream_solve_kernel(StreamParams p) {
  extern __shared__ __align__(16) float smem[];
  const int CB = p.block, k = p.k;
  const BakpCta c = bakp_cta(smem, p.obs, CB, k, p.xchg, p.tag0);
  const int L = c.L, n = c.n;
  float* ring = c.rest;
  float* s_e = ring + (size_t)2 * CB * L;
  const bool vec16 = p.vec16 != 0;
  const int nblocks = p.nvars / CB;
  const size_t ncoef = (size_t)CB * k;

  // The first tile's copy runs while the residual slice loads.
  stream_fetch(c, ring, 0, p.x_t, p.obs, 0, CB, vec16);
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      s_e[(size_t)r * L + i] = p.e0[(size_t)r * p.obs + c.o0 + i];
  if (c.cid == 0)                      // the coefficients this CTA owns
    for (int b = 0; b < nblocks; ++b)
      for (int i = threadIdx.x; i < c.S; i += blockDim.x) {
        const int idx = c.rank * c.S + i;
        const int col = idx / c.kp, r = idx - col * c.kp;
        if (col < CB && r < k) {
          const size_t at = (size_t)b * ncoef + (size_t)col * k + r;
          p.coef[at] = p.a0[at];
        }
      }
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < p.max_iter; i += blockDim.x) p.hist[i] = nanf("");
  __syncthreads();

  int sse_idx = 0;
  const float sse0 = bakp_cluster_sse(c, s_e, L, sse_idx++);
  float sse = sse0;
  bool converged = false, stop = false;
  int n_sweeps = 0;
  int step = 0;                        // block steps so far; parity = stage
  while (n_sweeps < p.max_iter && !stop) {
    for (int b = 0; b < nblocks; ++b, ++step) {
      BAKP_CLOCK_START;
      const float* tile = ring + (size_t)(step & 1) * CB * L;
      const int next = b + 1 < nblocks ? b + 1 : 0;
      stream_fetch(c, ring, (step + 1) & 1, p.x_t, p.obs, next * CB, CB, vec16);
      cp_async_wait<1>();              // this thread's part of `tile` ...
      __syncthreads();                 // ... and every thread's
      BAKP_CLOCK(0);
#ifdef BAKP_PHASE_CLOCKS
      long long fma_ = 0;
#endif
      const int warp = threadIdx.x >> 5;
      for (int r0 = 0; r0 < k; r0 += KC) {
        const int kc = k - r0 < KC ? k - r0 : KC;
        for (int c0 = warp * BAKP_CT; c0 < CB; c0 += BAKP_THREADS / 32 * BAKP_CT) {
          float acc[BAKP_CT][KC] = {};
          const int rows = CB - c0 < BAKP_CT ? CB - c0 : BAKP_CT;
#ifdef BAKP_PHASE_CLOCKS
          const long long f0_ = clock64();
#endif
          bakp_acc<KC, true>(tile + (size_t)c0 * L, L, rows, s_e + (size_t)r0 * L, L, n,
                             kc, acc);
#ifdef BAKP_PHASE_CLOCKS
          fma_ += clock64() - f0_;
#endif
          bakp_warp_scatter<KC>(acc, c0, rows, r0, kc, c.kp, c.part);
        }
      }
      __syncthreads();
#ifdef BAKP_PHASE_CLOCKS
      {
        const long long t_ = clock64();
        BAKP_CLOCK_ADD(1, fma_);
        BAKP_CLOCK_ADD(2, t_ - bakp_t0_ - fma_);
        bakp_t0_ = t_;
      }
#endif
      bakp_exchange(c, step, b, p.inv_cn, p.coef, true, p.omega);
#ifdef BAKP_PHASE_CLOCKS
      bakp_t0_ = clock64();
#endif
      bakp_update<BAKP_KG(KC)>(tile, L, CB, s_e, L, c.da, c.kp, k, n);
      __syncthreads();                 // `tile`'s stage may be refilled now
      BAKP_CLOCK(6);
      BAKP_CLOCK_STEP();
    }
    const float sse_new = bakp_cluster_sse(c, s_e, L, sse_idx++);
    if (blockIdx.x == 0 && threadIdx.x == 0) p.hist[n_sweeps] = sse_new;
    sweep_stop_flags(sse_new, sse, sse0, p.atol_sse, p.rtol, &converged, &stop);
    sse = sse_new;
    ++n_sweeps;
  }
  cp_async_wait<0>();                  // the unused prefetch of the last step
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      p.e[(size_t)r * p.obs + c.o0 + i] = s_e[(size_t)r * L + i];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *p.sse_out = sse;
    *p.n_out = n_sweeps;
    *p.conv_out = converged ? 1 : 0;
  }
  cl_cluster_sync();                   // no CTA leaves while the cluster pushes to it
}

static void* stream_pick(int k) {
  switch (bakp_pick_kc(k)) {
    case 1: return (void*)stream_solve_kernel<1>;
    case 2: return (void*)stream_solve_kernel<2>;
    case 4: return (void*)stream_solve_kernel<4>;
    default: return (void*)stream_solve_kernel<8>;
  }
}

extern "C" int stream_solve_clusters(int k, int cluster, int smem, int* n) {
  if (cluster < 1 || cluster > BAKP_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  size_t s = 0;
  cudaError_t err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  return (int)cl_max_clusters((void (*)(StreamParams))stream_pick(k), cluster, s, n);
}

extern "C" int stream_solve_launch(const float* x_t, const float* inv_cn,
                                   const float* e0, const float* a0,
                                   float* coef, float* e, float* hist,
                                   float* sse_out, int* n_out, int* conv_out,
                                   void* xchg, unsigned tag0, int nvars, int obs, int k,
                                   int block, int max_iter, float atol_sse,
                                   float rtol, float omega, int regime,
                                   int ctas, int cluster, int smem,
                                   void* stream) {
  // The plan the caller made must leave room for what the kernel carves.
  const size_t need = sizeof(float) * stream_smem_floats(obs, ctas, cluster, k, block);
  cudaError_t err = bakp_plan_check(obs, regime, ctas, cluster, xchg, need, (size_t)smem);
  size_t s = 0;
  if (err == cudaSuccess) err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  const int vec16 = obs % 4 == 0 && ((uintptr_t)x_t & 15) == 0;
  StreamParams p{x_t, inv_cn, e0, a0, coef, e, hist, sse_out, n_out, conv_out,
                 regime == BAKP_SINGLE_CLUSTER ? nullptr : xchg, tag0, nvars, obs, k,
                 block, max_iter, atol_sse, rtol, omega, vec16};
  return (int)cl_launch((void (*)(StreamParams))stream_pick(k), p, ctas, cluster,
                        regime != BAKP_SINGLE_CLUSTER, s, stream);
}
