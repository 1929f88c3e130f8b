// The whole-solve loop of SolveBakP (paper Algorithm 2) on bakp_cluster.cuh's
// block step: the sweeps, the per-sweep SSE and the stopping rule in one
// launch, with a true early exit and no host synchronisation per sweep.
// Shared by the two whole-solve kernels, fused_solve.cu (x kept on chip) and
// stream_solve.cu (x streamed from device memory), which differ only in
// where a block's (CB × L) tile of x comes from (SRC):
//   BAKP_X_SHARED  the CTA's (vars × L) slice of x, copied into shared
//                  memory with cp.async once per launch (row c at c·L);
//                  block b's tile is x_s + b·CB·L, read with no fetch and
//                  no wait per step.  fused_solve's x_shared regime.
//   BAKP_X_RING    a two-stage ring of tiles: at the top of block step t a
//                  CTA issues the copy of step t+1's tile (the next block,
//                  or block 0 of the next sweep) into the other stage, then
//                  waits for step t's, so the fetch overlaps the whole of
//                  step t, its exchanges included.  The other stage last
//                  held step t-1's tile, which every thread finished reading
//                  before the __syncthreads that closes step t-1.  The copy
//                  issued in the last step of the last sweep is waited for
//                  and unused.  stream_solve's regime, and fused_solve's
//                  x_l2 (a design within the fused budget stays in the L2).
//   BAKP_X_DIRECT  x read in place from device memory (the L2), and the
//                  residual kept there too: fused_solve's x_l2 where not
//                  even the ring and the residual slice fit a CTA.
// x is fp32 or bf16 (TX), kept on chip in its own type and widened to fp32
// as the block step reads it; a bf16 slice or ring takes half the shared
// memory.  Copies are 16-byte cp.async.cg where rows and the base are
// 16-byte aligned, else 4-byte cp.async.ca (a bf16 row of odd length: plain
// 2-byte copies), one commit group a copy (cp_bytes).
//
// Shared memory of a CTA, all dynamic: the block step's exchange arrays
// (bakp_hdr_floats, for `group` right-hand sides), then
//   x   vars·L (SHARED) or 2·CB·L (RING)   TX, row c at c·L
//   e   k·L (not DIRECT)                   the residual slice, whole solve
//
// Right-hand sides in groups.  Where the exchange arrays of all k do not
// fit beside the rest, a block step runs its k right-hand sides in groups
// of `group` (the last may be narrower): partials, exchange and update of
// one group, then of the next.  The columns of e are independent within a
// block step, so the iterate is the one a single exchange of all k gives;
// the SSE and the stop stay joint, after the sweep, over all k.  Exchange s
// of the launch (one a group of a block step) is bakp_exchange's step s.
//
// The SSE is bakp_cluster_sse's fixed-order sum in double: every CTA holds
// the same bits and takes the same stop decision.  Cluster 0's CTAs own the
// coefficients (each its slice of every block's and group's, from a0 on),
// CTA 0 writes the history and the scalar outputs.
#pragma once

#include <math.h>
#include <stdint.h>

#include "bakp_cluster.cuh"

// Where a block's tile comes from, by the codes the launches take.
#define BAKP_X_SHARED 0
#define BAKP_X_RING 1
#define BAKP_X_DIRECT 2

struct BakpSolveParams {
  const void* x_t;      // (vars, obs) of TX, device memory
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
  int nvars, obs, k, block, group, max_iter;
  float atol_sse, rtol, omega;
  int xw;               // bytes of one copy of x (cp_bytes: 16, 4 or 2)
};

// Floats of a CTA's dynamic shared memory with tile source src, for x of
// xsize bytes an element (L is a multiple of 32, so the x rows fill whole
// floats).
static inline size_t bakp_solve_smem_floats(int src, int nvars, int obs, int ctas,
                                            int cluster, int k, int group, int CB,
                                            int xsize) {
  const size_t L = (size_t)bakp_slice_len(obs, ctas);
  size_t f = (size_t)bakp_hdr_floats(CB, group, cluster);
  const size_t xrows = src == BAKP_X_SHARED ? (size_t)nvars : 2 * (size_t)CB;
  if (src != BAKP_X_DIRECT) f += xrows * L * xsize / 4 + (size_t)k * L;
  return f;
}

// Issue the copies of this CTA's slice (c.n positions from c.o0) of rows
// [row0, row0 + rows) of x_t into dst (row stride c.L), as one commit group.
template <typename TX>
__device__ __forceinline__ void bakp_fetch(const BakpCta& c, TX* dst, const TX* x_t, int obs,
                                           int row0, int rows, int xw) {
  cp_async_rows_b(dst, c.L, x_t + (size_t)row0 * obs + c.o0, obs, rows, c.n, xw);
  cp_async_commit();
}

template <int KC, int SRC, typename TX>
__device__ __forceinline__ void bakp_solve(const BakpSolveParams& p, float* smem) {
  constexpr bool ON_CHIP = SRC != BAKP_X_DIRECT;
  const int CB = p.block, k = p.k, G = p.group, obs = p.obs;
  const BakpCta c = bakp_cta(smem, obs, CB, G, p.xchg, p.tag0);
  const int L = c.L, n = c.n;
  const int xw = p.xw;
  const TX* x_t = static_cast<const TX*>(p.x_t);
  const int nblocks = p.nvars / CB;
  TX* xs = reinterpret_cast<TX*>(c.rest);  // the x slice or the ring
  float* eb;                           // the residual slice, row stride es
  int es;
  if constexpr (ON_CHIP) {
    eb = reinterpret_cast<float*>(xs + (size_t)(SRC == BAKP_X_SHARED ? p.nvars : 2 * CB) * L);
    es = L;
  } else {
    eb = p.e + c.o0;
    es = obs;
  }

  // The copy of x (the slice, or the first tile) runs while the residual
  // slice loads.
  if constexpr (SRC == BAKP_X_SHARED) bakp_fetch(c, xs, x_t, obs, 0, p.nvars, xw);
  if constexpr (SRC == BAKP_X_RING) bakp_fetch(c, xs, x_t, obs, 0, CB, xw);
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      eb[(size_t)r * es + i] = p.e0[(size_t)r * obs + c.o0 + i];
  if (c.cid == 0)                      // the coefficients this CTA owns
    for (int g0 = 0; g0 < k; g0 += G) {
      const int gk = k - g0 < G ? k - g0 : G;
      for (int b = 0; b < nblocks; ++b)
        for (int i = threadIdx.x; i < c.S; i += blockDim.x) {
          const int idx = c.rank * c.S + i;
          const int col = idx / c.kp, r = idx - col * c.kp;
          if (col < CB && r < gk) {
            const size_t at = ((size_t)b * CB + col) * k + g0 + r;
            p.coef[at] = p.a0[at];
          }
        }
    }
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < p.max_iter; i += blockDim.x) p.hist[i] = nanf("");
  if constexpr (SRC == BAKP_X_SHARED) cp_async_wait<0>();
  __syncthreads();

  int sse_idx = 0;
  const float sse0 = bakp_cluster_sse(c, eb, es, k, sse_idx++);
  float sse = sse0;
  bool converged = false, stop = false;
  int n_sweeps = 0;
  int bstep = 0;                       // block steps so far; parity = ring stage
  int step = 0;                        // exchanges so far
  const int warp = threadIdx.x >> 5;
  while (n_sweeps < p.max_iter && !stop) {
    for (int b = 0; b < nblocks; ++b, ++bstep) {
      BAKP_CLOCK_START;
      const TX* tile;                  // block b's tile, row stride tl
      int tl;
      if constexpr (SRC == BAKP_X_SHARED) {
        tile = xs + (size_t)b * CB * L;
        tl = L;
      } else if constexpr (SRC == BAKP_X_RING) {
        tile = xs + (size_t)(bstep & 1) * CB * L;
        tl = L;
        const int next = b + 1 < nblocks ? b + 1 : 0;
        bakp_fetch(c, xs + (size_t)((bstep + 1) & 1) * CB * L, x_t, obs, next * CB, CB, xw);
        cp_async_wait<1>();            // this thread's part of `tile` ...
        __syncthreads();               // ... and every thread's
      } else {
        tile = x_t + (size_t)b * CB * obs + c.o0;
        tl = obs;
      }
      BAKP_CLOCK(0);
      for (int g0 = 0; g0 < k; g0 += G, ++step) {
        const int gk = k - g0 < G ? k - g0 : G;
#ifdef BAKP_PHASE_CLOCKS
        long long fma_ = 0;
#endif
        for (int r0 = 0; r0 < gk; r0 += KC) {
          const int kc = gk - r0 < KC ? gk - r0 : KC;
          for (int c0 = warp * BAKP_CT; c0 < CB; c0 += BAKP_THREADS / 32 * BAKP_CT) {
            float acc[BAKP_CT][KC] = {};
            const int rows = CB - c0 < BAKP_CT ? CB - c0 : BAKP_CT;
#ifdef BAKP_PHASE_CLOCKS
            const long long f0_ = clock64();
#endif
            bakp_acc<KC, ON_CHIP, ON_CHIP>(tile + (size_t)c0 * tl, tl, rows,
                                           eb + (size_t)(g0 + r0) * es, es, n, kc, acc);
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
        bakp_exchange(c, step, b, p.inv_cn, p.coef + g0, k, gk, true, p.omega);
#ifdef BAKP_PHASE_CLOCKS
        bakp_t0_ = clock64();
#endif
        bakp_update<BAKP_KG(KC)>(tile, tl, CB, eb + (size_t)g0 * es, es, c.da, c.kp, gk, n);
        __syncthreads();               // a ring stage may be refilled now
        BAKP_CLOCK(6);
      }
      BAKP_CLOCK_STEP();
    }
    BAKP_CLOCK_START;
    const float sse_new = bakp_cluster_sse(c, eb, es, k, sse_idx++);
    BAKP_CLOCK(7);
    if (blockIdx.x == 0 && threadIdx.x == 0) p.hist[n_sweeps] = sse_new;
    sweep_stop_flags(sse_new, sse, sse0, p.atol_sse, p.rtol, &converged, &stop);
    sse = sse_new;
    ++n_sweeps;
  }
  if constexpr (SRC == BAKP_X_RING) cp_async_wait<0>();  // the unused prefetch
  if constexpr (ON_CHIP)
    for (int r = 0; r < k; ++r)
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        p.e[(size_t)r * obs + c.o0 + i] = eb[(size_t)r * es + i];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *p.sse_out = sse;
    *p.n_out = n_sweeps;
    *p.conv_out = converged ? 1 : 0;
  }
  cl_cluster_sync();                   // no CTA leaves while the cluster pushes to it
}
