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
// phases of the block step read it there.
//
// Decomposition: bakp_block.cuh's persistent cooperative grid, one CTA per
// SM at most, CTA q owning the obs slice [o0, o0 + L).  Shared memory of a
// CTA, all dynamic:
//   ring   2 · block · L   two stages of the tile, row c at c·L
//   e      k · L           the CTA's residual slice, for the whole solve
//   da     block · k       the block's increments
//   red    33              the SSE reduction scratch
// The block step is bakp_block.cuh's partials → grid.sync → fixed-order
// reduce → grid.sync → update, with the tile and e read from shared memory
// by the same loops the other two Algorithm-2 kernels run, so the three
// cannot drift numerically.  The SSE is bakp_grid_sse's fixed-order sum:
// every CTA holds the same bits and takes the same stop decision.
//
// The stream: cp.async (16-byte cp.async.cg when rows and the base are
// 16-byte aligned, else 4-byte cp.async.ca) with one commit group per
// tile.  At the top of block step t a CTA issues the copy of step t+1's
// tile (the next block, or block 0 of the next sweep) into the other stage,
// then waits for step t's group: the fetch overlaps the whole of step t,
// both grid barriers included.  The other stage last held step t-1's tile,
// which every thread finished reading before the __syncthreads that closes
// step t-1, so the copy never overwrites a tile still in use.  The copy
// issued in the last step of the last sweep is waited for and unused.
//
// C interface (ctypes; pointers and stream void*-sized; cudaError_t return):
//   stream_solve_grid(k, smem, &grid_max)  largest cooperative grid at smem
//   stream_solve_launch(...)               one whole solve on `stream`
#include <math.h>
#include <stdint.h>

#include "bakp_block.cuh"
#include "cp_async.cuh"

// Floats of the SSE reduction scratch at the end of the dynamic memory.
#define STREAM_RED_FLOATS 33

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
  float* partials;      // (grid, block, k) scratch
  float* da_buf;        // (block, k) scratch
  float* sse_part;      // (grid,) scratch
  int nvars, obs, k, block, max_iter;
  float atol_sse, rtol, omega;
  int vec16;            // rows and base 16-byte aligned: 16-byte copies
};

// Issue the copies of this CTA's slice (n positions from o0) of rows
// [row0, row0 + CB) of x_t into `stage` (row stride L), as one commit group.
__device__ __forceinline__ void stream_fetch(float* stage, const float* x_t,
                                             int obs, int row0, int CB, int o0,
                                             int n, int L, bool vec16) {
  if (vec16) {
    const int n4 = n >> 2;             // n is a multiple of 4 here
    const int total = CB * n4;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int c = idx / n4;
      const int i = (idx - c * n4) << 2;
      cp_async16(stage + (size_t)c * L + i,
                 x_t + (size_t)(row0 + c) * obs + o0 + i);
    }
  } else {
    const int total = CB * n;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int c = idx / n;
      const int i = idx - c * n;
      cp_async4(stage + (size_t)c * L + i,
                x_t + (size_t)(row0 + c) * obs + o0 + i);
    }
  }
  cp_async_commit();
}

template <int KC>
__global__ void __launch_bounds__(BAKP_THREADS) stream_solve_kernel(StreamParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const BakpSlice s = bakp_slice(p.obs);
  const int L = bakp_slice_len(p.obs, gridDim.x);
  const int n = s.o1 - s.o0;
  const int CB = p.block, k = p.k;
  float* ring = smem;
  float* s_e = ring + (size_t)2 * CB * L;
  float* s_da = s_e + (size_t)k * L;
  float* s_red = s_da + (size_t)CB * k;
  const bool vec16 = p.vec16 != 0;

  // The first tile's copy runs while the residual slice loads.
  stream_fetch(ring, p.x_t, p.obs, 0, CB, s.o0, n, L, vec16);
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      s_e[(size_t)r * L + i] = p.e0[(size_t)r * p.obs + s.o0 + i];
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int gs = gridDim.x * blockDim.x;
  for (int i = gt; i < p.nvars * k; i += gs) p.coef[i] = p.a0[i];
  for (int i = gt; i < p.max_iter; i += gs) p.hist[i] = nanf("");
  __syncthreads();

  const float sse0 = bakp_grid_sse(grid, s_e, L, 0, n, k, p.sse_part, s_red);
  float sse = sse0;
  bool converged = false, stop = false;
  int n_sweeps = 0;
  const int nblocks = p.nvars / CB;
  const size_t nda = (size_t)CB * k;
  int step = 0;                        // block steps so far; parity = stage
  while (n_sweeps < p.max_iter && !stop) {
    for (int b = 0; b < nblocks; ++b, ++step) {
      const float* tile = ring + (size_t)(step & 1) * CB * L;
      const int next = b + 1 < nblocks ? b + 1 : 0;
      stream_fetch(ring + (size_t)((step + 1) & 1) * CB * L, p.x_t, p.obs,
                   next * CB, CB, s.o0, n, L, vec16);
      cp_async_wait<1>();              // this thread's part of `tile` ...
      __syncthreads();                 // ... and every thread's
      bakp_partials<KC, false>(tile, L, s_e, L, 0, n, k, CB,
                               p.partials + blockIdx.x * nda);
      grid.sync();
      bakp_reduce(p.partials, p.da_buf, p.coef + (size_t)b * nda, true,
                  p.inv_cn + (size_t)b * CB, CB, k, p.omega);
      grid.sync();
      for (int i = threadIdx.x; i < (int)nda; i += blockDim.x)
        s_da[i] = __ldcg(p.da_buf + i);
      __syncthreads();
      bakp_update<KC, false>(tile, L, s_e, L, s_da, 0, n, k, CB);
      __syncthreads();                 // `tile`'s stage may be refilled now
    }
    const float sse_new = bakp_grid_sse(grid, s_e, L, 0, n, k, p.sse_part, s_red);
    if (gt == 0) p.hist[n_sweeps] = sse_new;
    sweep_stop_flags(sse_new, sse, sse0, p.atol_sse, p.rtol, &converged, &stop);
    sse = sse_new;
    ++n_sweeps;
  }
  cp_async_wait<0>();                  // the unused prefetch of the last step
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      p.e[(size_t)r * p.obs + s.o0 + i] = s_e[(size_t)r * L + i];
  if (gt == 0) {
    *p.sse_out = sse;
    *p.n_out = n_sweeps;
    *p.conv_out = converged ? 1 : 0;
  }
}

template <int KC>
static cudaError_t stream_grid(int k, int smem, int* out) {
  (void)k;
  return bakp_max_grid(stream_solve_kernel<KC>, (size_t)smem, out);
}

template <int KC>
static cudaError_t stream_launch(const StreamParams& p, int grid, int smem,
                                 void* stream) {
  return bakp_launch_coop(stream_solve_kernel<KC>, p, grid, (size_t)smem,
                          stream);
}

extern "C" int stream_solve_grid(int k, int smem, int* grid_max) {
  switch (bakp_pick_kc(k)) {
    case 1: return stream_grid<1>(k, smem, grid_max);
    case 2: return stream_grid<2>(k, smem, grid_max);
    case 4: return stream_grid<4>(k, smem, grid_max);
    default: return stream_grid<8>(k, smem, grid_max);
  }
}

extern "C" int stream_solve_launch(const float* x_t, const float* inv_cn,
                                   const float* e0, const float* a0,
                                   float* coef, float* e, float* hist,
                                   float* sse_out, int* n_out, int* conv_out,
                                   float* partials, float* da_buf,
                                   float* sse_part, int nvars, int obs, int k,
                                   int block, int max_iter, float atol_sse,
                                   float rtol, float omega, int grid, int smem,
                                   void* stream) {
  // Dynamic shared memory the kernel carves (see top); the caller's plan
  // must have sized it the same way.
  const int L = bakp_slice_len(obs, grid);
  const size_t need = sizeof(float) * ((size_t)2 * block * L + (size_t)k * L +
                                       (size_t)block * k + STREAM_RED_FLOATS);
  if ((size_t)smem != need) return (int)cudaErrorInvalidValue;
  const int vec16 = obs % 4 == 0 && ((uintptr_t)x_t & 15) == 0;
  StreamParams p{x_t, inv_cn, e0, a0, coef, e, hist, sse_out, n_out, conv_out,
                 partials, da_buf, sse_part, nvars, obs, k, block, max_iter,
                 atol_sse, rtol, omega, vec16};
  switch (bakp_pick_kc(k)) {
    case 1: return stream_launch<1>(p, grid, smem, stream);
    case 2: return stream_launch<2>(p, grid, smem, stream);
    case 4: return stream_launch<4>(p, grid, smem, stream);
    default: return stream_launch<8>(p, grid, smem, stream);
  }
}
