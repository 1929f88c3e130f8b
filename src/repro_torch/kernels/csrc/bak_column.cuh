// SolveBak (paper Algorithm 1) column step, shared by the per-sweep kernel
// (bak_sweep.cu) and the whole-solve kernel (bak_fused.cu), as
// repro/kernels/cd_sweep.py::bak_row_update is shared by the two Pallas
// bodies it replaces.  One definition keeps the two execution models
// numerically in lockstep.
//
// Layout as bakp_block.cuh: x_t (vars, obs) row-major fp32, residuals
// e (k, obs), increments and coefficients (vars, k), inv_cn (vars,).
//
// Decomposition.  A cooperative grid of G CTAs (at most one per SM), CTA q
// owning the obs slice [o0, o1) of e and of every row of x_t (bakp_slice).
// Algorithm 1 needs a full reduction over obs before each column's update,
// so every column costs one grid-wide barrier, and no more:
//   1. CTA q sums its k partial dots <x_j, e>[slice] in a fixed thread order
//      and writes them to partials[step & 1][q];                 grid.sync()
//   2. EVERY CTA sums the G partials of column j in the same fixed order, so
//      all CTAs hold the same bits of da_j = g_j * inv_j with no owner-thread
//      pass and no second barrier;
//   3. each CTA updates its own slice, e[:, slice] -= da_j x_j[slice].
// The two alternating partial buffers make one barrier safe: a CTA writes
// column j+2's partials (into the buffer of column j) only after barrier
// j+1, and every CTA finished reading column j's partials before it reached
// that barrier.  `step` counts columns across sweeps so the parity
// alternates across sweep boundaries too.
//
// Where e lives.  When k·L + L floats fit a CTA's shared memory (L the
// slice length), the slice of e stays in shared memory for the whole launch
// and x_j's slice is staged there between the dot and the update, so x is
// read from device memory once per column.  Otherwise e stays in device
// memory (its slice is L2-resident) and x_j is read twice.  The launch
// plan (bak_plan) picks one; the math is the same.
// fp32 FMAs throughout; no tensor cores.
#pragma once

#include "bakp_block.cuh"

// Positions of x_j one thread loads at once in the partial-dot pass when
// it owns more than one (bak_x_batch).
#define BAK_X_BATCH 8

// Where a CTA keeps its slice of the residual(s) and the staged column.
struct BakCta {
  BakpSlice s;   // obs slice [o0, o1)
  float* eb;     // e slice: shared memory, or e + o0 in device memory
  int es;        // stride between right-hand sides of eb (L or obs)
  float* xs;     // staged x_j slice in shared memory, or nullptr
  float* s_g;    // k floats of shared memory: partial or full inner products
};

// Per-thread values v[0..kc) summed over the CTA in a fixed order (warp
// butterfly, then warps in index order); the sums land in out[0..kc).
// s_red holds (blockDim.x / 32)·KC floats.  Ends with a __syncthreads, so
// out is visible to every thread on return.
template <int KC>
__device__ __forceinline__ void bak_block_sum(float (&v)[KC], int kc,
                                              float* s_red, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int r = 0; r < KC; ++r) v[r] = warp_sum(v[r]);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < KC; ++r) s_red[warp * KC + r] = v[r];
  __syncthreads();
  if ((int)threadIdx.x < kc) {
    float t = 0.f;
    for (int w = 0; w < nwarps; ++w) t += s_red[w * KC + threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

// One Algorithm-1 column j (see top).  xj is row j of x_t; partials the
// (2, G, k) scratch; step the running column count.  On return c.s_g holds
// g_j (k floats, the same bits in every CTA); da_j = g_j * inv_j.  XB is
// bak_x_batch's choice for this launch.
template <int KC, int XB>
__device__ void bak_column_step(cg::grid_group& grid,
                                const float* __restrict__ xj, float inv_j,
                                const BakCta& c, int k, float* partials,
                                int step, float* s_red) {
  const int n = c.s.o1 - c.s.o0;
  const int G = gridDim.x;
  float* part = partials + (size_t)(step & 1) * G * k;
  const float* xrow = xj + c.s.o0;

  // 1. this CTA's partial inner products, staging x_j's slice.  With XB > 1
  // a thread issues the loads of up to XB of its positions before using
  // any, so their device-memory latencies overlap instead of adding up.
  for (int r0 = 0; r0 < k; r0 += KC) {
    const int kc = k - r0 < KC ? k - r0 : KC;
    float acc[KC];
#pragma unroll
    for (int r = 0; r < KC; ++r) acc[r] = 0.f;
    if constexpr (XB == 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        float xv;
        if (c.xs == nullptr) {
          xv = __ldg(xrow + i);
        } else if (r0 == 0) {
          xv = __ldg(xrow + i);
          c.xs[i] = xv;          // read back by this same thread only
        } else {
          xv = c.xs[i];
        }
#pragma unroll
        for (int r = 0; r < KC; ++r)
          if (r < kc) acc[r] = fmaf(xv, c.eb[(size_t)(r0 + r) * c.es + i], acc[r]);
      }
    } else {
      for (int base = threadIdx.x; base < n; base += XB * blockDim.x) {
        float xv[XB];
#pragma unroll
        for (int u = 0; u < XB; ++u) {
          const int i = base + u * blockDim.x;
          xv[u] = i >= n ? 0.f
                  : (c.xs != nullptr && r0 > 0) ? c.xs[i] : __ldg(xrow + i);
        }
#pragma unroll
        for (int u = 0; u < XB; ++u) {
          const int i = base + u * blockDim.x;
          if (i >= n) break;
          if (c.xs != nullptr && r0 == 0) c.xs[i] = xv[u];  // read back by this thread only
#pragma unroll
          for (int r = 0; r < KC; ++r)
            if (r < kc)
              acc[r] = fmaf(xv[u], c.eb[(size_t)(r0 + r) * c.es + i], acc[r]);
        }
      }
    }
    bak_block_sum<KC>(acc, kc, s_red, c.s_g + r0);
    if ((int)threadIdx.x < kc)
      part[(size_t)blockIdx.x * k + r0 + threadIdx.x] = c.s_g[r0 + threadIdx.x];
  }
  grid.sync();

  // 2. every CTA reduces the G partials in the same fixed order.
  for (int r0 = 0; r0 < k; r0 += KC) {
    const int kc = k - r0 < KC ? k - r0 : KC;
    float acc[KC];
#pragma unroll
    for (int r = 0; r < KC; ++r) acc[r] = 0.f;
    for (int q = threadIdx.x; q < G; q += blockDim.x)
#pragma unroll
      for (int r = 0; r < KC; ++r)
        if (r < kc) acc[r] += __ldcg(part + (size_t)q * k + r0 + r);
    bak_block_sum<KC>(acc, kc, s_red, c.s_g + r0);
  }

  // 3. the update of this CTA's slice (the same positions each thread
  // owned in step 1, so the staged x_j needs no barrier).
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float xv = c.xs == nullptr ? __ldg(xrow + i) : c.xs[i];
    for (int r = 0; r < k; ++r) {
      float* ep = c.eb + (size_t)r * c.es + i;
      *ep = fmaf(-(c.s_g[r] * inv_j), xv, *ep);
    }
  }
}

// Grid-wide SSE of the residual slices: per-CTA partial in a fixed thread
// order, then every CTA sums the G partials in index order (as
// bakp_grid_sse), so every CTA takes the same stop decision.
__device__ float bak_grid_sse(cg::grid_group& grid, const BakCta& c, int k,
                              float* sse_part, float* s_red) {
  const int n = c.s.o1 - c.s.o0;
  float acc[1] = {0.f};
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float v = c.eb[(size_t)r * c.es + i];
      acc[0] = fmaf(v, v, acc[0]);
    }
  bak_block_sum<1>(acc, 1, s_red, c.s_g);
  if (threadIdx.x == 0) sse_part[blockIdx.x] = c.s_g[0];
  grid.sync();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int q = 0; q < (int)gridDim.x; ++q) t += (double)__ldcg(sse_part + q);
    c.s_g[0] = (float)t;
  }
  __syncthreads();
  const float out = c.s_g[0];
  __syncthreads();
  return out;
}

// XB of the launch: batched loads pay where a thread owns several
// positions of a slice of length L, and cost a little where it owns one
// (measured both ways at the two chip_smoke.py shapes, see PERF.md).
static inline bool bak_x_batched(int L) { return L > BAKP_THREADS; }

// Dynamic shared memory of a CTA: g (k, padded to 4), then with e_smem the
// e slice (k·L) and the staged column (L).
static inline size_t bak_smem_bytes(int L, int k, bool e_smem) {
  const size_t kp = ((size_t)k + 3) / 4 * 4;
  return sizeof(float) * (kp + (e_smem ? (size_t)(k + 1) * L : 0));
}

// Carve the dynamic shared memory and point the CTA at its slice.
__device__ __forceinline__ BakCta bak_cta(float* smem, float* e, int obs,
                                          int k, bool e_smem) {
  BakCta c;
  c.s = bakp_slice(obs);
  c.s_g = smem;
  const int kp = (k + 3) / 4 * 4;
  if (e_smem) {
    const int L = bakp_slice_len(obs, gridDim.x);
    c.eb = smem + kp;
    c.es = L;
    c.xs = smem + kp + (size_t)k * L;
  } else {
    c.eb = e + c.s.o0;
    c.es = obs;
    c.xs = nullptr;
  }
  return c;
}

// Copy the CTA's slice of a device residual into its own slice (shared
// memory, or the output residual in device memory), and back out.
__device__ __forceinline__ void bak_load_slice(const BakCta& c, const float* src,
                                               int obs, int k) {
  const int n = c.s.o1 - c.s.o0;
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      c.eb[(size_t)r * c.es + i] = src[(size_t)r * obs + c.s.o0 + i];
  __syncthreads();
}

__device__ __forceinline__ void bak_store_slice(const BakCta& c, float* dst,
                                                int obs, int k) {
  if (c.xs == nullptr) return;   // e already lives in dst
  const int n = c.s.o1 - c.s.o0;
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[(size_t)r * obs + c.s.o0 + i] = c.eb[(size_t)r * c.es + i];
}

// Launch plan: G = min(SMs, ceil(obs / min_obs)) CTAs, one per SM at most
// (every CTA reads all G partials per column, so more CTAs cost more L2
// traffic and a longer reduction).  e_smem when the slice and the staged
// column fit one CTA's shared memory at one CTA per SM.
template <typename F>
static cudaError_t bak_plan(F fn, int obs, int k, int min_obs, int* grid,
                            int* e_smem) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int G = (obs + min_obs - 1) / min_obs;
  G = G < 1 ? 1 : (G > sms ? sms : G);
  const int L = bakp_slice_len(obs, G);
  for (int mode = 1; mode >= 0; --mode) {
    const size_t smem = bak_smem_bytes(L, k, mode == 1);
    if (smem > (size_t)optin) continue;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, BAKP_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm >= 1) {
      *grid = G;
      *e_smem = mode;
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}
