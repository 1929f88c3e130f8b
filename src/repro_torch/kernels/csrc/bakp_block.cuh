// SolveBakP (paper Algorithm 2) block step on a cooperative grid, run by
// the whole-solve kernel (fused_solve.cu).  The per-sweep and streaming
// kernels (bakp_sweep.cu, stream_solve.cu) run bakp_cluster.cuh's step on
// thread-block clusters instead, which sums in another fixed order, so the
// three agree to fp32 rounding, not bit for bit.  The small shared pieces
// (slices, warp_sum, bakp_ld4, sweep_stop_flags, bakp_pick_kc) stay here
// for all of them and for bak_column.cuh.
//
// Layout (the JAX package's kernel layout): x_t (vars, obs) row-major fp32,
// a paper-"column" is a contiguous row; residuals e (k, obs); coefficients
// and increments (vars, k); inv_cn (vars,).
//
// Decomposition.  The TPU kernels keep e in VMEM scratch across grid steps
// that run in order on one core.  CUDA blocks run in no order, so the obs
// axis is split instead (the decomposition core/distributed.py::_bakp_local
// runs with a psum): a cooperative grid of G CTAs, CTA q owning the obs
// slice [o0, o1) of e and of every row of x_t.  Per column block b:
//   1. partials: CTA q writes g_q = x_b[:, slice] · e[:, slice]ᵀ (CB x k)
//      to partials[q];                                       grid.sync()
//   2. reduce:   each (c, r) entry has one owner thread in the grid, which
//      sums partials[0..G) in fixed index order (no atomics, so the result
//      is the same every run), forms da = ω·g·inv_c, writes it to da_buf and
//      stores or accumulates it into the coefficients;       grid.sync()
//   3. update:   every CTA copies da into shared memory and updates its own
//      slice, e[:, slice] -= daᵀ · x_b[:, slice].
// The three phases and the SSE take their operands as (base, row stride)
// and a range [ob, oe) of positions: the whole-solve kernel passes x and e
// in device memory with stride obs and the CTA's slice [o0, o1).  fp32
// FMAs throughout; no tensor cores (no TF32).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define BAKP_THREADS 256
// Columns of a block one warp carries through the obs slice at once.
#define BAKP_COLS_PER_WARP 4
// Slices start on 32-float (128-byte) boundaries.
#define BAKP_SLICE_ALIGN 32

struct BakpSlice {
  int o0, o1;
};

// Obs positions each CTA of a G-CTA grid owns (the last may own fewer).
__host__ __device__ __forceinline__ int bakp_slice_len(int obs, int G) {
  const int L = (obs + G - 1) / G;
  return (L + BAKP_SLICE_ALIGN - 1) / BAKP_SLICE_ALIGN * BAKP_SLICE_ALIGN;
}

__device__ __forceinline__ BakpSlice bakp_slice(int obs) {
  const int L = bakp_slice_len(obs, gridDim.x);
  const long long start = (long long)blockIdx.x * L;
  const int o0 = start < obs ? (int)start : obs;
  const int o1 = o0 + L < obs ? o0 + L : obs;
  return {o0, o1};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Four consecutive floats: one 16-byte access where the address is
// 16-byte aligned (shared memory), four otherwise (device memory rows).
template <bool A16>
__device__ __forceinline__ float4 bakp_ld4(const float* p) {
  if constexpr (A16) return *reinterpret_cast<const float4*>(p);
  else return make_float4(p[0], p[1], p[2], p[3]);
}

// A load of x: through the read-only cache from device memory, or a plain
// load from a shared-memory tile.
template <bool X_GLOBAL>
__device__ __forceinline__ float bakp_ld_x(const float* p) {
  if constexpr (X_GLOBAL) return __ldg(p);
  else return *p;
}

// Phase 1: this CTA's partial inner products g_q[c][r] over positions
// [ob, oe) of xb (row stride x_ld) and e (row stride e_ld).  Warp w carries
// BAKP_COLS_PER_WARP columns through the slice, KC right-hand sides at a
// time, lanes on consecutive positions.
template <int KC, bool X_GLOBAL>
__device__ void bakp_partials(const float* __restrict__ xb, int x_ld,
                              const float* e, int e_ld, int ob, int oe, int k,
                              int CB, float* part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  constexpr int CT = BAKP_COLS_PER_WARP;
  for (int r0 = 0; r0 < k; r0 += KC) {
    const int kc = k - r0 < KC ? k - r0 : KC;
    for (int c0 = warp * CT; c0 < CB; c0 += nwarps * CT) {
      float acc[CT][KC];
#pragma unroll
      for (int t = 0; t < CT; ++t)
#pragma unroll
        for (int r = 0; r < KC; ++r) acc[t][r] = 0.f;
      for (int o = ob + lane; o < oe; o += 32) {
        float ev[KC];
#pragma unroll
        for (int r = 0; r < KC; ++r)
          ev[r] = r < kc ? e[(size_t)(r0 + r) * e_ld + o] : 0.f;
#pragma unroll
        for (int t = 0; t < CT; ++t) {
          const float xv = c0 + t < CB
              ? bakp_ld_x<X_GLOBAL>(xb + (size_t)(c0 + t) * x_ld + o) : 0.f;
#pragma unroll
          for (int r = 0; r < KC; ++r) acc[t][r] = fmaf(xv, ev[r], acc[t][r]);
        }
      }
#pragma unroll
      for (int t = 0; t < CT; ++t)
#pragma unroll
        for (int r = 0; r < KC; ++r) {
          const float v = warp_sum(acc[t][r]);
          if (lane == 0 && c0 + t < CB && r < kc) part[(c0 + t) * k + r0 + r] = v;
        }
    }
  }
}

// Phase 2: fixed-order cross-CTA reduction; one owner thread per (c, r).
__device__ void bakp_reduce(const float* partials, float* da_buf,
                            float* coef_blk, bool accumulate,
                            const float* __restrict__ inv_blk, int CB, int k,
                            float omega) {
  const int G = gridDim.x;
  const int n = CB * k;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += G * blockDim.x) {
    float g = 0.f;
    for (int q = 0; q < G; ++q) g += __ldcg(partials + (size_t)q * n + idx);
    const float da = omega * g * __ldg(inv_blk + idx / k);
    da_buf[idx] = da;
    coef_blk[idx] = accumulate ? coef_blk[idx] + da : da;
  }
}

// Phase 3: e[:, slice] -= daᵀ · x_b[:, slice], one thread per position;
// operands as bakp_partials.
template <int KC, bool X_GLOBAL>
__device__ void bakp_update(const float* __restrict__ xb, int x_ld, float* e,
                            int e_ld, const float* s_da, int ob, int oe, int k,
                            int CB) {
  for (int o = ob + threadIdx.x; o < oe; o += blockDim.x) {
    for (int r0 = 0; r0 < k; r0 += KC) {
      const int kc = k - r0 < KC ? k - r0 : KC;
      float ev[KC];
#pragma unroll
      for (int r = 0; r < KC; ++r)
        ev[r] = r < kc ? e[(size_t)(r0 + r) * e_ld + o] : 0.f;
      for (int c = 0; c < CB; ++c) {
        const float xv = bakp_ld_x<X_GLOBAL>(xb + (size_t)c * x_ld + o);
#pragma unroll
        for (int r = 0; r < KC; ++r)
          if (r < kc) ev[r] = fmaf(-s_da[c * k + r0 + r], xv, ev[r]);
      }
#pragma unroll
      for (int r = 0; r < KC; ++r)
        if (r < kc) e[(size_t)(r0 + r) * e_ld + o] = ev[r];
    }
  }
}

// One Algorithm-2 column block b: partials, reduce, update (see top).
// accumulate: coef_b += da (whole solve) or coef_b = da (one sweep's da).
template <int KC>
__device__ void bakp_block_step(cg::grid_group& grid,
                                const float* __restrict__ x_t,
                                const float* __restrict__ inv_cn, float* e,
                                float* coef, bool accumulate, float* partials,
                                float* da_buf, float* s_da, int obs, int k,
                                int CB, int b, float omega, BakpSlice s) {
  const float* xb = x_t + (size_t)b * CB * obs;
  const size_t n = (size_t)CB * k;
  bakp_partials<KC, true>(xb, obs, e, obs, s.o0, s.o1, k, CB,
                          partials + blockIdx.x * n);
  grid.sync();
  bakp_reduce(partials, da_buf, coef + (size_t)b * n, accumulate,
              inv_cn + (size_t)b * CB, CB, k, omega);
  grid.sync();
  for (int i = threadIdx.x; i < (int)n; i += blockDim.x) s_da[i] = __ldcg(da_buf + i);
  __syncthreads();
  bakp_update<KC, true>(xb, obs, e, obs, s_da, s.o0, s.o1, k, CB);
  __syncthreads();
}

// Grid-wide SSE of e (k rows of stride e_ld): per-CTA partial over the
// CTA's positions [ob, oe) in a fixed thread order, then every CTA sums the
// G partials in index order, so all CTAs hold the same bits and take the
// same stop decision (one CTA leaving the sweep loop while another waits
// at grid.sync would hang the solve).  s_red holds 33 floats.
__device__ float bakp_grid_sse(cg::grid_group& grid, const float* e, int e_ld,
                               int ob, int oe, int k, float* sse_part,
                               float* s_red) {
  float acc = 0.f;
  for (int r = 0; r < k; ++r)
    for (int o = ob + threadIdx.x; o < oe; o += blockDim.x) {
      const float v = e[(size_t)r * e_ld + o];
      acc = fmaf(v, v, acc);
    }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += s_red[w];
    sse_part[blockIdx.x] = t;
  }
  grid.sync();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int q = 0; q < (int)gridDim.x; ++q) t += (double)__ldcg(sse_part + q);
    s_red[32] = (float)t;
  }
  __syncthreads();
  const float out = s_red[32];
  __syncthreads();
  return out;
}

// Device copy of repro/core/types.py::sweep_stop_flags: fp32 compares, the
// rtol>0 gating and the 1.01·sse0 divergence band.  Explicitly rounded
// operations keep the compiler from contracting them into an FMA.
__device__ __forceinline__ void sweep_stop_flags(float sse, float sse_prev,
                                                 float sse0, float atol_sse,
                                                 float rtol, bool* converged,
                                                 bool* stop) {
  const bool improved = sse <= sse_prev;
  const bool hit_atol = (atol_sse > 0.f) && (sse <= atol_sse);
  const bool hit_rtol = (rtol > 0.f) && improved &&
                        (__fsub_rn(sse_prev, sse) <= __fmul_rn(rtol, sse_prev));
  const bool rose = (rtol > 0.f) && !improved;
  *converged = hit_atol || hit_rtol || (rose && sse <= __fmul_rn(1.01f, sse0));
  *stop = hit_atol || hit_rtol || rose;
}

// Right-hand sides carried in registers per pass, from the RHS count.
static inline int bakp_pick_kc(int k) {
  return k == 1 ? 1 : k == 2 ? 2 : k <= 4 ? 4 : 8;
}

// Largest cooperative grid for kernel fn at this dynamic shared memory.
template <typename F>
static cudaError_t bakp_max_grid(F fn, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      BAKP_THREADS, smem);
  if (err != cudaSuccess) return err;
  *out = per_sm * sms;
  return cudaSuccess;
}

template <typename F, typename P>
static cudaError_t bakp_launch_coop(F fn, P params, int grid, size_t smem,
                                    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&params};
  err = cudaLaunchCooperativeKernel((const void*)fn, dim3(grid),
                                    dim3(BAKP_THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
