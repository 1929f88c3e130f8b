// Small pieces shared by every solver kernel: the obs slices of a grid of
// CTAs, warp_sum, bakp_ld4, the device copy of sweep_stop_flags and
// bakp_pick_kc.  The Algorithm-2 block step itself is bakp_cluster.cuh's
// (on thread-block clusters), the Algorithm-1 column step bak_column.cuh's.
//
// Layout (the JAX package's kernel layout): x_t (vars, obs) row-major, fp32
// or bf16 (the kernels' TX; a bf16 value is widened to fp32 as it is
// loaded, as the Pallas kernels widen x), a paper-"column" is a contiguous
// row; residuals e (k, obs), coefficients and increments (vars, k) and
// inv_cn (vars,) in fp32.
//
// Decomposition.  The TPU kernels keep e in VMEM scratch across grid steps
// that run in order on one core.  CUDA blocks run in no order, so the obs
// axis is split instead (the decomposition core/distributed.py::_bakp_local
// runs with a psum): CTA q of a grid of G owns the obs slice [o0, o1) of e
// and of every row of x_t (bakp_slice), and the kernels sum across CTAs in
// a fixed order.  fp32 FMAs throughout; no tensor cores (no TF32).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define BAKP_THREADS 256
// Launch bounds of the solver kernels for x of type TX: BAKP_THREADS
// threads and, for a bf16 x, one CTA an SM (what cl_launch_smem's shared
// memory makes it anyway).  Without that minimum ptxas holds some bf16
// instantiations to 128 registers and spills; an fp32 kernel keeps ptxas's
// own choice (a minimum of 0 gives the registers of no minimum).
#define BAKP_BOUNDS(TX) __launch_bounds__(BAKP_THREADS, sizeof(TX) == 2 ? 1 : 0)
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

// One element of x as fp32 (a bf16's bits are the top half of the float
// it widens to, so the widening is exact).
__device__ __forceinline__ float bakp_f(float v) { return v; }
__device__ __forceinline__ float bakp_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The C entries take x_t untyped, with its element size in bytes (4 fp32, 2
// bf16): f runs on x_t as the typed pointer; any other size is refused.
template <typename F>
static int bakp_with_x(const void* x_t, int x_bytes, F f) {
  if (x_bytes == 4) return (int)f(static_cast<const float*>(x_t));
  if (x_bytes == 2) return (int)f(static_cast<const __nv_bfloat16*>(x_t));
  return (int)cudaErrorInvalidValue;
}

// Four consecutive floats: one 16-byte access where the address is
// 16-byte aligned (shared memory), four otherwise (device memory rows).
template <bool A16>
__device__ __forceinline__ float4 bakp_ld4(const float* p) {
  if constexpr (A16) return *reinterpret_cast<const float4*>(p);
  else return make_float4(p[0], p[1], p[2], p[3]);
}

// Four consecutive bf16 values widened to fp32: one 8-byte access where the
// address is 8-byte aligned (shared memory), four otherwise.  Value 2i is
// the low half of word i (little-endian).
template <bool A16>
__device__ __forceinline__ float4 bakp_ld4(const __nv_bfloat16* p) {
  if constexpr (A16) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  } else {
    return make_float4(bakp_f(p[0]), bakp_f(p[1]), bakp_f(p[2]), bakp_f(p[3]));
  }
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
