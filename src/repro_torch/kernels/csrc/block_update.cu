// Rank-CB residual correction (paper Algorithm 2, line 9), obs unbounded:
// e' = e - da^T x_blk, for k right-hand sides sharing one pass over x_blk.
//
// Replaces the TPU kernel repro/kernels/block_update.py::_block_update_kernel
// (pallas_call in block_update, entry ops.block_update_kernel), which
// widens x to fp32 as it loads it: x_blk is fp32 or bf16 here too (TX),
// each bf16 value widened exactly as it is loaded; da and the residuals
// are fp32.
//
// What bounds it on an H100: device-memory bytes.  2·CB·obs·k FLOP against
// CB·obs·sizeof(TX) bytes of x plus 2·k·obs·4 of residuals: at most k FLOP
// a byte, under the fp32 ridge for any k the kernels take.  The design: a
// regular grid over obs; da (CB·k floats) is staged in shared memory once per CTA;
// each thread owns 4 consecutive obs (one 16-byte load of fp32 x or one
// 8-byte load of bf16 x where aligned), carries KC right-hand sides of e in
// registers and streams the CB rows of x_blk past them.  fp32 FMAs in a
// fixed order; no tensor cores, no atomics.
//
// C interface (loaded with ctypes; pointers and stream void*-sized; returns
// a cudaError_t, 0 on success):
//   block_update_launch(x_blk, x_bytes, da, e_in, e_out, cb, obs, k, stream)
// x_blk untyped with its element size x_bytes (4 fp32, 2 bf16).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bakp_block.cuh"

#define BU_THREADS 128

// Four consecutive values of x at p (4·sizeof(TX)-byte aligned) as fp32.
__device__ __forceinline__ float4 bu_ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 bu_ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// A bf16 instantiation asks for one CTA an SM, which lifts ptxas's register
// cap (at KC 8 it spilled without), and unrolls the row loop 8 deep, twice
// fp32's, to keep as many bytes of x in flight with half-size loads.
template <int KC, typename TX>
__global__ void __launch_bounds__(BU_THREADS, sizeof(TX) == 2 ? 1 : 0)
block_update_kernel(const TX* __restrict__ x, const float* __restrict__ da,
                    const float* __restrict__ e_in, float* __restrict__ e_out,
                    int cb, int obs, int k, int vec) {
  extern __shared__ float s_da[];
  for (int i = threadIdx.x; i < cb * k; i += blockDim.x) s_da[i] = da[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x * 4;
  for (long long o = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       o < obs; o += stride) {
    for (int r0 = 0; r0 < k; r0 += KC) {
      const int kc = k - r0 < KC ? k - r0 : KC;
      if (vec) {   // obs % 4 == 0: the 4 positions from o are in range
        float4 ev[KC];
#pragma unroll
        for (int r = 0; r < KC; ++r)
          if (r < kc)
            ev[r] = __ldg(reinterpret_cast<const float4*>(e_in + (size_t)(r0 + r) * obs + o));
#pragma unroll (sizeof(TX) == 2 ? 8 : 4)
        for (int c = 0; c < cb; ++c) {
          const float4 xv = bu_ld4(x + (size_t)c * obs + o);
#pragma unroll
          for (int r = 0; r < KC; ++r)
            if (r < kc) {
              const float d = -s_da[c * k + r0 + r];
              ev[r].x = fmaf(d, xv.x, ev[r].x);
              ev[r].y = fmaf(d, xv.y, ev[r].y);
              ev[r].z = fmaf(d, xv.z, ev[r].z);
              ev[r].w = fmaf(d, xv.w, ev[r].w);
            }
        }
#pragma unroll
        for (int r = 0; r < KC; ++r)
          if (r < kc)
            *reinterpret_cast<float4*>(e_out + (size_t)(r0 + r) * obs + o) = ev[r];
      } else {
        for (int t = 0; t < 4 && o + t < obs; ++t) {
          float ev[KC];
#pragma unroll
          for (int r = 0; r < KC; ++r)
            ev[r] = r < kc ? __ldg(e_in + (size_t)(r0 + r) * obs + o + t) : 0.f;
          for (int c = 0; c < cb; ++c) {
            const float xv = bakp_f(x[(size_t)c * obs + o + t]);
#pragma unroll
            for (int r = 0; r < KC; ++r)
              if (r < kc) ev[r] = fmaf(-s_da[c * k + r0 + r], xv, ev[r]);
          }
#pragma unroll
          for (int r = 0; r < KC; ++r)
            if (r < kc) e_out[(size_t)(r0 + r) * obs + o + t] = ev[r];
        }
      }
    }
  }
}

template <int KC, typename TX>
static cudaError_t bu_launch(const TX* x, const float* da, const float* e_in,
                             float* e_out, int cb, int obs, int k, void* stream) {
  const size_t smem = (size_t)cb * k * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_update_kernel<KC, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int vec = obs % 4 == 0 && (uintptr_t)x % (4 * sizeof(TX)) == 0 &&
                  (uintptr_t)e_in % 16 == 0 && (uintptr_t)e_out % 16 == 0;
  long long blocks = ((long long)obs + 4 * BU_THREADS - 1) / (4 * BU_THREADS);
  if (blocks > 32LL * sms) blocks = 32LL * sms;   // grid-stride beyond that
  if (blocks < 1) blocks = 1;
  block_update_kernel<KC, TX><<<(int)blocks, BU_THREADS, smem, (cudaStream_t)stream>>>(
      x, da, e_in, e_out, cb, obs, k, vec);
  return cudaGetLastError();
}

template <typename TX>
static cudaError_t bu_pick(const TX* x, const float* da, const float* e_in, float* e_out,
                           int cb, int obs, int k, void* stream) {
  switch (bakp_pick_kc(k)) {
    case 1: return bu_launch<1>(x, da, e_in, e_out, cb, obs, k, stream);
    case 2: return bu_launch<2>(x, da, e_in, e_out, cb, obs, k, stream);
    case 4: return bu_launch<4>(x, da, e_in, e_out, cb, obs, k, stream);
    default: return bu_launch<8>(x, da, e_in, e_out, cb, obs, k, stream);
  }
}

extern "C" int block_update_launch(const void* x, int x_bytes, const float* da,
                                   const float* e_in, float* e_out, int cb,
                                   int obs, int k, void* stream) {
  return bakp_with_x(x, x_bytes, [&](auto xt) {
    return bu_pick(xt, da, e_in, e_out, cb, obs, k, stream);
  });
}
