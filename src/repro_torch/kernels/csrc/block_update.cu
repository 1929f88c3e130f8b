// Rank-CB residual correction (paper Algorithm 2, line 9), obs unbounded:
// e' = e - da^T x_blk, for k right-hand sides sharing one pass over x_blk.
//
// Replaces the TPU kernel repro/kernels/block_update.py::_block_update_kernel
// (pallas_call in block_update, entry ops.block_update_kernel).
//
// What bounds it on an H100: device-memory bytes.  2·CB·obs·k FLOP against
// CB·obs·4 bytes of x plus 2·k·obs·4 of residuals: at most 2·k/4 FLOP a
// byte, under the fp32 ridge for any k the kernels take.  The design: a
// regular grid over obs; da (CB·k floats) is staged in shared memory once per CTA;
// each thread owns 4 consecutive obs (16-byte loads where aligned), carries
// KC right-hand sides of e in registers and streams the CB rows of x_blk
// past them.  fp32 FMAs; no tensor cores.
//
// C interface (loaded with ctypes; pointers and stream void*-sized; returns
// a cudaError_t, 0 on success):
//   block_update_launch(x_blk, da, e_in, e_out, cb, obs, k, stream)
#include <cuda_runtime.h>
#include <stdint.h>

#define BU_THREADS 128

template <int KC>
__global__ void __launch_bounds__(BU_THREADS)
block_update_kernel(const float* __restrict__ x, const float* __restrict__ da,
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
#pragma unroll 4
        for (int c = 0; c < cb; ++c) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(x + (size_t)c * obs + o));
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
            const float xv = __ldg(x + (size_t)c * obs + o + t);
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

template <int KC>
static cudaError_t bu_launch(const float* x, const float* da, const float* e_in,
                             float* e_out, int cb, int obs, int k, void* stream) {
  const size_t smem = (size_t)cb * k * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_update_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int vec = obs % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)e_in % 16 == 0 && (uintptr_t)e_out % 16 == 0;
  long long blocks = ((long long)obs + 4 * BU_THREADS - 1) / (4 * BU_THREADS);
  if (blocks > 32LL * sms) blocks = 32LL * sms;   // grid-stride beyond that
  if (blocks < 1) blocks = 1;
  block_update_kernel<KC><<<(int)blocks, BU_THREADS, smem, (cudaStream_t)stream>>>(
      x, da, e_in, e_out, cb, obs, k, vec);
  return cudaGetLastError();
}

extern "C" int block_update_launch(const float* x, const float* da,
                                   const float* e_in, float* e_out, int cb,
                                   int obs, int k, void* stream) {
  const int kc = k == 1 ? 1 : k == 2 ? 2 : k <= 4 ? 4 : 8;
  switch (kc) {
    case 1: return bu_launch<1>(x, da, e_in, e_out, cb, obs, k, stream);
    case 2: return bu_launch<2>(x, da, e_in, e_out, cb, obs, k, stream);
    case 4: return bu_launch<4>(x, da, e_in, e_out, cb, obs, k, stream);
    default: return bu_launch<8>(x, da, e_in, e_out, cb, obs, k, stream);
  }
}
