// SolveBakF feature scores (paper Algorithm 3, line 3) for every feature in
// one pass over x: score_j = <x_j, e>^2 * inv_cn_j.
//
// Replaces the TPU kernel repro/kernels/block_update.py::_score_kernel
// (pallas_call in score_features, entry ops.score_features_kernel).
//
// What bounds it on an H100: device-memory bytes.  2·vars·obs FLOP against
// vars·obs·4 bytes of x, half a FLOP per byte, far below the fp32 ridge.
// So the design is a streaming reduction: one warp per feature row of x_t,
// lanes along obs with 16-byte loads where the rows are aligned, fp32 sums
// in a fixed order.  When vars alone gives too few warps to keep every SM's
// loads in flight, obs is split into `nchunks` chunks, each warp sums one
// (row, chunk), and a second pass adds a row's chunk sums in chunk order.
// No atomics, so repeated runs give the same bits.
//
// C interface (loaded with ctypes; pointers and stream void*-sized; returns
// a cudaError_t, 0 on success):
//   score_features_launch(x_t, e, inv_cn, out, part, nvars, obs, chunk,
//                         nchunks, stream)
// `part` is (nchunks, nvars) fp32 scratch (unused when nchunks == 1);
// `chunk` is a multiple of 128 obs.
#include <cuda_runtime.h>
#include <stdint.h>

#define SCORE_THREADS 256
#define SCORE_WARPS (SCORE_THREADS / 32)

__device__ __forceinline__ float score_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(SCORE_THREADS)
score_partial_kernel(const float* __restrict__ x_t, const float* __restrict__ e,
                     const float* __restrict__ inv_cn, float* __restrict__ out,
                     float* __restrict__ part, int nvars, int obs, int chunk,
                     int nchunks, int vec) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * SCORE_WARPS + (threadIdx.x >> 5);
  if (j >= nvars) return;                 // whole warp: no shuffle pending
  const int c = blockIdx.y;
  const long long o0 = (long long)c * chunk;
  const long long o1 = o0 + chunk < obs ? o0 + chunk : obs;
  const float* xrow = x_t + (size_t)j * obs;
  float acc = 0.f;
  if (vec) {
    // o0 is a multiple of 128 and o1 of 4, so the float4 steps tile [o0, o1).
    for (long long o = o0 + 4 * lane; o < o1; o += 128) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(xrow + o));
      const float4 ev = __ldg(reinterpret_cast<const float4*>(e + o));
      acc = fmaf(xv.x, ev.x, acc);
      acc = fmaf(xv.y, ev.y, acc);
      acc = fmaf(xv.z, ev.z, acc);
      acc = fmaf(xv.w, ev.w, acc);
    }
  } else {
    for (long long o = o0 + lane; o < o1; o += 32)
      acc = fmaf(__ldg(xrow + o), __ldg(e + o), acc);
  }
  acc = score_warp_sum(acc);
  if (lane == 0) {
    if (nchunks == 1) out[j] = acc * acc * __ldg(inv_cn + j);
    else part[(size_t)c * nvars + j] = acc;
  }
}

__global__ void score_finish_kernel(const float* __restrict__ part,
                                    const float* __restrict__ inv_cn,
                                    float* __restrict__ out, int nvars,
                                    int nchunks) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nvars) return;
  float g = 0.f;
  for (int c = 0; c < nchunks; ++c) g += part[(size_t)c * nvars + j];
  out[j] = g * g * inv_cn[j];
}

extern "C" int score_features_launch(const float* x_t, const float* e,
                                     const float* inv_cn, float* out,
                                     float* part, int nvars, int obs,
                                     int chunk, int nchunks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = obs % 4 == 0 && (uintptr_t)x_t % 16 == 0 && (uintptr_t)e % 16 == 0;
  const dim3 grid((nvars + SCORE_WARPS - 1) / SCORE_WARPS, nchunks);
  score_partial_kernel<<<grid, SCORE_THREADS, 0, s>>>(
      x_t, e, inv_cn, out, part, nvars, obs, chunk, nchunks, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return err;
  score_finish_kernel<<<(nvars + 255) / 256, 256, 0, s>>>(part, inv_cn, out,
                                                           nvars, nchunks);
  return cudaGetLastError();
}
