// SolveBakF feature scores (paper Algorithm 3, line 3) for every feature in
// one pass over x: score_j = <x_j, e>^2 * inv_cn_j.
//
// Replaces the TPU kernel repro/kernels/block_update.py::_score_kernel
// (pallas_call in score_features, entry ops.score_features_kernel), which
// widens x to fp32 as it loads it: x is fp32 or bf16 here too (TX), each
// bf16 value widened exactly as it is loaded; e, inv_cn, the sums and the
// output are fp32.
//
// What bounds it on an H100: device-memory bytes.  2·vars·obs FLOP against
// vars·obs·sizeof(TX) bytes of x, at most one FLOP per byte, far below the
// fp32 ridge.  So the design is a streaming reduction: one warp per feature
// row of x_t, lanes along obs with 16-byte loads of x where the rows are
// aligned (4 fp32 or 8 bf16 values a lane, against one or two float4 of
// e), fp32 sums in a fixed order.  When vars alone gives too few warps to
// keep every SM's loads in flight, obs is split into `nchunks` chunks, each
// warp sums one (row, chunk), and a second pass adds a row's chunk sums in
// chunk order.  No atomics, so repeated runs give the same bits.
//
// C interface (loaded with ctypes; pointers and stream void*-sized; returns
// a cudaError_t, 0 on success):
//   score_features_launch(x_t, x_bytes, e, inv_cn, out, part, nvars, obs,
//                         chunk, nchunks, stream)
// x_t untyped with its element size x_bytes (4 fp32, 2 bf16); `part` is
// (nchunks, nvars) fp32 scratch (unused when nchunks == 1); `chunk` is a
// multiple of 32 lanes x (16 / x_bytes) obs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bakp_block.cuh"

#define SCORE_THREADS 256
#define SCORE_WARPS (SCORE_THREADS / 32)

// 16 bytes of x at p (16-byte aligned) widened to fp32.
__device__ __forceinline__ void score_ld16(const float* p, float* v) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void score_ld16(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {          // value 2i is the low half of word i
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename TX>
__global__ void __launch_bounds__(SCORE_THREADS)
score_partial_kernel(const TX* __restrict__ x_t, const float* __restrict__ e,
                     const float* __restrict__ inv_cn, float* __restrict__ out,
                     float* __restrict__ part, int nvars, int obs, int chunk,
                     int nchunks, int vec) {
  constexpr int V = 16 / sizeof(TX);     // x values in one 16-byte load
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * SCORE_WARPS + (threadIdx.x >> 5);
  if (j >= nvars) return;                 // whole warp: no shuffle pending
  const int c = blockIdx.y;
  const long long o0 = (long long)c * chunk;
  const long long o1 = o0 + chunk < obs ? o0 + chunk : obs;
  const TX* xrow = x_t + (size_t)j * obs;
  float acc = 0.f;
  if (vec) {
    // o0 and o1 are multiples of V, so the V-wide steps tile [o0, o1).
    for (long long o = o0 + V * lane; o < o1; o += 32 * V) {
      float xv[V];
      score_ld16(xrow + o, xv);
#pragma unroll
      for (int q = 0; q < V; q += 4) {
        const float4 ev = __ldg(reinterpret_cast<const float4*>(e + o + q));
        acc = fmaf(xv[q], ev.x, acc);
        acc = fmaf(xv[q + 1], ev.y, acc);
        acc = fmaf(xv[q + 2], ev.z, acc);
        acc = fmaf(xv[q + 3], ev.w, acc);
      }
    }
  } else {
    for (long long o = o0 + lane; o < o1; o += 32)
      acc = fmaf(bakp_f(xrow[o]), __ldg(e + o), acc);
  }
  acc = warp_sum(acc);
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

template <typename TX>
static cudaError_t score_launch(const TX* x_t, const float* e, const float* inv_cn,
                                float* out, float* part, int nvars, int obs, int chunk,
                                int nchunks, cudaStream_t s) {
  constexpr int V = 16 / sizeof(TX);
  const int vec = obs % V == 0 && chunk % V == 0 && (uintptr_t)x_t % 16 == 0 &&
                  (uintptr_t)e % 16 == 0;
  const dim3 grid((nvars + SCORE_WARPS - 1) / SCORE_WARPS, nchunks);
  score_partial_kernel<TX><<<grid, SCORE_THREADS, 0, s>>>(
      x_t, e, inv_cn, out, part, nvars, obs, chunk, nchunks, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return err;
  score_finish_kernel<<<(nvars + 255) / 256, 256, 0, s>>>(part, inv_cn, out,
                                                           nvars, nchunks);
  return cudaGetLastError();
}

extern "C" int score_features_launch(const void* x_t, int x_bytes, const float* e,
                                     const float* inv_cn, float* out,
                                     float* part, int nvars, int obs,
                                     int chunk, int nchunks, void* stream) {
  return bakp_with_x(x_t, x_bytes, [&](auto x) {
    return score_launch(x, e, inv_cn, out, part, nvars, obs, chunk, nchunks,
                        (cudaStream_t)stream);
  });
}
