// cp.async helpers shared by the kernels that stream x through a
// shared-memory ring or slice (bakp_solve.cuh, bakp_sweep.cu, bak_column.cuh):
// 16-byte cp.async.cg copies where source and destination are 16-byte
// aligned, 4-byte cp.async.ca copies otherwise, one commit group per stage.
#pragma once

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until at most n (0 to 6) of this thread's commit groups are in
// flight, for a ring whose depth is known only at run time.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// The block's threads copy `rows` rows of n floats (row stride src_ld in
// device memory) into dst (row stride dst_ld), W floats a copy (4: both
// sides 16-byte aligned and n % 4 == 0; 1 otherwise).  Row and column of a
// thread's copies advance by adds, not a division per copy.
template <int W>
__device__ __forceinline__ void cp_async_rows(float* dst, int dst_ld, const float* src,
                                              int src_ld, int rows, int n) {
  const int nw = n / W;
  if (nw == 0) return;
  const int step_r = blockDim.x / nw, step_i = blockDim.x - step_r * nw;
  int r = threadIdx.x / nw, i = threadIdx.x - r * nw;
  for (; r < rows; r += step_r, i += step_i) {
    if (i >= nw) {
      i -= nw;
      ++r;
      if (r >= rows) break;
    }
    if constexpr (W == 4) cp_async16(dst + (size_t)r * dst_ld + 4 * i, src + (size_t)r * src_ld + 4 * i);
    else cp_async4(dst + (size_t)r * dst_ld + i, src + (size_t)r * src_ld + i);
  }
}
