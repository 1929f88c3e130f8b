// cp.async helpers shared by the kernels that stream x through a
// shared-memory ring or slice (bakp_solve.cuh, bakp_sweep.cu, bak_column.cuh):
// 16-byte cp.async.cg copies where source and destination are 16-byte
// aligned, 8- or 4-byte cp.async.ca copies where only those are, one commit
// group per stage.  x is fp32 or bf16; a bf16 row of odd length has rows
// that start mid-word, which no cp.async size can copy, so it is copied
// with plain 2-byte loads and stores (cp_bytes picks the width).
#pragma once

#include <stdint.h>

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// One copy of B bytes: a cp.async for 16, 8 or 4; for 2, a plain load and
// store, which lands before the thread goes on (the barrier that makes a
// stage visible to the other threads follows every copy either way).
template <int B>
__device__ __forceinline__ void cp_async_b(void* dst, const void* src) {
  if constexpr (B == 16) cp_async16(dst, src);
  else if constexpr (B == 8) cp_async8(dst, src);
  else if constexpr (B == 4) cp_async4(dst, src);
  else *static_cast<unsigned short*>(dst) = *static_cast<const unsigned short*>(src);
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

// The block's threads copy `rows` rows of n elements (row stride src_ld in
// device memory) into dst (row stride dst_ld), B bytes a copy (B / sizeof(T)
// elements; n a multiple of them, as cp_bytes guarantees).  Row and column
// of a thread's copies advance by adds, not a division per copy.
template <int B, typename T>
__device__ __forceinline__ void cp_async_rows(T* dst, int dst_ld, const T* src, int src_ld,
                                              int rows, int n) {
  constexpr int W = B / (int)sizeof(T);
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
    cp_async_b<B>(dst + (size_t)r * dst_ld + W * i, src + (size_t)r * src_ld + W * i);
  }
}

// cp_async_rows with the width b of a copy known only at run time: 16 or
// 4 bytes, and 2 for a bf16 x.
template <typename T>
__device__ __forceinline__ void cp_async_rows_b(T* dst, int dst_ld, const T* src, int src_ld,
                                                int rows, int n, int b) {
  if (b == 16) {
    cp_async_rows<16>(dst, dst_ld, src, src_ld, rows, n);
  } else if constexpr (sizeof(T) == 2) {
    if (b == 4) cp_async_rows<4>(dst, dst_ld, src, src_ld, rows, n);
    else cp_async_rows<2>(dst, dst_ld, src, src_ld, rows, n);
  } else {
    cp_async_rows<4>(dst, dst_ld, src, src_ld, rows, n);
  }
}

// Host side: bytes one copy of x moves, for rows of row_bytes bytes from
// base: `wide` where both are multiples of it, else 4 where they are (the
// narrowest cp.async), else 2 (a bf16 row of odd length).  Slices start on
// 32-element boundaries, so every slice of every row keeps the alignment.
static inline int cp_bytes(const void* base, long long row_bytes, int wide) {
  const uintptr_t a = (uintptr_t)base;
  if (row_bytes % wide == 0 && a % wide == 0) return wide;
  if (row_bytes % 4 == 0 && a % 4 == 0) return 4;
  return 2;
}
