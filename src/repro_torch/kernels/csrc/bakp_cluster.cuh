// SolveBakP (paper Algorithm 2) block step on thread-block clusters, run by
// every Algorithm-2 kernel: the two whole-solve kernels (fused_solve.cu and
// stream_solve.cu, through bakp_solve.cuh's solve loop) and the per-sweep
// kernel (bakp_sweep.cu).
//
// Layout as bakp_block.cuh: x_t (vars, obs) row-major, its element TX fp32
// or bf16 (widened to fp32 as it is loaded); residuals e (k, obs),
// coefficients and increments (vars, k), inv_cn (vars,) in fp32.
//
// Decomposition.  G CTAs launched as clusters of C (cudaLaunchKernelEx
// with a cluster dimension; cooperative as well when there are several
// clusters, since a CTA then waits on words other clusters write), CTA q
// owning the obs slice [q·L, q·L + L) ∩ [0, obs) of e and of every row of
// x_t (bakp_slice); a CTA past the end owns none and still takes part in
// every exchange.  A block's CB·k partial inner products are kept as CB
// rows of kp (k padded to 1, 2 or a multiple of 4) and cut into C equal
// slices of S floats (S a multiple of 4), slice j owned by cluster rank j.
// Per column block b (step t; a whole solve whose exchange arrays do not
// fit every right-hand side runs one step per group of them, see
// bakp_solve.cuh):
//   1. partials: warp w carries 4 rows of the block through the CTA's
//      positions, lanes on consecutive float4 groups, KC right-hand sides
//      at a time, and ends with a butterfly reduce-scatter of its 4·KC
//      accumulators over the lanes (31 shuffles at KC 8), so each lane
//      writes one whole sum;                                __syncthreads
//   2. reduce-scatter: every thread pushes float4s of the partials with
//      st.async, slice j into CTA j's receive slot for this CTA's rank,
//      completing their bytes on CTA j's mbarrier; thread 0 has had its own
//      mbarrier expect the C slots' bytes; every thread waits on it;
//   3. thread i < S sums element i of the C slots in rank order; with
//      several clusters CTA r of each publishes its S sums as 64-bit words
//      tagged with the step, and sums every cluster's words in cluster
//      order; it forms da = ω·g·inv_c, the coefficients take it (cluster 0
//      only: coef += da in the whole solve, da_out = da in the sweep);
//                                                           __syncthreads
//   4. all-gather: every CTA pushes its da slice into every CTA's da
//      array with st.async and waits for the C slices on a second mbarrier;
//   5. update: e[:, slice] -= daᵀ·x_b[:, slice], every thread on (position,
//      group of up to 4 right-hand sides) units, the increments read as
//      float4 broadcasts, their sum over the block's rows in registers and
//      taken from e once.
// No grid-wide barrier, no device round trip of da, no atomics: every sum
// runs in one fixed order (lanes, then warps' rows, then rank, then
// cluster), so every CTA holds the same bits and every launch gives the
// same result.
//
// Reuse without a barrier.  Each of the two exchanges of a step has one
// receive array and one mbarrier, whose phase t & 1 is step t's.  A CTA A
// pushes into B's receive slots of step t+1 only after A's wait of the
// other exchange of step t (or t+1), which needs B's push of that exchange,
// which B makes only after a __syncthreads that follows every read B makes
// of the slots A is about to overwrite: B's rank-order sums of step t
// precede the __syncthreads before B's da push of step t; B's update of
// step t precedes the __syncthreads that ends B's partials of step t+1,
// before B's reduce-scatter push of t+1.  The same chain keeps an mbarrier
// from receiving bytes of step t+1 before its phase t completed.  The
// device words have two parities by step: cluster q writes a parity-t word
// for step t+2 after reading every cluster's step t+1 words, which each
// publisher wrote after its reads of step t.  The per-sweep SSE of the
// whole solve is a third exchange of the same kind (bakp_cluster_sse).
// A launch's tags run from tag0 + 1 up, past every tag an earlier launch
// on the same words wrote (the wrapper keeps the words of a stream and
// counts the tags each launch may use), so no word left from an earlier
// launch passes a wait and the words need no zeroing between launches.
#pragma once

#include <stdint.h>

#include "bakp_block.cuh"
#include "cluster.cuh"
#include "cp_async.cuh"

#define BAKP_SINGLE_CLUSTER 0
#define BAKP_MULTI_CLUSTER 1
#define BAKP_MAX_CLUSTER 16
// Rows of the block a warp carries through its positions at once.
#define BAKP_CT 4
// Fixed floats of a CTA's dynamic shared memory besides the three
// exchange arrays and the owned slice: mbarriers (8), the SSE's per-warp
// sums (16: 8 doubles), its per-rank slots and result (36: 16 doubles and
// a float).
#define BAKP_HDR_FIXED 60

// Phase clocks of the block step, built only with -DBAKP_PHASE_CLOCKS
// (tools/bakp_phase_split.py): thread 0 of CTA 0 adds the clock64 ticks of
// each phase to bakp_clocks[phase] and counts the steps in bakp_clocks[8].
// Phases: ring wait, partials' FMAs, their reduce-scatter and write, the
// push and its wait, the rank-order (and cross-cluster) sum, the da
// all-gather and its wait, the update; a whole solve's per-sweep SSE is
// bakp_clocks[7].
#ifdef BAKP_PHASE_CLOCKS
__device__ unsigned long long bakp_clocks[9];
#define BAKP_ON (blockIdx.x == 0 && threadIdx.x == 0)
#define BAKP_CLOCK_START long long bakp_t0_ = clock64()
#define BAKP_CLOCK(i)                                                       \
  do {                                                                      \
    const long long t_ = clock64();                                         \
    if (BAKP_ON) atomicAdd(&bakp_clocks[i], (unsigned long long)(t_ - bakp_t0_)); \
    bakp_t0_ = t_;                                                          \
  } while (0)
#define BAKP_CLOCK_ADD(i, v)                                                \
  do { if (BAKP_ON) atomicAdd(&bakp_clocks[i], (unsigned long long)(v)); } while (0)
#define BAKP_CLOCK_STEP() BAKP_CLOCK_ADD(8, 1)
extern "C" int bakp_phase_clocks(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long z[9] = {};
    return (int)cudaMemcpyToSymbol(bakp_clocks, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, bakp_clocks, sizeof(bakp_clocks));
}
#else
#define BAKP_CLOCK_START
#define BAKP_CLOCK(i)
#define BAKP_CLOCK_ADD(i, v)
#define BAKP_CLOCK_STEP()
#endif

// k padded: the row stride of the partials and increments.
__host__ __device__ __forceinline__ int bakp_kp(int k) {
  return k <= 2 ? k : (k + 3) / 4 * 4;
}

// Floats of the slice of a block's partials a CTA owns.
__host__ __device__ __forceinline__ int bakp_own(int CB, int k, int C) {
  const int s = (CB * bakp_kp(k) + C - 1) / C;
  return (s + 3) / 4 * 4;
}

// Floats of the fixed part of a CTA's dynamic shared memory.
__host__ __device__ __forceinline__ int bakp_hdr_floats(int CB, int k, int C) {
  const int S = bakp_own(CB, k, C);
  return BAKP_HDR_FIXED + 3 * C * S + S;
}

// int32 words of the device exchange: two parities x clusters x C·S step
// words, then two parities x clusters x 2 SSE words, 64 bits each.
static inline long long bakp_xchg_words(int clusters, int CB, int k, int C) {
  if (clusters <= 1) return 0;
  const long long np = (long long)C * bakp_own(CB, k, C);
  return 2LL * 2 * clusters * (np + 2);
}

struct BakpCta {
  int o0, n, L;            // obs slice [o0, o0 + n); slice stride
  int rank, csize, cid, ncl;
  int CB, k, kp, S, Np;    // block, RHS a step exchanges, padded, owned slice, C·S
  float* part;             // Np: this CTA's partials of the step, c·kp + r
  float* rx;               // Np: reduce-scatter slots [rank][S]
  float* da;               // Np: the block's increments, c·kp + r
  float* mine;             // S: the owned slice's increments
  float* sse;              // 16: the SSE's per-warp sums (8 doubles)
  float* red;              // 36: the SSE's per-rank slots (16 doubles), result
  float* rest;             // the kernel's own part of the dynamic memory
  unsigned mbar;           // three mbarriers: reduce-scatter, all-gather, SSE
  unsigned long long* xchg;  // device exchange words, or nullptr (one cluster)
  unsigned tag0;           // the launch's tags are tag0 + 1, tag0 + 2, ...
};

// Carve the dynamic shared memory, point the CTA at its slice, zero its
// partials (the padding is never written again) and initialise its
// mbarriers before any CTA of the cluster pushes to them.
__device__ __forceinline__ BakpCta bakp_cta(float* smem, int obs, int CB, int k,
                                            void* xchg, unsigned tag0) {
  cg::cluster_group cl = cg::this_cluster();
  BakpCta c;
  const BakpSlice s = bakp_slice(obs);
  c.o0 = s.o0;
  c.n = s.o1 - s.o0;
  c.L = bakp_slice_len(obs, gridDim.x);
  c.rank = (int)cl.block_rank();
  c.csize = (int)cl.num_blocks();
  c.cid = blockIdx.x / c.csize;
  c.ncl = gridDim.x / c.csize;
  c.CB = CB;
  c.k = k;
  c.kp = bakp_kp(k);
  c.S = bakp_own(CB, k, c.csize);
  c.Np = c.csize * c.S;
  c.xchg = c.ncl > 1 ? static_cast<unsigned long long*>(xchg) : nullptr;
  c.tag0 = tag0;
  c.mbar = (unsigned)__cvta_generic_to_shared(smem);
  c.part = smem + 8;
  c.rx = c.part + c.Np;
  c.da = c.rx + c.Np;
  c.mine = c.da + c.Np;
  c.sse = c.mine + c.S;
  c.red = c.sse + 16;
  c.rest = c.red + 36;
  for (int i = threadIdx.x; i < c.Np; i += blockDim.x) c.part[i] = 0.f;
  if (threadIdx.x == 0) cl_mbar_init(c.mbar, 3);
  cl_cluster_sync();
  return c;
}

// acc[t][r] += Σ_o xs[t·x_ld + o] · e[r·e_ld + o] over positions o < np,
// t < rows (≤ 4), r < kc; lane l takes the groups of 4 positions l, l + 32,
// ... of the whole rounds of 128 positions, then the rest one position at
// a time, so no lane does a round more than the others.  xs (fp32 or bf16,
// TX) in shared memory (X16: one wide load of 4 values, 16 bytes of fp32
// or 8 of bf16) or device memory, e in shared memory (E16) or device
// memory: a row in device memory is read one value at a time, since its
// start need not be aligned.
template <int KC, bool E16, bool X16 = true, typename TX>
__device__ __forceinline__ void bakp_acc(const TX* __restrict__ xs, int x_ld, int rows,
                                         const float* __restrict__ e, int e_ld,
                                         int np, int kc, float (&acc)[BAKP_CT][KC]) {
  const int lane = threadIdx.x & 31;
  const int np4 = np / 128 * 128;
  for (int b = 4 * lane; b < np4; b += 128) {
    float4 ev[KC];
#pragma unroll
    for (int r = 0; r < KC; ++r)
      ev[r] = r < kc ? bakp_ld4<E16>(e + (size_t)r * e_ld + b) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int t = 0; t < BAKP_CT; ++t) {
      const float4 xv = t < rows ? bakp_ld4<X16>(xs + (size_t)t * x_ld + b)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        acc[t][r] = fmaf(xv.x, ev[r].x, acc[t][r]);
        acc[t][r] = fmaf(xv.y, ev[r].y, acc[t][r]);
        acc[t][r] = fmaf(xv.z, ev[r].z, acc[t][r]);
        acc[t][r] = fmaf(xv.w, ev[r].w, acc[t][r]);
      }
    }
  }
  for (int o = np4 + lane; o < np; o += 32) {
    float ev[KC];
#pragma unroll
    for (int r = 0; r < KC; ++r) ev[r] = r < kc ? e[(size_t)r * e_ld + o] : 0.f;
#pragma unroll
    for (int t = 0; t < BAKP_CT; ++t) {
      const float xv = t < rows ? bakp_f(xs[(size_t)t * x_ld + o]) : 0.f;
#pragma unroll
      for (int r = 0; r < KC; ++r) acc[t][r] = fmaf(xv, ev[r], acc[t][r]);
    }
  }
}

// One reduce-scatter stage of bakp_warp_scatter over lane bit OFF: the
// lanes keep the lower or the upper H of the live values and add their
// partner's copies of them; then the next stage, on H / 2 values.
template <int M, int H>
__device__ __forceinline__ void bakp_rs_stage(float (&v)[M], int lane) {
  if constexpr (H >= 1) {
    constexpr int OFF = 32 * H / M;
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = up ? v[j] : v[j + H];
      const float keep = up ? v[j + H] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    bakp_rs_stage<M, H / 2>(v, lane);
  }
}

// The warp's 4·KC accumulators summed over its 32 lanes: a butterfly
// reduce-scatter over the top log2(4·KC) lane bits, then plain butterfly
// sums over the rest, so lane l holds the whole sum of accumulator
// l >> (5 - log2(4·KC)); one lane of each writes it to part[(c0 + t)·kp +
// r0 + r] for t < rows, r < kc.
template <int KC>
__device__ __forceinline__ void bakp_warp_scatter(float (&acc)[BAKP_CT][KC], int c0,
                                                  int rows, int r0, int kc, int kp,
                                                  float* part) {
  constexpr int M = BAKP_CT * KC;
  const int lane = threadIdx.x & 31;
  float v[M];
#pragma unroll
  for (int m = 0; m < M; ++m) v[m] = acc[m / KC][m % KC];
  bakp_rs_stage<M, M / 2>(v, lane);
  float s = v[0];
#pragma unroll
  for (int o = 16 / M; o >= 1; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  constexpr int LOW = 32 / M;            // lanes that share one sum
  const int i = lane / LOW;
  const int t = i / KC, r = i % KC;
  if (lane % LOW == 0 && t < rows && r < kc) part[(size_t)(c0 + t) * kp + r0 + r] = s;
}

// Steps 2-4 of block b (see the top) once part holds this CTA's partials
// and a __syncthreads has passed.  The step's kc right-hand sides (kc <=
// c.k) are columns 0..kc of coef, whose rows are coef_ld floats apart.
// accumulate: coef_b += da (whole solve) or coef_b = da (one sweep's da).
// On return c.da holds the block's increments in every CTA, visible to
// every thread.
__device__ __forceinline__ void bakp_exchange(const BakpCta& c, int step, int b,
                                              const float* __restrict__ inv_cn,
                                              float* coef, int coef_ld, int kc,
                                              bool accumulate, float omega) {
  BAKP_CLOCK_START;
  const int S4 = c.S / 4;
  const unsigned rs_bar = c.mbar, ag_bar = c.mbar + 8;
  // 2. reduce-scatter
  if (threadIdx.x == 0) cl_mbar_expect(rs_bar, c.Np * 4);
  {
    const unsigned slot = (unsigned)__cvta_generic_to_shared(c.rx + (size_t)c.rank * c.S);
    for (int i = threadIdx.x; i < c.Np / 4; i += blockDim.x) {
      const int j = i / S4, u = i - j * S4;
      cl_push4(cl_mapa(slot + 16 * u, j), *reinterpret_cast<const float4*>(c.part + 4 * i),
               cl_mapa(rs_bar, j));
    }
  }
  cl_mbar_wait(rs_bar, step);
  BAKP_CLOCK(3);
  // 3. rank-order sum, cross-cluster sum, da and the coefficients
  const unsigned seq = c.tag0 + step + 1;
  for (int i = threadIdx.x; i < c.S; i += blockDim.x) {
    float v[BAKP_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < BAKP_MAX_CLUSTER; ++q) v[q] = q < c.csize ? c.rx[q * c.S + i] : 0.f;
    float g = 0.f;
#pragma unroll
    for (int q = 0; q < BAKP_MAX_CLUSTER; ++q)
      if (q < c.csize) g += v[q];
    if (c.xchg != nullptr) {
      unsigned long long* words = c.xchg + (size_t)(step & 1) * c.ncl * c.Np + c.rank * c.S + i;
      cl_publish(words + (size_t)c.cid * c.Np, seq, __float_as_uint(g));
      const float own = g;
      g = 0.f;
      for (int q0 = 0; q0 < c.ncl; q0 += 16) {
        const int nb = c.ncl - q0 < 16 ? c.ncl - q0 : 16;
        unsigned w[16];
        unsigned todo = (1u << nb) - 1;  // words of the batch not yet tagged
#pragma unroll
        for (int u = 0; u < 16; ++u)     // this cluster's own sums
          if (q0 + u == c.cid) {
            w[u] = __float_as_uint(own);
            todo &= ~(1u << u);
          }
        while (todo) {                   // one round of loads at a time
          unsigned long long x[16];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (todo >> u & 1) x[u] = cl_ld_word(words + (size_t)(q0 + u) * c.Np);
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if ((todo >> u & 1) && (unsigned)(x[u] >> 32) == seq) {
              w[u] = (unsigned)x[u];
              todo &= ~(1u << u);
            }
        }
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (u < nb) g += __uint_as_float(w[u]);
      }
    }
    const int idx = c.rank * c.S + i;
    const int col = idx / c.kp, r = idx - col * c.kp;
    const bool real = col < c.CB && r < kc;
    const float d = real ? omega * g * __ldg(inv_cn + (size_t)b * c.CB + col) : 0.f;
    c.mine[i] = d;
    if (real && c.cid == 0) {
      float* cp = coef + ((size_t)b * c.CB + col) * coef_ld + r;
      *cp = accumulate ? *cp + d : d;
    }
  }
  __syncthreads();
  BAKP_CLOCK(4);
  // 4. all-gather of da
  if (threadIdx.x == 0) cl_mbar_expect(ag_bar, c.Np * 4);
  {
    const unsigned slot = (unsigned)__cvta_generic_to_shared(c.da + (size_t)c.rank * c.S);
    for (int i = threadIdx.x; i < c.Np / 4; i += blockDim.x) {
      const int j = i / S4, u = i - j * S4;
      cl_push4(cl_mapa(slot + 16 * u, j), *reinterpret_cast<const float4*>(c.mine + 4 * u),
               cl_mapa(ag_bar, j));
    }
  }
  cl_mbar_wait(ag_bar, step);
  BAKP_CLOCK(5);
}

// 5. e[r][o] -= Σ_c da[c·kp + r] · xs[c·x_ld + o] for rows c < rows,
// positions o < np, r < k: unit u is (position u mod np, RHS group
// u / np of KG), one thread a unit in turn, the sum in registers across
// the rows and taken from e once, as the plain version's e - daᵀ·x_b:
// an FMA chain into e itself rounds e once a row and, near convergence,
// leaves a residual floor many times the plain version's, which moves
// the rtol stop.  da in shared memory, read 16 bytes at a time: one
// column's four increments at KG 4, two or four columns' at KG 2 or 1.
// Eight columns' loads are issued ahead of their FMAs.  x (TX) is widened
// to fp32 as it is read.
template <int KG, typename TX>
__device__ __forceinline__ void bakp_update(const TX* __restrict__ xs, int x_ld, int rows,
                                            float* __restrict__ e, int e_ld,
                                            const float* __restrict__ da, int kp, int k,
                                            int np) {
  constexpr int CU = 4 / KG;             // columns a 16-byte load of da covers
  const int H = (k + KG - 1) / KG;
  const int units = np * H;
  const int rows4 = rows / CU * CU;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int h = u / np, o = u - h * np;
    const int r0 = h * KG;
    float ev[KG] = {};                   // Σ_c da[c]·x[c], then e - it
    const float* dp = da + r0;
    const TX* xo = xs + o;
#pragma unroll 8
    for (int col = 0; col < rows4; col += CU) {
      const float4 d = *reinterpret_cast<const float4*>(dp + (size_t)col * kp);
      const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int cu = 0; cu < CU; ++cu) {
        const float xv = bakp_f(xo[(size_t)(col + cu) * x_ld]);
#pragma unroll
        for (int j = 0; j < KG; ++j) ev[j] = fmaf(dv[cu * KG + j], xv, ev[j]);
      }
    }
    for (int col = rows4; col < rows; ++col) {
      const float xv = bakp_f(xo[(size_t)col * x_ld]);
#pragma unroll
      for (int j = 0; j < KG; ++j) ev[j] = fmaf(dp[(size_t)col * kp + j], xv, ev[j]);
    }
#pragma unroll
    for (int j = 0; j < KG; ++j)
      if (r0 + j < k) e[(size_t)(r0 + j) * e_ld + o] -= ev[j];
  }
}

// Right-hand sides an update unit carries, from the partials' KC
// (bakp_pick_kc): min(KC, 4), so a group is min(kp, 4) wide.
#define BAKP_KG(KC) ((KC) < 4 ? (KC) : 4)

// SSE of the residual slice (k rows of stride e_ld in shared or device
// memory, c.n positions), summed over the whole grid in double: squares of
// floats are exact in double, summed in a fixed thread order into a double
// per CTA, pushed to every CTA of the cluster and summed there in rank
// order, then (several clusters) in cluster order through two tagged words
// a cluster;
// `idx` counts the SSE exchanges of the launch.  The float returned is
// the SSE of the residual rounded once, so the stopping rule reads the
// residual, not the order of a sum.  Every CTA returns the same bits, so
// all take the same stop decision.
__device__ __forceinline__ float bakp_cluster_sse(const BakpCta& c, const float* e, int e_ld,
                                                  int k, int idx) {
  double* warp_part = reinterpret_cast<double*>(c.sse);   // 8 warps
  double* slots = reinterpret_cast<double*>(c.red);       // 16 ranks
  double acc = 0.0;
  for (int r = 0; r < k; ++r)
    for (int o = threadIdx.x; o < c.n; o += blockDim.x) {
      const double v = e[(size_t)r * e_ld + o];
      acc = fma(v, v, acc);
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  const unsigned bar = c.mbar + 16;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) cl_mbar_expect(bar, c.csize * 8);
    double t = 0.0;
    for (int w = 0; w < BAKP_THREADS / 32; ++w) t += warp_part[w];
    const unsigned slot = (unsigned)__cvta_generic_to_shared(slots + c.rank);
    for (int q = threadIdx.x; q < c.csize; q += 32)
      cl_push8(cl_mapa(slot, q), t, cl_mapa(bar, q));
  }
  cl_mbar_wait(bar, idx);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double t = 0.0;
    if (lane == 0)
      for (int q = 0; q < c.csize; ++q) t += slots[q];
    if (c.xchg != nullptr) {
      const unsigned seq = c.tag0 + idx + 1;
      unsigned long long* words = c.xchg + (size_t)2 * c.ncl * c.Np +
                                  (size_t)(idx & 1) * c.ncl * 2;
      if (lane == 0 && c.rank == 0) {
        cl_publish(words + 2 * c.cid, seq, (unsigned)__double2loint(t));
        cl_publish(words + 2 * c.cid + 1, seq, (unsigned)__double2hiint(t));
      }
      // Word 2q and 2q + 1 are the low and high halves of cluster q's sum.
      // The lanes poll 32 words at once (one L2 round trip, not one a
      // word) and every lane adds them in cluster order.
      t = 0.0;
      for (int j0 = 0; j0 < 2 * c.ncl; j0 += 32) {
        const unsigned w = j0 + lane < 2 * c.ncl ? cl_poll(words + j0 + lane, seq) : 0u;
        const int nq = (2 * c.ncl - j0 < 32 ? 2 * c.ncl - j0 : 32) / 2;
        for (int q = 0; q < nq; ++q) {
          const unsigned lo = __shfl_sync(0xffffffffu, w, 2 * q);
          const unsigned hi = __shfl_sync(0xffffffffu, w, 2 * q + 1);
          t += __hiloint2double((int)hi, (int)lo);
        }
      }
    }
    if (lane == 0) c.red[32] = (float)t;
  }
  __syncthreads();
  const float out = c.red[32];
  __syncthreads();
  return out;
}

// ------------------------------------------------------------- host side
// Checks a launch's plan arguments against the kernel's own arithmetic:
// returns cudaErrorInvalidValue for a plan the wrapper cannot have made.
static inline cudaError_t bakp_plan_check(int obs, int regime, int ctas, int cluster,
                                          const void* xchg, size_t need, size_t smem) {
  if (regime < BAKP_SINGLE_CLUSTER || regime > BAKP_MULTI_CLUSTER || cluster < 1 ||
      cluster > BAKP_MAX_CLUSTER || ctas < cluster || ctas % cluster != 0 ||
      (regime == BAKP_SINGLE_CLUSTER && ctas != cluster) ||
      (regime == BAKP_MULTI_CLUSTER && (ctas == cluster || xchg == nullptr)) ||
      obs < 1 || smem < need)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}
