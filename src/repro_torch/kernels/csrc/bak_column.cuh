// SolveBak (paper Algorithm 1) column step on thread-block clusters, shared
// by the per-sweep kernel (bak_sweep.cu) and the whole-solve kernel
// (bak_fused.cu), as repro/kernels/cd_sweep.py::bak_row_update is shared by
// the two Pallas bodies it replaces.  One definition keeps the two
// execution models numerically in lockstep.
//
// Layout as bakp_block.cuh: x_t (vars, obs) row-major, its element TX fp32
// or bf16 (kept in its own type in the ring, widened to fp32 as it is
// read); residuals e (k, obs), increments and coefficients (vars, k),
// inv_cn (vars,) in fp32.
//
// Decomposition.  G CTAs launched as clusters of C (cudaLaunchKernelEx with
// a cluster dimension), CTA q owning the obs slice [o0, o0 + L) of e and of
// every row of x_t (bakp_slice).  Thread t owns the positions 4t + 4Ti + u
// (u < 4) of the slice in every loop, so it reads only shared memory it
// wrote itself, and needs no barrier for that.  Algorithm 1 needs a full
// reduction over obs before each column's update.  Per column j:
//   1. x_j's slice is already in shared memory: step j-1 issued its
//      cp.async copy into a two-stage ring, and step j issues j+1's;
//   2. the CTA sums its k partial dots <x_j, e>[slice] in a fixed thread
//      order (warp butterfly, then warps in order; one __syncthreads);
//   3. warp 0 pushes them into every CTA of the cluster: lane q writes
//      them into CTA q's receive slot for this rank through distributed
//      shared memory with st.async, which counts its bytes on CTA q's
//      mbarrier for the step's parity (complete_tx); lane 0 has told its
//      own mbarrier to expect the C slots' bytes (arrive.expect_tx);
//   4. every thread waits on its own CTA's mbarrier (try_wait.parity) for
//      those bytes, and each warp sums the C received partials in rank
//      order from local shared memory, so every CTA holds the same bits
//      with no cluster-wide barrier.  With several
//      clusters, rank 0 of each publishes its cluster's sums in device
//      memory, each value a 64-bit word tagged with the step's sequence
//      number (one single-copy-atomic store, so a reader that sees the tag
//      sees the value); warp 0 of every CTA polls until every cluster's
//      words carry this step's tag and sums them in cluster order;
//   5. each CTA updates its own slice, e[:, slice] -= (g_j inv_j) x_j[slice].
// Two parity slots (receive slots, mbarriers, device words) keep steps
// apart: a CTA writes slot s for step t+2 only after its own wait of step
// t+1, which needs every CTA's slot of step t+1, which each CTA sends only
// after all its threads passed the __syncthreads of step t+1, after their
// reads of step t.  bak_fused's SSE is a step of its own on the same path.
// `step` counts steps across sweeps, so the parity alternates across sweep
// boundaries too.  Sums run in a fixed order everywhere (within the CTA,
// then in rank order, then in cluster order; no atomics), so a launch gives
// the same bits every time.  fp32 FMAs throughout; no tensor cores.
//
// Where e lives (the template parameter EG of the kernels): with k <= 8 and
// a slice of at most 12 positions a thread, each thread keeps its
// positions of e in registers (EG = 1 or 3 float4 groups a thread), so the
// dot and the update touch shared memory only for x_j; otherwise the slice
// is in shared memory (EG = 0) or, where it does not fit, in device memory
// (EG = -1).  Where even the ring does not fit (a slice of more than about
// 28,800 positions), x_j is read from device memory as well (EG = -2).
//
// The cluster primitives (DSMEM addresses, the cluster barrier, mbarriers,
// st.async, tagged words, the clustered launch) are cluster.cuh's, shared
// with the Algorithm-2 step (bakp_cluster.cuh).
//
// Launch regimes (bak_plan, from shared-memory arithmetic):
//   single cluster  G = C, the residual slices (in registers or shared
//                   memory) and the ring fit the CTAs.  No grid-wide
//                   barrier at all, and a cluster is co-scheduled by the
//                   hardware, so the launch is not cooperative.
//   multi cluster   G = clusters·C, one CTA per SM, residual slices on
//                   chip, the cross-cluster exchange of step 4.
//                   The launch is cooperative as well as clustered: the
//                   exchange's wait needs every CTA resident.
//   e device        as multi cluster, the residual slices in device memory
//                   (L2-resident) where they do not fit shared memory.
//   x device        as e device, x_j read from device memory in the dot and
//                   the update where the ring does not fit either.
#pragma once

#include <stdint.h>

#include "bakp_block.cuh"
#include "cluster.cuh"
#include "cp_async.cuh"

#define BAK_SINGLE_CLUSTER 0
#define BAK_MULTI_CLUSTER 1
#define BAK_E_DEVICE 2
#define BAK_X_DEVICE 3
// Ints bak_plan writes: regime, CTAs, cluster size, clusters, where e lives
// (0 device memory, 1 shared memory, 2 registers), int32 words of the
// device exchange.
#define BAK_PLAN_FIELDS 6
#define BAK_MAX_CLUSTER 16
// Loads an ordered sum issues before adding any (bak_ordered_sum).
#define BAK_LOAD_BATCH 16

// Phase clocks of the column step, built only with -DBAK_PHASE_CLOCKS
// (tools/bak_phase_split.py): thread 0 of CTA 0 adds the clock64 ticks of
// each phase to bak_clocks[phase] and counts the steps in
// bak_clocks[BAK_PHASES].  Phases: ring wait and dot, CTA reduction, push
// and mbarrier wait, cross-cluster exchange, rank-order sum and update.
#define BAK_PHASES 5
#ifdef BAK_PHASE_CLOCKS
__device__ unsigned long long bak_clocks[BAK_PHASES + 1];
#define BAK_CLOCK_START long long bak_t0_ = clock64()
#define BAK_CLOCK(i)                                                        \
  do {                                                                      \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                              \
      const long long t_ = clock64();                                       \
      atomicAdd(&bak_clocks[i], (unsigned long long)(t_ - bak_t0_));        \
      bak_t0_ = t_;                                                         \
    }                                                                       \
  } while (0)
extern "C" int bak_phase_clocks(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long z[BAK_PHASES + 1] = {};
    return (int)cudaMemcpyToSymbol(bak_clocks, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, bak_clocks, sizeof(bak_clocks));
}
#else
#define BAK_CLOCK_START
#define BAK_CLOCK(i)
#endif

// Positions a thread keeps in registers at most, and the rule for EG.
#define BAK_REG_GROUPS 3
__host__ __device__ __forceinline__ int bak_e_groups(int L, int k) {
  if (k > 8) return 0;
  if (L <= 4 * BAKP_THREADS) return 1;
  return L <= 4 * BAKP_THREADS * BAK_REG_GROUPS ? BAK_REG_GROUPS : 0;
}

// k padded to a multiple of 4: the stride of a receive slot.
__host__ __device__ __forceinline__ int bak_kp(int k) { return (k + 3) / 4 * 4; }

// int32 words of the device exchange: 2 parities x clusters x kp 64-bit
// tagged words.
static inline int bak_xchg_words(int clusters, int k) {
  return 2 * clusters * bak_kp(k) * 2;
}

// Dynamic shared memory of a CTA: two mbarriers (4 floats), part (kp),
// the receive slots (2·C·kp), s_g (kp), the ring (2·L elements of xsize
// bytes, unless EG = -2) and, when EG = 0, the residual slice (k·L).
static inline size_t bak_smem_bytes(int L, int k, int cluster, int eg, int xsize) {
  return sizeof(float) * (4 + (size_t)bak_kp(k) * (2 * cluster + 2) +
                          (eg == 0 ? (size_t)k * L : 0)) +
         (eg == -2 ? 0 : 2 * (size_t)L * xsize);
}

struct BakCta {
  int o0, n;         // obs slice [o0, o0 + n)
  int L, kp;         // ring stage stride; receive slot stride
  float* ring;       // two stages of L elements of x (TX; bak_stage)
  float* eb;         // e slice: shared memory, or e + o0 in device memory
  int es;            // row stride of eb (L or obs)
  float* part;       // kp floats: this CTA's partials of the step
  float* rx;         // receive slots [parity][rank][kp], written by the cluster
  float* s_g;        // kp floats: the step's full sums
  unsigned mbar;     // shared address of the two mbarriers (by parity)
  int rank, csize;   // rank in the cluster, cluster size
  int cid, ncl;      // cluster index, clusters
  unsigned long long* xchg;  // device exchange words, or nullptr (one cluster)
};

// Carve the dynamic shared memory (a ring of x of xsize bytes an element),
// point the CTA at its slice and initialise its two mbarriers (one arrival
// a phase, the expect_tx of bak_push) before any CTA of the cluster writes
// to them.
__device__ __forceinline__ BakCta bak_cta(float* smem, float* e, int obs,
                                          int k, bool e_smem, void* xchg, int xsize) {
  cg::cluster_group cl = cg::this_cluster();
  BakCta c;
  const BakpSlice s = bakp_slice(obs);
  c.o0 = s.o0;
  c.n = s.o1 - s.o0;
  c.L = bakp_slice_len(obs, gridDim.x);
  c.kp = bak_kp(k);
  c.rank = (int)cl.block_rank();
  c.csize = (int)cl.num_blocks();
  c.cid = blockIdx.x / c.csize;
  c.ncl = gridDim.x / c.csize;
  c.xchg = static_cast<unsigned long long*>(xchg);
  c.mbar = (unsigned)__cvta_generic_to_shared(smem);
  c.part = smem + 4;
  c.rx = c.part + c.kp;
  c.s_g = c.rx + 2 * (size_t)c.csize * c.kp;
  c.ring = c.s_g + c.kp;
  if (e_smem) {
    c.eb = c.ring + 2 * (size_t)c.L * xsize / 4;   // L is a multiple of 32
    c.es = c.L;
  } else {
    c.eb = e + c.o0;
    c.es = obs;
  }
  if (threadIdx.x == 0) cl_mbar_init(c.mbar, 2);
  cl_cluster_sync();
  return c;
}

// Ring stage s of x's type.
template <typename TX>
__device__ __forceinline__ TX* bak_stage(const BakCta& c, int s) {
  return reinterpret_cast<TX*>(c.ring) + (size_t)s * c.L;
}

// Issue this thread's copies of its positions of x row `xrow` (already
// offset to the slice) into `stage`, as one commit group: its 4 positions
// in one copy where xw (cp_bytes) is 4 elements' bytes (16 of fp32, 8 of
// bf16; n % 4 == 0 then), else 4 bytes a copy, else (a bf16 row of odd
// length) 2.
template <typename TX>
__device__ __forceinline__ void bak_fetch(const BakCta& c, TX* stage, const TX* xrow, int xw) {
  constexpr int WIDE = 4 * (int)sizeof(TX);
  for (int b = 4 * threadIdx.x; b < c.n; b += 4 * blockDim.x) {
    if (xw == WIDE) {
      cp_async_b<WIDE>(stage + b, xrow + b);
      continue;
    }
    if constexpr (sizeof(TX) == 2) {
      if (xw == 2) {
        for (int u = 0; u < 4 && b + u < c.n; ++u) cp_async_b<2>(stage + b + u, xrow + b + u);
        continue;
      }
    }
    constexpr int W = 4 / (int)sizeof(TX);  // 4 bytes a copy; n is even for a bf16 x
    for (int u = 0; u < 4 && b + u < c.n; u += W) cp_async_b<4>(stage + b + u, xrow + b + u);
  }
  cp_async_commit();
}

template <bool E_SMEM>
__device__ __forceinline__ void bak_st4(float* p, float4 v) {
  if constexpr (E_SMEM) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  }
}

// Per-thread values v[0..kc) summed over the CTA in a fixed order (warp
// butterfly, then warps in index order) by threads < kc into out[0..kc).
// s_red holds (blockDim.x / 32)·KC floats.  The caller's next barrier makes
// out visible and frees s_red.
template <int KC>
__device__ __forceinline__ void bak_cta_sum(float (&v)[KC], int kc,
                                            float* s_red, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < KC; ++r) v[r] = warp_sum(v[r]);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < KC; ++r) s_red[warp * KC + r] = v[r];
  __syncthreads();
  if ((int)threadIdx.x < kc) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < BAKP_THREADS / 32; ++w) t += s_red[w * KC + threadIdx.x];
    out[threadIdx.x] = t;
  }
}

// ld(0) + ld(1) + ... + ld(n - 1), added in index order.  Each batch of
// BAK_LOAD_BATCH loads is issued before any is added, so their latencies
// (distributed shared memory, L2) overlap instead of adding up.
template <typename T, typename Ld>
__device__ __forceinline__ T bak_ordered_sum(int n, Ld ld) {
  T t = T(0);
  for (int q0 = 0; q0 < n; q0 += BAK_LOAD_BATCH) {
    T v[BAK_LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < BAK_LOAD_BATCH; ++u) v[u] = q0 + u < n ? ld(q0 + u) : T(0);
#pragma unroll
    for (int u = 0; u < BAK_LOAD_BATCH; ++u)
      if (q0 + u < n) t += v[u];
  }
  return t;
}

// Warp 0, once threads < k wrote this CTA's partials to part: lane 0 has
// this CTA's mbarrier of the step's parity expect the C slots' bytes, and
// lane q writes the kp floats of part into CTA q's receive slot for this
// rank with st.async, which completes their bytes on CTA q's mbarrier.
__device__ __forceinline__ void bak_push(const BakCta& c, int step) {
  __syncwarp();
  const unsigned bar = c.mbar + 8 * (step & 1);
  if (threadIdx.x == 0) cl_mbar_expect(bar, c.csize * c.kp * 4);
  const unsigned slot = (unsigned)__cvta_generic_to_shared(
      c.rx + ((size_t)(step & 1) * c.csize + c.rank) * c.kp);
  for (int q = threadIdx.x; q < c.csize; q += 32) {
    const unsigned dst = cl_mapa(slot, q), rbar = cl_mapa(bar, q);
    for (int r = 0; r < c.kp; r += 4)
      cl_push4(dst + 4 * r, *reinterpret_cast<const float4*>(c.part + r), rbar);
  }
}

// Wait for the C slots of `step` on this CTA's mbarrier.  Barrier
// step & 1 serves every other step, so its (step >> 1)-th phase is this
// step's.  The slots' bytes complete on this CTA's own mbarrier, so the
// default CTA-scope acquire makes them visible (a cluster-scope one would
// also invalidate the L1 every column).
__device__ __forceinline__ void bak_wait_step(const BakCta& c, int step) {
  cl_mbar_wait(c.mbar + 8 * (step & 1), step >> 1);
}

// Sum over the cluster, in rank order, of the received value r of `step`.
__device__ __forceinline__ float bak_cluster_sum(const BakCta& c, int step, int r) {
  const float* src = c.rx + (step & 1) * c.csize * c.kp + r;
  return bak_ordered_sum<float>(c.csize, [&](int q) { return src[q * c.kp]; });
}

// Exchange word r of cluster q for the step's parity.
__device__ __forceinline__ unsigned long long* bak_word(const BakCta& c, int step,
                                                       int q, int r) {
  return c.xchg + ((size_t)(step & 1) * c.ncl + q) * c.kp + r;
}

// Warp 0, several clusters, after the wait of `step`: rank 0 publishes its
// cluster's k sums; then every CTA sums the clusters' sums in cluster
// order into s_g.  Each round loads every word of a batch not yet tagged
// before testing any, so the loads' latencies overlap.
__device__ __forceinline__ void bak_exchange(const BakCta& c, int k, int step) {
  const int seq = step + 1;
  const int lane = threadIdx.x;
  if (c.rank == 0)
    for (int r = lane; r < k; r += 32)
      cl_publish(bak_word(c, step, c.cid, r), seq,
                 __float_as_uint(bak_cluster_sum(c, step, r)));
  for (int r = lane; r < k; r += 32) {
    float g = 0.f;
    for (int q0 = 0; q0 < c.ncl; q0 += BAK_LOAD_BATCH) {
      const int nb = c.ncl - q0 < BAK_LOAD_BATCH ? c.ncl - q0 : BAK_LOAD_BATCH;
      unsigned v[BAK_LOAD_BATCH];
      unsigned todo = (1u << nb) - 1;  // words of the batch not yet tagged
      while (todo) {                   // one round of loads at a time
        unsigned long long w[BAK_LOAD_BATCH];
#pragma unroll
        for (int u = 0; u < BAK_LOAD_BATCH; ++u)
          if (todo >> u & 1) w[u] = cl_ld_word(bak_word(c, step, q0 + u, r));
#pragma unroll
        for (int u = 0; u < BAK_LOAD_BATCH; ++u)
          if ((todo >> u & 1) && (unsigned)(w[u] >> 32) == (unsigned)seq) {
            v[u] = (unsigned)w[u];
            todo &= ~(1u << u);
          }
      }
#pragma unroll
      for (int u = 0; u < BAK_LOAD_BATCH; ++u)
        if (u < nb) g += __uint_as_float(v[u]);
    }
    c.s_g[r] = g;
  }
}

// This thread's partial dots <x_j, e[r0 + r]> over its positions; xs is
// the ring stage (X_SMEM) or x_j's slice in device memory.
template <int KC, bool E_SMEM, bool X_SMEM, typename TX>
__device__ __forceinline__ void bak_dot(const BakCta& c, const TX* xs,
                                        int r0, int kc, float (&acc)[KC]) {
  for (int b = 4 * threadIdx.x; b < c.n; b += 4 * blockDim.x) {
    if (b + 4 <= c.n) {
      const float4 xv = bakp_ld4<X_SMEM>(xs + b);
#pragma unroll
      for (int r = 0; r < KC; ++r)
        if (r < kc) {
          const float4 ev = bakp_ld4<E_SMEM>(c.eb + (size_t)(r0 + r) * c.es + b);
          acc[r] = fmaf(xv.x, ev.x, acc[r]);
          acc[r] = fmaf(xv.y, ev.y, acc[r]);
          acc[r] = fmaf(xv.z, ev.z, acc[r]);
          acc[r] = fmaf(xv.w, ev.w, acc[r]);
        }
    } else {
      for (int i = b; i < c.n; ++i) {
        const float xv = bakp_f(xs[i]);
#pragma unroll
        for (int r = 0; r < KC; ++r)
          if (r < kc) acc[r] = fmaf(xv, c.eb[(size_t)(r0 + r) * c.es + i], acc[r]);
      }
    }
  }
}

// This thread's positions of e[r0 + r] -= da[r] x_j; every load of a group
// is issued before its stores.
template <int KC, bool E_SMEM, bool X_SMEM, typename TX>
__device__ __forceinline__ void bak_update(const BakCta& c, const TX* xs,
                                           int r0, int kc,
                                           const float (&da)[KC]) {
  for (int b = 4 * threadIdx.x; b < c.n; b += 4 * blockDim.x) {
    if (b + 4 <= c.n) {
      const float4 xv = bakp_ld4<X_SMEM>(xs + b);
      float4 ev[KC];
#pragma unroll
      for (int r = 0; r < KC; ++r)
        if (r < kc) ev[r] = bakp_ld4<E_SMEM>(c.eb + (size_t)(r0 + r) * c.es + b);
#pragma unroll
      for (int r = 0; r < KC; ++r)
        if (r < kc) {
          ev[r].x = fmaf(-da[r], xv.x, ev[r].x);
          ev[r].y = fmaf(-da[r], xv.y, ev[r].y);
          ev[r].z = fmaf(-da[r], xv.z, ev[r].z);
          ev[r].w = fmaf(-da[r], xv.w, ev[r].w);
          bak_st4<E_SMEM>(c.eb + (size_t)(r0 + r) * c.es + b, ev[r]);
        }
    } else {
      for (int i = b; i < c.n; ++i) {
        const float xv = bakp_f(xs[i]);
#pragma unroll
        for (int r = 0; r < KC; ++r)
          if (r < kc) {
            float* ep = c.eb + (size_t)(r0 + r) * c.es + i;
            *ep = fmaf(-da[r], xv, *ep);
          }
      }
    }
  }
}

// x_j at positions b..b+3 of the ring stage as fp32, zero past the
// slice's end.
template <typename TX>
__device__ __forceinline__ float4 bak_x4(const TX* xs, int b, int n) {
  if (b + 4 <= n) return bakp_ld4<true>(xs + b);
  return make_float4(bakp_f(xs[b]), b + 1 < n ? bakp_f(xs[b + 1]) : 0.f,
                     b + 2 < n ? bakp_f(xs[b + 2]) : 0.f, 0.f);
}

// The register forms (EG > 0): group g of this thread starts at position
// 4·(threadIdx.x + g·BAKP_THREADS); positions past the slice's end hold 0
// in er and take x = 0, so they neither add to a sum nor change.  The
// arithmetic and its order are bak_dot's and bak_update's.
template <int KC, int EG, typename TX>
__device__ __forceinline__ void bak_dot_reg(const BakCta& c, const TX* xs, int kc,
                                            const float4 (&er)[EG][KC],
                                            float (&acc)[KC]) {
#pragma unroll
  for (int g = 0; g < EG; ++g) {
    const int b = 4 * (threadIdx.x + g * BAKP_THREADS);
    if (b < c.n) {
      const float4 xv = bak_x4(xs, b, c.n);
#pragma unroll
      for (int r = 0; r < KC; ++r)
        if (r < kc) {
          acc[r] = fmaf(xv.x, er[g][r].x, acc[r]);
          acc[r] = fmaf(xv.y, er[g][r].y, acc[r]);
          acc[r] = fmaf(xv.z, er[g][r].z, acc[r]);
          acc[r] = fmaf(xv.w, er[g][r].w, acc[r]);
        }
    }
  }
}

template <int KC, int EG, typename TX>
__device__ __forceinline__ void bak_update_reg(const BakCta& c, const TX* xs, int kc,
                                               const float (&da)[KC],
                                               float4 (&er)[EG][KC]) {
#pragma unroll
  for (int g = 0; g < EG; ++g) {
    const int b = 4 * (threadIdx.x + g * BAKP_THREADS);
    if (b < c.n) {
      const float4 xv = bak_x4(xs, b, c.n);
#pragma unroll
      for (int r = 0; r < KC; ++r)
        if (r < kc) {
          er[g][r].x = fmaf(-da[r], xv.x, er[g][r].x);
          er[g][r].y = fmaf(-da[r], xv.y, er[g][r].y);
          er[g][r].z = fmaf(-da[r], xv.z, er[g][r].z);
          er[g][r].w = fmaf(-da[r], xv.w, er[g][r].w);
        }
    }
  }
}

// Load this thread's positions of a device residual (k, obs) into er, and
// store them back.
template <int KC, int EG>
__device__ __forceinline__ void bak_load_regs(const BakCta& c, const float* src,
                                              int obs, int k, float4 (&er)[EG][KC]) {
#pragma unroll
  for (int g = 0; g < EG; ++g) {
    const int b = 4 * (threadIdx.x + g * BAKP_THREADS);
#pragma unroll
    for (int r = 0; r < KC; ++r) {
      const float* p = src + (size_t)r * obs + c.o0 + b;
      const bool row = r < k;
      er[g][r] = make_float4(row && b < c.n ? p[0] : 0.f, row && b + 1 < c.n ? p[1] : 0.f,
                             row && b + 2 < c.n ? p[2] : 0.f,
                             row && b + 3 < c.n ? p[3] : 0.f);
    }
  }
}

template <int KC, int EG>
__device__ __forceinline__ void bak_store_regs(const BakCta& c, float* dst, int obs,
                                               int k, const float4 (&er)[EG][KC]) {
#pragma unroll
  for (int g = 0; g < EG; ++g) {
    const int b = 4 * (threadIdx.x + g * BAKP_THREADS);
#pragma unroll
    for (int r = 0; r < KC; ++r) {
      if (r >= k) continue;
      float* p = dst + (size_t)r * obs + c.o0 + b;
      if (b < c.n) p[0] = er[g][r].x;
      if (b + 1 < c.n) p[1] = er[g][r].y;
      if (b + 2 < c.n) p[2] = er[g][r].z;
      if (b + 3 < c.n) p[3] = er[g][r].w;
    }
  }
}

// This thread's e: EG register groups, or a placeholder where e lives in
// shared or device memory (EG <= 0).
template <int KC, int EG>
using BakRegs = float4[EG > 0 ? EG : 1][KC];

// One Algorithm-1 column (see top).  x_j sits in ring stage col & 1, or
// at xj (its slice in device memory) when EG = -2; jn is the next column
// to prefetch (-1: none), copied xw bytes at a time (bak_fetch).  On return thread t holds in
// c.s_g[r] the full sum g_j[r] for every r = t mod blockDim.x it owns (it
// wrote or, with several clusters, was barrier-synchronised with them), so
// a CTA's own loop over r = threadIdx.x, + blockDim.x... reads them with no
// further barrier; da_j = g_j * inv_j.
template <int KC, int EG, typename TX>
__device__ __forceinline__ void bak_column_step(const BakCta& c, BakRegs<KC, EG>& er,
                                                const TX* __restrict__ x_t, int obs,
                                                const TX* xj, int jn, int col,
                                                int step, float inv_j, int k,
                                                int xw, float* s_red) {
  BAK_CLOCK_START;
  constexpr bool RING = EG != -2;
  const TX* xs = RING ? bak_stage<TX>(c, col & 1) : xj;
  if constexpr (RING) {
    if (jn >= 0)
      bak_fetch(c, bak_stage<TX>(c, (col + 1) & 1), x_t + (size_t)jn * obs + c.o0, xw);
    else
      cp_async_commit();
    cp_async_wait<1>();               // this thread's copies of x_j landed
  }
  for (int r0 = 0; r0 < k; r0 += KC) {
    const int kc = k - r0 < KC ? k - r0 : KC;
    float acc[KC];
#pragma unroll
    for (int r = 0; r < KC; ++r) acc[r] = 0.f;
    if constexpr (EG > 0) bak_dot_reg<KC, EG>(c, xs, kc, er, acc);
    else bak_dot<KC, EG == 0, RING>(c, xs, r0, kc, acc);
    BAK_CLOCK(0);
    if (r0 > 0) __syncthreads();      // the last chunk's s_red reads
    bak_cta_sum<KC>(acc, kc, s_red, c.part + r0);
    BAK_CLOCK(1);
  }
  if (threadIdx.x < 32) bak_push(c, step);
  bak_wait_step(c, step);
  BAK_CLOCK(2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool one = c.xchg == nullptr;
  if (!one) {
    if (threadIdx.x < 32) bak_exchange(c, k, step);
    __syncthreads();
  }
  BAK_CLOCK(3);
  float gl = 0.f;                     // one cluster: g[r32 + lane]
  for (int r0 = 0; r0 < k; r0 += KC) {
    const int kc = k - r0 < KC ? k - r0 : KC;
    if (one && (r0 & 31) == 0) {      // a new block of 32 sums, per warp
      const int r = r0 + lane;
      gl = r < k ? bak_cluster_sum(c, step, r) : 0.f;
      if (r < k && ((r0 >> 5) & (BAKP_THREADS / 32 - 1)) == warp) c.s_g[r] = gl;
    }
    float da[KC];
#pragma unroll
    for (int r = 0; r < KC; ++r) {
      const float g = one ? __shfl_sync(0xffffffffu, gl, (r0 & 31) + r) : c.s_g[r0 + r];
      da[r] = r < kc ? g * inv_j : 0.f;
    }
    if constexpr (EG > 0) bak_update_reg<KC, EG>(c, xs, kc, da, er);
    else bak_update<KC, EG == 0, RING>(c, xs, r0, kc, da);
  }
  BAK_CLOCK(4);
#ifdef BAK_PHASE_CLOCKS
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&bak_clocks[BAK_PHASES], 1ull);
#endif
}

// SSE of the residual slices, as a step of its own: a float per CTA in a
// fixed thread order, then in double in rank order and in cluster order
// (two tagged words carry a cluster's double), so every CTA holds the same
// bits and takes the same stop decision.
template <int KC, int EG>
__device__ __forceinline__ float bak_sse(const BakCta& c, const BakRegs<KC, EG>& er,
                                         int k, int step, float* s_red) {
  float acc[1] = {0.f};
  if constexpr (EG > 0) {             // k <= KC here
#pragma unroll
    for (int r = 0; r < KC; ++r)
      if (r < k)
#pragma unroll
        for (int g = 0; g < EG; ++g) {
          const float4 v = er[g][r];
          acc[0] = fmaf(v.x, v.x, acc[0]);
          acc[0] = fmaf(v.y, v.y, acc[0]);
          acc[0] = fmaf(v.z, v.z, acc[0]);
          acc[0] = fmaf(v.w, v.w, acc[0]);
        }
  }
  for (int r = 0; r < (EG > 0 ? 0 : k); ++r) {
    const float* e_r = c.eb + (size_t)r * c.es;
    for (int b = 4 * threadIdx.x; b < c.n; b += 4 * blockDim.x) {
      if (b + 4 <= c.n) {
        const float4 v = bakp_ld4<EG == 0>(e_r + b);
        acc[0] = fmaf(v.x, v.x, acc[0]);
        acc[0] = fmaf(v.y, v.y, acc[0]);
        acc[0] = fmaf(v.z, v.z, acc[0]);
        acc[0] = fmaf(v.w, v.w, acc[0]);
      } else {
        for (int i = b; i < c.n; ++i) acc[0] = fmaf(e_r[i], e_r[i], acc[0]);
      }
    }
  }
  bak_cta_sum<1>(acc, 1, s_red, c.part);
  if (threadIdx.x < 32) bak_push(c, step);
  bak_wait_step(c, step);
  if (threadIdx.x == 0) {
    const float* src = c.rx + (size_t)(step & 1) * c.csize * c.kp;
    double t = bak_ordered_sum<double>(
        c.csize, [&](int q) { return (double)src[(size_t)q * c.kp]; });
    if (c.xchg != nullptr) {
      const int seq = step + 1;
      if (c.rank == 0) {
        cl_publish(bak_word(c, step, c.cid, 0), seq, (unsigned)__double2loint(t));
        cl_publish(bak_word(c, step, c.cid, 1), seq, (unsigned)__double2hiint(t));
      }
      t = 0.0;
      for (int q = 0; q < c.ncl; ++q) {
        const unsigned lo = cl_poll(bak_word(c, step, q, 0), seq);
        const unsigned hi = cl_poll(bak_word(c, step, q, 1), seq);
        t += __hiloint2double((int)hi, (int)lo);
      }
    }
    c.s_g[0] = (float)t;
  }
  __syncthreads();
  return c.s_g[0];
}

// Copy the CTA's slice of a device residual into its own slice (shared
// memory, or the output residual in device memory), and back out.
__device__ __forceinline__ void bak_load_slice(const BakCta& c, const float* src,
                                               int obs, int k) {
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < c.n; i += blockDim.x)
      c.eb[(size_t)r * c.es + i] = src[(size_t)r * obs + c.o0 + i];
  __syncthreads();
}

template <bool E_SMEM>
__device__ __forceinline__ void bak_store_slice(const BakCta& c, float* dst,
                                                int obs, int k) {
  if constexpr (!E_SMEM) return;      // e already lives in dst
  __syncthreads();
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < c.n; i += blockDim.x)
      dst[(size_t)r * obs + c.o0 + i] = c.eb[(size_t)r * c.es + i];
}

// ------------------------------------------------------------- host side
// Where e lives in a regime for a slice of L positions (EG, see the top),
// and its code in the plan: 0 device memory, 1 shared memory, 2 registers.
static inline int bak_eg(int L, int k, int regime) {
  return regime == BAK_X_DEVICE ? -2 : regime == BAK_E_DEVICE ? -1 : bak_e_groups(L, k);
}
static inline int bak_e_code(int eg) { return eg < 0 ? 0 : eg == 0 ? 1 : 2; }

// A kernel's five instantiations of one KC, by EG.
template <typename F>
struct BakKernels {
  F xdev, dev, smem, reg1, reg3;
  F pick(int eg) const {
    return eg == -2 ? xdev : eg < 0 ? dev : eg == 0 ? smem : eg == 1 ? reg1 : reg3;
  }
};

// Launch plan (see the regimes at the top).  Single cluster when C CTAs
// (halved while a CTA would own fewer than min_obs positions) hold the
// residual slices (in registers or shared memory) and the ring; else
// clusters·C CTAs, at most one per SM, at most as many clusters as the
// card holds at once and at least min_obs positions a CTA: e on chip when
// its slices fit, else in device memory with the ring, else without it.
// Fails when the card cannot place a cluster of C.
// x's elements are xsize bytes (the ring's share of a CTA's memory).
template <typename F>
static cudaError_t bak_plan(const BakKernels<F>& fns, int obs, int k, int min_obs,
                            int cluster, int xsize, int* out) {
  if (cluster < 1 || cluster > BAK_MAX_CLUSTER || obs < 1 || k < 1)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0, fit = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, fns.smem)) != cudaSuccess) return err;
  const size_t dyn_max = (size_t)optin - fa.sharedSizeBytes;   // less s_red

  int c1 = cluster;
  while (c1 > 1 && (long long)c1 * min_obs > obs) c1 >>= 1;
  int L = bakp_slice_len(obs, c1), eg = bak_eg(L, k, BAK_SINGLE_CLUSTER);
  size_t need = bak_smem_bytes(L, k, c1, eg, xsize), smem = 0;
  if (need <= dyn_max) {
    if ((err = cl_launch_smem(need, &smem)) != cudaSuccess) return err;
    if ((err = cl_max_clusters(fns.pick(eg), c1, smem, &fit)) != cudaSuccess) return err;
    if (fit >= 1) {
      const int plan[BAK_PLAN_FIELDS] = {BAK_SINGLE_CLUSTER, c1, c1, 1, bak_e_code(eg), 0};
      for (int i = 0; i < BAK_PLAN_FIELDS; ++i) out[i] = plan[i];
      return cudaSuccess;
    }
  }
  const long long want = ((long long)obs + min_obs - 1) / min_obs;
  const int G = want < sms ? (int)want : sms;
  for (int regime = BAK_MULTI_CLUSTER; regime <= BAK_X_DEVICE; ++regime) {
    int n = G / cluster > 1 ? G / cluster : 1;
    L = bakp_slice_len(obs, n * cluster);
    eg = bak_eg(L, k, regime);
    need = bak_smem_bytes(L, k, cluster, eg, xsize);
    if (need > dyn_max) continue;
    // One CTA per SM at any launch size, so the clusters the card holds at
    // once do not depend on the slice length.
    if ((err = cl_launch_smem(need, &smem)) != cudaSuccess) return err;
    if ((err = cl_max_clusters(fns.pick(eg), cluster, smem, &fit)) != cudaSuccess)
      return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    if (n > fit) {
      n = fit;
      L = bakp_slice_len(obs, n * cluster);
      eg = bak_eg(L, k, regime);
      need = bak_smem_bytes(L, k, cluster, eg, xsize);
      if (need > dyn_max) continue;
    }
    const int plan[BAK_PLAN_FIELDS] = {regime, n * cluster, cluster, n,
                                       bak_e_code(eg), bak_xchg_words(n, k)};
    for (int i = 0; i < BAK_PLAN_FIELDS; ++i) out[i] = plan[i];
    return cudaSuccess;
  }
  return cudaErrorInvalidConfiguration;
}

// Checks a launch's plan arguments and derives where e lives and the
// shared memory a CTA asks for; returns cudaErrorInvalidValue for a plan
// bak_plan cannot have made.
static inline cudaError_t bak_launch_check(int obs, int k, int regime, int ctas,
                                           int cluster, const void* xchg, int xsize,
                                           int* eg, size_t* smem) {
  if (regime < BAK_SINGLE_CLUSTER || regime > BAK_X_DEVICE || cluster < 1 ||
      cluster > BAK_MAX_CLUSTER || ctas < cluster || ctas % cluster != 0 ||
      (regime == BAK_SINGLE_CLUSTER && ctas != cluster) ||
      (regime != BAK_SINGLE_CLUSTER && xchg == nullptr))
    return cudaErrorInvalidValue;
  const int L = bakp_slice_len(obs, ctas);
  *eg = bak_eg(L, k, regime);
  return cl_launch_smem(bak_smem_bytes(L, k, cluster, *eg, xsize), smem);
}
