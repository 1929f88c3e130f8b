// One SolveBakP sweep (paper Algorithm 2) over every column block, in order.
//
// Replaces the TPU kernel repro/kernels/cd_sweep.py::_bakp_sweep_kernel
// (pallas_call in _sweep_call, entry bakp_sweep).
//
// What bounds it on an H100: device-memory bytes.  It does 4·vars·obs·k
// FLOP against vars·obs·4 bytes of fp32 x (half that in bf16), under one
// FLOP per byte at k = 1 and two at k = 8, far below the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s, about 20).  This is the path for designs over the whole-solve
// budget, so x does not stay on chip between sweeps; within a sweep each
// block is read twice (once for the inner products, once for the residual
// update), because a whole (block, obs) tile cannot stay on chip across the
// reduction between them: at best two reads of x a sweep.  The block step
// is bakp_cluster.cuh's, on thread-block clusters with no grid-wide
// barrier.
//
// x (fp32 or bf16, TX; a bf16 x is widened to fp32 in the block step)
// reaches the step through a shared-memory ring of NS chunks (3 to
// SWEEP_MAX_STAGES, as many as fit beside the rest), each SWEEP_ROWS rows
// of the block × P positions of the CTA's slice (P = min(L, SWEEP_POS)),
// copied with 16-byte cp.async (4-byte where rows are not 16-byte
// aligned, 2-byte plain copies for a bf16 row of odd length: cp_bytes),
// one commit group a chunk, NS - 1 chunks ahead of the one in use: 64-224
// KB of fp32 a CTA in flight, across the exchanges too, since the
// update's chunks do not depend on da.  A block's chunks, in
// order: the partials pass (for each KC chunk of the right-hand sides, each
// row group, each position chunk; warp w carries rows 4w..4w+3 of the
// group, its accumulators kept across the group's position chunks), then
// the update pass (each position chunk, each row group).  A chunk's stage
// is refilled only after the __syncthreads at the top of the next chunk,
// which every reader of the stage has passed.
//
// Where the residual slice lives.  In shared memory for the whole sweep
// when it fits beside the ring (read once from e_in, written once to
// e_out), each row group's update applied to it in place.  Else (E_SMEM
// false) in e_out in device memory, and then the ring carries it too: a
// partials chunk's stage holds, beside its x, the chunk's KC rows of e
// (sweep_ke), copied in the same commit group, so the partials read e
// from shared memory, once from the L2 or HBM a chunk and not once a
// warp; and the update carries the increments' sum over the block's rows
// across the row groups in a shared tile of k × P (each thread keeps its
// own units), so e is read and written in device memory once a block, not
// once a row group.  A partials chunk whose e the ring would copy before
// the update of the block before has written it (few position chunks, a
// deep ring) copies it at its turn instead (sweep_e_late).

// C interface (loaded with ctypes; every pointer and the stream are
// void*-sized; each entry returns a cudaError_t, 0 on success):
//   bakp_sweep_clusters(k, cluster, smem, &n)  clusters the card holds
//   bakp_sweep_launch(x_t, x_bytes, ...)        one sweep on `stream`; x_t fp32
//                                               (x_bytes 4) or bf16 (2)
#include <stdint.h>

#include "bakp_cluster.cuh"

#define SWEEP_ROWS 32
#define SWEEP_POS 256
#define SWEEP_MIN_STAGES 3
#define SWEEP_MAX_STAGES 8

struct SweepParams {
  const void* x_t;      // (vars, obs) of TX
  const float* inv_cn;  // (vars,)
  const float* e_in;    // (k, obs)
  float* e_out;         // (k, obs)
  float* da;            // (vars, k)
  void* xchg;           // device exchange words (several clusters)
  unsigned tag0;        // the launch's exchange tags count from here
  int nvars, obs, k, block;
  float omega;
  int xw;               // bytes of one copy of x (cp_bytes: 16, 4 or 2)
  int ew;               // bytes of one copy of e (16 or 4; device-e path)
  int stages;           // ring depth NS
};

// Rows of e a ring stage carries: none when the slice is in shared memory,
// else min(k, KC).
static inline int sweep_ke(int k, bool e_smem) {
  const int kc = bakp_pick_kc(k);
  return e_smem ? 0 : k < kc ? k : kc;
}

// Floats of a CTA's dynamic shared memory: the exchange arrays, the ring
// of `stages` chunks of x (xsize bytes an element; P is a multiple of 32)
// and, when e_smem, the residual slice; else each chunk's rows of e beside
// its x and the update's k × P tile.
static inline size_t sweep_smem_floats(int obs, int ctas, int cluster, int k, int CB,
                                       bool e_smem, int stages, int xsize) {
  const int L = bakp_slice_len(obs, ctas);
  const int P = L < SWEEP_POS ? L : SWEEP_POS;
  return (size_t)bakp_hdr_floats(CB, k, cluster) +
         (size_t)stages * (SWEEP_ROWS * P * xsize / 4 + sweep_ke(k, e_smem) * P) +
         (size_t)k * (e_smem ? L : P);
}

// PB consecutive values at p as fp32: one load of PB elements of x (TX),
// or of PB floats (p aligned to them).
template <int PB, typename TX>
__device__ __forceinline__ void sweep_ldx(const TX* p, float (&v)[PB]) {
  if constexpr (PB == 4) {
    const float4 w = bakp_ld4<true>(p);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else if constexpr (PB == 2 && sizeof(TX) == 4) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x, v[1] = w.y;
  } else if constexpr (PB == 2) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
    v[0] = __uint_as_float(w << 16), v[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    v[0] = bakp_f(p[0]);
  }
}

template <int PB>
__device__ __forceinline__ void sweep_stf(float* p, const float (&v)[PB]) {
  if constexpr (PB == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (PB == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else p[0] = v[0];
}

// The update of one position chunk by one row group of the block:
// e[r][o] -= Σ_c da[c·kp + r]·xs[c·x_ld + o], as bakp_update, but a unit
// is PB consecutive positions × KG right-hand sides, so each load of da
// and of x feeds PB·KG FMAs (PB 4, 2 or 1 as there are at least 4, 2 or
// 1 groups of KG, so that the units still fill the CTA).  first / last:
// the sums start from zero, else from the tile s (k rows of stride P in
// shared memory), where the earlier groups left them; the last group
// takes them from e once (in shared or device memory), its loads of e
// issued before the rows' FMAs (PB-wide where e16: e's rows 16-byte
// aligned), and the others leave them in s.  With the slice in shared
// memory every group is first and last, and s is unused.  Each sum is one
// FMA chain over its rows in order, as bakp_update's over a group's.  A
// thread's units are the same in every group of a chunk (np and k fixed),
// so each thread reads back only what it wrote.  Positions past np read
// stale x from the stage (P is a multiple of 32) and are never written to
// e.
template <int KG, int PB, typename TX>
__device__ __forceinline__ void sweep_update_dev(const TX* __restrict__ xs, int x_ld,
                                                 int rows, float* __restrict__ s, int P,
                                                 float* __restrict__ e, int e_ld, bool e16,
                                                 const float* __restrict__ da, int kp,
                                                 int k, int np, bool first, bool last) {
  constexpr int CU = 4 / KG;             // columns a 16-byte load of da covers
  const int H = (k + KG - 1) / KG;
  const int nq = (np + PB - 1) / PB;     // groups of PB positions
  const int units = nq * H;
  const int rows4 = rows / CU * CU;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int h = u / nq, o = PB * (u - h * nq);
    const int r0 = h * KG;
    const bool whole = e16 && np - o >= PB;
    float ev[KG][PB], eo[KG][PB];
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      const bool real = r0 + j < k;
      float* er = e + (size_t)(r0 + j) * e_ld + o;
      if (real && !first) sweep_ldx<PB>(s + (size_t)(r0 + j) * P + o, ev[j]);
      else
#pragma unroll
        for (int i = 0; i < PB; ++i) ev[j][i] = 0.f;
      if (real && last && whole) sweep_ldx<PB>(static_cast<const float*>(er), eo[j]);
      else
#pragma unroll
        for (int i = 0; i < PB; ++i) eo[j][i] = real && last && o + i < np ? er[i] : 0.f;
    }
    const float* dp = da + r0;
    const TX* xo = xs + o;
    // Eight loads of da (8·CU rows of x) issued ahead of their FMAs at PB
    // 1, where a unit has only KG FMAs a load of x; four where it has more.
#pragma unroll(PB == 1 ? 8 : 4)
    for (int col = 0; col < rows4; col += CU) {
      const float4 d = *reinterpret_cast<const float4*>(dp + (size_t)col * kp);
      const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int cu = 0; cu < CU; ++cu) {
        float xv[PB];
        sweep_ldx<PB>(xo + (size_t)(col + cu) * x_ld, xv);
#pragma unroll
        for (int j = 0; j < KG; ++j)
#pragma unroll
          for (int i = 0; i < PB; ++i) ev[j][i] = fmaf(dv[cu * KG + j], xv[i], ev[j][i]);
      }
    }
    for (int col = rows4; col < rows; ++col) {
      float xv[PB];
      sweep_ldx<PB>(xo + (size_t)col * x_ld, xv);
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const float dj = dp[(size_t)col * kp + j];
#pragma unroll
        for (int i = 0; i < PB; ++i) ev[j][i] = fmaf(dj, xv[i], ev[j][i]);
      }
    }
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      if (r0 + j >= k) continue;
      if (!last) {
        sweep_stf<PB>(s + (size_t)(r0 + j) * P + o, ev[j]);
        continue;
      }
#pragma unroll
      for (int i = 0; i < PB; ++i) eo[j][i] -= ev[j][i];
      float* er = e + (size_t)(r0 + j) * e_ld + o;
      if (whole) sweep_stf<PB>(er, eo[j]);
      else
#pragma unroll
        for (int i = 0; i < PB; ++i)
          if (o + i < np) er[i] = eo[j][i];
    }
  }
}

template <int KC, bool E_SMEM, typename TX>
__global__ void BAKP_BOUNDS(TX) bakp_sweep_kernel(SweepParams p) {
  extern __shared__ __align__(16) float smem[];
  const int CB = p.block, k = p.k, obs = p.obs;
  const BakpCta c = bakp_cta(smem, obs, CB, k, p.xchg, p.tag0);
  const int L = c.L, n = c.n;
  const int P = L < SWEEP_POS ? L : SWEEP_POS;
  const int NS = p.stages;
  const TX* x_t = static_cast<const TX*>(p.x_t);
  TX* ring = reinterpret_cast<TX*>(c.rest);
  // A stage is SWEEP_ROWS × P of x, then (device-e path) KE × P of e (as
  // TX elements: SX in all).
  const int KE = E_SMEM ? 0 : (k < KC ? k : KC);
  const size_t SX = (size_t)SWEEP_ROWS * P + (size_t)KE * P * (sizeof(float) / sizeof(TX));
  auto stage_e = [&](long long q) {
    return reinterpret_cast<float*>(ring + (size_t)(q % NS) * SX + (size_t)SWEEP_ROWS * P);
  };
  float* eb;                           // the residual slice, row stride es
  int es;
  float* et = nullptr;                 // device-e path: the update's k × P tile
  if constexpr (E_SMEM) {
    eb = reinterpret_cast<float*>(ring + (size_t)NS * SX);
    es = L;
  } else {
    eb = p.e_out + c.o0;
    es = obs;
    et = reinterpret_cast<float*>(ring + (size_t)NS * SX);
  }
  for (int r = 0; r < k; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      eb[(size_t)r * es + i] = p.e_in[(size_t)r * obs + c.o0 + i];

  const int nblocks = p.nvars / CB;
  const int NG = (CB + SWEEP_ROWS - 1) / SWEEP_ROWS;
  const int NPC = (n + P - 1) / P;     // 0 for a CTA past the end
  const int nrc = (k + KC - 1) / KC;
  const int per = NG * NPC;            // chunks of one pass over the block
  const int Q = (nrc + 1) * per;       // chunks of a block
  const long long total = (long long)nblocks * Q;

  // Chunk q is block b, KC chunk rc of the partials (-1 in the update
  // pass, position chunk outermost), row group g, position chunk pc.
  struct Chunk {
    int b, rc, g, pc;
  };
  auto chunk = [&](long long q) -> Chunk {
    Chunk h;
    h.b = (int)(q / Q);
    int w = (int)(q - (long long)h.b * Q);
    if (w < nrc * per) {
      h.rc = w / per;
      w -= h.rc * per;
      h.g = w / NPC;
      h.pc = w - h.g * NPC;
    } else {
      h.rc = -1;
      w -= nrc * per;
      h.pc = w / NG;
      h.g = w - h.pc * NG;
    }
    return h;
  };
  // Device-e path: whether partials chunk h (q) would be copied (at take
  // q - NS + 1, or before the first take) before the update of block b - 1
  // has written its positions (in chunk W, the last row group of position
  // chunk pc); block 0 reads e_in, which nothing writes.
  auto sweep_e_late = [&](long long q, const Chunk& h) {
    if (h.rc < 0 || h.b == 0) return false;
    const long long W = (long long)(h.b - 1) * Q + nrc * per + (long long)h.pc * NG + NG - 1;
    return q - NS + 1 <= W;
  };
  // The partials' e rows of chunk h: e_in for block 0, else e_out.
  auto e_src = [&](const Chunk& h) {
    return (h.b == 0 ? p.e_in : p.e_out) + (size_t)h.rc * KC * obs + c.o0 + h.pc * P;
  };

  // Issue the copies of chunk q into its stage, as one commit group (an
  // empty one past the last chunk).
  auto fetch = [&](long long q) {
    if (q < total) {
      const Chunk h = chunk(q);
      const int rows = CB - h.g * SWEEP_ROWS < SWEEP_ROWS ? CB - h.g * SWEEP_ROWS : SWEEP_ROWS;
      const int p0 = h.pc * P;
      const int np = n - p0 < P ? n - p0 : P;
      const TX* src = x_t + (size_t)(h.b * CB + h.g * SWEEP_ROWS) * obs + c.o0 + p0;
      cp_async_rows_b(ring + (size_t)(q % NS) * SX, P, src, obs, rows, np, p.xw);
      if (!E_SMEM && h.rc >= 0 && !sweep_e_late(q, h)) {
        const int kc = k - h.rc * KC < KC ? k - h.rc * KC : KC;
        cp_async_rows_b(stage_e(q), P, e_src(h), obs, kc, np, p.ew);
      }
    }
    cp_async_commit();
  };
  // Wait for chunk q, free the stage of chunk q - 1 and refill it with
  // chunk q + NS - 1; returns chunk q's stage.
  auto take = [&](long long q) -> const TX* {
    cp_async_wait_n(NS - 2);
    __syncthreads();
    if constexpr (!E_SMEM) {
      const Chunk h = chunk(q);
      if (sweep_e_late(q, h)) {        // its e, written before this barrier
        const int kc = k - h.rc * KC < KC ? k - h.rc * KC : KC;
        const int np = n - h.pc * P < P ? n - h.pc * P : P;
        const float* src = e_src(h);
        float* dst = stage_e(q);
        for (int i = threadIdx.x; i < kc * np; i += blockDim.x) {
          const int r = i / np, o = i - r * np;
          dst[(size_t)r * P + o] = src[(size_t)r * obs + o];
        }
        __syncthreads();
      }
    }
    fetch(q + NS - 1);
    return ring + (size_t)(q % NS) * SX;
  };

  for (int s = 0; s < NS - 1; ++s) fetch(s);
  __syncthreads();                     // the residual slice is in place
  const int warp = threadIdx.x >> 5;
  long long q = 0;
  for (int b = 0; b < nblocks; ++b) {
    BAKP_CLOCK_START;
#ifdef BAKP_PHASE_CLOCKS
    long long fma_ = 0, wait_ = 0;
#endif
    for (int r0 = 0; r0 < k; r0 += KC) {
      const int kc = k - r0 < KC ? k - r0 : KC;
      for (int g = 0; g < NG; ++g) {
        const int c0 = g * SWEEP_ROWS + warp * BAKP_CT;
        const int rows = CB - c0 < BAKP_CT ? CB - c0 : BAKP_CT;
        float acc[BAKP_CT][KC] = {};
        for (int pc = 0; pc < NPC; ++pc, ++q) {
#ifdef BAKP_PHASE_CLOCKS
          const long long w0_ = clock64();
#endif
          const TX* stage = take(q);
#ifdef BAKP_PHASE_CLOCKS
          const long long f0_ = clock64();
          wait_ += f0_ - w0_;
#endif
          const int p0 = pc * P;
          const int np = n - p0 < P ? n - p0 : P;
          const float* ep;             // the chunk's e rows r0.., row stride eld
          int eld;
          if constexpr (E_SMEM) {
            ep = eb + (size_t)r0 * es + p0;
            eld = es;
          } else {
            ep = stage_e(q);
            eld = P;
          }
          if (rows > 0)
            bakp_acc<KC, true>(stage + (size_t)warp * BAKP_CT * P, P, rows, ep, eld, np, kc,
                               acc);
#ifdef BAKP_PHASE_CLOCKS
          fma_ += clock64() - f0_;
#endif
        }
        if (rows > 0) bakp_warp_scatter<KC>(acc, c0, rows, r0, kc, c.kp, c.part);
      }
    }
    __syncthreads();
#ifdef BAKP_PHASE_CLOCKS
    {
      const long long t_ = clock64();
      BAKP_CLOCK_ADD(0, wait_);
      BAKP_CLOCK_ADD(1, fma_);
      BAKP_CLOCK_ADD(2, t_ - bakp_t0_ - fma_ - wait_);
      bakp_t0_ = t_;
    }
#endif
    bakp_exchange(c, b, b, p.inv_cn, p.da, k, k, false, p.omega);
#ifdef BAKP_PHASE_CLOCKS
    bakp_t0_ = clock64();
#endif
    {
      constexpr int KG = BAKP_KG(KC);
      const int HG = (k + KG - 1) / KG;  // the update's groups of KG right-hand sides
      const bool e16 = E_SMEM || p.ew == 16;
      for (int pc = 0; pc < NPC; ++pc) {
        const int p0 = pc * P;
        const int np = n - p0 < P ? n - p0 : P;
        for (int g = 0; g < NG; ++g, ++q) {
          const int rows = CB - g * SWEEP_ROWS < SWEEP_ROWS ? CB - g * SWEEP_ROWS : SWEEP_ROWS;
          const TX* stage = take(q);
          const float* dag = c.da + (size_t)g * SWEEP_ROWS * c.kp;
          // With the slice in shared memory each group updates it in place.
          const bool first = E_SMEM || g == 0, last = E_SMEM || g == NG - 1;
          if (HG >= 4)
            sweep_update_dev<KG, 4>(stage, P, rows, et, P, eb + p0, es, e16, dag, c.kp, k, np,
                                    first, last);
          else if (HG >= 2)
            sweep_update_dev<KG, 2>(stage, P, rows, et, P, eb + p0, es, e16, dag, c.kp, k, np,
                                    first, last);
          else
            sweep_update_dev<KG, 1>(stage, P, rows, et, P, eb + p0, es, e16, dag, c.kp, k, np,
                                    first, last);
        }
      }
    }
    BAKP_CLOCK(6);
    BAKP_CLOCK_STEP();
  }
  cp_async_wait<0>();                  // the empty groups past the last chunk
  if constexpr (E_SMEM) {
    __syncthreads();
    for (int r = 0; r < k; ++r)
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        p.e_out[(size_t)r * obs + c.o0 + i] = eb[(size_t)r * es + i];
  }
  cl_cluster_sync();                   // no CTA leaves while the cluster pushes to it
}

template <int KC, typename TX>
static void* sweep_kernel(bool e_smem) {
  return e_smem ? (void*)bakp_sweep_kernel<KC, true, TX> : (void*)bakp_sweep_kernel<KC, false, TX>;
}

template <typename TX>
static void* sweep_pick(int k, bool e_smem) {
  switch (bakp_pick_kc(k)) {
    case 1: return sweep_kernel<1, TX>(e_smem);
    case 2: return sweep_kernel<2, TX>(e_smem);
    case 4: return sweep_kernel<4, TX>(e_smem);
    default: return sweep_kernel<8, TX>(e_smem);
  }
}

// Asked of the fp32 kernel: one CTA an SM whatever x's type.
extern "C" int bakp_sweep_clusters(int k, int cluster, int smem, int* n) {
  if (cluster < 1 || cluster > BAKP_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  size_t s = 0;
  cudaError_t err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  return (int)cl_max_clusters((void (*)(SweepParams))sweep_pick<float>(k, true), cluster, s, n);
}

template <typename TX>
static int sweep_launch(const TX* x_t, const float* inv_cn, const float* e_in, float* e_out,
                        float* da, void* xchg, unsigned tag0, int nvars, int obs, int k,
                        int block, float omega, int regime, int ctas, int cluster, int e_smem,
                        int stages, int smem, void* stream) {
  const size_t need = sizeof(float) * sweep_smem_floats(obs, ctas, cluster, k, block,
                                                        e_smem != 0, stages, sizeof(TX));
  cudaError_t err = bakp_plan_check(obs, regime, ctas, cluster, xchg, need, (size_t)smem);
  if (stages < SWEEP_MIN_STAGES || stages > SWEEP_MAX_STAGES) err = cudaErrorInvalidValue;
  size_t s = 0;
  if (err == cudaSuccess) err = cl_launch_smem((size_t)smem, &s);
  if (err != cudaSuccess) return (int)err;
  SweepParams p{x_t, inv_cn, e_in, e_out, da,
                regime == BAKP_SINGLE_CLUSTER ? nullptr : xchg, tag0,
                nvars, obs, k, block, omega,
                cp_bytes(x_t, (long long)obs * sizeof(TX), 16),
                cp_bytes(e_in, (long long)obs * 4, 16) == 16 &&
                        cp_bytes(e_out, (long long)obs * 4, 16) == 16 ? 16 : 4,
                stages};
  return (int)cl_launch((void (*)(SweepParams))sweep_pick<TX>(k, e_smem != 0), p, ctas,
                        cluster, regime != BAKP_SINGLE_CLUSTER, s, stream);
}

extern "C" int bakp_sweep_launch(const void* x_t, int x_bytes, const float* inv_cn,
                                 const float* e_in, float* e_out, float* da,
                                 void* xchg, unsigned tag0, int nvars, int obs,
                                 int k, int block, float omega, int regime, int ctas,
                                 int cluster,
                                 int e_smem, int stages, int smem, void* stream) {
  return bakp_with_x(x_t, x_bytes, [&](auto x) {
    return sweep_launch(x, inv_cn, e_in, e_out, da, xchg, tag0, nvars, obs, k, block, omega,
                        regime, ctas, cluster, e_smem, stages, smem, stream);
  });
}
