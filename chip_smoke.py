#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
process per source, in parallel), then:

  1. handle, fused path — ``prepare`` a 16,384 x 256 fp32 design with
     ``SolverSpec(method="bakp_fused")`` and serve a cold, a k=8 multi-RHS,
     a tenant's cold and warm (drifted ``y``) solve, the same four with
     ``bak_fused`` (Algorithm 1 on its whole-solve kernel), plus ``solve()``
     calls for bak (cyclic and random order) / bakp / bakp_gram / bakf /
     lstsq / normal;
  2. kernel entry, per-sweep path — ``solvebakp_kernel`` for Algorithm 2
     and Algorithm 1 on a 262,144 x 1,024 fp32 design (1 GiB), k=8,
     block=256, over the on-chip budget, and the same handle's
     ``bakp_fused`` / ``bak_fused`` falling back to the plain paths; then
     the two streamed-obs entries on that design, ``score_features_kernel``
     and ``block_update_kernel``;
  3. the streaming path — ``prepare`` a 16,384 x 4,096 fp32 design (256 MiB,
     a linear probe of 16k examples on 4,096-wide activations, 6.4x the
     fused budget) with ``SolverSpec(method="bakp_stream")`` and serve a
     cold, a k=8, a tenant's cold and warm solve on the streaming kernel,
     plus ``bakp_fused`` on the same handle falling back to the plain
     path; ``solvebakp_stream_kernel`` on the phase 2 design (its tile ring
     does not fit a CTA: the per-sweep loop); and a non-resident handle over
     the design's pinned host copy (the host-block loop, cold and warm),
     beside the rate of one plain pinned host-to-device copy of the design;
  4. mixed precision — phase 1's handle at ``precision="bf16"`` and
     ``"bf16_fp32acc"`` (refine 8) for ``bakp_fused`` and ``bak_fused`` at
     k 1 and 8 (coefficients within 1e-2 and 1e-5 of the fp32 solve, as
     JAX's test_precision; the history max_iter + refine_sweeps long); a
     16,384 x 512 design whose bf16 slice stays in shared memory where the
     fp32 one streams from the L2; a 16,384 x 1,024 design on the fused
     kernels at bf16 only; phase 3's design on the bf16 per-sweep loop
     (both algorithms), the bf16 streaming kernel and the non-resident
     handle (fp32 blocks whatever the precision); then the gates of
     ``benchmarks/solver_precision.py`` on its well-conditioned designs
     (post-refine MAPE against fp64 lstsq, analytic x bytes, a bf16-only
     fused dispatch) beside the JAX figures in ``BENCH_precision.json``.
     Each bf16 request runs twice, its first and repeat latency printed;
  5. the serving engine (``repro_torch.serve.SolverServeEngine``, run after
     the kernel rows of item 9), eight flushes on Gaussian designs from a
     numpy seed: (1) 64 cold ``bakp`` requests, 16 tenants on each of 4
     16,384 x 256 designs, with ``prefer_fused`` — 4 groups of k 16, 4
     ``fused_solve`` launches; (2) the same tenants with ``y`` drifted by
     1%, every request warm; (3) 16 4,096 x 256 ``bakp_gram`` designs (one
     batch across designs, plain lane) beside 8 ``bak_fused`` tenants of
     one design (one launch at k 8, fused lane); (4) 2 ``bakp_stream``
     tenants on phase 3's design (one ``stream_solve`` launch); (5) flush
     1 at ``precision="bf16_fp32acc"`` (``fused_solve_bf16`` and the fp32
     polish) plus an ``lstsq`` request that downgrades to fp32; (6) flush
     1 through an engine armed with a fault plan (a lane worker death,
     whose group is resubmitted, and a solver raise the retry ladder
     serves); (7) flush 3 on one serial lane, then (8) on lanes again
     through a fresh engine (the batch's operations no longer new to the
     process), both bit-identical to (3).  Each
     flush's engine counters and kernel launches must be as stated, each
     flush prints its wall time, requests/s, the split of its spans and
     mean sweeps; every request is held to fp64 lstsq (MAPE <= 1e-4) and
     to the handle's own solve (1e-5), and the four kernels the path ran
     to their plain versions at its shapes and plans; a watchdog turns a
     hang into a failed exit;
  6. the tiered design store and the async dispatcher (after phase 5), on
     an engine with ``store_device_bytes`` = 4 built 16,384 x 256 handles,
     a pinned host tier of 4 designs' layouts and a disk tier in a
     temporary directory of the checkout: (6a) 24 such designs, 4 tenants
     each, ``bakp`` with ``prefer_fused``, served twice in flushes of 4
     designs (pass 2 in reverse order with y drifted 1%, so it meets the
     device, host and disk tiers) — every pass must promote from host and
     disk, warm-start every request with fewer mean sweeps, keep the
     device tier within its budget after every flush and launch one
     ``fused_solve`` a resident group; (6b) phase 3's 16,384 x 4,096
     design through the same engine, rerouted to ``bakp_stream``
     (``over_hbm``) and solved from its host / disk tier on the host-block
     loop, beside seconds a sweep from each tier, the CRC check of a tile
     and one pinned copy of x; (6c) a tile corrupted once through the
     fault site and once by a flipped byte on disk: quarantined, rebuilt
     from the request's x with the tenants' warm state; (6d) an
     ``AsyncDispatcher`` over the same engine, 256 requests from 4
     submitter threads at 600 requests/s Poisson, deadline 50 ms,
     ``max_batch`` 16 (warm mean sweeps <= 0.7 x cold, promotions on the
     dispatch thread; each warm request's start source, its tenant's
     solves finished before its batch fired, its group, and counts by
     source), then the same trace on the synchronous engine;
     (6e) a broken ``fused_solve`` launch through the dispatcher fails its
     tickets with ``KernelError``.  Every request is held to fp64 lstsq
     (MAPE <= 1e-4) and 6a's to a storeless engine (1e-5, same sweeps);
     a watchdog turns a hang into a failed exit;
  7. the sharded path (after phase 6) on *virtual shards*: every shard of
     a mesh on ``cuda:0``, so the sharded arithmetic, routing, copies and
     mesh lanes run on one card (copies between cards do not).  (7a) the
     four sharded solvers of ``repro_torch.core.distributed`` against
     ``solvebakp`` at the same shape, each timed to ``synchronize()``
     beside it and beside the bytes of its sharded copy: obs-sharded on
     (4,) over phase 2's 262,144 x 1,024 design at k 8 (5 sweeps' history
     within rtol 1e-4 + 1e-7 |y|², coef within 1e-5 at 20), rhs-sharded on
     (4,) over 16,384 x 256 at k 64 (coef within 1e-5, sweeps equal at
     rtol 0 and within one at rtol 1e-7), vars- on (1, 4) and 2-D on
     (2, 2) over 65,536 x 1,024 at omega 0.5 (within 1e-3 of a_true);
     (7b) the engine on ``build_serve_mesh("4", devices=[cuda:0] * 4)``
     with the default policy, two rounds (round 2 warm through
     ``tenant_id``): 3 designs of 65,536 x 512 x 4 tenants
     (``obs_sharded``), one 4,096 x 256 design x 32 tenants
     (``rhs_sharded``), 4 designs of 4,096 x 64 (the batch across designs,
     single-device) — placements, batch kinds, mesh lanes, sharded solves
     and warm starts as stated, every request within MAPE 1e-5 of a
     mesh-less engine and 1e-4 of fp64 lstsq, no kernel launched, the
     flush split by spans; with ``prefer_fused`` the ``bakp`` requests
     stay ``bakp``, counted ``unshardable_fused`` and logged once; (7c) a
     store engine with a budget of two designs and their sharded copies:
     the copies count in the device tier, a demotion frees them, and the
     tier holds its budget after every flush;
  8. the LM serving path (after phase 7): qwen3-8b at full width and depth
     (36 layers, d_model 4,096, 32 heads and 8 KV heads of 128, d_ff
     12,288, vocab 151,936, bf16) with random weights from the seed.
     (8a) the build: ``count_params`` against ``n_params()``, weight
     bytes, init seconds, peak memory; (8b) 4 prompts of 512 tokens
     through ``launch/steps``' prefill and 32 greedy decode steps on a
     32,768-slot cache (19.3 GB): prefill seconds, decode tokens/s, cache
     bytes, lengths 544, finite logits; decoding token 512 from the cache
     against one full forward over 513 tokens, printed in bf16 beside two
     full forwards' own difference, and held at JAX's bound (rtol = atol
     = 2e-2) on the same model in fp32; (8c) the 16,384 x 4,096 fp32
     features of 4 x 4,096 tokens (embedding in fp32), their condition
     number, and planted readouts at k 1 and 8 fitted with ``bakp_gram``
     (warm-started chunks until |coef - w|/|w| < 1e-2) and with
     ``bakp_stream`` on the streaming kernel at omega 1 and 1 / lambda_max
     (the latter's coef within 1e-5 of ``stream_solve_plain`` at the same
     sweeps), each beside fp64 lstsq; then 9e's int8 run on these
     weights (below);
  9. every attention and cache variant of the LM stack (after phase 8),
     four models at full width and depth (``reduced: []``), random bf16
     weights from the seed, each built, served (4 prompts, prefill cold
     and warm, 32 greedy steps, one more step profiled by aten op), its
     decode step bounded by the weights
     and the bf16 cache read once at 3.35 TB/s, its first step held to
     one full forward in bf16 (beside two forwards' own difference) and,
     at JAX's bound, in fp32, then freed: (9a) h2o-danube-1.8b, prompts
     of 4,608 tokens (the window plus 512: the prefill roll) into its
     4,096-slot ring, fp32 check at B 2 past the window; (9b) gemma2-9b,
     4 x 4,608 tokens so the local rings wrap, 32,768 global slots, fp32
     check at B 2 on 8,192 slots; (9c)
     minicpm3-4b, 4 x 512 tokens into 32,768 latent slots, beside JAX's
     MLA compression bound (under 1/10 of a per-head cache); (9d)
     qwen2-vl-2b, 4 x 512 tokens with JAX's arange M-RoPE streams; (9e)
     the int8 KV cache on phase 8's qwen3-8b weights (32,768 slots, under
     0.6x the bf16 cache's bytes) and on 9a's ring, fed the bf16 run's
     tokens: greedy agreement and the log-softmax gap beside JAX's bound
     of 0.15.  No kernel launches; a watchdog turns a hang into a failed
     exit;
 10. the MoE, SSM and hybrid families (after phase 9, its own watchdog),
     at full width, random bf16 weights from the seed, each counted
     against ``n_params()``, served (4 prompts, prefill cold and warm, 32
     greedy steps, one more step profiled by aten op, the step bounded by
     every weight, all experts', and the cache read once at 3.35 TB/s),
     checked in fp32 and freed (``lm_family``): (10a) dbrx-132b at 6 of
     its 40 layers and (10b) arctic-480b at 2 of its 35 (its dense
     residual on), 4 x 512 tokens into 32,768 slots, each MoE layer's
     prefill routing printed (the share of assignments capacity drops,
     the load per expert), the fp32 decode step's MoE outputs (at 2 and 1
     layers) held to the no-capacity reference within 1e-5 of their
     magnitude; (10c) mamba2-370m and (10d) zamba2-7b at full depth, 4 x
     4,000 tokens (16 SSD chunks, the last padded), decode of token 4,000
     against one full forward over 4,001 tokens in bf16 (beside two
     forwards' own difference) and at JAX's bound in fp32 (zamba2 at B 2
     on 8,192 slots; its serving cache 32,768 slots, not its
     max_cache_len's 524,288); mamba2's state bytes constant in the
     length.  No kernel launches;
 11. the enc-dec family (after phase 10, its own watchdog):
     seamless-m4t-large-v2 at full width and depth (24 + 24 layers,
     ``reduced: []``), random bf16 weights from the seed, counted against
     ``n_params()`` (whose formula leaves out the decoder's cross-attention
     V projections: that gap is counted exactly), 4 prompts of 512 target
     tokens with frames (4, 4,096, 1,024) so the source fills
     ``src_len_for_decode``, prefill cold and warm and the encoder and the
     decoder's prefill timed apart, 32 greedy steps into 32,768
     self-attention slots (the cache 14,495,514,640 B), one step profiled,
     the step bounded by the weights a decode step reads (the decoder's
     but its cross K/V projections, the unembedding) and the cache once at
     3.35 TB/s; decode of token 512 against one forward over 513 target
     tokens with the same frames in bf16 (beside two forwards' own
     difference) and at JAX's bound in fp32 (B 2).  No kernel launches;
 12. training (after phase 11, its own watchdog; ``train_family``): (12a)
     seamless-m4t-large-v2 at full width and depth, B 8 x 512 target
     tokens and frames (8, 512, 1,024), microbatch 2; (12b) qwen3-8b at
     full width and 4 of its 36 layers (its AdamW state is 131 GB in
     full), B 8 x 1,024, microbatch 4; each with random bf16 weights, its
     config's AdamW and ``remat="full"``, 20 steps of ``make_train_step``
     (peak_lr 1e-3, warmup 5) on ``SyntheticLM``: step ms, tokens/s, the
     model-FLOP share of the bf16 peak (6 x the parameters but the input
     embedding x tokens a step; enc-dec's encoder sees the frames, here as
     many), one step profiled, peak memory, the optimizer state's bytes;
     every loss and grad norm finite, ce descending, a restart from a
     ``CheckpointManager`` checkpoint of step 10 (28 GB, in a git-ignored
     ``chip_smoke_ckpt_*`` directory of the checkout) no farther from the
     uninterrupted run's master weights at step 12 than a second
     uninterrupted run is, and microbatch 2 against 1 on an fp32 copy at
     2 (+ 2) layers within JAX's bounds.  No kernel launches;
 13. each kernel against its plain torch version on the same inputs, on the
     card, and timed with CUDA events beside its roofline bound (and beside
     the nearest single PyTorch call, where there is one); for the streaming
     kernel also the per-sweep loop on the same design, as a finding.  The
     Algorithm-1 rows carry their launch plan
     (regime, CTAs, cluster size, clusters, where e lives) and the time of a
     column step; phase 1 must run on one thread-block cluster and phase 2
     on several.  The Algorithm-2 kernels' rows (``bakp_sweep`` at phases
     1-3, ``fused_solve`` at phase 1, ``stream_solve`` at phase 3) carry
     their plan (regime, CTAs, cluster size, clusters, L, where x's tiles
     come from, right-hand sides an exchange) and the time of a block step;
     phase 1's handle must run the fused kernel with x's slices in shared
     memory (x_shared), phase 3's streaming solves and phase 2's per-sweep
     loop on several clusters.  The fused kernel also runs on a 16,384 x
     512 design (within the budget, over shared memory: x_l2) and at block
     256 with k 64 (right-hand sides in groups), each in one launch.  Then
     the Algorithm-1 kernels at each cluster size of 2, 4, 8 and 16, and
     the Algorithm-2 cluster kernels at 4, 8 and 16, each launch held to its
     plain version.  The five x-reading kernels also run on bf16 copies of
     x at the shapes of their fp32 rows and at every shape phase 4 gave
     them, there on the plan phase 4 ran (x at 2 bytes in the bound), with
     their rtol stops held to the rule on the plain iterate's fp64 SSE;
 14. a ``kernels`` summary line (the bf16 kernels as ``<name>_bf16``;
     launches summed over the paths), the card's name and power limit,
     and the result line
     ``{"ok": true, "device": {...}}``.

Launch counts are reset just before each path (phases 1-2, the earlier
slices' path; phase 3, the streaming path; phase 4, the mixed-precision
path, where each bf16 kernel must launch; phase 5, the serving path;
phase 6, the store and dispatcher path; phase 7b, the sharded serving
path; phase 8, the LM path, whose probes launch the streaming kernel;
phase 9, the LM variants; phase 10, the MoE, SSM and hybrid families;
phase 11, the enc-dec family; phase 12, training) and read just after
it, so they count that path only; each kernel must have launched on its
path, and none on the sharded path, the LM variants, the MoE, SSM,
hybrid and enc-dec families or training.  Inputs
are Gaussian designs with a planted ``a_true`` and ``y = x @ a_true`` from
a fixed seed.  Any failed check, build or launch error exits non-zero
without the result line; so does a host with no CUDA device, or a
directory without the repository's ``src/``.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
# Accuracy of a solve against the planted coefficients: max |coef - a_true|
# over max |a_true|.
COEF_TOL = 1e-4
# Kernel against its plain version: the sums run in another order (a
# fixed-order cross-CTA reduction against cuBLAS), so they agree to fp32
# rounding, not bit for bit.  Errors are max |kernel - plain| over the
# largest magnitude of the reference quantity.
KERNEL_TOL = 1e-4
# The same on a bf16 x: each kernel and its plain version widen the same
# bf16 values exactly, so only the order of the fp32 sums differs.
BF16_KERNEL_TOL = 1e-5
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# (non-tensor-core) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# bf16 tensor-core dense peak (the same data sheet), for phase 12's
# model-FLOP share.
BF16_FLOP_PER_S = 989e12
# Phase 5's watchdog: a serving path that has not finished by then is a
# hang, and the script exits non-zero instead of waiting on it.
PHASE5_WATCHDOG_S = 120
# Phase 6's (the store and the dispatcher, disk writes included).
PHASE6_WATCHDOG_S = 420
# Phase 7's (the sharded solvers, engine and store on virtual shards).
PHASE7_WATCHDOG_S = 300
# Phase 8's (qwen3-8b: build, serve, probes).
PHASE8_WATCHDOG_S = 700
# Phase 9's (four models at full width: build, serve, checks in fp32).
PHASE9_WATCHDOG_S = 900
# Phase 10's (four MoE, SSM and hybrid models: build, serve, checks in
# fp32).
PHASE10_WATCHDOG_S = 600
# Phase 11's (seamless-m4t-large-v2: build, serve, the check in fp32).
PHASE11_WATCHDOG_S = 300
# Phase 12's (two models trained 20 steps, a restart from a checkpoint of
# 28-32 GB, the microbatch check in fp32).
PHASE12_WATCHDOG_S = 900
# Phase 10's MoE decode check: each layer's output in an fp32 decode step
# against the no-capacity reference, max error over max |reference|.
MOE_REF_TOL = 1e-5
# Phase 8c: bakp_gram runs in warm-started chunks of this many sweeps until
# it recovers the planted readout, at most this many in all.
GRAM_CHUNK = 2_000
PROBE_GRAM_MAX_SWEEPS = 48_000
# Phase 8c's bakp_stream at omega = 1 / lambda_max: sweeps at most.
STREAM_PROBE_ITERS = 200

_failures: list = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        _failures.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)


def _timed(fn):
    """(fn(), its ms on the host clock between two device syncs)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _step_profile(step) -> tuple:
    """One call of ``step`` under torch.profiler: (device ms, the ten
    aten ops with the most device self time, by name)."""
    import torch
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        step()
        torch.cuda.synchronize()
    ops = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        # "Command Buffer Full" is the host waiting for room in the launch
        # queue (a training step launches tens of thousands of kernels),
        # not a kernel's time.
        if str(ev.device_type).endswith("CPU") and us > 0 and \
                ev.key != "Command Buffer Full":
            ops[ev.key] = us / 1e3
    return sum(ops.values()), dict(sorted(ops.items(),
                                          key=lambda kv: -kv[1])[:10])


@contextlib.contextmanager
def _moe_calls(record: list):
    """Within it, each MoE layer's call appends (its params, its input, its
    output) to ``record``: ``models.transformer.apply_moe`` wrapped, for
    phase 10's routing statistics and its decode check."""
    import repro_torch.models.transformer as tt
    real = tt.apply_moe

    def recording(cfg, p, h):
        y, aux = real(cfg, p, h)
        record.append((p, h, y))
        return y, aux

    tt.apply_moe = recording
    try:
        yield record
    finally:
        tt.apply_moe = real


def _routing_stats(cfg, p, h) -> dict:
    """One MoE layer's routing of its input ``h``: its capacity, the
    assignments it dropped and their share, and the assignments and kept
    ones per expert."""
    import torch

    from repro_torch.models import moe as moe_lib
    xg = h.reshape(1, -1, cfg.d_model)
    r = moe_lib.route(cfg, moe_lib.router_logits(p, xg),
                      moe_lib.capacity(cfg, xg.shape[1]))
    flat = r.idx.reshape(-1)
    return {"capacity": r.cap, "assignments": flat.numel(),
            "dropped": int((~r.keep).sum()),
            "dropped_share": 1.0 - r.keep.float().mean().item(),
            "assignments_per_expert": torch.bincount(
                flat, minlength=cfg.n_experts).tolist(),
            "kept_per_expert": torch.bincount(
                flat[r.keep.reshape(-1)], minlength=cfg.n_experts).tolist()}


def _against_no_capacity(cfg, p, h, y) -> float:
    """max |y - the no-capacity reference on h| over its max magnitude."""
    from repro_torch.models import moe as moe_lib
    ref = moe_lib.apply_moe_no_capacity(cfg, p, h)
    return ((y - ref).abs().max() / ref.abs().max()).item()


def _tree_bytes(tree) -> int:
    from repro_torch.models.params import tree_items
    return sum(t.numel() * t.element_size() for _, t in tree_items(tree))


def lm_family(spec, *, dev, card, against, held, int8_against=None):
    """Phases 9 to 11: serve one model at its full width, its depth cut
    (``spec["depth"]``) where its bf16 weights pass one card, as
    ``spec["reduced"]`` says: build and count, prefill 4 prompts cold and
    warm, 32 greedy decode steps on a cache of max(max_cache_len, prompt +
    gen) slots (or ``spec["slots"]``), one more step profiled by aten op;
    an MoE model's prefill routing per layer (capacity drops, expert
    loads); with ``spec["int8_slots"]``, the int8 KV cache against this
    run (``int8_against``); an enc-dec model's prompts carry frames of
    ``spec["frames"]`` source positions, its encoder and decoder prefill
    are timed apart too, and its step bound counts the weights a decode
    step reads (the decoder's but its cross-attention K/V projections,
    which only prefill runs, and the unembedding).  Then the decode check in fp32 on a fresh copy
    of ``spec["check_depth"]`` layers: an MoE model's decode step, layer by
    layer, against the no-capacity reference within MOE_REF_TOL of its
    magnitude (capacity routes a 1-token decode unlike a long forward);
    any other model's first step against one full forward at JAX's bound,
    after the same comparison in bf16 beside two forwards' own
    difference."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get as get_arch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import encdec as encdec_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.common import embed_tokens
    from repro_torch.models.kvcache import (cache_bytes, cache_spec_tree,
                                            init_cache)
    from repro_torch.models.model import (forward_logits, init_model,
                                          make_smoke_batch, model_defs)
    from repro_torch.models.params import count_params

    step, arch = spec["step"], spec["arch"]
    full_cfg = get_arch(arch)
    got = (full_cfg.n_layers, full_cfg.d_model, full_cfg.n_heads,
           full_cfg.n_kv_heads, full_cfg.resolved_head_dim, full_cfg.d_ff,
           full_cfg.vocab_size)
    check(got == spec["shape"], f"phase {step}: {arch} is {got}")
    encdec = full_cfg.family == "encdec"
    if encdec:
        got = (full_cfg.n_enc_layers, full_cfg.n_dec_layers,
               full_cfg.src_len_for_decode)
        check(got == spec["encdec"],
              f"phase {step}: {arch}'s encoder, decoder, source slots {got}")
    cfg = dataclasses.replace(
        full_cfg, n_layers=spec.get("depth", full_cfg.n_layers))
    moe = cfg.n_experts > 0
    b, s, gen = 4, spec["prompt"], 32
    slots = spec.get("slots", max(cfg.max_cache_len, s + gen))
    if "cache_bytes_b4" in spec:
        check(cache_bytes(cfg, 4, 32_768) == spec["cache_bytes_b4"],
              f"phase {step}: cache_bytes(B 4, 32,768) "
              f"{cache_bytes(cfg, 4, 32_768)}, want "
              f"{spec['cache_bytes_b4']}")
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = _timed(lambda: init_model(cfg, seed=SEED, device=dev))
    n = count_params(model_defs(cfg))
    wbytes = _tree_bytes(params)
    check(n == spec["params"] and wbytes == 2 * n,
          f"phase {step}: {n} parameters in {wbytes} bytes, want "
          f"{spec['params']} in bf16")
    # n_params() leaves out the norms, the conv and LoRA weights and the
    # padded vocab rows: under 1% of every model here.
    # JAX's n_params() leaves out the enc-dec decoder's cross-attention V
    # projections (``spec["n_params_gap"]``, counted exactly).
    gap = spec.get("n_params_gap", 0)
    check(abs(n - gap - cfg.n_params()) < 1e-2 * cfg.n_params(),
          f"phase {step}: count_params {n} less {gap}, n_params() "
          f"{cfg.n_params()}")
    prompt = make_smoke_batch(cfg, seed=SEED + spec["seed_offset"],
                              batch=b, seq=s, device=dev)
    prompt.pop("labels")
    if encdec:
        gen_f = torch.Generator(device=dev).manual_seed(
            SEED + spec["seed_offset"] + 1)
        prompt["frames"] = torch.randn((b, spec["frames"], cfg.d_model),
                                       generator=gen_f, device=dev)
    cache = init_cache(cfg, b, slots, device=dev)
    cbytes = cache_bytes(cfg, b, slots)
    check(cbytes == sum(t.numel() * t.element_size()
                        for t in cache.values()),
          f"phase {step}: cache_bytes {cbytes} is not the cache's")
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    def fresh_prefill(record=None):
        # Into the cache zeroed again (untimed): an SSM prefill continues
        # from the states it finds there, as JAX's does.
        for t in cache.values():
            t.zero_()
        with torch.no_grad(), _moe_calls([] if record is None else record):
            (out, _), ms = _timed(lambda: prefill(params, prompt, cache))
        return out, ms

    logits, pre_ms = fresh_prefill()
    logits, pre_warm_ms = fresh_prefill()
    row = {"phase": spec["row"], "card": card, "step": step, "arch": arch,
           "family": cfg.family, "layers": cfg.n_layers,
           "published_layers": full_cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "layer_pattern": cfg.layer_pattern,
           "attn_type": cfg.attn_type, "window": cfg.sliding_window,
           "dtype": cfg.dtype, "reduced": spec["reduced"], "params": n,
           "n_params_formula": cfg.n_params(), "n_params_gap": gap,
           "weight_bytes": wbytes,
           "init_s": init_ms / 1e3, "batch": b, "prompt": s, "gen": gen,
           "cache_slots": slots,
           "cache_layout": {k: list(v[0]) for k, v in
                            cache_spec_tree(cfg, b, slots).items()},
           "cache_bytes": cbytes, "prefill_s": pre_ms / 1e3,
           "prefill_warm_s": pre_warm_ms / 1e3, "held_before_phase": held}
    if encdec:
        # The encoder alone, then the decoder's prefill on its output (the
        # cross K/V written once), each warm.
        with torch.no_grad():
            enc_out, enc_ms = _timed(lambda: encdec_lib.run_encoder(
                cfg, params["backbone"], prompt["frames"].to(torch.bfloat16)))
            x = embed_tokens(params["embed"], prompt["tokens"],
                             torch.bfloat16)
            pos = torch.arange(s, dtype=torch.int32,
                               device=dev)[None].expand(b, s)
            _, dec_ms = _timed(lambda: encdec_lib.run_decoder(
                cfg, params["backbone"], x, enc_out, mode="prefill",
                positions=pos, cache=cache))
        del enc_out, x
        row.update(n_enc_layers=cfg.n_enc_layers,
                   n_dec_layers=cfg.n_dec_layers,
                   frames=list(prompt["frames"].shape),
                   prefill_encoder_s=enc_ms / 1e3,
                   prefill_decoder_s=dec_ms / 1e3)
    if moe:
        row.update(n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
                   moe_d_ff=cfg.moe_d_ff,
                   dense_residual_d_ff=cfg.dense_residual_d_ff)
        # The prefill once more, each MoE layer's routing recorded.
        calls = []
        fresh_prefill(calls)
        routing = [_routing_stats(cfg, p, h) for p, h, _ in calls]
        calls.clear()
        check(len(routing) == cfg.n_layers,
              f"phase {step}: {len(routing)} MoE layers ran in prefill")
        row["prefill_routing_by_layer"] = routing
    tok = first_tok = logits.argmax(-1)[:, None].to(torch.int32)
    ids, steps = [], []
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.no_grad():
        for _ in range(gen):
            ids.append(tok)
            logits = decode(params, tok, cache)[0]
            steps.append(logits)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t
    lengths = cache["lengths"].tolist()
    check(lengths == [s + gen] * b, f"phase {step}: lengths {lengths}")
    check(all(bool(torch.isfinite(lg).all()) for lg in steps),
          f"phase {step}: decode logits not finite")
    with torch.no_grad():
        dev_ms, ops = _step_profile(lambda: decode(params, tok, cache))
    step_wbytes = wbytes
    if encdec:
        dec = params["backbone"]["dec"]
        step_wbytes = (_tree_bytes(dec) - _tree_bytes(
            {k: dec["cross_attn"][k] for k in ("wk", "wv")})
            + _tree_bytes(params["embed"]["out"])
            + _tree_bytes(params["final_ln"]))
        row["decode_weight_bytes"] = step_wbytes
    row.update({
        "decode_s": dec_s, "decode_tokens_per_s": gen * b / dec_s,
        "decode_ms_per_step": dec_s * 1e3 / gen,
        # The step's least time: every weight (every expert's: the batched
        # product computes each expert's capacity rows; enc-dec's that a
        # step reads) and the cache, read once.
        "step_bound_ms": (step_wbytes + cbytes) / HBM_BYTES_PER_S * 1e3,
        "profiled_step_device_ms": dev_ms,
        "profiled_step_device_ms_by_op": ops,
        "decode_idle_share": 1.0 - dev_ms / (dec_s * 1e3 / gen),
        "lengths": lengths,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "generated_ids_row0": [int(t_[0]) for t_ in ids]})
    full = torch.cat([prompt["tokens"], first_tok], 1)
    del cache
    torch.cuda.empty_cache()
    if not moe:
        # Decode against the full forward in bf16: the first step's logits
        # against one forward over s + 1 tokens at position s, and a
        # forward over s + 2 tokens at s (the rounding floor).
        with torch.no_grad():
            ref = forward_logits(cfg, params, full, at=s,
                                 frames=prompt.get("frames"))
            floor = forward_logits(cfg, params,
                                   torch.cat([full, first_tok], 1), at=s,
                                   frames=prompt.get("frames"))
        row["decode_vs_forward_bf16"] = against(steps[0], ref)
        row["forward_vs_forward_bf16"] = against(floor, ref)
        del ref, floor
    if "int8_slots" in spec:
        row["int8"] = int8_against(cfg, params, prompt, ids, steps,
                                   spec["int8_slots"])
    del params, steps, logits
    torch.cuda.empty_cache()

    # The check on the same model in fp32 (JAX's tests' dtype).
    cb, cs, cslots = spec["check"]
    c32 = dataclasses.replace(cfg, dtype="float32",
                              n_layers=spec.get("check_depth", cfg.n_layers))
    params32 = init_model(c32, seed=SEED, device=dev)
    cache32 = init_cache(c32, cb, cslots, device=dev)
    # tokens (B, S), frames (B, S_src, d): rows; positions (3, B, S).
    p32 = {k: v[:cb, :cs] if k == "tokens" else
           v[:cb] if k == "frames" else v[:, :cb, :cs]
           for k, v in prompt.items()}
    row["fp32_check"] = {"layers": c32.n_layers, "batch": cb, "prompt": cs,
                         "cache_slots": cslots,
                         "cache_bytes": cache_bytes(c32, cb, cslots)}
    calls = []
    with torch.no_grad():
        make_prefill_step(c32)(params32, p32, cache32)
        with _moe_calls(calls):
            dec32 = make_decode_step(c32)(params32, full[:cb, cs:cs + 1],
                                          cache32)[0]
        if moe:
            errs = [_against_no_capacity(c32, p, h, y) for p, h, y in calls]
            drops = [_routing_stats(c32, p, h)["dropped"]
                     for p, h, _ in calls]
            calls.clear()
            row["decode_moe_vs_no_capacity_fp32"] = {
                "rel_err_by_layer": errs, "dropped_by_layer": drops,
                "capacity": moe_lib.capacity(c32, cb), "tol": MOE_REF_TOL}
            check(len(errs) == c32.n_layers and max(errs) <= MOE_REF_TOL
                  and not any(drops),
                  f"phase {step}: fp32 decode MoE against the no-capacity "
                  f"reference {errs}, dropped {drops}")
        else:
            ref32 = forward_logits(c32, params32, full[:cb, :cs + 1], at=cs,
                                   frames=p32.get("frames"))
            row["decode_vs_forward_fp32"] = res32 = against(dec32, ref32)
            check(res32["outside_jax_bound"] == 0,
                  f"phase {step}: {arch} fp32 decode against the full "
                  f"forward {res32}")
    row["max_memory_allocated_fp32_check"] = torch.cuda.max_memory_allocated()
    del params32, cache32, dec32
    torch.cuda.empty_cache()
    emit(row)
    return row


def _max_diff(a, b) -> float:
    """max |a - b| over every leaf of two trees of tensors."""
    from repro_torch.models.params import tree_items
    return max((x - y).abs().max().item()
               for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))


def train_family(spec, *, dev, card, held, ckpt_root):
    """Phase 12: train one model at its full width (its depth cut where its
    AdamW state passes one card, as ``spec["reduced"]`` says) with random
    bf16 weights from the seed, its config's optimizer, ``remat`` and
    ``spec["microbatch"]``, on ``SyntheticLM`` batches of ``spec["batch"]``
    x ``spec["seq"]`` tokens (enc-dec: frames (B, seq, d_model) drawn from
    a generator seeded by the step), 20 steps of ``make_train_step``
    (peak_lr 1e-3, warmup 5).  Prints step ms (the median of the warm
    steps, 2-19), tokens/s, the model-FLOP share of the bf16 peak, one
    more step's device ms by aten op and the idle share, peak memory and
    the optimizer state's bytes.  Checks: every loss and grad
    norm finite; the mean ce of the last 5 steps below the first 5's; the
    restart (a ``CheckpointManager`` save at step 10, restored into fresh
    tensors, run to step 12) no farther from the uninterrupted run's fp32
    master weights at step 12 than a second uninterrupted run is; and, on
    an fp32 copy at full width and ``spec["mb_layers"]`` depth, one step
    at ``microbatch`` 2 against 1 on the same batch within JAX's test's
    bounds (ce within 2e-3, params rtol = atol = 2e-2)."""
    import dataclasses
    import math
    import statistics
    import tempfile

    import torch

    from repro_torch.configs.registry import get as get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_model, model_defs
    from repro_torch.models.params import count_params, tree_items, tree_map
    from repro_torch.optim import make_optimizer

    step_id, arch = spec["step"], spec["arch"]
    full_cfg = get_arch(arch)
    cfg = dataclasses.replace(
        full_cfg, n_layers=spec.get("depth", full_cfg.n_layers),
        microbatch=spec["microbatch"])
    encdec = cfg.family == "encdec"
    b, s, n_steps, seed = spec["batch"], spec["seq"], 20, SEED + spec[
        "seed_offset"]
    sched = dict(peak_lr=1e-3, warmup=5, total_steps=n_steps)
    opt_init, _ = make_optimizer(cfg.optimizer)
    check(cfg.optimizer == "adamw" and cfg.remat == "full",
          f"phase {step_id}: {arch} trains with {cfg.optimizer}, remat "
          f"{cfg.remat}")

    def next_batch(data, c=cfg):
        st = data.state.step
        out = {k: torch.from_numpy(v).to(dev)
               for k, v in data.next_batch().items()}
        if encdec:
            gen = torch.Generator(device=dev).manual_seed(seed + st)
            out["frames"] = torch.randn((b, s, c.d_model), generator=gen,
                                        device=dev)
        return out

    def run(params, opt_state, data, steps, on_step=None):
        step_fn = make_train_step(cfg, **sched)
        rows = []
        for st in steps:
            batch = next_batch(data)
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch, st)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            rows.append({"step": st, "ms": ms,
                         **{k: float(v) for k, v in m.items()}})
            if on_step is not None:
                on_step(st, params, opt_state, data)
        return params, opt_state, rows

    def fresh():
        params = init_model(cfg, seed=seed, device=dev)
        return params, opt_init(params)

    torch.cuda.reset_peak_memory_stats()
    (params, opt_state), init_ms = _timed(fresh)
    n = count_params(model_defs(cfg))
    wbytes, state_bytes = _tree_bytes(params), _tree_bytes(opt_state)
    check(n == spec["params"] and wbytes == 2 * n,
          f"phase {step_id}: {n} parameters in {wbytes} bytes, want "
          f"{spec['params']} in bf16")
    gap = spec.get("n_params_gap", 0)
    check(abs(n - gap - cfg.n_params()) < 1e-2 * cfg.n_params(),
          f"phase {step_id}: count_params {n} less {gap}, n_params() "
          f"{cfg.n_params()}")

    # A: the 20 steps, a checkpoint at step 10 and the fp32 master weights
    # of step 12 kept.
    ckdir = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_",
                                        dir=ckpt_root)
    mgr = CheckpointManager(ckdir.name, interval_steps=10)
    kept = {}

    def on_step(st, params, opt_state, data):
        if mgr.should_save(st):
            path, kept["save_ms"] = _timed(lambda: mgr.save(
                st, {"params": params, "opt": opt_state},
                extras={"data_step": data.state.step}))
            kept["ckpt_bytes"] = sum(f.stat().st_size
                                     for f in Path(path).iterdir())
        if st == 12:
            kept["master"] = tree_map(torch.clone, opt_state["master"])

    data = SyntheticLM(cfg.vocab_size, s, b)
    params, opt_state, rows = run(params, opt_state, data, range(n_steps),
                                  on_step)
    peak = torch.cuda.max_memory_allocated()
    # One more step (the 21st batch) under torch.profiler: device ms by
    # aten op, against the warm steps' median for the idle share.
    batch = next_batch(data)
    step_fn = make_train_step(cfg, **sched)
    dev_ms, ops = _step_profile(
        lambda: step_fn(params, opt_state, batch, n_steps))
    del params, opt_state, batch
    torch.cuda.empty_cache()
    ces = [r["ce_loss"] for r in rows]
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in rows),
          f"phase {step_id}: a loss or grad norm is not finite {rows}")
    check(statistics.mean(ces[-5:]) < statistics.mean(ces[:5]),
          f"phase {step_id}: ce {ces} did not descend")

    # B: a second uninterrupted run to step 12, the floor of the restart's
    # difference (a CUDA backward may sum in another order run to run).
    params, opt_state = fresh()
    params, opt_state, rows_b = run(params, opt_state,
                                    SyntheticLM(cfg.vocab_size, s, b),
                                    range(13))
    floor = _max_diff(opt_state["master"], kept["master"])
    del params, opt_state
    torch.cuda.empty_cache()

    # C: the restart, from step 10's checkpoint into fresh tensors.
    template = {"params": tree_map(
        lambda d: torch.empty(d.shape, dtype=torch.bfloat16, device="meta"),
        model_defs(cfg))}
    template["opt"] = opt_init(template["params"])
    (tree, extras, saved), restore_ms = _timed(
        lambda: mgr.restore_latest(template, device=dev))
    del template
    data = SyntheticLM(cfg.vocab_size, s, b)
    data.skip_to(extras["data_step"])
    check(saved == 10 and extras["data_step"] == 11,
          f"phase {step_id}: restored step {saved}, data step {extras}")
    params, opt_state, rows_c = run(tree["params"], tree["opt"], data,
                                    range(saved + 1, 13))
    restart = _max_diff(opt_state["master"], kept["master"])
    check(restart <= floor,
          f"phase {step_id}: the restart is {restart} from the "
          f"uninterrupted run's master weights at step 12, two "
          f"uninterrupted runs {floor}")
    del params, opt_state, tree, kept["master"]
    ckdir.cleanup()
    torch.cuda.empty_cache()

    # The microbatch equivalence in fp32 at full width, reduced depth: one
    # step at microbatch 2 against 1 on the same batch, at step 5 (the
    # peak rate).
    c32 = dataclasses.replace(cfg, dtype="float32", **spec["mb_layers"])
    p0 = init_model(c32, seed=seed, device=dev)
    batch = next_batch(SyntheticLM(cfg.vocab_size, s, b), c32)
    outs = []
    for k in (1, 2):
        p = tree_map(torch.clone, p0)
        o = opt_init(p)
        p, o, m = make_train_step(dataclasses.replace(c32, microbatch=k),
                                  **sched)(p, o, batch, 5)
        outs.append((float(m["ce_loss"]), float(m["grad_norm"]),
                     tree_map(lambda t: t.cpu(), p)))
        del p, o, m
        torch.cuda.empty_cache()
    del p0
    (ce1, g1, q1), (ce2, g2, q2) = outs
    outside = sum(int(((x - y).abs() > 2e-2 + 2e-2 * y.abs()).sum())
                  for (_, x), (_, y) in zip(tree_items(q2), tree_items(q1)))
    mb = {"layers": {k: getattr(c32, k) for k in spec["mb_layers"]},
          "batch": b, "seq": s, "step": 5, "ce_mb1": ce1, "ce_mb2": ce2,
          "ce_diff": abs(ce1 - ce2), "grad_norm_mb1": g1,
          "grad_norm_mb2": g2, "params_max_abs_diff": _max_diff(q2, q1),
          "params_outside_jax_bound": outside,
          "params": count_params(model_defs(c32))}
    check(mb["ce_diff"] < 2e-3 and outside == 0,
          f"phase {step_id}: microbatch 2 against 1 in fp32 {mb}")
    del outs, q1, q2

    warm = [r["ms"] for r in rows[2:]]
    step_s = statistics.median(warm) / 1e3
    tokens = b * s
    # Model FLOP of a step: 6 x the parameters that multiply (all but the
    # input embedding table, a gather) x the tokens each sees; enc-dec's
    # encoder sees B x S_src frames, the rest B x S_tgt tokens, here both
    # B x seq.  Attention's score products are left out.
    n_matmul = n - (0 if cfg.tie_embeddings
                    else cfg.padded_vocab * cfg.d_model)
    flop = 6 * n_matmul * tokens
    row = {"phase": "train", "card": card, "step": step_id, "arch": arch,
           "family": cfg.family, "layers": cfg.n_layers,
           "published_layers": full_cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers,
           "n_dec_layers": cfg.n_dec_layers, "d_model": cfg.d_model,
           "reduced": spec["reduced"], "params": n,
           "n_params_formula": cfg.n_params(), "n_params_gap": gap,
           "dtype": cfg.dtype, "optimizer": cfg.optimizer,
           "remat": cfg.remat, "microbatch": cfg.microbatch, "batch": b,
           "seq": s, "frames": [b, s, cfg.d_model] if encdec else None,
           "schedule": sched, "init_s": init_ms / 1e3,
           "weight_bytes": wbytes, "opt_state_bytes": state_bytes,
           "step_ms_median_warm": step_s * 1e3, "step_ms": [r["ms"]
                                                           for r in rows],
           "tokens_per_s": tokens / step_s,
           "model_flop_per_step": flop, "params_matmul": n_matmul,
           "model_flop_share_bf16_peak": flop / step_s / BF16_FLOP_PER_S,
           "profiled_step_device_ms": dev_ms,
           "profiled_step_device_ms_by_op": ops,
           "step_idle_share": 1.0 - dev_ms / (step_s * 1e3),
           "max_memory_allocated": peak, "held_before_phase": held,
           "ce_loss": ces, "loss": [r["loss"] for r in rows],
           "grad_norm": [r["grad_norm"] for r in rows],
           "lr": [r["lr"] for r in rows],
           "ce_first5_mean": statistics.mean(ces[:5]),
           "ce_last5_mean": statistics.mean(ces[-5:]),
           "restart": {"save_ms": kept["save_ms"],
                       "restore_ms": restore_ms,
                       "checkpoint_bytes": kept["ckpt_bytes"],
                       "master_max_abs_diff_restart": restart,
                       "master_max_abs_diff_two_runs": floor,
                       "ce_steps_11_12": [r["ce_loss"] for r in rows_c],
                       "ce_steps_11_12_uninterrupted": ces[11:13],
                       "ce_steps_11_12_second_run":
                           [r["ce_loss"] for r in rows_b[11:13]]},
           "microbatch_equivalence_fp32": mb}
    emit(row)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    from repro_torch.core import (SolverSpec, UnsupportedSpecError, prepare,
                                  prepared_from_arrays, solve)
    from repro_torch.kernels import (_build, block_update_kernel,
                                     score_features_kernel, solvebakp_kernel,
                                     solvebakp_persweep_kernel,
                                     solvebakp_stream_kernel)
    from repro_torch.kernels.block_update import (_block_update_cuda,
                                                  _score_features_cuda,
                                                  block_update_plain,
                                                  score_features_plain)
    from repro_torch.kernels.cd_sweep import (_bakp_sweep_cuda,
                                              _cd_sweep_cuda,
                                              bakp_sweep_plain,
                                              cd_sweep_plain)
    from repro_torch.kernels.fused_solve import (fused_cuda, fused_fits,
                                                 fused_solve_plain,
                                                 plain_rtol_stop, solve_init)
    from repro_torch.kernels.stream_solve import (stream_cuda, stream_fits,
                                                  stream_solve_plain)
    from repro_torch.core.prepare import host_copy
    from repro_torch.core.types import (atol_to_sse, column_norms_sq_t,
                                        safe_inv)
    from repro_torch.obs import (consume_dispatch, fallback_counts,
                                 reset_counters)

    # fp32 matmuls in full fp32 on the plain paths (PyTorch's default, set
    # here so the comparison does not depend on the environment).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    emit({"phase": "device", "name": props.name,
          "sms": props.multi_processor_count,
          "l2_bytes": getattr(props, "L2_cache_size", None),
          "memory_bytes": props.total_memory, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = _build.build_all()
    regs = {n: [ln.strip() for ln in log.splitlines() if "Used" in ln]
            for n, log in logs.items()}
    # Kernels that spill registers (ptxas -v), by library; a bf16
    # instantiation must not.
    spills = {}
    for n, log in logs.items():
        fn = None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            fn = m.group(1) if m else fn
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            if m and fn and m.group(1) + m.group(2) != "00":
                spills.setdefault(n, {})[fn] = [int(m.group(1)),
                                                int(m.group(2))]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": regs, "spills": spills})
    bf16_spills = [fn for by_fn in spills.values() for fn in by_fn
                   if "bfloat16" in fn]
    check(not bf16_spills, f"bf16 kernels spill registers: {bf16_spills}")

    def sync():
        torch.cuda.synchronize()

    def rel(a, b, scale=None) -> float:
        s = (b if scale is None else scale).abs().max().item() or 1.0
        return (a - b).abs().max().item() / s

    latency_ms = {}

    def request(name, method, fn, truth, want_path):
        consume_dispatch()
        sync()
        t = time.perf_counter()
        res = fn()
        sync()
        ms = (time.perf_counter() - t) * 1e3
        latency_ms[name, method] = ms
        path = consume_dispatch()
        err = rel(res.coef, truth)
        emit({"phase": name, "method": method, "path": path,
              "n_sweeps": int(res.n_sweeps), "latency_ms": ms,
              "max_rel_err": err})
        check(err <= COEF_TOL, f"{name}/{method}: coef error {err}")
        check(path == want_path, f"{name}/{method}: path {path}, "
                                 f"want {want_path}")
        return res

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # ------------------------------- main path of the earlier slices
    _build.reset_launch_counts()
    reset_counters()

    # Phase 1: the handle on the fused path.
    obs1, vars1, thr1, k = 16_384, 256, 128, 8
    x1 = randn(obs1, vars1)
    a1 = randn(vars1)
    a1k = randn(vars1, k)
    y1, y1k = x1 @ a1, x1 @ a1k
    spec1 = SolverSpec(method="bakp_fused", rtol=1e-7, max_iter=100)
    check(fused_fits(vars1, obs1, k, 4, max_iter=spec1.max_iter),
          "phase 1 design must fit the fused budget")
    p1 = prepare(x1, spec1)
    _build.PLANS.pop("fused_solve", None)
    request("handle", "bakp_fused", lambda: p1.solve(y1), a1, "fused")
    request("handle_k8", "bakp_fused", lambda: p1.solve(y1k), a1k, "fused")
    cold = request("handle_tenant_cold", "bakp_fused",
                   lambda: p1.solve(y1, tenant_id="tenant-0"), a1, "fused")
    a1d = a1 + 0.01 * randn(vars1)
    y1d = x1 @ a1d
    warm = request("handle_tenant_warm", "bakp_fused",
                   lambda: p1.solve(y1d, tenant_id="tenant-0"), a1d, "fused")
    check(int(warm.n_sweeps) < int(cold.n_sweeps),
          f"warm solve took {int(warm.n_sweeps)} sweeps, cold "
          f"{int(cold.n_sweeps)}")
    plan1 = _build.PLANS.get("fused_solve")
    check(plan1 is not None and plan1.x_in == "shared",
          f"phase 1 bakp_fused must keep x's slices in shared memory "
          f"(x_shared), ran {plan1}")
    for m in ("bakp", "bakp_gram", "lstsq", "normal"):
        request("solve_shim", m,
                lambda m=m: solve(x1, y1, method=m, rtol=1e-7, max_iter=100),
                a1, "xla")

    # Phase 1, Algorithm 1 on its whole-solve kernel through the same handle
    # (same block width, so the cached transposed copy serves both), and
    # Algorithms 1 and 3 through the solve() shim.
    spec1b = SolverSpec(method="bak_fused", rtol=1e-7, max_iter=100)
    request("handle", "bak_fused", lambda: p1.solve(y1, spec=spec1b), a1,
            "fused")
    request("handle_k8", "bak_fused", lambda: p1.solve(y1k, spec=spec1b),
            a1k, "fused")
    cold_b = request("handle_tenant_cold", "bak_fused",
                     lambda: p1.solve(y1, spec=spec1b, tenant_id="tenant-1"),
                     a1, "fused")
    warm_b = request("handle_tenant_warm", "bak_fused",
                     lambda: p1.solve(y1d, spec=spec1b, tenant_id="tenant-1"),
                     a1d, "fused")
    check(int(warm_b.n_sweeps) < int(cold_b.n_sweeps),
          f"bak_fused warm solve took {int(warm_b.n_sweeps)} sweeps, cold "
          f"{int(cold_b.n_sweeps)}")
    request("solve_shim", "bak",
            lambda: solve(x1, y1, method="bak", rtol=1e-7, max_iter=100),
            a1, "xla")
    request("solve_shim_random", "bak",
            lambda: solve(x1, y1, method="bak", order="random", rtol=1e-7,
                          max_iter=100,
                          generator=torch.Generator(device=dev).manual_seed(
                              SEED)),
            a1, "xla")
    request("solve_shim", "bakf",
            lambda: solve(x1, y1, method="bakf", max_iter=20), a1, "xla")

    # Phase 2: the kernel entry on the per-sweep path, 1 GiB design.
    obs2, vars2, thr2 = 262_144, 1_024, 256
    x2 = randn(obs2, vars2)
    a2k = randn(vars2, k)
    y2k = x2 @ a2k
    spec2 = SolverSpec(method="bakp_fused", thr=thr2, rtol=1e-7, max_iter=100)
    check(not fused_fits(vars2, obs2, k, 4, max_iter=spec2.max_iter),
          "phase 2 design must be over the fused budget")
    p2 = prepare(x2, spec2)
    x2t, inv2 = p2.x_t_for(thr2), p2.inv_cn_for(thr2)
    request("kernel_entry", "solvebakp_kernel",
            lambda: solvebakp_kernel(x2t, y2k, inv_cn=inv2, block=thr2,
                                     max_iter=100, rtol=1e-7),
            a2k, "persweep")
    request("handle_over_budget", "bakp_fused", lambda: p2.solve(y2k), a2k,
            "xla")
    check(fallback_counts().get(("bakp_fused", "vmem"), 0) >= 1,
          "bakp_fused over budget must record reason=vmem")
    request("kernel_entry", "solvebakp_kernel(bak)",
            lambda: solvebakp_kernel(x2t, y2k, inv_cn=inv2, block=thr2,
                                     max_iter=100, rtol=1e-7, variant="bak"),
            a2k, "persweep")
    spec2b = SolverSpec(method="bak_fused", thr=thr2, rtol=1e-7,
                        max_iter=100)
    request("handle_over_budget", "bak_fused",
            lambda: p2.solve(y2k, spec=spec2b), a2k, "xla")
    check(fallback_counts().get(("bak_fused", "vmem"), 0) >= 1,
          "bak_fused over budget must record reason=vmem")

    # Phase 2, the streamed-obs entries on the same design: SolveBakF
    # scores of all 1,024 features, and a rank-256 residual correction of
    # k=8 residuals.  Each is held to its plain version on the same inputs.
    e_sc = randn(obs2)
    e8 = randn(k, obs2)
    da_bu = randn(thr2, k)
    x2blk = x2t[:thr2]
    inv2_raw = safe_inv(column_norms_sq_t(x2t))
    sync()
    t = time.perf_counter()
    scores = score_features_kernel(x2t, e_sc)
    e8_new = block_update_kernel(x2blk, e8, da_bu)
    sync()
    entry_ms = (time.perf_counter() - t) * 1e3
    err_sc = rel(scores, score_features_plain(x2t, e_sc, inv2_raw))
    err_bu = rel(e8_new, block_update_plain(x2blk, e8, da_bu))
    emit({"phase": "entries", "score_features_rel_err": err_sc,
          "block_update_rel_err": err_bu, "latency_ms": entry_ms})
    check(err_sc <= KERNEL_TOL, f"score_features_kernel: rel err {err_sc}")
    check(err_bu <= KERNEL_TOL, f"block_update_kernel: rel err {err_bu}")

    path_kernels = {
        "phases_1_2": ("bakp_sweep", "fused_solve", "bak_sweep", "bak_fused",
                       "score_features", "block_update"),
        "phase_3_stream": ("stream_solve",),
        "phase_4_precision": tuple(_build.launch_key(n, 2)
                                   for n in _build.X_KERNELS),
        "phase_5_serving": ("fused_solve", "fused_solve_bf16", "bak_fused",
                            "stream_solve"),
        "phase_6_store": ("fused_solve",),
        "phase_8_lm": ("stream_solve",)}
    # Launches per kernel, summed over the paths that list it.
    launches = {}

    def read_launches(path):
        counts = {**_build.launch_counts(), **_build.launch_counts(2)}
        emit({"phase": "main_path_launches", "path": path, **counts,
              "plans": {n: p._asdict() for n, p in _build.PLANS.items()}})
        for name in path_kernels[path]:
            launches[name] = launches.get(name, 0) + counts[name]
            check(counts[name] > 0,
                  f"kernel {name} was not launched on its path {path}")

    read_launches("phases_1_2")
    # The handle's bak_fused solves ran on one cluster, the per-sweep loop's
    # bak_sweep launches at phase 2 on several.
    for name, want in (("bak_fused", "single_cluster"),
                       ("bak_sweep", "multi_cluster"),
                       ("bakp_sweep", "multi_cluster")):
        check(_build.PLANS[name].regime == want,
              f"main path {name}: regime {_build.PLANS[name].regime}, "
              f"want {want}")

    # ------------------------------------------- the streaming path
    _build.reset_launch_counts()

    # Phase 3: the handle on the streaming kernel, a design 6.4x the fused
    # budget (obs / vars = 4 keeps it well conditioned for COEF_TOL).
    obs3, vars3, thr3 = 16_384, 4_096, 128
    x3 = randn(obs3, vars3)
    a3 = randn(vars3)
    a3k = randn(vars3, k)
    y3, y3k = x3 @ a3, x3 @ a3k
    spec3 = SolverSpec(method="bakp_stream", thr=thr3, rtol=1e-7,
                       max_iter=100)
    check(not fused_fits(vars3, obs3, k, 4, max_iter=spec3.max_iter),
          "phase 3 design must be over the fused budget")
    check(stream_fits(vars3, obs3, k, 4, block=thr3),
          "phase 3 design must fit the streaming kernel")
    p3 = prepare(x3, spec3)
    request("stream_handle", "bakp_stream", lambda: p3.solve(y3), a3,
            "stream")
    request("stream_handle_k8", "bakp_stream", lambda: p3.solve(y3k), a3k,
            "stream")
    cold3 = request("stream_tenant_cold", "bakp_stream",
                    lambda: p3.solve(y3, tenant_id="tenant-2"), a3, "stream")
    a3d = a3 + 0.01 * randn(vars3)
    y3d = x3 @ a3d
    warm3 = request("stream_tenant_warm", "bakp_stream",
                    lambda: p3.solve(y3d, tenant_id="tenant-2"), a3d,
                    "stream")
    check(int(warm3.n_sweeps) < int(cold3.n_sweeps),
          f"bakp_stream warm solve took {int(warm3.n_sweeps)} sweeps, cold "
          f"{int(cold3.n_sweeps)}")
    vmem_before = fallback_counts().get(("bakp_fused", "vmem"), 0)
    request("stream_handle_over_budget", "bakp_fused",
            lambda: p3.solve(y3, spec=spec3.replace(method="bakp_fused")),
            a3, "xla")
    check(fallback_counts().get(("bakp_fused", "vmem"), 0) == vmem_before + 1,
          "bakp_fused over budget on the phase 3 handle must record "
          "reason=vmem")

    # Phase 3, the streaming entry on the phase 2 design: L = 2,016 obs per
    # CTA makes a thr 256 tile ring 4 MB, over a CTA's shared memory.
    check(not stream_fits(vars2, obs2, k, 4, block=thr2),
          "phase 2 design must be over the streaming kernel's ring")
    vmem_before = fallback_counts().get(("bakp", "vmem"), 0)
    request("stream_entry", "solvebakp_stream_kernel",
            lambda: solvebakp_stream_kernel(x2t, y2k, inv_cn=inv2,
                                            block=thr2, max_iter=100,
                                            rtol=1e-7),
            a2k, "persweep")
    check(fallback_counts().get(("bakp", "vmem"), 0) == vmem_before + 1,
          "solvebakp_stream_kernel over the ring must record reason=vmem")

    # Phase 3, a non-resident handle: x3 stays in pinned host memory and
    # the host-block loop copies one tile at a time on a side stream.
    h3 = prepared_from_arrays(x3, resident=False, spec=spec3,
                              fingerprint="phase3-host")
    check(not h3.resident and h3.blocks.block_t(thr3, 0).is_pinned(),
          "the non-resident handle must read a pinned host copy")
    cold_h = request("stream_host_tenant_cold", "bakp_stream",
                     lambda: h3.solve(y3, tenant_id="tenant-3"), a3,
                     "stream_host")
    warm_h = request("stream_host_tenant_warm", "bakp_stream",
                     lambda: h3.solve(y3d, tenant_id="tenant-3"), a3d,
                     "stream_host")
    check(int(warm_h.n_sweeps) < int(cold_h.n_sweeps),
          f"stream_host warm solve took {int(warm_h.n_sweeps)} sweeps, cold "
          f"{int(cold_h.n_sweeps)}")
    try:
        h3.solve(y3, spec=spec3.replace(method="bakp_fused"))
        check(False, "bakp_fused on a non-resident handle must raise")
    except UnsupportedSpecError:
        pass
    read_launches("phase_3_stream")
    plan3 = _build.PLANS["stream_solve"]
    check(plan3.regime == "multi_cluster" and plan3.clusters > 1,
          f"phase 3 stream_solve must run on several clusters, ran {plan3}")

    # One plain pinned host-to-device copy of the whole design, the rate
    # the host-block loop is held to.
    x3_host = host_copy(x3.T, pin=True)
    x3_dev = torch.empty_like(x3_host, device=dev)
    h2d = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x3_dev.copy_(x3_host, non_blocking=True)
        end.record()
        sync()
        h2d.append(start.elapsed_time(end))
    nbytes3 = x3_host.numel() * 4
    emit({"phase": "stream_host_rate", "bytes": nbytes3,
          "s_per_sweep_cold": latency_ms["stream_host_tenant_cold",
                                         "bakp_stream"]
          / 1e3 / int(cold_h.n_sweeps),
          "s_per_sweep_warm": latency_ms["stream_host_tenant_warm",
                                         "bakp_stream"]
          / 1e3 / int(warm_h.n_sweeps),
          "h2d_pinned_ms": h2d, "h2d_pinned_gb_per_s":
          nbytes3 / (min(h2d) / 1e3) / 1e9})
    del x3_dev

    # ---------------------------------------- the mixed-precision path
    _build.reset_launch_counts()
    # The plan each bf16 kernel ran on this path, by (kernel, case): the
    # kernel rows below are held to the same plans.
    path_plans = {}

    def record_plan(name, case):
        path_plans[name, case] = _build.PLANS[name]._asdict()

    def precision_request(name, method, precision, fn, ref, tol, want_path,
                          want_len=None, truth=None):
        """A bf16 / bf16_fp32acc request against the fp32 solve ``ref``
        (max |coef - ref| <= ``tol``, as JAX's test_precision) and its
        path.  The request runs twice: the first call's latency carries the
        set-up of a precision or shape first seen (the quantized copy, plan
        queries, exchange words), the second is the one a repeat request
        pays; the checks read the second."""
        sync()
        t = time.perf_counter()
        fn()
        sync()
        first_ms = (time.perf_counter() - t) * 1e3
        consume_dispatch()
        t = time.perf_counter()
        res = fn()
        sync()
        ms = (time.perf_counter() - t) * 1e3
        path = consume_dispatch()
        err = (res.coef - ref).abs().max().item()
        row = {"phase": name, "method": method, "precision": precision,
               "path": path, "n_sweeps": int(res.n_sweeps),
               "history_len": int(res.history.shape[0]),
               "first_latency_ms": first_ms, "latency_ms": ms,
               "max_abs_err_vs_fp32": err}
        if truth is not None:
            row["max_rel_err"] = rel(res.coef, truth)
        emit(row)
        check(err <= tol, f"{name}/{method}/{precision}: max |coef - fp32 "
                          f"coef| {err} over {tol}")
        check(path == want_path, f"{name}/{method}/{precision}: path {path}, "
                                 f"want {want_path}")
        if want_len is not None:
            check(int(res.history.shape[0]) == want_len,
                  f"{name}/{method}/{precision}: history length "
                  f"{int(res.history.shape[0])}, want {want_len}")
        check(bool(torch.isfinite(res.coef).all()
                   and torch.isfinite(res.residual).all()),
              f"{name}/{method}/{precision}: non-finite result")
        return res

    # Phase 4a: phase 1's handle at bf16 and bf16_fp32acc, k 1 and 8.
    refine = 8
    for ktag, yy, truth in (("k1", y1, a1), ("k8", y1k, a1k)):
        for method in ("bakp_fused", "bak_fused"):
            sp = spec1.replace(method=method)
            r32 = p1.solve(yy, spec=sp)
            consume_dispatch()
            precision_request(
                f"precision_p1_{ktag}", method, "bf16",
                lambda: p1.solve(yy, spec=sp.replace(precision="bf16")),
                r32.coef, 1e-2, "fused", truth=truth)
            kname = ("fused_solve_bf16" if method == "bakp_fused"
                     else "bak_fused_bf16")
            record_plan(kname, f"phase1_{ktag}")
            if method == "bakp_fused":
                plan = _build.PLANS[kname]
                check(plan.x_in == "shared",
                      f"phase 4 p1 {ktag} bf16 bakp_fused: x_in {plan.x_in}, "
                      f"want shared")
            precision_request(
                f"precision_p1_{ktag}", method, "bf16_fp32acc",
                lambda: p1.solve(yy, spec=sp.replace(
                    precision="bf16_fp32acc", refine_sweeps=refine)),
                r32.coef, 1e-5, "fused", want_len=sp.max_iter + refine,
                truth=truth)

    # Phase 4b: 16,384 x 512, k 8: x_l2 (the ring) at fp32, its bf16 slice
    # (512 x 2 B x L 160) fits a CTA: x_shared on the plan the launch used.
    x4w = randn(obs1, 2 * vars1)
    a4w = randn(2 * vars1, k)
    y4w = x4w @ a4w
    p4w = prepare(x4w, spec1.replace(precision="bf16"))
    r32 = p4w.solve(y4w, spec=spec1)
    plan32 = _build.PLANS["fused_solve"]
    precision_request("precision_16384x512_k8", "bakp_fused", "bf16",
                      lambda: p4w.solve(y4w), r32.coef, 1e-2, "fused",
                      truth=a4w)
    plan16 = _build.PLANS["fused_solve_bf16"]
    record_plan("fused_solve_bf16", "16384x512_k8")
    emit({"phase": "precision_plan_16384x512", "fp32": plan32._asdict(),
          "bf16": plan16._asdict()})
    check(plan32.x_in == "ring" and plan16.x_in == "shared",
          f"16,384 x 512 k 8: x_in fp32 {plan32.x_in} (want ring), bf16 "
          f"{plan16.x_in} (want shared)")

    # Phase 4c: 16,384 x 1,024 (64 MiB fp32, 32 MiB bf16), k 8: fused only
    # at bf16.
    vars4 = 1_024
    x4 = randn(obs1, vars4)
    a4 = randn(vars4, k)
    y4 = x4 @ a4
    check(not fused_fits(vars4, obs1, k, 4, max_iter=spec1.max_iter)
          and fused_fits(vars4, obs1, k, 2, max_iter=spec1.max_iter),
          "16,384 x 1,024 must fit the fused budget at bf16 only")
    p4 = prepare(x4, spec1)
    for method in ("bakp_fused", "bak_fused"):
        sp = spec1.replace(method=method)
        vmem_before = fallback_counts().get((method, "vmem"), 0)
        r32 = request("precision_16384x1024_k8_fp32", method,
                      lambda: p4.solve(y4, spec=sp), a4, "xla")
        check(fallback_counts().get((method, "vmem"), 0) == vmem_before + 1,
              f"{method} fp32 on 16,384 x 1,024 must record reason=vmem")
        precision_request("precision_16384x1024_k8", method, "bf16",
                          lambda: p4.solve(y4, spec=sp.replace(
                              precision="bf16")),
                          r32.coef, 1e-2, "fused", truth=a4)
        record_plan("fused_solve_bf16" if method == "bakp_fused"
                    else "bak_fused_bf16", "16384x1024_k8")
        precision_request("precision_16384x1024_k8", method, "bf16_fp32acc",
                          lambda: p4.solve(y4, spec=sp.replace(
                              precision="bf16_fp32acc",
                              refine_sweeps=refine)),
                          r32.coef, 1e-5, "fused",
                          want_len=sp.max_iter + refine, truth=a4)

    # Phase 4d: phase 3's design (128 MiB at bf16, still over the budget):
    # the per-sweep loop on the bf16 copy, the streaming kernel on it, and
    # the host-block handle, which streams fp32 blocks whatever the
    # precision.
    for ktag, yy, truth in (("k1", y3, a3), ("k8", y3k, a3k)):
        r32 = p3.solve(yy)                        # bakp_stream fp32
        consume_dispatch()
        precision_request(
            f"precision_p3_{ktag}", "bakp_fused", "bf16",
            lambda: p3.solve(yy, spec=spec3.replace(method="bakp_fused",
                                                    precision="bf16")),
            r32.coef, 1e-2, "persweep", truth=truth)
        record_plan("bakp_sweep_bf16", f"phase3_{ktag}")
        precision_request(
            f"precision_p3_{ktag}", "bakp_stream", "bf16",
            lambda: p3.solve(yy, spec=spec3.replace(precision="bf16")),
            r32.coef, 1e-2, "stream", truth=truth)
        record_plan("stream_solve_bf16", f"phase3_{ktag}")
        # Algorithm 1 over 4,096 columns: three sweeps, held to the
        # residual of its own coefficients on the bf16 x.
        consume_dispatch()
        rb = p3.solve(yy, spec=spec3.replace(method="bak_fused", max_iter=3,
                                             precision="bf16"))
        path = consume_dispatch()
        record_plan("bak_sweep_bf16", f"phase3_{ktag}")
        x3b = p3.x_bf16_for(thr3)
        e_re = (yy.reshape(obs3, -1)
                - x3b.float().T @ rb.coef.reshape(vars3, -1))
        err_e = rel(rb.residual.reshape(obs3, -1), e_re, scale=yy)
        hist = rb.history
        emit({"phase": f"precision_p3_{ktag}", "method": "bak_fused",
              "precision": "bf16", "path": path,
              "n_sweeps": int(rb.n_sweeps), "residual_rel_err": err_e,
              "history": hist.tolist()})
        check(path == "persweep", f"p3 {ktag} bak_fused bf16: path {path}")
        check(err_e <= KERNEL_TOL and bool(torch.isfinite(hist).all())
              and bool((hist[1:] <= hist[:-1]).all()),
              f"p3 {ktag} bak_fused bf16: residual err {err_e}, history "
              f"{hist.tolist()}")
        consume_dispatch()
        rh32 = h3.solve(yy)
        rh = h3.solve(yy, spec=spec3.replace(precision="bf16"))
        path = consume_dispatch()
        err_h = rel(rh.coef, rh32.coef)
        emit({"phase": f"precision_p3_{ktag}", "method": "bakp_stream",
              "precision": "bf16", "handle": "non-resident", "path": path,
              "n_sweeps": int(rh.n_sweeps), "rel_err_vs_fp32": err_h,
              "max_rel_err": rel(rh.coef, truth)})
        check(path == "stream_host" and err_h <= 1e-6
              and int(rh.n_sweeps) == int(rh32.n_sweeps),
              f"p3 {ktag} non-resident bf16: path {path}, rel err vs its "
              f"fp32 solve {err_h}")
    emit({"phase": "precision_plans",
          **{f"{n} {case}": pl for (n, case), pl in path_plans.items()}})
    read_launches("phase_4_precision")

    # Phase 4e: benchmarks/solver_precision.py's gates, on the card, at
    # the budget as it stands: its well-conditioned design (singular values
    # in [1, 2]), k 1, rtol = atol = 0 so every sweep in the budget runs
    # and the bytes below are exact.
    def well_conditioned(obs, nv):
        g64 = torch.Generator(device=dev).manual_seed(SEED + nv)
        u = torch.linalg.qr(torch.randn(obs, nv, generator=g64, device=dev,
                                        dtype=torch.float64))[0]
        v = torch.linalg.qr(torch.randn(nv, nv, generator=g64, device=dev,
                                        dtype=torch.float64))[0]
        s_ = torch.linspace(1.0, 2.0, nv, device=dev, dtype=torch.float64)
        return ((u * s_) @ v).float()

    def x_bytes_moved(obs, nv, precision, path, n_lp, n_polish,
                      polish_path):
        """``benchmarks/solver_precision.py::_x_bytes_moved``: x crosses
        device memory once a fused solve, once a sweep otherwise; the
        polish streams fp32."""
        x32, x16 = obs * nv * 4, obs * nv * 2
        lp = x32 if precision == "fp32" else x16
        total = lp if path == "fused" else n_lp * lp
        if n_polish:
            total += x32 if polish_path == "fused" else n_polish * x32
        return total

    gate_rows = []
    for nv, max_iter in ((256, 40), (1_024, 40)):
        xg = well_conditioned(obs1, nv)
        ag = randn(nv)
        yg = xg @ ag
        ref = torch.linalg.lstsq(xg.double(), yg.double()[:, None]).solution[:, 0]
        base = SolverSpec(method="bakp_fused", thr=thr1, max_iter=max_iter,
                          refine_sweeps=refine)
        pg = prepare(xg, base.replace(precision="bf16"))
        polish_path = ("fused" if fused_fits(nv, obs1, 1, 4, max_iter=refine)
                       else "persweep")
        row = {"obs": obs1, "vars": nv, "thr": thr1, "max_iter": max_iter,
               "refine_sweeps": refine}
        for precision in ("fp32", "bf16", "bf16_fp32acc"):
            consume_dispatch()
            res = pg.solve(yg, spec=base.replace(precision=precision))
            sync()
            path = consume_dispatch()
            n_pol = refine if precision == "bf16_fp32acc" else 0
            coef = res.coef.double()
            row[precision] = {
                "path": path, "n_sweeps": int(res.n_sweeps),
                "x_bytes_moved": x_bytes_moved(
                    obs1, nv, precision, path, int(res.n_sweeps) - n_pol,
                    n_pol, polish_path),
                "mape_vs_lstsq": float((coef - ref).abs().sum()
                                       / ref.abs().sum())}
        row["bf16acc_bytes_ratio_vs_fp32"] = (
            row["bf16_fp32acc"]["x_bytes_moved"]
            / row["fp32"]["x_bytes_moved"])
        emit({"phase": "precision_gates_design", **row})
        gate_rows.append(row)
        del pg, xg
    worst_mape = max(r["bf16_fp32acc"]["mape_vs_lstsq"] for r in gate_rows)
    # The bytes gate is the benchmark's for its two regimes, where the fp32
    # solve leaves the chip (x once a sweep); where fp32 runs fused too, x
    # crosses once in both and the polish adds an fp32 pass (1.5x).
    off_chip = [r for r in gate_rows if r["fp32"]["path"] != "fused"]
    worst_ratio = max(r["bf16acc_bytes_ratio_vs_fp32"] for r in off_chip)
    only16 = any(r["bf16"]["path"] == "fused" and r["fp32"]["path"] != "fused"
                 for r in gate_rows)
    jax_gates = json.loads((src.parent / "BENCH_precision.json").read_text(
        ))["precision_gates"]
    emit({"phase": "precision_gates", "mape_pass": worst_mape <= 1e-4,
          "worst_post_refine_mape": worst_mape,
          "bytes_pass": worst_ratio < 0.6,
          "worst_bf16acc_bytes_ratio_off_chip": worst_ratio,
          "bf16acc_bytes_ratio_by_vars": {
              r["vars"]: r["bf16acc_bytes_ratio_vs_fp32"] for r in gate_rows},
          "bf16_only_fused_dispatch_pass": only16,
          "jax_cpu_interpret_figures": {
              "worst_post_refine_mape": jax_gates["worst_post_refine_mape"],
              "worst_bf16acc_bytes_ratio":
                  jax_gates["worst_bf16acc_bytes_ratio"]}})
    check(worst_mape <= 1e-4, f"precision gate: post-refine MAPE {worst_mape}")
    check(worst_ratio < 0.6, f"precision gate: bytes ratio {worst_ratio}")
    check(only16, "precision gate: no design dispatched fused at bf16 only")

    # ------------------------------------------ kernels against plain
    def cuda_ms(fn, iters):
        for _ in range(2):
            fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / iters

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    rows = {}

    held_plans = set()

    def held_to_path_plan(name, label, row, path_case):
        """A kernel row of the precision path must run the plan that path
        ran at the same shape (``path_case``)."""
        if path_case is None:
            return
        want = path_plans.get((name, path_case))
        held_plans.add((name, path_case))
        row["path_case"] = path_case
        check(want is not None and row["plan"] == want,
              f"{name} {label}: plan {row['plan']}, the precision path ran "
              f"{want} ({path_case})")

    def sweep_case(label, x_t, inv, nrhs, block, iters, alg=2,
                   plain_iters=None, path_case=None):
        nv, no = x_t.shape
        e = randn(nrhs, no)
        name = _build.launch_key("bak_sweep" if alg == 1 else "bakp_sweep",
                                 x_t.element_size())

        def kernel():
            if alg == 1:
                return _cd_sweep_cuda(x_t, e, inv)
            return _bakp_sweep_cuda(x_t, e, inv, block=block, omega=1.0)

        def plain_fn():
            if alg == 1:
                return cd_sweep_plain(x_t, e, inv)
            return bakp_sweep_plain(x_t, e, inv, block=block)

        da, e_k = kernel()
        da_p, e_p = plain_fn()
        sync()
        err_da, err_e = rel(da, da_p), rel(e_k, e_p, scale=e)
        tol = BF16_KERNEL_TOL if x_t.element_size() == 2 else KERNEL_TOL
        check(err_da <= tol and err_e <= tol,
              f"{name} {label}: rel err da {err_da}, e {err_e}")
        ms = cuda_ms(kernel, iters)
        plain = cuda_ms(plain_fn, plain_iters or iters)
        nbytes = (x_t.element_size() * nv * no
                  + 4 * (nv + 2 * nrhs * no + nv * nrhs))
        b_ms, b_by = bound(nbytes, 4 * nv * no * nrhs)
        max_abs = max((da - da_p).abs().max().item(),
                      (e_k - e_p).abs().max().item())
        row = {"shape": [nv, no, nrhs, block], "max_abs_err": max_abs,
               "rel_err_da": err_da, "rel_err_e": err_e, "ms": ms,
               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        row["plan"] = _build.PLANS[name]._asdict()
        if alg == 1:
            row["us_per_column"] = ms * 1e3 / nv
        else:
            row["us_per_step"] = ms * 1e3 / (nv // block)
        held_to_path_plan(name, label, row, path_case)
        emit({"phase": "kernel_vs_plain", "kernel": name, "case": label,
              **row})
        return row

    def fused_case(label, x_t, inv, y, block, max_iter, rtol, iters,
                   variant="bakp", plain_iters=None, atol=0.0, rule=False,
                   path_case=None):
        """A whole-solve kernel against its plain version: ``variant``
        "bakp" / "bak" (fused_solve.cu / bak_fused.cu) or "stream"
        (stream_solve.cu, which reads x once per sweep); one solve must be
        one launch.  ``rule``: an rtol stop must also fall within one sweep
        of the rule on the plain iterate's SSE summed in fp64.
        ``path_case``: the plan must be the one the precision path ran."""
        nv, no = x_t.shape
        nrhs = y.shape[1] if y.dim() == 2 else 1
        inv_cn, a0m, e0 = solve_init(x_t, y, inv, None, y.dim() == 2)
        kw = dict(block=block, max_iter=max_iter,
                  atol_sse=atol_to_sse(no, nrhs, atol), rtol=rtol, omega=1.0)
        if variant == "stream":
            name, kernel_fn, plain_fn = ("stream_solve", stream_cuda,
                                         stream_solve_plain)
        else:
            kw["variant"] = variant
            name = "fused_solve" if variant == "bakp" else "bak_fused"
            kernel_fn, plain_fn = fused_cuda, fused_solve_plain
        name = _build.launch_key(name, x_t.element_size())
        n0 = _build.LAUNCHES[name]
        ck, ek, hk, sk, nk, _ = kernel_fn(x_t, inv_cn, e0, a0m, **kw)
        check(_build.LAUNCHES[name] == n0 + 1,
              f"{name} {label}: {_build.LAUNCHES[name] - n0} launches")
        cp, ep, hp, sp, np_, _ = plain_fn(x_t, inv_cn, e0, a0m, **kw)
        sync()
        nk, np_ = int(nk), int(np_)
        err_c, err_e = rel(ck, cp), rel(ek, ep, scale=e0)
        if rtol == 0.0:
            check(nk == np_ and (atol > 0.0 or nk == max_iter),
                  f"{name} {label}: n_sweeps {nk} vs {np_}")
        else:
            check(abs(nk - np_) <= 1,
                  f"{name} {label}: n_sweeps {nk} vs {np_}")
        stop_rule = None
        if rule:
            stop_rule = plain_rtol_stop(
                x_t, inv_cn, e0, block=block, rtol=rtol, max_iter=max_iter,
                variant="bak" if variant == "bak" else "bakp")
            check(stop_rule is not None and abs(nk - stop_rule) <= 1,
                  f"{name} {label}: stopped at {nk}, the rule on the plain "
                  f"iterate's fp64 SSE at {stop_rule}")
        tol = BF16_KERNEL_TOL if x_t.element_size() == 2 else KERNEL_TOL
        check(err_c <= tol and err_e <= tol,
              f"{name} {label}: rel err coef {err_c}, e {err_e}")
        ms = cuda_ms(lambda: kernel_fn(x_t, inv_cn, e0, a0m, **kw), iters)
        plain = cuda_ms(lambda: plain_fn(x_t, inv_cn, e0, a0m, **kw),
                        plain_iters or iters)
        x_reads = nk if variant == "stream" else 1
        nbytes = (x_t.element_size() * x_reads * nv * no
                  + 4 * (nv + 2 * nrhs * no + 2 * nv * nrhs + max_iter))
        b_ms, b_by = bound(nbytes, 4 * nk * nv * no * nrhs)
        max_abs = max((ck - cp).abs().max().item(),
                      (ek - ep).abs().max().item())
        row = {"shape": [nv, no, nrhs, block], "n_sweeps": nk,
               "n_sweeps_plain": np_, "n_sweeps_rule": stop_rule,
               "max_abs_err": max_abs,
               "rel_err_coef": err_c, "rel_err_e": err_e, "ms": ms,
               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        if variant == "bak":
            # A column step's time; the per-sweep SSE step is included.
            row["plan"] = _build.PLANS[name]._asdict()
            row["us_per_column"] = ms * 1e3 / (nk * nv)
        else:
            # A block step's time (every group of right-hand sides); the
            # per-sweep SSE is included.
            row["plan"] = _build.PLANS[name]._asdict()
            row["us_per_step"] = ms * 1e3 / (nk * (nv // block))
        held_to_path_plan(name, label, row, path_case)
        emit({"phase": "kernel_vs_plain", "kernel": name, "case": label,
              **row})
        return row

    def entry_case(name, kernel, plain_fn, library, library_label, nbytes,
                   flops, iters, shape):
        """A streamed-obs kernel against its plain version and the nearest
        single PyTorch call (timed only; the port never calls it)."""
        out_k, out_p = kernel(), plain_fn()
        sync()
        err = rel(out_k, out_p)
        check(err <= KERNEL_TOL, f"{name}: rel err {err}")
        ms = cuda_ms(kernel, iters)
        plain = cuda_ms(plain_fn, iters)
        lib = cuda_ms(library, iters)
        b_ms, b_by = bound(nbytes, flops)
        row = {"shape": shape, "max_abs_err": (out_k - out_p).abs().max()
               .item(), "rel_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
               "library_call": library_label}
        emit({"phase": "kernel_vs_plain", "kernel": name, "case": "phase2",
              **row})
        return row

    x1t, inv1 = p1.x_t_for(thr1), p1.inv_cn_for(thr1)
    sweep_case("phase1_k8", x1t, inv1, k, thr1, 20)
    sweep_case("phase1_k1", x1t, inv1, 1, thr1, 20)
    rows["bakp_sweep"] = sweep_case("phase2_k8", x2t, inv2, k, thr2, 10)
    fused_case("phase1_k1_fixed20", x1t, inv1, y1 + 0.1 * randn(obs1), thr1,
               20, 0.0, 10)
    rows["fused_solve"] = fused_case("phase1_k8_fixed20", x1t, inv1,
                                     y1k + 0.1 * randn(obs1, k), thr1, 20,
                                     0.0, 10)
    fused_case("phase1_k8_rtol", x1t, inv1, y1k, thr1, 100, 1e-7, 5)
    # Same design and work at half the block width: twice the block steps
    # a sweep.
    fused_case("phase1_k1_thr64_fixed20", p1.x_t_for(64), p1.inv_cn_for(64),
               y1 + 0.1 * randn(obs1), 64, 20, 0.0, 10)
    # A 16,384 x 512 design (32 MiB, within the fused budget): no CTA can
    # keep its slice of x, so each block's tile comes from the L2 through
    # the two-stage ring (x_l2).
    x1w = randn(obs1, 2 * vars1)
    x1wt = x1w.T.contiguous()
    inv1w = safe_inv(column_norms_sq_t(x1wt))
    check(fused_fits(2 * vars1, obs1, k, 4, max_iter=20),
          "the 16,384 x 512 design must fit the fused budget")
    wide = fused_case("phase1w_k8_fixed20", x1wt, inv1w,
                      x1w @ randn(2 * vars1, k) + 0.1 * randn(obs1, k), thr1,
                      20, 0.0, 10)
    check(wide["plan"]["x_in"] == "ring",
          f"16,384 x 512 fused_solve: x_in {wide['plan']['x_in']}, want ring")
    del x1w, x1wt
    # Block 256 at k 64: one exchange of all 64 right-hand sides does not
    # fit a CTA beside the slices, so a block step runs them in groups.
    g64 = fused_case("phase1_k64_thr256_fixed20", p1.x_t_for(256),
                     p1.inv_cn_for(256), x1 @ randn(vars1, 64)
                     + 0.1 * randn(obs1, 64), 256, 20, 0.0, 5)
    check(1 < g64["plan"]["group"] < 64,
          f"block 256, k 64 fused_solve: group {g64['plan']['group']}")
    for row in (rows["fused_solve"], g64):
        check(row["plan"]["x_in"] == "shared",
              f"phase 1 fused_solve: x_in {row['plan']['x_in']}, want shared")

    # Algorithm 1: one sweep at the phase shapes, the whole solve at a
    # fixed 20 sweeps (n_sweeps must match) and to rtol 1e-7.  The plain
    # versions loop over columns from the host, so they run few times.
    # Phase 1 must run in the single-cluster regime and phase 2 in the
    # multi-cluster one, so this run times each.
    y1n, y1kn = y1 + 0.1 * randn(obs1), y1k + 0.1 * randn(obs1, k)
    a1_rows = {
        "bak_sweep phase1_k1": sweep_case("phase1_k1", x1t, inv1, 1, thr1,
                                          20, alg=1, plain_iters=3),
        "bak_sweep phase1_k8": sweep_case("phase1_k8", x1t, inv1, k, thr1,
                                          20, alg=1, plain_iters=3),
        "bak_sweep phase2_k8": sweep_case("phase2_k8", x2t, inv2, k, thr2, 5,
                                          alg=1, plain_iters=2),
        "bak_fused phase1_k1_fixed20": fused_case(
            "phase1_k1_fixed20", x1t, inv1, y1n, thr1, 20, 0.0, 5,
            variant="bak", plain_iters=2),
        "bak_fused phase1_k8_fixed20": fused_case(
            "phase1_k8_fixed20", x1t, inv1, y1kn, thr1, 20, 0.0, 5,
            variant="bak", plain_iters=2),
        "bak_fused phase1_k8_rtol": fused_case(
            "phase1_k8_rtol", x1t, inv1, y1k, thr1, 100, 1e-7, 5,
            variant="bak", plain_iters=2)}
    rows["bak_sweep"] = a1_rows["bak_sweep phase2_k8"]
    rows["bak_fused"] = a1_rows["bak_fused phase1_k8_fixed20"]
    for label, row in a1_rows.items():
        want = "multi_cluster" if "phase2" in label else "single_cluster"
        check(row["plan"]["regime"] == want,
              f"{label}: regime {row['plan']['regime']}, want {want}")

    # The cluster size of the Algorithm-1 kernels: each of 2, 4, 8, 16 at
    # the phase 1 shapes (one cluster) and at phase 2 k 8 (several), every
    # launch held to its plain version.  cd_sweep.BAK_CLUSTER is the rule.
    cd_mod = importlib.import_module("repro_torch.kernels.cd_sweep")
    rule = cd_mod.BAK_CLUSTER
    e1k, e2k = randn(k, obs1), randn(k, obs2)
    sweep_in = {"bak_sweep phase1_k8": (x1t, e1k, inv1),
                "bak_sweep phase2_k8": (x2t, e2k, inv2)}
    fused_in = {"bak_fused phase1_k1_fixed20": y1n,
                "bak_fused phase1_k8_fixed20": y1kn}
    plain_out = {lab: cd_sweep_plain(*args) for lab, args in sweep_in.items()}
    fused_ops = {}
    for lab, yy in fused_in.items():
        inv_cn, a0m, e0 = solve_init(x1t, yy, inv1, None, yy.dim() == 2)
        fused_ops[lab] = (inv_cn, e0, a0m)
        plain_out[lab] = fused_solve_plain(
            x1t, *fused_ops[lab], block=thr1, max_iter=20, atol_sse=0.0,
            rtol=0.0, omega=1.0, variant="bak")[:2]
    for csize in (2, 4, 8, 16):
        cd_mod.BAK_CLUSTER = csize
        for lab in (*sweep_in, *fused_in):
            if lab in sweep_in:
                x_t, e_in, inv = sweep_in[lab]
                fn = (lambda x_t=x_t, inv=inv, e_in=e_in:
                      _cd_sweep_cuda(x_t, e_in, inv))
                name, cols, scale = "bak_sweep", x_t.shape[0], e_in
            else:
                ops = fused_ops[lab]
                fn = (lambda ops=ops: fused_cuda(
                    x1t, *ops, block=thr1, max_iter=20, atol_sse=0.0,
                    rtol=0.0, omega=1.0, variant="bak"))
                name, cols, scale = "bak_fused", 20 * vars1, ops[1]
            out = fn()
            sync()
            err = max(rel(out[0], plain_out[lab][0]),
                      rel(out[1], plain_out[lab][1], scale=scale))
            check(err <= KERNEL_TOL,
                  f"{lab} cluster {csize}: rel err {err}")
            ms = cuda_ms(fn, 5 if "phase2" in lab else 10)
            emit({"phase": "bak_cluster_sweep", "case": lab,
                  "cluster": csize, "plan": _build.PLANS[name]._asdict(),
                  "rel_err": err, "ms": ms, "us_per_column": ms * 1e3 / cols})
    cd_mod.BAK_CLUSTER = rule

    # The streamed-obs entries at the phase 2 shapes, full fp32 throughout
    # (TF32 is off above, so torch.mv / torch.addmm run in fp32 too).
    rows["score_features"] = entry_case(
        "score_features",
        lambda: _score_features_cuda(x2t, e_sc, inv2_raw),
        lambda: score_features_plain(x2t, e_sc, inv2_raw),
        lambda: torch.mv(x2t, e_sc), "torch.mv(x_t, e): the matvec alone, "
        "without the square-and-scale epilogue",
        4 * (vars2 * obs2 + obs2 + 2 * vars2), 2 * vars2 * obs2 + 2 * vars2,
        20, [vars2, obs2])
    rows["block_update"] = entry_case(
        "block_update",
        lambda: _block_update_cuda(x2blk, e8, da_bu),
        lambda: block_update_plain(x2blk, e8, da_bu),
        lambda: torch.addmm(e8, da_bu.T, x2blk, alpha=-1),
        "torch.addmm(e, da.T, x_blk, alpha=-1): the same function",
        4 * (thr2 * obs2 + 2 * k * obs2 + thr2 * k), 2 * thr2 * obs2 * k,
        20, [thr2, obs2, k])

    # The streaming kernel on the phase 3 design: 20 fixed sweeps at k 1 and
    # k 8, and to rtol 1e-7.  Beside it, as a finding, the per-sweep loop.
    x3t, inv3 = p3.x_t_for(thr3), p3.inv_cn_for(thr3)
    y3n = y3 + 0.1 * randn(obs3)
    y3kn = y3k + 0.1 * randn(obs3, k)
    stream_rows = {
        1: fused_case("phase3_k1_fixed20", x3t, inv3, y3n, thr3, 20, 0.0, 10,
                      variant="stream", plain_iters=3),
        k: fused_case("phase3_k8_fixed20", x3t, inv3, y3kn, thr3, 20, 0.0,
                      10, variant="stream", plain_iters=3)}
    rows["stream_solve"] = stream_rows[k]
    fused_case("phase3_k8_rtol", x3t, inv3, y3k, thr3, 100, 1e-7, 3,
               variant="stream", plain_iters=2)
    # k 1 to rtol 1e-7 on the noise-free system: the stop falls where the
    # SSE reaches the residual's fp32 floor (tools/stop_witness.py).
    fused_case("phase3_k1_rtol", x3t, inv3, y3, thr3, 100, 1e-7, 3,
               variant="stream", plain_iters=2)
    # The per-sweep kernel at the phase 3 shape, the per-sweep loop's
    # launch on phase 3's path.
    sweep_case("phase3_k8", x3t, inv3, k, thr3, 10, plain_iters=3)
    for label, row in stream_rows.items():
        check(row["plan"]["regime"] == "multi_cluster",
              f"stream_solve phase3 k {label}: regime {row['plan']['regime']}")

    # The cluster size of the Algorithm-2 cluster kernels: 4, 8 and 16 at
    # the phase 1 (the fused solve), 2 and 3 shapes, every launch held to
    # its plain version; cd_sweep.BAKP_CLUSTER holds each kernel's rule.
    rule2 = dict(cd_mod.BAKP_CLUSTER)
    a2_in = {"bakp_sweep phase2_k8": (x2t, e2k, inv2, thr2),
             "bakp_sweep phase3_k8": (x3t, randn(k, obs3), inv3, thr3)}
    a2_plain = {lab: bakp_sweep_plain(x_t, e_in, inv, block=blk)
                for lab, (x_t, e_in, inv, blk) in a2_in.items()}
    # Whole solves, 20 fixed sweeps: (kernel, plain, x_t, block, operands).
    s_ops = {}
    for lab, solver, plain_fn, x_t, inv, blk, yy in (
            ("fused_solve phase1_k1_fixed20", fused_cuda, fused_solve_plain,
             x1t, inv1, thr1, y1 + 0.1 * randn(obs1)),
            ("fused_solve phase1_k8_fixed20", fused_cuda, fused_solve_plain,
             x1t, inv1, thr1, y1k + 0.1 * randn(obs1, k)),
            ("stream_solve phase3_k1_fixed20", stream_cuda,
             stream_solve_plain, x3t, inv3, thr3, y3n),
            ("stream_solve phase3_k8_fixed20", stream_cuda,
             stream_solve_plain, x3t, inv3, thr3, y3kn)):
        inv_cn, a0m, e0 = solve_init(x_t, yy, inv, None, yy.dim() == 2)
        s_ops[lab] = (solver, x_t, blk, (inv_cn, e0, a0m))
        a2_plain[lab] = plain_fn(
            x_t, inv_cn, e0, a0m, block=blk, max_iter=20, atol_sse=0.0,
            rtol=0.0, omega=1.0)[:2]
    for csize in (4, 8, 16):
        cd_mod.BAKP_CLUSTER.update(stream=csize, sweep=csize, fused=csize)
        for lab in (*a2_in, *s_ops):
            if lab in a2_in:
                x_t, e_in, inv, blk = a2_in[lab]
                fn = (lambda x_t=x_t, e_in=e_in, inv=inv, blk=blk:
                      _bakp_sweep_cuda(x_t, e_in, inv, block=blk, omega=1.0))
                name, steps, scale = "bakp_sweep", x_t.shape[0] // blk, e_in
            else:
                solver, x_t, blk, ops = s_ops[lab]
                fn = (lambda solver=solver, x_t=x_t, blk=blk, ops=ops: solver(
                    x_t, *ops, block=blk, max_iter=20, atol_sse=0.0,
                    rtol=0.0, omega=1.0))
                name = lab.split()[0]
                steps, scale = 20 * (x_t.shape[0] // blk), ops[1]
            out = fn()
            sync()
            err = max(rel(out[0], a2_plain[lab][0]),
                      rel(out[1], a2_plain[lab][1], scale=scale))
            check(err <= KERNEL_TOL, f"{lab} cluster {csize}: rel err {err}")
            ms = cuda_ms(fn, 10 if name == "fused_solve" else 3)
            emit({"phase": "bakp_cluster_sweep", "case": lab,
                  "cluster": csize, "plan": _build.PLANS[name]._asdict(),
                  "rel_err": err, "ms": ms, "us_per_step": ms * 1e3 / steps})
    cd_mod.BAKP_CLUSTER.update(rule2)
    for label, yy in (("phase3_k1_fixed20", y3n), ("phase3_k8_fixed20", y3kn)):
        nrhs = yy.shape[1] if yy.dim() == 2 else 1
        persweep_ms = cuda_ms(lambda: solvebakp_persweep_kernel(
            x3t, yy, inv_cn=inv3, block=thr3, max_iter=20), 3)
        emit({"phase": "stream_findings", "case": label, "k": nrhs,
              "persweep_loop_ms": persweep_ms,
              "stream_solve_ms": stream_rows[nrhs]["ms"]})

    # bf16 x (precision "bf16"): kernels 1, 2, 3, 4 and 7 at the shapes of
    # their fp32 rows and at every shape the precision path gave them, on
    # the handles' bf16 copies, each held to its plain version on the same
    # bf16 tensor and, at a precision-path shape, to the plan that path
    # ran; x counts 2 bytes in the bound.  The rtol stops are also held to
    # the rule on the plain iterate's fp64 SSE, and an atol-only stop must
    # fall on the plain version's sweep.
    x1b, x2b, x3b = (p1.x_bf16_for(thr1), p2.x_bf16_for(thr2),
                     p3.x_bf16_for(thr3))
    x4wb, inv4w = p4w.x_bf16_for(thr1), p4w.inv_cn_for(thr1)
    x4b, inv4 = p4.x_bf16_for(thr1), p4.inv_cn_for(thr1)
    rows["bakp_sweep_bf16"] = sweep_case("phase2_k8", x2b, inv2, k, thr2, 10)
    for ktag, nrhs in (("k1", 1), ("k8", k)):
        sweep_case(f"phase3_{ktag}", x3b, inv3, nrhs, thr3, 10,
                   plain_iters=3, path_case=f"phase3_{ktag}")
    rows["fused_solve_bf16"] = fused_case(
        "phase1_k8_fixed20", x1b, inv1, y1k + 0.1 * randn(obs1, k), thr1,
        20, 0.0, 10, path_case="phase1_k8")
    fused_case("phase1_k1_fixed20", x1b, inv1, y1 + 0.1 * randn(obs1), thr1,
               20, 0.0, 10, path_case="phase1_k1")
    fused_case("phase1_k8_rtol", x1b, inv1, y1k, thr1, 100, 1e-7, 5,
               rule=True)
    # The noise (0.1) and bf16's rounding of x hold the RMSE near 0.104.
    fused_case("phase1_k8_atol", x1b, inv1, y1kn, thr1, 100, 0.0, 5,
               atol=0.12)
    # 16,384 x 512 (x's bf16 slice in shared memory) and 16,384 x 1,024
    # (fused at bf16 only), as the precision path ran them.
    fused_case("16384x512_k8_fixed20", x4wb, inv4w,
               y4w + 0.1 * randn(obs1, k), thr1, 20, 0.0, 10,
               path_case="16384x512_k8")
    y4n = y4 + 0.1 * randn(obs1, k)
    fused_case("16384x1024_k8_fixed20", x4b, inv4, y4n, thr1, 20, 0.0, 10,
               path_case="16384x1024_k8")
    rows["bak_sweep_bf16"] = sweep_case("phase2_k8", x2b, inv2, k, thr2, 5,
                                        alg=1, plain_iters=2)
    # Algorithm 1 over phase 3's 4,096 columns: the plain version loops
    # over them from the host, so it runs once after its warm-ups.
    for ktag, nrhs in (("k1", 1), ("k8", k)):
        sweep_case(f"phase3_{ktag}", x3b, inv3, nrhs, thr3, 3, alg=1,
                   plain_iters=1, path_case=f"phase3_{ktag}")
    rows["bak_fused_bf16"] = fused_case(
        "phase1_k8_fixed20", x1b, inv1, y1kn, thr1, 20, 0.0, 5,
        variant="bak", plain_iters=2, path_case="phase1_k8")
    fused_case("phase1_k1_fixed20", x1b, inv1, y1n, thr1, 20, 0.0, 5,
               variant="bak", plain_iters=2, path_case="phase1_k1")
    fused_case("phase1_k8_rtol", x1b, inv1, y1k, thr1, 100, 1e-7, 5,
               variant="bak", plain_iters=2, rule=True)
    fused_case("16384x1024_k8_fixed5", x4b, inv4, y4n, thr1, 5, 0.0, 3,
               variant="bak", plain_iters=1, path_case="16384x1024_k8")
    del p4w, x4w, x4wb, p4, x4, x4b
    rows["stream_solve_bf16"] = fused_case(
        "phase3_k8_fixed20", x3b, inv3, y3kn, thr3, 20, 0.0, 10,
        variant="stream", plain_iters=3, path_case="phase3_k8")
    fused_case("phase3_k1_fixed20", x3b, inv3, y3n, thr3, 20, 0.0, 10,
               variant="stream", plain_iters=3, path_case="phase3_k1")
    fused_case("phase3_k8_rtol", x3b, inv3, y3k, thr3, 100, 1e-7, 3,
               variant="stream", plain_iters=2, rule=True)
    for name in ("fused_solve_bf16", "bak_fused_bf16"):
        check(rows[name]["plan"]["regime"] == "multi_cluster"
              if name == "fused_solve_bf16" else
              rows[name]["plan"]["regime"] == "single_cluster",
              f"{name} phase 1: plan {rows[name]['plan']}")
    check(rows["fused_solve_bf16"]["plan"]["x_in"] == "shared",
          f"fused_solve_bf16 phase 1: x_in "
          f"{rows['fused_solve_bf16']['plan']['x_in']}")
    unheld = set(path_plans) - held_plans
    check(not unheld, f"precision-path plans no kernel row ran: {unheld}")

    # ---------------------------------------- the serving path (phase 5)
    # repro_torch.serve.SolverServeEngine on the card: seven flushes (see
    # the module doc), each with the engine counters and kernel launches it
    # must give, then every served request held to fp64 lstsq and to the
    # port handle's own solve, and the kernels it launched held to their
    # plain versions at its shapes.
    import os
    import threading

    import numpy as np

    from repro_torch import obs as tobs
    from repro_torch.resilience import faults
    from repro_torch.serve import ServeConfig, SolveRequest, SolverServeEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]

    def hung():
        print(f"chip_smoke: phase 5 did not finish in {PHASE5_WATCHDOG_S} s "
              f"(a hang on the serving path)", file=sys.stderr, flush=True)
        os._exit(3)

    watchdog = threading.Timer(PHASE5_WATCHDOG_S, hung)
    watchdog.daemon = True
    watchdog.start()
    t_phase5 = time.perf_counter()
    _build.reset_launch_counts()
    reg5 = tobs.MetricsRegistry()
    tracer = tobs.get_tracer()
    rng5 = np.random.default_rng(SEED + 5)
    obs5, vars5, thr5 = 16_384, 256, 128
    knobs5 = dict(thr=thr5, rtol=1e-7, max_iter=100)
    # Flush 1's traffic: 4 designs, 16 tenants each, planted coefficients.
    x5 = [rng5.standard_normal((obs5, vars5), dtype=np.float32)
          for _ in range(4)]
    a5 = rng5.standard_normal((4, vars5, 16), dtype=np.float32)
    a5d = a5 + 0.01 * rng5.standard_normal(a5.shape, dtype=np.float32)
    y5 = [x5[d] @ a5[d] for d in range(4)]
    y5d = [x5[d] @ a5d[d] for d in range(4)]
    # Flush 3's: 16 designs of 4,096 x 256 (one bakp_gram batch across
    # designs), and 8 bak_fused tenants on one 16,384 x 256 design.
    x5g = [rng5.standard_normal((4_096, vars5), dtype=np.float32)
           for _ in range(16)]
    y5g = [x @ rng5.standard_normal(vars5, dtype=np.float32) for x in x5g]
    x5b = rng5.standard_normal((obs5, vars5), dtype=np.float32)
    y5b = x5b @ rng5.standard_normal((vars5, 8), dtype=np.float32)
    # Flush 4's: 2 tenants on phase 3's 16,384 x 4,096 design.
    y5s = (x3 @ randn(vars3, 2)).cpu().numpy()

    def tenants_requests(ys):
        return [SolveRequest(x=x5[d], y=ys[d][:, t], method="bakp",
                             design_key=f"p5-d{d}",
                             tenant_id=f"p5-d{d}-t{t}", **knobs5)
                for d in range(4) for t in range(16)]

    def flush3_requests():
        return ([SolveRequest(x=x, y=y, method="bakp_gram",
                              design_key=f"p5-g{i}", **knobs5)
                 for i, (x, y) in enumerate(zip(x5g, y5g))]
                + [SolveRequest(x=x5b, y=y5b[:, t], method="bak_fused",
                                design_key="p5-b", **knobs5)
                   for t in range(8)])

    def all_counts():
        return {**_build.launch_counts(), **_build.launch_counts(2)}

    stat_keys = ("multi_rhs_groups", "multi_rhs_requests", "vmap_batches",
                 "vmap_requests", "single_solves", "warm_starts",
                 "failures", "retries")
    served = []     # (flush label, engine, requests, results, a0 used)
    flush_plans = {}

    def serve_flush(label, eng, reqs, want_stats, want_launch):
        # The warm starts the engine will read: each tenant's retained
        # coefficients before this flush (the handle check re-runs with
        # them).
        a0_used = {}
        for r in reqs:
            entry = eng.cache.get(r.design_key, record_stats=False)
            coef = None if entry is None else entry.warm_coef(r.tenant_id)
            if coef is not None:
                a0_used[r.tenant_id] = coef.cpu().numpy()
        stats0 = eng.stats.as_dict()
        counts0 = all_counts()
        tracer.clear()
        t = time.perf_counter()
        out = eng.serve(reqs)
        wall = time.perf_counter() - t
        counts = all_counts()
        d_launch = {n: counts[n] - counts0[n] for n in counts
                    if counts[n] != counts0[n]}
        d_stats = {k: eng.stats.as_dict()[k] - stats0[k] for k in stat_keys}
        split = {}
        for sp in tracer.spans():
            name = sp.name.split(".", 1)[1]
            if name == "solve":
                name = f"solve[{sp.tags.get('lane')}]"
            split[name] = split.get(name, 0.0) + sp.duration_s * 1e3
        ok = [r for r in out if r.error is None]
        emit({"phase": "serve", "flush": label, "card": card,
              "requests": len(reqs), "wall_ms": wall * 1e3,
              "requests_per_s": len(reqs) / wall, "split_ms": split,
              "mean_sweeps": (float(np.mean([r.n_sweeps for r in ok]))
                              if ok else None),
              "launches": d_launch, "stats": d_stats,
              "errors": len(out) - len(ok)})
        check(d_stats == {k: want_stats.get(k, 0) for k in stat_keys},
              f"phase 5 {label}: engine counters {d_stats}, want "
              f"{want_stats}")
        check(d_launch == want_launch,
              f"phase 5 {label}: launches {d_launch}, want {want_launch}")
        for name in d_launch:
            flush_plans[name, label] = _build.PLANS[name]._asdict()
        served.append((label, eng, reqs, out, a0_used))
        return out

    eng = SolverServeEngine(ServeConfig(prefer_fused=True), registry=reg5)
    multi16 = dict(multi_rhs_groups=4, multi_rhs_requests=64)
    f1 = serve_flush("1_cold_coalesced", eng, tenants_requests(y5),
                     multi16, {"fused_solve": 4})
    f2 = serve_flush("2_warm", eng, tenants_requests(y5d),
                     {**multi16, "warm_starts": 64}, {"fused_solve": 4})
    check(all(r.warm_start for r in f2), "phase 5 flush 2: a cold request")
    check(np.mean([r.n_sweeps for r in f2])
          < np.mean([r.n_sweeps for r in f1]),
          "phase 5 flush 2: warm mean sweeps not below flush 1's")
    want3 = dict(multi_rhs_groups=1, multi_rhs_requests=8, vmap_batches=1,
                 vmap_requests=16)
    f3 = serve_flush("3_two_lanes", eng, flush3_requests(), want3,
                     {"bak_fused": 1})
    serve_flush("4_stream", eng,
                [SolveRequest(x=x3, y=torch.from_numpy(y5s[:, t]),
                              method="bakp_stream", design_key="p5-s",
                              **knobs5) for t in range(2)],
                dict(multi_rhs_groups=1, multi_rhs_requests=2),
                {"stream_solve": 1})
    eng.shutdown()
    eng = SolverServeEngine(ServeConfig(precision="bf16_fp32acc",
                                        prefer_fused=True), registry=reg5)
    fb = reg5.counter("solver_fallback_total")
    prec0 = fb.value(reason="precision")
    serve_flush("5_precision", eng,
                tenants_requests(y5) + [SolveRequest(
                    x=x5[0], y=y5[0][:, 0], method="lstsq",
                    design_key="p5-d0")],
                {**multi16, "single_solves": 1},
                {"fused_solve_bf16": 4, "fused_solve": 4})
    check(fb.value(reason="precision") == prec0 + 1,
          "phase 5 flush 5: the lstsq request must count one precision "
          "fallback")
    eng.shutdown()
    # Flush 6: flush 1 through an engine armed with a fault plan.  The
    # fused lane's first work dies with its worker (the engine, as the JAX
    # engine, fails that unit's requests with LaneWorkerDeath and restarts
    # the worker); the next raises in the solver and the retry ladder
    # serves it on the plain "bakp" rung.  The failed group is submitted
    # again, as a client would, and is served.
    plan = {"solver.raise": {"count": 1, "match": "bakp_fused"},
            "lane.worker": {"count": 1, "match": "single:fused"}}
    restarts = reg5.counter("serve_lane_restarts_total")
    r0 = restarts.value(lane="single:fused")
    eng = SolverServeEngine(ServeConfig(prefer_fused=True, fault_plan=plan),
                            registry=reg5)
    f6 = serve_flush("6_faults", eng, tenants_requests(y5),
                     dict(multi_rhs_groups=3, multi_rhs_requests=48,
                          failures=16, retries=1), {"fused_solve": 2})
    dead = [i for i, r in enumerate(f6) if r.error is not None]
    check(len(dead) == 16 and all("LaneWorkerDeath" in f6[i].error
                                  for i in dead),
          f"phase 5 flush 6: {len(dead)} failed requests, want the 16 of "
          f"the unit whose worker died")
    check(restarts.value(lane="single:fused") == r0 + 1,
          "phase 5 flush 6: the fused lane's worker did not restart")
    retried = [r for r in f6 if r.retries]
    check(len(retried) == 16 and all(r.telemetry.kernel_path == "xla"
                                     for r in retried),
          "phase 5 flush 6: the raised group must be served by the ladder")
    again = tenants_requests(y5)
    serve_flush("6_resubmitted", eng, [again[i] for i in dead],
                dict(multi_rhs_groups=1, multi_rhs_requests=16),
                {"fused_solve": 1})
    faults.clear()
    eng.shutdown()
    eng = SolverServeEngine(ServeConfig(prefer_fused=True,
                                        lane_execution=False), registry=reg5)
    f7 = serve_flush("7_serial", eng, flush3_requests(), want3,
                     {"bak_fused": 1})
    eng.shutdown()
    eng = SolverServeEngine(ServeConfig(prefer_fused=True), registry=reg5)
    f8 = serve_flush("8_lanes_again", eng, flush3_requests(), want3,
                     {"bak_fused": 1})
    eng.shutdown()
    for label, fx in (("7", f7), ("8", f8)):
        for a, b in zip(f3, fx):
            check(np.array_equal(a.coef, b.coef)
                  and np.array_equal(a.residual, b.residual)
                  and a.n_sweeps == b.n_sweeps,
                  f"phase 5 flush {label}: {a.request_id} ({a.batch_kind}) "
                  f"differs from flush 3: max |dcoef| "
                  f"{float(np.abs(a.coef - b.coef).max())}")
    check({r.telemetry.lane for r in f3} == {"single:xla", "single:fused"}
          and {r.telemetry.lane for r in f7} == {"serial"}
          and {r.telemetry.lane for r in f8} == {r.telemetry.lane
                                                 for r in f3},
          "phase 5 flushes 3 / 7 / 8: lanes")
    read_launches("phase_5_serving")
    watchdog.cancel()
    main_path_s = time.perf_counter() - t_phase5
    emit({"phase": "serve_registry", "card": card,
          "families": {n: {k: (v if not isinstance(v, dict)
                               else {"count": v["count"], "sum": v["sum"]})
                           for k, v in fam["values"].items()}
                       for n, fam in reg5.snapshot().items()
                       if n.startswith("serve_")}})

    # Every served request: no error, MAPE against fp64 lstsq, and within
    # 1e-5 of the port handle's own solve of the same system under the
    # effective spec (the same stacked y and warm start for a group).
    handles = {}
    worst = {"mape": 0.0, "vs_handle": 0.0}
    n_checked = 0
    for label, eng, reqs, out, a0_used in served:
        groups = {}
        for req, res in zip(reqs, out):
            if res.error is not None:
                check(label == "6_faults", f"phase 5 {label}: "
                      f"{req.request_id} failed: {res.error}")
                continue
            n_checked += 1
            check(bool(np.isfinite(res.coef).all())
                  and res.coef.shape == (req.x.shape[1],),
                  f"phase 5 {label}: {req.request_id} coef")
            groups.setdefault((req.design_key, res.batch_kind,
                               res.telemetry.method), []).append((req, res))
            fused_lane = res.telemetry.method in ("bakp_fused", "bak_fused")
            check(not fused_lane or res.retries > 0
                  or res.telemetry.kernel_path == "fused",
                  f"phase 5 {label}: {req.request_id} on "
                  f"{res.telemetry.method} ran {res.telemetry.kernel_path}")
        for (key, kind, method), members in groups.items():
            x = members[0][0].x
            ys = np.stack([q.y for q, _ in members], 1).astype(np.float32)
            xd = torch.as_tensor(x, device=dev)
            ref = torch.linalg.lstsq(
                xd.double(), torch.as_tensor(ys, device=dev).double()
            ).solution.cpu().numpy()
            coefs = np.stack([r.coef for _, r in members], 1)
            denom = np.maximum(np.abs(ref), 1e-12)
            mape = float(np.max(np.mean(np.abs(coefs - ref) / denom, 0)))
            worst["mape"] = max(worst["mape"], mape)
            check(mape <= 1e-4, f"phase 5 {label} {key}: MAPE vs fp64 "
                                f"lstsq {mape}")
            if key not in handles:
                handles[key] = prepare(xd, device=dev)
            h = handles[key]
            spec = eng.spec_for(members[0][0]).replace(method=method)
            if kind == "multi_rhs":
                k_pad = 1 << (len(members) - 1).bit_length()
                ypad = np.zeros((x.shape[0], k_pad), np.float32)
                ypad[:, :len(members)] = ys
                a0 = None
                if any(q.tenant_id in a0_used for q, _ in members):
                    a0 = np.zeros((x.shape[1], k_pad), np.float32)
                    for c, (q, _) in enumerate(members):
                        if q.tenant_id in a0_used:
                            a0[:, c] = a0_used[q.tenant_id]
                hr = h.solve(ypad, a0, spec=spec)
                hcoef = hr.coef[:, :len(members)].cpu().numpy()
                sweeps_ok = all(r.n_sweeps == int(hr.n_sweeps)
                                for _, r in members)
            else:
                # A single, or one system of a batch across designs: the
                # handle solves it alone (an rtol stop may fall a sweep
                # apart between the batch and a single solve).
                hrs = [h.solve(q.y, spec=spec) for q, _ in members]
                hcoef = np.stack([hr.coef.cpu().numpy() for hr in hrs], 1)
                sweeps_ok = all(abs(r.n_sweeps - int(hr.n_sweeps)) <= 1
                                for (_, r), hr in zip(members, hrs))
            err = float(np.abs(coefs - hcoef).max()
                        / max(1.0, float(np.abs(hcoef).max())))
            worst["vs_handle"] = max(worst["vs_handle"], err)
            check(err <= 1e-5 and sweeps_ok,
                  f"phase 5 {label} {key} {method}: {err} from the handle's "
                  f"own solve (sweeps match: {sweeps_ok})")
    handles.clear()
    emit({"phase": "serve_checks", "card": card,
          "requests_checked": n_checked,
          "worst_mape_vs_fp64_lstsq": worst["mape"],
          "worst_rel_err_vs_handle": worst["vs_handle"],
          "main_path_s": main_path_s})

    # The kernels this path launched, held to their plain versions at its
    # shapes, on the plan the path ran.
    def held5(row, name, flush):
        want = flush_plans.get((name, flush))
        check(want is not None and row["plan"] == want,
              f"phase 5 {name}: kernel row ran {row['plan']}, flush "
              f"{flush} ran {want}")

    h5 = prepare(x5[0], device=dev)
    x5t, inv5 = h5.x_t_for(thr5), h5.inv_cn_for(thr5)
    y16 = torch.from_numpy(y5[0]).to(dev)
    held5(fused_case("phase5_k16_rtol", x5t, inv5, y16, thr5, 100, 1e-7, 5),
          "fused_solve", "1_cold_coalesced")
    held5(fused_case("phase5_k16_rtol", h5.x_bf16_for(thr5), inv5, y16,
                     thr5, 100, 1e-7, 5), "fused_solve_bf16", "5_precision")
    h5b = prepare(x5b, device=dev)
    held5(fused_case("phase5_k8_rtol", h5b.x_t_for(thr5),
                     h5b.inv_cn_for(thr5), torch.from_numpy(y5b).to(dev),
                     thr5, 100, 1e-7, 3, variant="bak", plain_iters=1),
          "bak_fused", "3_two_lanes")
    held5(fused_case("phase5_k2_rtol", x3t, inv3,
                     torch.from_numpy(y5s).to(dev), thr3, 100, 1e-7, 3,
                     variant="stream", plain_iters=1),
          "stream_solve", "4_stream")
    del h5, h5b, x5, x5g, x5b
    emit({"phase": "serve_done", "card": card,
          "seconds": time.perf_counter() - t_phase5})

    # ---------------------- the design store and the dispatcher (phase 6)
    # A fleet of designs whose bytes exceed a device budget behind the
    # tiered DesignStore (device -> pinned host -> CRC-checked disk tiles),
    # an over-budget design on the host-block loop, corrupt tiles
    # quarantined and rebuilt, and the async dispatcher in front (see the
    # module doc).  Launch counts are reset here and read after 6d; the
    # storeless engine, the synchronous run of 6d's trace and 6e are
    # comparisons and checks run after that read.
    import tempfile

    from repro_torch.kernels._build import KernelError
    from repro_torch.kernels.stream_solve import stream_x_resident_bytes
    from repro_torch.serve import AsyncDispatcher, DispatchConfig
    from repro_torch.store import DesignStore
    from repro_torch.store.store import _TILE_HEADER, _entry_device_bytes

    def hung6():
        print(f"chip_smoke: phase 6 did not finish in {PHASE6_WATCHDOG_S} s "
              f"(a hang on the store or dispatcher path)", file=sys.stderr,
              flush=True)
        os._exit(3)

    watchdog = threading.Timer(PHASE6_WATCHDOG_S, hung6)
    watchdog.daemon = True
    watchdog.start()
    t_phase6 = time.perf_counter()
    tiles_root = tempfile.TemporaryDirectory(
        prefix="chip_smoke_store_", dir=Path(__file__).resolve().parent)
    tiles = Path(tiles_root.name)
    obs6, vars6, thr6, ten6, n6 = 16_384, 256, 128, 4, 24
    knobs6 = dict(thr=thr6, rtol=1e-7, max_iter=100)
    # 24 designs of 16 MiB, made on the card from the seed and handed to
    # the engine as host arrays, as a client sends them.
    x6 = [randn(obs6, vars6) for _ in range(n6)]
    a6 = randn(n6, vars6, ten6)
    a6d = a6 + 0.01 * randn(n6, vars6, ten6)
    y6 = [(x6[d] @ a6[d]).cpu().numpy() for d in range(n6)]
    y6d = [(x6[d] @ a6d[d]).cpu().numpy() for d in range(n6)]
    x6 = [x.cpu().numpy() for x in x6]
    probe = prepare(x6[0], SolverSpec(method="bakp_fused", thr=thr6))
    entry_bytes = _entry_device_bytes(probe)
    snap_bytes = probe.x_t_for(thr6).nbytes
    del probe
    budget6 = 4 * entry_bytes
    reg6 = tobs.MetricsRegistry()
    cfg6 = dict(prefer_fused=True, store_device_bytes=budget6,
                store_host_bytes=4 * snap_bytes)
    eng6 = SolverServeEngine(ServeConfig(store_dir=str(tiles / "a"),
                                         **cfg6), registry=reg6)
    st6 = eng6.store
    emit({"phase": "store_config", "card": card, "entry_bytes": entry_bytes,
          "device_budget": budget6, "host_budget": 4 * snap_bytes})

    # Device -> host and host -> disk demotions, timed by wrapping the
    # store's own calls (a device demotion that cascades to disk is
    # counted without the disk write).
    move_s = {"device_to_host": [], "host_to_disk": []}

    def timed_demotions(st):
        demote, to_disk = st.demote, st._demote_to_disk
        nested = []

        def demote_t(key):
            nested.append(0.0)
            t = time.perf_counter()
            out = demote(key)
            move_s["device_to_host"].append(time.perf_counter() - t
                                            - nested.pop())
            return out

        def to_disk_t(key):
            t = time.perf_counter()
            to_disk(key)
            dt = time.perf_counter() - t
            move_s["host_to_disk"].append(dt)
            if nested:
                nested[-1] += dt

        st.demote, st._demote_to_disk = demote_t, to_disk_t

    timed_demotions(st6)
    # Promotions by the thread that ran them (6d: the dispatch thread).
    promo_threads = {}
    promote6 = st6.promote

    def promote_counted(key):
        with st6._lock:
            before = (st6.stats.promotions_host, st6.stats.promotions_disk)
            out = promote6(key)
            moved = (st6.stats.promotions_host - before[0]
                     + st6.stats.promotions_disk - before[1])
        if moved:
            name = threading.current_thread().name
            promo_threads[name] = promo_threads.get(name, 0) + moved
        return out

    st6.promote = promote_counted

    def split_ms():
        split = {}
        for sp in tracer.spans():
            name = sp.name.split(".", 1)[1]
            if name == "solve":
                name = f"solve[{sp.tags.get('lane')}]"
            split[name] = split.get(name, 0.0) + sp.duration_s * 1e3
        tracer.clear()
        return split

    def fetch_hist():
        h = reg6.get("store_fetch_latency_seconds")
        return {t: (h.count(tier=t), h.sum(tier=t)) for t in ("host", "disk")}

    def tenants6(d, ys, tag="t"):
        return [SolveRequest(x=x6[d], y=ys[d][:, t], method="bakp",
                             design_key=f"p6-d{d}",
                             tenant_id=f"p6-d{d}-{tag}{t}", **knobs6)
                for t in range(ten6)]

    # 6a: two passes of 24 designs x 4 tenants, in flushes of 4 designs;
    # pass 2 (y drifted 1%) in reverse order, so it meets designs on the
    # device, the host and the disk tiers.
    _build.reset_launch_counts()
    served6 = []        # (pass, requests, results)
    plan6 = None
    for pas, order, ys in ((1, range(n6), y6),
                           (2, range(n6 - 1, -1, -1), y6d)):
        order = list(order)
        stats0, hist0 = st6.stats.as_dict(), fetch_hist()
        moves0 = {k: len(v) for k, v in move_s.items()}
        tracer.clear()
        wall, split, outs = 0.0, {}, []
        for lo in range(0, n6, 4):
            reqs = [r for d in order[lo:lo + 4] for r in tenants6(d, ys)]
            n0 = all_counts().get("fused_solve", 0)
            t = time.perf_counter()
            out = eng6.serve(reqs)
            wall += time.perf_counter() - t
            for name, v in split_ms().items():
                split[name] = split.get(name, 0.0) + v
            launched = all_counts().get("fused_solve", 0) - n0
            resident = len({r.design_key for r, o in zip(reqs, out)
                            if o.telemetry.kernel_path == "fused"})
            check(launched == resident == 4,
                  f"phase 6a pass {pas}: {launched} fused_solve launches "
                  f"for {resident} groups solved resident")
            check(st6.device_used() <= budget6,
                  f"phase 6a pass {pas}: device tier {st6.device_used()} "
                  f"bytes over its budget {budget6}")
            plan6 = _build.PLANS["fused_solve"]._asdict()
            outs.append((reqs, out))
        d_stats = {k: v - stats0[k] for k, v in st6.stats.as_dict().items()}
        hist = fetch_hist()
        fetch = {t: {"count": hist[t][0] - hist0[t][0],
                     "mean_ms": ((hist[t][1] - hist0[t][1])
                                 / max(1, hist[t][0] - hist0[t][0]) * 1e3)}
                 for t in hist}
        moves = {k: v[moves0[k]:] for k, v in move_s.items()}
        res = [o for _, out in outs for o in out]
        emit({"phase": "store_pass", "pass": pas, "card": card,
              "requests": len(res), "wall_ms": wall * 1e3,
              "requests_per_s": len(res) / wall, "split_ms": split,
              "mean_sweeps": float(np.mean([r.n_sweeps for r in res])),
              "warm_starts": sum(r.warm_start for r in res),
              "store": d_stats, "promotion_ms_by_tier": fetch,
              "demotion_ms": {k: {"count": len(v), "mean_ms":
                                  float(np.mean(v)) * 1e3 if v else None}
                              for k, v in moves.items()},
              "errors": sum(r.error is not None for r in res)})
        served6.extend((pas, reqs, out) for reqs, out in outs)
    check(st6.stats.promotions_host >= 1 and st6.stats.promotions_disk >= 1,
          f"phase 6a pass 2 must promote from host and disk: "
          f"{st6.stats.as_dict()}")
    sweeps6 = {p: np.mean([o.n_sweeps for q, rr, oo in served6 if q == p
                           for o in oo]) for p in (1, 2)}
    check(sweeps6[2] < sweeps6[1],
          f"phase 6a: pass 2 mean sweeps {sweeps6[2]} not below pass 1's "
          f"{sweeps6[1]} (warm state lost in demotion)")
    check(all(o.warm_start for q, rr, oo in served6 if q == 2 for o in oo),
          "phase 6a pass 2: a request served cold")

    # 6b: phase 3's 16,384 x 4,096 design (256 MiB) in the same engine:
    # over the device budget, so rerouted to bakp_stream and served from
    # the host / disk tier through the host-block loop.
    fb6 = reg6.counter("solver_fallback_total")
    hbm0 = fb6.value(reason="over_hbm")
    a6b = randn(vars3, 2)
    y6b = (x3 @ a6b).cpu().numpy()
    big = [SolveRequest(x=x3, y=y6b[:, t], method="bakp",
                        design_key="p6-big", **knobs6) for t in range(2)]
    check(eng6.spec_for(big[0]).method == "bakp_stream",
          "phase 6b: the over-budget design must be rerouted to bakp_stream")
    tracer.clear()
    t = time.perf_counter()
    out6b = eng6.serve(big)
    wall6b = time.perf_counter() - t
    check(fb6.value(reason="over_hbm") - hbm0 >= 1,
          "phase 6b: solver_fallback_total{reason=over_hbm} did not count")
    check(all(o.error is None and o.telemetry.kernel_path == "stream_host"
              for o in out6b),
          f"phase 6b: paths {[o.telemetry.kernel_path for o in out6b]} "
          f"errors {[o.error for o in out6b]}")
    ref6b = torch.linalg.lstsq(x3.double(), torch.from_numpy(y6b).to(
        dev).double()).solution.cpu().numpy()
    mape6b = max(float(np.mean(np.abs(o.coef - ref6b[:, t])
                               / np.maximum(np.abs(ref6b[:, t]), 1e-12)))
                 for t, o in enumerate(out6b))
    check(mape6b <= 1e-4, f"phase 6b: MAPE vs fp64 lstsq {mape6b}")
    x_res = stream_x_resident_bytes(thr6, obs3, 4)
    check(x_res < 0.25 * x3.numel() * 4,
          f"phase 6b: resident x {x_res} bytes, not under 0.25x the matrix")
    emit({"phase": "store_over_hbm", "card": card, "wall_ms": wall6b * 1e3,
          "split_ms": split_ms(), "tier": st6.tier("p6-big"),
          "n_sweeps": [o.n_sweeps for o in out6b], "mape": mape6b,
          "x_resident_bytes": x_res,
          "x_resident_ratio": x_res / (x3.numel() * 4)})
    # Seconds a sweep from each tier, through the store's block source,
    # beside one pinned copy of x (10 fixed sweeps a solve).
    st_r = DesignStore(device_bytes=budget6, disk_dir=str(tiles / "rate"),
                       registry=tobs.MetricsRegistry())
    t = time.perf_counter()
    h_r = st_r.build("p6-rate", x3)
    build_ms = (time.perf_counter() - t) * 1e3
    spec_r = SolverSpec(method="bakp_stream", thr=thr6, max_iter=10)
    yr = torch.from_numpy(y6b[:, 0]).to(dev)

    def sweep_s(h=None):
        sync()
        t = time.perf_counter()
        r = (h or h_r).solve(yr, spec=spec_r)
        sync()
        check(int(r.n_sweeps) == 10, "phase 6b rate: 10 fixed sweeps")
        return (time.perf_counter() - t) / 10

    host_x = next(iter(st_r._host["p6-rate"].x_t.values()))
    check(host_x.is_pinned(), "phase 6b: the host tier must be pinned")
    x_dev = torch.empty_like(host_x, device=dev)
    h2d = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x_dev.copy_(host_x, non_blocking=True)
        end.record()
        sync()
        h2d.append(start.elapsed_time(end))
    del x_dev, host_x
    # In turns with phase 3's non-resident handle (the same host tier).
    host_sweeps, p3_sweeps = [], []
    for _ in range(2):
        host_sweeps.append(sweep_s())
        p3_sweeps.append(sweep_s(h3))
    t = time.perf_counter()
    st_r._demote_to_disk("p6-rate")
    to_disk_ms = (time.perf_counter() - t) * 1e3
    disk_sweeps = [sweep_s() for _ in range(2)]   # the first verifies CRCs
    rec = st_r._disk["p6-rate"]
    verify_ms = []
    for j in range(3):
        t = time.perf_counter()
        rec.verify_tile(j)
        verify_ms.append((time.perf_counter() - t) * 1e3)
    emit({"phase": "store_tier_rates", "card": card,
          "bytes": x3.numel() * 4, "tile_bytes": _TILE_HEADER.size
          + thr6 * obs3 * 4, "host_build_ms": build_ms,
          "host_to_disk_ms": to_disk_ms,
          "s_per_sweep_host": host_sweeps,
          "s_per_sweep_host_phase3_handle": p3_sweeps,
          "s_per_sweep_disk": disk_sweeps,
          "crc_verify_ms_per_tile": verify_ms, "h2d_pinned_ms": h2d,
          "h2d_pinned_gb_per_s": x3.numel() * 4 / (min(h2d) / 1e3) / 1e9})
    st_r.close()
    del h_r, st_r

    # 6c: corruption, once through the fault site and once by a byte
    # flipped in a tile file: the design is quarantined, rebuilt from the
    # request's x with its tenants' warm state, and served.
    corr = reg6.counter("store_tile_corruption_total")
    on_disk = [d for d in range(n6) if st6.tier(f"p6-d{d}") == "disk"]
    check(len(on_disk) >= 2, f"phase 6c: designs on disk {on_disk}")
    for how, d in zip(("fault_site", "flipped_byte"), on_disk):
        key = f"p6-d{d}"
        c0 = corr.value()
        if how == "flipped_byte":
            path = st6._disk[key].tile_path(1)
            raw = bytearray(path.read_bytes())
            raw[_TILE_HEADER.size + 7] ^= 0xFF
            path.write_bytes(bytes(raw))
            out = eng6.serve(tenants6(d, y6d))
        else:
            with faults.installed({"store.tile_corrupt": {"count": 1,
                                                          "match": key}}):
                out = eng6.serve(tenants6(d, y6d))
        check(corr.value() == c0 + 1,
              f"phase 6c {how}: store_tile_corruption_total rose by "
              f"{corr.value() - c0}")
        check(all(o.error is None for o in out),
              f"phase 6c {how}: {[o.error for o in out]}")
        check(all(o.warm_start for o in out),
              f"phase 6c {how}: the tenants' warm state did not survive")
        served6.append((f"6c_{how}", tenants6(d, y6d), out))
        emit({"phase": "store_corruption", "case": how, "design": key,
              "card": card, "tier_after": st6.tier(key),
              "warm_starts": sum(o.warm_start for o in out),
              "quarantined": st6.stats.tile_corruptions})

    # 6d: the async dispatcher over this store engine: 256 requests from 4
    # submitter threads, Poisson arrivals at 600 requests/s, deadline 50
    # ms, max_batch 16; 16 of the designs, 8 new tenants each, each
    # tenant twice (y drifted by 0.01% the second time: a warm start).
    rate6, dl6, mb6, nd6, nt6 = 600.0, 0.05, 16, 16, 8
    rng6 = np.random.default_rng(SEED + 6)
    b6 = rng6.standard_normal((nd6, nt6, vars6), dtype=np.float32)
    b6d = b6 + 1e-4 * rng6.standard_normal(b6.shape, dtype=np.float32)
    arrivals6 = np.cumsum(rng6.exponential(1.0 / rate6, size=2 * nd6 * nt6))

    def trace6(tag):
        return [SolveRequest(
            x=x6[d], y=x6[d] @ b[d, t], method="bakp",
            design_key=f"p6-d{d}", tenant_id=f"p6{tag}-d{d}-t{t}",
            **knobs6) for b in (b6, b6d) for d in range(nd6)
            for t in range(nt6)]

    dcfg6 = DispatchConfig(max_queue=1024, backpressure="block",
                           max_batch=mb6, deadline_margin_s=dl6 / 4,
                           idle_timeout_s=4.0 / rate6)
    reqs6d = trace6("a")
    tickets6 = [None] * len(reqs6d)
    errs6 = []
    promo_threads.clear()
    with AsyncDispatcher(eng6, dcfg6) as disp6:
        t0 = time.perf_counter()

        def submitter(s):
            try:
                for i in range(s, len(reqs6d), 4):
                    wait = arrivals6[i] - (time.perf_counter() - t0)
                    if wait > 0:
                        time.sleep(wait)
                    tickets6[i] = disp6.submit(reqs6d[i], deadline_s=dl6)
            except Exception as exc:   # surfaced as a failed check
                errs6.append(exc)

        subs = [threading.Thread(target=submitter, args=(s,))
                for s in range(4)]
        for th in subs:
            th.start()
        for th in subs:
            th.join(timeout=120)
        check(not errs6 and not any(th.is_alive() for th in subs),
              f"phase 6d submitters: {errs6}")
        check(disp6.drain(timeout=120), "phase 6d: drain timed out")
        async_wall = time.perf_counter() - t0
        out6d = [tk.result(timeout=60) for tk in tickets6]
        dstats6 = disp6.stats.as_dict()
    lat6 = np.array([tk.latency_s for tk in tickets6])
    qw6 = np.array([tk.queue_wait_s for tk in tickets6])
    check(all(o.error is None for o in out6d),
          f"phase 6d: {sum(o.error is not None for o in out6d)} errors")
    warm6 = [o.n_sweeps for o in out6d if o.warm_start]
    cold6 = [o.n_sweeps for o in out6d if not o.warm_start]
    check(len(warm6) >= nd6 * nt6 // 2 and cold6
          and np.mean(warm6) <= 0.7 * np.mean(cold6),
          f"phase 6d: {len(warm6)} warm starts, mean sweeps warm "
          f"{np.mean(warm6) if warm6 else None} cold "
          f"{np.mean(cold6) if cold6 else None} (gate: warm <= 0.7 x cold)")
    # Where each warm request's start came from (the engine's
    # extra["a0_source"]) and how many solves of its tenant had finished
    # before its batch fired, beside its group: the warm gate's inputs
    # (ROADMAP S3).
    warm_rows6, by_source6 = [], {}
    # A tenant's second request (the drifted y) served cold: its first
    # had not stored coefficients when its batch fired.
    second_cold6 = sum(1 for i, o in enumerate(out6d)
                       if i >= nd6 * nt6 and not o.warm_start)
    # A coalesced group reports one n_sweeps for all its members: the
    # cold members a warm request's group held (members share the design,
    # the batch's latency and its size).
    cold_in6 = {}
    for i, o in enumerate(out6d):
        g = (reqs6d[i].design_key, o.latency_s, o.group_size)
        cold_in6[g] = cold_in6.get(g, 0) + (not o.warm_start)
    for i, o in enumerate(out6d):
        if not o.warm_start:
            continue
        tenant = reqs6d[i].tenant_id
        taken = tickets6[i].fired_at
        done_before = sum(
            1 for j, tk in enumerate(tickets6) if j != i
            and reqs6d[j].tenant_id == tenant
            and tk.completed_at is not None and tk.completed_at <= taken)
        src = o.extra.get("a0_source")
        warm_rows6.append([tenant, src, done_before, o.batch_kind,
                           o.group_size, cold_in6[(reqs6d[i].design_key,
                                                   o.latency_s,
                                                   o.group_size)],
                           o.n_sweeps])
        agg = by_source6.setdefault(src, {"count": 0, "sweeps": 0})
        agg["count"] += 1
        agg["sweeps"] += o.n_sweeps
    for agg in by_source6.values():
        agg["mean_sweeps"] = agg.pop("sweeps") / agg["count"]
    served6.append(("6d_async", reqs6d, out6d))
    dispatch_promotions = dict(promo_threads)
    read_launches("phase_6_store")
    main6_s = time.perf_counter() - t_phase6

    # The same trace through the synchronous engine (new tenants, the same
    # designs and arrival times), flushed every max_batch arrivals.
    reqs6s = trace6("s")
    t0 = time.perf_counter()
    pending, sync_lat = [], []
    for i, req in enumerate(reqs6s):
        wait = arrivals6[i] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        pending.append((arrivals6[i], req))
        if len(pending) >= mb6 or i == len(reqs6s) - 1:
            out = eng6.serve([r for _, r in pending])
            done = time.perf_counter() - t0
            check(all(o.error is None for o in out), "phase 6d sync: errors")
            sync_lat.extend(done - arr for arr, _ in pending)
            pending = []
    sync_wall = time.perf_counter() - t0
    sync_lat = np.array(sync_lat)
    emit({"phase": "store_async", "card": card, "requests": len(out6d),
          "rate_per_s": rate6, "deadline_ms": dl6 * 1e3,
          "async_wall_s": async_wall,
          "async_requests_per_s": len(out6d) / async_wall,
          "sync_wall_s": sync_wall,
          "sync_requests_per_s": len(reqs6s) / sync_wall,
          "latency_ms_p50": float(np.percentile(lat6, 50)) * 1e3,
          "latency_ms_p95": float(np.percentile(lat6, 95)) * 1e3,
          "queue_wait_ms_p50": float(np.percentile(qw6, 50)) * 1e3,
          "queue_wait_ms_p95": float(np.percentile(qw6, 95)) * 1e3,
          "sync_latency_ms_p50": float(np.percentile(sync_lat, 50)) * 1e3,
          "sync_latency_ms_p95": float(np.percentile(sync_lat, 95)) * 1e3,
          "deadline_hit_rate": dstats6["deadline_hit_rate"],
          "fired": {k: dstats6[f"fired_{k}"]
                    for k in ("full", "deadline", "idle", "drain")},
          "warm_starts": len(warm6), "mean_sweeps_warm": float(
              np.mean(warm6)), "mean_sweeps_cold": float(np.mean(cold6)),
          "warm_by_source": by_source6,
          "second_requests_cold": second_cold6,
          "warm_finished_before_taken": {
              str(n): sum(1 for r in warm_rows6 if r[2] == n)
              for n in sorted({r[2] for r in warm_rows6})},
          "warm_mean_sweeps_by_cold_in_group": {
              str(c): float(np.mean([r[6] for r in warm_rows6 if r[5] == c]))
              for c in sorted({r[5] for r in warm_rows6})},
          "warm_requests": {"columns": ["tenant", "a0_source",
                                        "tenant_solves_finished_before",
                                        "batch_kind", "group_size",
                                        "group_cold_members", "n_sweeps"],
                            "rows": warm_rows6},
          "promotions_by_thread": dispatch_promotions,
          "store": st6.stats.as_dict()})
    check(dispatch_promotions.get("serve-dispatch", 0) >= 1,
          f"phase 6d: no promotion ran on the dispatch thread "
          f"{dispatch_promotions}")

    # 6a's traffic through a storeless engine: every request within 1e-5
    # of it (same kernels, same warm starts).
    base6 = SolverServeEngine(ServeConfig(prefer_fused=True),
                              registry=tobs.MetricsRegistry())
    worst6 = {"mape": 0.0, "vs_storeless": 0.0}
    for label, reqs, out in served6:
        if label in (1, 2):
            for o, b in zip(out, base6.serve(reqs)):
                err = float(np.abs(o.coef - b.coef).max()
                            / max(1.0, float(np.abs(b.coef).max())))
                worst6["vs_storeless"] = max(worst6["vs_storeless"], err)
                check(err <= 1e-5 and o.n_sweeps == b.n_sweeps,
                      f"phase 6a {o.request_id}: {err} from the storeless "
                      f"engine, sweeps {o.n_sweeps} vs {b.n_sweeps}")
        groups = {}
        for q, o in zip(reqs, out):
            check(o.error is None and o.coef.shape == (vars6,)
                  and bool(np.isfinite(o.coef).all()),
                  f"phase 6 {label} {o.request_id}: {o.error}")
            groups.setdefault(q.design_key, []).append((q, o))
        for key, members in groups.items():
            xd = torch.as_tensor(members[0][0].x, device=dev).double()
            ys = torch.as_tensor(np.stack([q.y for q, _ in members], 1),
                                 device=dev).double()
            ref = torch.linalg.lstsq(xd, ys).solution.cpu().numpy()
            coefs = np.stack([o.coef for _, o in members], 1)
            mape = float(np.max(np.mean(
                np.abs(coefs - ref) / np.maximum(np.abs(ref), 1e-12), 0)))
            worst6["mape"] = max(worst6["mape"], mape)
            check(mape <= 1e-4, f"phase 6 {label} {key}: MAPE vs fp64 "
                                f"lstsq {mape}")
    base6.shutdown()

    # 6e: a fused_solve launch that returns a CUDA error, through the
    # dispatcher: each ticket fails with KernelError; nothing is served on
    # the plain "bakp" rung.
    lib6 = _build.load("fused_solve")

    class BrokenFused:
        def __getattr__(self, name):
            return getattr(lib6, name)

        @staticmethod
        def bakp_fused_launch(*args):
            return 98  # cudaErrorInvalidDeviceFunction

    solves6 = reg6.counter("serve_solves_total")
    plain0 = solves6.value(method="bakp")
    _build._libs["fused_solve"] = BrokenFused()
    try:
        with AsyncDispatcher(eng6, DispatchConfig(idle_timeout_s=0.01)) as d:
            tks = [d.submit(SolveRequest(
                x=x6[0], y=y6[0][:, t], method="bakp",
                design_key="p6-broken", **knobs6)) for t in range(2)]
            failed6 = 0
            for tk in tks:
                try:
                    tk.result(timeout=60)
                except KernelError:
                    failed6 += 1
    finally:
        _build._libs["fused_solve"] = lib6
    check(failed6 == 2, f"phase 6e: {failed6} of 2 tickets failed with "
                        f"KernelError")
    check(solves6.value(method="bakp") == plain0,
          "phase 6e: a request was served on the plain bakp rung")
    eng6.shutdown()
    watchdog.cancel()
    emit({"phase": "store_checks", "card": card,
          "requests_checked": sum(len(o) for _, _, o in served6),
          "worst_mape_vs_fp64_lstsq": worst6["mape"],
          "worst_rel_err_vs_storeless": worst6["vs_storeless"],
          "kernel_error_tickets": failed6, "main_path_s": main6_s})

    # The kernel this path launched, at 6a's shape and plan.
    h6 = prepare(x6[0], device=dev)
    row6 = fused_case("phase6_k4_rtol", h6.x_t_for(thr6),
                      h6.inv_cn_for(thr6),
                      torch.from_numpy(y6[0]).to(dev), thr6, 100, 1e-7, 5)
    check(row6["plan"] == plan6,
          f"phase 6 fused_solve: kernel row ran {row6['plan']}, 6a ran "
          f"{plan6}")
    del h6, x6, eng6, st6
    tiles_root.cleanup()
    emit({"phase": "store_done", "card": card,
          "seconds": time.perf_counter() - t_phase6})

    # ------------------------------ sharded, on virtual shards (phase 7)
    # The mesh path on one card: every shard of a mesh sits on cuda:0
    # (virtual shards), so the sharded arithmetic, the routing, the sharded
    # copies' bytes and the mesh lanes run here; copies between cards do
    # not (tests/test_torch_cuda.py::test_sharded_solvers_on_distinct_cards
    # waits for a machine with two).  This slice launches no hand-written
    # kernel: JAX's sharded solvers are plain XLA, and so are these.
    import logging

    import repro_torch.core as tcore
    from repro_torch.core.distributed import shard_x
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import build_serve_mesh

    def hung7():
        print(f"chip_smoke: phase 7 did not finish in {PHASE7_WATCHDOG_S} s "
              f"(a hang on the sharded path)", file=sys.stderr, flush=True)
        os._exit(3)

    watchdog = threading.Timer(PHASE7_WATCHDOG_S, hung7)
    watchdog.daemon = True
    watchdog.start()
    t_phase7 = time.perf_counter()

    timed = _timed

    # 7a: the four solvers against the single-device solver at one shape.
    virtual = {"obs": make_mesh((4,), ("data",), [dev] * 4),
               "rhs": make_mesh((4,), ("data",), [dev] * 4),
               "vars": make_mesh((1, 4), ("data", "model"), [dev] * 4),
               "2d": make_mesh((2, 2), ("data", "model"), [dev] * 4)}
    fns7 = {"obs": tcore.solvebakp_obs_sharded,
            "rhs": tcore.solvebakp_rhs_sharded,
            "vars": tcore.solvebakp_vars_sharded, "2d": tcore.solvebakp_2d}

    def case7(kind, x, y, a_true, knobs, hist_sweeps=None):
        mesh = virtual[kind]
        xs, layout_ms = timed(lambda: shard_x(x, mesh, kind,
                                              model_axis="model"))
        fn = fns7[kind]
        fn(xs, y, mesh, **dict(knobs, max_iter=1))      # warm-up
        tcore.solvebakp(x, y, **dict(knobs, max_iter=1))
        res, ms = timed(lambda: fn(xs, y, mesh, **knobs))
        ref, ms1 = timed(lambda: tcore.solvebakp(x, y, **knobs))
        row = {"phase": "sharded_solver", "case": kind, "card": card,
               "mesh": dict(mesh.shape), "shape": list(x.shape),
               "k": y.shape[1], "knobs": knobs, "ms": ms,
               "sweeps": int(res.n_sweeps),
               "ms_per_sweep": ms / max(1, int(res.n_sweeps)),
               "single_ms": ms1, "single_sweeps": int(ref.n_sweeps),
               "single_ms_per_sweep": ms1 / max(1, int(ref.n_sweeps)),
               "sharded_copy_bytes": xs.nbytes, "layout_ms": layout_ms,
               "coef_err_vs_single": rel(res.coef, ref.coef),
               "coef_err_vs_truth": rel(res.coef, a_true)}
        if hist_sweeps is not None:
            kw = dict(knobs, max_iter=hist_sweeps)
            h = fn(xs, y, mesh, **kw).history
            h1 = tcore.solvebakp(x, y, **kw).history
            sse0 = float((y * y).sum())
            row["history_max_abs_diff"] = float((h - h1).abs().max())
            check(bool(((h - h1).abs() <= 1e-4 * h1.abs() + 1e-7 * sse0)
                       .all()),
                  f"phase 7a {kind}: the first {hist_sweeps} sweeps' "
                  f"history differs from solvebakp's: {h.tolist()} vs "
                  f"{h1.tolist()}")
        first = mesh.devices.flat[0]
        check(res.coef.device == first and res.residual.device == first,
              f"phase 7a {kind}: result on {res.coef.device}, not on the "
              f"first shard's device {first}")
        emit(row)
        del xs
        return res, ref, row

    gram = dict(thr=128, mode="gram")
    # obs: phase 2's 262,144 x 1,024 design (1 GiB; its copy another 1 GiB).
    x7 = randn(262_144, 1_024)
    a7 = randn(1_024, 8)
    y7 = x7 @ a7
    res, ref, row = case7("obs", x7, y7, a7, dict(gram, max_iter=20),
                          hist_sweeps=5)
    check(row["sharded_copy_bytes"] == x7.numel() * 4,
          f"phase 7a obs: sharded copy {row['sharded_copy_bytes']} bytes")
    check(row["coef_err_vs_single"] <= 1e-5,
          f"phase 7a obs: coef {row['coef_err_vs_single']} from solvebakp")
    del x7, y7, res, ref
    # rhs: 16,384 x 256 at k 64: the single-device multi-RHS solve's
    # iterates, its sweep count at rtol 0 and within one at rtol 1e-7.
    x7 = randn(16_384, 256)
    a7 = randn(256, 64)
    y7 = x7 @ a7
    res, ref, row = case7("rhs", x7, y7, a7, dict(gram, max_iter=30))
    check(row["coef_err_vs_single"] <= 1e-5,
          f"phase 7a rhs: coef {row['coef_err_vs_single']} from solvebakp")
    check(row["sweeps"] == row["single_sweeps"],
          "phase 7a rhs: sweeps differ at rtol 0")
    res, ref, row = case7("rhs", x7, y7, a7,
                          dict(gram, max_iter=200, rtol=1e-7))
    check(abs(row["sweeps"] - row["single_sweeps"]) <= 1,
          f"phase 7a rhs rtol 1e-7: {row['sweeps']} sweeps against "
          f"{row['single_sweeps']}")
    # vars and 2-D: 65,536 x 1,024, omega 0.5 (their cross-shard Jacobi
    # block changes the iterates): JAX's 1e-3 against a_true.
    x7 = randn(65_536, 1_024)
    a7 = randn(1_024, 1)
    y7 = x7 @ a7
    for kind in ("vars", "2d"):
        res, ref, row = case7(kind, x7, y7, a7,
                              dict(gram, omega=0.5, max_iter=100,
                                   rtol=1e-7))
        check(row["coef_err_vs_truth"] <= 1e-3,
              f"phase 7a {kind}: coef error {row['coef_err_vs_truth']}")
    del x7, y7, a7, res, ref

    # 7b: the serving engine on four virtual shards, default policy.
    rng7 = np.random.default_rng(SEED + 7)
    knobs7 = dict(method="bakp", thr=128, max_iter=40, rtol=0.0)
    big7 = [rng7.standard_normal((65_536, 512), dtype=np.float32)
            for _ in range(3)]
    big7a = rng7.standard_normal((3, 512, 4), dtype=np.float32)
    # 4,096 x 256 = 2^20 cells: a single-device bucket under the default
    # 2^21 threshold, whose 32-tenant group upgrades to rhs_sharded.
    grp7 = rng7.standard_normal((4_096, 256), dtype=np.float32)
    grp7a = rng7.standard_normal((256, 32), dtype=np.float32)
    sm7 = [rng7.standard_normal((4_096, 64), dtype=np.float32)
           for _ in range(4)]
    sm7a = rng7.standard_normal((4, 64), dtype=np.float32)

    def workload7():
        reqs = [SolveRequest(x=big7[d], y=big7[d] @ big7a[d, :, t],
                             design_key=f"p7-big{d}", tenant_id=f"b{d}-{t}",
                             request_id=f"big{d}-{t}", **knobs7)
                for d in range(3) for t in range(4)]
        reqs += [SolveRequest(x=grp7, y=grp7 @ grp7a[:, t],
                              design_key="p7-grp", tenant_id=f"g{t}",
                              request_id=f"grp-{t}", **knobs7)
                 for t in range(32)]
        reqs += [SolveRequest(x=sm7[i], y=sm7[i] @ sm7a[i],
                              design_key=f"p7-sm{i}", request_id=f"sm-{i}",
                              **knobs7) for i in range(4)]
        return reqs

    want7 = {**{f"big{d}-{t}": ("obs_sharded", "multi_rhs")
                for d in range(3) for t in range(4)},
             **{f"grp-{t}": ("rhs_sharded", "multi_rhs") for t in range(32)},
             **{f"sm-{i}": ("single", "vmap") for i in range(4)}}
    smesh7 = build_serve_mesh("4", devices=[dev] * 4)
    reg7 = tobs.MetricsRegistry()
    eng7 = SolverServeEngine(ServeConfig(), mesh=smesh7, registry=reg7)
    base7 = SolverServeEngine(ServeConfig(), registry=tobs.MetricsRegistry())
    _build.reset_launch_counts()
    out7 = []
    for rnd in (1, 2):      # round 2 warm through tenant_id
        reqs = workload7()
        tracer.clear()
        t = time.perf_counter()
        out = eng7.serve(reqs)
        wall = time.perf_counter() - t
        split = {}
        for sp in tracer.spans():
            name = sp.name.split(".", 1)[1]
            if name == "solve":
                name = f"solve[{sp.tags.get('lane')}]"
            split[name] = split.get(name, 0.0) + sp.duration_s * 1e3
        emit({"phase": "sharded_serve", "round": rnd, "card": card,
              "requests": len(reqs), "wall_ms": wall * 1e3,
              "requests_per_s": len(reqs) / wall, "split_ms": split,
              "mean_sweeps": float(np.mean([r.n_sweeps for r in out])),
              "placements": {p: sum(r.placement == p for r in out)
                             for p in ("obs_sharded", "rhs_sharded",
                                       "single")}})
        out7.append((reqs, out))
    counts7 = {**_build.launch_counts(), **_build.launch_counts(2)}
    emit({"phase": "main_path_launches", "path": "phase_7_sharded",
          **counts7})
    check(not any(counts7.values()),
          f"phase 7b: the sharded path launched kernels {counts7}")
    worst7 = {"vs_meshless": 0.0, "vs_lstsq": 0.0}
    for rnd, (reqs, out) in enumerate(out7, 1):
        ref_out = base7.serve(workload7())
        for q, o, b in zip(reqs, out, ref_out):
            check(o.error is None, f"phase 7b {o.request_id}: {o.error}")
            if o.error is not None:
                continue
            check((o.placement, o.batch_kind) == want7[q.request_id],
                  f"phase 7b {q.request_id}: {o.placement} / "
                  f"{o.batch_kind}, want {want7[q.request_id]}")
            m = float(np.mean(np.abs(o.coef - b.coef)
                              / np.maximum(np.abs(b.coef), 1e-12)))
            lst = np.linalg.lstsq(np.asarray(q.x, np.float64),
                                  np.asarray(q.y, np.float64),
                                  rcond=None)[0]
            m2 = float(np.mean(np.abs(o.coef - lst)
                               / np.maximum(np.abs(lst), 1e-12)))
            worst7["vs_meshless"] = max(worst7["vs_meshless"], m)
            worst7["vs_lstsq"] = max(worst7["vs_lstsq"], m2)
    check(worst7["vs_meshless"] <= 1e-5,
          f"phase 7b: MAPE vs the mesh-less engine {worst7['vs_meshless']}")
    check(worst7["vs_lstsq"] <= 1e-4,
          f"phase 7b: MAPE vs fp64 lstsq {worst7['vs_lstsq']}")
    lanes7 = eng7.lanes.stats()
    check(eng7.stats.sharded_solves >= 8,
          f"phase 7b: {eng7.stats.sharded_solves} sharded solves")
    check(eng7.stats.warm_starts > 0, "phase 7b: no warm start")
    check({"mesh:obs_sharded", "mesh:rhs_sharded"} <= set(lanes7),
          f"phase 7b: lanes {sorted(lanes7)}")
    # prefer_fused on a mesh engine does nothing, audibly: counted once a
    # request, logged once an engine.
    logged = []

    class _Catch(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())

    catch = _Catch(level=logging.WARNING)
    logging.getLogger("repro_torch.serve.engine").addHandler(catch)
    regf = tobs.MetricsRegistry()
    engf = SolverServeEngine(ServeConfig(prefer_fused=True), mesh=smesh7,
                             registry=regf)
    outf = engf.serve(workload7()[:12])
    logging.getLogger("repro_torch.serve.engine").removeHandler(catch)
    unshard = regf.get("solver_fallback_total").value(
        reason="unshardable_fused")
    check(all(o.error is None and o.telemetry.method == "bakp"
              and o.placement == "obs_sharded" for o in outf),
          "phase 7b prefer_fused: a bakp request left bakp on the mesh")
    check(unshard >= 1, "phase 7b prefer_fused: unshardable_fused not "
                        "counted")
    check(sum("prefer_fused" in m for m in logged) == 1,
          f"phase 7b prefer_fused: {len(logged)} warnings, want 1")
    emit({"phase": "sharded_checks", "card": card,
          "requests_checked": sum(len(o) for _, o in out7),
          "worst_mape_vs_meshless": worst7["vs_meshless"],
          "worst_mape_vs_fp64_lstsq": worst7["vs_lstsq"],
          "sharded_solves": eng7.stats.sharded_solves,
          "warm_starts": eng7.stats.warm_starts,
          "lanes": {k: {f: v[f] for f in ("batches", "requests", "busy_s")}
                    for k, v in lanes7.items()},
          "unshardable_fused": unshard})
    for e in (eng7, base7, engf):
        e.shutdown()

    # 7c: a store engine of a 2-design budget (x and its sharded copy) on
    # the same mesh: the copies count in store_bytes, a demotion frees
    # them, and the device tier holds its budget after every flush.
    design7 = 65_536 * 512 * 4
    budget7 = 2 * 2 * design7
    reg7c = tobs.MetricsRegistry()
    eng7c = SolverServeEngine(ServeConfig(store_device_bytes=budget7),
                              mesh=smesh7, registry=reg7c)
    st7 = eng7c.store
    freed7 = []
    demote7 = st7.demote

    def demote_freed(key):
        with st7._lock:
            entry = st7._device.get(key)
            copies = (sum(sh.nbytes for sh in entry._sharded.values())
                      if entry is not None else 0)
            del entry
            sync()
            before = torch.cuda.memory_allocated(dev)
            out = demote7(key)
            sync()
            freed7.append((key, copies,
                           before - torch.cuda.memory_allocated(dev)))
            return out

    st7.demote = demote_freed
    rows7c = []
    for rnd in (1, 2):
        for d in range(3):
            reqs = [r for r in workload7() if r.design_key == f"p7-big{d}"]
            out = eng7c.serve(reqs)
            check(all(o.error is None and o.placement == "obs_sharded"
                      for o in out),
                  f"phase 7c round {rnd} design {d}: "
                  f"{[(o.placement, o.error) for o in out]}")
            used = st7.device_used()
            gauge = reg7c.get("store_bytes").value(tier="device")
            entry = st7.get(f"p7-big{d}")
            copy = sum(sh.nbytes for sh in entry._sharded.values())
            rows7c.append({"round": rnd, "design": d, "device_used": used,
                           "store_bytes_gauge": gauge, "copy_bytes": copy})
            check(used <= budget7,
                  f"phase 7c: device tier {used} bytes over {budget7}")
            check(gauge == used,
                  f"phase 7c: store_bytes{{tier=device}} {gauge}, the tier "
                  f"holds {used}")
            check(copy == design7 and used >= 2 * design7,
                  f"phase 7c: the sharded copy ({copy} bytes) must count "
                  f"in the device tier ({used})")
            del entry
    check(len(freed7) >= 4 and all(c == design7 and f >= c
                                   for _, c, f in freed7),
          f"phase 7c: demotions (key, copy bytes, bytes freed) {freed7}")
    emit({"phase": "sharded_store", "card": card, "budget": budget7,
          "flushes": rows7c, "demotions": freed7,
          "stats": st7.stats.as_dict()})
    eng7c.shutdown()
    del eng7c, st7
    watchdog.cancel()
    emit({"phase": "sharded_done", "card": card,
          "seconds": time.perf_counter() - t_phase7})

    # ------------------------------------ the LM serving path (phase 8)
    # qwen3-8b at full width and depth, random bf16 weights from SEED:
    # (8a) the build, (8b) serving through launch/steps and the decode-
    # versus-forward check, (8c) linear probes of its activations on the
    # gram-mode solver and on the streaming kernel.
    import dataclasses

    from repro_torch.configs.registry import get as get_arch
    from repro_torch.core import fit_linear_probe
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.kvcache import cache_bytes, init_cache
    from repro_torch.models.model import (forward_logits, init_model,
                                          make_smoke_batch, model_defs,
                                          probe_features)
    from repro_torch.models.params import count_params, tree_items

    def int8_against(cfg, params, prompt, ids, ref_steps, smax):
        """The model's int8 KV cache (phase 9e) against its bf16 cache's
        run: prefill the same prompt into an int8 cache of ``smax`` slots,
        feed the bf16 run's tokens ``ids`` step by step (teacher forcing,
        so every step sees the same inputs), and compare each step's
        logits with ``ref_steps``: argmax agreement and the largest
        log-softmax gap, beside JAX's bound of 0.15 (test_kv_quant)."""
        cfgq = dataclasses.replace(cfg, kv_quant="int8")
        b = prompt["tokens"].shape[0]
        qbytes, fbytes = cache_bytes(cfgq, b, smax), cache_bytes(cfg, b, smax)
        check(qbytes < 0.6 * fbytes,
              f"9e {cfg.name}: int8 cache {qbytes} bytes, not under 0.6x "
              f"the bf16 cache's {fbytes}")
        torch.cuda.reset_peak_memory_stats()
        cacheq = init_cache(cfgq, b, smax)
        (_, cacheq), pre_ms = timed(
            lambda: make_prefill_step(cfgq)(params, prompt, cacheq))
        decq = make_decode_step(cfgq)
        outs = []
        sync()
        t = time.perf_counter()
        for tok in ids:
            lq, cacheq = decq(params, tok, cacheq)
            outs.append(lq)
        sync()
        dec_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        lq, lf = torch.stack(outs), torch.stack(ref_steps)
        agree = (lq.argmax(-1) == lf.argmax(-1)).float().mean().item()
        gap = (torch.log_softmax(lq, -1) - torch.log_softmax(lf, -1)
               ).abs().max().item()
        finite = bool(torch.isfinite(lq).all())
        check(finite, f"9e {cfg.name}: int8 decode logits not finite")
        del cacheq, outs, lq, lf
        torch.cuda.empty_cache()
        return {"arch": cfg.name, "cache_slots": smax,
                "cache_bytes_int8": qbytes, "cache_bytes_bf16": fbytes,
                "int8_over_bf16": qbytes / fbytes, "prefill_s": pre_ms / 1e3,
                "decode_ms_per_step": dec_s * 1e3 / len(ids),
                "decode_tokens_per_s": len(ids) * b / dec_s,
                "max_memory_allocated": peak,
                "greedy_agreement_vs_bf16_cache": agree,
                "max_log_softmax_gap_vs_bf16_cache": gap,
                "jax_gap_bound": 0.15, "finite": finite}

    def hung8():
        print(f"chip_smoke: phase 8 did not finish in {PHASE8_WATCHDOG_S} s "
              f"(a hang on the LM path)", file=sys.stderr, flush=True)
        os._exit(3)

    watchdog = threading.Timer(PHASE8_WATCHDOG_S, hung8)
    watchdog.daemon = True
    watchdog.start()
    t_phase8 = time.perf_counter()

    cfg8 = get_arch("qwen3-8b")
    shape8 = (cfg8.n_layers, cfg8.d_model, cfg8.n_heads, cfg8.n_kv_heads,
              cfg8.resolved_head_dim, cfg8.d_ff, cfg8.vocab_size)
    check(shape8 == (36, 4096, 32, 8, 128, 12288, 151936),
          f"phase 8: qwen3-8b is {shape8}")

    # 8a: the build.
    _build.reset_launch_counts()
    torch.cuda.empty_cache()
    held8 = torch.cuda.memory_allocated()       # the earlier phases' tensors
    torch.cuda.reset_peak_memory_stats()
    params8, init_ms = timed(lambda: init_model(cfg8, seed=SEED))
    n8 = count_params(model_defs(cfg8))
    wbytes8 = sum(t.numel() * t.element_size()
                  for _, t in tree_items(params8))
    # n_params() leaves out the padded vocab rows of both tables and the
    # norm weights; count_params has them.
    d8, hd8 = cfg8.d_model, cfg8.resolved_head_dim
    extra8 = (2 * (cfg8.padded_vocab - cfg8.vocab_size) * d8 + d8
              + cfg8.n_layers * (2 * d8 + 2 * hd8))
    check(n8 == cfg8.n_params() + extra8,
          f"phase 8a: count_params {n8}, n_params() {cfg8.n_params()} + "
          f"{extra8}")
    check(wbytes8 == 2 * n8, f"phase 8a: {wbytes8} bytes of weights for "
                             f"{n8} bf16 parameters")
    emit({"phase": "lm_build", "card": card, "arch": cfg8.name,
          "layers": cfg8.n_layers, "d_model": d8, "heads": cfg8.n_heads,
          "kv_heads": cfg8.n_kv_heads, "head_dim": hd8, "d_ff": cfg8.d_ff,
          "vocab": cfg8.vocab_size, "padded_vocab": cfg8.padded_vocab,
          "dtype": cfg8.dtype, "params": n8,
          "n_params_formula": cfg8.n_params(), "weight_bytes": wbytes8,
          "init_s": init_ms / 1e3, "reduced": [],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "held_before_phase": held8})

    # 8b: serve 4 prompts of 512 tokens, 32 greedy steps, through
    # launch/steps with launch/serve's cache length (32,768 slots).
    b8, s8, g8 = 4, 512, 32
    smax8 = max(cfg8.max_cache_len, s8 + g8)
    prompt8 = make_smoke_batch(cfg8, seed=SEED + 8, batch=b8, seq=s8)
    prompt8.pop("labels")
    prefill8, decode8 = make_prefill_step(cfg8), make_decode_step(cfg8)
    cache8 = init_cache(cfg8, b8, smax8)
    cbytes8 = cache_bytes(cfg8, b8, smax8)
    check(cbytes8 == sum(t.numel() * t.element_size()
                         for t in cache8.values()),
          f"phase 8b: cache_bytes {cbytes8} is not the cache's")
    (logits8, cache8), prefill_ms = timed(
        lambda: prefill8(params8, prompt8, cache8))
    # Again, warm (the first call also pays cuBLAS's start-up).
    (logits8, cache8), prefill_warm_ms = timed(
        lambda: prefill8(params8, prompt8, cache8))
    tok8 = first_tok8 = logits8.argmax(-1)[:, None].to(torch.int32)
    ids8, steps8 = [], []
    sync()
    t = time.perf_counter()
    for i in range(g8):
        ids8.append(tok8)
        logits8, cache8 = decode8(params8, tok8, cache8)
        steps8.append(logits8)
        tok8 = logits8.argmax(-1)[:, None].to(torch.int32)
    sync()
    decode_s = time.perf_counter() - t
    lengths8 = cache8["lengths"].tolist()
    check(lengths8 == [s8 + g8] * b8, f"phase 8b: lengths {lengths8}")
    first8 = steps8[0]
    check(bool(torch.isfinite(first8).all())
          and bool(torch.isfinite(logits8).all()),
          "phase 8b: decode logits not finite")
    peak8b = torch.cuda.max_memory_allocated()
    # One more step under torch.profiler: its device time by operation
    # (self time of each aten op's kernels), against the steps' mean wall.
    step_dev_ms, step_ops = _step_profile(
        lambda: decode8(params8, tok8, cache8))
    del cache8

    def against(a, b):
        """a against the reference b: errors, the count outside JAX's bound
        (rtol = atol = 2e-2), argmax agreement."""
        d = (a - b).abs()
        return {"max_abs_err": d.max().item(),
                "rel_to_max_logit": d.max().item() / b.abs().max().item(),
                "outside_jax_bound": int((d > 2e-2 + 2e-2 * b.abs()).sum()),
                "logits": d.numel(),
                "argmax_agreement": (a.argmax(-1) == b.argmax(-1)).float()
                .mean().item()}

    # Decoding token S from the cache against one full forward over S + 1
    # tokens at position S.  In bf16 two full forwards of S + 1 and S + 2
    # tokens differ at position S too (the rounding of a random 36-layer
    # model under another GEMM and chunk shape): that is printed beside
    # it.  JAX's bound is held on the same model in fp32, JAX's test's
    # dtype (cache of 2,048 slots, the 1,535 past the prompt masked).
    full8 = torch.cat([prompt8["tokens"], first_tok8], 1)
    with torch.no_grad():
        ref8 = forward_logits(cfg8, params8, full8)[:, s8]
        floor8 = forward_logits(cfg8, params8,
                                torch.cat([full8, first_tok8], 1))[:, s8]
    bf16_check = against(first8, ref8)
    bf16_floor = against(floor8, ref8)
    cfg32 = dataclasses.replace(cfg8, dtype="float32")
    params32 = init_model(cfg32, seed=SEED)
    cache32 = init_cache(cfg32, b8, 2_048)
    _, cache32 = make_prefill_step(cfg32)(params32, prompt8, cache32)
    dec32, cache32 = make_decode_step(cfg32)(params32, first_tok8, cache32)
    with torch.no_grad():
        ref32 = forward_logits(cfg32, params32, full8)[:, s8]
    fp32_check = against(dec32, ref32)
    check(fp32_check["outside_jax_bound"] == 0,
          f"phase 8b: fp32 decode against the full forward {fp32_check}")
    del params32, cache32, dec32, ref32, ref8, floor8
    torch.cuda.empty_cache()
    emit({"phase": "lm_serve", "card": card, "batch": b8, "prompt": s8,
          "gen": g8, "cache_slots": smax8, "cache_bytes": cbytes8,
          "prefill_s": prefill_ms / 1e3,
          "prefill_warm_s": prefill_warm_ms / 1e3,
          "decode_s": decode_s, "decode_tokens_per_s": g8 * b8 / decode_s,
          "decode_ms_per_step": decode_s * 1e3 / g8, "lengths": lengths8,
          "profiled_step_device_ms": step_dev_ms,
          "profiled_step_device_ms_by_op": step_ops,
          "decode_idle_share": 1.0 - step_dev_ms / (decode_s * 1e3 / g8),
          "max_memory_allocated": peak8b,
          "generated_ids_row0": [int(t[0]) for t in ids8],
          "decode_vs_forward_bf16": bf16_check,
          "forward_vs_forward_bf16": bf16_floor,
          "decode_vs_forward_fp32": fp32_check})

    # 9e on qwen3-8b (phase 9's int8 KV cache, run here on phase 8's
    # weights before 8c frees them): the same prompts into an int8 cache
    # of the same 32,768 slots, and 8b's 32 tokens fed step by step.
    emit({"phase": "lm_int8", "card": card, "step": "9e",
          **int8_against(cfg8, params8, prompt8, ids8, steps8, smax8)})
    del steps8

    # 8c: linear probes of the activations (4 x 4,096 tokens: a 16,384 x
    # 4,096 fp32 design, the embedding in fp32 as the JAX package's probe).
    ptok8 = make_smoke_batch(cfg8, seed=SEED + 9, batch=4, seq=4096)[
        "tokens"]
    with torch.no_grad():
        feats8, feat_ms = timed(lambda: probe_features(cfg8, params8,
                                                       ptok8))
    del params8
    torch.cuda.empty_cache()
    check(tuple(feats8.shape) == (16_384, 4_096)
          and feats8.dtype == torch.float32
          and bool(torch.isfinite(feats8).all()),
          f"phase 8c: features {tuple(feats8.shape)} {feats8.dtype}")
    f64 = feats8.double()
    sv8 = torch.linalg.svdvals(f64)
    thr8 = 128
    # Algorithm 2 moves a block's columns at once (Jacobi within the
    # block): with omega * lambda_max(D^-1/2 G_b D^-1/2) over 2 a block
    # step raises the SSE.  The probe runs the paper's omega 1, and
    # omega = 1 / lambda_max, the largest over blocks.
    xb8 = f64.view(f64.shape[0], -1, thr8)
    lam8 = 0.0
    for blk in range(xb8.shape[1]):
        g = xb8[:, blk].T @ xb8[:, blk]
        dn = g.diagonal().rsqrt()
        lam8 = max(lam8, torch.linalg.eigvalsh(dn[:, None] * g * dn[None])
                   .max().item())
    del xb8
    omega8 = 1.0 / lam8
    h8 = prepare(feats8, SolverSpec(method="bakp_stream", thr=thr8))
    x_t8, inv8 = h8.x_t_for(thr8), h8.inv_cn_for(thr8)
    emit({"phase": "lm_probe_design", "card": card,
          "shape": list(feats8.shape), "features_s": feat_ms / 1e3,
          "singular_value_max": sv8[0].item(),
          "singular_value_min": sv8[-1].item(),
          "condition_number": (sv8[0] / sv8[-1]).item(),
          "block_jacobi_lambda_max": lam8, "omega": omega8,
          "mean_direction_energy": (feats8.mean(0).norm() ** 2
                                    * feats8.shape[0]
                                    / feats8.norm() ** 2).item()})

    def relnorm(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    def probe_fit(target, **kw):
        consume_dispatch()
        res, ms = timed(lambda: fit_linear_probe(feats8, target, **kw))
        return res, ms, consume_dispatch()

    def stream_vs_plain(res, target, omega):
        """The streaming kernel's coef against stream_solve_plain on the
        same operands at the same sweeps."""
        inv_cn, a0m, e0 = solve_init(x_t8, target, inv8, None,
                                     target.dim() == 2)
        cp, *_ = stream_solve_plain(
            x_t8, inv_cn, e0, a0m, block=thr8, max_iter=int(res.n_sweeps),
            atol_sse=0.0, rtol=0.0, omega=omega)
        ck = res.coef.reshape(cp.shape)
        fin = torch.isfinite(ck)
        same = torch.equal(fin, torch.isfinite(cp))
        if bool(fin.all()) and same:
            return rel(ck, cp), same
        return None, same

    rng8 = np.random.default_rng(SEED + 10)
    probe_rows = []
    for k8 in (1, 8):
        w8 = torch.tensor(rng8.standard_normal(
            (d8,) if k8 == 1 else (d8, k8)).astype(np.float32), device=dev)
        target8 = feats8 @ w8
        ls8 = torch.linalg.lstsq(f64, target8.double()).solution
        # bakp_gram (plain torch, cuBLAS Cholesky): warm-started chunks of
        # GRAM_CHUNK sweeps until the planted readout is recovered to
        # JAX's bound, at most PROBE_GRAM_MAX_SWEEPS.
        coef, sweeps, gram_ms, trail = None, 0, 0.0, []
        while sweeps < PROBE_GRAM_MAX_SWEEPS:
            res, ms, path_g = probe_fit(target8, method="bakp_gram",
                                        thr=thr8, max_iter=GRAM_CHUNK,
                                        a0=coef)
            coef = res.coef
            sweeps += int(res.n_sweeps)
            gram_ms += ms
            trail.append([sweeps, relnorm(coef, w8)])
            # Recovered, or the solver's own stopping rule fired.
            if trail[-1][1] < 1e-2 or int(res.n_sweeps) < GRAM_CHUNK:
                break
        err_gram = relnorm(coef, w8)
        check(err_gram < 1e-2,
              f"phase 8c k {k8}: bakp_gram |coef - w|/|w| {err_gram} after "
              f"{sweeps} sweeps")
        check(path_g == "xla", f"phase 8c k {k8}: bakp_gram path {path_g}")
        row = {"phase": "lm_probe", "card": card, "k": k8,
               "lstsq_fp64_err_vs_w": relnorm(ls8, w8),
               "bakp_gram": {"path": path_g, "sweeps": sweeps,
                             "ms": gram_ms, "err_vs_w": err_gram,
                             "err_vs_lstsq": relnorm(coef, ls8),
                             "err_vs_w_by_sweeps": trail}}
        # bakp_stream (the streaming kernel) at the paper's omega 1 and at
        # omega = 1 / lambda_max.
        for label, omega, kw in (
                ("bakp_stream_omega_1", 1.0, dict(method="bakp_stream",
                                                  thr=thr8)),
                ("bakp_stream_omega_inv_lambda", omega8, dict(
                    spec=SolverSpec(method="bakp_stream", thr=thr8,
                                    omega=omega8, max_iter=STREAM_PROBE_ITERS,
                                    rtol=1e-7)))):
            res, ms, path = probe_fit(target8, **kw)
            check(path == "stream", f"phase 8c k {k8} {label}: path {path}")
            err_plain, same_finite = stream_vs_plain(res, target8, omega)
            finite = bool(torch.isfinite(res.coef).all())
            row[label] = {"path": path, "omega": omega,
                          "sweeps": int(res.n_sweeps),
                          "converged": bool(res.converged), "ms": ms,
                          "finite": finite,
                          "rel_err_vs_plain": err_plain,
                          "finite_where_plain_is": same_finite,
                          "err_vs_w": relnorm(res.coef, w8) if finite
                          else None,
                          "err_vs_lstsq": relnorm(res.coef, ls8) if finite
                          else None}
            if omega != 1.0:
                check(err_plain is not None and err_plain <= 1e-5,
                      f"phase 8c k {k8} {label}: coef {err_plain} from "
                      f"stream_solve_plain at {int(res.n_sweeps)} sweeps")
        emit(row)
        probe_rows.append(row)
    read_launches("phase_8_lm")
    del feats8, f64, h8, x_t8
    torch.cuda.empty_cache()
    watchdog.cancel()
    emit({"phase": "lm_done", "card": card,
          "seconds": time.perf_counter() - t_phase8})

    # -------------------- every attention and cache variant (phase 9)
    # Four more models at full width and depth, random bf16 weights from
    # SEED: (9a) h2o-danube-1.8b's SWA ring, prompts past the window;
    # (9b) gemma2-9b's local/global pairs, softcaps and post-norms, local
    # rings wrapped; (9c) minicpm3-4b's MLA latent cache; (9d)
    # qwen2-vl-2b's M-RoPE streams; (9e) the int8 KV cache on 9a's ring
    # (on qwen3-8b in phase 8).  Each model's decode step is profiled and
    # held to one full forward at JAX's bound in fp32 (``lm_family``).
    def hung9():
        print(f"chip_smoke: phase 9 did not finish in {PHASE9_WATCHDOG_S} s "
              f"(a hang on the LM variants)", file=sys.stderr, flush=True)
        os._exit(3)

    watchdog = threading.Timer(PHASE9_WATCHDOG_S, hung9)
    watchdog.daemon = True
    watchdog.start()
    t_phase9 = time.perf_counter()
    _build.reset_launch_counts()
    torch.cuda.empty_cache()
    held9 = torch.cuda.memory_allocated()

    variants9 = [lm_family(dict(spec, row="lm_variant", seed_offset=90,
                                reduced=[]),
                           dev=dev, card=card, against=against, held=held9,
                           int8_against=int8_against) for spec in (
        # 9a: 4 prompts of the window plus 512, so the prefill roll runs;
        # the ring of 4,096 slots; fp32 check past the window, B 2; 9e's
        # int8 ring.
        {"step": "9a", "arch": "h2o-danube-1.8b",
         "shape": (24, 2560, 32, 8, 80, 6912, 32000),
         "params": 1_831_201_280, "cache_bytes_b4": 1_006_632_976,
         "prompt": 4_608, "check": (2, 4_608, 4_609), "int8_slots": 4_609},
        # 9b: the local rings wrap; 32,768 global slots; fp32 check on
        # 8,192 slots, B 2.
        {"step": "9b", "arch": "gemma2-9b",
         "shape": (42, 3584, 16, 8, 256, 14336, 256000),
         "params": 9_241_705_984, "cache_bytes_b4": 25_367_150_608,
         "prompt": 4_608, "check": (2, 4_608, 8_192)},
        # 9c: 32,768 latent slots; fp32 check as phase 8's (2,048 slots).
        {"step": "9c", "arch": "minicpm3-4b",
         "shape": (62, 2560, 40, 40, 96, 6400, 73448),
         "params": 4_262_025_728, "cache_bytes_b4": 4_680_843_280,
         "prompt": 512, "check": (4, 512, 2_048)},
        # 9d: JAX's arange position streams; 32,768 slots.
        {"step": "9d", "arch": "qwen2-vl-2b",
         "shape": (28, 1536, 12, 2, 128, 8960, 151936),
         "params": 1_543_853_568, "cache_bytes_b4": 3_758_096_400,
         "prompt": 512, "check": (4, 512, 2_048)})]
    mla9 = get_arch("minicpm3-4b")
    per_head9 = (mla9.n_layers * 32_768 * mla9.n_heads
                 * (mla9.qk_nope_dim + mla9.qk_rope_dim + mla9.v_head_dim)
                 * 2 * 2)
    mla_bytes9 = cache_bytes(mla9, 1, 32_768)
    check(mla_bytes9 < per_head9 / 10,
          f"phase 9c: MLA cache {mla_bytes9} bytes, not under 1/10 of a "
          f"per-head cache's {per_head9}")
    counts9 = {**_build.launch_counts(), **_build.launch_counts(2)}
    check(not any(counts9.values()),
          f"phase 9: the LM variants launched kernels {counts9}")
    watchdog.cancel()
    emit({"phase": "lm_variants_done", "card": card,
          "seconds": time.perf_counter() - t_phase9,
          "mla_cache_bytes_b1_32768": mla_bytes9,
          "per_head_cache_bytes_b1_32768": per_head9,
          "mla_over_per_head": mla_bytes9 / per_head9,
          "kernel_launches": counts9,
          "summary": {r["arch"]: {
              "decode_ms_per_step": r["decode_ms_per_step"],
              "step_bound_ms": r["step_bound_ms"],
              "prefill_warm_s": r["prefill_warm_s"],
              "fp32_outside_jax_bound":
                  r["decode_vs_forward_fp32"]["outside_jax_bound"]}
              for r in variants9}})

    # ------------------- the MoE, SSM and hybrid families (phase 10)
    # Four models at full width, random bf16 weights from SEED, each built,
    # served through launch/steps and checked in fp32, then freed: (10a)
    # dbrx-132b and (10b) arctic-480b (its dense residual on), depth cut to
    # what one card holds; (10c) mamba2-370m and (10d) zamba2-7b at full
    # depth, 4 x 4,000 tokens (16 chunks of 256, the last padded).
    def hung10():
        print(f"chip_smoke: phase 10 did not finish in {PHASE10_WATCHDOG_S}"
              f" s (a hang on the MoE, SSM and hybrid families)",
              file=sys.stderr, flush=True)
        os._exit(3)

    watchdog = threading.Timer(PHASE10_WATCHDOG_S, hung10)
    watchdog.daemon = True
    watchdog.start()
    t_phase10 = time.perf_counter()
    _build.reset_launch_counts()
    torch.cuda.empty_cache()
    held10 = torch.cuda.memory_allocated()
    families10 = [lm_family(dict(spec, row="lm_family", seed_offset=100),
                            dev=dev, card=card, against=against,
                            held=held10) for spec in (
        {"step": "10a", "arch": "dbrx-132b",
         "shape": (40, 6144, 48, 8, 128, 10752, 100352), "depth": 6,
         "params": 20_787_640_320, "prompt": 512, "check_depth": 2,
         "check": (4, 512, 2_048),
         "reduced": ["n_layers 40 -> 6: 40 layers are 263 GB of bf16 "
                     "weights, 6 are 41.6 GB; fp32 check at 2 layers "
                     "(31 GB)"]},
        {"step": "10b", "arch": "arctic-480b",
         "shape": (35, 7168, 56, 8, 128, 4864, 32000), "depth": 2,
         "params": 27_681_131_520, "prompt": 512, "check_depth": 1,
         "check": (4, 512, 2_048),
         "reduced": ["n_layers 35 -> 2: 35 layers are 954 GB of bf16 "
                     "weights, 2 are 55.4 GB; fp32 check at 1 layer "
                     "(56 GB)"]},
        # The SSM cache has no slots: its max_cache_len (524,288) sizes
        # nothing.
        {"step": "10c", "arch": "mamba2-370m",
         "shape": (48, 1024, 32, 32, 64, 0, 50280),
         "params": 368_494_080, "prompt": 4_000, "check": (4, 4_000, 4_001),
         "reduced": []},
        {"step": "10d", "arch": "zamba2-7b",
         "shape": (81, 3584, 32, 32, 112, 14336, 32000),
         "params": 5_773_198_656, "prompt": 4_000, "slots": 32_768,
         "check": (2, 4_000, 8_192),
         "reduced": ["max_cache_len 524,288 -> 32,768 slots of the shared "
                     "attention's K/V: 390 GB at B 4, 24.9 GB cut"]})]
    mamba10 = get_arch("mamba2-370m")
    state_bytes10 = {str(n_): cache_bytes(mamba10, 4, n_)
                     for n_ in (4_032, 32_768, mamba10.max_cache_len)}
    check(len(set(state_bytes10.values())) == 1,
          f"phase 10c: mamba2's state bytes vary with the length "
          f"{state_bytes10}")
    counts10 = {**_build.launch_counts(), **_build.launch_counts(2)}
    check(not any(counts10.values()),
          f"phase 10: the MoE, SSM and hybrid families launched kernels "
          f"{counts10}")
    watchdog.cancel()
    emit({"phase": "lm_families_done", "card": card,
          "seconds": time.perf_counter() - t_phase10,
          "mamba2_state_bytes_b4_by_length": state_bytes10,
          "kernel_launches": counts10,
          "summary": {r["arch"]: {
              "layers": r["layers"], "reduced": r["reduced"],
              "decode_ms_per_step": r["decode_ms_per_step"],
              "step_bound_ms": r["step_bound_ms"],
              "decode_idle_share": r["decode_idle_share"],
              "prefill_warm_s": r["prefill_warm_s"],
              "max_memory_allocated": r["max_memory_allocated"],
              "fp32_check": r.get("decode_moe_vs_no_capacity_fp32",
                                  r.get("decode_vs_forward_fp32"))}
              for r in families10}})

    # ------------------------------ the enc-dec family (phase 11)
    # seamless-m4t-large-v2 at full width and depth (24 + 24 layers),
    # random bf16 weights from SEED: 4 prompts of 512 target tokens with
    # frames (4, 4,096, 1,024), so the source fills src_len_for_decode and
    # decode equals the full forward; 32,768 self-attention slots.
    def hung11():
        print(f"chip_smoke: phase 11 did not finish in {PHASE11_WATCHDOG_S}"
              f" s (a hang on the enc-dec family)", file=sys.stderr,
              flush=True)
        os._exit(3)

    watchdog = threading.Timer(PHASE11_WATCHDOG_S, hung11)
    watchdog.daemon = True
    watchdog.start()
    t_phase11 = time.perf_counter()
    _build.reset_launch_counts()
    torch.cuda.empty_cache()
    held11 = torch.cuda.memory_allocated()
    sm11 = get_arch("seamless-m4t-large-v2")
    encdec11 = lm_family(
        {"step": "11", "arch": "seamless-m4t-large-v2", "row": "lm_encdec",
         "seed_offset": 110, "shape": (24, 1024, 16, 16, 64, 8192, 256206),
         "encdec": (24, 24, 4096), "params": 2_034_886_656,
         "n_params_gap": sm11.n_dec_layers * sm11.d_model
         * sm11.n_kv_heads * sm11.resolved_head_dim,
         "cache_bytes_b4": 14_495_514_640, "prompt": 512, "frames": 4_096,
         "check": (2, 512, 2_048), "reduced": []},
        dev=dev, card=card, against=against, held=held11)
    counts11 = {**_build.launch_counts(), **_build.launch_counts(2)}
    check(not any(counts11.values()),
          f"phase 11: the enc-dec family launched kernels {counts11}")
    watchdog.cancel()
    emit({"phase": "lm_encdec_done", "card": card,
          "seconds": time.perf_counter() - t_phase11,
          "kernel_launches": counts11,
          "summary": {k: encdec11[k] for k in (
              "prefill_warm_s", "prefill_encoder_s", "prefill_decoder_s",
              "decode_ms_per_step", "step_bound_ms", "decode_idle_share",
              "max_memory_allocated", "decode_vs_forward_fp32",
              "decode_vs_forward_bf16", "forward_vs_forward_bf16")}})

    # ---------------------------------------- training (phase 12)
    # (12a) seamless-m4t-large-v2 at full width and depth, (12b) qwen3-8b
    # at full width and 4 of its 36 layers, each 20 steps of
    # make_train_step with its config's AdamW, remat "full" and
    # microbatching, a restart from a checkpoint and the microbatch
    # equivalence in fp32 (``train_family``).
    def hung12():
        print(f"chip_smoke: phase 12 did not finish in {PHASE12_WATCHDOG_S}"
              f" s (a hang in training)", file=sys.stderr, flush=True)
        os._exit(3)

    watchdog = threading.Timer(PHASE12_WATCHDOG_S, hung12)
    watchdog.daemon = True
    watchdog.start()
    t_phase12 = time.perf_counter()
    _build.reset_launch_counts()
    torch.cuda.empty_cache()
    held12 = torch.cuda.memory_allocated()
    root = Path(__file__).resolve().parent
    trained12 = [train_family(dict(spec, seed_offset=120), dev=dev,
                              card=card, held=held12, ckpt_root=root)
                 for spec in (
        {"step": "12a", "arch": "seamless-m4t-large-v2", "microbatch": 2,
         "batch": 8, "seq": 512, "params": 2_034_886_656,
         "n_params_gap": sm11.n_dec_layers * sm11.d_model
         * sm11.n_kv_heads * sm11.resolved_head_dim,
         "mb_layers": {"n_enc_layers": 2, "n_dec_layers": 2},
         "reduced": []},
        {"step": "12b", "arch": "qwen3-8b", "depth": 4, "microbatch": 4,
         "batch": 8, "seq": 1_024, "params": 2_017_498_112,
         "mb_layers": {"n_layers": 2},
         "reduced": ["n_layers 36 -> 4: AdamW state of 131 GB in full "
                     "(16 bytes a parameter), 32 GB at 4 layers; the fp32 "
                     "microbatch check at 2 layers"]})]
    counts12 = {**_build.launch_counts(), **_build.launch_counts(2)}
    check(not any(counts12.values()),
          f"phase 12: training launched kernels {counts12}")
    watchdog.cancel()
    emit({"phase": "train_done", "card": card,
          "seconds": time.perf_counter() - t_phase12,
          "kernel_launches": counts12,
          "summary": {r["arch"]: {k: r[k] for k in (
              "layers", "reduced", "step_ms_median_warm", "tokens_per_s",
              "model_flop_share_bf16_peak", "step_idle_share",
              "max_memory_allocated",
              "opt_state_bytes", "ce_first5_mean", "ce_last5_mean")}
              for r in trained12}})

    kernel_src = "src/repro_torch/kernels/csrc/"
    src_of = {
        "bakp_sweep": ("bakp_sweep.cu", "src/repro/kernels/cd_sweep.py:108"),
        "fused_solve": ("fused_solve.cu",
                        "src/repro/kernels/fused_solve.py:94"),
        "bak_sweep": ("bak_sweep.cu", "src/repro/kernels/cd_sweep.py:75"),
        "bak_fused": ("bak_fused.cu",
                      "src/repro/kernels/fused_solve.py:139"),
        "score_features": ("score_features.cu",
                           "src/repro/kernels/block_update.py:69"),
        "block_update": ("block_update.cu",
                         "src/repro/kernels/block_update.py:24"),
        "stream_solve": ("stream_solve.cu",
                         "src/repro/kernels/stream_solve.py:87")}
    src_of.update({_build.launch_key(n, 2): src_of[n]
                   for n in _build.X_KERNELS})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": kernel_src + src_of[name][0],
         "replaces": src_of[name][1], "launches": launches[name],
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name]["library_ms"]}
        for name in src_of]})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    if _failures:
        print("chip_smoke: FAILED:\n  " + "\n  ".join(_failures),
              file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
