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
     the kernel rows of item 6), eight flushes on Gaussian designs from a
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
  6. each kernel against its plain torch version on the same inputs, on the
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
  7. a ``kernels`` summary line (the bf16 kernels as ``<name>_bf16``;
     launches summed over the paths), the card's name and power limit,
     and the result line
     ``{"ok": true, "device": {...}}``.

Launch counts are reset just before each path (phases 1-2, the earlier
slices' path; phase 3, the streaming path; phase 4, the mixed-precision
path, where each bf16 kernel must launch; phase 5, the serving path) and
read just after it, so they count that path only; each kernel must have
launched on its path.  Inputs
are Gaussian designs with a planted ``a_true`` and ``y = x @ a_true`` from
a fixed seed.  Any failed check, build or launch error exits non-zero
without the result line; so does a host with no CUDA device, or a
directory without the repository's ``src/``.
"""
from __future__ import annotations

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
# Phase 5's watchdog: a serving path that has not finished by then is a
# hang, and the script exits non-zero instead of waiting on it.
PHASE5_WATCHDOG_S = 120

_failures: list = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        _failures.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)


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
                            "stream_solve")}
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
    check(not h3.resident and h3.blocks.host.x_t.is_pinned(),
          "the non-resident handle must hold a pinned host copy")
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
    x3_host = h3.blocks.host.x_t
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
