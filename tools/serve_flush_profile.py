#!/usr/bin/env python3
"""Where the time of the serving engine's two-lane flush goes, on one GPU.

    python3 tools/serve_flush_profile.py                    # lanes / serial
    python3 tools/serve_flush_profile.py --profile 1        # trace flush 1

Serves ``chip_smoke.py``'s phase-5 flush 3 (16 designs of 4,096 x 256 as
``bakp_gram`` singles, one batch across designs on the plain lane, beside
8 ``bak_fused`` tenants of one 16,384 x 256 design on the fused lane; thr
128, rtol 1e-7, max_iter 100) through a fresh ``SolverServeEngine`` per
flush, in the order ``--order`` gives (``lanes`` or ``serial``, the
latter ``lane_execution=False``), and prints per flush its wall time and
the split of its spans (``engine.*``, the solve span per lane).

Before the flushes the process runs the handle path the earlier phases of
``chip_smoke.py`` run on these shapes (a ``bakp_gram`` and a ``bak_fused``
solve through ``prepare(...).solve``), so the first flush meets the state
phase 5's flush 3 meets: the kernels built, the single-system solvers
used, the batch's own operations (``bmm`` over stacked designs, the
batched ``cholesky_solve``) not yet.  ``--no-warm`` skips that.

``--profile N`` runs flush N (1-based) under ``torch.profiler`` (CPU and
CUDA activity) and prints the operations that took most host time in it
and the device time per kernel; the Chrome trace goes to ``--trace``.

Every flush's coefficients must equal the first flush's bit for bit; the
tool exits 1 otherwise.  Writes every number to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def requests(rng_seed: int):
    from repro_torch.serve import SolveRequest

    rng = np.random.default_rng(rng_seed)
    knobs = dict(thr=128, rtol=1e-7, max_iter=100)
    xg = [rng.standard_normal((4_096, 256), dtype=np.float32)
          for _ in range(16)]
    yg = [x @ rng.standard_normal(256, dtype=np.float32) for x in xg]
    xb = rng.standard_normal((16_384, 256), dtype=np.float32)
    yb = xb @ rng.standard_normal((256, 8), dtype=np.float32)

    def make():
        return ([SolveRequest(x=x, y=y, method="bakp_gram",
                              design_key=f"g{i}", **knobs)
                 for i, (x, y) in enumerate(zip(xg, yg))]
                + [SolveRequest(x=xb, y=yb[:, t], method="bak_fused",
                                design_key="b", **knobs) for t in range(8)])
    return make, xg[0], yg[0], xb, yb


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--order", default="lanes,serial,lanes,serial")
    ap.add_argument("--profile", type=int, default=0)
    ap.add_argument("--no-warm", action="store_true")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/serve_flush_profile.json")
    ap.add_argument("--trace", default="chiprun_out/serve_flush3_trace.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import obs as tobs
    from repro_torch.core import SolverSpec, prepare
    from repro_torch.kernels import _build
    from repro_torch.serve import ServeConfig, SolverServeEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t = time.perf_counter()
    _build.build_all(["bak_fused", "fused_solve"])
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    make, xg0, yg0, xb, yb = requests(args.seed)
    if not args.no_warm:
        knobs = dict(thr=128, rtol=1e-7, max_iter=100)
        prepare(xg0).solve(yg0, spec=SolverSpec(method="bakp_gram", **knobs))
        prepare(xb).solve(yb[:, 0], spec=SolverSpec(method="bak_fused",
                                                    **knobs))
        torch.cuda.synchronize()
    tracer = tobs.get_tracer()
    rows, ref = [], None
    for n, mode in enumerate(args.order.split(","), start=1):
        eng = SolverServeEngine(
            ServeConfig(lane_execution=mode == "lanes"),
            registry=tobs.MetricsRegistry())
        reqs = make()
        tracer.clear()
        prof = None
        if n == args.profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t = time.perf_counter()
        out = eng.serve(reqs)
        wall = time.perf_counter() - t
        if prof is not None:
            prof.__exit__(None, None, None)
        eng.shutdown()
        split = {}
        for sp in tracer.spans():
            name = sp.name.split(".", 1)[1]
            if name == "solve":
                name = f"solve[{sp.tags.get('lane')}:{sp.tags.get('kind')}]"
            split[name] = split.get(name, 0.0) + sp.duration_s * 1e3
        coef = np.stack([r.coef for r in out])
        errors = [r.error for r in out if r.error is not None]
        same = ref is None or np.array_equal(coef, ref)
        ref = coef if ref is None else ref
        row = {"flush": n, "mode": mode, "card": card,
               "wall_ms": wall * 1e3, "split_ms": split,
               "sweeps": [r.n_sweeps for r in out], "errors": errors,
               "bitwise_equal_to_first": bool(same),
               "profiled": prof is not None}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if prof is not None:
            Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(args.trace)
            ka = prof.key_averages()
            print("host time by operation (profiled flush):", flush=True)
            print(ka.table(sort_by="self_cpu_time_total", row_limit=25),
                  flush=True)
            print("device time by kernel (profiled flush):", flush=True)
            try:
                table = ka.table(sort_by="self_cuda_time_total",
                                 row_limit=15)
            except (AttributeError, KeyError, ValueError):
                table = ka.table(sort_by="self_device_time_total",
                                 row_limit=15)
            print(table, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    ok = all(r["bitwise_equal_to_first"] and not r["errors"] for r in rows)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
