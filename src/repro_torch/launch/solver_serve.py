"""Solver-serving command line of the PyTorch port: pump a synthetic
multi-tenant request stream through ``repro_torch.serve`` and report
throughput.

Counterpart of ``repro.launch.solver_serve``, synchronous windows only:

    PYTHONPATH=src python -m repro_torch.launch.solver_serve \\
        --requests 256 --obs 2048 --vars 256 --designs 8 \\
        --method bakp_gram --flush-every 32 --check

On the CPU pass ``--device cpu`` (the default device is the GPU, and the
engine raises without one).  ``--designs D`` controls design reuse:
requests cycle over D distinct matrices, so every flush window sees
same-design groups (coalesced into multi-RHS solves) and, across windows,
design-cache hits.  ``--designs`` equal to ``--requests`` gives an
all-unique stream (batches across designs); ``--designs 1`` puts
everything on one multi-RHS solve.  ``--tenants T`` tags requests with
recurring tenant ids, so repeated (design, tenant) pairs warm-start.

Not in this slice: ``--mode async`` (the async dispatcher), ``--mesh``
(mesh placements) and ``--store-*`` (the tiered design store) exit with a
message naming the slice that brings them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs

# Flags of the JAX command line that this slice does not serve, and the
# slice that brings each.
_LATER = {
    "mode": "--mode async needs the async dispatcher, a later slice of "
            "the PyTorch port",
    "mesh": "--mesh needs mesh placements, which arrive with the PyTorch "
            "port's multi-GPU slice",
    "store": "--store-* needs the tiered DesignStore, which arrives with "
             "the PyTorch port's design-store slice",
}


def build_requests(rng, xs, n, method, max_iter, rtol, thr, tenants=0,
                   precision="fp32", refine_sweeps=None):
    """Requests cycling over the shared design matrices ``xs``
    (``design_key`` is trusted identity, reused only for the same
    matrix)."""
    from repro_torch.serve import SolveRequest, SolverSpec

    kw = {} if refine_sweeps is None else {"refine_sweeps": refine_sweeps}
    spec = SolverSpec(method=method, max_iter=max_iter, rtol=rtol, thr=thr,
                      precision=precision, **kw)
    designs = len(xs)
    nvars = xs[0].shape[1]
    reqs = []
    for i in range(n):
        d = i % designs
        a = rng.normal(size=(nvars,)).astype(np.float32)
        reqs.append(SolveRequest(
            x=xs[d], y=xs[d] @ a, spec=spec,
            design_key=f"design-{d}", request_id=f"req-{i}",
            tenant_id=f"tenant-{i % tenants}" if tenants else None))
    return reqs


def report_engine(engine):
    s = engine.stats
    print(f"solver calls: {s.solver_calls} "
          f"(multi_rhs groups={s.multi_rhs_groups} "
          f"covering {s.multi_rhs_requests} reqs; "
          f"vmap batches={s.vmap_batches} covering {s.vmap_requests} reqs; "
          f"singles={s.single_solves}; warm starts={s.warm_starts}; "
          f"failures={s.failures}; retries={s.retries})")
    c = engine.cache.stats
    print(f"design cache: {c.hits} hits / {c.misses} misses "
          f"(hit rate {c.hit_rate:.1%}), {len(engine.cache)} resident")
    lanes = engine.lanes.stats()
    if lanes:
        mix = "; ".join(
            f"{label}: {ls['batches']} batches/{ls['requests']} reqs "
            f"busy {ls['busy_s']*1e3:.0f}ms"
            for label, ls in sorted(lanes.items()))
        print(f"execution lanes: {mix}")


def run_sync(args, engine, reqs):
    results = []
    t0 = time.perf_counter()
    for lo in range(0, len(reqs), args.flush_every):
        for r in reqs[lo:lo + args.flush_every]:
            engine.submit(r)
        results.extend(engine.flush())
    wall = time.perf_counter() - t0
    lat = np.array([r.latency_s for r in results])
    kinds = {k: sum(r.batch_kind == k for r in results)
             for k in ("multi_rhs", "vmap", "single", "error")}
    print(f"served {len(results)} requests in {wall:.3f}s "
          f"-> {len(results)/wall:.1f} solves/s on {engine.device}")
    print(f"latency p50={np.percentile(lat, 50)*1e3:.2f}ms "
          f"p95={np.percentile(lat, 95)*1e3:.2f}ms "
          f"max={lat.max()*1e3:.2f}ms (batch wall time per request)")
    print(f"batch mix: {kinds}")
    report_engine(engine)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve a synthetic request stream through "
                    "repro_torch.serve (synchronous windows)")
    ap.add_argument("--mode", choices=["sync", "async"], default="sync")
    ap.add_argument("--device", default=None,
                    help="torch device for designs and solves (default: "
                         "cuda; pass 'cpu' for the plain torch path)")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--obs", type=int, default=2048)
    ap.add_argument("--vars", type=int, default=256)
    ap.add_argument("--designs", type=int, default=8)
    ap.add_argument("--method", default="bakp_gram",
                    help="solver method; any name in "
                         "repro_torch.core.method_names()")
    ap.add_argument("--max-iter", type=int, default=40)
    ap.add_argument("--rtol", type=float, default=1e-10)
    ap.add_argument("--thr", type=int, default=128)
    ap.add_argument("--flush-every", type=int, default=32,
                    help="requests per flush window")
    ap.add_argument("--tenants", type=int, default=0,
                    help="recurring tenant ids (0 = off; enables warm starts)")
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16", "bf16_fp32acc"],
                    help="X-stream storage precision (SolverSpec.precision); "
                         "methods without it downgrade to fp32, counted in "
                         "solver_fallback_total{reason='precision'}")
    ap.add_argument("--refine-sweeps", type=int, default=None,
                    help="fp32 polish-sweep cap for bf16_fp32acc")
    ap.add_argument("--prefer-fused", action="store_true",
                    help="upgrade 'bakp' requests to the whole-solve CUDA "
                         "kernel ('bakp_fused') when the bucket fits the "
                         "card's on-chip budget")
    ap.add_argument("--no-lanes", action="store_true",
                    help="run every batch on one serial lane (one thread, "
                         "one stream; results are bit-identical)")
    ap.add_argument("--fault-plan", default=None, metavar="JSON",
                    help="chaos harness: inline JSON or a JSON file mapping "
                         "fault sites to rules, e.g. "
                         "'{\"solver.raise\": {\"count\": 3}}'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="verify every request against fp64 numpy lstsq")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the final metrics-registry snapshot to PATH")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the run into DIR")
    ap.add_argument("--mesh", default=None, help=_LATER["mesh"])
    ap.add_argument("--store-device-bytes", type=int, default=None,
                    help=_LATER["store"])
    ap.add_argument("--store-host-bytes", type=int, default=None,
                    help=_LATER["store"])
    ap.add_argument("--store-dir", default=None, help=_LATER["store"])
    args = ap.parse_args(argv)

    if args.mode != "sync":
        raise SystemExit(_LATER["mode"])
    if args.mesh is not None:
        raise SystemExit(_LATER["mesh"])
    if (args.store_device_bytes is not None
            or args.store_host_bytes is not None
            or args.store_dir is not None):
        raise SystemExit(_LATER["store"])

    from repro_torch.core import method_names
    from repro_torch.serve import ServeConfig, SolverServeEngine

    if args.method not in method_names():
        raise SystemExit(
            f"--method must be one of {method_names()}, got {args.method!r}")
    rng = np.random.default_rng(args.seed)
    engine = SolverServeEngine(
        ServeConfig(prefer_fused=args.prefer_fused,
                    lane_execution=not args.no_lanes,
                    precision=(args.precision if args.precision != "fp32"
                               else None),
                    fault_plan=args.fault_plan),
        device=args.device)
    xs = [rng.normal(size=(args.obs, args.vars)).astype(np.float32)
          for _ in range(args.designs)]
    req_kw = dict(tenants=args.tenants, precision=args.precision,
                  refine_sweeps=args.refine_sweeps)
    reqs = build_requests(rng, xs, args.requests, args.method, args.max_iter,
                          args.rtol, args.thr, **req_kw)
    # Warm-up window: builds the kernels on first use, the design cache
    # and the (design, tenant) warm state, so the timed stream measures
    # steady serving.
    for _ in range(2 if args.tenants else 1):
        engine.serve(build_requests(
            rng, xs, min(args.flush_every, args.requests), args.method,
            args.max_iter, args.rtol, args.thr, **req_kw))

    if args.trace_dir:
        obs.start_profiling(args.trace_dir)
    try:
        results = run_sync(args, engine, reqs)
    finally:
        if args.trace_dir:
            obs.stop_profiling()
            print(f"profiler trace written to {args.trace_dir}")
        if args.metrics_json:
            obs.write_metrics_json(
                args.metrics_json, registry=engine.registry,
                extra={"mode": args.mode, "method": args.method,
                       "requests": args.requests, "obs": args.obs,
                       "vars": args.vars, "designs": args.designs,
                       "device": str(engine.device)})
            print(f"metrics snapshot written to {args.metrics_json}")
        engine.shutdown()

    lat_h = engine.registry.get("serve_solve_latency_seconds")
    if lat_h is not None and lat_h.count():
        print("solver-call latency (registry): "
              f"p50={lat_h.percentile(50)*1e3:.2f}ms "
              f"p95={lat_h.percentile(95)*1e3:.2f}ms "
              f"p99={lat_h.percentile(99)*1e3:.2f}ms "
              f"over {lat_h.count()} calls")

    failed = [r for r in results if r.error]
    if failed:
        print(f"{len(failed)} requests failed, first: {failed[0].error}")
    if args.check:
        mapes = []
        for r, q in zip(results, reqs):
            ref = np.linalg.lstsq(np.asarray(q.x, np.float64),
                                  np.asarray(q.y, np.float64), rcond=None)[0]
            denom = np.maximum(np.abs(ref), 1e-12)
            mapes.append(float(np.mean(np.abs(r.coef - ref) / denom)))
        print(f"MAPE vs lstsq: mean={np.mean(mapes):.2e} "
              f"worst={np.max(mapes):.2e}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
