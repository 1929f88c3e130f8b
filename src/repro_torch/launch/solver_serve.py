"""Solver-serving command line of the PyTorch port: pump a synthetic
multi-tenant request stream through ``repro_torch.serve`` and report
throughput.

Counterpart of ``repro.launch.solver_serve``.  Synchronous windows:

    PYTHONPATH=src python -m repro_torch.launch.solver_serve \\
        --requests 256 --obs 2048 --vars 256 --designs 8 \\
        --method bakp_gram --flush-every 32 --check

Async deadline-aware dispatch (Poisson arrivals through AsyncDispatcher):

    PYTHONPATH=src python -m repro_torch.launch.solver_serve --mode async \\
        --requests 256 --rate 200 --deadline-ms 500 --max-batch 16 \\
        --tenants 32 --check

A fleet over a device budget (the tiered design store: demotion to pinned
host memory and CRC-checked disk tiles, promotion back, over-budget
designs on the streaming method):

    PYTHONPATH=src python -m repro_torch.launch.solver_serve \\
        --designs 16 --store-device-bytes 8388608 \\
        --store-host-bytes 4194304 --store-dir /path/to/tiles --check

Mesh-sharded placement (big buckets and large same-design groups on the
sharded SolveBakP backends; with ``--device cpu`` the mesh's shards are
virtual CPU shards, on the card it needs that many cards):

    PYTHONPATH=src python -m repro_torch.launch.solver_serve --mesh 4x2 \
        --requests 256 --obs 2048 --vars 256 --designs 4 \
        --shard-min-cells 65536 --rhs-shard-min-k 32

On the CPU pass ``--device cpu`` (the default device is the GPU, and the
engine raises without one).  ``--designs D`` controls design reuse:
requests cycle over D distinct matrices, so every flush window sees
same-design groups (coalesced into multi-RHS solves) and, across windows,
design-cache hits.  ``--designs`` equal to ``--requests`` gives an
all-unique stream (batches across designs); ``--designs 1`` puts
everything on one multi-RHS solve.  ``--tenants T`` tags requests with
recurring tenant ids, so repeated (design, tenant) pairs warm-start; in
async mode each request also carries a deadline and the command reports
the deadline hit rate.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs


def build_requests(rng, xs, n, method, max_iter, rtol, thr, tenants=0,
                   deadline_s=None, precision="fp32", refine_sweeps=None):
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
            tenant_id=f"tenant-{i % tenants}" if tenants else None,
            deadline_s=deadline_s))
    return reqs


def report_engine(engine):
    s = engine.stats
    print(f"solver calls: {s.solver_calls} "
          f"(multi_rhs groups={s.multi_rhs_groups} "
          f"covering {s.multi_rhs_requests} reqs; "
          f"vmap batches={s.vmap_batches} covering {s.vmap_requests} reqs; "
          f"singles={s.single_solves}; warm starts={s.warm_starts}; "
          f"failures={s.failures}; retries={s.retries}; "
          f"sharded={s.sharded_solves})")
    c = engine.cache.stats
    print(f"design cache: {c.hits} hits / {c.misses} misses "
          f"(hit rate {c.hit_rate:.1%}), {len(engine.cache)} resident")
    if engine.store is not None:
        st = engine.store.stats
        print(f"design store: {st.demotions_device} device->host / "
              f"{st.demotions_disk} host->disk demotions, "
              f"{st.promotions_host} host / {st.promotions_disk} disk "
              f"promotions, {st.builds_nonresident} non-resident builds, "
              f"{st.tile_corruptions} quarantined; tiers "
              f"device={engine.store.device_used()}B "
              f"host={engine.store.host_used()}B "
              f"disk={engine.store.disk_used()}B")
    lanes = engine.lanes.stats()
    if lanes:
        mix = "; ".join(
            f"{label}: {ls['batches']} batches/{ls['requests']} reqs "
            f"busy {ls['busy_s']*1e3:.0f}ms"
            for label, ls in sorted(lanes.items()))
        print(f"execution lanes: {mix}")
    if engine.mesh is not None:
        print(f"mesh: {engine.mesh.describe()} on "
              f"{', '.join(engine.mesh.mesh.device_ids())}")


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
    return reqs, results


def run_async(args, engine, reqs):
    """Poisson arrival stream through the deadline-aware dispatcher."""
    from repro_torch.serve import AsyncDispatcher, DispatchConfig

    rng = np.random.default_rng(args.seed + 1)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, size=len(reqs)))
    cfg = DispatchConfig(
        max_queue=args.max_queue,
        backpressure=args.backpressure,
        max_batch=args.max_batch,
        deadline_margin_s=args.deadline_margin_ms / 1e3,
        idle_timeout_s=args.idle_timeout_ms / 1e3,
        default_deadline_s=args.deadline_ms / 1e3,
    )
    tickets = []
    rejected = 0
    with AsyncDispatcher(engine, cfg) as disp:
        t0 = time.perf_counter()
        base = obs.now()  # same clock as every SolveTicket timestamp
        for i, req in enumerate(reqs):
            now = time.perf_counter() - t0
            if arrivals[i] > now:
                time.sleep(arrivals[i] - now)
            try:
                tickets.append((i, disp.submit(req)))
            except Exception:  # QueueFullError under "reject"
                rejected += 1
        disp.drain()
        wall = time.perf_counter() - t0
        results = [t.result(timeout=60.0) for _, t in tickets]
        stats = disp.stats

    lat = np.array([t.completed_at - base - arrivals[i]
                    for i, t in tickets])
    misses = sum(t.deadline_met is False for _, t in tickets)
    served = len(tickets)
    print(f"served {served}/{len(reqs)} requests in {wall:.3f}s "
          f"-> {served/wall:.1f} solves/s on {engine.device} "
          f"(arrival rate {args.rate:.0f}/s, {rejected} rejected)")
    print(f"request latency p50={np.percentile(lat, 50)*1e3:.2f}ms "
          f"p95={np.percentile(lat, 95)*1e3:.2f}ms "
          f"max={lat.max()*1e3:.2f}ms (arrival -> completion)")
    print(f"deadlines: {misses} missed / {served} "
          f"(hit rate {1 - misses/served:.1%} at "
          f"{args.deadline_ms:.0f}ms)")
    print(f"batches fired: full={stats.fired_full} "
          f"deadline={stats.fired_deadline} idle={stats.fired_idle} "
          f"drain={stats.fired_drain}; max inflight={stats.max_inflight}")
    report_engine(engine)
    # Pair results with the requests actually accepted: under "reject"
    # backpressure some submissions never got a ticket.
    return [reqs[i] for i, _ in tickets], results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve a synthetic request stream through "
                    "repro_torch.serve")
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
                    help="sync mode: requests per flush window")
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
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="route big buckets onto a device mesh, e.g. '4' or "
                         "'4x2' (data[xmodel]): that many cards, or virtual "
                         "CPU shards with --device cpu")
    ap.add_argument("--shard-min-cells", type=int, default=None,
                    help="bucket obs_p*vars_p at which solves go obs-sharded "
                         "(default: PlacementPolicy's 2^21)")
    ap.add_argument("--rhs-shard-min-k", type=int, default=32,
                    help="same-design group size at which the k axis shards "
                         "across the data shards")
    ap.add_argument("--store-device-bytes", type=int, default=None,
                    help="device-tier byte budget of the tiered design "
                         "store (repro_torch.store): eviction demotes "
                         "designs to pinned host memory / disk instead of "
                         "deleting them, and over-budget designs serve via "
                         "the streaming 'bakp_stream' method.  Unset (with "
                         "the other --store-* flags) = plain LRU cache")
    ap.add_argument("--store-host-bytes", type=int, default=None,
                    help="host-tier byte budget; overflow spills LRU host "
                         "records to --store-dir (or drops x bytes, "
                         "keeping warm/Cholesky state, when unset)")
    ap.add_argument("--store-dir", default=None, metavar="DIR",
                    help="disk-tier directory for the CRC-checked design "
                         "tile files (unset = no disk tier)")
    # async-mode knobs
    ap.add_argument("--rate", type=float, default=200.0,
                    help="async: Poisson arrival rate (requests/s)")
    ap.add_argument("--deadline-ms", type=float, default=500.0)
    ap.add_argument("--deadline-margin-ms", type=float, default=100.0)
    ap.add_argument("--idle-timeout-ms", type=float, default=20.0)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-queue", type=int, default=1024)
    ap.add_argument("--backpressure", choices=["reject", "block"],
                    default="block")
    args = ap.parse_args(argv)

    from repro_torch.core import method_names
    from repro_torch.serve import (PlacementPolicy, ServeConfig,
                                   SolverServeEngine, build_serve_mesh)

    if args.method not in method_names():
        raise SystemExit(
            f"--method must be one of {method_names()}, got {args.method!r}")
    rng = np.random.default_rng(args.seed)
    smesh, policy = None, None
    if args.mesh:
        try:
            smesh = build_serve_mesh(args.mesh, device=args.device)
        except ValueError as exc:
            raise SystemExit(f"--mesh {args.mesh}: {exc}")
        defaults = PlacementPolicy()
        policy = PlacementPolicy(
            obs_shard_min_cells=(args.shard_min_cells
                                 if args.shard_min_cells is not None
                                 else defaults.obs_shard_min_cells),
            rhs_shard_min_k=args.rhs_shard_min_k)
    engine = SolverServeEngine(
        ServeConfig(placement_policy=policy,
                    prefer_fused=args.prefer_fused,
                    lane_execution=not args.no_lanes,
                    precision=(args.precision if args.precision != "fp32"
                               else None),
                    store_device_bytes=args.store_device_bytes,
                    store_host_bytes=args.store_host_bytes,
                    store_dir=args.store_dir,
                    fault_plan=args.fault_plan),
        mesh=smesh, device=args.device)
    xs = [rng.normal(size=(args.obs, args.vars)).astype(np.float32)
          for _ in range(args.designs)]
    req_kw = dict(tenants=args.tenants, precision=args.precision,
                  refine_sweeps=args.refine_sweeps)
    reqs = build_requests(rng, xs, args.requests, args.method, args.max_iter,
                          args.rtol, args.thr,
                          deadline_s=(args.deadline_ms / 1e3
                                      if args.mode == "async" else None),
                          **req_kw)
    # Warm-up: builds the kernels on first use, the design cache and the
    # (design, tenant) warm state, so the timed stream measures steady
    # serving.  Async batch sizes vary with arrival timing, so that mode
    # warms a range of window sizes.
    if args.mode == "sync":
        warm_sizes = [min(args.flush_every, args.requests)]
    else:
        warm_sizes = sorted({1, 2, 4, args.max_batch, args.designs,
                             2 * args.designs})
    for n in warm_sizes:
        for _ in range(2 if args.tenants else 1):
            engine.serve(build_requests(
                rng, xs, min(n, args.requests), args.method, args.max_iter,
                args.rtol, args.thr, **req_kw))

    if args.trace_dir:
        obs.start_profiling(args.trace_dir)
    try:
        if args.mode == "sync":
            served_reqs, results = run_sync(args, engine, reqs)
        else:
            served_reqs, results = run_async(args, engine, reqs)
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
                       "device": str(engine.device), "mesh": args.mesh})
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
        for r, q in zip(results, served_reqs):
            ref = np.linalg.lstsq(np.asarray(q.x, np.float64),
                                  np.asarray(q.y, np.float64), rcond=None)[0]
            denom = np.maximum(np.abs(ref), 1e-12)
            mapes.append(float(np.mean(np.abs(r.coef - ref) / denom)))
        print(f"MAPE vs lstsq: mean={np.mean(mapes):.2e} "
              f"worst={np.max(mapes):.2e}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
