"""Batched multi-tenant solver-serving engine of the PyTorch port.

Counterpart of ``repro.serve.engine``: ``SolverServeEngine`` turns a stream
of per-tenant ``SolveRequest``s into a small number of batch solves on one
device (the card by default):

  1. **Bucketing** — requests are grouped by padded power-of-two shape (and
     solver config), exactly as the JAX engine groups them, so both solve
     the same padded systems.
  2. **Same-design coalescing** — requests whose design fingerprints match
     are merged into ONE multi-RHS solve: ``y`` becomes (obs, k) and one
     pass over ``x`` serves all k tenants (on the whole-solve kernel, one
     launch).  k is padded to a power of two, as in the JAX engine.
  3. **Batching across designs** — leftover single-design requests of a
     ``batchable`` method in a bucket are stacked into one batch solve
     (``MethodEntry.vmap_one``: plain torch over (B, obs, vars), the
     counterpart of the JAX engine's ``jit(vmap(one))``).
  4. **Design caching** — everything that depends only on ``x`` lives on a
     ``repro_torch.core.PreparedDesign`` handle, memoised across flushes in
     an LRU ``DesignCache`` and warmed on the flush thread.  With
     ``ServeConfig.store_*`` set, the cache is a view over a tiered
     ``repro_torch.store.DesignStore``: eviction demotes (device → pinned
     host → disk tiles) and a miss promotes, and a BAK-family bucket whose
     padded x exceeds the device budget is rerouted to ``bakp_stream``
     (``solver_fallback_total{reason="over_hbm"}``) and served from the
     host or disk tier through the host-block loop.
  5. **Warm starts** — a request may carry ``a0``, or name a ``tenant_id``
     whose last coefficients the design cache retained.  Cold members of
     a coalesced group ride a zero column of the stacked ``a0``.
  6. **Mesh placement** — an engine constructed with a ``ServeMesh`` routes
     buckets onto the mesh-sharded SolveBakP backends
     (``repro_torch.serve.placement``, ``repro_torch.core.distributed``):
     big buckets shard rows over the data axes (``obs_sharded``), large
     same-design multi-RHS groups shard the k axis instead
     (``rhs_sharded``), and opted-in pod-scale buckets go 2-D.  The
     placement is part of the grouping key; the batch across designs stays
     single-device, so sharded buckets solve their leftovers one by one.
  7. **Execution lanes** — ``flush()`` groups, resolves design entries and
     routes each batch to its lane (``repro_torch.serve.lanes``: a thread
     and a CUDA stream per kernel path — the plain torch family, the
     whole-solve kernels, the streaming kernel — and a mesh lane per
     sharded placement, with a stream a distinct card of its mesh), then
     waits for all units.
     Batches on different lanes overlap on the card; batches on one lane
     keep their submission order, so results match the serial engine
     (``ServeConfig.lane_execution=False``: one lane, one stream) bit for
     bit.

Every solve dispatches through ``PreparedDesign.solve`` with the request's
effective ``SolverSpec`` (``spec_for``), so the engine runs the port's
handle API and, through it, the CUDA kernels.  A solve's latency ends
after the lane's stream was synchronised (``obs.sync_device``), so it
counts the device's work, not only its launch.

Flushing is exception-safe: a batch whose solver raises (after the retry
ladder, ``repro_torch.resilience``) is isolated — every request in it gets
an error result and the remaining batches still run.  A CUDA kernel that
fails to build or launch (``kernels._build.KernelError``) fails its batch
at once: the ladder never serves such a request on a plain rung.

The async front end is ``repro_torch.serve.dispatch.AsyncDispatcher``.

Example::

    engine = SolverServeEngine()              # on the GPU
    for x, y in workload:
        engine.submit(SolveRequest(x=x, y=y, method="bakp", rtol=1e-7))
    for served in engine.flush():
        use(served.coef)
"""
from __future__ import annotations

import functools
import itertools
import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.prepare import PreparedDesign, as_f32, resolve_device
from repro_torch.core.spec import SolverSpec, solver_method
from repro_torch.kernels._build import KernelError
from repro_torch.kernels.fused_solve import fused_fits
from repro_torch.resilience import faults, ladder
from repro_torch.serve.batching import (design_fingerprint, group_requests,
                                        next_pow2, pad_x, pad_y,
                                        prepare_request, request_bucket,
                                        rhs_to_device, stage_rhs)
from repro_torch.serve.cache import DesignCache
from repro_torch.launch.mesh import Mesh
from repro_torch.serve.lanes import LaneKey, LanePool, LaneWork, current_lane
from repro_torch.serve.placement import (Placement, PlacementPolicy,
                                         ServeMesh, placement_for_bucket,
                                         placement_for_group)
from repro_torch.serve.types import ServedSolve, SolveRequest
from repro_torch.store.store import DesignStore, TileCorruptionError

# BAK-family methods a store-backed engine rewrites to "bakp_stream" when a
# request's bucket exceeds the device byte budget (spec_for): the same
# block-Jacobi mathematics, served through the store's streaming path
# instead of a resident x copy that could never be admitted.
_STREAM_REROUTE = frozenset(
    {"bak", "bakp", "bakp_gram", "bakp_fused", "bak_fused"})

_log = logging.getLogger(__name__)


@dataclass
class ServeConfig:
    """Engine-level knobs (per-request solver knobs live on SolveRequest);
    the JAX engine's fields and defaults."""

    omega: float = 1.0
    ridge: float = 1e-6
    min_obs: int = 8
    min_vars: int = 8
    coalesce: bool = True        # same-design requests → one multi-RHS solve
    vmap_batch: bool = True      # same-bucket singles → one batch solve
    max_vmap_batch: int = 64     # cap on the batch size (memory bound)
    cache_entries: int = 64      # LRU design-cache capacity
    warm_cache: bool = True      # retain per-tenant coefs for warm starts
    warm_tenants: int = 64       # per-design LRU cap on retained tenants
    prefer_fused: bool = False   # upgrade "bakp" requests to the
    # whole-solve kernel ("bakp_fused") when the bucket fits the card's
    # on-chip budget (kernels.fused_solve.fused_fits): same algorithm and
    # results, one launch a solve, no batching across designs.  A no-op on
    # a mesh engine (the kernel is single-device; counted as
    # solver_fallback_total{reason="unshardable_fused"}).
    placement_policy: Optional[PlacementPolicy] = None  # None → defaults
    omega_2d: float = 0.5        # damping for the 2-D mesh placement (its
    # cross-shard Jacobi block is model-size·thr wide)
    precision: Optional[str] = None  # engine-level X-stream precision policy
    # ("bf16"/"bf16_fp32acc"): applied to legacy per-field requests exactly
    # like omega/ridge (an explicit SolveRequest.spec stays authoritative).
    # Requests whose effective method lacks the precision downgrade to
    # "fp32" with a solver_fallback_total{reason="precision"} count.
    lane_execution: bool = True  # per-kernel-path lanes, each a thread and
    # a CUDA stream; False puts every batch on ONE serial lane.  Results
    # are bit-identical either way.
    store_device_bytes: Optional[int] = None  # device-tier byte budget of
    # the design store (repro_torch.store).  With any store_* knob set, the
    # design cache becomes a view over a DesignStore: eviction demotes
    # designs to pinned host memory / disk instead of deleting them
    # (per-tenant warm starts survive), and a bucket whose padded x alone
    # exceeds this budget is served by the streaming "bakp_stream" method
    # (solver_fallback_total{reason="over_hbm"}).  All three None = no
    # store: the plain LRU cache.
    store_host_bytes: Optional[int] = None    # host-tier budget; overflow
    # spills to store_dir (or drops x bytes, keeping warm/Cholesky state,
    # when store_dir is unset)
    store_dir: Optional[str] = None           # disk-tier directory for the
    # CRC-checked design tile files (None = no disk tier)
    fault_plan: Optional[object] = None  # chaos harness
    # (repro_torch.resilience): a FaultPlan, a {site: rule} dict, inline
    # JSON text or a JSON file path, installed process-wide at
    # construction; None leaves injection disarmed.
    retry_ladder: bool = True    # retry failed/diverged solves down the
    # ladder: cold restart when a warm start is implicated, fp32 when
    # reduced precision is, then MethodEntry.fallback hops
    # (fused → plain → stream → lstsq).  False: first error fails the batch.
    max_retries: int = 3         # ladder steps per request (not per rung)
    retry_backoff_s: float = 0.002  # jittered exponential backoff base
    # between ladder steps; 0 disables the sleep (tests)
    lane_max_restarts: int = 3   # consecutive lane worker-thread deaths
    # before that lane's circuit breaker trips to the serial fallback


@dataclass
class ServeStats:
    """Per-engine counters (the same events stream into the engine's
    ``MetricsRegistry`` as the ``serve_*`` families)."""

    requests: int = 0
    solver_calls: int = 0
    multi_rhs_groups: int = 0
    multi_rhs_requests: int = 0
    vmap_batches: int = 0
    vmap_requests: int = 0
    single_solves: int = 0
    warm_starts: int = 0
    failures: int = 0
    sharded_solves: int = 0      # solver calls routed to a mesh placement
    retries: int = 0             # retry-ladder steps taken (all reasons)

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def _host(v) -> np.ndarray:
    """A solve output (tensor on any device) as a host numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return np.asarray(v).nbytes


class SolverServeEngine:
    """Multi-tenant batched serving front-end for the BAK solver family.

    ``device``: where designs and single-device solves live — default
    ``"cuda"`` (``core.prepare.resolve_device``: raises without a GPU), or
    the mesh's first device when there is a mesh; pass ``device="cpu"`` for
    the plain torch path.  ``mesh`` (optional) is a
    ``repro_torch.serve.placement.ServeMesh`` or a raw
    ``repro_torch.launch.mesh.Mesh`` (wrapped with a ``"model"`` axis as
    the model axis and the others as data); with one, the placement policy
    routes big buckets and groups onto the mesh-sharded solvers.  Anything
    else raises ``TypeError``.
    """

    def __init__(self, config: Optional[ServeConfig] = None, mesh=None,
                 registry: Optional[obs.MetricsRegistry] = None,
                 device=None):
        self.config = config or ServeConfig()
        cfg = self.config
        if isinstance(mesh, Mesh):
            axes = tuple(mesh.axis_names)
            model = "model" if "model" in axes and len(axes) > 1 else None
            data = tuple(a for a in axes if a != model)
            mesh = ServeMesh(mesh=mesh, data_axes=data, model_axis=model)
        elif mesh is not None and not isinstance(mesh, ServeMesh):
            raise TypeError(
                f"mesh must be a ServeMesh or a repro_torch.launch.mesh.Mesh, "
                f"got {type(mesh).__name__}")
        self.mesh: Optional[ServeMesh] = mesh
        self.policy = cfg.placement_policy or PlacementPolicy()
        if device is None and mesh is not None:
            device = mesh.mesh.devices.flat[0]
        self.device = resolve_device(device)
        # One registry for the whole serving stack: the cache and the
        # lanes record into this same instance.
        self.registry = registry or obs.default_registry()
        if cfg.fault_plan is not None:
            faults.install(faults.FaultPlan.coerce(cfg.fault_plan))
        self.store = None
        if (cfg.store_device_bytes is not None
                or cfg.store_host_bytes is not None
                or cfg.store_dir is not None):
            self.store = DesignStore(device_bytes=cfg.store_device_bytes,
                                     host_bytes=cfg.store_host_bytes,
                                     disk_dir=cfg.store_dir,
                                     max_entries=cfg.cache_entries,
                                     registry=self.registry,
                                     device=self.device)
        self.cache = DesignCache(max_entries=cfg.cache_entries,
                                 max_tenants=cfg.warm_tenants,
                                 registry=self.registry, device=self.device,
                                 store=self.store)
        self.lanes = LanePool(registry=self.registry,
                              serial=not cfg.lane_execution,
                              max_restarts=cfg.lane_max_restarts,
                              device=self.device)
        # Work units on different lanes mutate ServeStats concurrently.
        self._stats_lock = threading.Lock()
        self.stats = ServeStats()
        reg = self.registry
        self._m_requests = reg.counter(
            "serve_requests_total", "requests accepted into flush windows")
        self._m_solves = reg.counter(
            "serve_solves_total",
            "solver calls by batch kind / method / kernel path / placement")
        self._m_served = reg.counter(
            "serve_requests_served_total",
            "requests answered, by batch kind and warm/cold start")
        self._m_errors = reg.counter(
            "serve_errors_total",
            "requests failed, by exception type / method / bucket")
        self._m_latency = reg.histogram(
            "serve_solve_latency_seconds",
            "wall time of one batched solver call to the end of its "
            "stream's work (kernel path, X-stream precision and execution "
            "lane labelled)",
            buckets=obs.LATENCY_BUCKETS)
        self._m_fallback = reg.counter(
            "solver_fallback_total",
            "solves re-routed off their requested kernel path")
        self._m_retries = reg.counter(
            "solver_retries_total",
            "retry-ladder steps taken, by reason and from/to rung")
        self._m_sweeps = reg.histogram(
            "serve_sweeps",
            "solver sweeps per request (warm label isolates warm-start "
            "savings)", buckets=obs.COUNT_BUCKETS)
        self._m_group = reg.histogram(
            "serve_group_size", "requests per solver call, by batch kind",
            buckets=obs.COUNT_BUCKETS)
        # Bound-series children for the hot label combos (per-request and
        # per-solve record sites run on the flush path).
        self._c_served: dict = {}
        self._c_sweeps: dict = {}
        self._c_solve: dict = {}
        self._pending: List[SolveRequest] = []
        self._seq = itertools.count()
        self._warned_unshardable_fused = False

    def placement_for(self, bucket, method: str) -> Optional[Placement]:
        """Bucket-level placement (None when the engine has no mesh, so
        mesh-less grouping keys stay the single-device ones)."""
        if self.mesh is None:
            return None
        return placement_for_bucket(bucket, method, self.policy, self.mesh)

    def spec_for(self, req: SolveRequest, *, record: bool = False
                 ) -> SolverSpec:
        """The effective ``SolverSpec`` a request solves under.

        An explicit ``SolveRequest.spec`` is authoritative; legacy
        per-field requests get the engine-level ``omega``/``ridge``/
        ``precision`` applied.  On a store-backed engine a BAK-family
        request whose padded bucket alone exceeds the device budget is
        rewritten to ``"bakp_stream"`` (the store builds it non-resident),
        counting ``solver_fallback_total{reason="over_hbm"}`` under
        ``record=True``, before ``prefer_fused`` could move it onto a
        resident-only path.  ``prefer_fused`` upgrades ``"bakp"`` to
        ``"bakp_fused"`` where the bucket fits the card's on-chip budget
        at nrhs 1 (``fused_fits``; the method re-checks with the real
        coalesced k and falls back itself); on a mesh engine it does
        nothing (the kernel is single-device and the upgrade would defeat
        sharded placement) and counts
        ``solver_fallback_total{reason="unshardable_fused"}`` under
        ``record=True``, logging a warning once per engine.  A precision
        the effective method cannot run downgrades to "fp32", counting
        ``solver_fallback_total{reason="precision"}`` under
        ``record=True`` (the once-per-request grouping pass).
        """
        spec = req.solver_spec()
        if req.spec is None:
            spec = spec.replace(omega=self.config.omega,
                                ridge=self.config.ridge)
            if (self.config.precision is not None
                    and spec.precision != self.config.precision):
                spec = spec.replace(precision=self.config.precision)
        if (self.store is not None and self.store.device_bytes is not None
                and spec.method in _STREAM_REROUTE):
            bucket = request_bucket(req, min_obs=self.config.min_obs,
                                    min_vars=self.config.min_vars)
            if bucket[0] * bucket[1] * 4 > self.store.device_bytes:
                if record:
                    self._m_fallback.inc(1, method=spec.method,
                                         reason="over_hbm")
                spec = spec.replace(method="bakp_stream")
        # The bf16 X stream halves the resident itemsize, so the fit check
        # (and therefore the upgrade) sees twice the headroom.
        itemsize = 2 if spec.precision != "fp32" else 4
        if (self.config.prefer_fused and spec.method == "bakp"
                and spec.max_iter >= 1):
            if self.mesh is not None:
                if record:
                    self._m_fallback.inc(1, method="bakp_fused",
                                         reason="unshardable_fused")
                    if not self._warned_unshardable_fused:
                        self._warned_unshardable_fused = True
                        _log.warning(
                            "prefer_fused is a no-op on this mesh engine: "
                            "the whole-solve kernel is single-device, so "
                            "'bakp' requests keep their sharded-eligible "
                            "method (counted as solver_fallback_total"
                            "{reason=\"unshardable_fused\"})")
            else:
                bucket = request_bucket(req, min_obs=self.config.min_obs,
                                        min_vars=self.config.min_vars)
                vars_pb = -(-bucket[1] // spec.thr) * spec.thr
                if fused_fits(vars_pb, bucket[0], 1, itemsize,
                              max_iter=spec.max_iter):
                    spec = spec.replace(method="bakp_fused")
        if (spec.precision != "fp32"
                and spec.precision not in
                solver_method(spec.method).precisions):
            if record:
                self._m_fallback.inc(1, method=spec.method,
                                     reason="precision")
            spec = spec.replace(precision="fp32")
        return spec

    # ------------------------------------------------------------- intake
    def _intake(self, request: SolveRequest) -> str:
        """Normalise one request (``prepare_request``) and assign its id."""
        prepare_request(request)
        if request.request_id is None:
            request.request_id = f"req-{next(self._seq)}"
        return request.request_id

    def submit(self, request: SolveRequest) -> str:
        """Queue a request for the next flush(); returns its id.
        submit()/flush() are a single-caller API; concurrent callers use
        serve()."""
        rid = self._intake(request)
        self._pending.append(request)
        return rid

    def serve(self, requests: Sequence[SolveRequest]) -> List[ServedSolve]:
        """Solve ``requests`` in one flush window; results in order.
        Thread-safe: the batch stays local to this call."""
        batch = list(requests)
        for r in batch:
            self._intake(r)
        return self._serve(batch)

    # -------------------------------------------------------------- flush
    def flush(self) -> List[ServedSolve]:
        """Execute all pending requests; results in submission order."""
        requests, self._pending = self._pending, []
        return self._serve(requests)

    def _serve(self, requests: List[SolveRequest]) -> List[ServedSolve]:
        if not requests:
            return []
        with self._stats_lock:
            self.stats.requests += len(requests)
        self._m_requests.inc(len(requests))
        with obs.span("engine.flush", requests=len(requests)):
            return self._flush(requests)

    def _flush(self, requests: List[SolveRequest]) -> List[ServedSolve]:
        """Batch-builder: fingerprints, grouping and design-cache lookups
        run here on the calling thread; the solves are work units on the
        engine's lanes (``_run_units``)."""
        results: List[Optional[ServedSolve]] = [None] * len(requests)
        units: List[Tuple[LaneKey, int, object, List[int], tuple]] = []
        cfg = self.config

        def unit(lane, fail_idxs, bucket, size, fn):
            def run(fn=fn, fail_idxs=fail_idxs, bucket=bucket):
                try:
                    fn()
                except Exception as exc:
                    self._fail(requests, fail_idxs, bucket, exc, results)
            units.append((lane, size, run, fail_idxs, bucket))

        with obs.span("engine.fingerprint"):
            for r in requests:
                if r.design_key is None:
                    r.design_key = design_fingerprint(r.x)
        with obs.span("engine.group"):
            groups = group_requests(
                requests, min_obs=cfg.min_obs, min_vars=cfg.min_vars,
                placement_fn=self.placement_for,
                spec_fn=lambda r: self.spec_for(r, record=True))
        for outer, designs in groups.items():
            bucket = outer[0]
            method = outer[1]
            mentry = solver_method(method)
            placement = self.placement_for(bucket, method)
            singles = []  # (idx, entry, cache_hit, design_key)
            for key, idxs in designs.items():
                try:
                    entry, hit = self._design_entry(
                        key, requests[idxs[0]], bucket,
                        self.spec_for(requests[idxs[0]]), placement)
                except Exception as exc:  # bad design: fail just this group
                    self._fail(requests, idxs, bucket, exc, results)
                    continue
                if cfg.coalesce and len(idxs) > 1 and mentry.multi_rhs:
                    # The k-sharded group upgrade is decided here (k is
                    # known after coalescing), so the unit routes to its
                    # real lane, not the bucket's.
                    gplacement = placement
                    if self.mesh is not None and mentry.shardable:
                        gplacement = placement_for_group(
                            placement or Placement(), next_pow2(len(idxs)),
                            self.policy, self.mesh)
                    unit(self.lanes.lane_for(method, gplacement, self.mesh),
                         idxs, bucket, len(idxs),
                         functools.partial(self._solve_multi_rhs, requests,
                                           idxs, entry, hit, bucket,
                                           results, gplacement, key))
                else:
                    singles.extend((i, entry, hit, key) for i in idxs)
            # The batch across designs is single-device; sharded buckets
            # solve their leftovers one by one.
            use_vmap = (cfg.vmap_batch and len(singles) > 1
                        and mentry.batchable
                        and (placement is None or not placement.sharded))
            if use_vmap:
                for lo in range(0, len(singles), cfg.max_vmap_batch):
                    chunk = singles[lo:lo + cfg.max_vmap_batch]
                    if len(chunk) > 1:
                        unit(self.lanes.lane_for(method),
                             [i for i, _, _, _ in chunk], bucket,
                             len(chunk),
                             functools.partial(self._solve_vmapped,
                                               requests, chunk, bucket,
                                               results))
                    else:
                        idx, entry, hit, key = chunk[0]
                        unit(self.lanes.lane_for(method, placement,
                                                 self.mesh),
                             [idx], bucket, 1,
                             functools.partial(self._solve_one, requests,
                                               idx, entry, hit, bucket,
                                               results, placement, key))
            else:
                for idx, entry, hit, key in singles:
                    unit(self.lanes.lane_for(method, placement, self.mesh),
                         [idx], bucket, 1,
                         functools.partial(self._solve_one, requests, idx,
                                           entry, hit, bucket, results,
                                           placement, key))
        self._run_units(units, requests, results)
        assert all(r is not None for r in results)
        return results

    def _run_units(self, units, requests, results) -> None:
        """Execute flush work units on their lanes and wait for all.

        Nested flushes (``serve``/``flush`` called from a lane work) run
        inline on the current lane thread.  A work coming back with
        ``error`` set never completed (lane worker-thread death or a
        shutdown race): its unanswered requests get error results.
        """
        if not units:
            return
        if current_lane() is not None:
            for _, _, fn, _, _ in units:
                fn()
            return
        works = [self.lanes.submit(lane, LaneWork(fn, size=size,
                                                  tag=lane.label))
                 for lane, size, fn, _, _ in units]
        for w in works:
            w.wait()
        for w, (_, _, _, fail_idxs, bucket) in zip(works, units):
            if w.error is not None:
                missing = [i for i in fail_idxs if results[i] is None]
                if missing:
                    self._fail(requests, missing, bucket, w.error, results)

    def shutdown(self, drain: bool = True) -> None:
        """Stop the engine's lane executor threads (idempotent)."""
        self.lanes.shutdown(drain=drain)

    # ---------------------------------------------------------- internals
    def _design_entry(self, key, req, bucket, spec=None, placement=None):
        """The design's cached handle, built (pad, copy to the device) on
        a miss and warmed for ``spec`` — and a sharded ``placement``'s copy
        on the engine's mesh — on this thread."""
        with obs.span("engine.design", key=key) as sp:
            entry, hit = self.cache.get_or_build(
                key, lambda: pad_x(req.x, bucket), spec=spec,
                placement=placement, mesh=self.mesh)
            if sp is not None:
                sp.tags["hit"] = hit
            return entry, hit

    def _fail(self, requests, idxs, bucket, exc, results):
        """Error results for a poisoned batch (engine keeps serving).  A
        ``KernelError`` also rides on each result as
        ``extra["kernel_error"]``, so the async dispatcher fails those
        tickets with it."""
        exc_type = type(exc).__name__
        msg = f"{exc_type}: {exc}"
        obs.consume_dispatch()  # drop any path a partial dispatch recorded
        for idx in idxs:
            req = requests[idx]
            n_obs, nvars = np.shape(req.x)
            tel = None
            if obs.enabled():
                tel = obs.SolveTelemetry(
                    request_id=req.request_id, tenant_id=req.tenant_id,
                    bucket=bucket, method=req.method, kernel_path="none",
                    batch_kind="error", group_size=len(idxs),
                    batch_size=len(idxs), error_type=exc_type)
            results[idx] = ServedSolve(
                request_id=req.request_id,
                coef=np.zeros((nvars,), np.float32),
                residual=np.asarray(req.y, np.float32).copy(),
                sse=float(np.dot(req.y, req.y)),
                n_sweeps=0,
                converged=False,
                bucket=bucket,
                batch_kind="error",
                group_size=len(idxs),
                error=msg,
                extra=({"kernel_error": exc}
                       if isinstance(exc, KernelError) else {}),
                telemetry=tel,
            )
            with self._stats_lock:
                self.stats.failures += 1
            self._m_errors.inc(1, exception_type=exc_type,
                               method=req.method,
                               bucket=f"{bucket[0]}x{bucket[1]}")

    def _resolve_a0(self, req: SolveRequest, entry: PreparedDesign):
        """(warm-start coefficients as host numpy, their source) for a
        request: explicit ``a0`` wins (``"request"``), then the design
        handle's per-tenant store (``PreparedDesign.warm_coef_source``);
        (None, None) means cold."""
        if req.a0 is not None:
            return np.asarray(req.a0, np.float32), "request"
        if self.config.warm_cache:
            coef, source = entry.warm_coef_source(req.tenant_id)
            if coef is not None:
                return _host(coef), source
        return None, None

    @staticmethod
    def _pad_a0(a0: np.ndarray, vars_p: int) -> np.ndarray:
        """Zero-pad (vars,) warm-start coefficients to the bucket width
        (padded columns are zero, so their coefficients stay 0)."""
        if a0.shape[0] == vars_p:
            return a0
        out = np.zeros((vars_p,), np.float32)
        out[: a0.shape[0]] = a0
        return out

    @staticmethod
    def _padded_atol(atol: float, n_real: int, n_padded: int) -> float:
        """Correct an absolute RMSE tolerance for zero padding: the solvers
        compare total SSE against ``n_padded * atol²``, but only ``n_real``
        elements carry signal, so atol scales by sqrt(n_real/n_padded).
        ``rtol`` needs no correction."""
        if atol <= 0.0 or n_real == n_padded:
            return atol
        return atol * math.sqrt(n_real / n_padded)

    def _call_solver(self, spec: SolverSpec, entry: PreparedDesign, y,
                     atol: float, a0=None, placement=None):
        """One (possibly multi-RHS) solve on the prepared design, with the
        padding-corrected ``atol`` (``spec.atol`` itself must not be used)
        and, on a 2-D mesh placement, the engine's ``omega_2d``.  ``a0``
        is a host array, copied by the handle inside ``engine.call``.  A
        host ``y`` is copied to the device on the lane's stream
        (``design.y_to_device``) before that span; a tensor ``y`` was
        staged there by the caller and is used as it is."""
        eff = spec.replace(atol=atol)
        if placement is not None and placement.kind == "mesh_2d":
            eff = eff.replace(omega=self.config.omega_2d)
        if isinstance(y, torch.Tensor):
            y_dev = as_f32(y, entry.device)
        else:
            with obs.span("design.y_to_device", bytes=np.size(y) * 4):
                y_dev = as_f32(y, entry.device)
        with obs.span("engine.call", method=eff.method):
            return entry.solve(y_dev, a0, spec=eff, placement=placement,
                               mesh=self.mesh)

    def _to_host(self, *outs) -> List[np.ndarray]:
        """Solve outputs as host arrays, in one ``engine.result_to_host``
        span."""
        with obs.span("engine.result_to_host",
                      bytes=sum(_nbytes(v) for v in outs)):
            return [_host(v) for v in outs]

    def _sync(self, entry: PreparedDesign, placement) -> None:
        """Wait for a solve's device work: the entry's device, or every
        distinct device of the mesh for a sharded placement."""
        if (placement is not None and placement.sharded
                and self.mesh is not None):
            for d in self.mesh.mesh.distinct_devices():
                obs.sync_device(d)
        else:
            obs.sync_device(entry.device)

    # ------------------------------------------------------- retry ladder
    @staticmethod
    def _rung_label(spec: SolverSpec, warm: bool = False) -> str:
        """Metrics label for one ladder rung: method, ':<precision>' when
        reduced, '+warm' when warm-started."""
        lbl = spec.method
        if spec.precision != "fp32":
            lbl += f":{spec.precision}"
        if warm:
            lbl += "+warm"
        return lbl

    @staticmethod
    def _diverged(res, sse0: Optional[float] = None) -> bool:
        """Whether a completed solve net-diverged: not converged AND the
        recorded SSE rose materially above its own start — or above the
        cold baseline ``sse0`` (|y|², the SSE of the zero solution)."""
        try:
            conv = _host(res.converged)
            if conv.ndim != 0 or bool(conv):
                return False
            h = _host(res.history).astype(np.float32).ravel()
            h = h[np.isfinite(h)]
            if h.size == 0:
                return False
            if h.size >= 2 and float(h[-1]) > 1.01 * float(h[0]):
                return True
            if sse0 is not None and float(h[-1]) > 1.01 * sse0:
                return True
        except Exception:
            return False
        return False

    @staticmethod
    def _is_corruption(exc: BaseException) -> bool:
        """Did this solve die because the design's store tier is damaged?"""
        if isinstance(exc, TileCorruptionError):
            return True
        return isinstance(exc, KeyError) and "store tier" in str(exc)

    def _rung_ok(self, spec: SolverSpec, entry, need_multi: bool) -> bool:
        """Can this entry/batch actually run on the given rung?"""
        m = solver_method(spec.method)
        if entry.x_pad is None and not m.streams:
            return False  # non-resident design: streaming rungs only
        if need_multi and not m.multi_rhs:
            return False  # coalesced (obs, k) batch stays coalesced
        return True

    def _attempt_solve(self, spec: SolverSpec, entry, y, atol: float, a0,
                       placement=None, *,
                       deadline_at: Optional[float] = None,
                       rebuild=None, sse0: Optional[float] = None,
                       need_multi: bool = False):
        """One solve with the retry/degradation ladder wrapped around it
        (the JAX engine's order: store corruption → rebuild and retry the
        same rung; a warm start present → cold retry on the same rung;
        reduced precision → fp32; then ``MethodEntry.fallback`` hops,
        skipping rungs the entry/batch cannot run; a method change drops
        the mesh placement, since the fallback may not be shardable).
        Bounded by ``max_retries``, ``deadline_at`` and the ladder floor;
        each step sleeps a jittered backoff and counts
        ``solver_retries_total{reason,from_path,to_path}``.  A solve is
        complete on the device before it is judged (``obs.sync_device``
        on the lane's streams).  ``KernelError`` (a CUDA kernel that
        failed to build or launch) is raised at once, never retried.

        Returns ``(res, spec, entry, placement, retries, diverged,
        a0_used)``.
        """
        cfg = self.config
        cur, cur_entry, cur_a0, cur_place = spec, entry, a0, placement
        retries = 0
        while True:
            exc = None
            res = None
            try:
                faults.maybe_raise("solver.raise", cur.method)
                res = self._call_solver(cur, cur_entry, y, atol, a0=cur_a0,
                                        placement=cur_place)
                with obs.span("engine.sync"):
                    self._sync(cur_entry, cur_place)
            except KernelError:
                raise  # a broken kernel is a fault, not a rung to step past
            except Exception as e:
                exc = e
            forced = (exc is None
                      and faults.hit("solver.diverge", cur.method)
                      is not None)
            diverged = forced or (exc is None and self._diverged(res, sse0))
            if exc is None and not diverged:
                return (res, cur, cur_entry, cur_place, retries, False,
                        cur_a0)
            out_of_time = (deadline_at is not None
                           and obs.now() >= deadline_at)
            if (not cfg.retry_ladder or retries >= cfg.max_retries
                    or out_of_time):
                if exc is not None:
                    raise exc
                return (res, cur, cur_entry, cur_place, retries, True,
                        cur_a0)
            frm = self._rung_label(cur, cur_a0 is not None)
            if (exc is not None and self._is_corruption(exc)
                    and rebuild is not None):
                reason, nxt = "corruption", cur
                try:
                    cur_entry = rebuild()
                except Exception:
                    raise exc
            elif cur_a0 is not None:
                reason, nxt, cur_a0 = "warm_poison", cur, None
            else:
                reason = "raise" if exc is not None else (
                    "forced_diverge" if forced else "diverge")
                nxt = ladder.next_rung(cur)
                while nxt is not None and not self._rung_ok(
                        nxt, cur_entry, need_multi):
                    nxt = ladder.next_rung(nxt)
                if nxt is None:  # ladder floor reached
                    if exc is not None:
                        raise exc
                    return (res, cur, cur_entry, cur_place, retries, True,
                            cur_a0)
                if nxt.method != cur.method:
                    cur_place = None  # the fallback may not be shardable
            retries += 1
            self._m_retries.inc(1, reason=reason, from_path=frm,
                                to_path=self._rung_label(
                                    nxt, cur_a0 is not None))
            with self._stats_lock:
                self.stats.retries += 1
            delay = ladder.backoff_s(retries - 1, cfg.retry_backoff_s)
            if delay > 0.0:
                if deadline_at is not None:
                    delay = min(delay, max(0.0, deadline_at - obs.now()))
                time.sleep(delay)
            cur = nxt

    def _record_solve(self, spec: SolverSpec, placement, kind: str,
                      group_size: int, dt: float, path=None) -> str:
        """Record one solver call's metrics; returns the kernel path that
        actually executed (off the dispatch relay, or ``path``)."""
        if path is None:
            path = obs.consume_dispatch(
                "sharded" if placement is not None and placement.sharded
                else "xla")
        if obs.enabled():
            placement_kind = (placement.kind if placement is not None
                              else "single")
            lk = current_lane()
            lane = lk.label if lk is not None else "inline"
            ck = (kind, spec.method, path, placement_kind, spec.precision,
                  lane)
            bound = self._c_solve.get(ck)
            if bound is None:
                bound = self._c_solve[ck] = (
                    self._m_solves.labels(kind=kind, method=spec.method,
                                          path=path,
                                          placement=placement_kind),
                    self._m_latency.labels(kind=kind, method=spec.method,
                                           path=path,
                                           precision=spec.precision,
                                           lane=lane),
                    self._m_group.labels(kind=kind))
            bound[0].inc(1)
            bound[1].observe(dt)
            bound[2].observe(group_size)
        return path

    def _retain(self, entry: PreparedDesign, reqs, coefs) -> None:
        """Retain tenants' solved coefficients on their design from the
        device result: column ``c`` of ``coefs`` (vars_p, ·), stripped to
        the real columns, for ``reqs[c]`` (the JAX engine stores each
        request's host copy in ``_strip``; here the group's columns stay
        on the device, one copy and one settle a group)."""
        if not self.config.warm_cache:
            return
        tenants = [r.tenant_id for r in reqs]
        if any(t is not None for t in tenants):
            nvars = np.shape(reqs[0].x)[1]
            entry.store_coefs(tenants, coefs[:nvars, :len(reqs)])

    def _strip(self, req: SolveRequest, coef, residual, *, bucket, kind,
               group_size, latency, hit, n_sweeps, converged,
               warm=False, a0_source=None, placement=None, method="",
               path="xla", retries=0) -> ServedSolve:
        """One request's result with the padding stripped (``coef`` /
        ``residual`` are host arrays).  A warm request's ``extra`` names
        where its start came from (``a0_source``: ``"request"``,
        ``"handle"`` or ``"restored"``)."""
        n_obs, nvars = np.shape(req.x)
        coef = np.asarray(coef)[:nvars]
        residual = np.asarray(residual)[:n_obs]
        if warm:
            with self._stats_lock:
                self.stats.warm_starts += 1
        sse = float(np.dot(residual, residual))
        n_sweeps = int(n_sweeps)
        converged = bool(converged)
        placement_kind = placement.kind if placement is not None else "single"
        lk = current_lane()
        lane = lk.label if lk is not None else "inline"
        tel = None
        if obs.enabled():
            warm_lbl = "1" if warm else "0"
            sk = (kind, warm_lbl)
            served_c = self._c_served.get(sk)
            if served_c is None:
                served_c = self._c_served[sk] = self._m_served.labels(
                    kind=kind, warm=warm_lbl)
            sweeps_c = self._c_sweeps.get(warm_lbl)
            if sweeps_c is None:
                sweeps_c = self._c_sweeps[warm_lbl] = self._m_sweeps.labels(
                    warm=warm_lbl)
            served_c.inc(1)
            sweeps_c.observe(n_sweeps)
            tel = obs.SolveTelemetry(
                request_id=req.request_id, tenant_id=req.tenant_id,
                bucket=bucket, method=method or req.method,
                kernel_path=path, placement=placement_kind, lane=lane,
                batch_kind=kind,
                group_size=group_size, batch_size=group_size,
                warm_start=warm, cache_hit=hit, n_sweeps=n_sweeps, sse=sse,
                converged=converged, retries=retries, solve_s=latency)
        return ServedSolve(
            request_id=req.request_id,
            coef=coef,
            residual=residual,
            sse=sse,
            n_sweeps=n_sweeps,
            converged=converged,
            bucket=bucket,
            batch_kind=kind,
            group_size=group_size,
            latency_s=latency,
            cache_hit=hit,
            warm_start=warm,
            placement=placement_kind,
            retries=retries,
            telemetry=tel,
            extra={"a0_source": a0_source} if warm else {},
        )

    def _solve_multi_rhs(self, requests, idxs, entry, hit, bucket, results,
                         placement=None, key=None):
        """Coalesce same-design requests into one (obs, k_pad) solve; warm
        and cold members coalesce (cold columns of the stacked ``a0`` are
        zero, identical to those members' cold path).  ``placement`` is
        final here (``_flush`` decided the k-sharded group upgrade), except
        that the retry ladder drops it when a rung changes the method."""
        obs_p, vars_p = bucket
        k = len(idxs)
        k_pad = next_pow2(k)
        req0 = requests[idxs[0]]
        spec = self.spec_for(req0)
        mentry = solver_method(spec.method)
        # The right-hand sides go to the card RHS-major and are transposed
        # there: a strided column write a request into a row-major
        # (obs_p, k_pad) host array touches every cache line of it.
        pin = entry.device.type == "cuda"
        with obs.span("engine.pad", kind="multi_rhs", k=k,
                      staging="pinned" if pin else "pageable"):
            ys_h, sse0 = stage_rhs(
                [np.asarray(requests[idx].y, np.float32) for idx in idxs],
                obs_p, k_pad, pin=pin)
            resolved = ([self._resolve_a0(requests[idx], entry)
                         for idx in idxs] if mentry.iterative
                        else [(None, None)] * k)
            a0s = [a for a, _ in resolved]
            a0_mat = None
            if any(a is not None for a in a0s):
                a0_mat = np.zeros((vars_p, k_pad), np.float32)
                for c, a in enumerate(a0s):
                    if a is not None:
                        a0_mat[:, c] = self._pad_a0(a, vars_p)
        obs_real = np.shape(req0.x)[0]
        atol = self._padded_atol(spec.atol, obs_real * k, obs_p * k_pad)
        deadlines = [requests[i].deadline_at for i in idxs
                     if requests[i].deadline_at is not None]
        rebuild = None
        if key is not None:
            rebuild = lambda: self._design_entry(  # noqa: E731
                key, req0, bucket, spec, placement)[0]
        lane = current_lane()
        with obs.span("engine.solve", kind="multi_rhs", method=spec.method,
                      lane=lane.label if lane is not None else "inline"):
            t0 = obs.now()
            with obs.span("design.y_to_device", bytes=ys_h.numel() * 4):
                ys = rhs_to_device(ys_h, entry.device)
            res, fspec, fentry, fplace, retries, diverged, a0_used = \
                self._attempt_solve(
                    spec, entry, ys, atol, a0_mat, placement,
                    deadline_at=min(deadlines) if deadlines else None,
                    rebuild=rebuild, sse0=sse0, need_multi=True)
            dt = obs.now() - t0
        path = self._record_solve(fspec, fplace, "multi_rhs", k, dt)
        with obs.span("engine.strip", kind="multi_rhs", k=k):
            coef, resid = self._to_host(res.coef, res.residual)
            n_sweeps, converged = int(res.n_sweeps), bool(res.converged)
            if not diverged:
                self._retain(fentry, [requests[i] for i in idxs], res.coef)
            for c, idx in enumerate(idxs):
                results[idx] = self._strip(
                    requests[idx], coef[:, c], resid[:, c], bucket=bucket,
                    kind="multi_rhs", group_size=k, latency=dt, hit=hit,
                    n_sweeps=n_sweeps, converged=converged,
                    warm=a0_used is not None and a0s[c] is not None,
                    a0_source=resolved[c][1], placement=fplace,
                    method=fspec.method, path=path, retries=retries)
        with self._stats_lock:
            self.stats.solver_calls += 1
            self.stats.multi_rhs_groups += 1
            self.stats.multi_rhs_requests += k
            if fplace is not None and fplace.sharded:
                self.stats.sharded_solves += 1

    def _solve_vmapped(self, requests, singles, bucket, results):
        """Stack same-bucket single-design requests into one batch solve.

        A raised batch is not retried as a stack: it degrades to
        per-request ``_solve_one`` calls, each with its own full ladder,
        counted as ``solver_retries_total{from_path="vmap:...",
        to_path="single"}`` once per member.
        """
        try:
            self._solve_vmapped_inner(requests, singles, bucket, results)
            return
        except Exception as exc:
            if not self.config.retry_ladder:
                raise
            spec = self.spec_for(requests[singles[0][0]])
            reason = ("raise" if isinstance(exc, faults.FaultInjected)
                      else type(exc).__name__)
            self._m_retries.inc(len(singles), reason=reason,
                                from_path=f"vmap:{spec.method}",
                                to_path="single")
            with self._stats_lock:
                self.stats.retries += len(singles)
        for idx, entry, hit, key in singles:
            if results[idx] is not None:
                continue
            try:
                self._solve_one(requests, idx, entry, hit, bucket, results,
                                key)
            except Exception as exc:
                self._fail(requests, [idx], bucket, exc, results)

    def _solve_vmapped_inner(self, requests, singles, bucket, results):
        """The batch solve: the method's ``vmap_one`` over the stacked
        designs, right-hand sides, norms, per-system padding-corrected
        atol (real obs varies within a bucket), Gram factors and warm
        starts.  Unlike the JAX engine, the batch is not padded to a power
        of two: eager torch compiles nothing per batch size."""
        obs_p, vars_p = bucket
        req0 = requests[singles[0][0]]
        spec = self.spec_for(req0)
        mentry = solver_method(spec.method)
        b = len(singles)
        dev = self.device
        with obs.span("engine.pad", kind="vmap", b=b):
            ys_h = np.stack([pad_y(np.asarray(requests[i].y, np.float32),
                                   obs_p) for i, _, _, _ in singles])
            resolved = [self._resolve_a0(requests[i], e)
                        for i, e, _, _ in singles]
            a0s = [a for a, _ in resolved]
            warm = any(a is not None for a in a0s)
            atols = [self._padded_atol(
                spec.atol, np.shape(requests[i].x)[0], obs_p)
                for i, _, _, _ in singles]
            a0_mat = None
            if warm:
                a0_mat = np.zeros((b, vars_p), np.float32)
                for row, a in enumerate(a0s):
                    if a is not None:
                        a0_mat[row] = self._pad_a0(a, vars_p)
        solver = mentry.vmap_one(spec.canonical().replace(atol=0.0))
        lane = current_lane()
        with obs.span("engine.solve", kind="vmap", method=spec.method,
                      lane=lane.label if lane is not None else "inline"):
            t0 = obs.now()
            faults.maybe_raise("solver.raise", f"vmap:{spec.method}")
            h2d = ys_h.nbytes + (0 if a0_mat is None else a0_mat.nbytes)
            with obs.span("design.y_to_device", bytes=h2d):
                ys = torch.from_numpy(ys_h).to(dev)
                a0_dev = (None if a0_mat is None
                          else torch.from_numpy(a0_mat).to(dev))
            with obs.span("engine.call", method=spec.method):
                xs = torch.stack([e.x_pad for _, e, _, _ in singles])
                if mentry.blocked:
                    cns = torch.stack(
                        [e.cn_for_thr(spec.thr) for _, e, _, _ in singles])
                else:
                    cns = torch.stack([e.cn for _, e, _, _ in singles])
                chols = None
                if mentry.needs_chol:
                    chols = torch.stack(
                        [e.chol_for(spec.thr, spec.ridge)
                         for _, e, _, _ in singles])
                res = solver(xs, ys, cns, atols, chols=chols, a0s=a0_dev)
            with obs.span("engine.sync"):
                obs.sync_device(dev)
            dt = obs.now() - t0
        forced = faults.hit("solver.diverge", f"vmap:{spec.method}")
        # The batch solve runs the plain solvers' batch form, not the
        # dispatch shims: its path is "vmap" by construction.
        obs.consume_dispatch()
        path = self._record_solve(spec, None, "vmap", b, dt, path="vmap")
        with obs.span("engine.strip", kind="vmap", b=b):
            coef, resid = self._to_host(res.coef, res.residual)
            conv_b = _host(res.converged)
            hist_b = _host(res.history).astype(np.float32)
            sweeps_b = _host(res.n_sweeps)

            def row_retain(row: int) -> bool:
                if forced is not None:
                    return False
                if bool(conv_b[row]):
                    return True
                h = hist_b[row][np.isfinite(hist_b[row])]
                return not (h.size >= 2 and float(h[-1]) > 1.01 * float(h[0]))

            for row, (idx, entry, hit, _) in enumerate(singles):
                if row_retain(row):
                    self._retain(entry, [requests[idx]],
                                 res.coef[row, :, None])
                results[idx] = self._strip(
                    requests[idx], coef[row], resid[row], bucket=bucket,
                    kind="vmap", group_size=b, latency=dt, hit=hit,
                    n_sweeps=sweeps_b[row], converged=conv_b[row],
                    warm=a0s[row] is not None,
                    a0_source=resolved[row][1], method=spec.method,
                    path=path)
        with self._stats_lock:
            self.stats.solver_calls += 1
            self.stats.vmap_batches += 1
            self.stats.vmap_requests += b

    def _solve_one(self, requests, idx, entry, hit, bucket, results,
                   placement=None, key=None):
        req = requests[idx]
        spec = self.spec_for(req)
        with obs.span("engine.pad", kind="single", k=1):
            y_real = np.asarray(req.y, np.float32)
            y_pad = pad_y(y_real, bucket[0])
            a0, a0_source = None, None
            if solver_method(spec.method).iterative:
                a0, a0_source = self._resolve_a0(req, entry)
            a0_pad = None
            if a0 is not None:
                a0_pad = self._pad_a0(a0, bucket[1])
        atol = self._padded_atol(spec.atol, y_real.shape[0], bucket[0])
        rebuild = None
        if key is not None:
            rebuild = lambda: self._design_entry(  # noqa: E731
                key, req, bucket, spec, placement)[0]
        lane = current_lane()
        with obs.span("engine.solve", kind="single", method=spec.method,
                      lane=lane.label if lane is not None else "inline"):
            t0 = obs.now()
            res, fspec, fentry, fplace, retries, diverged, a0_used = \
                self._attempt_solve(spec, entry, y_pad, atol, a0_pad,
                                    placement,
                                    deadline_at=req.deadline_at,
                                    rebuild=rebuild,
                                    sse0=float(np.dot(y_real, y_real)))
            dt = obs.now() - t0
        path = self._record_solve(fspec, fplace, "single", 1, dt)
        with obs.span("engine.strip", kind="single", k=1):
            if not diverged:
                self._retain(fentry, [req], res.coef[:, None])
            coef, resid = self._to_host(res.coef, res.residual)
            results[idx] = self._strip(
                req, coef, resid, bucket=bucket,
                kind="single", group_size=1, latency=dt, hit=hit,
                n_sweeps=int(res.n_sweeps), converged=bool(res.converged),
                warm=a0_used is not None, a0_source=a0_source,
                placement=fplace, method=fspec.method, path=path,
                retries=retries)
        with self._stats_lock:
            self.stats.solver_calls += 1
            self.stats.single_solves += 1
            if fplace is not None and fplace.sharded:
                self.stats.sharded_solves += 1
