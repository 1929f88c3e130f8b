"""Request/response records for the solver-serving engine.

Counterpart of ``repro.serve.types``.  A ``SolveRequest`` is one tenant's
system ``x @ a ≈ y``; the engine groups requests into padded shape
buckets, coalesces requests that share a design matrix into one multi-RHS
solve, and returns one ``ServedSolve`` per request with all padding
stripped and per-request accuracy/latency metadata attached.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch.core.spec import SolverSpec
from repro_torch.obs import SolveTelemetry


@dataclass
class SolveRequest:
    """One solve request.

    Attributes:
      x: (obs, vars) design matrix (numpy array or torch tensor, on any
        device; a tensor stays where it is, the cache copies it to the
        engine's device on a miss).
      y: (obs,) right-hand side (made host numpy at intake).
      spec: optional ``repro_torch.core.SolverSpec`` carrying the full solver
        configuration — the preferred form.  When set it wins over the
        legacy per-field knobs below (which are synced from it during
        validation so older readers keep seeing consistent values).
      method: solver method — any name in
        ``repro_torch.core.method_names()`` (same registry as
        ``repro_torch.core.solve``).  Requests are only
        coalesced/batched with requests whose canonical spec matches.
      max_iter / atol / rtol / thr: legacy solver knobs (see
        ``repro_torch.core.SolverSpec``); ignored when ``spec`` is given.
      a0: optional (vars,) initial coefficients (warm start).  The iterative
        methods start from ``a0`` instead of zeros, so a request whose ``y``
        drifted only slightly since its last solve converges in a fraction of
        the cold-start sweeps.  Warm and cold requests still coalesce into
        one multi-RHS solve (cold members ride a zero column of the stacked
        ``a0``).  Ignored by the direct methods ("lstsq"/"normal").
      tenant_id: optional stable caller identity.  When set (and the engine's
        ``warm_cache`` is on) the design cache retains this tenant's last
        coefficients keyed by (design, tenant) and uses them as ``a0`` on the
        tenant's next solve against the same design; an explicit ``a0`` takes
        precedence over the cached one.
      deadline_s: optional *relative* deadline in seconds (from submit time).
        The synchronous engine ignores it (the async dispatcher that reads
        it is a later slice of the port).
      design_key: optional caller-provided identity for ``x``.  When two
        requests carry the same key the engine trusts it and skips hashing
        the matrix bytes; leave None to let the engine fingerprint ``x``.
      request_id: optional caller tag, echoed on the result.
      deadline_at: optional *absolute* deadline on the ``obs.now()`` clock;
        synchronous callers may set it directly.  The engine's retry ladder
        (``repro_torch.resilience``) stops retrying once it passes — a
        request never burns its deadline on backoff sleeps.
    """

    x: Any
    y: Any
    method: str = "bakp_gram"
    max_iter: int = 50
    atol: float = 0.0
    rtol: float = 0.0
    thr: int = 128
    spec: Optional[SolverSpec] = None
    a0: Optional[Any] = None
    tenant_id: Optional[str] = None
    deadline_s: Optional[float] = None
    design_key: Optional[str] = None
    request_id: Optional[str] = None
    deadline_at: Optional[float] = None

    def solver_spec(self) -> SolverSpec:
        """The request's ``SolverSpec``: the explicit ``spec`` when given,
        else one built from the legacy per-field knobs (engine-level
        ``omega``/``ridge`` defaults are applied by the engine — see
        ``SolverServeEngine.spec_for``)."""
        if self.spec is not None:
            return self.spec
        return SolverSpec(method=self.method, max_iter=int(self.max_iter),
                          atol=float(self.atol), rtol=float(self.rtol),
                          thr=int(self.thr))


@dataclass
class ServedSolve:
    """Per-request result, padding stripped back to the request's shapes.

    ``batch_kind`` records how the request was executed:
      "multi_rhs" — coalesced with same-design requests into one (obs, k)
                    multi-RHS solve;
      "vmap"      — stacked with same-bucket (different-design) requests
                    into one batch solve (the counterpart of JAX's vmap);
      "single"    — solved alone.
    ``latency_s`` is the wall time of the batch solve the request rode in
    (shared by all members of the batch); ``group_size`` its occupancy.

    For a coalesced ("multi_rhs") request, ``n_sweeps``/``converged`` are
    group-level: the solver's stopping criterion is the group-total SSE
    (with the absolute tolerance corrected for padding), so an individual
    tenant in a group is not guaranteed its own per-column atol.  ``sse``
    is always this request's own, recomputed from the stripped residual.

    ``warm_start`` is True when the solve started from a non-zero ``a0``
    (explicit or recalled from the design cache's per-tenant coefficient
    store).  ``error`` is None on success; on a solver failure the engine
    isolates the poisoned batch, fills ``error`` with the exception text and
    returns zero coefficients (``converged=False``) instead of wedging the
    whole flush — check ``ok`` before trusting ``coef``.

    ``placement`` records which backend the solve ran on: "single" (one
    device), "obs_sharded", "rhs_sharded" or "mesh_2d" (a mesh engine's
    sharded solvers).

    ``retries`` counts the retry-ladder steps the solve took before this
    result (``repro_torch.resilience``): 0 = first attempt; the ``batch_kind``/
    ``placement``/telemetry method describe the rung that finally served.

    ``telemetry`` is the request's ``repro_torch.obs.SolveTelemetry`` record
    — everything above plus the kernel path that actually executed (fused
    / persweep / stream / xla / vmap).  None when obs is disabled
    (``REPRO_OBS_DISABLED=1``).
    """

    request_id: str
    coef: np.ndarray
    residual: np.ndarray
    sse: float
    n_sweeps: int
    converged: bool
    bucket: tuple = (0, 0)
    batch_kind: str = "single"
    group_size: int = 1
    latency_s: float = 0.0
    cache_hit: bool = False
    warm_start: bool = False
    placement: str = "single"
    retries: int = 0
    error: Optional[str] = None
    extra: dict = field(default_factory=dict)
    telemetry: Optional[SolveTelemetry] = None

    @property
    def ok(self) -> bool:
        return self.error is None
