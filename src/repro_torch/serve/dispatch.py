"""Async deadline-aware dispatcher for the solver-serving engine.

Counterpart of ``repro.serve.dispatch`` (pure Python over the port's
engine).  ``SolverServeEngine`` is a synchronous submit/flush window:
callers decide when to flush, and while a flush runs on the device nothing
else happens — request validation, design hashing and padding all
serialize behind it.
``AsyncDispatcher`` layers an async pipeline on top:

  * the **dispatch thread** drains a bounded intake queue, normalises each
    request (``prepare_request``: shape/knob validation, design
    fingerprint), pre-warms the engine's design cache (bucket padding, the
    host-to-device copy, column norms, the kernels' layouts and, on a
    store-backed engine, ``store.promote``), and groups requests into
    per-(bucket, solver-config) pending batches;
  * fired batches are submitted to the engine's **execution lanes**
    (``repro_torch.serve.lanes``): one executor thread and CUDA stream per
    kernel path, each draining its own most-urgent-first queue.

On the card the dispatch thread runs on a CUDA stream of its own: every
tensor its pre-warm builds or promotes is settled on that stream
(``core.prepare._settled``) before a lane's stream reads it.  A
``KernelError`` (a CUDA kernel that failed to build or launch) fails its
tickets with that error: the engine never retries it on a plain rung, and
the dispatcher hands it to ``result()`` as it is.

Host-side bucketing of *incoming* requests still overlaps the solves *in
flight* — the dispatch thread is hashing and padding batch N+1 while the
lanes run batch N — and additionally batches bound for different lanes
overlap each other.

**Flush policy** — a pending batch fires when the first of these holds:

  * it reaches ``max_batch`` requests (full);
  * its most urgent member's deadline is ``deadline_margin_s`` away
    (deadline pressure; batches fire most-urgent-first);
  * no request has joined it for ``idle_timeout_s`` (idle — bounds the
    latency of deadline-less traffic).

The dispatch thread sleeps on a condition variable whose timeout is
computed from the most urgent pending deadline/idle expiry (no fixed-rate
polling): it wakes exactly when the next batch could fire, or immediately
on submit()/drain()/stop().

**Backpressure** — at most ``max_queue`` requests may be incomplete
(queued + pending + solving) at once.  ``backpressure="reject"`` makes
``submit`` raise ``QueueFullError`` immediately; ``"block"`` makes it wait
for capacity, propagating the slowdown to the caller.
``max_lane_inflight`` additionally bounds each execution lane separately
(same reject/block policy), so a backed-up lane exerts backpressure on its
own traffic while other requests keep flowing.

**Deadlines** — a request may carry ``deadline_s`` (relative to submit).
The dispatcher flushes so the solve *starts* with at least the margin left
and records on each ticket whether completion beat the deadline;
``DispatchStats.deadline_misses`` aggregates the misses.

Example::

    with AsyncDispatcher(engine=SolverServeEngine()) as disp:
        tickets = [disp.submit(SolveRequest(x=x, y=y, deadline_s=0.2))
                   for x, y in workload]
        coefs = [t.result().coef for t in tickets]
"""
from __future__ import annotations

import contextlib
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.serve.batching import (bucket_shape, config_key, pad_x,
                                        prepare_request, request_bucket)
from repro_torch.serve.engine import ServeConfig, SolverServeEngine
from repro_torch.serve.lanes import LaneKey, LaneWork
from repro_torch.serve.types import ServedSolve, SolveRequest


class QueueFullError(RuntimeError):
    """Raised by ``submit`` under the "reject" backpressure policy."""


class DispatcherStopped(RuntimeError):
    """Raised when submitting to (or awaiting a ticket of) a stopped
    dispatcher that will never serve it."""


class TicketCancelled(RuntimeError):
    """Raised by ``SolveTicket.result()`` after a successful ``cancel()``
    — the request was dropped before its batch fired and will never be
    solved."""


@dataclass
class DispatchConfig:
    """Dispatcher knobs (engine knobs live on ``ServeConfig``)."""

    max_queue: int = 256           # max incomplete requests (backpressure)
    backpressure: str = "reject"   # "reject" | "block"
    max_batch: int = 32            # fire a batch at this occupancy
    deadline_margin_s: float = 0.05  # fire when an oldest deadline is this close
    idle_timeout_s: float = 0.02   # fire a batch this long after its last join
    poll_interval_s: float = 0.002  # DEPRECATED, ignored: the dispatch
    # thread now sleeps until the most urgent pending deadline/idle expiry
    # (condition-variable wakeup), so there is no poll rate to tune.  Kept
    # so existing DispatchConfig(**kwargs) call sites keep constructing.
    max_lane_inflight: Optional[int] = None  # per-execution-lane cap on
    # incomplete requests (None = only the global max_queue applies).
    # Applied under the same reject/block policy; requests whose lane can't
    # be determined cheaply at submit (non-array x) only count globally.
    default_deadline_s: Optional[float] = None  # applied when request has none
    prewarm_cache: bool = True     # build design entries on the dispatch thread


@dataclass
class DispatchStats:
    """Per-dispatcher counters (convenience mirror of the
    ``serve_dispatch_*`` families this dispatcher records into its engine's
    registry — see ``ServeStats`` for the pattern; the registry is what the
    exporters read)."""

    submitted: int = 0
    rejected: int = 0
    completed: int = 0
    cancelled: int = 0
    deadline_misses: int = 0
    fired_full: int = 0
    fired_deadline: int = 0
    fired_idle: int = 0
    fired_drain: int = 0
    max_inflight: int = 0
    # Batches fired per execution lane, by lane label (dispatch-thread
    # owned; the engine's LanePool.stats() carries the execution side).
    lane_batches: Dict[str, int] = field(default_factory=dict)

    @property
    def deadline_hit_rate(self) -> float:
        """Fraction of completed requests that met their deadline
        (requests submitted without a deadline count as hits)."""
        total = self.completed
        if not total:
            return 1.0
        return 1.0 - self.deadline_misses / total

    def as_dict(self) -> dict:
        return {"submitted": self.submitted, "rejected": self.rejected,
                "completed": self.completed,
                "cancelled": self.cancelled,
                "deadline_misses": self.deadline_misses,
                "deadline_hit_rate": self.deadline_hit_rate,
                "fired_full": self.fired_full,
                "fired_deadline": self.fired_deadline,
                "fired_idle": self.fired_idle,
                "fired_drain": self.fired_drain,
                "max_inflight": self.max_inflight,
                "lane_batches": dict(self.lane_batches)}


class SolveTicket:
    """Future-like handle for one dispatched request.

    ``result()`` blocks until the solve lands (or raises on timeout /
    dispatcher failure).  Timing fields are filled in as the request moves
    through the pipeline: ``submitted_at`` → ``fired_at`` → ``started_at``
    (its lane began the batch) → ``completed_at`` (``repro_torch.obs.now()``
    values — the single serving clock, so queue wait, lane wait and engine
    solve time compose); ``deadline`` is absolute or None.  At the fire
    the ticket also gets ``fire_reason`` (``full`` / ``idle`` /
    ``deadline`` / ``drain``) and ``batch``, the dispatcher's sequence
    number of the fire, which every span of the batch carries.
    """

    def __init__(self, request: SolveRequest, deadline: Optional[float],
                 dispatcher: Optional["AsyncDispatcher"] = None):
        self.request = request
        self.deadline = deadline
        self.submitted_at = obs.now()
        self.fired_at: Optional[float] = None
        self.started_at: Optional[float] = None
        self.fire_reason: Optional[str] = None
        self.batch: Optional[int] = None
        self.completed_at: Optional[float] = None
        self.deadline_met: Optional[bool] = None
        self._event = threading.Event()
        self._result: Optional[ServedSolve] = None
        self._exception: Optional[BaseException] = None
        self._dispatcher = dispatcher
        self._cancelled = False
        self._bp_lane: Optional[str] = None  # lane label counted for
        # per-lane backpressure at submit (None = not lane-counted)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServedSolve:
        """Wait for the solve.  A ``TimeoutError`` leaves the ticket live —
        the solve still completes and still counts against the caller's
        backpressure budget; a caller that is *done* with a timed-out
        ticket should ``cancel()`` it so the dispatcher can drop it."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.request_id!r} not completed "
                f"within {timeout}s")
        if self._exception is not None:
            raise self._exception
        return self._result

    def cancel(self) -> bool:
        """Drop the request if its batch has not fired yet.

        Returns True when the cancellation won: the ticket completes
        immediately (``result()`` raises ``TicketCancelled``, no deadline
        miss recorded) and the dispatcher releases its backpressure slot —
        the fix for the ``result(timeout=...)`` leak, where every timed-out
        ticket stayed in flight forever and eventually wedged ``drain()``
        and the queue budget.  Returns False when the ticket already fired
        (the solve proceeds and will land on the ticket normally), already
        completed, or was already cancelled.
        """
        disp = self._dispatcher
        if disp is None:
            return False
        with disp._cv:
            # fired_at is the cut-off, stamped under this same lock by
            # _fire_ready: after it, the lane owns the ticket.
            if (self._event.is_set() or self._cancelled
                    or self.fired_at is not None):
                return False
            self._cancelled = True
        self.completed_at = obs.now()
        self._exception = TicketCancelled(
            f"request {self.request.request_id!r} cancelled")
        # deadline_met stays None: a cancelled ticket is not a miss.
        self._event.set()
        disp._on_cancel(self)
        return True

    @property
    def latency_s(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Submit → fire wait (None until the batch fires)."""
        if self.fired_at is None:
            return None
        return self.fired_at - self.submitted_at

    @property
    def lane_wait_s(self) -> Optional[float]:
        """Fire → the lane began the batch (None until it began)."""
        if self.started_at is None or self.fired_at is None:
            return None
        return self.started_at - self.fired_at

    @property
    def telemetry(self):
        """The completed result's ``SolveTelemetry`` (None until
        completion, on failure, or when obs is disabled)."""
        return self._result.telemetry if self._result is not None else None

    # ------------------------------------------------- dispatcher-side
    def _complete(self, result: ServedSolve) -> None:
        self.completed_at = obs.now()
        self._result = result
        if self.deadline is not None:
            self.deadline_met = self.completed_at <= self.deadline
        tel = result.telemetry
        if tel is not None:
            # Back-fill the async-path timings the engine can't see: how
            # long the request waited in the dispatcher before its batch
            # fired, and how much deadline headroom was left at completion.
            tel.queue_wait_s = self.queue_wait_s
            if self.deadline is not None:
                tel.deadline_margin_s = self.deadline - self.completed_at
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self.completed_at = obs.now()
        self._exception = exc
        if self.deadline is not None:
            self.deadline_met = False
        self._event.set()


@dataclass
class _PendingBatch:
    """One per-(bucket, solver-config) accumulation of tickets.

    ``lane`` is the execution lane the batch will fire onto — fixed at
    creation, since every member shares the config key the lane derives
    from.
    """

    lane: LaneKey
    tickets: List[SolveTicket] = field(default_factory=list)
    last_join: float = 0.0

    @property
    def min_deadline(self) -> float:
        dls = [t.deadline for t in self.tickets if t.deadline is not None]
        return min(dls) if dls else float("inf")


class AsyncDispatcher:
    """Deadline-aware async front-end over ``SolverServeEngine``."""

    def __init__(self, engine: Optional[SolverServeEngine] = None,
                 config: Optional[DispatchConfig] = None):
        # The default engine runs on the card (and raises without one).
        self.engine = engine or SolverServeEngine(ServeConfig())
        self.config = config or DispatchConfig()
        if self.config.backpressure not in ("reject", "block"):
            raise ValueError(
                f"backpressure must be 'reject' or 'block', "
                f"got {self.config.backpressure!r}")
        self.stats = DispatchStats()
        reg = self.engine.registry
        self._m_submitted = reg.counter(
            "serve_dispatch_submitted_total", "requests accepted by submit()")
        self._m_rejected = reg.counter(
            "serve_dispatch_rejected_total",
            "requests rejected by backpressure")
        self._m_completed = reg.counter(
            "serve_dispatch_completed_total",
            "tickets completed (served or failed)")
        self._m_cancelled = reg.counter(
            "serve_dispatch_cancelled_total",
            "tickets cancelled before their batch fired")
        self._m_deadline_misses = reg.counter(
            "serve_dispatch_deadline_misses_total",
            "completed tickets that missed their deadline")
        self._m_fired = reg.counter(
            "serve_dispatch_fired_total", "batches fired, by flush reason")
        self._m_inflight = reg.gauge(
            "serve_dispatch_inflight",
            "requests accepted and not yet completed")
        self._m_queue_wait = reg.histogram(
            "serve_queue_wait_seconds",
            "submit-to-fire wait per request", obs.LATENCY_BUCKETS)
        self._m_req_latency = reg.histogram(
            "serve_request_latency_seconds",
            "submit-to-complete latency per request", obs.LATENCY_BUCKETS)
        self._cv = threading.Condition()
        self._intake: deque = deque()
        self._inflight = 0          # accepted and not yet completed
        self._lane_inflight: Dict[str, int] = {}  # per-lane, submit-counted
        self._draining = False
        self._stopping = False
        self._abandon = False       # stop(drain=False): fail, don't serve
        self._started = False
        self._seq = 0
        self._batch_seq = 0         # fires so far (dispatch-thread only)
        # Dispatch-thread-only state.
        self._pending: "Dict[Tuple, _PendingBatch]" = {}
        # Fired batches live on the engine's execution lanes; this maps each
        # outstanding LaneWork -> (claim fn, tickets) so stop(drain=False)
        # can claim and fail queued-but-unstarted batches with no orphaned
        # tickets.
        self._works: Dict[LaneWork, Tuple] = {}
        self._works_lock = threading.Lock()
        self._dispatch_thread: Optional[threading.Thread] = None
        dev = self.engine.device
        # The dispatch thread's own CUDA stream (None off the card).
        self._stream = (torch.cuda.Stream(device=dev)
                        if dev.type == "cuda" else None)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "AsyncDispatcher":
        if self._started:
            return self
        self._started = True
        self._stopping = False
        self._abandon = False
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="serve-dispatch", daemon=True)
        self._dispatch_thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the dispatcher; with ``drain`` (default) serve what's queued
        first, otherwise fail unserved tickets with ``DispatcherStopped``.

        Either way every ticket is complete (served or failed) when this
        returns — fired batches still queued on a lane are claimed and
        failed, in-flight ones are waited for.  The engine's lane threads
        themselves are engine-owned and stay up (``engine.shutdown()``
        stops them).
        """
        if not self._started:
            return
        if drain:
            self.drain()
        with self._cv:
            self._abandon = not drain
            self._stopping = True
            self._cv.notify_all()
        self._dispatch_thread.join()
        if not drain:
            self._finalize_abandoned()
        self._started = False

    def __enter__(self) -> "AsyncDispatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    # --------------------------------------------------------------- intake
    def submit(self, request: SolveRequest,
               deadline_s: Optional[float] = None) -> SolveTicket:
        """Queue a request; returns a ``SolveTicket`` immediately.

        ``deadline_s`` (relative, seconds) overrides ``request.deadline_s``;
        with neither set, ``config.default_deadline_s`` applies.  Under the
        "reject" policy a full pipeline raises ``QueueFullError``; under
        "block" this call waits for capacity.
        """
        if not self._started:
            raise DispatcherStopped("dispatcher is not running; call start()")
        rel = deadline_s
        if rel is None:
            rel = request.deadline_s
        if rel is None:
            rel = self.config.default_deadline_s
        if rel is not None and rel <= 0:
            raise ValueError(f"deadline_s must be positive, got {rel}")
        ticket = SolveTicket(
            request, None if rel is None else obs.now() + float(rel),
            dispatcher=self)
        # Stamp the absolute deadline onto the request so the engine's
        # retry ladder (repro_torch.resilience) is bounded by it.
        request.deadline_at = ticket.deadline
        cfg = self.config
        lane_lbl = (self._lane_label_of(request)
                    if cfg.max_lane_inflight is not None else None)
        with self._cv:
            if self._stopping:
                raise DispatcherStopped("dispatcher stopped")
            if request.request_id is None:
                request.request_id = f"areq-{self._seq}"
            self._seq += 1

            def _over() -> Optional[str]:
                if self._inflight >= cfg.max_queue:
                    return (f"dispatcher at capacity ({cfg.max_queue} "
                            f"in flight)")
                if (lane_lbl is not None
                        and self._lane_inflight.get(lane_lbl, 0)
                        >= cfg.max_lane_inflight):
                    return (f"lane {lane_lbl} at capacity "
                            f"({cfg.max_lane_inflight} in flight)")
                return None

            over = _over()
            if over is not None:
                if cfg.backpressure == "reject":
                    self.stats.rejected += 1
                    self._m_rejected.inc()
                    raise QueueFullError(over)
                while _over() is not None:
                    if self._stopping:
                        raise DispatcherStopped("dispatcher stopped")
                    self._cv.wait(0.01)
            self._inflight += 1
            if lane_lbl is not None:
                ticket._bp_lane = lane_lbl
                self._lane_inflight[lane_lbl] = (
                    self._lane_inflight.get(lane_lbl, 0) + 1)
            self.stats.submitted += 1
            self._m_submitted.inc()
            self._m_inflight.set(self._inflight)
            self.stats.max_inflight = max(self.stats.max_inflight,
                                          self._inflight)
            self._intake.append(ticket)
            self._cv.notify_all()
        return ticket

    def _lane_label_of(self, req: SolveRequest) -> Optional[str]:
        """Cheap submit-time lane estimate for per-lane backpressure.

        Uses only the request's array shape + spec + the engine's routing
        tables (no padding, hashing or device work).  Returns None when the
        lane can't be determined without normalising (e.g. ``x`` is a
        list) — those requests only count against the global queue; the
        authoritative lane is still assigned at admit time.
        """
        try:
            shape = getattr(req.x, "shape", None)
            if shape is None or len(shape) != 2:
                return None
            eng = self.engine
            bucket = bucket_shape(int(shape[0]), int(shape[1]),
                                  min_obs=eng.config.min_obs,
                                  min_vars=eng.config.min_vars)
            spec = eng.spec_for(req)
            placement = eng.placement_for(bucket, spec.method)
            return eng.lanes.lane_for(spec.method, placement,
                                      eng.mesh).label
        except Exception:
            return None

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Fire everything pending and wait for the pipeline to empty.

        Returns False if ``timeout`` elapsed first.
        """
        deadline = None if timeout is None else obs.now() + timeout
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while self._inflight > 0:
                remaining = (None if deadline is None
                             else deadline - obs.now())
                if remaining is not None and remaining <= 0:
                    self._draining = False
                    return False
                self._cv.wait(0.005 if remaining is None
                              else min(0.005, remaining))
            self._draining = False
        return True

    @property
    def inflight(self) -> int:
        with self._cv:
            return self._inflight

    # ------------------------------------------------------ dispatch thread
    def _next_wake_delay(self) -> Optional[float]:
        """Seconds until the most urgent pending batch could fire (its
        deadline-margin or idle expiry, whichever is sooner), or None when
        nothing is pending — sleep until a notify.  Dispatch-thread only."""
        if not self._pending:
            return None
        cfg = self.config
        t = float("inf")
        for batch in self._pending.values():
            t = min(t,
                    batch.last_join + cfg.idle_timeout_s,
                    batch.min_deadline - cfg.deadline_margin_s)
        return max(0.0, t - obs.now())

    def _dispatch_loop(self) -> None:
        with contextlib.ExitStack() as ctx:
            if self._stream is not None:
                ctx.enter_context(torch.cuda.device(self.engine.device))
                ctx.enter_context(torch.cuda.stream(self._stream))
            self._dispatch_forever()

    def _dispatch_forever(self) -> None:
        while True:
            with self._cv:
                if not self._intake and not self._stopping:
                    # Sleep exactly until the most urgent pending batch's
                    # deadline-margin/idle expiry; fully idle we sleep
                    # until submit()/drain()/stop() notifies (no polling).
                    self._cv.wait(self._next_wake_delay())
                arrivals = []
                while self._intake:
                    arrivals.append(self._intake.popleft())
                stopping = self._stopping
                draining = self._draining
                abandon = self._abandon
            if stopping and abandon:
                residual = [t for t in arrivals if not t._cancelled]
                residual += [t for b in self._pending.values()
                             for t in b.tickets if not t._cancelled]
                self._pending.clear()
                for t in residual:
                    t._fail(DispatcherStopped("dispatcher stopped"))
                if residual:
                    self._on_complete(residual)
                return  # stop() finalizes fired-but-unserved lane works
            for ticket in arrivals:
                self._admit(ticket)
            now = obs.now()
            for lane, urgency, chunk in self._fire_ready(
                    now, drain_all=draining or stopping):
                self._submit_batch(lane, urgency, chunk)
            if stopping and not self._pending:
                self._drain_works()
                return

    def _admit(self, ticket: SolveTicket) -> None:
        """Normalise + fingerprint one request and join it to its batch,
        in a ``dispatch.admit`` span.

        This is the host-side work that overlaps in-flight device solves:
        validation, design hashing and (optionally) design-cache pre-warm
        (padding, the copy to the device, column norms, the kernels'
        layouts, a store promotion) all happen here on the dispatch thread
        and its stream.
        """
        if ticket._cancelled:
            return  # cancel() already settled and accounted the ticket
        with obs.span("dispatch.admit", request_id=ticket.request.request_id):
            self._admit_traced(ticket)

    def _admit_traced(self, ticket: SolveTicket) -> None:
        req = ticket.request
        try:
            prepare_request(req, fingerprint=True)
        except Exception as exc:
            ticket._fail(exc)
            self._on_complete([ticket])
            return
        ecfg = self.engine.config
        bucket = request_bucket(req, min_obs=ecfg.min_obs,
                                min_vars=ecfg.min_vars)
        spec = self.engine.spec_for(req)
        # Placement- and spec-aware key: batches the dispatcher accumulates
        # line up with the engine's flush grouping, so a sharded bucket's
        # requests never share a pending batch with single-device ones.
        placement = self.engine.placement_for(bucket, spec.method)
        if self.config.prewarm_cache:
            try:
                # record_stats=False: the flush-time lookup is the one cache
                # event per request, so hit rates stay comparable with the
                # synchronous path ("hit" = design state resident at flush).
                # Passing the effective spec also warms the method's derived
                # design state (thr-padded column norms, Cholesky factors,
                # the kernels' transposed copies) here, and the placement
                # binds the entry's home lane and builds its sharded copy,
                # all overlapping whatever solves are in flight on the
                # lanes.  On a store-backed engine this is also the async
                # tier *promotion*: a design demoted to host/disk climbs
                # back to device here, while its request still waits in
                # the intake queue.
                self.engine.cache.get_or_build(
                    req.design_key, lambda: pad_x(req.x, bucket),
                    spec=spec, record_stats=False, placement=placement,
                    mesh=self.engine.mesh)
            except Exception:
                pass  # engine flush will surface the failure per-request
        batch = self._pending.setdefault(
            config_key(req, bucket, placement, spec),
            _PendingBatch(lane=self.engine.lanes.lane_for(
                spec.method, placement, self.engine.mesh)))
        batch.tickets.append(ticket)
        batch.last_join = obs.now()

    def _fire_ready(self, now: float, drain_all: bool = False
                    ) -> List[Tuple[LaneKey, float, List[SolveTicket]]]:
        """Pop every batch whose flush condition holds, most urgent first.

        Returns (lane, urgency, tickets) triples: the batch's execution
        lane and its most urgent member's absolute deadline (``inf`` for
        deadline-less batches), which orders each lane's queue.
        """
        cfg = self.config
        ready: List[Tuple[float, Tuple, str]] = []
        for key, batch in self._pending.items():
            if not batch.tickets:
                continue
            min_dl = batch.min_deadline
            if drain_all:
                ready.append((min_dl, key, "drain"))
            elif len(batch.tickets) >= cfg.max_batch:
                ready.append((min_dl, key, "full"))
            elif min_dl - cfg.deadline_margin_s <= now:
                ready.append((min_dl, key, "deadline"))
            elif now - batch.last_join >= cfg.idle_timeout_s:
                ready.append((min_dl, key, "idle"))
        # Deadline-ordered firing: the batch with the most urgent member
        # submits to its lane first (and carries its deadline as the lane
        # queue's urgency, so lanes also drain most-urgent-first).
        ready.sort(key=lambda r: r[0])
        fired: List[Tuple[LaneKey, float, List[SolveTicket]]] = []
        for min_dl, key, why in ready:
            batch = self._pending.pop(key)
            # max_batch is an upper bound too: a burst admitted in one
            # iteration fires as several max_batch-sized solves, keeping
            # the configured latency/memory bound per engine call.
            for lo in range(0, len(batch.tickets), cfg.max_batch):
                chunk = batch.tickets[lo:lo + cfg.max_batch]
                # fired_at is the cancel() cut-off and is stamped under
                # _cv: a cancel that won the race is dropped here; one
                # that arrives after sees fired_at set and returns False.
                with self._cv:
                    live = [t for t in chunk if not t._cancelled]
                    for t in live:
                        t.fired_at = now
                        t.fire_reason = why
                        t.batch = self._batch_seq
                if not live:
                    continue
                self._batch_seq += 1
                setattr(self.stats, f"fired_{why}",
                        getattr(self.stats, f"fired_{why}") + 1)
                self._m_fired.inc(1, reason=why)
                lbl = batch.lane.label
                self.stats.lane_batches[lbl] = (
                    self.stats.lane_batches.get(lbl, 0) + 1)
                for t in live:
                    self._m_queue_wait.observe(now - t.submitted_at)
                fired.append((batch.lane, min_dl, live))
        return fired

    # ------------------------------------------------------ lane execution
    def _submit_batch(self, lane: LaneKey, urgency: float,
                      tickets: List[SolveTicket]) -> None:
        """Hand one fired batch to its execution lane.

        The work closure carries a claim flag: exactly one of the lane
        thread and ``_finalize_abandoned`` (after ``stop(drain=False)``)
        gets to settle the tickets, so none are served twice and none are
        orphaned.
        """
        claim_lock = threading.Lock()
        claimed = [False]

        def try_claim() -> bool:
            with claim_lock:
                if claimed[0]:
                    return False
                claimed[0] = True
                return True

        head = tickets[0]

        def run() -> None:
            if not try_claim():
                return
            started = obs.now()
            for t in tickets:
                t.started_at = started
            served = None
            if self._abandon:
                for t in tickets:
                    t._fail(DispatcherStopped("dispatcher stopped"))
            else:
                try:
                    with obs.span("dispatch.solve_batch", size=len(tickets),
                                  lane=lane.label, batch=head.batch,
                                  fire_reason=head.fire_reason,
                                  lane_wait_s=head.lane_wait_s):
                        served = self.engine.serve(
                            [t.request for t in tickets])
                except Exception as exc:  # engine failure: fail the batch
                    for ticket in tickets:
                        ticket._fail(exc)
            with obs.span("dispatch.complete", batch=head.batch):
                if served is not None:
                    try:
                        for ticket, result in zip(tickets, served):
                            # A broken kernel fails the ticket with its
                            # error.
                            kerr = result.extra.get("kernel_error")
                            if kerr is not None:
                                ticket._fail(kerr)
                            else:
                                ticket._complete(result)
                    except Exception as exc:
                        for ticket in tickets:
                            ticket._fail(exc)
                self._on_complete(tickets)
            with self._works_lock:
                self._works.pop(work, None)

        def on_fail(exc: BaseException) -> None:
            # Lane-side failure without the callable completing — worker-
            # thread death (LaneWorkerDeath) or an abandoning shutdown.
            # Claim-protected like every other settle path: if the work
            # half-ran, run() already owns the tickets and this is a no-op.
            if not try_claim():
                return
            for t in tickets:
                t._fail(exc)
            self._on_complete(tickets)
            with self._works_lock:
                self._works.pop(work, None)

        work = LaneWork(run, urgency=urgency, size=len(tickets),
                        tag=lane.label, on_fail=on_fail)
        with self._works_lock:
            self._works[work] = (try_claim, tickets)
        try:
            self.engine.lanes.submit(lane, work)
        except Exception as exc:  # lane shut down under us
            if try_claim():
                for t in tickets:
                    t._fail(exc)
                self._on_complete(tickets)
            with self._works_lock:
                self._works.pop(work, None)

    def _drain_works(self) -> None:
        """Wait for every outstanding lane work (dispatch-thread, on a
        draining stop) so ``stop()`` returns with all tickets complete."""
        with self._works_lock:
            works = list(self._works)
        for w in works:
            w.wait()

    def _finalize_abandoned(self) -> None:
        """After ``stop(drain=False)``: claim queued-but-unstarted lane
        works and fail their tickets; wait out the ones already running."""
        with self._works_lock:
            works = list(self._works.items())
        for w, (claim, tickets) in works:
            if claim():
                for t in tickets:
                    t._fail(DispatcherStopped("dispatcher stopped"))
                self._on_complete(tickets)
                with self._works_lock:
                    self._works.pop(w, None)
            else:
                w.wait()

    def _on_cancel(self, ticket: SolveTicket) -> None:
        """Release a cancelled ticket's pipeline slot (called by
        ``SolveTicket.cancel`` after it settled the ticket).  Mirrors
        ``_on_complete`` minus the latency/deadline recording — a cancel
        is neither a served request nor a miss."""
        with self._cv:
            self._inflight -= 1
            if ticket._bp_lane is not None:
                left = self._lane_inflight.get(ticket._bp_lane, 0) - 1
                if left > 0:
                    self._lane_inflight[ticket._bp_lane] = left
                else:
                    self._lane_inflight.pop(ticket._bp_lane, None)
                ticket._bp_lane = None
            self.stats.completed += 1
            self.stats.cancelled += 1
            self._m_inflight.set(self._inflight)
            self._cv.notify_all()
        self._m_completed.inc(1)
        self._m_cancelled.inc(1)

    def _on_complete(self, tickets: List[SolveTicket]) -> None:
        misses = sum(1 for t in tickets if t.deadline_met is False)
        with self._cv:
            self._inflight -= len(tickets)
            for t in tickets:
                if t._bp_lane is not None:
                    left = self._lane_inflight.get(t._bp_lane, 0) - 1
                    if left > 0:
                        self._lane_inflight[t._bp_lane] = left
                    else:
                        self._lane_inflight.pop(t._bp_lane, None)
                    t._bp_lane = None
            self.stats.completed += len(tickets)
            # Failures count as misses too: _fail() marks deadline_met
            # False on any ticket that carried a deadline.
            self.stats.deadline_misses += misses
            self._m_inflight.set(self._inflight)
            self._cv.notify_all()
        self._m_completed.inc(len(tickets))
        if misses:
            self._m_deadline_misses.inc(misses)
        for t in tickets:
            if t.latency_s is not None:
                self._m_req_latency.observe(t.latency_s)
