"""Structured tracing: the serving clock, spans, solve telemetry, and the
kernel-path relay.

Counterpart of ``repro.obs.trace``, with the port's relay folded in.

**The clock.** ``now()`` is THE timestamp source for the serving stack —
``time.perf_counter`` — so durations and absolute deadlines live on one
timeline.  A device solve is timed to its end, not to its launch: the
engine synchronises the lane's CUDA stream (``sync_device``) before it
reads the clock again.

**Spans.** ``Tracer.span("engine.flush", bucket=..., method=...)`` is a
context manager recording wall time on ``now()``, nesting (per-thread
stack → ``parent_id`` and depth; every span gets a ``span_id``) and
free-form tags into an in-memory ring buffer.  A span inherits the link
tags ``batch`` (the dispatcher's sequence number of the fired batch it
serves) and ``request_id`` from its parent, so the dispatch thread's and a
lane's spans of one batch or request can be joined.  ``Tracer.dropped``
counts spans the ring pushed out; its default room holds a few minutes
of a busy server's spans, and ``Tracer.reserve`` gives it more.  While the
program's own trace records (``obs.start_profiling``, which records every
thread), each span also opens a ``record_function`` range of its name,
and an NVTX range on a card; under a profiler someone else started, which
records only its own thread, a span opens nothing.

**The clock map.** The profiler stamps host events in Unix-epoch
nanoseconds, not on ``now()``.  The tracer keeps an anchor, a
``(time.perf_counter_ns(), time.time_ns())`` pair read back to back
(the tightest of a few tries), taken when it is built or cleared;
``Tracer.unix_ns`` maps a span's times onto the profiler's timeline
through it.

**SolveTelemetry.** One record per served request — who (tenant), where
(bucket, kernel path, lane), how (warm/cold, batch kind/size), and outcome
(sweeps, SSE, converged, error type).  The engine attaches it to every
``ServedSolve``.

**The relay.** The eager dispatch shims (``kernels/ops.py``,
``core/methods.py``) call ``record_dispatch`` once per solve.  It bumps
two plain counters — ``dispatch_counts()`` ``{(path, method): n}`` and
``fallback_counts()`` ``{(method, reason): n}`` (``reason`` non-empty:
``"vmem"`` for over the on-chip budget, ``"max_iter"`` for a zero sweep
budget) — and the default registry's ``solver_dispatch_total`` /
``solver_fallback_total``, and parks the path in a thread-local slot the
serving engine pops with ``consume_dispatch``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter, deque
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import profiling as _profiling

#: The single serving clock (seconds, monotonic, highest resolution
#: available).  Compare/subtract only against other ``now()`` readings.
now = time.perf_counter

#: Tags a span takes from its parent unless it sets them itself.
LINK_TAGS = ("batch", "request_id")


def sync_device(device) -> None:
    """Wait for the work queued on ``device``'s current stream (the calling
    lane's stream); a no-op for a CPU device.  Timed regions that end in a
    device solve call this before reading ``now()``."""
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch

        torch.cuda.current_stream(device).synchronize()


def clock_anchor(tries: int = 16) -> Tuple[int, int]:
    """A ``(perf_counter_ns, time_ns)`` pair read at one instant: of
    ``tries`` back-to-back brackets ``perf, unix, perf``, the tightest,
    with the two perf readings averaged."""
    best = None
    for _ in range(tries):
        p0 = time.perf_counter_ns()
        unix = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, (p0 + p1) // 2, unix)
    return best[1], best[2]


@dataclass
class SpanRecord:
    """One completed (or still-open) span; times are ``now()`` readings."""

    name: str
    t_start: float
    t_end: Optional[float] = None
    tags: Dict[str, Any] = field(default_factory=dict)
    span_id: int = 0
    parent_id: Optional[int] = None
    depth: int = 0
    thread: str = ""

    @property
    def duration_s(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return self.t_end - self.t_start

    def as_dict(self) -> dict:
        d = asdict(self)
        d["duration_s"] = self.duration_s
        return d


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    return str(v)


def _profiler_range(name: str):
    """A ``record_function`` (plus, on a card, an NVTX) range of ``name``
    while ``obs.start_profiling``'s trace records; None otherwise."""
    if not _profiling.profiling_active():
        return None
    import torch

    ctx = contextlib.ExitStack()
    ctx.enter_context(torch.profiler.record_function(name))
    if torch.cuda.is_available():
        ctx.enter_context(torch.cuda.nvtx.range(name))
    return ctx


class Tracer:
    """Ring-buffered span recorder with per-thread nesting.

    ``capacity`` bounds memory: the oldest spans are pushed out (counted
    in ``dropped``), the newest kept; ``reserve`` grows it.  The default,
    2^16 spans (about 28 MB), holds about four minutes of a server that
    records 280 spans a second (~27 single solves a second).  Thread-safe:
    the ring shares one lock; the nesting stack is thread-local, so spans
    on different threads never see each other as parents (the link tags
    join them).
    """

    def __init__(self, capacity: int = 1 << 16):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.dropped = 0
        self.anchor = clock_anchor()

    def reserve(self, capacity: int) -> None:
        """Let the ring hold at least ``capacity`` spans (what it holds
        stays): room for every span of a measured window."""
        with self._lock:
            if capacity > self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=capacity)

    def unix_ns(self, t: float) -> int:
        """A ``now()`` reading on the profiler's Unix-epoch ns timeline,
        through the anchor."""
        perf_ns, unix_ns = self.anchor
        return unix_ns + round(t * 1e9) - perf_ns

    # ------------------------------------------------------------ record
    @contextmanager
    def span(self, name: str, **tags):
        """Record one span; yields the (mutable) ``SpanRecord`` so the body
        can attach result tags.  No-op (yields None) when obs is disabled."""
        if not _metrics.enabled():
            yield None
            return
        stack: List[SpanRecord] = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        tags = {k: _jsonable(v) for k, v in tags.items()}
        parent = stack[-1] if stack else None
        if parent is not None:
            for k in LINK_TAGS:
                if k in parent.tags and k not in tags:
                    tags[k] = parent.tags[k]
        rec = SpanRecord(
            name=name, t_start=now(), tags=tags, span_id=next(self._ids),
            parent_id=parent.span_id if parent is not None else None,
            depth=len(stack), thread=threading.current_thread().name)
        ranges = _profiler_range(name)
        stack.append(rec)
        try:
            if ranges is None:
                yield rec
            else:
                with ranges:
                    yield rec
        finally:
            rec.t_end = now()
            stack.pop()
            with self._lock:
                if len(self._ring) == self._ring.maxlen:
                    self.dropped += 1
                self._ring.append(rec)

    # ------------------------------------------------------------- reads
    def spans(self, name: Optional[str] = None) -> List[SpanRecord]:
        """Completed spans, oldest first (optionally filtered by name)."""
        with self._lock:
            out = list(self._ring)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def clear(self) -> None:
        """Empty the ring, zero ``dropped`` and take a fresh clock anchor."""
        with self._lock:
            self._ring.clear()
            self.dropped = 0
        self.anchor = clock_anchor()


def self_seconds(spans: List[SpanRecord]) -> Dict[int, float]:
    """Each completed span's own time: its duration less its children's
    (by ``parent_id``, among ``spans``), keyed by ``span_id``."""
    own = {s.span_id: s.duration_s for s in spans if s.t_end is not None}
    for s in spans:
        if s.parent_id in own and s.t_end is not None:
            own[s.parent_id] -= s.duration_s
    return own


_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer (ring buffer)."""
    return _tracer


def span(name: str, **tags):
    """``get_tracer().span(...)`` — the port's one instrumentation call."""
    return _tracer.span(name, **tags)


# -------------------------------------------------------- kernel-path relay
_relay_lock = threading.Lock()
_dispatch: Counter = Counter()
_fallback: Counter = Counter()
_dispatch_local = threading.local()


def record_dispatch(path: str, method: str = "", reason: str = "") -> None:
    """Note the kernel path a solve ran (``fused`` / ``persweep`` /
    ``stream`` / ``stream_host`` / ``xla``) — see the module doc.  The plain
    counters always count; the registry families only while obs is on."""
    method = method or "unknown"
    with _relay_lock:
        _dispatch[(path, method)] += 1
        if reason:
            _fallback[(method, reason)] += 1
    _dispatch_local.last = path
    if not _metrics.enabled():
        return
    reg = _metrics.default_registry()
    reg.counter("solver_dispatch_total",
                "solver calls by kernel path actually executed").inc(
        1, path=path, method=method)
    if reason:
        reg.counter("solver_fallback_total",
                    "solves re-routed off their requested kernel path").inc(
            1, method=method, reason=reason)


def consume_dispatch(default: Optional[str] = None) -> Optional[str]:
    """Pop the kernel path recorded by the last solve on this thread."""
    path = getattr(_dispatch_local, "last", None)
    _dispatch_local.last = None
    return path if path is not None else default


def dispatch_counts() -> Dict[Tuple[str, str], int]:
    with _relay_lock:
        return dict(_dispatch)


def fallback_counts() -> Dict[Tuple[str, str], int]:
    with _relay_lock:
        return dict(_fallback)


def reset_counters() -> None:
    with _relay_lock:
        _dispatch.clear()
        _fallback.clear()


# ------------------------------------------------------------ solve records
@dataclass
class SolveTelemetry:
    """Per-request solve record (see module doc).

    ``kernel_path`` is the dispatch route that actually executed —
    ``fused`` (whole-solve CUDA kernel), ``persweep`` (per-sweep kernel
    loop), ``stream`` (streaming kernel), ``xla`` (the plain torch family,
    named as in the JAX package) or ``vmap`` (the batch across designs) —
    including fallbacks (a ``bakp_fused`` request whose coalesced width
    outgrew the on-chip budget reports ``xla``), which ``method`` alone
    cannot show.

    ``queue_wait_s`` (submit → fire) and ``deadline_margin_s`` are set by
    the async dispatcher (``serve.dispatch.SolveTicket``) when the ticket
    completes; a request served by the engine alone leaves them None.
    ``solve_s`` ends after the lane's stream was synchronised.
    ``retries`` counts the retry-ladder steps the request's solve took.
    """

    request_id: str = ""
    tenant_id: Optional[str] = None
    bucket: Tuple[int, int] = (0, 0)
    method: str = ""
    kernel_path: str = "unknown"
    placement: str = "single"
    lane: str = ""                    # execution-lane label ("single:xla",
    # "single:fused", "serial", ...; "inline" = solved on the caller's
    # thread, e.g. a flush nested inside a lane work)
    batch_kind: str = "single"
    group_size: int = 1
    batch_size: int = 1
    warm_start: bool = False
    cache_hit: bool = False
    n_sweeps: int = 0
    sse: float = 0.0
    converged: bool = False
    retries: int = 0
    solve_s: float = 0.0
    queue_wait_s: Optional[float] = None
    deadline_margin_s: Optional[float] = None
    error_type: Optional[str] = None

    def as_dict(self) -> dict:
        return {k: _jsonable(v) for k, v in asdict(self).items()}
