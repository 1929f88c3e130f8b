"""Structured tracing: the serving clock, spans, solve telemetry, and the
kernel-path relay.

Counterpart of ``repro.obs.trace``, with the port's relay folded in.

**The clock.** ``now()`` is THE timestamp source for the serving stack —
``time.perf_counter`` — so durations and absolute deadlines live on one
timeline.  A device solve is timed to its end, not to its launch: the
engine synchronises the lane's CUDA stream (``sync_device``) before it
reads the clock again.

**Spans.** ``Tracer.span("engine.flush", bucket=..., method=...)`` is a
context manager recording wall time, nesting (per-thread stack → parent
name + depth) and free-form tags into an in-memory ring buffer, with an
optional JSONL sink for offline analysis.  Spans are for *structure* (what
called what, where the time went inside one flush); the aggregate story
lives in the metrics registry.

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

import json
import threading
import time
from collections import Counter, deque
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs import metrics as _metrics

#: The single serving clock (seconds, monotonic, highest resolution
#: available).  Compare/subtract only against other ``now()`` readings.
now = time.perf_counter


def sync_device(device) -> None:
    """Wait for the work queued on ``device``'s current stream (the calling
    lane's stream); a no-op for a CPU device.  Timed regions that end in a
    device solve call this before reading ``now()``."""
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch

        torch.cuda.current_stream(device).synchronize()


@dataclass
class SpanRecord:
    """One completed (or still-open) span."""

    name: str
    t_start: float
    t_end: Optional[float] = None
    tags: Dict[str, Any] = field(default_factory=dict)
    parent: Optional[str] = None
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


class Tracer:
    """Ring-buffered span recorder with per-thread nesting.

    ``capacity`` bounds memory (old spans are dropped, newest kept);
    ``jsonl_path`` (or a later ``set_sink``) additionally appends one JSON
    object per completed span.  Thread-safe: the ring and sink share one
    lock; the nesting stack is thread-local, so spans on different threads
    never see each other as parents.
    """

    def __init__(self, capacity: int = 2048,
                 jsonl_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._local = threading.local()
        self._sink = None
        if jsonl_path:
            self.set_sink(jsonl_path)

    # ------------------------------------------------------------- sink
    def set_sink(self, path: Optional[str]) -> None:
        """Point the JSONL sink at ``path`` (None closes it)."""
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
            if path:
                self._sink = open(path, "a", encoding="utf-8")

    def close(self) -> None:
        self.set_sink(None)

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
        rec = SpanRecord(
            name=name, t_start=now(),
            tags={k: _jsonable(v) for k, v in tags.items()},
            parent=stack[-1].name if stack else None,
            depth=len(stack), thread=threading.current_thread().name)
        stack.append(rec)
        try:
            yield rec
        finally:
            rec.t_end = now()
            stack.pop()
            with self._lock:
                self._ring.append(rec)
                if self._sink is not None:
                    json.dump(rec.as_dict(), self._sink)
                    self._sink.write("\n")
                    self._sink.flush()

    # ------------------------------------------------------------- reads
    def spans(self, name: Optional[str] = None) -> List[SpanRecord]:
        """Completed spans, oldest first (optionally filtered by name)."""
        with self._lock:
            out = list(self._ring)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer (ring buffer + optional JSONL sink)."""
    return _tracer


def span(name: str, **tags):
    """``get_tracer().span(...)`` — the standard instrumentation call."""
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

    ``queue_wait_s`` and ``deadline_margin_s`` belong to the async
    dispatcher, which the port does not have yet; they stay None.
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
