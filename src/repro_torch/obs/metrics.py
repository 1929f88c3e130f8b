"""Unified metrics registry — Counter / Gauge / Histogram, stdlib only.

The port's own copy of ``repro.obs.metrics`` (the same semantics, imported
from nowhere in the JAX package).  One ``MetricsRegistry`` holds every
metric family the serving stack emits; ``snapshot()`` returns a plain
(JSON-serialisable) dict and ``render_prometheus()`` emits the Prometheus
text exposition format, so one exporter reads the same numbers the engine,
cache, lanes and kernel dispatch record.  No third-party client library.

Concurrency: every metric family guards its label→series map and series
state with one lock; the registry guards the name→family map with another.
``snapshot()``/``render_prometheus()`` take the same locks per family, so a
reader never observes a torn histogram (count incremented but sum not).
Lane threads record concurrently — the hammer test in
``tests/test_torch_obs.py`` holds this.

Global kill switch: ``REPRO_OBS_DISABLED=1`` in the environment makes every
mutator a no-op at import time (``set_enabled`` flips it at runtime, for
tests and A/B overhead runs).  Reads still work — they just see zeros — so
instrumented code never needs its own guard.

Histogram buckets are **fixed and log-spaced** (``log_buckets``): serving
latencies span ~5 decades, so linear buckets would waste resolution.
Buckets are upper bounds in the Prometheus ``le`` convention, cumulative
when rendered.
"""
from __future__ import annotations

import math
import os
import threading
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

# --------------------------------------------------------------- kill switch
_TRUTHY = ("1", "true", "yes", "on")


def _env_disabled(environ=None) -> bool:
    env = os.environ if environ is None else environ
    return str(env.get("REPRO_OBS_DISABLED", "")).strip().lower() in _TRUTHY


_enabled = not _env_disabled()


def enabled() -> bool:
    """Whether obs hooks record anything (``REPRO_OBS_DISABLED`` off)."""
    return _enabled


def set_enabled(flag: bool) -> bool:
    """Flip the global obs switch at runtime; returns the previous value."""
    global _enabled
    prev, _enabled = _enabled, bool(flag)
    return prev


# ------------------------------------------------------------------- buckets
def log_buckets(lo: float, hi: float, per_decade: int = 4) -> Tuple[float, ...]:
    """Fixed log-spaced histogram bucket upper bounds covering [lo, hi].

    ``per_decade`` bounds per factor of 10; endpoints included.  The +Inf
    overflow bucket is implicit (every histogram carries it).
    """
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    n = int(math.ceil(round(math.log10(hi / lo) * per_decade, 9)))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


#: Default latency buckets: 100µs … 100s, 8 per decade (49 bounds).  Wide
#: enough for a vmap member's share of a warm batch up to a cold mesh solve.
LATENCY_BUCKETS = log_buckets(1e-4, 100.0, per_decade=8)

#: Default count buckets (sweeps, batch sizes): 1 … 1024, 4 per decade.
COUNT_BUCKETS = log_buckets(1.0, 1024.0, per_decade=4)


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    items = [(k, v if type(v) is str else str(v))
             for k, v in labels.items()]
    if len(items) > 1:
        items.sort()
    return tuple(items)


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Base: one named family holding label-keyed series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: "OrderedDict[Tuple, object]" = OrderedDict()

    def labelsets(self):
        with self._lock:
            return list(self._series)

    def labels(self, **labels) -> "_Bound":
        """Bound single-series handle with the label key precomputed.

        The kwargs form (``c.inc(1, kind="vmap")``) rebuilds and sorts the
        label key on every call — fine for per-flush events, measurable for
        per-request ones.  Hot paths fetch a child once per label combo and
        record through it (the serving engine caches these per
        (kind, warm, ...) tuple)."""
        return _Bound(self, _label_key(labels))


class _Bound:
    """Pre-keyed series handle (see ``_Metric.labels``)."""

    __slots__ = ("_m", "_key")

    def __init__(self, metric: "_Metric", key: Tuple):
        self._m = metric
        self._key = key

    def inc(self, n: float = 1.0) -> None:
        if not _enabled:
            return
        self._m._inc_key(self._key, n)

    def set(self, v: float) -> None:
        if not _enabled:
            return
        self._m._set_key(self._key, v)

    def observe(self, v: float) -> None:
        if not _enabled:
            return
        self._m._observe_key(self._key, v)


class Counter(_Metric):
    """Monotonically increasing count (`*_total` families)."""

    kind = "counter"

    def _inc_key(self, key: Tuple, n: float) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def inc(self, n: float = 1.0, **labels) -> None:
        if not _enabled:
            return
        self._inc_key(_label_key(labels), n)

    def value(self, **labels) -> float:
        """Sum over every series whose labels contain ``labels``."""
        want = set(_label_key(labels))
        with self._lock:
            return sum(v for k, v in self._series.items()
                       if want <= set(k))


class Gauge(_Metric):
    """Last-written value (queue depths, resident entries)."""

    kind = "gauge"

    def _set_key(self, key: Tuple, v: float) -> None:
        with self._lock:
            self._series[key] = float(v)

    def _inc_key(self, key: Tuple, n: float) -> None:
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def set(self, v: float, **labels) -> None:
        if not _enabled:
            return
        self._set_key(_label_key(labels), v)

    def inc(self, n: float = 1.0, **labels) -> None:
        if not _enabled:
            return
        self._inc_key(_label_key(labels), n)

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class _HistSeries:
    __slots__ = ("counts", "overflow", "total", "sum")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.overflow = 0
        self.total = 0
        self.sum = 0.0


class Histogram(_Metric):
    """Fixed log-spaced-bucket histogram with sum/count per series."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets)) if buckets else LATENCY_BUCKETS

    def _observe_key(self, key: Tuple, v: float) -> None:
        v = float(v)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            # First bucket whose upper bound holds v (le semantics).
            lo, hi = 0, len(self.buckets)
            while lo < hi:
                mid = (lo + hi) // 2
                if v <= self.buckets[mid]:
                    hi = mid
                else:
                    lo = mid + 1
            if lo < len(self.buckets):
                s.counts[lo] += 1
            else:
                s.overflow += 1
            s.total += 1
            s.sum += v

    def observe(self, v: float, **labels) -> None:
        if not _enabled:
            return
        self._observe_key(_label_key(labels), v)

    def _merged(self, labels) -> _HistSeries:
        """Merge every series whose labels contain ``labels``."""
        want = set(_label_key(labels))
        out = _HistSeries(len(self.buckets))
        with self._lock:
            for k, s in self._series.items():
                if want <= set(k):
                    for i, c in enumerate(s.counts):
                        out.counts[i] += c
                    out.overflow += s.overflow
                    out.total += s.total
                    out.sum += s.sum
        return out

    def count(self, **labels) -> int:
        return self._merged(labels).total

    def sum(self, **labels) -> float:
        return self._merged(labels).sum

    def percentile(self, q: float, **labels) -> float:
        """Estimated q-th percentile (0..100) over matching series.

        Linear interpolation inside the containing bucket — resolution is
        one bucket width (~33% at 8 buckets/decade), which is what a
        fixed-bucket histogram can honestly give.  Returns NaN when empty;
        the top bound when the rank lands in the +Inf overflow bucket.
        """
        s = self._merged(labels)
        if s.total == 0:
            return math.nan
        rank = q / 100.0 * s.total
        seen = 0
        for i, c in enumerate(s.counts):
            if seen + c >= rank and c > 0:
                lo = self.buckets[i - 1] if i else 0.0
                frac = (rank - seen) / c
                return lo + frac * (self.buckets[i] - lo)
            seen += c
        return self.buckets[-1]


class MetricsRegistry:
    """Name → metric family.  ``counter``/``gauge``/``histogram`` get or
    create (idempotent — callers never coordinate registration order);
    re-registering a name as a different kind is a programming error and
    raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "OrderedDict[str, _Metric]" = OrderedDict()

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return list(self._metrics)

    def reset(self) -> None:
        """Zero every family's recorded series IN PLACE (benchmark/test
        isolation).  Registrations survive — components hold direct
        references to their families, so dropping the objects would detach
        them from the registry's snapshot."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                m._series.clear()

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """Plain-dict view of every family: JSON-serialisable, label sets
        flattened to ``"k=v,k2=v2"`` strings (``""`` = unlabelled)."""
        out: dict = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            entry: dict = {"type": m.kind, "help": m.help}
            with m._lock:
                if isinstance(m, Histogram):
                    entry["buckets"] = list(m.buckets)
                    entry["values"] = {
                        _label_str(k): {
                            "counts": list(s.counts) + [s.overflow],
                            "count": s.total,
                            "sum": s.sum,
                        }
                        for k, s in m._series.items()}
                else:
                    entry["values"] = {_label_str(k): v
                                       for k, v in m._series.items()}
            out[m.name] = entry
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                esc = m.help.replace("\\", r"\\").replace("\n", r"\n")
                lines.append(f"# HELP {m.name} {esc}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            with m._lock:
                series = list(m._series.items())
                if isinstance(m, Histogram):
                    for key, s in series:
                        base = [f'{k}="{_escape_label(v)}"' for k, v in key]
                        cum = 0
                        for le, c in zip(m.buckets, s.counts):
                            cum += c
                            lab = ",".join(base + [f'le="{_fmt(le)}"'])
                            lines.append(f"{m.name}_bucket{{{lab}}} {cum}")
                        lab = ",".join(base + ['le="+Inf"'])
                        lines.append(f"{m.name}_bucket{{{lab}}} {s.total}")
                        suffix = "{" + ",".join(base) + "}" if base else ""
                        lines.append(f"{m.name}_sum{suffix} {_fmt(s.sum)}")
                        lines.append(f"{m.name}_count{suffix} {s.total}")
                else:
                    for key, v in series:
                        lab = ",".join(f'{k}="{_escape_label(val)}"'
                                       for k, val in key)
                        suffix = "{" + lab + "}" if lab else ""
                        lines.append(f"{m.name}{suffix} {_fmt(v)}")
        return "\n".join(lines) + ("\n" if lines else "")


# ------------------------------------------------------------ global default
_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry: module-level hooks (kernel dispatch
    counters) and any component not handed an explicit registry record
    here, so one exporter sees the whole stack by default."""
    return _default
