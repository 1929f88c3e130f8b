"""Kernel-path relay: which execution route a solve actually took.

The port's own minimal counterpart of ``repro.obs.trace.record_dispatch`` /
``consume_dispatch``.  The eager dispatch shims (``kernels/ops.py``,
``core/methods.py``) call ``record_dispatch`` once per solve; it bumps two
plain counters and parks the path in a thread-local slot that a caller pops
with ``consume_dispatch``.  The JAX package's Prometheus registry, spans and
``SolveTelemetry`` arrive with the serving slice; nothing here needs them.

Counters:
  * ``dispatch_counts()`` — ``{(path, method): n}``, every recorded solve.
  * ``fallback_counts()`` — ``{(method, reason): n}``, solves re-routed off
    their requested path (``reason`` non-empty: ``"vmem"`` for over the
    on-chip budget, ``"max_iter"`` for a zero sweep budget).
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, Optional, Tuple

_lock = threading.Lock()
_dispatch: Counter = Counter()
_fallback: Counter = Counter()
_local = threading.local()


def record_dispatch(path: str, method: str = "", reason: str = "") -> None:
    """Note the kernel path a solve ran (``fused`` / ``persweep`` / ``xla``)."""
    method = method or "unknown"
    with _lock:
        _dispatch[(path, method)] += 1
        if reason:
            _fallback[(method, reason)] += 1
    _local.last = path


def consume_dispatch(default: Optional[str] = None) -> Optional[str]:
    """Pop the kernel path recorded by the last solve on this thread."""
    path = getattr(_local, "last", None)
    _local.last = None
    return path if path is not None else default


def dispatch_counts() -> Dict[Tuple[str, str], int]:
    with _lock:
        return dict(_dispatch)


def fallback_counts() -> Dict[Tuple[str, str], int]:
    with _lock:
        return dict(_fallback)


def reset_counters() -> None:
    with _lock:
        _dispatch.clear()
        _fallback.clear()
