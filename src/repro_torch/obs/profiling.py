"""Profiler hooks — named regions in ``torch.profiler`` traces.

Counterpart of ``repro.obs.profiling``, where ``jax.profiler`` sat:
``start_profiling(trace_dir)`` opens a ``torch.profiler`` trace (CPU
activity, plus CUDA activity where a card is present) that writes a
TensorBoard / Perfetto-loadable trace into ``trace_dir`` on stop, and
``profile_region(name)`` names a region on it with
``torch.profiler.record_function`` and, on a card, an NVTX range
(``torch.cuda.nvtx.range``), so engine flushes and solver calls show up
named on the timeline.

Inert when idle: ``profile_region`` is a bare ``yield`` unless a trace was
started (or ``force=True``), and nothing at all under
``REPRO_OBS_DISABLED=1``.  Without a card the NVTX half is skipped, so on
the CPU a forced region only names the profiler's CPU events.  ``torch``
is imported inside the functions.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

from repro_torch.obs import metrics as _metrics

_lock = threading.Lock()
_trace_dir: Optional[str] = None
_profiler = None


def profiling_active() -> bool:
    """True between ``start_profiling`` and ``stop_profiling``."""
    return _trace_dir is not None


def start_profiling(trace_dir: str) -> bool:
    """Start a ``torch.profiler`` trace into ``trace_dir``.  Returns False
    (and stays inert) when obs is disabled; raises on a second concurrent
    trace so misuse is not silent."""
    global _trace_dir, _profiler
    if not _metrics.enabled():
        return False
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    with _lock:
        if _trace_dir is not None:
            raise RuntimeError(
                f"profiling already active (writing {_trace_dir!r})")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(trace_dir))
        prof.start()
        _profiler, _trace_dir = prof, trace_dir
    return True


def stop_profiling() -> Optional[str]:
    """Stop the active trace (writing it out); returns its directory (None
    if idle)."""
    global _trace_dir, _profiler
    with _lock:
        if _trace_dir is None:
            return None
        _profiler.stop()
        out, _trace_dir, _profiler = _trace_dir, None, None
    return out


@contextmanager
def profile_region(name: str, force: bool = False):
    """Name a region on the trace timeline (see module doc)."""
    if not _metrics.enabled() or (_trace_dir is None and not force):
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
