"""Profiler hooks — a ``torch.profiler`` trace of the serving process.

Counterpart of ``repro.obs.profiling``, where ``jax.profiler`` sat:
``start_profiling(trace_dir)`` opens a ``torch.profiler`` trace (CPU
activity, plus CUDA activity where a card is present) that writes a
TensorBoard / Perfetto-loadable trace into ``trace_dir`` on stop.  It
records every thread (``profile_all_threads``, where the torch build has
it), so the spans the lanes and the dispatch thread open
(``obs.span``, which opens a ``record_function`` and an NVTX range of its
own while this trace records) show up named on the timeline.

Nothing starts under ``REPRO_OBS_DISABLED=1``.  ``torch`` is imported
inside the functions.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.obs import metrics as _metrics

_lock = threading.Lock()
_trace_dir: Optional[str] = None
_profiler = None


def profiling_active() -> bool:
    """True between ``start_profiling`` and ``stop_profiling``."""
    return _trace_dir is not None


def all_threads_config():
    """The profiler's ``_ExperimentalConfig`` that records every thread, or
    None where this torch build lacks ``profile_all_threads`` (there only
    the starting thread's ranges are recorded)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


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
        config = all_threads_config()
        prof = profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(trace_dir),
                       **({} if config is None
                          else {"experimental_config": config}))
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
