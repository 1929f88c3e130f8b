"""Fault-tolerance substrate: periodic and on-signal checkpoints, resume,
straggler detection.

The port of the JAX package's ``distributed/fault_tolerance.py``, the
host-side machinery (the data-plane pieces, restore and the resumable data
state, live in ``repro_torch.checkpoint`` and ``repro_torch.data``):

CheckpointManager   — periodic + on-signal saves, resume, keep-k.
StragglerMonitor    — per-step wall-time ring buffer; flags steps beyond
                      median + k·MAD over the window.
install_preemption_handler — SIGTERM → save at the next step.
"""
from __future__ import annotations

import collections
import signal
import time
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.checkpoint.checkpoint import (latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)


class CheckpointManager:
    def __init__(self, directory: str, *, interval_steps: int = 100,
                 keep: int = 3):
        self.directory = directory
        self.interval = interval_steps
        self.keep = keep
        self._preempted = False

    def should_save(self, step: int) -> bool:
        return self._preempted or (step > 0 and step % self.interval == 0)

    def save(self, step: int, tree: Any, extras: Optional[Dict] = None):
        return save_checkpoint(self.directory, step, tree, extras,
                               keep=self.keep)

    def restore_latest(self, template: Any, device=None):
        """(tree, extras, step) of the newest checkpoint, as fresh tensors
        on ``device`` (default ``"cuda"``)."""
        return restore_checkpoint(self.directory, template, device=device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def install_preemption_handler(self):
        def _handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, _handler)


class StragglerMonitor:
    """Step-time outlier detection (median + k·MAD over a sliding window,
    once it holds 8 steps)."""

    def __init__(self, window: int = 64, k: float = 5.0):
        self.times = collections.deque(maxlen=window)
        self.k = k
        self.flagged = 0
        self._t0: Optional[float] = None

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self) -> bool:
        """Returns True if this step is a straggler outlier."""
        dt = time.monotonic() - self._t0
        is_outlier = False
        if len(self.times) >= 8:
            med = float(np.median(self.times))
            mad = float(np.median(np.abs(np.array(self.times) - med))) + 1e-9
            if dt > med + self.k * mad:
                is_outlier = True
                self.flagged += 1
        self.times.append(dt)
        return is_outlier

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"median_s": 0.0, "flagged": 0}
        return {"median_s": float(np.median(self.times)),
                "flagged": self.flagged}
