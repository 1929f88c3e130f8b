"""The retry/degradation ladder — capability-aware fallback spec chains.

Counterpart of ``repro.resilience.ladder``, walking the port's registry.

When a solve fails (raises) or diverges, the serving engine retries it
down a ladder of progressively cheaper/safer configurations instead of
erroring the request outright:

  1. **cold restart** — if the failed solve warm-started, the warm state is
     implicated first: retry the *same* rung with ``a0=None`` (a poisoned
     warm coefficient is the most common divergence cause);
  2. **precision** — a reduced-precision X stream (``bf16`` /
     ``bf16_fp32acc``) falls back to ``"fp32"`` on the same method;
  3. **method** — each registry entry names its own fallback
     (``MethodEntry.fallback``): the whole-solve kernels fall back to
     their plain torch family, the block-Jacobi family to the streaming
     path, and everything bottoms out at the direct ``"lstsq"`` baseline,
     which cannot diverge.

``next_rung`` yields one step of 2–3; the engine layers the cold restart,
jittered backoff (``backoff_s``) and the request-deadline bound on top
(``SolverServeEngine._attempt_solve``).
"""
from __future__ import annotations

import random
from typing import List, Optional

from repro_torch.core.spec import SolverSpec, solver_method


def next_rung(spec: SolverSpec) -> Optional[SolverSpec]:
    """The next (strictly cheaper/safer) spec down the ladder, or None.

    Precision degrades before method: a bf16 failure retries at fp32 on
    the same kernel first, so a numerically marginal solve is not punished
    with a slower method when full precision fixes it.
    """
    if spec.precision != "fp32":
        return spec.replace(precision="fp32")
    fb = solver_method(spec.method).fallback
    if fb is None or fb == spec.method:
        return None
    return spec.replace(method=fb)


def rungs(spec: SolverSpec) -> List[SolverSpec]:
    """The full ladder from ``spec`` (exclusive) to its floor, in order."""
    out: List[SolverSpec] = []
    cur = next_rung(spec)
    while cur is not None:
        out.append(cur)
        cur = next_rung(cur)
    return out


def backoff_s(attempt: int, base: float, cap: float = 0.05) -> float:
    """Jittered exponential backoff before retry ``attempt`` (0-based).

    ``base * 2**attempt``, capped, with ±50% uniform jitter so a burst of
    co-failing requests doesn't retry in lockstep.
    """
    if base <= 0:
        return 0.0
    delay = min(cap, base * (2 ** attempt))
    return delay * (0.5 + random.random())
