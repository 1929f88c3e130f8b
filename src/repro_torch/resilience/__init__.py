"""repro_torch.resilience — fault injection and the retry ladder.

Counterpart of ``repro.resilience``: every failure mode the serving stack
can hit — a lane worker thread dying, a solver raising or diverging — is
*injectable* (``faults``: a process-wide ``FaultPlan`` with named sites in
the serving paths, zero cost when disarmed), *observable*
(``serve_lane_restarts_total``, ``serve_lane_health``,
``solver_retries_total``) and *survivable* (supervised lane restarts with a
serial-fallback circuit breaker, and the engine's retry/degradation
ladder).  The store sites are registered for the design-store slice.

The consumers live where the failures live — ``repro_torch.serve.lanes``
and ``repro_torch.serve.engine``; this package holds the harness
(``faults``) and the ladder policy (``ladder``).
"""
from repro_torch.resilience.faults import (FaultInjected, FaultPlan,
                                           FaultRule, SITES, active, clear,
                                           hit, install, installed,
                                           maybe_delay, maybe_raise)
from repro_torch.resilience.ladder import backoff_s, next_rung, rungs

__all__ = [
    "FaultInjected",
    "FaultPlan",
    "FaultRule",
    "SITES",
    "active",
    "backoff_s",
    "clear",
    "hit",
    "install",
    "installed",
    "maybe_delay",
    "maybe_raise",
    "next_rung",
    "rungs",
]
