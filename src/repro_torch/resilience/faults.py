"""Fault-injection harness for the serving stack's chaos tests.

The port's own copy of ``repro.resilience.faults`` (pure Python, the same
sites and semantics).  A ``FaultPlan`` is a process-wide set of rules, each bound to a named
**injection site** compiled into the production code paths:

  ===================== ====================================================
  site                  where it fires
  ===================== ====================================================
  ``lane.worker``       ``LaneExecutor._loop`` — raises *outside* the
                        per-work try, simulating worker-thread death (the
                        supervisor must fail only the in-flight unit and
                        restart the thread).
  ``lane.delay``        same spot, but sleeps ``delay_s`` instead of
                        raising — slow-device / deadline-storm simulation.
  ``solver.raise``      ``SolverServeEngine`` solve body — the solver call
                        raises before running (retry-ladder input).
  ``solver.diverge``    after a solve returns — the engine treats the
                        result as diverged (cold-retry / ladder input,
                        warm-coefficient retention must be skipped).
  ``store.tile_corrupt`` the tiered design store's tile verification
                        (registered; no hook until the store is ported).
  ``store.read_delay``  the design store's disk reads (registered; no hook
                        until the store is ported).
  ===================== ====================================================

The harness is **zero-cost when disarmed**: every hook starts with a
module-global ``None`` check, so production behaviour (and results) with no
plan installed is bit-identical to a build without the hooks.  Plans are
activated through ``ServeConfig.fault_plan`` (the engine installs at
construction) or ``repro_torch.launch.solver_serve --fault-plan`` (JSON
text or a path to a JSON file), so chaos runs exercise the real serving
path.

JSON shape — a mapping of site name to rule knobs::

    {"lane.worker": {"count": 2},
     "solver.raise": {"count": 1, "skip": 3, "match": "bakp"},
     "store.read_delay": {"count": 0, "delay_s": 0.005}}

``count`` bounds how many times the rule arms (``0`` = unlimited);
``skip`` lets the first N matching hits through unarmed; ``match`` is a
substring filter on the hook's tag (lane label, method name, design key).

Thread-safety: rule counters mutate under the plan's lock; hooks are
called from lane threads and solver bodies concurrently.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Union

#: The sites compiled into the serving stack (see module doc).
SITES = ("lane.worker", "lane.delay", "solver.raise", "solver.diverge",
         "store.tile_corrupt", "store.read_delay")


class FaultInjected(RuntimeError):
    """An injected fault (never raised unless a ``FaultPlan`` is armed)."""

    def __init__(self, site: str, tag: str = ""):
        self.site = site
        self.tag = tag
        super().__init__(f"injected fault at {site!r}"
                         + (f" (tag={tag!r})" if tag else ""))


@dataclass
class FaultRule:
    """One armed rule at one site.

    ``count`` bounds arming (0 = unlimited); ``skip`` passes the first N
    matching hits through unarmed; ``match`` substring-filters the hook
    tag; ``delay_s`` is the sleep the latency sites inject.
    ``seen``/``fired`` are live counters (plan-lock guarded).
    """

    site: str
    count: int = 1
    skip: int = 0
    delay_s: float = 0.0
    match: str = ""
    seen: int = 0
    fired: int = 0

    def _arm(self, tag: str) -> bool:
        """Decide (and record) whether this hit arms.  Plan-lock held."""
        if self.match and self.match not in tag:
            return False
        self.seen += 1
        if self.seen <= self.skip:
            return False
        if self.count > 0 and self.fired >= self.count:
            return False
        self.fired += 1
        return True


class FaultPlan:
    """A set of ``FaultRule``s, keyed by injection site."""

    def __init__(self, rules: Optional[Dict[str, dict]] = None):
        self._lock = threading.Lock()
        self.rules: Dict[str, FaultRule] = {}
        for site, knobs in (rules or {}).items():
            self.add(site, **(knobs or {}))

    def add(self, site: str, **knobs) -> FaultRule:
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; sites: {SITES}")
        rule = FaultRule(site=site, **knobs)
        with self._lock:
            self.rules[site] = rule
        return rule

    def hit(self, site: str, tag: str = "") -> Optional[FaultRule]:
        """The armed rule for this hit, or None (counts the hit)."""
        with self._lock:
            rule = self.rules.get(site)
            if rule is None or not rule._arm(tag):
                return None
            return rule

    def counts(self) -> Dict[str, dict]:
        """Per-site ``{seen, fired}`` counters (chaos-run reporting)."""
        with self._lock:
            return {s: {"seen": r.seen, "fired": r.fired}
                    for s, r in self.rules.items()}

    # ---------------------------------------------------------- coercion
    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        """Parse the ``--fault-plan`` JSON mapping (see module doc)."""
        data = json.loads(text)
        if not isinstance(data, dict):
            raise ValueError(
                f"fault plan must be a JSON object of site -> rule knobs, "
                f"got {type(data).__name__}")
        return cls(data)

    @classmethod
    def coerce(cls, obj: Union["FaultPlan", dict, str]) -> "FaultPlan":
        """Accept a ``FaultPlan``, a rules dict, inline JSON text, or a
        path to a JSON file (the ``ServeConfig.fault_plan`` contract)."""
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls(obj)
        if isinstance(obj, str):
            if os.path.exists(obj):
                with open(obj) as f:
                    return cls.from_json(f.read())
            return cls.from_json(obj)
        raise TypeError(
            f"fault_plan must be a FaultPlan, dict or JSON str, "
            f"got {type(obj).__name__}")


# Process-wide armed plan.  ``None`` (the default) short-circuits every
# hook before any work happens — the bit-identical-when-unset guarantee.
_PLAN: Optional[FaultPlan] = None


def install(plan: Union[FaultPlan, dict, str, None]) -> Optional[FaultPlan]:
    """Arm a plan process-wide (None disarms).  Returns the armed plan."""
    global _PLAN
    _PLAN = None if plan is None else FaultPlan.coerce(plan)
    return _PLAN


def clear() -> None:
    """Disarm fault injection (restores bit-identical production paths)."""
    install(None)


def active() -> Optional[FaultPlan]:
    return _PLAN


class installed:
    """Context manager arming ``plan`` for the block (tests/benchmarks)."""

    def __init__(self, plan: Union[FaultPlan, dict, str]):
        self.plan = FaultPlan.coerce(plan)

    def __enter__(self) -> FaultPlan:
        install(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        clear()


# ------------------------------------------------------------------ hooks
def hit(site: str, tag: str = "") -> Optional[FaultRule]:
    """The armed rule for this hit, or None.  The one-load ``_PLAN is
    None`` fast path is the entire disarmed cost."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.hit(site, tag)


def maybe_raise(site: str, tag: str = "") -> None:
    """Raise ``FaultInjected`` when the site's rule arms (no-op unarmed)."""
    rule = hit(site, tag)
    if rule is not None:
        if rule.delay_s > 0:
            time.sleep(rule.delay_s)
        raise FaultInjected(site, tag)


def maybe_delay(site: str, tag: str = "") -> bool:
    """Sleep ``delay_s`` when the site's rule arms; True if it did."""
    rule = hit(site, tag)
    if rule is None:
        return False
    if rule.delay_s > 0:
        time.sleep(rule.delay_s)
    return True
