"""The program's own spans: what its host steps took.

The program (``repro_torch.obs``) records each host step of serving as a
span, on its serving clock (``time.perf_counter``, the harness's clock
too), into a ring buffer in the process.  The per-layer readers run in the
same process after the window and read the spans that started inside it.
They read nothing where the ring no longer reaches back to the window's
first request (it pushed out spans, ``Tracer.dropped``, and the oldest it
holds ended after that request was sent): a median of the window's tail
is not one of the window.  A program whose spans carry no ids and no
``batch`` tag gives them nothing to read either.

A solver call is one ``engine.pad``, ``engine.solve`` and ``engine.strip``
of one fired batch (the ``batch`` tag), in that order on the lane's
thread; the copy of its right-hand sides to the device
(``design.y_to_device``) runs inside its ``engine.solve``, the copy of its
coefficients and residuals back (``engine.result_to_host``) inside its
``engine.strip``.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


def window_spans(run) -> Optional[list]:
    """The program's completed spans that started inside ``run``'s window
    (first submit to close); None where the program keeps no span ids, no
    request was sent, or the ring lost spans of the window."""
    t_close = getattr(run, "t_close", None)
    sent = [r.t_submit for r in getattr(run, "requests", [])]
    if t_close is None or not sent:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    tracer = obs.get_tracer()
    held = tracer.spans()
    if not held or not hasattr(held[0], "span_id"):
        return None
    t0 = min(sent)
    if getattr(tracer, "dropped", 0) and held[0].t_end >= t0:
        return None     # spans that ended after t0 were pushed out
    return [s for s in held
            if s.t_end is not None and t0 <= s.t_start <= t_close]


def median_ms(samples: Sequence[float]) -> Optional[float]:
    return statistics.median(samples) * 1e3 if samples else None


def admit_s(spans) -> List[float]:
    """One ``dispatch.admit`` a request."""
    return [s.duration_s for s in spans if s.name == "dispatch.admit"]


def lane_wait_s(spans) -> List[float]:
    """Fire → the lane began the batch, once for each request of it."""
    out = []
    for s in spans:
        wait = s.tags.get("lane_wait_s")
        if s.name == "dispatch.solve_batch" and wait is not None:
            out += [float(wait)] * int(s.tags.get("size", 1))
    return out


def calls(spans) -> List[dict]:
    """The solver calls of fully held batches: ``pad``, ``solve``,
    ``strip`` and their copy children ``to_device`` / ``to_host``."""
    by_batch: Dict[tuple, Dict[str, list]] = defaultdict(
        lambda: defaultdict(list))
    children: Dict[int, list] = defaultdict(list)
    for s in spans:
        if s.parent_id is not None:
            children[s.parent_id].append(s)
        b = s.tags.get("batch")
        if b is not None and s.name in ("engine.pad", "engine.solve",
                                        "engine.strip"):
            by_batch[(b, s.thread)][s.name].append(s)
    out = []
    for parts in by_batch.values():
        pads, solves, strips = (sorted(parts[n], key=lambda s: s.t_start)
                                for n in ("engine.pad", "engine.solve",
                                          "engine.strip"))
        if not (len(pads) == len(solves) == len(strips)):
            continue        # a batch cut by the window or the ring
        for pad, solve, strip in zip(pads, solves, strips):
            out.append({
                "pad": pad, "solve": solve, "strip": strip,
                "to_device": [c for c in children[solve.span_id]
                              if c.name == "design.y_to_device"],
                "to_host": [c for c in children[strip.span_id]
                            if c.name == "engine.result_to_host"]})
    return out


def copy_s(spans) -> List[float]:
    """Per solver call: its copies to the device and back."""
    return [sum(c.duration_s for c in call["to_device"] + call["to_host"])
            for call in calls(spans) if call["to_device"] and call["to_host"]]


def pad_strip_s(spans) -> List[float]:
    """Per solver call: the padding of its right-hand sides and the strip
    of its answers, the copy back to the host left out."""
    return [call["pad"].duration_s + call["strip"].duration_s
            - sum(c.duration_s for c in call["to_host"])
            for call in calls(spans) if call["to_host"]]
