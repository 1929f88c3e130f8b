#!/usr/bin/env python3
"""Where a benchmark cell's device idle time goes, by the program's spans.

    python3 tools/serve_idle_spans.py --workload tall.shared --seed 7 \
        --seconds 51 [--out idle_spans.json]

Runs one cell of ``solverbench`` as its ``--trace 1`` run does (the
harness's ``torch.profiler`` over the window), with the program's span
ring given room for the whole run (``Tracer.reserve``), keeps the trace's
events and the run's record, and prints one JSON line with:

  * ``result``: the run's result line (its per-layer metrics, the span
    readers included) and ``end_to_end``, the end-to-end metrics of this
    traced run;
  * ``dropped`` (``Tracer.dropped``) and the fired batches by
    ``fire_reason``;
  * ``gaps``: the ten longest idle gaps of the device, each named as the
    harness names it (its ``breakdown``) plus the innermost program span
    covering more than half of it, on any thread, or ``outside the
    program's spans``;
  * ``idle_in_program_pct``: the share of the device's idle time that the
    host-work spans (``HOST_WORK``) cover;
  * ``cycles``: per batch cycle (one ``dispatch.solve_batch`` start to the
    next), the median device idle, host-work span sum and union, and the
    idle the host-work spans cover, in ms;
  * ``self_ms``: each span name's own time summed over the window;
  * ``window``: the span readers' quantities over every call of the
    window, to hold the benchmark's own readings against.

Spans are placed on the profiler's clock through the tracer's anchor and a
second anchor read after the run (linear between the two; ``drift_us`` is
how far the two clocks moved apart over the run).  Needs a CUDA card.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import Counter, defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Spans the program's ring holds here: every span of a 51 s window.
RING = 1 << 18
sys.path.insert(0, str(ROOT / "solverbench"))
sys.path.insert(1, str(ROOT / "src"))


def _med(values):
    return statistics.median(values) if values else None


#: Spans of host work the device may wait for (containers, the solver
#: call and the stream wait left out).
HOST_WORK = ("dispatch.admit", "engine.fingerprint", "engine.group",
             "engine.design", "engine.pad", "design.y_to_device",
             "engine.strip", "dispatch.complete")
OUTSIDE = "outside the program's spans"


def program_label(gap, placed) -> str:
    """The innermost placed ``(span, start, end)`` covering more than half
    of ``gap``: of those, the shortest (on one thread a child is never
    longer than its parent; across threads the most specific step wins)."""
    g0, g1 = gap
    best = None
    for s, a, b in placed:
        if 2 * (min(b, g1) - max(a, g0)) > g1 - g0:
            key = (b - a, -s.depth)
            if best is None or key < best[0]:
                best = (key, s.name)
    return best[1] if best is not None else OUTSIDE


def covered_ns(idle, by) -> int:
    """How much of the ``idle`` intervals the union of ``by`` covers."""
    from harness.devtrace import union

    cover, iv, j = 0, union(by), 0
    for g0, g1 in sorted(idle):
        while j < len(iv) and iv[j][1] <= g0:
            j += 1
        k = j
        while k < len(iv) and iv[k][0] < g1:
            cover += min(iv[k][1], g1) - max(iv[k][0], g0)
            k += 1
    return cover


def idle_in_program_pct(idle, placed):
    """Of the ``idle`` intervals, the share the host-work spans cover."""
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    work = [(a, b) for s, a, b in placed if s.name in HOST_WORK]
    return 100.0 * covered_ns(idle, work) / total


def idle_gaps(events, w0, w1):
    """The device's idle intervals inside the window ``[w0, w1]``: the
    complement of the union of its operations, as ``devtrace.read`` takes
    its busy time."""
    from harness.devtrace import union

    gaps, prev = [], w0
    for s, e in union([(max(s, w0), min(e, w1)) for _, dev, s, e in events
                       if dev and min(e, w1) > max(s, w0)]):
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if w1 > prev:
        gaps.append((prev, w1))
    return gaps


def analyse(events, spans, anchors, requests_window, result):
    """The breakdown (see the module doc) from the trace's ``events``
    ``(name, is_device, start_ns, end_ns)``, the program's ``spans`` and
    the harness's own ``result`` line of the same traced run."""
    from harness import devtrace
    from harness import spans as sp
    from harness.devtrace import union

    (p0, u0), (p1, u1) = anchors
    rate = (u1 - u0) / (p1 - p0) if p1 != p0 else 1.0

    def unix(t):
        return u0 + round((t * 1e9 - p0) * rate)

    w0, w1 = next((s, e) for n, dev, s, e in events
                  if n == devtrace.WINDOW and not dev)
    gaps = idle_gaps(events, w0, w1)
    idle_ns = sum(e - s for s, e in gaps)
    harness_idle = (result["device"]["window_s"]
                    - result["device"]["busy_s"]) * 1e9
    if abs(idle_ns - harness_idle) > 1e6:
        raise RuntimeError(
            f"idle {idle_ns / 1e9} s here against the harness's "
            f"{harness_idle / 1e9} s: devtrace.read takes its busy time "
            f"otherwise now; update idle_gaps")
    placed = [(s, unix(s.t_start), unix(s.t_end)) for s in spans
              if unix(s.t_start) < w1 and unix(s.t_end) > w0]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:devtrace.TOP]
    named = [[f"{label} / {program_label(g, placed)}", secs]
             for g, (label, secs) in zip(longest,
                                         result["breakdown"]["idle_gaps"])]

    starts = sorted(a for s, a, _ in placed
                    if s.name == "dispatch.solve_batch")
    work = [(a, b) for s, a, b in placed if s.name in HOST_WORK]
    cyc = defaultdict(list)
    for c0, c1 in zip(starts, starts[1:]):
        idle_c = [(max(s, c0), min(e, c1)) for s, e in gaps
                  if s < c1 and e > c0]
        work_c = [(max(a, c0), min(b, c1)) for a, b in work
                  if a < c1 and b > c0]
        cyc["idle_ms"].append(sum(e - s for s, e in idle_c) / 1e6)
        cyc["work_sum_ms"].append(sum(b - a for a, b in work_c) / 1e6)
        cyc["work_union_ms"].append(
            sum(e - s for s, e in union(work_c)) / 1e6)
        cyc["work_in_idle_ms"].append(covered_ns(idle_c, work_c) / 1e6)
        cyc["cycle_ms"].append((c1 - c0) / 1e6)
    from repro_torch import obs

    inside = [s for s, a, b in placed]
    own = obs.self_seconds(inside)
    self_ms = Counter()
    for s in inside:
        self_ms[s.name] += own[s.span_id] * 1e3
    reasons = Counter(s.tags.get("fire_reason") for s in inside
                      if s.name == "dispatch.solve_batch")
    req = [s for s in spans if requests_window[0] <= s.t_start
           <= requests_window[1] and s.t_end is not None]
    window = {name: sp.median_ms(fn(req))
              for name, fn in (("admit_ms", sp.admit_s),
                               ("lane_wait_ms", sp.lane_wait_s),
                               ("copy_ms", sp.copy_s),
                               ("pad_strip_ms", sp.pad_strip_s))}
    window["calls"] = len(sp.calls(req))
    window["admits"] = len(sp.admit_s(req))
    return {
        "window_s": (w1 - w0) / 1e9,
        "idle_s": idle_ns / 1e9,
        "idle_in_program_pct": idle_in_program_pct(gaps, placed),
        "gaps": named,
        "fire_reasons": dict(reasons),
        "cycles": {k: _med(v) for k, v in cyc.items()} | {
            "n": len(cyc["idle_ms"])},
        "self_ms": dict(sorted(self_ms.items(), key=lambda kv: -kv[1])),
        "window": window,
        "drift_us": ((u1 - u0) - (p1 - p0)) / 1e3,
    }


def traced_run(cell, *, seed: int, seconds: float, device: str):
    """One traced run of ``cell``: (the harness's outcome, the row)."""
    from harness import cell as hcell
    from harness import devtrace, spec
    from repro_torch import obs
    from repro_torch.obs.trace import clock_anchor

    tracer = obs.get_tracer()
    tracer.reserve(RING)
    tracer.clear()
    kept, records = {}, []
    read = devtrace.read

    def keep_events(prof):
        kept["events"] = devtrace._events(prof)
        return read(prof)

    @dataclasses.dataclass
    class Kept(hcell.RunRecord):
        def __post_init__(self):
            records.append(self)

    devtrace.read, hcell.RunRecord = keep_events, Kept
    try:
        out = hcell.run_cell(cell, seed=seed, seconds=seconds, trace=True,
                             device=device, t_start=T_START)
    finally:
        devtrace.read, hcell.RunRecord = read, Kept.__base__
    if len(records) != 1 or "events" not in kept:
        raise RuntimeError(
            "run_cell no longer builds one RunRecord and reads its trace "
            "through devtrace.read; update traced_run")
    anchors = (tracer.anchor, clock_anchor())
    run = records[0]
    e2e = {m.name: spec.metric_reader(m.name)(run) for m in cell.end_to_end}
    t0 = min(r.t_submit for r in run.requests)
    row = {"workload": cell.name, "seed": seed,
           "card": out.result["device"]["kind"], "result": out.result,
           "end_to_end": e2e, "dropped": tracer.dropped,
           "spans_held": len(tracer.spans()),
           **analyse(kept["events"], tracer.spans(), anchors,
                     (t0, run.t_close), out.result)}
    return out, row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from harness import spec

    out, row = traced_run(spec.resolve_cell(args.workload), seed=args.seed,
                          seconds=args.seconds, device="cuda:0")
    for line in out.info:
        print(line, flush=True)
    print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(row, indent=1))
    return 0 if out.result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
