"""The program's spans as the benchmark reads them: solver calls joined by
batch and the four span readers, on synthetic spans and in a traced run on
the CPU; and idle gaps named and covered by the program's spans, as
``tools/serve_idle_spans.py`` takes them."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from sbtest import run_tiny, spec, tiny_cell
from harness import spans as sp
from repro_torch import obs

TOOL = Path(__file__).resolve().parents[2] / "tools" / "serve_idle_spans.py"

NEW = ("admit_ms", "lane_wait_ms", "copy_ms", "pad_strip_ms")


def _span(name, t0, t1, sid, parent=None, depth=0, thread="lane", **tags):
    return obs.SpanRecord(name=name, t_start=t0, t_end=t1, tags=tags,
                          span_id=sid, parent_id=parent, depth=depth,
                          thread=thread)


def _batch(b, t, sid):
    """One fired batch of two solver calls, on the lane, from time ``t``;
    every span 1 s long except where the arithmetic needs otherwise."""
    out = [_span("dispatch.solve_batch", t, t + 20, sid, batch=b, size=3,
                 lane_wait_s=0.001 * (b + 1))]
    for c in range(2):
        base, i = t + 10 * c, sid + 1 + 10 * c
        out += [_span("engine.pad", base, base + 1, i, sid, 1, batch=b),
                _span("engine.solve", base + 1, base + 6, i + 1, sid, 1,
                      batch=b),
                _span("design.y_to_device", base + 1, base + 1.5, i + 2,
                      i + 1, 2, batch=b),
                _span("engine.call", base + 1.5, base + 5.5, i + 3, i + 1, 2,
                      batch=b),
                _span("engine.strip", base + 6, base + 9, i + 4, sid, 1,
                      batch=b),
                _span("engine.result_to_host", base + 6, base + 8, i + 5,
                      i + 4, 2, batch=b)]
    return out


def test_calls_are_joined_by_batch():
    held = _batch(0, 0.0, 100) + _batch(1, 30.0, 200)
    held += [_span("dispatch.admit", 29.0, 29.25, 300, thread="d",
                   request_id="r")]
    calls = sp.calls(held)
    assert len(calls) == 4
    assert sp.copy_s(held) == [2.5] * 4        # 0.5 in, 2 back
    assert sp.pad_strip_s(held) == [2.0] * 4   # 1 pad, 3 - 2 strip
    assert sp.admit_s(held) == [0.25]
    assert sp.lane_wait_s(held) == [0.001] * 3 + [0.002] * 3
    # A batch the ring cut (its first pad pushed out) is left out whole.
    cut = [s for s in held if s.span_id != 101]
    assert len(sp.calls(cut)) == 2
    # Spans without the batch tag (a program before it) join nothing.
    bare = [_span(s.name, s.t_start, s.t_end, s.span_id, s.parent_id)
            for s in held]
    assert sp.calls(bare) == [] and sp.copy_s(bare) == []


def _tool():
    loader = importlib.util.spec_from_file_location("serve_idle_spans", TOOL)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod


def test_gaps_named_and_covered_by_the_program():
    tool = _tool()
    ms = 1_000_000
    placed = [
        (_span("dispatch.solve_batch", 0, 0, 1), 0, 100 * ms),
        (_span("engine.strip", 0, 0, 2, 1, 1), 10 * ms, 40 * ms),
        (_span("engine.result_to_host", 0, 0, 3, 2, 2), 12 * ms, 38 * ms),
        (_span("dispatch.admit", 0, 0, 4, thread="d"), 50 * ms, 58 * ms),
        (_span("engine.call", 0, 0, 5, 1, 1), 60 * ms, 100 * ms)]
    # Inside the copy back: the innermost span over most of the gap.
    assert tool.program_label((15 * ms, 35 * ms), placed) == (
        "engine.result_to_host")
    # The copy covers under half of this one (26 of 56 ms), its parent
    # more (30): the parent names it.
    assert tool.program_label((2 * ms, 58 * ms), placed) == "engine.strip"
    # An admit on the dispatch thread, inside the lane's container.
    assert tool.program_label((50 * ms, 56 * ms), placed) == "dispatch.admit"
    assert tool.program_label((110 * ms, 130 * ms), placed) == tool.OUTSIDE
    # Idle 5-45 (40 ms) and 45-60 (15 ms): the strip covers 30, the admit
    # 8; engine.call and the container count as no host work.
    idle = [(5 * ms, 45 * ms), (45 * ms, 60 * ms), (70 * ms, 75 * ms)]
    assert tool.covered_ns(idle, [(10 * ms, 40 * ms), (50 * ms, 58 * ms)]) \
        == 38 * ms
    pct = tool.idle_in_program_pct(idle, placed)
    assert pct == pytest.approx(100 * 38 / 60)
    assert tool.idle_in_program_pct([], placed) is None
    # The gaps are the window's complement of the device's busy union.
    events = [("k", True, 10, 20), ("k", True, 15, 30), ("c", True, 50, 60),
              ("sb.window", False, 0, 100), ("host", False, 30, 50)]
    assert tool.idle_gaps(events, 0, 100) == [(0, 10), (30, 50), (60, 100)]


def test_readers_leave_out_what_they_cannot_read(monkeypatch):
    run = SimpleNamespace(trace=None, requests=[], t_close=1.0)
    for name in NEW:
        assert spec.metric_reader(name)(run) is None, name
    # A ring that pushed out spans of the window: the readers would see
    # only its tail, so they read nothing.
    ring = obs.Tracer(capacity=4)
    monkeypatch.setattr(obs, "get_tracer", lambda: ring)
    for i in range(2):
        with ring.span("dispatch.admit", request_id=f"before{i}"):
            pass
    sent = SimpleNamespace(t_submit=obs.now())
    run = SimpleNamespace(trace=None, requests=[sent], t_close=obs.now() + 9)
    for i in range(3):
        with ring.span("dispatch.admit", request_id=f"r{i}"):
            pass
    # Only a span of before the window went: the oldest held ended before
    # the first request was sent.
    assert ring.dropped == 1 and len(sp.window_spans(run)) == 3
    assert spec.metric_reader("admit_ms")(run) is not None
    with ring.span("dispatch.admit", request_id="r3"):
        pass
    assert ring.dropped == 2 and sp.window_spans(run) is None
    for name in NEW:
        assert spec.metric_reader(name)(run) is None, name


@pytest.mark.parametrize("reserve", [False, True])
def test_traced_run_reports_the_span_metrics(reserve):
    tracer = obs.get_tracer()
    tracer.clear()
    if reserve:
        tracer.reserve(1 << 16)
    # A CPU solve takes up to ~0.6 s: a window of a few holds whole calls
    # even on a loaded machine (the span readers read only whole ones).
    out = run_tiny(tiny_cell(), seed=2 ** 31 + 3, seconds=3.0, trace=True)
    assert out.result["correct"], out.checks
    got = out.result["metrics"]
    assert set(got) >= set(NEW), sorted(got)
    for name in NEW:
        assert got[name]["unit"] == "ms" and got[name]["value"] >= 0
    assert tracer.dropped == 0
