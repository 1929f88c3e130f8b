"""repro_torch.obs against repro.obs: metrics registry, exporters, tracing,
the kernel-path relay, profiler regions and the engine's telemetry.

Mirrors ``tests/test_obs.py``.  The metric primitives are held to the JAX
package's by running the same operations on both registries and comparing
``snapshot()`` and ``render_prometheus()`` exactly; the engine and
dispatcher telemetry run the port's engine with ``device="cpu"``, the
dispatcher's families held to those JAX's dispatcher records for the same
requests.  The concurrency hammer drives ``engine.serve`` from several
threads (lane threads record concurrently) and, as the JAX test does,
the dispatcher from several submitters.
"""
import json
import math
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.obs as jobs
import repro.serve as J
from conftest import make_system
from repro_torch import obs
from repro_torch.obs.metrics import _env_disabled
from repro_torch.serve import (AsyncDispatcher, DispatchConfig, ServeConfig,
                               SolveRequest, SolverServeEngine)


@pytest.fixture(autouse=True)
def _obs_enabled():
    """Every test starts (and leaves) with obs on, whatever it flips."""
    prev = obs.set_enabled(True)
    yield
    obs.set_enabled(prev)


def _req(x, y, **kw):
    kw.setdefault("method", "bakp")
    kw.setdefault("max_iter", 15)
    return SolveRequest(x=x, y=y, **kw)


def _engine(**kw):
    return SolverServeEngine(ServeConfig(**kw),
                             registry=obs.MetricsRegistry(), device="cpu")


# ----------------------------------------------------------------- buckets
class TestBuckets:
    def test_log_buckets_span_and_spacing(self):
        b = obs.log_buckets(1e-3, 1.0, per_decade=4)
        assert b[0] == pytest.approx(1e-3)
        assert b[-1] == pytest.approx(1.0)
        assert len(b) == 13
        ratios = [b[i + 1] / b[i] for i in range(len(b) - 1)]
        assert all(r == pytest.approx(10 ** 0.25) for r in ratios)
        assert b == jobs.log_buckets(1e-3, 1.0, per_decade=4)

    def test_log_buckets_validation(self):
        with pytest.raises(ValueError):
            obs.log_buckets(0.0, 1.0)
        with pytest.raises(ValueError):
            obs.log_buckets(2.0, 1.0)

    def test_default_buckets_match_reference(self):
        assert obs.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS
        assert obs.COUNT_BUCKETS == jobs.COUNT_BUCKETS


# ----------------------------------------------------------------- metrics
def _record(mod):
    """The same operations on a fresh registry of ``mod`` (either obs)."""
    reg = mod.MetricsRegistry()
    c = reg.counter("solve_total", "solves by kind")
    c.inc(3, kind="multi_rhs")
    c.inc(1, kind='we"ird\\label')
    c.labels(kind="vmap").inc(2)
    reg.gauge("inflight", "in flight").set(2)
    reg.gauge("inflight").inc(1.5, lane="single:xla")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 5.0):
        h.observe(v, path="xla")
    h.labels(path="fused").observe(0.2)
    return reg


class TestMetrics:
    def test_snapshot_and_text_match_reference(self):
        t, j = _record(obs), _record(jobs)
        assert t.snapshot() == j.snapshot()
        assert t.render_prometheus() == j.render_prometheus()

    def test_counter_labels_and_subset_sum(self):
        reg = obs.MetricsRegistry()
        c = reg.counter("reqs_total", "help text")
        c.inc(2, kind="a", path="x")
        c.inc(3, kind="b", path="x")
        c.inc(1, kind="a", path="y")
        assert c.value() == 6
        assert c.value(kind="a") == 3
        assert c.value(path="x") == 5
        assert c.value(kind="b", path="y") == 0

    def test_counter_rejects_decrease(self):
        with pytest.raises(ValueError):
            obs.MetricsRegistry().counter("c").inc(-1)

    def test_gauge_set_inc_dec(self):
        g = obs.MetricsRegistry().gauge("depth")
        g.set(5)
        g.inc(2)
        g.dec()
        assert g.value() == 6.0
        g.set(1, queue="q")
        assert g.value(queue="q") == 1.0

    def test_histogram_percentile_and_merge(self):
        h = obs.MetricsRegistry().histogram(
            "lat", buckets=obs.log_buckets(1e-3, 10.0, per_decade=8))
        vals = np.exp(np.random.default_rng(7).normal(-2.0, 0.5, size=4000))
        for i, v in enumerate(vals):
            h.observe(float(v), path="a" if i % 2 else "b")
        assert h.count() == 4000
        assert h.count(path="a") == 2000
        assert h.sum() == pytest.approx(float(vals.sum()), rel=1e-6)
        for q in (50, 95):
            est, true = h.percentile(q), float(np.percentile(vals, q))
            assert abs(est - true) / true < 0.35, (q, est, true)
        assert math.isnan(h.percentile(50, path="missing"))

    def test_histogram_overflow_bucket(self):
        h = obs.MetricsRegistry().histogram("o", buckets=(1.0, 10.0))
        h.observe(0.5)
        h.observe(1e9)
        assert h.count() == 2
        assert h.percentile(99) == 10.0

    def test_registry_get_or_create_and_kind_clash(self):
        reg = obs.MetricsRegistry()
        assert reg.counter("x") is reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")
        assert "x" in reg.names()
        assert reg.get("nope") is None

    def test_reset_keeps_held_references_live(self):
        reg = obs.MetricsRegistry()
        c = reg.counter("kept")
        c.inc(5)
        reg.reset()
        assert c.value() == 0
        c.inc(2)
        assert reg.get("kept").value() == 2

    def test_snapshot_shape(self):
        reg = obs.MetricsRegistry()
        reg.counter("c", "ch").inc(2, kind="a")
        reg.gauge("g").set(1.5)
        h = reg.histogram("h", buckets=(1.0, 2.0))
        h.observe(1.5)
        h.observe(99.0)
        snap = reg.snapshot()
        assert snap["c"] == {"type": "counter", "help": "ch",
                             "values": {"kind=a": 2.0}}
        assert snap["g"]["values"][""] == 1.5
        hv = snap["h"]["values"][""]
        assert hv["counts"] == [0, 1, 1]
        assert hv["count"] == 2
        assert hv["sum"] == pytest.approx(100.5)
        json.dumps(snap)


# -------------------------------------------------------------- prometheus
_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*")*\})?'
    r' (?:[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|\+Inf|-Inf|NaN)$')


class TestPrometheus:
    def test_every_line_parses(self):
        text = _record(obs).render_prometheus()
        assert text.endswith("\n")
        for line in text.strip().split("\n"):
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                continue
            assert _SAMPLE.match(line), f"bad exposition line: {line!r}"

    def test_histogram_cumulative_and_escaping(self):
        text = _record(obs).render_prometheus()
        buckets = re.findall(r'lat_seconds_bucket\{path="xla",le="([^"]+)"\} '
                             r'(\d+)', text)
        assert [b[0] for b in buckets] == ["0.01", "0.1", "1", "+Inf"]
        assert [int(b[1]) for b in buckets] == [1, 3, 3, 4]
        assert 'lat_seconds_count{path="xla"} 4' in text
        assert "# TYPE lat_seconds histogram" in text
        assert "# TYPE solve_total counter" in text
        assert r'kind="we\"ird\\label"' in text


# ----------------------------------------------------------------- tracing
class TestTracing:
    def test_span_nesting_and_tags(self):
        tr = obs.Tracer(capacity=16)
        with tr.span("outer", bucket="64x8"):
            with tr.span("inner", step=1):
                with tr.span("leaf"):
                    pass
            with tr.span("sibling"):
                pass
        spans = {s.name: s for s in tr.spans()}
        ids = [s.span_id for s in spans.values()]
        assert len(set(ids)) == 4 and all(i > 0 for i in ids)
        assert spans["inner"].parent_id == spans["outer"].span_id
        assert spans["leaf"].parent_id == spans["inner"].span_id
        assert spans["sibling"].parent_id == spans["outer"].span_id
        assert [spans[n].depth for n in ("outer", "inner", "leaf")] == [
            0, 1, 2]
        assert spans["outer"].parent_id is None
        assert spans["outer"].tags == {"bucket": "64x8"}
        assert spans["outer"].duration_s >= spans["inner"].duration_s >= 0

    def test_link_tags_inherited_within_a_thread(self):
        tr = obs.Tracer(capacity=16)
        seen = {}

        def other():
            with tr.span("other") as sp:
                seen["other"] = sp

        with tr.span("batch", batch=7, size=2):
            with tr.span("req", request_id="r1"):
                with tr.span("copy", bytes=8):
                    pass
            with tr.span("own", batch=8):
                pass
            t = threading.Thread(target=other)
            t.start()
            t.join()
        spans = {s.name: s for s in tr.spans()}
        assert spans["copy"].tags == {"bytes": 8, "batch": 7,
                                      "request_id": "r1"}
        assert spans["req"].tags == {"request_id": "r1", "batch": 7}
        assert spans["own"].tags == {"batch": 8}
        assert "size" not in spans["req"].tags  # only the link tags
        # Another thread's stack is its own: no parent, no inherited tags.
        assert seen["other"].parent_id is None and seen["other"].tags == {}

    def test_self_seconds(self):
        mk = obs.SpanRecord
        spans = [mk("a", 0.0, 1.0, span_id=1),
                 mk("b", 0.1, 0.4, span_id=2, parent_id=1),
                 mk("c", 0.5, 0.7, span_id=3, parent_id=1),
                 mk("d", 0.2, 0.3, span_id=4, parent_id=2)]
        own = obs.self_seconds(spans)
        assert own[1] == pytest.approx(0.5)
        assert own[2] == pytest.approx(0.2)
        assert own[3] == pytest.approx(0.2)
        assert own[4] == pytest.approx(0.1)

    def test_ring_buffer_bounded(self):
        tr = obs.Tracer(capacity=4)
        for i in range(10):
            with tr.span(f"s{i}"):
                pass
        assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]

    def test_dropped_counts_pushed_out_spans(self):
        tr = obs.Tracer(capacity=4)
        for i in range(10):
            with tr.span(f"s{i}", bucket=(64, 8)):
                pass
        assert tr.dropped == 6
        assert tr.spans("s9")[0].tags["bucket"] == [64, 8]
        tr.reserve(8)
        tr.reserve(2)  # never shrinks
        assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]
        for i in range(10, 14):
            with tr.span(f"s{i}"):
                pass
        assert tr.dropped == 6 and len(tr.spans()) == 8
        with tr.span("s14"):
            pass
        assert tr.dropped == 7 and tr.spans()[0].name == "s7"
        tr.clear()
        assert tr.dropped == 0 and tr.spans() == []

    def test_ring_under_many_threads(self):
        """More recording threads than cores, switching often: every span
        is kept or counted as dropped, and no id is handed out twice."""
        import sys

        tr = obs.Tracer(capacity=500)
        n_threads, per_thread = 16, 200
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            def work(slot):
                for i in range(per_thread):
                    with tr.span("outer", batch=slot):
                        with tr.span("inner"):
                            pass

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
        held = tr.spans()
        assert len(held) + tr.dropped == 2 * n_threads * per_thread
        assert len({s.span_id for s in held}) == len(held) == 500
        by_id = {s.span_id: s for s in held}
        for s in held:
            if s.name == "inner" and s.parent_id in by_id:
                parent = by_id[s.parent_id]
                assert parent.thread == s.thread
                assert parent.tags["batch"] == s.tags["batch"]

    def test_dispatch_relay_feeds_counters_and_registry(self):
        reg = obs.default_registry()
        fam = reg.counter("solver_dispatch_total")
        before = fam.value(path="fused", method="bakp")
        plain = obs.dispatch_counts().get(("fused", "bakp"), 0)
        obs.consume_dispatch()
        obs.record_dispatch("fused", method="bakp")
        assert obs.consume_dispatch("xla") == "fused"
        assert obs.consume_dispatch("xla") == "xla"  # one-shot
        assert fam.value(path="fused", method="bakp") == before + 1
        assert obs.dispatch_counts()[("fused", "bakp")] == plain + 1
        fb = reg.counter("solver_fallback_total")
        fb0 = fb.value(method="bakp", reason="vmem")
        obs.record_dispatch("persweep", method="bakp", reason="vmem")
        assert fb.value(method="bakp", reason="vmem") == fb0 + 1
        obs.consume_dispatch()

    def test_relay_counts_with_obs_disabled(self):
        plain = obs.dispatch_counts().get(("xla", "probe"), 0)
        obs.set_enabled(False)
        obs.record_dispatch("xla", method="probe")
        obs.set_enabled(True)
        assert obs.dispatch_counts()[("xla", "probe")] == plain + 1
        assert obs.consume_dispatch() == "xla"

    def test_now_and_cpu_sync(self):
        import torch

        a = obs.now()
        obs.sync_device(torch.device("cpu"))  # a no-op off the card
        assert obs.now() >= a

    def test_profile_region_inert_and_traced(self, tmp_path):
        """``span`` opens no profiler range while nothing records, nor
        under a profiler someone else started (it records only its own
        thread, and sees the program as without spans), and names one on a
        ``start_profiling`` trace."""
        import torch

        from repro_torch.obs.trace import _profiler_range

        assert _profiler_range("idle") is None
        with obs.span("idle"):
            pass
        assert not obs.profiling_active()
        foreign = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        foreign.start()
        try:
            assert _profiler_range("foreign") is None
            with obs.span("foreign"):
                sum(range(100))
        finally:
            foreign.stop()
        assert "foreign" not in {e.name for e in foreign.events()}
        assert obs.start_profiling(str(tmp_path))
        with pytest.raises(RuntimeError, match="already active"):
            obs.start_profiling(str(tmp_path))
        with obs.span("engine.flush"):
            sum(range(100))
        assert obs.stop_profiling() == str(tmp_path)
        assert obs.stop_profiling() is None
        assert _profiler_range("idle") is None
        names = _trace_names(tmp_path)
        assert "engine.flush" in names and "idle" not in names

    def test_span_on_a_second_thread_in_the_trace(self, tmp_path):
        if obs.all_threads_config() is None:
            pytest.skip("this torch build's profiler has no "
                        "profile_all_threads: only the starting thread's "
                        "ranges are recorded")
        assert obs.start_profiling(str(tmp_path))

        def lane():
            with obs.span("engine.call", method="bakp"):
                sum(range(1000))

        t = threading.Thread(target=lane, name="lane-test")
        t.start()
        t.join()
        obs.stop_profiling()
        assert "engine.call" in _trace_names(tmp_path)

    def test_clock_map_places_span_on_the_profiler_clock(self):
        import torch

        tr = obs.Tracer(capacity=8)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
        tr.clear()  # a fresh anchor, as a window's reader takes it
        with torch.profiler.record_function("test.window"):
            time.sleep(0.002)
            with tr.span("test.inner"):
                time.sleep(0.003)
            time.sleep(0.002)
        prof.stop()
        win = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.name() == "test.window"]
        assert len(win) == 1
        w0, w1 = win[0]
        sp = tr.spans("test.inner")[0]
        s0, s1 = tr.unix_ns(sp.t_start), tr.unix_ns(sp.t_end)
        assert s1 - s0 == pytest.approx(sp.duration_s * 1e9, abs=1e3)
        assert w0 - 1_000_000 <= s0 and s1 <= w1 + 1_000_000
        # The span sits between the window's two 2 ms sleeps.
        assert s0 - w0 >= 1_000_000 and w1 - s1 >= 1_000_000


def _trace_names(trace_dir):
    """Every event name in the Chrome traces written under ``trace_dir``."""
    names = set()
    for path in trace_dir.rglob("*.json"):
        for ev in json.loads(path.read_text()).get("traceEvents", []):
            names.add(ev.get("name"))
    assert names, "the trace must be written"
    return names


# ------------------------------------------------------------- kill switch
class TestKillSwitch:
    def test_env_parsing(self):
        assert _env_disabled({"REPRO_OBS_DISABLED": "1"})
        assert _env_disabled({"REPRO_OBS_DISABLED": "True"})
        assert not _env_disabled({"REPRO_OBS_DISABLED": "0"})
        assert not _env_disabled({})

    def test_disabled_mutators_are_noops(self):
        reg = obs.MetricsRegistry()
        c = reg.counter("c")
        h = reg.histogram("h")
        c.inc(5)
        obs.set_enabled(False)
        c.inc(100)
        c.labels().inc(100)
        h.observe(1.0)
        with obs.span("dead") as s:
            assert s is None
        obs.set_enabled(True)
        assert c.value() == 5
        assert h.count() == 0

    def test_disabled_engine_serves_without_telemetry(self, rng):
        x, y, _ = make_system(rng, 40, 8)
        eng = _engine()
        obs.set_enabled(False)
        out = eng.serve([_req(x, y)])
        assert out[0].ok
        assert out[0].telemetry is None
        assert eng.registry.get("serve_requests_served_total").value() == 0
        eng.shutdown()


# ----------------------------------------------------- engine telemetry
class TestEngineTelemetry:
    def test_solve_telemetry_attached_and_kernel_path(self, rng):
        x, y, _ = make_system(rng, 40, 8)
        eng = _engine()
        out = eng.serve([_req(x, y, tenant_id="t0", request_id="r0")])
        tel = out[0].telemetry
        assert tel is not None
        assert tel.request_id == "r0" and tel.tenant_id == "t0"
        assert tel.method == "bakp" and tel.kernel_path == "xla"
        assert tel.batch_kind == out[0].batch_kind
        assert tel.bucket == out[0].bucket
        assert tel.n_sweeps == out[0].n_sweeps
        assert tel.solve_s == pytest.approx(out[0].latency_s)
        assert tel.lane == "single:xla"
        assert not tel.warm_start and tel.error_type is None
        d = tel.as_dict()
        assert d["kernel_path"] == "xla" and json.dumps(d)
        eng.shutdown()

    def test_fused_method_reports_fused_path(self, rng):
        x, y, _ = make_system(rng, 40, 8)
        eng = _engine()
        out = eng.serve([_req(x, y, method="bakp_fused", thr=8)])
        assert out[0].ok
        assert out[0].telemetry.kernel_path == "fused"
        assert out[0].telemetry.lane == "single:fused"
        eng.shutdown()

    def test_registry_families_after_serve(self, rng):
        x, y, _ = make_system(rng, 40, 8)
        x2, y2, _ = make_system(rng, 40, 8)
        eng = _engine()
        reg = eng.registry
        served = eng.serve([_req(x, y, design_key="d1"),
                            _req(x2, y2, design_key="d2")])
        assert all(s.ok for s in served)
        assert reg.get("serve_requests_total").value() == 2
        assert reg.get("serve_requests_served_total").value() == 2
        assert reg.get("serve_solve_latency_seconds").count() >= 1
        assert reg.get("serve_sweeps").count() == 2
        assert reg.get("serve_cache_misses_total").value() == 2
        assert reg.get("serve_cache_entries").value() == 2
        eng.serve([_req(x, y, design_key="d1")])
        assert reg.get("serve_cache_hits_total").value() == 1
        eng.shutdown()

    def test_flush_spans(self, rng):
        x, y, _ = make_system(rng, 40, 8)
        tr = obs.get_tracer()
        tr.clear()
        eng = _engine()
        eng.serve([_req(x, y, design_key="sp"), _req(x, y, design_key="sp")])
        names = {s.name for s in tr.spans()}
        assert {"engine.flush", "engine.fingerprint", "engine.group",
                "engine.design", "engine.pad", "engine.solve",
                "design.y_to_device", "engine.call", "engine.sync",
                "engine.strip", "engine.result_to_host"} <= names
        solve = tr.spans("engine.solve")[-1]
        assert solve.tags["lane"] == "single:xla"
        assert solve.tags["kind"] == "multi_rhs"
        eng.shutdown()

    def test_warm_start_label(self, rng):
        x, y, _ = make_system(rng, 60, 8)
        eng = _engine()
        reg = eng.registry
        eng.serve([_req(x, y, design_key="d", tenant_id="t")])
        out = eng.serve([_req(x, y, design_key="d", tenant_id="t")])
        assert out[0].warm_start and out[0].telemetry.warm_start
        assert reg.get("serve_requests_served_total").value(warm="1") == 1
        assert reg.get("serve_sweeps").count(warm="1") == 1
        eng.shutdown()

    def test_error_telemetry_and_counter(self, rng):
        x, y, _ = make_system(rng, 40, 4)
        eng = _engine(retry_ladder=False)
        # thr=0 fails inside the solve: a poisoned request that submit-time
        # validation cannot catch.
        out = eng.serve([_req(x, y, thr=0, max_iter=5)])
        assert not out[0].ok
        tel = out[0].telemetry
        assert tel is not None
        assert tel.error_type and tel.kernel_path == "none"
        assert tel.batch_kind == "error"
        errs = eng.registry.get("serve_errors_total")
        assert errs.value() == 1
        assert errs.value(exception_type=tel.error_type) == 1
        assert errs.value(method="bakp") == 1
        eng.shutdown()


# ------------------------------------------------------ dispatcher telemetry
_DISPATCH_FAMILIES = ("serve_dispatch_submitted_total",
                      "serve_dispatch_completed_total",
                      "serve_dispatch_fired_total",
                      "serve_dispatch_inflight",
                      "serve_dispatch_deadline_misses_total")


class TestDispatcherTelemetry:
    def test_queue_wait_and_deadline_margin_backfilled(self, rng):
        x, y, _ = make_system(rng, 40, 8)
        values = []
        for Disp, Cfg, eng, Req in (
                (AsyncDispatcher, DispatchConfig, _engine(), SolveRequest),
                (J.AsyncDispatcher, J.DispatchConfig,
                 J.SolverServeEngine(J.ServeConfig(),
                                     registry=jobs.MetricsRegistry()),
                 J.SolveRequest)):
            reg = eng.registry
            with Disp(eng, Cfg(idle_timeout_s=0.005)) as d:
                t = d.submit(Req(x=x, y=y, method="bakp", max_iter=15),
                             deadline_s=30.0)
                res = t.result(timeout=30.0)
            assert res.ok
            tel = res.telemetry
            assert tel is t.telemetry
            assert tel.queue_wait_s is not None and tel.queue_wait_s >= 0
            assert tel.queue_wait_s == pytest.approx(t.queue_wait_s)
            assert tel.deadline_margin_s == pytest.approx(
                t.deadline - t.completed_at)
            assert tel.deadline_margin_s > 0  # 30s deadline was met
            assert reg.get("serve_queue_wait_seconds").count() == 1
            assert reg.get("serve_request_latency_seconds").count() == 1
            values.append([reg.get(f).value() for f in _DISPATCH_FAMILIES])
            eng.shutdown()
        assert values[0] == values[1] == [1, 1, 1, 0, 0]

    def test_ticket_clock_is_obs_now(self, rng):
        x, y, _ = make_system(rng, 40, 8)
        before = obs.now()
        eng = _engine()
        with AsyncDispatcher(eng, DispatchConfig()) as d:
            t = d.submit(_req(x, y))
            t.result(timeout=30.0)
        after = obs.now()
        # Same epoch as obs.now(): composes with engine/queue timings.
        assert before <= t.submitted_at <= t.fired_at <= t.completed_at
        assert t.completed_at <= after
        eng.shutdown()


# ------------------------------------------------------------ concurrency
class TestHammer:
    def test_hammer_counts_consistent_and_snapshot_safe(self, rng):
        x, y, _ = make_system(rng, 40, 8)
        x2, y2, _ = make_system(rng, 40, 8)
        eng = _engine()
        reg = eng.registry
        n_threads, per_thread = 6, 4
        results = [[] for _ in range(n_threads)]
        errors = []
        stop = threading.Event()

        def snapshotter():
            # Waits between reads: a spinning reader would hold the GIL
            # against every torch call of the lanes.
            while not stop.wait(0.001):
                try:
                    json.dumps(reg.snapshot())
                    reg.render_prometheus()
                except Exception as exc:  # pragma: no cover
                    errors.append(exc)

        def worker(slot):
            try:
                for i in range(per_thread):
                    results[slot].extend(eng.serve([_req(
                        x if i % 2 else x2, y if i % 2 else y2,
                        design_key="da" if i % 2 else "db",
                        tenant_id=f"w{slot}")]))
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        snap_t = threading.Thread(target=snapshotter, daemon=True)
        snap_t.start()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        stop.set()
        snap_t.join(timeout=10.0)
        assert not any(t.is_alive() for t in threads + [snap_t])
        assert not errors, errors
        delivered = [r for slot in results for r in slot]
        total = n_threads * per_thread
        assert len(delivered) == total
        assert all(r.ok and r.telemetry is not None for r in delivered)
        assert reg.get("serve_requests_total").value() == total
        assert reg.get("serve_requests_served_total").value() == total
        assert reg.get("serve_sweeps").count() == total
        assert reg.get("serve_lane_inflight").value(lane="single:xla") == 0
        eng.shutdown()

    def test_dispatcher_hammer_counts_consistent_and_snapshot_safe(self,
                                                                  rng):
        """The JAX test's hammer: submitters racing through the dispatcher
        while a reader snapshots the registry; its totals agree with what
        the callers received."""
        x, y, _ = make_system(rng, 40, 8)
        x2, y2, _ = make_system(rng, 40, 8)
        eng = _engine()
        reg = eng.registry
        n_threads, per_thread = 6, 12
        results = [[] for _ in range(n_threads)]
        errors = []
        stop = threading.Event()

        def snapshotter():
            while not stop.wait(0.001):
                try:
                    json.dumps(reg.snapshot())
                    reg.render_prometheus()
                except Exception as exc:  # pragma: no cover
                    errors.append(exc)

        cfg = DispatchConfig(max_queue=512, idle_timeout_s=0.005,
                             max_batch=8)
        with AsyncDispatcher(eng, cfg) as disp:
            def worker(slot):
                try:
                    tickets = [
                        disp.submit(_req(
                            x if i % 2 else x2, y if i % 2 else y2,
                            design_key="da" if i % 2 else "db",
                            tenant_id=f"w{slot}"))
                        for i in range(per_thread)]
                    results[slot] = [t.result(timeout=60.0) for t in tickets]
                except Exception as exc:  # pragma: no cover
                    errors.append(exc)

            snap_t = threading.Thread(target=snapshotter, daemon=True)
            snap_t.start()
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            stop.set()
            snap_t.join(timeout=10.0)
        assert not any(t.is_alive() for t in threads + [snap_t])
        assert not errors, errors
        delivered = [r for slot in results for r in slot]
        total = n_threads * per_thread
        assert len(delivered) == total
        assert all(r.ok and r.telemetry is not None for r in delivered)
        assert reg.get("serve_dispatch_submitted_total").value() == total
        assert reg.get("serve_dispatch_completed_total").value() == total
        assert reg.get("serve_requests_served_total").value() == total
        assert reg.get("serve_request_latency_seconds").count() == total
        assert reg.get("serve_queue_wait_seconds").count() == total
        assert reg.get("serve_sweeps").count() == total
        assert 1 <= reg.get("serve_dispatch_fired_total").value() <= total
        assert reg.get("serve_dispatch_inflight").value() == 0
        eng.shutdown()


# ------------------------------------------------------------- exporters
class TestExporters:
    def test_write_metrics_json(self, tmp_path):
        reg = obs.MetricsRegistry()
        reg.counter("c").inc(3)
        path = tmp_path / "m.json"
        doc = obs.write_metrics_json(str(path), registry=reg,
                                     extra={"run": "test"})
        on_disk = json.loads(path.read_text())
        assert on_disk == doc
        assert on_disk["metrics"]["c"]["values"][""] == 3.0
        assert on_disk["meta"]["run"] == "test"

    def test_http_endpoint(self):
        reg = obs.MetricsRegistry()
        reg.counter("hits_total", "hits").inc(7, route="a")
        with obs.start_metrics_server(0, registry=reg,
                                      host="127.0.0.1") as srv:
            base = f"http://127.0.0.1:{srv.port}"
            text = urllib.request.urlopen(f"{base}/metrics").read().decode()
            assert 'hits_total{route="a"} 7' in text
            snap = json.loads(
                urllib.request.urlopen(f"{base}/metrics.json").read())
            assert snap["hits_total"]["values"]["route=a"] == 7.0
            assert urllib.request.urlopen(
                f"{base}/healthz").read() == b"ok\n"
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"{base}/nope")
