"""repro_torch.serve.dispatch against repro.serve.dispatch: flush policy,
backpressure, deadlines, warm starts and exception safety.

Mirrors all of ``tests/test_dispatch.py``.  Each test drives the port's
``AsyncDispatcher`` over an engine with ``device="cpu"`` and, on the same
numpy requests, JAX's over its engine: the flush decisions (which batches
fire, in which order, in which chunks, on which lane, for which reason)
and the dispatcher's counters must be the same, and every served request
the same to 1e-5 of its scale (coefficients and residuals), with the same
batch kind and warm-start flag (every run here stops on an rtol, so
``n_sweeps`` is not compared).
"""
import time

import numpy as np
import pytest

import repro.serve as J
from conftest import make_system
from repro import obs as jobs
from repro.serve.dispatch import SolveTicket as JSolveTicket
from repro_torch import obs
from repro_torch.serve import (AsyncDispatcher, DispatchConfig,
                               DispatcherStopped, QueueFullError,
                               ServeConfig, SolveRequest, SolverServeEngine)
from repro_torch.serve.dispatch import SolveTicket

TOL = 1e-5


def _lstsq(x, y):
    return np.linalg.lstsq(np.asarray(x, np.float64),
                           np.asarray(y, np.float64), rcond=None)[0]


def _req(x, y, Req=SolveRequest, **kw):
    kw.setdefault("method", "bakp_gram")
    kw.setdefault("thr", 8)
    kw.setdefault("max_iter", 60)
    kw.setdefault("rtol", 1e-12)
    return Req(x=x, y=y, **kw)


def _engine(**cfg):
    return SolverServeEngine(ServeConfig(**cfg),
                             registry=obs.MetricsRegistry(), device="cpu")


def _j_engine(**cfg):
    return J.SolverServeEngine(J.ServeConfig(**cfg),
                               registry=jobs.MetricsRegistry())


def _agree(t, j, y):
    """One request served alike by both packages."""
    assert t.ok and j.ok, (t.error, j.error)
    assert (t.batch_kind, t.warm_start) == (j.batch_kind, j.warm_start)
    c_scale = max(1.0, float(np.abs(j.coef).max()))
    assert float(np.abs(t.coef - j.coef).max()) <= TOL * c_scale
    y_scale = max(1.0, float(np.abs(y).max()))
    assert float(np.abs(t.residual - j.residual).max()) <= TOL * y_scale


def _counters(stats):
    """The dispatcher counters that do not depend on timing."""
    d = stats.as_dict()
    return {k: d[k] for k in ("submitted", "rejected", "completed",
                              "cancelled", "deadline_misses")}


# ------------------------------------------------------- flush policy (unit)
class TestFlushPolicy:
    """Drive _admit/_fire_ready directly — no threads, no timing races —
    on both dispatchers with the same tickets."""

    def _dispatchers(self, **kw):
        return (AsyncDispatcher(_engine(),
                                DispatchConfig(prewarm_cache=False, **kw)),
                J.AsyncDispatcher(_j_engine(),
                                  J.DispatchConfig(prewarm_cache=False,
                                                   **kw)))

    def _ticket(self, disp, req, deadline_s=None):
        Ticket = JSolveTicket if isinstance(disp, J.AsyncDispatcher) \
            else SolveTicket
        clock = jobs.now if Ticket is JSolveTicket else obs.now
        t = Ticket(req, None if deadline_s is None
                   else clock() + deadline_s)
        disp._admit(t)
        return t

    def _both(self, fn, **kw):
        """Run ``fn(disp, Req)`` on both; return (port, jax) results."""
        tp, jp = self._dispatchers(**kw)
        return fn(tp, SolveRequest), fn(jp, J.SolveRequest), tp, jp

    @staticmethod
    def _shape(fired):
        return [(lane.label, len(chunk)) for lane, _, chunk in fired]

    def test_fires_when_full(self, rng):
        x, y, _ = make_system(rng, 40, 4)

        def run(disp, Req):
            for _ in range(2):
                self._ticket(disp, _req(x, y, Req, design_key="d"))
            before = disp._fire_ready(obs.now())
            self._ticket(disp, _req(x, y, Req, design_key="d"))
            return before, disp._fire_ready(obs.now())

        (tb, tf), (jb, jf), tp, jp = self._both(
            run, max_batch=3, idle_timeout_s=1e9)
        assert tb == jb == []
        assert self._shape(tf) == self._shape(jf) == [("single:xla", 3)]
        assert tp.stats.fired_full == jp.stats.fired_full == 1
        assert not tp._pending and not jp._pending

    def test_deadline_ordered_flushing(self, rng):
        """The batch holding the most urgent deadline fires first, even when
        a looser-deadline batch was admitted earlier."""
        x1, y1, _ = make_system(rng, 40, 4)
        x2, y2, _ = make_system(rng, 400, 40)  # different bucket

        def run(disp, Req):
            loose = self._ticket(disp, _req(x1, y1, Req, design_key="a"),
                                 deadline_s=0.2)
            tight = self._ticket(disp, _req(x2, y2, Req, design_key="b"),
                                 deadline_s=0.1)
            fired = disp._fire_ready(obs.now())
            assert [b[1] for b in fired] == sorted(b[1] for b in fired)
            return [b[2][0] for b in fired] == [tight, loose]

        t_ok, j_ok, tp, jp = self._both(run, max_batch=100,
                                        idle_timeout_s=1e9,
                                        deadline_margin_s=0.5)
        assert t_ok and j_ok
        assert tp.stats.fired_deadline == jp.stats.fired_deadline == 2

    def test_burst_fires_in_max_batch_chunks(self, rng):
        """max_batch bounds each fired solve even when a burst lands in
        one dispatch iteration."""
        x, y, _ = make_system(rng, 40, 4)

        def run(disp, Req):
            for _ in range(10):
                self._ticket(disp, _req(x, y, Req, design_key="d"))
            return [len(c) for _, _, c in disp._fire_ready(obs.now())]

        t, j, tp, jp = self._both(run, max_batch=4, idle_timeout_s=1e9)
        assert t == j == [4, 4, 2]
        assert tp.stats.fired_full == jp.stats.fired_full == 3

    def test_deadline_not_fired_outside_margin(self, rng):
        x, y, _ = make_system(rng, 40, 4)

        def run(disp, Req):
            self._ticket(disp, _req(x, y, Req, design_key="d"),
                         deadline_s=60.0)
            return disp._fire_ready(obs.now())

        t, j, _, _ = self._both(run, max_batch=100, idle_timeout_s=1e9,
                                deadline_margin_s=0.01)
        assert t == j == []

    def test_idle_timeout_fires(self, rng):
        x, y, _ = make_system(rng, 40, 4)
        tp, jp = self._dispatchers(max_batch=100, idle_timeout_s=0.01)
        self._ticket(tp, _req(x, y, design_key="d"))
        self._ticket(jp, _req(x, y, J.SolveRequest, design_key="d"))
        assert tp._fire_ready(obs.now()) == jp._fire_ready(jobs.now()) == []
        time.sleep(0.02)
        assert (self._shape(tp._fire_ready(obs.now()))
                == self._shape(jp._fire_ready(jobs.now()))
                == [("single:xla", 1)])
        assert tp.stats.fired_idle == jp.stats.fired_idle == 1

    def test_invalid_request_fails_ticket_at_admit(self, rng):
        x, y, _ = make_system(rng, 40, 4)
        tp, jp = self._dispatchers()
        for disp, Req in ((tp, SolveRequest), (jp, J.SolveRequest)):
            t = self._ticket(disp, Req(x=x, y=y[:-1]))
            assert t.done()
            with pytest.raises(ValueError, match="y must be"):
                t.result(timeout=0)
        assert _counters(tp.stats) == _counters(jp.stats)


# ----------------------------------------------------------- backpressure
class TestBackpressure:
    def test_reject_policy_raises(self, rng):
        """With nothing firing, the (max_queue+1)-th submit is rejected."""
        x, y, _ = make_system(rng, 40, 4)
        stats, served = [], []
        for Disp, Cfg, eng, Req, Full in (
                (AsyncDispatcher, DispatchConfig, _engine(), SolveRequest,
                 QueueFullError),
                (J.AsyncDispatcher, J.DispatchConfig, _j_engine(),
                 J.SolveRequest, J.QueueFullError)):
            cfg = Cfg(max_queue=3, backpressure="reject", max_batch=100,
                      idle_timeout_s=1e9)
            with Disp(eng, cfg) as disp:
                tickets = [disp.submit(_req(x, y, Req, design_key="d"))
                           for _ in range(3)]
                with pytest.raises(Full, match="capacity"):
                    disp.submit(_req(x, y, Req, design_key="d"))
                assert disp.stats.rejected == 1
                assert disp.drain(timeout=120)
                served.append([t.result(timeout=1) for t in tickets])
            stats.append(_counters(disp.stats))
            eng.shutdown()
        assert stats[0] == stats[1]
        for t, j in zip(*served):
            _agree(t, j, y)

    def test_block_policy_completes_everything(self, rng):
        x, y, _ = make_system(rng, 40, 4)
        out = []
        for Disp, Cfg, eng, Req in (
                (AsyncDispatcher, DispatchConfig, _engine(), SolveRequest),
                (J.AsyncDispatcher, J.DispatchConfig, _j_engine(),
                 J.SolveRequest)):
            cfg = Cfg(max_queue=2, backpressure="block", max_batch=2,
                      idle_timeout_s=0.005)
            with Disp(eng, cfg) as disp:
                tickets = [disp.submit(_req(x, y, Req, design_key="d"))
                           for _ in range(6)]   # blocks, never raises
                assert disp.drain(timeout=120)
            results = [t.result(timeout=1) for t in tickets]
            assert all(r.ok for r in results)
            assert disp.stats.rejected == 0 and disp.stats.submitted == 6
            assert disp.stats.max_inflight <= 2
            out.append(results)
            eng.shutdown()
        for t, j in zip(*out):
            _agree(t, j, y)

    def test_bad_backpressure_rejected(self):
        eng = _engine()
        with pytest.raises(ValueError, match="backpressure"):
            AsyncDispatcher(eng, DispatchConfig(backpressure="drop"))
        with pytest.raises(ValueError, match="backpressure"):
            J.AsyncDispatcher(config=J.DispatchConfig(backpressure="drop"))
        eng.shutdown()

    def test_stop_without_drain_fails_pending(self, rng):
        """stop(drain=False) abandons queued work instead of serving it."""
        x, y, _ = make_system(rng, 40, 4)
        for Disp, Cfg, eng, Req, Stopped in (
                (AsyncDispatcher, DispatchConfig, _engine(), SolveRequest,
                 DispatcherStopped),
                (J.AsyncDispatcher, J.DispatchConfig, _j_engine(),
                 J.SolveRequest, J.DispatcherStopped)):
            disp = Disp(eng, Cfg(max_batch=100, idle_timeout_s=1e9)).start()
            tickets = [disp.submit(_req(x, y, Req, design_key="d"))
                       for _ in range(3)]
            disp.stop(drain=False)
            for t in tickets:
                assert t.done()
                with pytest.raises(Stopped):
                    t.result(timeout=1)
            with pytest.raises(Stopped):
                disp.submit(_req(x, y, Req))
            assert disp.inflight == 0
            eng.shutdown()


# ------------------------------------------------------------- end to end
class TestAsyncEndToEnd:
    def test_matches_synchronous_engine(self, rng):
        """Same requests through the dispatcher and a plain engine flush
        give identical coefficients (same batching, same solves), and the
        same as JAX's dispatcher to 1e-5."""
        x_shared = rng.normal(size=(300, 24)).astype(np.float32)
        reqs = []
        for _ in range(4):  # same design -> multi-RHS group
            a = rng.normal(size=(24,)).astype(np.float32)
            reqs.append((x_shared, x_shared @ a, "s"))
        for i in range(2):  # unique designs, same bucket -> batch
            xu = rng.normal(size=(290, 20)).astype(np.float32)
            reqs.append((xu, xu @ np.ones(20, np.float32), f"u{i}"))

        sync_eng = _engine()
        sync = sync_eng.serve([_req(x, y, thr=16, design_key=k)
                               for x, y, k in reqs])
        sync_eng.shutdown()
        out = {}
        for Disp, Cfg, eng, Req in (
                (AsyncDispatcher, DispatchConfig, _engine(), SolveRequest),
                (J.AsyncDispatcher, J.DispatchConfig, _j_engine(),
                 J.SolveRequest)):
            with Disp(eng, Cfg(max_batch=len(reqs),
                               idle_timeout_s=0.01)) as disp:
                tickets = [disp.submit(_req(x, y, Req, thr=16, design_key=k))
                           for x, y, k in reqs]
                out[Req] = [t.result(timeout=120) for t in tickets]
            eng.shutdown()
        for s, r, j, (_, y, _) in zip(sync, out[SolveRequest],
                                      out[J.SolveRequest], reqs):
            assert r.ok and r.batch_kind == s.batch_kind
            np.testing.assert_array_equal(r.coef, s.coef)
            _agree(r, j, y)

    def test_deadline_reporting(self, rng):
        x, y, _ = make_system(rng, 40, 4)
        out = []
        for Disp, Cfg, eng, Req in (
                (AsyncDispatcher, DispatchConfig, _engine(), SolveRequest),
                (J.AsyncDispatcher, J.DispatchConfig, _j_engine(),
                 J.SolveRequest)):
            with Disp(eng, Cfg(max_batch=4, idle_timeout_s=0.005)) as disp:
                tickets = [disp.submit(_req(x, y, Req, design_key="d"),
                                       deadline_s=120.0) for _ in range(4)]
                results = [t.result(timeout=120) for t in tickets]
            assert all(r.ok for r in results)
            assert all(t.deadline_met for t in tickets)
            assert all(t.latency_s is not None and t.latency_s >= 0
                       for t in tickets)
            assert disp.stats.deadline_hit_rate == 1.0
            out.append((results, _counters(disp.stats)))
            eng.shutdown()
        assert out[0][1] == out[1][1] == dict(
            submitted=4, rejected=0, completed=4, cancelled=0,
            deadline_misses=0)
        for t, j in zip(out[0][0], out[1][0]):
            _agree(t, j, y)


    def test_mesh_engine_sends_sharded_bucket_to_mesh_lane(self, rng):
        """A mesh engine's dispatcher keys a sharded bucket's batch by its
        placement, pre-warms its sharded copy on the dispatch thread while
        the batch waits, and fires it on the mesh lane; the single-device
        bucket rides the single lane.  Held to JAX's dispatcher over a
        one-device mesh (the same placements and lanes)."""
        from repro_torch.serve import PlacementPolicy, build_serve_mesh

        big = [make_system(rng, 200, 16) for _ in range(2)]
        small = [make_system(rng, 40, 8) for _ in range(2)]
        reqs = ([(x, y, f"big-{i}") for i, (x, y, _) in enumerate(big)]
                + [(x, y, f"small-{i}") for i, (x, y, _) in enumerate(small)])
        out = {}
        for Disp, Cfg, eng, Req in (
                (AsyncDispatcher, DispatchConfig, SolverServeEngine(
                    ServeConfig(placement_policy=PlacementPolicy(
                        obs_shard_min_cells=128 * 16)),
                    mesh=build_serve_mesh("4", device="cpu"),
                    registry=obs.MetricsRegistry()), SolveRequest),
                (J.AsyncDispatcher, J.DispatchConfig, J.SolverServeEngine(
                    J.ServeConfig(placement_policy=J.PlacementPolicy(
                        obs_shard_min_cells=128 * 16)),
                    mesh=J.build_serve_mesh("1"),
                    registry=jobs.MetricsRegistry()), J.SolveRequest)):
            with Disp(eng, Cfg(max_batch=16, idle_timeout_s=0.5)) as disp:
                tickets = [disp.submit(_req(x, y, Req, design_key=k))
                           for x, y, k in reqs]
                if Req is SolveRequest:
                    # The batch waits out its idle timeout: the pre-warm
                    # has built the sharded copy before it fires.
                    deadline = time.monotonic() + 5.0
                    entry = None
                    while entry is None and time.monotonic() < deadline:
                        entry = eng.cache.get("big-1", record_stats=False)
                        time.sleep(0.005)
                    assert entry is not None
                    assert entry.home == "obs_sharded"
                    assert "obs_sharded" in entry.resident_lanes()
                    assert not any(t.done() for t in tickets)
                out[Req] = [t.result(timeout=120) for t in tickets]
            if Req is SolveRequest:
                assert set(eng.lanes.stats()) == {"mesh:obs_sharded",
                                                  "single:xla"}
                assert eng.stats.sharded_solves == 2
                assert eng.cache.stats.hits == len(reqs)  # pre-warmed
            eng.shutdown()
        for t, j, (_, y, _) in zip(out[SolveRequest], out[J.SolveRequest],
                                   reqs):
            assert t.placement == j.placement
            assert t.telemetry.lane == j.telemetry.lane
            _agree(t, j, y)
        assert [t.placement for t in out[SolveRequest]] == [
            "obs_sharded", "obs_sharded", "single", "single"]


# -------------------------------------------------------------- warm starts
class TestWarmStart:
    """The engine's warm-start paths the dispatcher relies on, against the
    JAX engine on the same requests."""

    @staticmethod
    def _pair():
        return ((_engine(), SolveRequest), (_j_engine(), J.SolveRequest))

    def test_warm_matches_cold_within_rtol(self, rng):
        """A tenant's warm-started re-solve lands on the cold answer."""
        x = rng.normal(size=(300, 24)).astype(np.float32)
        a = rng.normal(size=(24,)).astype(np.float32)
        a2 = a + 0.01 * rng.normal(size=24).astype(np.float32)
        out = []
        for (eng, Req), (cold_eng, _) in zip(self._pair(), self._pair()):
            eng.serve([_req(x, x @ a, Req, thr=16, design_key="d",
                            tenant_id="t")])
            warm, = eng.serve([_req(x, x @ a2, Req, thr=16, design_key="d",
                                    tenant_id="t")])
            cold, = cold_eng.serve([_req(x, x @ a2, Req, thr=16,
                                         design_key="d")])
            assert warm.warm_start and not cold.warm_start
            np.testing.assert_allclose(warm.coef, cold.coef, rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(warm.coef, _lstsq(x, x @ a2),
                                       rtol=1e-3, atol=1e-3)
            out.append(warm)
            eng.shutdown()
            cold_eng.shutdown()
        _agree(out[0], out[1], x @ a2)

    def test_warm_and_cold_coalesce(self, rng):
        """Warm and cold tenants merge into ONE multi-RHS solve and each
        still gets the right answer (cold rides a zero a0 column)."""
        x = rng.normal(size=(300, 24)).astype(np.float32)
        a_warm = rng.normal(size=(24,)).astype(np.float32)
        a_new = rng.normal(size=(24,)).astype(np.float32)
        drifted = a_warm + 0.01 * rng.normal(size=24).astype(np.float32)
        outs = []
        for eng, Req in self._pair():
            eng.serve([_req(x, x @ a_warm, Req, thr=16, design_key="d",
                            tenant_id="veteran")])
            out = eng.serve([
                _req(x, x @ drifted, Req, thr=16, design_key="d",
                     tenant_id="veteran"),
                _req(x, x @ a_new, Req, thr=16, design_key="d",
                     tenant_id="rookie"),
            ])
            assert [r.batch_kind for r in out] == ["multi_rhs"] * 2
            assert out[0].warm_start and not out[1].warm_start
            np.testing.assert_allclose(out[0].coef, _lstsq(x, x @ drifted),
                                       rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(out[1].coef, _lstsq(x, x @ a_new),
                                       rtol=1e-3, atol=1e-3)
            assert eng.stats.warm_starts == 1
            outs.append(out)
            eng.shutdown()
        for t, j, y in zip(outs[0], outs[1], (x @ drifted, x @ a_new)):
            _agree(t, j, y)

    def test_explicit_a0_beats_cached(self, rng):
        x = rng.normal(size=(64, 8)).astype(np.float32)
        a = rng.normal(size=(8,)).astype(np.float32)
        outs = []
        for eng, Req in self._pair():
            eng.serve([_req(x, x @ a, Req, design_key="d", tenant_id="t")])
            served, = eng.serve([_req(x, x @ a, Req, design_key="d",
                                      tenant_id="t", a0=a)])
            assert served.warm_start
            np.testing.assert_allclose(served.coef, a, rtol=1e-4, atol=1e-5)
            outs.append(served)
            eng.shutdown()
        _agree(outs[0], outs[1], x @ a)

    def test_warm_reduces_sweeps(self, rng):
        x = rng.normal(size=(400, 32)).astype(np.float32)
        a = rng.normal(size=(32,)).astype(np.float32)
        drift = a + 0.001 * rng.normal(size=32).astype(np.float32)
        kw = dict(thr=16, rtol=1e-4, max_iter=100, design_key="d")
        for (eng, Req), (cold_eng, _) in zip(self._pair(), self._pair()):
            eng.serve([_req(x, x @ a, Req, tenant_id="t", **kw)])
            warm, = eng.serve([_req(x, x @ drift, Req, tenant_id="t", **kw)])
            cold, = cold_eng.serve([_req(x, x @ drift, Req, **kw)])
            assert warm.warm_start
            assert warm.n_sweeps < cold.n_sweeps
            eng.shutdown()
            cold_eng.shutdown()

    def test_warm_cache_off_stays_cold(self, rng):
        x = rng.normal(size=(64, 8)).astype(np.float32)
        for eng, Req in ((_engine(warm_cache=False), SolveRequest),
                         (_j_engine(warm_cache=False), J.SolveRequest)):
            eng.serve([_req(x, x[:, 0], Req, design_key="d", tenant_id="t")])
            served, = eng.serve([_req(x, x[:, 0], Req, design_key="d",
                                      tenant_id="t")])
            assert not served.warm_start
            assert eng.stats.warm_starts == 0
            eng.shutdown()

    def test_vmap_path_warm_and_cold(self, rng):
        """Distinct-design batches thread per-row a0 with zero rows for
        cold members."""
        x1 = rng.normal(size=(300, 24)).astype(np.float32)
        x2 = rng.normal(size=(300, 24)).astype(np.float32)
        a1 = rng.normal(size=(24,)).astype(np.float32)
        a2 = rng.normal(size=(24,)).astype(np.float32)
        outs = []
        for eng, Req in self._pair():
            out = eng.serve([
                _req(x1, x1 @ a1, Req, thr=16, a0=a1 * 0.99),
                _req(x2, x2 @ a2, Req, thr=16),
            ])
            assert [r.batch_kind for r in out] == ["vmap"] * 2
            assert out[0].warm_start and not out[1].warm_start
            np.testing.assert_allclose(out[0].coef, a1, rtol=1e-3,
                                       atol=1e-3)
            np.testing.assert_allclose(out[1].coef, a2, rtol=1e-3,
                                       atol=1e-3)
            outs.append(out)
            eng.shutdown()
        for t, j, y in zip(outs[0], outs[1], (x1 @ a1, x2 @ a2)):
            _agree(t, j, y)

    def test_a0_broadcasts_across_rhs(self, rng):
        """A (vars,) a0 with multi-RHS y warm-starts every column."""
        import torch

        from repro.core import solvebakp as j_solvebakp
        from repro_torch.core import solvebak, solvebakp
        x = rng.normal(size=(100, 8)).astype(np.float32)
        a = rng.normal(size=(8,)).astype(np.float32)
        ys = np.stack([x @ a, x @ a], 1)
        xt, yt, at = (torch.from_numpy(v) for v in (x, ys, a))
        r1 = solvebak(xt, yt, max_iter=30, a0=at)
        r2 = solvebakp(xt, yt, thr=4, max_iter=30, a0=at)
        jr = j_solvebakp(x, ys, thr=4, max_iter=30, a0=a)
        for r in (r1, r2):
            np.testing.assert_allclose(r.coef.numpy(), np.stack([a, a], 1),
                                       rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r2.coef.numpy(), np.asarray(jr.coef),
                                   rtol=1e-5, atol=1e-5)

    def test_bad_a0_shape_rejected(self, rng):
        x, y, _ = make_system(rng, 50, 4)
        eng = _engine()
        with pytest.raises(ValueError, match="a0 must be"):
            eng.submit(SolveRequest(x=x, y=y, a0=np.zeros(3, np.float32)))
        with pytest.raises(ValueError, match="a0 must be"):
            J.SolverServeEngine().submit(
                J.SolveRequest(x=x, y=y, a0=np.zeros(3, np.float32)))
        eng.shutdown()


# ---------------------------------------------- flush exception safety
class TestFlushExceptionSafety:
    """A solver raising mid-flush never aborts the whole flush, in either
    package."""

    def test_poisoned_request_cannot_wedge_engine(self, rng):
        x, y, _ = make_system(rng, 64, 8)
        outs = []
        # retry_ladder=False: the raw isolation property (with the ladder
        # on, the poisoned request is recovered instead).
        for eng, Req in ((_engine(retry_ladder=False), SolveRequest),
                         (_j_engine(retry_ladder=False), J.SolveRequest)):
            # thr=0 fails inside the solve, after submit-time validation.
            poisoned = _req(x, y, Req, method="bakp", thr=0, max_iter=5)
            healthy = [_req(x, y, Req, design_key="d") for _ in range(2)]
            out = eng.serve([healthy[0], poisoned, healthy[1]])
            assert [r.ok for r in out] == [True, False, True]
            assert out[1].batch_kind == "error"
            assert "ZeroDivisionError" in out[1].error
            assert not out[1].converged
            np.testing.assert_allclose(out[0].coef, _lstsq(x, y), rtol=1e-3,
                                       atol=1e-3)
            assert eng.stats.failures == 1
            again, = eng.serve([_req(x, y, Req, design_key="d")])
            assert again.ok and again.cache_hit
            outs.append((out, again))
            eng.shutdown()
        (tout, tagain), (jout, jagain) = outs
        for t, j in ((tout[0], jout[0]), (tout[2], jout[2]),
                     (tagain, jagain)):
            _agree(t, j, y)

    def test_poisoned_multi_rhs_group_isolated(self, rng, monkeypatch):
        """One group's failure doesn't take down sibling groups in the
        same flush."""
        x1 = rng.normal(size=(64, 8)).astype(np.float32)
        x2 = rng.normal(size=(64, 8)).astype(np.float32)
        outs = []
        for eng, Req in ((_engine(), SolveRequest),
                         (_j_engine(), J.SolveRequest)):
            real = eng._call_solver

            def boom(spec, entry, y_dev, atol, a0=None, real=real, **kw):
                if entry.fingerprint == "bad":
                    raise RuntimeError("injected solver failure")
                return real(spec, entry, y_dev, atol, a0=a0, **kw)

            monkeypatch.setattr(eng, "_call_solver", boom)
            out = eng.serve([
                _req(x1, x1[:, 0], Req, design_key="bad"),
                _req(x1, x1[:, 1], Req, design_key="bad"),
                _req(x2, x2[:, 0], Req, design_key="good"),
                _req(x2, x2[:, 1], Req, design_key="good"),
            ])
            assert [r.ok for r in out] == [False, False, True, True]
            assert all("injected" in r.error for r in out[:2])
            assert eng.stats.failures == 2
            outs.append(out)
            eng.shutdown()
        for t, j, y in zip(outs[0][2:], outs[1][2:], (x2[:, 0], x2[:, 1])):
            _agree(t, j, y)

    def test_failed_deadline_ticket_counts_as_miss(self, rng, monkeypatch):
        """A batch whose engine.serve raises marks deadline-carrying
        tickets as misses (hit rate must not be inflated by failures)."""
        x, y, _ = make_system(rng, 64, 8)
        stats = []
        for Disp, Cfg, eng, Req in (
                (AsyncDispatcher, DispatchConfig, _engine(), SolveRequest),
                (J.AsyncDispatcher, J.DispatchConfig, _j_engine(),
                 J.SolveRequest)):
            monkeypatch.setattr(
                eng, "serve",
                lambda reqs: (_ for _ in ()).throw(RuntimeError("boom")))
            with Disp(eng, Cfg(max_batch=1, idle_timeout_s=0.005)) as disp:
                t = disp.submit(_req(x, y, Req), deadline_s=120.0)
                with pytest.raises(RuntimeError, match="boom"):
                    t.result(timeout=120)
            assert t.deadline_met is False
            assert disp.stats.deadline_hit_rate == 0.0
            stats.append(_counters(disp.stats))
            eng.shutdown()
        assert stats[0] == stats[1] and stats[0]["deadline_misses"] == 1

    def test_dispatcher_surfaces_error_results(self, rng):
        x, y, _ = make_system(rng, 64, 8)
        outs = []
        for Disp, Cfg, eng, Req in (
                (AsyncDispatcher, DispatchConfig,
                 _engine(retry_ladder=False), SolveRequest),
                (J.AsyncDispatcher, J.DispatchConfig,
                 _j_engine(retry_ladder=False), J.SolveRequest)):
            with Disp(eng, Cfg(max_batch=2, idle_timeout_s=0.005)) as disp:
                bad = disp.submit(_req(x, y, Req, method="bakp", thr=0,
                                       max_iter=5))
                good = disp.submit(_req(x, y, Req, design_key="d"))
                bad_r = bad.result(timeout=120)
                good_r = good.result(timeout=120)
            assert not bad_r.ok and "ZeroDivisionError" in bad_r.error
            assert good_r.ok
            outs.append(good_r)
            eng.shutdown()
        _agree(outs[0], outs[1], y)


# ------------------------------------------------------------------ spans
class TestSpans:
    """The port's own spans and ticket stamps (the JAX dispatcher has
    none to compare): ``batch`` and ``request_id`` join the dispatch
    thread's intake to the lane's engine spans of the same fire."""

    @pytest.fixture(autouse=True)
    def _tracer(self):
        prev = obs.set_enabled(True)
        tr = obs.get_tracer()
        tr.reserve(8192)
        tr.clear()
        yield tr
        obs.set_enabled(prev)

    def test_spans_link_intake_to_the_engine(self, rng, _tracer):
        import torch

        xd, _, _ = make_system(rng, 64, 8)
        xe, _, _ = make_system(rng, 64, 8)
        ys = [torch.from_numpy(np.asarray(y, np.float32)) for y in
              (xd @ rng.normal(size=8), xd @ rng.normal(size=8),
               xe @ rng.normal(size=8), xe @ rng.normal(size=8))]
        eng = _engine()
        with AsyncDispatcher(eng, DispatchConfig(
                max_batch=4, idle_timeout_s=1e9)) as disp:
            tickets = [disp.submit(_req(x, y, design_key=k))
                       for x, y, k in zip((xd, xd, xe, xe), ys,
                                          ("d", "d", "e", "e"))]
            served = [t.result(timeout=120) for t in tickets]
        eng.shutdown()
        assert all(r.ok for r in served)
        batch = tickets[0].batch
        assert {t.batch for t in tickets} == {batch}
        for t, r in zip(tickets, served):
            assert t.fire_reason == "full"
            assert t.submitted_at <= t.fired_at <= t.started_at
            assert t.started_at <= t.completed_at
            assert t.lane_wait_s >= 0
        spans = _tracer.spans()
        by_id = {s.span_id: s for s in spans}
        # Intake: one admit a request on the dispatch thread; y is in host
        # memory already, so no copy to the host opens inside it.
        for t in tickets:
            rid = t.request.request_id
            admit = [s for s in spans if s.name == "dispatch.admit"
                     and s.tags["request_id"] == rid]
            assert len(admit) == 1
            assert admit[0].thread == "serve-dispatch"
        assert not _tracer.spans("serve.y_to_host")
        # The fire: every span of the batch carries its number, and all
        # but the fan-out descend from the lane's solve_batch span.
        mine = [s for s in spans if s.tags.get("batch") == batch]
        names = [s.name for s in mine]
        for name, n in (("dispatch.solve_batch", 1), ("engine.flush", 1),
                        ("engine.fingerprint", 1), ("engine.group", 1),
                        ("engine.design", 2), ("engine.pad", 2),
                        ("engine.solve", 2), ("design.y_to_device", 2),
                        ("engine.call", 2), ("engine.sync", 2),
                        ("engine.strip", 2), ("engine.result_to_host", 2),
                        ("dispatch.complete", 1)):
            assert names.count(name) == n, (name, names)
        root = next(s for s in mine if s.name == "dispatch.solve_batch")
        assert root.tags["fire_reason"] == "full"
        assert root.tags["size"] == 4
        assert root.tags["lane_wait_s"] == pytest.approx(
            tickets[0].lane_wait_s)
        for s in mine:
            if s.name in ("dispatch.solve_batch", "dispatch.complete"):
                continue
            up = s
            while up.parent_id is not None:
                up = by_id[up.parent_id]
            assert up is root, s.name
        for s in mine:
            if s.name == "engine.call":
                assert by_id[s.parent_id].name == "engine.solve"
                assert s.tags["method"] == "bakp_gram"
            if s.name == "engine.result_to_host":
                assert by_id[s.parent_id].name == "engine.strip"
            # Each coalesced group stages its rows RHS-major (pageable
            # host memory off CUDA) and copies them in under its solve:
            # one (obs_p, k_pad) = (64, 2) fp32 block.
            if s.name == "engine.pad":
                assert s.tags["kind"] == "multi_rhs"
                assert s.tags["staging"] == "pageable"
            if s.name == "design.y_to_device":
                assert by_id[s.parent_id].name == "engine.solve"
                assert s.tags["bytes"] == 64 * 2 * 4
        # The copy spans carry their bytes: two (64, 2) fp32 y in, each
        # group's (8, 2) coefficients and (64, 2) residuals out.
        def tagged(name):
            return sum(s.tags["bytes"] for s in mine if s.name == name)

        assert tagged("design.y_to_device") == 2 * 64 * 2 * 4
        assert tagged("engine.result_to_host") == 2 * (8 * 2 + 64 * 2) * 4
        assert _tracer.dropped == 0

    def test_fire_reason_and_batch_numbers(self, rng, _tracer):
        x, y, _ = make_system(rng, 40, 4)
        eng = _engine()
        with AsyncDispatcher(eng, DispatchConfig(
                max_batch=8, idle_timeout_s=0.005)) as disp:
            idle = disp.submit(_req(x, y, design_key="d"))
            idle.result(timeout=120)
            disp.config.idle_timeout_s = 1e9
            late = [disp.submit(_req(x, y, design_key="d"))
                    for _ in range(2)]
            disp.drain()
            [t.result(timeout=120) for t in late]
        eng.shutdown()
        assert idle.fire_reason == "idle"
        assert [t.fire_reason for t in late] == ["drain", "drain"]
        assert late[0].batch == late[1].batch == idle.batch + 1
        assert disp.stats.fired_idle == 1 and disp.stats.fired_drain == 1
        for t in [idle] + late:
            assert t.lane_wait_s is not None and t.lane_wait_s >= 0
        reasons = {s.tags["batch"]: s.tags["fire_reason"]
                   for s in _tracer.spans("dispatch.solve_batch")}
        assert reasons == {idle.batch: "idle", late[0].batch: "drain"}
