"""Execution lanes of the port: routing, executor semantics, and the
engine's lanes against its serial lane.

Mirrors ``tests/test_lanes.py``, its mesh cases on one-shard CPU meshes
(``TestMeshLanes``, ``TestUnshardableFusedFallback``); ``TestMeshRaises``
holds what a mesh refuses; ``TestDispatcherLanes`` drives the port's async
dispatcher over the lanes, its answers held to the planted coefficients
and its lane labels to JAX's dispatcher's.
Lane labels and routing are held to ``repro.serve``'s; the engine runs
with ``device="cpu"``, where a lane is a thread (on the card it is a
thread and a CUDA stream: ``tests/test_torch_cuda.py``).
"""
import threading
import time

import numpy as np
import pytest

import repro.serve as J
from conftest import make_system
from repro_torch import obs
from repro_torch.core.spec import solver_method
from repro_torch.serve import (AsyncDispatcher, DispatchConfig,
                               DispatcherStopped, LaneKey, LanePool,
                               LaneShutdown, LaneWork, Placement,
                               PlacementPolicy, QueueFullError, ServeConfig,
                               SolveRequest, SolverServeEngine,
                               build_serve_mesh, current_lane, lane_for,
                               placement_for_bucket, placement_for_group)
from repro_torch.serve.lanes import SERIAL_LANE


def _req(x, y, **kw):
    kw.setdefault("max_iter", 40)
    kw.setdefault("rtol", 1e-12)
    return SolveRequest(x=x, y=y, **kw)


# ------------------------------------------------------------ routing (pure)
class TestLaneRouting:
    @pytest.mark.parametrize("method", ["bak", "bakp", "bakp_gram",
                                        "bakp_fused", "bak_fused",
                                        "bakp_stream", "lstsq", "normal",
                                        "bakf"])
    def test_registry_lane_capability_matches_reference(self, method):
        from repro.core.spec import solver_method as j_solver_method

        assert solver_method(method).lane == j_solver_method(method).lane
        assert (Placement().lane_key(method)
                == J.Placement().lane_key(method))

    def test_placement_lane_key(self):
        assert Placement().lane_key("bakp_gram") == "single:xla"
        assert Placement().lane_key("bakp_fused") == "single:fused"
        assert Placement().lane_key("bakp_stream") == "single:stream"
        assert Placement().lane_key("not_registered") == "single:xla"
        assert (Placement("obs_sharded").lane_key("bakp")
                == "mesh:obs_sharded")

    def test_mesh_lane_owns_the_mesh_devices(self):
        smesh = build_serve_mesh("4x2", device="cpu")
        key = lane_for("bakp", Placement("obs_sharded"), device="cpu",
                       smesh=smesh)
        assert key.label == "mesh:obs_sharded"
        assert key.devices == ("cpu",) * 8
        # without a mesh a sharded placement keeps its label, on the device
        assert lane_for("bakp", Placement("obs_sharded"),
                        device="cpu").devices == ("cpu",)
        pool = LanePool(device="cpu")
        assert pool.lane_for("bakp", Placement("rhs_sharded"), smesh) == \
            LaneKey("mesh:rhs_sharded", ("cpu",) * 8)
        assert pool.executor(pool.lane_for(
            "bakp", Placement("rhs_sharded"), smesh)).streams == []

    def test_lane_for_labels_and_devices(self):
        xla = lane_for("bakp_gram", device="cpu")
        fused = lane_for("bakp_fused", device="cpu")
        assert xla.label == "single:xla" and fused.label == "single:fused"
        assert xla != fused
        assert xla.devices == ("cpu",)
        assert lane_for("bakp_gram", device="cpu") == xla
        assert lane_for("bakp_gram").devices == ("cuda",)  # port default

    def test_serial_pool_collapses_everything(self):
        pool = LanePool(serial=True, device="cpu")
        assert pool.lane_for("bakp_gram") == SERIAL_LANE
        assert pool.lane_for("bakp_fused") == SERIAL_LANE


class TestMeshRaises:
    def test_sharded_placements_raise(self, monkeypatch):
        # A mesh of distinct cards needs that many: it never falls back to
        # the CPU or repeats a device it was not given.
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(ValueError, match="needs 8 CUDA devices"):
            build_serve_mesh("4x2")
        with pytest.raises(ValueError, match="'D' or 'DxM'"):
            build_serve_mesh("2x2x2", device="cpu")
        with pytest.raises(ValueError, match="needs 4 devices, got 2"):
            build_serve_mesh("4", devices=["cpu", "cpu"])
        with pytest.raises(TypeError, match="ServeMesh"):
            SolverServeEngine(mesh=object(), device="cpu")

    def test_single_device_placements(self):
        assert placement_for_bucket((1 << 12, 1 << 10), "bakp",
                                    PlacementPolicy(obs_shard_min_cells=1),
                                    None) == Placement("single")
        assert placement_for_group(Placement(), 64, PlacementPolicy(),
                                   None) == Placement("single")


# ----------------------------------------------------- executor (no devices)
class TestLaneExecutor:
    def test_urgency_orders_queue(self):
        pool = LanePool(registry=obs.MetricsRegistry())
        key = LaneKey("single:test")
        order = []
        gate, started = threading.Event(), threading.Event()
        first = pool.submit(key, LaneWork(
            lambda: (started.set(), gate.wait()), size=0))
        # The lane is inside the first work before the others queue.
        assert started.wait(10.0)
        works = [pool.submit(key, LaneWork(lambda u=u: order.append(u),
                                           urgency=u))
                 for u in (30.0, 10.0, 20.0)]
        gate.set()
        for w in works:
            assert w.wait(10.0)
        assert order == [10.0, 20.0, 30.0]
        assert first.done() and first.error is None
        stats = pool.stats()["single:test"]
        assert stats["batches"] == 4
        assert stats["max_queue_depth"] >= 3
        pool.shutdown()

    def test_error_lands_on_work_not_thread(self):
        pool = LanePool(registry=obs.MetricsRegistry())
        key = LaneKey("single:test")

        def boom():
            raise ValueError("boom")

        bad = pool.submit(key, LaneWork(boom))
        good = pool.submit(key, LaneWork(lambda: None))
        assert bad.wait(10.0) and good.wait(10.0)
        assert isinstance(bad.error, ValueError)
        assert good.error is None
        assert pool.stats()["single:test"]["failures"] == 1
        pool.shutdown()

    def test_current_lane_marks_executor_thread(self):
        pool = LanePool(registry=obs.MetricsRegistry(), device="cpu")
        key = LaneKey("single:test", ("cpu",))
        seen = []
        w = pool.submit(key, LaneWork(lambda: seen.append(current_lane())))
        assert w.wait(10.0)
        assert seen == [key]
        assert current_lane() is None
        assert pool.executor(key).stream is None  # no stream off the card
        pool.shutdown()

    def test_shutdown_abandons_queued_work(self):
        pool = LanePool(registry=obs.MetricsRegistry())
        key = LaneKey("single:test")
        gate = threading.Event()
        running = pool.submit(key, LaneWork(gate.wait, size=0))
        queued = [pool.submit(key, LaneWork(lambda: None)) for _ in range(3)]
        gate.set()
        pool.shutdown(drain=False)
        assert running.wait(10.0)
        for w in queued:
            assert w.wait(10.0)
            assert (w.error is None
                    or isinstance(w.error, LaneShutdown))
        again = pool.submit(key, LaneWork(lambda: None))
        assert again.wait(10.0) and again.error is None
        pool.shutdown()

    def test_counted_under_contention(self):
        """More workers than cores submitting to one lane: every work runs
        exactly once and the lane's counters agree (no lost update)."""
        import sys

        pool = LanePool(registry=obs.MetricsRegistry())
        key = LaneKey("single:test")
        ran = []
        lock = threading.Lock()

        def work(i):
            with lock:
                ran.append(i)

        prev = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            works, wlock = [], threading.Lock()

            def submitter(s):
                for i in range(25):
                    w = pool.submit(key, LaneWork(lambda i=(s, i): work(i)))
                    with wlock:
                        works.append(w)

            threads = [threading.Thread(target=submitter, args=(s,))
                       for s in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30.0)
            assert not any(t.is_alive() for t in threads)
            for w in works:
                assert w.wait(30.0)
        finally:
            sys.setswitchinterval(prev)
        assert sorted(ran) == sorted((s, i) for s in range(16)
                                     for i in range(25))
        assert pool.stats()["single:test"]["batches"] == 400
        assert pool.executor(key).inflight == 0
        pool.shutdown()


# ------------------------------------------------------------ engine parity
class TestEngineLaneParity:
    def _workload(self, rng, n=6):
        reqs = []
        for i in range(n):
            x, y, _ = make_system(rng, 96, 12)
            method = "bakp_fused" if i % 3 == 0 else "bakp_gram"
            reqs.append(_req(x, y, method=method, thr=8,
                             design_key=f"lane-{i}", request_id=f"r-{i}"))
        return reqs

    def test_mixed_lanes_bitwise_match_serial(self):
        lane_eng = SolverServeEngine(ServeConfig(), device="cpu",
                                     registry=obs.MetricsRegistry())
        serial_eng = SolverServeEngine(ServeConfig(lane_execution=False),
                                       device="cpu",
                                       registry=obs.MetricsRegistry())
        r_lane = lane_eng.serve(self._workload(np.random.default_rng(3)))
        r_serial = serial_eng.serve(self._workload(np.random.default_rng(3)))
        assert not [r.error for r in r_lane + r_serial if r.error]
        for a, b in zip(r_lane, r_serial):
            assert np.array_equal(a.coef, b.coef), a.request_id
            assert a.n_sweeps == b.n_sweeps
        assert set(lane_eng.lanes.stats()) == {"single:xla", "single:fused"}
        assert set(serial_eng.lanes.stats()) == {"serial"}
        assert {r.telemetry.lane for r in r_lane} == {"single:xla",
                                                      "single:fused"}
        assert {r.telemetry.lane for r in r_serial} == {"serial"}
        lat = lane_eng.registry.get("serve_solve_latency_seconds")
        assert lat.count(lane="single:fused") >= 1
        assert lat.count(lane="single:xla") >= 1
        g = lane_eng.registry.get("serve_lane_inflight")
        assert g.value(lane="single:xla") == 0
        lane_eng.shutdown()
        serial_eng.shutdown()

    def test_lanes_match_reference_engine(self):
        """The same mix against JAX's engine: its "bakp_gram" requests as
        JAX batches them, its fused ones against JAX's "bakp" served singly
        (JAX's fused kernels cannot run here)."""
        t_eng = SolverServeEngine(ServeConfig(), device="cpu",
                                  registry=obs.MetricsRegistry())
        t_out = t_eng.serve(self._workload(np.random.default_rng(4)))
        reqs = self._workload(np.random.default_rng(4))
        fused = [r.method == "bakp_fused" for r in reqs]
        j_out = {}
        for want, cfg in ((False, {}), (True, {"vmap_batch": False})):
            j_eng = J.SolverServeEngine(J.ServeConfig(**cfg))
            sub = [(i, r) for i, r in enumerate(reqs) if fused[i] == want]
            outs = j_eng.serve([J.SolveRequest(
                x=r.x, y=r.y, thr=8, max_iter=40, rtol=1e-12,
                method="bakp" if want else r.method,
                design_key=r.design_key) for _, r in sub])
            j_out.update({i: o for (i, _), o in zip(sub, outs)})
            j_eng.shutdown()
        for i, t in enumerate(t_out):
            j = j_out[i]
            assert t.batch_kind == ("single" if fused[i] else "vmap")
            assert t.batch_kind == j.batch_kind
            scale = max(1.0, float(np.abs(j.coef).max()))
            assert float(np.abs(t.coef - j.coef).max()) <= 1e-5 * scale
        t_eng.shutdown()


# ------------------------------------------------------------- mesh lanes
class TestMeshLanes:
    def test_one_device_mesh_lane(self, rng):
        """A one-shard CPU mesh runs the mesh lane (and the handle's
        sharded copy) against the serial single-device engine."""
        policy = PlacementPolicy(obs_shard_min_cells=128 * 16)
        mesh_eng = SolverServeEngine(
            ServeConfig(placement_policy=policy),
            mesh=build_serve_mesh("1", device="cpu"),
            registry=obs.MetricsRegistry())
        serial_eng = SolverServeEngine(ServeConfig(), device="cpu",
                                       registry=obs.MetricsRegistry())
        assert mesh_eng.device.type == "cpu"  # the mesh's first device

        def work(seed):
            r = np.random.default_rng(seed)
            reqs = []
            for i in range(2):  # big bucket -> obs_sharded on the mesh
                x, y, _ = make_system(r, 200, 16)
                reqs.append(_req(x, y, method="bakp_gram", thr=16,
                                 design_key=f"big-{i}",
                                 request_id=f"big-{i}"))
            for i in range(2):  # small bucket -> single lane
                x, y, _ = make_system(r, 40, 8)
                reqs.append(_req(x, y, method="bakp_gram", thr=8,
                                 design_key=f"small-{i}",
                                 request_id=f"small-{i}"))
            return reqs

        r_mesh = mesh_eng.serve(work(11))
        r_single = serial_eng.serve(work(11))
        assert not [r.error for r in r_mesh + r_single if r.error]
        assert {r.placement for r in r_mesh} == {"obs_sharded", "single"}
        for m, s in zip(r_mesh, r_single):
            denom = np.maximum(np.abs(s.coef), 1e-12)
            assert float(np.mean(np.abs(m.coef - s.coef) / denom)) <= 1e-5
        assert "mesh:obs_sharded" in mesh_eng.lanes.stats()
        assert mesh_eng.stats.sharded_solves == 2
        # the design entries remember their home + resident lanes
        entry = mesh_eng.cache.get("big-0", record_stats=False)
        assert entry.home == "obs_sharded"
        assert "obs_sharded" in entry.resident_lanes()
        mesh_eng.shutdown()
        serial_eng.shutdown()


# ------------------------------------------------- the dispatcher on lanes
def _cpu_engine(**cfg):
    return SolverServeEngine(ServeConfig(**cfg), device="cpu",
                             registry=obs.MetricsRegistry())


class TestDispatcherLanes:
    def test_concurrent_submitters_mixed_lanes(self, rng):
        """Racing submitters over single:xla, single:fused and batch
        traffic: every ticket lands, per-lane stats populate, answers stay
        correct."""
        eng = _cpu_engine()
        cfg = DispatchConfig(max_batch=8, idle_timeout_s=0.005,
                             prewarm_cache=True)
        n_sub, per = 4, 12
        systems = {}
        r = np.random.default_rng(21)
        for s in range(n_sub):
            for i in range(per):
                method = "bakp_fused" if (s + i) % 3 == 0 else "bakp_gram"
                x = r.normal(size=(80, 10)).astype(np.float32)
                a = r.normal(size=(10,)).astype(np.float32)
                systems[(s, i)] = (x, x @ a, a, method)
        tickets = {}
        tlock = threading.Lock()
        errs = []

        def submitter(s, disp):
            try:
                for i in range(per):
                    x, y, _, method = systems[(s, i)]
                    t = disp.submit(_req(
                        x, y, method=method, thr=8,
                        design_key=f"d-{s}-{i}", request_id=f"q-{s}-{i}"))
                    with tlock:
                        tickets[(s, i)] = t
            except Exception as exc:  # surfaced below
                errs.append(exc)

        with AsyncDispatcher(eng, cfg) as disp:
            threads = [threading.Thread(target=submitter, args=(s, disp))
                       for s in range(n_sub)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            assert not any(t.is_alive() for t in threads)
            assert not errs
            results = {k: t.result(timeout=120.0)
                       for k, t in tickets.items()}
        assert len(results) == n_sub * per
        for (s, i), res in results.items():
            _, _, a, method = systems[(s, i)]
            denom = np.maximum(np.abs(a), 1e-12)
            assert float(np.mean(np.abs(res.coef - a) / denom)) <= 1e-4
            assert res.telemetry.lane == (
                "single:fused" if method == "bakp_fused" else "single:xla")
        assert disp.inflight == 0
        # both single-device lanes fired, and the dispatcher + engine agree
        assert {"single:xla", "single:fused"} <= set(disp.stats.lane_batches)
        lanes = eng.lanes.stats()
        assert {"single:xla", "single:fused"} <= set(lanes)
        assert (sum(ls["requests"] for ls in lanes.values())
                >= n_sub * per)
        eng.shutdown()

    def test_stop_no_drain_orphans_nothing(self, rng):
        eng = _cpu_engine()
        # Huge idle timeout: batches only fire on the drain/stop path, so
        # tickets are still pending when stop(drain=False) lands.
        cfg = DispatchConfig(idle_timeout_s=1e9, max_batch=1000,
                             prewarm_cache=False)
        disp = AsyncDispatcher(eng, cfg).start()
        x, y, _ = make_system(rng, 40, 8)
        tickets = [disp.submit(_req(x, y, thr=8, design_key="d",
                                    request_id=f"s-{i}"))
                   for i in range(8)]
        disp.stop(drain=False)
        for t in tickets:
            assert t.done(), "orphaned ticket after stop(drain=False)"
            with pytest.raises(DispatcherStopped):
                t.result(timeout=0)
        assert disp.inflight == 0
        eng.shutdown()

    def test_stop_drain_serves_everything(self, rng):
        eng = _cpu_engine()
        cfg = DispatchConfig(idle_timeout_s=1e9, max_batch=1000,
                             prewarm_cache=False)
        disp = AsyncDispatcher(eng, cfg).start()
        x, y, a = make_system(rng, 40, 8)
        tickets = [disp.submit(_req(x, y, thr=8, design_key="d",
                                    request_id=f"t-{i}"))
                   for i in range(4)]
        disp.stop(drain=True)
        for t in tickets:
            assert t.done()
            assert t.result(timeout=0).ok  # served, not failed
        assert disp.stats.fired_drain == 1
        eng.shutdown()

    def test_fires_without_polling(self, rng):
        """Idle and deadline firing rely on the computed wakeup: with the
        unused poll interval set absurdly high, batches still fire on
        time."""
        eng = _cpu_engine()
        x, y, _ = make_system(rng, 40, 8)
        eng.serve([_req(x, y, thr=8, design_key="w")])
        cfg = DispatchConfig(idle_timeout_s=0.01, max_batch=1000,
                             poll_interval_s=1e6, prewarm_cache=False)
        with AsyncDispatcher(eng, cfg) as disp:
            t0 = time.perf_counter()
            t = disp.submit(_req(x, y, thr=8, design_key="w"))
            t.result(timeout=30.0)
            assert time.perf_counter() - t0 < 5.0
        cfg = DispatchConfig(idle_timeout_s=1e9, max_batch=1000,
                             deadline_margin_s=0.25,
                             poll_interval_s=1e6, prewarm_cache=False)
        with AsyncDispatcher(eng, cfg) as disp:
            t0 = time.perf_counter()
            t = disp.submit(_req(x, y, thr=8, design_key="w"),
                            deadline_s=0.3)
            t.result(timeout=30.0)
            assert time.perf_counter() - t0 < 5.0
        eng.shutdown()

    def test_per_lane_backpressure_rejects(self, rng):
        eng = _cpu_engine()
        cfg = DispatchConfig(idle_timeout_s=1e9, max_batch=1000,
                             max_lane_inflight=2, backpressure="reject",
                             prewarm_cache=False)
        disp = AsyncDispatcher(eng, cfg).start()
        x, y, _ = make_system(rng, 40, 8)
        for i in range(2):
            disp.submit(_req(x, y, thr=8, design_key="bp",
                             request_id=f"bp-{i}"))
        # the lane JAX's dispatcher names for the same request
        jlane = J.AsyncDispatcher(J.SolverServeEngine())._lane_label_of(
            J.SolveRequest(x=x, y=y, thr=8, max_iter=40, rtol=1e-12))
        assert jlane == "single:xla"
        with pytest.raises(QueueFullError, match=f"lane {jlane}"):
            disp.submit(_req(x, y, thr=8, design_key="bp",
                             request_id="bp-over"))
        disp.stop(drain=True)
        # completions released the lane budget
        assert disp._lane_inflight == {}
        eng.shutdown()


# ----------------------------------------------- prefer_fused on one device
class TestPreferFused:
    def test_single_engine_upgrades(self, rng):
        eng = SolverServeEngine(ServeConfig(prefer_fused=True), device="cpu",
                                registry=obs.MetricsRegistry())
        x, y, _ = make_system(rng, 40, 8)
        spec = eng.spec_for(_req(x, y, method="bakp", thr=8, max_iter=4),
                            record=True)
        assert spec.method == "bakp_fused"
        assert eng.registry.get(
            "solver_fallback_total").value(reason="unshardable_fused") == 0
        eng.shutdown()

    def test_over_budget_keeps_bakp(self, rng, monkeypatch):
        import importlib

        cd_sweep = importlib.import_module("repro_torch.kernels.cd_sweep")
        monkeypatch.setattr(cd_sweep, "ON_CHIP_BUDGET_BYTES", 1024)
        eng = SolverServeEngine(ServeConfig(prefer_fused=True), device="cpu",
                                registry=obs.MetricsRegistry())
        x, y, _ = make_system(rng, 40, 8)
        spec = eng.spec_for(_req(x, y, method="bakp", thr=8, max_iter=4))
        assert spec.method == "bakp"
        eng.shutdown()


# ----------------------------------------------- prefer_fused mesh fallback
class TestUnshardableFusedFallback:
    # (the single-device engine's upgrade: TestPreferFused)
    def test_mesh_engine_counts_and_logs_once(self, rng, caplog):
        eng = SolverServeEngine(ServeConfig(prefer_fused=True),
                                mesh=build_serve_mesh("1", device="cpu"),
                                registry=obs.MetricsRegistry())
        x, y, _ = make_system(rng, 40, 8)
        req = _req(x, y, method="bakp", thr=8, max_iter=4)
        with caplog.at_level("WARNING",
                             logger="repro_torch.serve.engine"):
            s1 = eng.spec_for(req, record=True)
            s2 = eng.spec_for(req, record=True)
        assert s1.method == "bakp" and s2.method == "bakp"  # no upgrade
        ctr = eng.registry.get("solver_fallback_total")
        assert ctr.value(reason="unshardable_fused") == 2
        warnings = [r for r in caplog.records
                    if "prefer_fused" in r.getMessage()]
        assert len(warnings) == 1  # one-time log
        eng.shutdown()


# ----------------------------------------------------------- launch counts
class TestLaunchCounts:
    def test_count_launch_loses_nothing_under_threads(self):
        """The kernels' launch counter is a read-modify-write taken under a
        lock: 16 threads counting at a shortened switch interval lose no
        count."""
        import sys

        from repro_torch.kernels import _build

        key = "test_probe"
        prev = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: [
                _build.count_launch(key) for _ in range(2000)])
                for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
            assert not any(t.is_alive() for t in threads)
            assert _build.LAUNCHES[key] == 16 * 2000
        finally:
            sys.setswitchinterval(prev)
            _build.LAUNCHES.pop(key, None)
