"""Execution lanes of the port: routing, executor semantics, and the
engine's lanes against its serial lane.

Mirrors ``tests/test_lanes.py`` (all but the dispatcher classes — the
async dispatcher is a later slice — and the mesh cases: mesh placements
raise until the multi-GPU slice, which is what ``TestMeshRaises`` holds).
Lane labels and routing are held to ``repro.serve``'s; the engine runs
with ``device="cpu"``, where a lane is a thread (on the card it is a
thread and a CUDA stream: ``tests/test_torch_cuda.py``).
"""
import threading

import numpy as np
import pytest

import repro.serve as J
from conftest import make_system
from repro_torch import obs
from repro_torch.core.spec import UnsupportedSpecError, solver_method
from repro_torch.serve import (LaneKey, LanePool, LaneShutdown, LaneWork,
                               Placement, PlacementPolicy, ServeConfig,
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
    def test_sharded_placements_raise(self):
        with pytest.raises(UnsupportedSpecError, match="multi-GPU"):
            lane_for("bakp", Placement("obs_sharded"), device="cpu")
        with pytest.raises(UnsupportedSpecError, match="multi-GPU"):
            build_serve_mesh("4x2")
        with pytest.raises(UnsupportedSpecError, match="multi-GPU"):
            placement_for_bucket((64, 8), "bakp", PlacementPolicy(),
                                 smesh=object())
        with pytest.raises(UnsupportedSpecError, match="multi-GPU"):
            placement_for_group(Placement(), 64, PlacementPolicy(),
                                smesh=object())

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
