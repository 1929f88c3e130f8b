"""repro_torch.resilience and the port engine's failure paths, against the
JAX package's: the fault harness, the ladder policy, supervised lanes and
the engine's retry ladder.

Mirrors ``tests/test_resilience.py``, ``TestTicketCancel`` (the async
dispatcher's ticket hygiene) and ``TestCrashSafeStore`` (CRC-headered tile
files, quarantine, rebuild) included.  The harness and ladder are held to
``repro.resilience`` on the same inputs, the crash-safe store to JAX's
``DesignStore`` driven alike (the same tiers, stats and counters); the
engine runs with ``device="cpu"``.
"""
import json
import time
import zlib

import numpy as np
import pytest

import repro.resilience as jres
import repro.serve as J
from conftest import make_system
from repro import obs as jobs
from repro.core.spec import SolverSpec as JSpec
from repro.store import DesignStore as JDesignStore
from repro.store.store import TileCorruptionError as JTileCorruptionError
from repro_torch import obs
from repro_torch.core.spec import SolverSpec, method_names
from repro_torch.resilience import (FaultInjected, FaultPlan, backoff_s,
                                    faults, installed, next_rung, rungs)
from repro_torch.serve import (AsyncDispatcher, DispatchConfig, LaneKey,
                               LanePool, LaneShutdown, LaneWork,
                               LaneWorkerDeath, ServeConfig, SolveRequest,
                               SolverServeEngine, TicketCancelled)
from repro_torch.serve.lanes import SERIAL_LANE
from repro_torch.store import DesignStore
from repro_torch.store.store import (TileCorruptionError, _TILE_HEADER,
                                     _TILE_MAGIC)


@pytest.fixture(autouse=True)
def _disarmed():
    """Never leak an armed plan into (or out of) a test (either
    package's)."""
    faults.clear()
    jres.faults.clear()
    yield
    faults.clear()
    jres.faults.clear()


def _req(x, y, **kw):
    kw.setdefault("max_iter", 40)
    kw.setdefault("rtol", 1e-12)
    return SolveRequest(x=x, y=y, **kw)


def _engine(**kw):
    return SolverServeEngine(ServeConfig(**kw),
                             registry=obs.MetricsRegistry(), device="cpu")


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


def _mape(coef, a):
    denom = np.maximum(np.abs(a), 1e-12)
    return float(np.mean(np.abs(coef - a) / denom))


# ------------------------------------------------------------ fault harness
class TestFaultPlan:
    def test_sites_match_reference(self):
        assert faults.SITES == jres.SITES

    def test_unknown_site_rejected(self):
        with pytest.raises(ValueError, match="unknown fault site"):
            FaultPlan().add("lane.wrong")

    def test_coerce_dict_json_file_and_passthrough(self, tmp_path):
        spec = {"solver.raise": {"count": 2, "match": "bakp"}}
        for obj in (spec, json.dumps(spec)):
            rule = FaultPlan.coerce(obj).rules["solver.raise"]
            assert rule.count == 2 and rule.match == "bakp"
        p = tmp_path / "plan.json"
        p.write_text(json.dumps(spec))
        assert FaultPlan.coerce(str(p)).rules["solver.raise"].count == 2
        plan = FaultPlan(spec)
        assert FaultPlan.coerce(plan) is plan
        with pytest.raises(ValueError, match="JSON object"):
            FaultPlan.from_json("[1, 2]")
        with pytest.raises(TypeError):
            FaultPlan.coerce(42)

    def test_count_skip_match_semantics_match_reference(self):
        hits = ["lstsq", "bakp", "bakp", "bakp_gram", "bakp", "bakp"]
        out = {}
        for name, mod in (("port", faults), ("jax", jres.faults)):
            plan = mod.FaultPlan()
            plan.add("solver.raise", count=2, skip=1, match="bakp")
            out[name] = ([plan.hit("solver.raise", t) is not None
                          for t in hits], plan.counts())
        assert out["port"] == out["jax"]
        assert out["port"][0] == [False, False, True, True, False, False]
        assert out["port"][1]["solver.raise"] == {"seen": 5, "fired": 2}

    def test_disarmed_hooks_are_noops(self):
        assert faults.active() is None
        assert faults.hit("solver.raise", "bakp") is None
        faults.maybe_raise("solver.raise", "bakp")
        assert not faults.maybe_delay("store.read_delay", "k")

    def test_installed_context_arms_and_disarms(self):
        with installed({"solver.raise": {"count": 1}}) as plan:
            assert faults.active() is plan
            with pytest.raises(FaultInjected, match="solver.raise"):
                faults.maybe_raise("solver.raise", "bakp")
        assert faults.active() is None


# ------------------------------------------------------------ ladder policy
class TestLadder:
    def test_precision_degrades_before_method(self):
        rung = next_rung(SolverSpec(method="bakp_fused", precision="bf16"))
        assert rung.method == "bakp_fused" and rung.precision == "fp32"

    @pytest.mark.parametrize("method", ["bak", "bakp", "bakp_gram",
                                        "bakp_fused", "bak_fused",
                                        "bakp_stream", "lstsq", "normal",
                                        "bakf"])
    def test_chain_matches_reference(self, method):
        assert method in method_names()
        for precision in ("fp32", "bf16"):
            kw = {} if precision == "fp32" else {"precision": precision}
            port = [(s.method, s.precision)
                    for s in rungs(SolverSpec(method=method, **kw))]
            ref = [(s.method, s.precision)
                   for s in jres.rungs(JSpec(method=method, **kw))]
            assert port == ref, (method, precision)

    def test_registry_chain_bottoms_at_lstsq(self):
        chain = [s.method for s in rungs(SolverSpec(method="bakp_fused"))]
        assert chain == ["bakp", "bakp_stream", "lstsq"]
        assert [s.method for s in rungs(SolverSpec(method="bak_fused"))] \
            == ["bak", "lstsq"]
        assert rungs(SolverSpec(method="lstsq")) == []

    def test_backoff_bounded_and_jittered(self):
        assert backoff_s(0, 0.0) == 0.0
        for attempt in range(8):
            d = backoff_s(attempt, 0.002, cap=0.05)
            assert 0.0 < d <= 0.05 * 1.5


# --------------------------------------------------- supervised lanes (pure)
class TestLaneSupervision:
    def test_worker_death_fails_only_inflight_and_restarts(self):
        reg = obs.MetricsRegistry()
        pool = LanePool(registry=reg)
        key = LaneKey("single:test")
        with installed({"lane.worker": {"count": 1, "match": "single:test"}}):
            dead = pool.submit(key, LaneWork(lambda: None))
            assert dead.wait(10.0)
            assert isinstance(dead.error, LaneWorkerDeath)
            assert isinstance(dead.error.__cause__, FaultInjected)
            ok = pool.submit(key, LaneWork(lambda: None))
            assert ok.wait(10.0) and ok.error is None
        stats = pool.stats()["single:test"]
        assert stats["restarts"] == 1 and stats["failures"] == 1
        assert not stats["tripped"]
        assert reg.get("serve_lane_restarts_total").value(
            lane="single:test") == 1
        assert _wait_for(lambda: reg.get("serve_lane_health").value(
            lane="single:test") == 1.0)
        pool.shutdown()

    def test_circuit_breaker_trips_to_serial(self):
        reg = obs.MetricsRegistry()
        pool = LanePool(registry=reg, max_restarts=0)
        key = LaneKey("single:test")
        ran = []
        with installed({"lane.worker": {"count": 0, "match": "single:test"}}):
            first = pool.submit(key, LaneWork(lambda: ran.append("w0")))
            assert first.wait(10.0)
            assert isinstance(first.error, LaneWorkerDeath)
            assert _wait_for(lambda: pool.executor(key).tripped)
            works = [pool.submit(key, LaneWork(lambda i=i: ran.append(i)))
                     for i in range(3)]
            for w in works:
                assert w.wait(10.0) and w.error is None
        assert sorted(ran) == [0, 1, 2]
        assert pool.stats()["single:test"]["tripped"]
        assert reg.get("serve_lane_health").value(lane="single:test") == 0.0
        assert pool.stats()[SERIAL_LANE.label]["requests"] == 3
        with pytest.raises(LaneShutdown):
            pool.executor(key).submit(LaneWork(lambda: None))
        pool.shutdown()

    def test_engine_survives_lane_death(self):
        eng = _engine()
        systems = [make_system(np.random.default_rng(40 + i), 64, 16)
                   for i in range(4)]
        with installed({"lane.worker": {"count": 1, "match": "single:"}}):
            out = eng.serve([
                _req(x, y, method="bakp_gram", thr=8, design_key=f"ld{i}",
                     request_id=f"ld{i}")
                for i, (x, y, _) in enumerate(systems)])
        failed = [r for r in out if r.error]
        assert failed, "the injected worker death must fail its unit"
        assert all("LaneWorkerDeath" in r.error for r in failed)
        again = eng.serve([
            _req(x, y, method="bakp_gram", thr=8, design_key=f"ld{i}")
            for i, (x, y, _) in enumerate(systems)])
        assert not [r.error for r in again if r.error]
        assert eng.registry.get("serve_lane_restarts_total").value(
            lane="single:xla") == 1
        eng.shutdown()


# -------------------------------------------------------- engine ladder
class TestRetryLadder:
    def test_raised_solve_retries_to_success(self, rng):
        eng = _engine()
        x, y, a = make_system(rng, 64, 16)
        with installed({"solver.raise": {"count": 1}}):
            [res] = eng.serve([_req(x, y, method="bakp_gram", thr=8,
                                    design_key="rl")])
        assert res.ok and res.retries == 1
        assert res.telemetry is not None and res.telemetry.retries == 1
        assert eng.stats.retries == 1
        ctr = eng.registry.get("solver_retries_total")
        assert ctr.value(reason="raise", from_path="bakp_gram",
                         to_path="bakp") == 1
        assert _mape(res.coef, a) <= 1e-4
        eng.shutdown()

    def test_fused_raise_falls_to_plain_bakp(self, rng):
        """The fused kernel's rung raising retries on the plain "bakp"
        rung of the same iterate: served, and the kernel path reported is
        the plain family's."""
        eng = _engine()
        x, y, a = make_system(rng, 64, 16)
        with installed({"solver.raise": {"count": 1,
                                         "match": "bakp_fused"}}):
            [res] = eng.serve([_req(x, y, method="bakp_fused", thr=8,
                                    design_key="fr")])
        assert res.ok and res.retries == 1
        assert res.telemetry.kernel_path == "xla"
        assert res.telemetry.method == "bakp"
        assert eng.registry.get("solver_retries_total").value(
            reason="raise", from_path="bakp_fused", to_path="bakp") == 1
        assert _mape(res.coef, a) <= 1e-4
        eng.shutdown()

    @pytest.mark.parametrize("n", [1, 3])
    def test_kernel_error_is_not_retried(self, rng, monkeypatch, n):
        """A kernel that fails to build or launch (``KernelError``) fails
        its batch at once, single or coalesced: no rung of the ladder
        serves it, and the other batches of the flush still run."""
        from repro_torch.kernels._build import KernelError

        eng = _engine(prefer_fused=True)
        call = eng._call_solver

        def broken(spec, *args, **kw):
            if spec.method == "bakp_fused":
                raise KernelError("bakp_fused_launch failed with "
                                  "cudaError_t 98")
            return call(spec, *args, **kw)

        monkeypatch.setattr(eng, "_call_solver", broken)
        x, y, a = make_system(rng, 64, 16)
        out = eng.serve([_req(x, y, method="bakp", thr=8, design_key="ke")
                         for _ in range(n)]
                        + [_req(x, y, method="bakp_gram", thr=8,
                                design_key="ke")])
        assert all(not r.ok and "KernelError" in r.error and r.retries == 0
                   for r in out[:n])
        assert out[n].ok and _mape(out[n].coef, a) <= 1e-4
        assert eng.stats.retries == 0 and eng.stats.failures == n
        assert eng.registry.get("solver_retries_total").value() == 0
        eng.shutdown()

    def test_ladder_off_returns_typed_error(self, rng):
        eng = _engine(retry_ladder=False)
        x, y, _ = make_system(rng, 64, 16)
        with installed({"solver.raise": {"count": 1}}):
            [res] = eng.serve([_req(x, y, method="bakp_gram", thr=8,
                                    design_key="off")])
        assert not res.ok and res.retries == 0
        assert "FaultInjected" in res.error
        assert eng.stats.retries == 0
        eng.shutdown()

    def test_expired_deadline_bounds_the_ladder(self, rng):
        eng = _engine()
        x, y, _ = make_system(rng, 64, 16)
        req = _req(x, y, method="bakp_gram", thr=8, design_key="dl")
        req.deadline_at = obs.now() - 1.0
        with installed({"solver.raise": {"count": 1}}):
            [res] = eng.serve([req])
        assert not res.ok and "FaultInjected" in res.error
        assert eng.stats.retries == 0
        eng.shutdown()

    def test_forced_diverge_cold_retries_then_falls_back(self, rng):
        eng = _engine(max_retries=2)
        x, y, _ = make_system(rng, 64, 16)
        [warm] = eng.serve([_req(x, y, method="bakp_gram", thr=8,
                                 design_key="fd", tenant_id="t")])
        assert warm.ok
        with installed({"solver.diverge": {"count": 0}}):
            [res] = eng.serve([_req(x, y, method="bakp_gram", thr=8,
                                    design_key="fd", tenant_id="t")])
        assert res.error is None
        assert res.retries == 2
        ctr = eng.registry.get("solver_retries_total")
        assert ctr.value(reason="warm_poison", from_path="bakp_gram+warm",
                         to_path="bakp_gram") == 1
        assert ctr.value(reason="forced_diverge", from_path="bakp_gram",
                         to_path="bakp") == 1
        eng.shutdown()

    def test_diverged_solve_never_poisons_warm_store(self, rng):
        eng = _engine(retry_ladder=False)
        x, y, _ = make_system(rng, 64, 16)

        def req():
            return _req(x, y, method="bakp_gram", thr=8, design_key="wp",
                        tenant_id="t0")

        [good] = eng.serve([req()])
        assert good.ok
        entry = eng.cache.get("wp", record_stats=False)
        before = entry.warm_coef("t0").clone()
        with installed({"solver.diverge": {"count": 1}}):
            [bad] = eng.serve([req()])
        assert bad.error is None
        after = entry.warm_coef("t0")
        assert after is not None and bool((before == after).all()), \
            "diverged coefficients leaked into the warm-start store"
        [ok] = eng.serve([req()])
        assert ok.ok
        eng.shutdown()

    def test_vmapped_batch_degrades_to_singles(self):
        eng = _engine()
        systems = [make_system(np.random.default_rng(60 + i), 64, 16)
                   for i in range(3)]
        reqs = [_req(x, y, method="bakp_gram", thr=8, design_key=f"vm{i}",
                     request_id=f"vm{i}")
                for i, (x, y, _) in enumerate(systems)]
        with installed({"solver.raise": {"count": 1, "match": "vmap:"}}):
            out = eng.serve(reqs)
        assert not [r.error for r in out if r.error]
        assert {r.batch_kind for r in out} == {"single"}
        assert eng.registry.get("solver_retries_total").value(
            reason="raise", from_path="vmap:bakp_gram",
            to_path="single") == len(reqs)
        for (x, y, a), res in zip(systems, out):
            assert _mape(res.coef, a) <= 1e-4
        eng.shutdown()

    def test_no_plan_is_bit_identical(self):
        def run():
            eng = _engine()
            x, y, _ = make_system(np.random.default_rng(7), 64, 16)
            [res] = eng.serve([_req(x, y, method="bakp_gram", thr=8,
                                    design_key="bi")])
            eng.shutdown()
            return res
        a, b = run(), run()
        assert a.ok and b.ok and a.retries == b.retries == 0
        assert np.array_equal(a.coef, b.coef)

    def test_engine_config_installs_plan(self, rng):
        x, y, a = make_system(rng, 64, 16)
        eng = _engine(fault_plan='{"solver.raise": {"count": 1}}')
        assert faults.active() is not None
        [res] = eng.serve([_req(x, y, method="bakp", thr=8,
                                design_key="cfg")])
        assert res.ok and res.retries == 1
        assert faults.active().counts()["solver.raise"]["fired"] == 1
        eng.shutdown()


# ------------------------------------------------------------ ticket hygiene
class TestTicketCancel:
    def test_cancel_unfired_ticket_and_drain(self, rng):
        eng = _engine()
        # huge idle timeout: the batch never fires on its own, so an
        # uncancelled leaked ticket would hang drain() forever.
        cfg = DispatchConfig(idle_timeout_s=1e9, max_batch=1000,
                             prewarm_cache=False)
        disp = AsyncDispatcher(eng, cfg).start()
        x, y, _ = make_system(rng, 40, 8)
        t = disp.submit(_req(x, y, thr=8, design_key="c0"))
        with pytest.raises(TimeoutError):
            t.result(timeout=0.01)      # the leak pattern under test
        assert t.cancel()
        assert not t.cancel()           # idempotent: already settled
        with pytest.raises(TicketCancelled):
            t.result(timeout=1.0)
        t0 = time.perf_counter()
        assert disp.drain(timeout=5.0)
        assert time.perf_counter() - t0 < 2.0
        assert disp.stats.cancelled == 1
        assert disp.stats.deadline_misses == 0   # a cancel is not a miss
        assert disp.inflight == 0
        assert eng.registry.get("serve_dispatch_cancelled_total").value() \
            == 1
        disp.stop()
        eng.shutdown()

    def test_cancel_after_completion_returns_false(self, rng):
        eng = _engine()
        cfg = DispatchConfig(idle_timeout_s=0.005, prewarm_cache=False)
        with AsyncDispatcher(eng, cfg) as disp:
            x, y, _ = make_system(rng, 40, 8)
            t = disp.submit(_req(x, y, thr=8, design_key="c1"))
            res = t.result(timeout=60.0)
            assert res.ok
            assert not t.cancel()
        eng.shutdown()

    def test_drain_survives_dead_lane(self, rng):
        """A worker death mid-dispatch settles the fired tickets through
        the work's failure hook — drain() completes, nothing hangs."""
        eng = _engine()
        cfg = DispatchConfig(idle_timeout_s=0.005, prewarm_cache=False)
        disp = AsyncDispatcher(eng, cfg).start()
        x, y, _ = make_system(rng, 64, 16)
        with installed({"lane.worker": {"count": 1, "match": "single:"}}):
            tickets = [disp.submit(_req(x, y, method="bakp_gram", thr=8,
                                        design_key="dd",
                                        request_id=f"dd{i}"))
                       for i in range(4)]
            assert disp.drain(timeout=60.0)
            failed = 0
            for t in tickets:
                assert t.done(), "ticket orphaned by the dead lane"
                try:
                    t.result(timeout=0)
                except LaneWorkerDeath:
                    failed += 1         # failed units surface typed errors
            assert failed >= 1
        # dispatcher and engine both keep serving afterwards
        t = disp.submit(_req(x, y, method="bakp_gram", thr=8,
                             design_key="dd"))
        assert t.result(timeout=60.0).ok
        assert disp.inflight == 0
        disp.stop()
        eng.shutdown()


# --------------------------------------------------------- crash-safe store
class TestCrashSafeStore:
    """Each case on the port's store and on JAX's, driven alike."""

    def _to_disk(self, rng, tmp_path, key="d1"):
        x = rng.normal(size=(64, 48)).astype(np.float32)
        self.regs = (obs.MetricsRegistry(), jobs.MetricsRegistry())
        stores = []
        for Store, reg, sub, kw in ((DesignStore, self.regs[0], "t",
                                     {"device": "cpu"}),
                                    (JDesignStore, self.regs[1], "j", {})):
            st = Store(device_bytes=None, host_bytes=1,
                       disk_dir=str(tmp_path / sub / "tiles"),
                       registry=reg, **kw)
            entry = st.build(key, x)
            entry.x_t_for(16)
            entry.store_coef("tenant", np.ones(48, np.float32))
            st.demote(key)
            assert st.tier(key) == "disk"
            stores.append(st)
        return stores, x

    def test_tile_format_and_atomic_writes(self, rng, tmp_path):
        (st, jst), x = self._to_disk(rng, tmp_path)
        disk, jdisk = st._disk["d1"], jst._disk["d1"]
        assert not list(disk.tile_dir.glob("*.tmp")), \
            "temp files must never survive a tile write"
        assert disk.nblocks == jdisk.nblocks == 3
        for j in range(disk.nblocks):
            raw = disk.tile_path(j).read_bytes()
            assert raw == jdisk.tile_path(j).read_bytes()
            magic, crc, nbytes = _TILE_HEADER.unpack_from(raw)
            payload = raw[_TILE_HEADER.size:]
            assert magic == _TILE_MAGIC
            assert nbytes == len(payload)
            assert crc == zlib.crc32(payload)
            np.testing.assert_array_equal(
                disk.verify_tile(j).numpy(),
                np.frombuffer(payload, np.float32).reshape(16, 64))

    def test_corrupt_tile_quarantined_and_rebuilt(self, rng, tmp_path):
        stores, x = self._to_disk(rng, tmp_path)
        for st, reg, sub in zip(stores, self.regs, ("t", "j")):
            path = st._disk["d1"].tile_path(1)
            raw = bytearray(path.read_bytes())
            raw[_TILE_HEADER.size + 5] ^= 0xFF    # flip one payload byte
            path.write_bytes(bytes(raw))
            assert st.promote("d1") is None       # detected, not served
            assert st.tier("d1") == "none"        # X bytes are gone...
            qdir = tmp_path / sub / "tiles" / "d1.quarantine"
            assert qdir.exists()
            assert not (tmp_path / sub / "tiles" / "d1").exists()
            assert st.stats.tile_corruptions == 1
            assert reg.get("store_tile_corruption_total").value() == 1
            # ...but a rebuild from the design source restores tenant state
            fresh = st.build("d1", x)
            assert fresh.warm_coef("tenant") is not None
            assert np.allclose(np.asarray(fresh.x_pad), x)
        assert stores[0].stats.as_dict() == stores[1].stats.as_dict()

    def test_fault_site_corrupts_without_touching_disk(self, rng, tmp_path):
        (st, jst), x = self._to_disk(rng, tmp_path, key="d2")
        plan = {"store.tile_corrupt": {"count": 1, "match": "d2"}}
        for s, inst, err in ((st, installed, TileCorruptionError),
                             (jst, jres.installed, JTileCorruptionError)):
            with inst(plan):
                with pytest.raises(err, match="CRC32"):
                    s._disk["d2"].verify_tile(0)
            # the on-disk bytes were never mutated: a clean retry verifies
            s._disk["d2"].verify_tile(0)
            assert s.promote("d2") is not None
        assert st.stats.as_dict() == jst.stats.as_dict()

    def test_engine_recovers_from_corruption(self, rng, tmp_path):
        """Store-backed engine: a design demoted to disk gets its tiles
        corrupted; the next request quarantines it and rebuilds from the
        request's design source — served, counted, no error — in step with
        JAX's store engine."""
        design_bytes = 64 * 32 * 4
        systems = [make_system(np.random.default_rng(80 + i), 48, 24)
                   for i in range(4)]
        outs = []
        for Eng, Cfg, Req, reg, sub, kw in (
                (SolverServeEngine, ServeConfig, SolveRequest,
                 obs.MetricsRegistry(), "t", {"device": "cpu"}),
                (J.SolverServeEngine, J.ServeConfig, J.SolveRequest,
                 jobs.MetricsRegistry(), "j", {})):
            eng = Eng(Cfg(store_device_bytes=2 * design_bytes,
                          store_host_bytes=1,
                          store_dir=str(tmp_path / sub), cache_entries=256),
                      registry=reg, **kw)
            reqs = [Req(x=x, y=y, method="bakp", thr=8, max_iter=150,
                        rtol=1e-12, design_key=f"cq{i}",
                        request_id=f"cq{i}")
                    for i, (x, y, _) in enumerate(systems)]
            eng.serve(reqs)              # churns the early designs to disk
            victims = [k for k in ("cq0", "cq1", "cq2", "cq3")
                       if eng.store.tier(k) == "disk"]
            assert victims, "workload must demote a design to disk"
            disk = eng.store._disk[victims[0]]
            for j in range(disk.nblocks):
                p = disk.tile_path(j)
                raw = bytearray(p.read_bytes())
                raw[-1] ^= 0xFF
                p.write_bytes(bytes(raw))
            out = eng.serve(reqs)        # hits the corrupt tiles
            assert not [r.error for r in out if r.error]
            assert eng.store.stats.tile_corruptions >= 1
            assert reg.get("store_tile_corruption_total").value() >= 1
            for (x, y, a), res in zip(systems, out):
                assert _mape(res.coef, a) <= 1e-4
            outs.append((victims, eng.store.stats.as_dict(), out))
            eng.shutdown()
        (tv, tst, tout), (jv, jst, jout) = outs
        assert tv == jv and tst == jst
        for t, j in zip(tout, jout):
            scale = max(1.0, float(np.abs(j.coef).max()))
            assert float(np.abs(t.coef - j.coef).max()) <= 1e-5 * scale

    def test_dispatcher_promotion_quarantines_and_rebuilds(self, rng,
                                                            tmp_path):
        """The promotion runs on the dispatch thread (pre-warm): a corrupt
        tile there quarantines the design, the pre-warm rebuilds it from
        the request's x with the stub's warm state, and the tenant is
        served warm with no error."""
        design_bytes = 64 * 32 * 4
        eng = _engine(store_device_bytes=design_bytes, store_host_bytes=1,
                      store_dir=str(tmp_path / "t"))
        systems = [make_system(np.random.default_rng(90 + i), 48, 24)
                   for i in range(2)]
        for i, (x, y, _) in enumerate(systems):
            [r] = eng.serve([_req(x, y, method="bakp", thr=8, max_iter=150,
                                  design_key=f"pq{i}", tenant_id="t")])
            assert r.ok
        assert eng.store.tier("pq0") == "disk"
        x, y, a = systems[0]
        with installed({"store.tile_corrupt": {"count": 1,
                                               "match": "pq0"}}):
            cfg = DispatchConfig(idle_timeout_s=0.005, prewarm_cache=True)
            with AsyncDispatcher(eng, cfg) as disp:
                res = disp.submit(_req(x, y, method="bakp", thr=8,
                                       max_iter=150, design_key="pq0",
                                       tenant_id="t")).result(timeout=60.0)
        assert res.ok and res.warm_start
        assert _mape(res.coef, a) <= 1e-4
        assert eng.store.stats.tile_corruptions == 1
        assert eng.registry.get("store_tile_corruption_total").value() == 1
        assert eng.store.tier("pq0") == "device"
        eng.shutdown()
