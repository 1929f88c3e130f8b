"""Sharded serving in the port: placement routing, mesh parity, cache
thread-safety — mirrors ``tests/test_serve_sharded.py``.

* ``TestPlacementPolicy``: the port's placement rules against JAX's on a
  shape-only fake mesh (no device state).
* ``TestDesignEntryLocking``: the handle's per-design state hammered from
  several threads.
* ``TestMeshEngineParity``: JAX's parity workload (big buckets →
  ``obs_sharded``, a 32-tenant same-design group → ``rhs_sharded``, small
  designs → the single-device batch) through the port's mesh engine on a
  (4, 2) mesh of virtual CPU shards against its mesh-less engine, two
  rounds (round 2 warm through ``tenant_id``); and, in a subprocess with 8
  forced CPU devices, against JAX's mesh engine on a (4, 2) mesh, request
  by request: the same placement and batch kind, MAPE <= 1e-5.
"""
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import repro.serve as J
from repro_torch import obs
from repro_torch.serve import (Placement, PlacementPolicy, ServeConfig,
                               ServeMesh, SolveRequest, SolverServeEngine,
                               build_serve_mesh, mesh_device_count,
                               placement_for_bucket, placement_for_group)
from repro_torch.serve.batching import config_key
from repro_torch.serve.cache import DesignCache

K = 32  # same-design group size: the k-sharded multi-RHS path


def workload(seed, Req=SolveRequest):
    """JAX's parity workload (``tests/test_serve_sharded.py``)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(3):  # pads to 512 x 64 >= the policy threshold
        x = rng.normal(size=(500, 60)).astype(np.float32)
        a = rng.normal(size=(60,)).astype(np.float32)
        reqs.append(Req(x=x, y=x @ a, thr=16, max_iter=40, rtol=0.0,
                        design_key=f"big-{i}", request_id=f"big-{i}",
                        tenant_id=f"big-t{i}"))
    xs = rng.normal(size=(200, 24)).astype(np.float32)
    A = rng.normal(size=(24, K)).astype(np.float32)
    for i in range(K):
        reqs.append(Req(x=xs, y=xs @ A[:, i], thr=16, max_iter=40,
                        rtol=0.0, design_key="grp", request_id=f"grp-{i}",
                        tenant_id=f"grp-t{i}"))
    for i in range(4):
        x = rng.normal(size=(100, 12)).astype(np.float32)
        a = rng.normal(size=(12,)).astype(np.float32)
        reqs.append(Req(x=x, y=x @ a, thr=8, max_iter=40, rtol=0.0,
                        design_key=f"sm-{i}", request_id=f"sm-{i}"))
    return reqs


def _policy(P=PlacementPolicy):
    return P(obs_shard_min_cells=512 * 64, rhs_shard_min_k=32)


def _mape(a, ref):
    return float(np.mean(np.abs(a - ref) / np.maximum(np.abs(ref), 1e-12)))


def check_placements(results):
    placements = {r.request_id: r.placement for r in results}
    kinds = {r.request_id: r.batch_kind for r in results}
    for i in range(3):
        assert placements[f"big-{i}"] == "obs_sharded", placements
    for i in range(K):
        assert placements[f"grp-{i}"] == "rhs_sharded", placements
        assert kinds[f"grp-{i}"] == "multi_rhs"
    for i in range(4):
        assert placements[f"sm-{i}"] == "single", placements
        assert kinds[f"sm-{i}"] == "vmap"


# The port's mesh engine against JAX's, under 8 forced CPU devices.
JAX_PARITY_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import repro.serve as J
    from repro_torch import obs
    from repro_torch.serve import (PlacementPolicy, ServeConfig,
                                   SolverServeEngine, build_serve_mesh)
    from test_torch_serve_sharded import (_mape, _policy, check_placements,
                                          workload)

    t_eng = SolverServeEngine(ServeConfig(placement_policy=_policy()),
                              mesh=build_serve_mesh("4x2", device="cpu"),
                              registry=obs.MetricsRegistry())
    j_eng = J.SolverServeEngine(
        J.ServeConfig(placement_policy=_policy(J.PlacementPolicy)),
        mesh=J.build_serve_mesh("4x2"))
    for rnd in range(2):
        t_out = t_eng.serve(workload(7))
        j_out = j_eng.serve(workload(7, J.SolveRequest))
        assert not [r.error for r in t_out + j_out if r.error]
        check_placements(t_out)
        worst = 0.0
        for t, j in zip(t_out, j_out):
            assert t.request_id == j.request_id
            assert (t.placement, t.batch_kind, t.warm_start) == (
                j.placement, j.batch_kind, j.warm_start), t.request_id
            worst = max(worst, _mape(t.coef, j.coef))
        assert worst <= 1e-5, f"round {rnd}: MAPE vs JAX {worst}"
        print(f"round {rnd}: worst MAPE vs JAX {worst:.2e}")
    assert t_eng.stats.sharded_solves == j_eng.stats.sharded_solves >= 8
    print("JAX_PARITY_OK")
""")


class TestMeshEngineParity:
    def test_mesh_engine_matches_meshless_engine(self):
        eng_mesh = SolverServeEngine(
            ServeConfig(placement_policy=_policy()),
            mesh=build_serve_mesh("4x2", device="cpu"),
            registry=obs.MetricsRegistry())
        eng_single = SolverServeEngine(ServeConfig(), device="cpu",
                                       registry=obs.MetricsRegistry())
        for rnd in range(2):  # round 2 = warm starts via tenant_id
            r_mesh = eng_mesh.serve(workload(7))
            r_single = eng_single.serve(workload(7))
            assert [r.request_id for r in r_mesh] == \
                [r.request_id for r in r_single]
            assert not [r.error for r in r_mesh + r_single if r.error]
            check_placements(r_mesh)
            assert all(r.placement == "single" for r in r_single)
            worst = max(_mape(m.coef, s.coef)
                        for m, s in zip(r_mesh, r_single))
            assert worst <= 1e-5, f"round {rnd}: parity MAPE {worst}"
        assert eng_mesh.stats.sharded_solves >= 8   # 3 obs + 1 rhs a round
        assert eng_mesh.stats.warm_starts > 0
        assert eng_single.stats.sharded_solves == 0
        assert {"mesh:obs_sharded", "mesh:rhs_sharded"} <= set(
            eng_mesh.lanes.stats())
        solves = eng_mesh.registry.get("serve_solves_total")
        assert solves.value(placement="obs_sharded", path="sharded") == 6
        entry = eng_mesh.cache.get("grp", record_stats=False)
        assert entry.home == "single"  # the bucket's; the group upgraded
        assert "rhs_sharded" in entry.resident_lanes()
        eng_mesh.shutdown()
        eng_single.shutdown()

    def test_mesh_engine_matches_jax_mesh_engine_subprocess(self):
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.abspath(os.path.join(here, "..", "src")), here])
        p = subprocess.run([sys.executable, "-c", JAX_PARITY_SCRIPT],
                           capture_output=True, text=True, env=env,
                           timeout=600)
        assert p.returncode == 0, p.stdout + "\n" + p.stderr
        assert "JAX_PARITY_OK" in p.stdout


# ----------------------------------------------------------- policy (pure)
class _FakeMesh:
    """Shape-only stand-in: the policy reads axis sizes only."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _smesh(data=4, model=2, Mesh=ServeMesh):
    shape = {"data": data}
    if model:
        shape["model"] = model
    return Mesh(mesh=_FakeMesh(shape), data_axes=("data",),
                model_axis="model" if model else None)


BUCKETS = [(512, 128), (128, 128), (4, 1 << 10), (1 << 12, 1 << 12),
           (64, 8)]
POLICIES = [dict(), dict(obs_shard_min_cells=1 << 16),
            dict(obs_shard_min_cells=1),
            dict(obs_shard_min_cells=1, mesh_2d_min_cells=1 << 16)]


class TestPlacementPolicy:
    def test_no_mesh_is_single(self):
        p = placement_for_bucket((1 << 12, 1 << 12), "bakp_gram",
                                 PlacementPolicy(), None)
        assert p.kind == "single"

    def test_threshold_routes_obs_sharded(self):
        pol = PlacementPolicy(obs_shard_min_cells=1 << 16)
        sm = _smesh()
        assert placement_for_bucket((512, 128), "bakp_gram", pol,
                                    sm).kind == "obs_sharded"
        assert placement_for_bucket((128, 128), "bakp_gram", pol,
                                    sm).kind == "single"
        for m in ("bak", "lstsq", "normal", "bakp_fused", "bakp_stream"):
            assert placement_for_bucket((512, 128), m, pol, sm).kind == \
                "single"

    def test_divisibility_guard(self):
        pol = PlacementPolicy(obs_shard_min_cells=1)
        sm = _smesh(data=8, model=None)
        assert placement_for_bucket((4, 1 << 10), "bakp", pol, sm).kind == \
            "single"

    def test_mesh_2d_opt_in(self):
        sm = _smesh()
        off = PlacementPolicy(obs_shard_min_cells=1)
        assert placement_for_bucket((512, 128), "bakp_gram", off,
                                    sm).kind == "obs_sharded"
        on = PlacementPolicy(obs_shard_min_cells=1, mesh_2d_min_cells=1 << 16)
        assert placement_for_bucket((512, 128), "bakp_gram", on,
                                    sm).kind == "mesh_2d"

    def test_group_upgrade(self):
        pol = PlacementPolicy(rhs_shard_min_k=32)
        sm = _smesh()
        single = Placement("single")
        assert placement_for_group(single, 32, pol, sm).kind == "rhs_sharded"
        assert placement_for_group(single, 16, pol, sm).kind == "single"
        pol2 = PlacementPolicy(rhs_shard_min_k=2)
        assert placement_for_group(single, 2, pol2, sm).kind == "single"
        obs_p = Placement("obs_sharded")
        assert placement_for_group(obs_p, 64, pol, sm).kind == "obs_sharded"

    @pytest.mark.parametrize("pol", POLICIES, ids=range(len(POLICIES)))
    def test_decisions_match_reference(self, pol):
        for data, model in ((4, 2), (8, None), (1, 4)):
            sm = _smesh(data, model)
            jsm = _smesh(data, model, J.ServeMesh)
            assert (sm.data_size, sm.model_size, sm.describe()) == (
                jsm.data_size, jsm.model_size, jsm.describe())
            for bucket in BUCKETS:
                for m in ("bakp", "bakp_gram", "bak", "bakp_fused"):
                    t = placement_for_bucket(bucket, m, PlacementPolicy(**pol),
                                             sm)
                    j = J.placement_for_bucket(
                        bucket, m, J.PlacementPolicy(**pol), jsm)
                    assert t.kind == j.kind, (bucket, m, data, model)
                    for k in (1, 16, 32, 64):
                        assert placement_for_group(
                            t, k, PlacementPolicy(**pol), sm).kind == \
                            J.placement_for_group(
                                j, k, J.PlacementPolicy(**pol), jsm).kind

    def test_config_key_carries_placement(self, rng):
        x = rng.normal(size=(40, 6)).astype(np.float32)
        req = SolveRequest(x=x, y=x[:, 0])
        bucket = (64, 8)
        base = config_key(req, bucket)
        assert config_key(req, bucket, None) == base
        keyed = config_key(req, bucket, Placement("obs_sharded"))
        assert keyed != base
        assert keyed[:len(base)] == base

    def test_mesh_device_count(self):
        assert mesh_device_count("8") == 8
        assert mesh_device_count("4x2") == 8

    def test_decisions_are_counted(self):
        ctr = obs.default_registry().counter(
            "serve_placement_decisions_total",
            "placement routing decisions, by level and chosen kind")
        before = ctr.value(level="bucket", kind="obs_sharded")
        placement_for_bucket((512, 128), "bakp",
                             PlacementPolicy(obs_shard_min_cells=1), _smesh())
        assert ctr.value(level="bucket", kind="obs_sharded") == before + 1

    def test_raw_mesh_wraps_with_model_axis(self):
        from repro_torch.launch.mesh import make_debug_mesh

        eng = SolverServeEngine(
            mesh=make_debug_mesh((2, 2), ("data", "model"),
                                 devices=["cpu"] * 4),
            registry=obs.MetricsRegistry())
        assert (eng.mesh.data_axes, eng.mesh.model_axis) == (("data",),
                                                             "model")
        assert eng.mesh.describe() == "ServeMesh(data=2, model=2)"
        eng.shutdown()


# ------------------------------------------------- cache thread-safety
class TestDesignEntryLocking:
    def test_concurrent_entry_mutation(self, rng):
        """Every per-design accessor hammered from several threads: the
        warm-coefficient LRU and the derived-state dicts stay whole."""
        cache = DesignCache(max_entries=4, max_tenants=8, device="cpu",
                            registry=obs.MetricsRegistry())
        x = rng.normal(size=(64, 24)).astype(np.float32)
        entry, _ = cache.get_or_build("d0", lambda: x)
        smesh = build_serve_mesh("4", device="cpu")
        stop = threading.Event()
        errors = []

        def hammer(tid):
            try:
                i = 0
                while not stop.is_set():
                    t = f"tenant-{tid}-{i % 13}"
                    entry.store_coef(t, np.full((24,), float(i), np.float32))
                    entry.warm_coef(t)
                    entry.warm_coef(f"tenant-{(tid + 1) % 4}-{i % 13}")
                    entry.cn_for_thr(5 + (i % 3))
                    entry.chol_for(8, 1e-6)
                    entry.x_for_placement(Placement("obs_sharded"), smesh)
                    entry.resident_lanes()
                    i += 1
            except Exception as exc:  # pragma: no cover - the regression
                errors.append(exc)

        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not errors, errors
        assert len(entry._warm) <= 8
        assert len(entry._sharded) == 1  # built once, under the lock

    def test_store_coef_copies(self, rng):
        cache = DesignCache(device="cpu", registry=obs.MetricsRegistry())
        x = rng.normal(size=(16, 4)).astype(np.float32)
        entry, _ = cache.get_or_build("d0", lambda: x)
        coef = np.ones((4,), np.float32)
        entry.store_coef("t", coef)
        coef[:] = -1.0  # caller mutates the returned ServedSolve.coef
        np.testing.assert_array_equal(entry.warm_coef("t").numpy(),
                                      np.ones((4,), np.float32))
