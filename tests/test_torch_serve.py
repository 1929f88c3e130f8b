"""repro_torch.serve against repro.serve: bucketing, padding, grouping,
the design cache, multi-RHS coalescing, batching across designs, warm
starts, the precision policy and the device rule.

Mirrors ``tests/test_serve.py``.  The same numpy requests, made from a
seed, go through ``repro.serve.SolverServeEngine`` and the port's engine
with ``device="cpu"``; per request, ``coef`` and ``residual`` agree to
1e-5 of their scale (the largest |coef| or |y|, at least 1), batch kinds,
warm-start flags and ``ServeStats`` exactly, and ``n_sweeps`` exactly on
the ``rtol=0`` and atol-only workloads (the North-star rule: an rtol stop
compares two fp32 SSEs an ulp apart, and may fall a sweep apart).

On this tree's jax, JAX's fused kernels raise, so JAX's engine cannot
serve ``bakp_fused`` / ``bak_fused``.  The port's fused route is held
against JAX's engine with ``prefer_fused=False`` ("bakp", the same
iterate) and against "bak".  ``test_multi_rhs_kernels_vs_ref`` fails on
the JAX side for the same reason, so the port's case is held against the
port's ``kernels/ref.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.serve as J
from conftest import make_system
from repro.core import solvebak as j_solvebak
from repro_torch import obs
from repro_torch.core import solve, solvebak, solvebakp
from repro_torch.core.spec import UnsupportedSpecError
from repro_torch.serve import (ServeConfig, ServedSolve, SolveRequest,
                               SolverServeEngine, bucket_shape,
                               design_fingerprint, group_requests, next_pow2)

TOL = 1e-5


def _lstsq(x, y):
    return np.linalg.lstsq(np.asarray(x, np.float64),
                           np.asarray(y, np.float64), rcond=None)[0]


def _engines(**cfg):
    return (J.SolverServeEngine(J.ServeConfig(**cfg),
                                registry=jobs.MetricsRegistry()),
            SolverServeEngine(ServeConfig(**cfg),
                              registry=obs.MetricsRegistry(), device="cpu"))


def _agree(j, t, y, *, sweeps=True):
    """One request's results from both engines agree (see module doc)."""
    assert j.error is None and t.error is None, (j.error, t.error)
    assert (t.batch_kind, t.group_size, t.bucket, t.warm_start,
            t.cache_hit) == (j.batch_kind, j.group_size, tuple(j.bucket),
                             j.warm_start, j.cache_hit)
    c_scale = max(1.0, float(np.abs(j.coef).max()))
    assert float(np.abs(t.coef - j.coef).max()) <= TOL * c_scale
    y_scale = max(1.0, float(np.abs(y).max()))
    assert float(np.abs(t.residual - j.residual).max()) <= TOL * y_scale
    assert t.sse == pytest.approx(float(np.dot(t.residual, t.residual)),
                                  rel=1e-5, abs=1e-8)
    if sweeps:
        assert (t.n_sweeps, t.converged) == (j.n_sweeps, j.converged)


def _serve_both(make, **cfg):
    """``make(Request)`` builds one request list; both engines serve it."""
    jeng, teng = _engines(**cfg)
    jout = jeng.serve(make(J.SolveRequest))
    tout = teng.serve(make(SolveRequest))
    return jeng, teng, jout, tout


# --------------------------------------------------------------- multi-RHS
class TestMultiRhsSolvers:
    """Multi-RHS core solves vs a column-by-column fp32 oracle."""

    @pytest.mark.parametrize("solver_kw", [
        dict(fn="bak"),
        dict(fn="bakp", mode="jacobi", thr=16),
        dict(fn="bakp", mode="gram", thr=16),
    ])
    def test_matches_column_by_column(self, rng, solver_kw):
        obs_, nvars, k = 400, 32, 6
        x = torch.from_numpy(rng.normal(size=(obs_, nvars)).astype(np.float32))
        a_true = rng.normal(size=(nvars, k)).astype(np.float32)
        ys = x @ torch.from_numpy(a_true)
        if solver_kw["fn"] == "bak":
            multi = solvebak(x, ys, max_iter=60)
            cols = [solvebak(x, ys[:, i], max_iter=60) for i in range(k)]
        else:
            kw = dict(thr=solver_kw["thr"], mode=solver_kw["mode"],
                      max_iter=60)
            multi = solvebakp(x, ys, **kw)
            cols = [solvebakp(x, ys[:, i], **kw) for i in range(k)]
        assert tuple(multi.coef.shape) == (nvars, k)
        assert tuple(multi.residual.shape) == (obs_, k)
        for i, c in enumerate(cols):
            np.testing.assert_allclose(multi.coef[:, i].numpy(),
                                       c.coef.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(multi.coef.numpy(), a_true, rtol=1e-3,
                                   atol=1e-3)

    def test_multi_rhs_via_solve_api(self, rng):
        x, _, _ = make_system(rng, 300, 20)
        a_true = rng.normal(size=(20, 3)).astype(np.float32)
        ys = x @ a_true
        for method in ("bak", "bakp", "bakp_gram", "lstsq", "normal"):
            res = solve(x, ys, method=method, max_iter=60, thr=8,
                        device="cpu")
            assert tuple(res.coef.shape) == (20, 3), method
            np.testing.assert_allclose(res.coef.numpy(), a_true, rtol=1e-3,
                                       atol=1e-3, err_msg=method)

    def test_multi_rhs_kernels_vs_ref(self, rng):
        from repro_torch.core.types import column_norms_sq, safe_inv
        from repro_torch.kernels import bakp_sweep, block_update, cd_sweep
        from repro_torch.kernels.ref import (ref_bakp_sweep, ref_block_update,
                                             ref_cd_sweep)
        obs_, nvars, k, blk = 128, 16, 4, 8
        x = torch.from_numpy(rng.normal(size=(obs_, nvars)).astype(np.float32))
        e = torch.from_numpy(rng.normal(size=(k, obs_)).astype(np.float32))
        x_t = x.T.contiguous()
        inv_cn = safe_inv(column_norms_sq(x))
        for kern, ref, kw in ((cd_sweep, ref_cd_sweep, {}),
                              (bakp_sweep, ref_bakp_sweep, dict(block=blk))):
            da_k, e_k = kern(x_t, e, inv_cn, block=blk)
            da_r, e_r = ref(x_t, e, inv_cn, **kw)
            np.testing.assert_allclose(da_k.numpy(), da_r.numpy(),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(e_k.numpy(), e_r.numpy(), rtol=1e-5,
                                       atol=1e-5)
        da = torch.from_numpy(rng.normal(size=(blk, k)).astype(np.float32))
        np.testing.assert_allclose(
            block_update(x_t[:blk], e, da).numpy(),
            ref_block_update(x_t[:blk], e, da).numpy(), rtol=1e-5,
            atol=1e-5)


# ---------------------------------------------------------- dispatch errors
class TestDispatchErrors:
    def test_unknown_method_raises(self, rng):
        x, y, _ = make_system(rng, 50, 4)
        with pytest.raises(ValueError, match="method must be one of"):
            solve(x, y, method="cholesky_qr", device="cpu")

    def test_random_order_requires_generator(self, rng):
        x, y, _ = make_system(rng, 50, 4)
        with pytest.raises(ValueError, match="requires a torch.Generator"):
            solvebak(torch.from_numpy(x), torch.from_numpy(y),
                     order="random")

    def test_engine_rejects_unknown_method(self, rng):
        x, y, _ = make_system(rng, 50, 4)
        with pytest.raises(ValueError, match="method must be one of"):
            SolverServeEngine(device="cpu").submit(
                SolveRequest(x=x, y=y, method="qr"))

    def test_engine_rejects_bad_shapes(self, rng):
        x, y, _ = make_system(rng, 50, 4)
        eng = SolverServeEngine(device="cpu")
        with pytest.raises(ValueError, match="x must be 2D"):
            eng.submit(SolveRequest(x=y, y=y))
        with pytest.raises(ValueError, match="y must be"):
            eng.submit(SolveRequest(x=x, y=y[:-1]))

    def test_no_gpu_raises_and_cpu_serves(self, rng, monkeypatch):
        x, y, _ = make_system(rng, 50, 4)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SolverServeEngine()
        eng = SolverServeEngine(device="cpu")
        [res] = eng.serve([SolveRequest(x=x, y=y, method="lstsq")])
        assert res.ok
        eng.shutdown()

    def test_later_slices_raise(self):
        for knob in (dict(store_device_bytes=1 << 20),
                     dict(store_host_bytes=1 << 20), dict(store_dir="d")):
            with pytest.raises(UnsupportedSpecError, match="design-store"):
                SolverServeEngine(ServeConfig(**knob), device="cpu")
        with pytest.raises(UnsupportedSpecError, match="multi-GPU"):
            SolverServeEngine(mesh=object(), device="cpu")


# ----------------------------------------------------------------- batching
class TestBucketing:
    def test_pow2(self):
        assert next_pow2(1) == 1
        assert next_pow2(5) == 8
        assert next_pow2(8) == 8
        assert next_pow2(9) == 16
        assert next_pow2(3, floor=8) == 8
        assert bucket_shape(300, 24) == (512, 32)
        assert bucket_shape(4, 4) == (8, 8)

    def test_fingerprint_content_keyed_and_matches_reference(self, rng):
        x = rng.normal(size=(20, 4)).astype(np.float32)
        assert design_fingerprint(x) == design_fingerprint(x.copy())
        assert design_fingerprint(x) == design_fingerprint(
            torch.from_numpy(x))
        assert design_fingerprint(x) == J.design_fingerprint(x)
        x2 = x.copy()
        x2[3, 2] += 1.0
        assert design_fingerprint(x) != design_fingerprint(x2)
        assert design_fingerprint(x) != design_fingerprint(x.reshape(4, 20))

    def test_grouping_deterministic_and_matches_reference(self, rng):
        xs = [rng.normal(size=(30 + 3 * i, 6)).astype(np.float32)
              for i in range(3)]
        methods = ("bakp_gram", "bak", "lstsq")

        def mk(Req):
            return [Req(x=xs[i % 3], y=xs[i % 3][:, 0],
                        method=methods[(i // 3) % 3]) for i in range(9)]

        g1, g2 = group_requests(mk(SolveRequest)), group_requests(
            mk(SolveRequest))
        assert list(g1) == list(g2)
        ref = J.group_requests(mk(J.SolveRequest))

        def shape(g):
            return [(outer[0], outer[1], list(inner.items()))
                    for outer, inner in g.items()]
        assert shape(g1) == shape(ref)


# ------------------------------------------------------------------- engine
def _mixed_workload(seed, *, atol=0.0, rtol=0.0, max_iter=60, noise=0.0):
    """Same-design (multi_rhs), same-bucket distinct (vmap) and a lone
    single, non-pow2 shapes, as JAX's padding test."""
    r = np.random.default_rng(seed)
    x_shared = r.normal(size=(300, 24)).astype(np.float32)
    systems = [(x_shared, r.normal(size=(24,)).astype(np.float32))
               for _ in range(3)]
    for nobs in (290, 270):
        systems.append((r.normal(size=(nobs, 20)).astype(np.float32),
                        r.normal(size=(20,)).astype(np.float32)))
    systems.append((r.normal(size=(100, 5)).astype(np.float32),
                    np.ones(5, np.float32)))
    ys = [x @ a + noise * r.normal(size=x.shape[0]).astype(np.float32)
          for x, a in systems]

    def make(Req, method="bakp"):
        return [Req(x=x, y=y, method=method, thr=16, max_iter=max_iter,
                    atol=atol, rtol=rtol, request_id=f"r{i}")
                for i, ((x, _), y) in enumerate(zip(systems, ys))]
    return make, ys


class TestEngineParity:
    @pytest.mark.parametrize("method", ["bakp", "bakp_gram", "bak"])
    def test_fixed_sweeps_every_batch_kind(self, method):
        make, ys = _mixed_workload(1, max_iter=30)
        jeng, teng, jout, tout = _serve_both(
            lambda R: make(R, method))
        assert [r.batch_kind for r in tout] == \
            ["multi_rhs"] * 3 + ["vmap"] * 2 + ["single"]
        for j, t, y in zip(jout, tout, ys):
            _agree(j, t, y)
            assert t.n_sweeps == 30
        assert teng.stats.as_dict() == jeng.stats.as_dict()
        assert teng.cache.stats.as_dict() == jeng.cache.stats.as_dict()
        teng.shutdown()

    @pytest.mark.parametrize("method", ["bakp", "bakp_gram", "bak"])
    def test_atol_stop_every_batch_kind(self, method):
        """atol-only: every stop (group SSE for multi_rhs, per system in
        the batch, each with its padding-corrected atol) falls on JAX's
        sweep."""
        make, ys = _mixed_workload(2, atol=0.32, max_iter=60, noise=0.3)
        jeng, teng, jout, tout = _serve_both(lambda R: make(R, method))
        for j, t, y in zip(jout, tout, ys):
            _agree(j, t, y)
        assert any(1 < t.n_sweeps < 60 for t in tout), \
            [t.n_sweeps for t in tout]
        assert teng.stats.as_dict() == jeng.stats.as_dict()
        teng.shutdown()

    def test_rtol_workload_vs_reference_and_lstsq(self):
        make, ys = _mixed_workload(3, rtol=1e-12, max_iter=60)
        jeng, teng, jout, tout = _serve_both(make)
        reqs = make(SolveRequest)
        for j, t, y, req in zip(jout, tout, ys, reqs):
            _agree(j, t, y, sweeps=False)
            assert abs(t.n_sweeps - j.n_sweeps) <= 1
            assert isinstance(t, ServedSolve)
            assert t.coef.shape == (req.x.shape[1],)
            assert t.residual.shape == (req.x.shape[0],)
            np.testing.assert_allclose(t.coef, _lstsq(req.x, req.y),
                                       rtol=1e-3, atol=1e-3)
        assert teng.stats.as_dict() == jeng.stats.as_dict()
        teng.shutdown()

    def test_warm_starts_match_reference(self):
        """Two windows with tenants: the second warm-starts every request
        (multi_rhs members on columns of the stacked a0, vmap rows on rows
        of it) in both engines."""
        make, ys = _mixed_workload(4, atol=0.05, max_iter=80, noise=0.02)

        def tenants(R):
            reqs = make(R)
            for i, r in enumerate(reqs):
                r.tenant_id = f"t{i}"
                r.design_key = f"d{i if i >= 3 else 0}"
            return reqs

        jeng, teng = _engines()
        jeng.serve(tenants(J.SolveRequest))
        teng.serve(tenants(SolveRequest))
        jout = jeng.serve(tenants(J.SolveRequest))
        tout = teng.serve(tenants(SolveRequest))
        assert all(t.warm_start for t in tout)
        for j, t, y in zip(jout, tout, ys):
            _agree(j, t, y)
        assert teng.stats.as_dict() == jeng.stats.as_dict()
        teng.shutdown()

    def test_tensor_requests(self, rng):
        x, y, a = make_system(rng, 60, 8)
        eng = SolverServeEngine(device="cpu")
        [res] = eng.serve([SolveRequest(
            x=torch.from_numpy(x), y=torch.from_numpy(y),
            a0=torch.zeros(8), method="bakp_gram", thr=8, max_iter=60,
            rtol=1e-12)])
        assert res.ok
        np.testing.assert_allclose(res.coef, a, rtol=1e-3, atol=1e-3)
        eng.shutdown()


    def test_tensor_design_kept_through_intake(self, rng):
        """A tensor x is not copied to host numpy at intake: the request
        keeps it, the fingerprint span sets its design key (the numpy
        bytes' key), the cache builds its own copy from it, and the
        results equal those of the same numpy request bit for bit."""
        x, y, _ = make_system(rng, 60, 8)
        xt = torch.from_numpy(x.copy())
        outs, reqs = [], []
        for xv in (x, xt):
            eng = SolverServeEngine(device="cpu",
                                    registry=obs.MetricsRegistry())
            reqs.append([SolveRequest(x=xv, y=torch.from_numpy(y),
                                      method="bakp", thr=8, max_iter=30,
                                      tenant_id=f"t{i}") for i in range(2)])
            outs.append(eng.serve(reqs[-1]))
            eng.shutdown()
        for r in reqs[1]:
            assert r.x is xt and isinstance(r.y, np.ndarray)
            assert r.design_key == design_fingerprint(x)
        for a, b in zip(*outs):
            assert a.ok and b.ok and a.batch_kind == "multi_rhs"
            assert np.array_equal(a.coef, b.coef)
            assert np.array_equal(a.residual, b.residual)
        entry = eng.cache.get(reqs[1][0].design_key, record_stats=False)
        xt.zero_()  # a later write by the caller misses the cached copy
        assert np.array_equal(entry.x_pad[:60, :8].numpy(), x)

    def test_group_retains_served_coefficients(self, rng):
        """A coalesced group's tenants keep, as warm starts, exactly the
        coefficients they were served (retained from the device result,
        one copy a group)."""
        x, y, _ = make_system(rng, 64, 16)
        ys = np.stack([y, 2 * y, -y], axis=1)
        eng = SolverServeEngine(device="cpu", registry=obs.MetricsRegistry())
        out = eng.serve([SolveRequest(x=x, y=ys[:, c], method="bakp", thr=8,
                                      max_iter=20, design_key="g",
                                      tenant_id=None if c == 1 else f"t{c}")
                         for c in range(3)])
        entry = eng.cache.get("g", record_stats=False)
        assert [t for t in entry._warm] == ["t0", "t2"]
        for c in (0, 2):
            warm = entry.warm_coef(f"t{c}")
            assert warm.shape == (16,)
            assert np.array_equal(warm.numpy(), out[c].coef)
        eng.shutdown()


class TestBatchAcrossDesigns:
    @pytest.mark.parametrize("method", ["bak", "bakp", "bakp_gram"])
    def test_batch_vs_reference_and_port_singles(self, method):
        """One batch of 5 designs (real obs 100..130, bucket 128 x 16),
        atol-only: against JAX's vmap batch, and against the port's own
        single solves of the same padded systems (n_sweeps per system
        equal)."""
        r = np.random.default_rng(5)
        systems = []
        for i in range(5):
            x = r.normal(size=(100 + 7 * i, 12)).astype(np.float32)
            y = (x @ r.normal(size=(12,)).astype(np.float32)
                 + 0.2 * r.normal(size=x.shape[0]).astype(np.float32))
            systems.append((x, y))

        def make(Req):
            return [Req(x=x, y=y, method=method, thr=8, max_iter=50,
                        atol=0.21, design_key=f"b{i}")
                    for i, (x, y) in enumerate(systems)]

        jeng, teng, jout, tout = _serve_both(make)
        assert [t.batch_kind for t in tout] == ["vmap"] * 5
        for j, t, (_, y) in zip(jout, tout, systems):
            _agree(j, t, y)
        assert len({t.n_sweeps for t in tout}) > 1, \
            "systems of one batch should stop at different sweeps"
        single = SolverServeEngine(ServeConfig(vmap_batch=False),
                                   registry=obs.MetricsRegistry(),
                                   device="cpu")
        sout = single.serve(make(SolveRequest))
        for s, t, (_, y) in zip(sout, tout, systems):
            assert s.batch_kind == "single"
            assert (t.n_sweeps, t.converged) == (s.n_sweeps, s.converged)
            c_scale = max(1.0, float(np.abs(s.coef).max()))
            assert float(np.abs(t.coef - s.coef).max()) <= TOL * c_scale
        assert teng.stats.vmap_batches == 1
        single.shutdown()
        teng.shutdown()

    def test_random_order_not_batchable(self, rng):
        from repro_torch.core.spec import SolverSpec, solver_method

        with pytest.raises(ValueError, match="not batchable"):
            solver_method("bak").vmap_one(SolverSpec(method="bak",
                                                     order="random"))


class TestEngine:
    def test_results_in_submission_order(self, rng):
        eng = SolverServeEngine(device="cpu")
        reqs = []
        for i in range(6):
            x = rng.normal(size=(40 + i, 4)).astype(np.float32)
            reqs.append(SolveRequest(x=x, y=x @ np.ones(4, np.float32),
                                     request_id=f"tag-{i}", thr=4,
                                     max_iter=40, rtol=1e-12))
        out = eng.serve(reqs)
        assert [r.request_id for r in out] == [f"tag-{i}" for i in range(6)]
        eng.shutdown()

    def test_cache_hits_for_repeated_design(self, rng):
        eng = SolverServeEngine(device="cpu")
        x = rng.normal(size=(200, 16)).astype(np.float32)

        def mk():
            a = rng.normal(size=(16,)).astype(np.float32)
            return SolveRequest(x=x, y=x @ a, thr=8, max_iter=40, rtol=1e-12)

        first = eng.serve([mk()])
        assert not first[0].cache_hit
        assert eng.cache.stats.hits == 0
        second = eng.serve([mk(), mk()])
        assert all(r.cache_hit for r in second)
        assert eng.cache.stats.hits == 1
        assert len(eng.cache) == 1
        entry = eng.cache.get(design_fingerprint(x), record_stats=False)
        assert entry.home == "single"
        assert entry.resident_lanes() == ("single",)
        eng.shutdown()

    def test_cache_lru_eviction(self, rng):
        eng = SolverServeEngine(ServeConfig(cache_entries=2), device="cpu")
        for i in range(4):
            x = rng.normal(size=(50, 4)).astype(np.float32)
            eng.serve([SolveRequest(x=x, y=x[:, 0], thr=4, max_iter=20)])
        assert len(eng.cache) == 2
        assert eng.cache.stats.evictions == 2
        eng.shutdown()

    def test_coalescing_off_falls_back(self, rng):
        eng = SolverServeEngine(ServeConfig(coalesce=False,
                                            vmap_batch=False), device="cpu")
        x = rng.normal(size=(64, 8)).astype(np.float32)
        out = eng.serve([SolveRequest(x=x, y=x[:, 0], thr=8, max_iter=30,
                                      rtol=1e-12) for _ in range(3)])
        assert all(r.batch_kind == "single" for r in out)
        np.testing.assert_allclose(out[0].coef, _lstsq(x, x[:, 0]),
                                   rtol=1e-3, atol=1e-3)
        eng.shutdown()

    def test_atol_corrected_for_padding(self, rng):
        """obs=300 pads to 512; the engine's solve must take exactly as
        many sweeps as the direct unpadded solve (the port's and JAX's)."""
        x, y, _ = make_system(rng, 300, 24, noise=0.3)
        atol = 0.35
        direct = solvebak(torch.from_numpy(x), torch.from_numpy(y),
                          max_iter=50, atol=atol)
        jdirect = j_solvebak(jnp.array(x), jnp.array(y), max_iter=50,
                             atol=atol)
        assert int(direct.n_sweeps) == int(jdirect.n_sweeps)
        eng = SolverServeEngine(device="cpu")
        served, = eng.serve([SolveRequest(x=x, y=y, method="bak",
                                          max_iter=50, atol=atol)])
        assert served.n_sweeps == int(direct.n_sweeps)
        assert served.converged == bool(direct.converged)
        assert 1 <= int(direct.n_sweeps) < 50
        eng.shutdown()

    @pytest.mark.parametrize("seed", [1, 4, 6])
    def test_lstsq_on_padded_bucket_matches_reference(self, seed):
        """A coalesced lstsq group on a bucket with zero-padded columns
        (60 x 6 in 64 x 8): the minimum-norm solution, as JAX's engine
        gives it (torch.linalg.lstsq's default driver got these seeds
        wrong)."""
        r = np.random.default_rng(seed)
        x = r.normal(size=(60, 6)).astype(np.float32)
        ys = [x @ r.normal(size=(6,)).astype(np.float32) for _ in range(2)]

        def make(Req):
            return [Req(x=x, y=y, method="lstsq") for y in ys]

        jeng, teng, jout, tout = _serve_both(make)
        for j, t, y in zip(jout, tout, ys):
            assert t.batch_kind == "multi_rhs" and t.bucket == (64, 8)
            _agree(j, t, y)
            np.testing.assert_allclose(t.coef, _lstsq(x, y), rtol=1e-4,
                                       atol=1e-4)
        teng.shutdown()

    def test_direct_methods_served_singly(self, rng):
        eng = SolverServeEngine(device="cpu")
        x = rng.normal(size=(60, 6)).astype(np.float32)
        a = rng.normal(size=(6,)).astype(np.float32)
        out = eng.serve([SolveRequest(x=x, y=x @ a, method="lstsq")
                         for _ in range(2)])
        assert all(r.batch_kind in ("single", "multi_rhs") for r in out)
        for r in out:
            np.testing.assert_allclose(r.coef, a, rtol=1e-3, atol=1e-3)
        eng.shutdown()


# ---------------------------------------------- fused route and precision
class TestFusedAndPrecision:
    def test_prefer_fused_vs_reference_bakp(self):
        """prefer_fused upgrades "bakp" to "bakp_fused" (the whole-solve
        kernel's plain version here): the same iterate as JAX's engine
        serving "bakp" with prefer_fused off, at fixed sweeps."""
        r = np.random.default_rng(6)
        xs = [r.normal(size=(96, 16)).astype(np.float32) for _ in range(2)]
        ys = [xs[i % 2] @ r.normal(size=(16,)).astype(np.float32)
              for i in range(6)]

        def make(Req):
            return [Req(x=xs[i % 2], y=ys[i], method="bakp", thr=8,
                        max_iter=25, design_key=f"pf{i % 2}",
                        tenant_id=f"t{i}")
                    for i in range(6)]

        jeng = J.SolverServeEngine(J.ServeConfig(),
                                   registry=jobs.MetricsRegistry())
        teng = SolverServeEngine(ServeConfig(prefer_fused=True),
                                 registry=obs.MetricsRegistry(),
                                 device="cpu")
        for _ in range(2):  # cold, then warm from the retained coefs
            jout = jeng.serve(make(J.SolveRequest))
            tout = teng.serve(make(SolveRequest))
            for j, t, y in zip(jout, tout, ys):
                _agree(j, t, y)
                assert t.telemetry.method == "bakp_fused"
                assert t.telemetry.kernel_path == "fused"
                assert t.telemetry.lane == "single:fused"
        assert teng.stats.as_dict() == jeng.stats.as_dict()
        assert teng.stats.multi_rhs_groups == 4
        assert teng.lanes.stats()["single:fused"]["batches"] == 4
        teng.shutdown()

    def test_bak_fused_vs_reference_bak(self, rng):
        x, y, _ = make_system(rng, 90, 12, noise=0.2)

        def make(Req, method):
            return [Req(x=x, y=y + 0.01 * i, method=method, thr=4,
                        max_iter=20, design_key="bf") for i in range(3)]

        jeng = J.SolverServeEngine(J.ServeConfig(),
                                   registry=jobs.MetricsRegistry())
        teng = SolverServeEngine(ServeConfig(),
                                 registry=obs.MetricsRegistry(),
                                 device="cpu")
        jout = jeng.serve(make(J.SolveRequest, "bak"))
        tout = teng.serve(make(SolveRequest, "bak_fused"))
        for j, t in zip(jout, tout):
            _agree(j, t, y)
            assert t.telemetry.kernel_path == "fused"
        teng.shutdown()

    def test_precision_policy_and_downgrade(self, rng):
        x, y, _ = make_system(rng, 128, 16)
        eng = SolverServeEngine(ServeConfig(precision="bf16_fp32acc",
                                            prefer_fused=True),
                                registry=obs.MetricsRegistry(),
                                device="cpu")
        ref = SolverServeEngine(ServeConfig(prefer_fused=True),
                                registry=obs.MetricsRegistry(),
                                device="cpu")

        def make():
            return [SolveRequest(x=x, y=y, method="bakp", thr=8,
                                 max_iter=40, rtol=1e-9, design_key="p"),
                    SolveRequest(x=x, y=y, method="lstsq", design_key="p")]

        out = eng.serve(make())
        base = ref.serve(make())
        assert all(r.ok for r in out)
        assert eng.spec_for(make()[0]).precision == "bf16_fp32acc"
        assert eng.spec_for(make()[1]).precision == "fp32"
        assert out[0].telemetry.method == "bakp_fused"
        assert eng.registry.get("solver_fallback_total").value(
            method="lstsq", reason="precision") == 1
        # The request ran its effective spec (bf16 x, then the fp32
        # polish): the handle's own solve of it, and near fp32's.
        from repro_torch.core import prepare

        own = prepare(x, device="cpu").solve(y, spec=eng.spec_for(make()[0]))
        assert float(np.abs(out[0].coef - own.coef.numpy()).max()) <= 1e-6
        assert float(np.abs(out[0].coef - base[0].coef).max()) <= 1e-3
        assert float(np.abs(out[1].coef - base[1].coef).max()) <= 1e-5
        lat = eng.registry.get("serve_solve_latency_seconds")
        assert lat.count(precision="bf16_fp32acc") == 1
        eng.shutdown()
        ref.shutdown()
