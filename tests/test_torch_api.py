"""The port's handle API against the JAX handle: ``prepare(...).solve(y,
a0)`` for every method x single/multi-RHS x warm/cold, the recorded
dispatch paths, the tenant warm LRU, ``solve()`` / ``fit_linear_probe``,
fingerprints, state carried over with ``prepared_from_arrays``, the device
rule and the import boundary.

JAX's ``bakp_fused``, ``bak_fused`` and resident ``bakp_stream`` raise on
this tree's jax (their Pallas kernel), so the references for the port's
are JAX's ``bakp`` and ``bak`` handles, which share their semantics.  Coef agrees to 1e-5 of its
largest magnitude (at least 1), the residual to 1e-5 of the largest |y|:
``e = y - x @ coef`` carries the rounding of ``y``.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.obs as jobs
import repro_torch.core as T
from repro_torch.core import spec as tspec
from repro_torch.obs import consume_dispatch, fallback_counts

TOL = 1e-5
# Every registered method; bakf is single-RHS and ignores a0, so the
# handle grid below runs the others and bakf has tests of its own.
METHODS = ("bak", "bakp", "bakp_gram", "bakp_fused", "bak_fused",
           "bakp_stream", "lstsq", "normal", "bakf")
HANDLE_METHODS = tuple(m for m in METHODS if m != "bakf")
ITERATIVE = ("bak", "bakp", "bakp_gram", "bakp_fused", "bak_fused",
             "bakp_stream")
FUSED = ("bakp_fused", "bak_fused")
# The path each kernel method records on the port's CPU path (its kernel's
# plain version); the others record "xla", as JAX's do.
KERNEL_PATH = {"bakp_fused": "fused", "bak_fused": "fused",
               "bakp_stream": "stream"}


def _spec(mod, method, **kw):
    if method in ("lstsq", "normal"):
        return mod.SolverSpec(method=method, **kw)
    return mod.SolverSpec(method=method, max_iter=60, rtol=1e-12, thr=8, **kw)


def _jax_method(method):
    if method == "bakp_stream":
        return "bakp"
    return method[:-len("_fused")] if method in FUSED else method


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(a, b, tol=TOL, scale=None):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    ref = np.abs(b if scale is None else _np(scale)).max()
    assert np.abs(a - b).max() <= tol * max(1.0, float(ref))


def _system(seed, obs=300, nvars=24, k=None, noise=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(obs, nvars)).astype(np.float32)
    a = rng.normal(size=(nvars,) if k is None else (nvars, k)).astype(np.float32)
    y = (x @ a + noise * rng.normal(size=(obs,) if k is None
                                    else (obs, k))).astype(np.float32)
    return x, a, y


@pytest.mark.parametrize("method", HANDLE_METHODS)
@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_handle_matches_jax(method, k, warm):
    x, a, y = _system(100, k=k)
    a0 = (a + 0.1).astype(np.float32) if warm else None
    consume_dispatch()
    r = T.prepare(x, _spec(T, method), device="cpu").solve(y, a0)
    path = consume_dispatch()
    jr = J.prepare(x, _spec(J, _jax_method(method))).solve(y, a0)
    jpath = jobs.consume_dispatch()
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual, scale=y)
    assert r.coef.device.type == "cpu"
    if method in KERNEL_PATH:
        assert path == KERNEL_PATH[method]
    else:
        assert path == jpath == "xla"
    if method in ("lstsq", "normal"):
        assert int(r.n_sweeps) == 1 and bool(r.converged)


def test_jax_fused_records_the_same_path():
    """JAX records ``fused`` before its kernel raises on this jax, so the
    recorded path is comparable even though the result is not."""
    x, _, y = _system(101)
    jobs.consume_dispatch()
    try:
        J.prepare(x, _spec(J, "bakp_fused")).solve(y)
    except Exception:  # noqa: BLE001 — the JAX Pallas kernel may raise
        pass
    assert jobs.consume_dispatch() == "fused"
    T.prepare(x, _spec(T, "bakp_fused"), device="cpu").solve(y)
    assert consume_dispatch() == "fused"


def test_fused_over_budget_falls_back_like_jax(monkeypatch):
    import importlib
    cd = importlib.import_module("repro_torch.kernels.cd_sweep")
    monkeypatch.setattr(cd, "ON_CHIP_BUDGET_BYTES", 1024)
    x, _, y = _system(102, nvars=21)          # 21 % 8 != 0: padded layout
    before = fallback_counts().get(("bakp_fused", "vmem"), 0)
    r = T.prepare(x, _spec(T, "bakp_fused"), device="cpu").solve(y)
    assert consume_dispatch() == "xla"
    assert fallback_counts()[("bakp_fused", "vmem")] == before + 1
    jr = J.prepare(x, _spec(J, "bakp")).solve(y)
    _close(r.coef, jr.coef)


@pytest.mark.parametrize("k", [None, 2])
def test_fused_pads_a0_and_truncates_coef(k):
    x, a, y = _system(103, nvars=21, k=k)
    a0 = (0.9 * a).astype(np.float32)
    r = T.prepare(x, _spec(T, "bakp_fused"), device="cpu").solve(y, a0)
    assert consume_dispatch() == "fused"
    assert tuple(r.coef.shape) == a.shape
    jr = J.prepare(x, _spec(J, "bakp")).solve(y, a0)
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual, scale=y)


@pytest.mark.parametrize("method", ITERATIVE)
def test_tenant_warm_solve_matches_jax(method):
    x, a, y = _system(104)
    y2 = (y + 0.01 * x @ np.ones(24, np.float32)).astype(np.float32)
    tp = T.prepare(x, _spec(T, method), device="cpu")
    jp = J.prepare(x, _spec(J, _jax_method(method)))
    cold = tp.solve(y, tenant_id="t0")
    jp.solve(y, tenant_id="t0")
    _close(tp.warm_coef("t0"), jp.warm_coef("t0"))
    warm = tp.solve(y2, tenant_id="t0")
    jwarm = jp.solve(y2, tenant_id="t0")
    _close(warm.coef, jwarm.coef)
    _close(warm.residual, jwarm.residual, scale=y2)
    assert int(warm.n_sweeps) < int(cold.n_sweeps)


def test_tenant_lru_and_shape_gate():
    x, _, y = _system(105, obs=64, nvars=8)
    p = T.prepare(x, _spec(T, "bakp"), device="cpu", max_tenants=2)
    for t in ("a", "b", "c"):
        p.solve(y, tenant_id=t)
    assert p.warm_coef("a") is None and p.warm_coef("c") is not None
    stored = p.warm_coef("c")
    # A multi-RHS solve whose k does not match the stored coef starts cold.
    r = p.solve(np.stack([y, y, y], 1), tenant_id="c")
    assert tuple(r.coef.shape) == (8, 3)
    assert tuple(p.warm_coef("c").shape) == (8, 3)
    assert tuple(stored.shape) == (8,)
    # Direct methods neither read nor store tenant state.
    p.solve(y, spec=_spec(T, "lstsq"), tenant_id="z")
    assert p.warm_coef("z") is None


def test_diverged_solve_is_not_retained():
    """Jacobi within a block of near-duplicate columns blows up; with the
    full budget spent on a rising history the coefficients are dropped, as
    in the JAX handle."""
    rng = np.random.default_rng(106)
    base = rng.normal(size=(200, 1)).astype(np.float32)
    x = (base + 0.01 * rng.normal(size=(200, 8))).astype(np.float32)
    y = (x @ rng.normal(size=8)).astype(np.float32)
    for mod in (T, J):
        spec = mod.SolverSpec(method="bakp", thr=8, max_iter=5)
        p = (T.prepare(x, spec, device="cpu") if mod is T
             else J.prepare(x, spec))
        r = p.solve(y, tenant_id="t")
        assert not bool(r.converged)
        assert p.warm_coef("t") is None


def test_solve_shim_and_linear_probe():
    x, a, y = _system(107)
    r = T.solve(x, y, method="bakp", thr=8, max_iter=60, rtol=1e-12,
                device="cpu")
    jr = J.solve(jnp.asarray(x), jnp.asarray(y), method="bakp", thr=8,
                 max_iter=60, rtol=1e-12)
    _close(r.coef, jr.coef)
    feats = x.reshape(3, 100, 24)
    targets = np.stack([y, 2 * y], -1).reshape(3, 100, 2)
    pr = T.fit_linear_probe(feats, targets, method="bakp_gram", thr=8,
                            device="cpu")
    jpr = J.fit_linear_probe(jnp.asarray(feats), jnp.asarray(targets),
                             method="bakp_gram", thr=8)
    assert tuple(pr.coef.shape) == (24, 2)
    _close(pr.coef, jpr.coef)
    with pytest.raises(ValueError, match="do not match"):
        T.fit_linear_probe(feats, targets[:, :50], device="cpu")


def test_fingerprint_matches_jax():
    x, _, _ = _system(108)
    fp = T.design_fingerprint(x)
    assert fp == J.design_fingerprint(x)
    assert fp == T.design_fingerprint(torch.tensor(x))
    assert (T.prepare(x, device="cpu").design_key()
            == J.prepare(x).design_key())


def test_prepared_from_arrays_carries_jax_state():
    x, a, y = _system(109, nvars=20)
    jspec = _spec(J, "bakp_gram")
    jp = J.prepare(x, jspec)
    jp.solve(y, tenant_id="t0")
    y2 = (y + 0.05).astype(np.float32)
    chol = {key: np.asarray(v) for key, v in jp.chol.items()}
    warm = {t: np.asarray(c) for t, c in jp._warm.items()}
    tp = T.prepared_from_arrays(np.asarray(jp.x_pad),
                                fingerprint=jp.design_key(), chol=chol,
                                warm=warm, spec=_spec(T, "bakp_gram"),
                                device="cpu")
    assert tp.design_key() == jp.design_key()
    key = (8, 1e-6)
    assert tp.chol[key].data_ptr() == tp.chol_for(8, 1e-6).data_ptr()
    _close(tp.chol[key], chol[key])
    _close(tp.warm_coef("t0"), warm["t0"])
    r = tp.solve(y2, tenant_id="t0")
    jr = jp.solve(y2, tenant_id="t0")
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual, scale=y2)


def test_spec_and_registry_match_jax():
    for m in METHODS:
        ts, js = _spec(T, m, omega=0.9, ridge=1e-4), _spec(J, m, omega=0.9,
                                                           ridge=1e-4)
        assert (tspec.dataclasses.asdict(ts.canonical())
                == J.spec.dataclasses.asdict(js.canonical()))
        te, je = T.solver_method(m), J.solver_method(m)
        for f in ("consumes", "iterative", "multi_rhs", "blocked",
                  "needs_chol", "streams", "lane", "fallback"):
            assert getattr(te, f) == getattr(je, f), (m, f)
        assert te.precisions == je.precisions
        assert te.batchable == je.batchable
        assert te.shardable == je.shardable, m
        assert (te.vmap_one is None) == (je.vmap_one is None)
    assert set(T.method_names()) == set(METHODS)
    assert T.streaming_methods() == J.spec.streaming_methods()
    assert T.shardable_methods() == J.spec.shardable_methods()
    with pytest.raises(ValueError, match="method must be one of"):
        T.SolverSpec(method="bakp_unregistered")


def test_every_fallback_resolves():
    """Each registered fallback names a registered method, and the
    degradation chains end at a direct method, as in the JAX registry."""
    for m in T.method_names():
        seen, cur = [m], T.solver_method(m).fallback
        while cur is not None:
            assert cur in T.method_names(), (m, cur)
            assert cur not in seen, seen
            seen.append(cur)
            cur = T.solver_method(cur).fallback
    chain, cur = ["bakp"], "bakp"
    while T.solver_method(cur).fallback is not None:
        cur = T.solver_method(cur).fallback
        chain.append(cur)
    assert chain == ["bakp", "bakp_stream", "lstsq"]


def test_unsupported_specs_raise():
    x, _, y = _system(110, obs=64, nvars=8)
    with pytest.raises(T.UnsupportedSpecError):
        T.prepare(x, T.SolverSpec(method="bakp_stream",
                                  precision="bf16_fp32acc"), device="cpu")
    p = T.prepare(x, _spec(T, "bakp"), device="cpu")
    with pytest.raises(T.UnsupportedSpecError):
        p.solve(y, spec=T.SolverSpec(method="bakp", precision="bf16"))

    # A sharded placement runs the method's sharded backend (here on a
    # one-shard CPU mesh, where it is the single-device solve); a method
    # registered without one raises.
    from repro_torch.serve.placement import OBS_SHARDED, build_serve_mesh

    smesh = build_serve_mesh("1", device="cpu")
    res = p.solve(y, placement=OBS_SHARDED, mesh=smesh)
    ref = p.solve(y)
    np.testing.assert_allclose(res.coef.numpy(), ref.coef.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert "obs_sharded" in p.resident_lanes()
    with pytest.raises(T.UnsupportedSpecError, match="sharded"):
        p.solve(y, spec=_spec(T, "lstsq"), placement=OBS_SHARDED,
                mesh=smesh)
    with pytest.raises(ValueError, match="no SolverSpec"):
        T.prepare(x, device="cpu").solve(y)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    x, _, y = _system(111, obs=64, nvars=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.prepare(x, _spec(T, "bakp"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.solve(x, y, method="bakp")


# ------------------------------------------------ Algorithms 1 and 3
def test_jax_bak_fused_records_the_same_path():
    x, _, y = _system(112)
    jobs.consume_dispatch()
    try:
        J.prepare(x, _spec(J, "bak_fused")).solve(y)
    except Exception:  # noqa: BLE001 — the JAX Pallas kernel may raise
        pass
    assert jobs.consume_dispatch() == "fused"
    T.prepare(x, _spec(T, "bak_fused"), device="cpu").solve(y)
    assert consume_dispatch() == "fused"


@pytest.mark.parametrize("k", [None, 2])
def test_bak_fused_over_budget_falls_back_like_jax(monkeypatch, k):
    import importlib
    cd = importlib.import_module("repro_torch.kernels.cd_sweep")
    jcd = importlib.import_module("repro.kernels.cd_sweep")
    monkeypatch.setattr(cd, "ON_CHIP_BUDGET_BYTES", 1024)
    monkeypatch.setattr(jcd, "VMEM_BUDGET_BYTES", 1024)
    x, a, y = _system(113, nvars=21, k=k)
    a0 = (0.5 * a).astype(np.float32)
    before = fallback_counts().get(("bak_fused", "vmem"), 0)
    r = T.prepare(x, _spec(T, "bak_fused"), device="cpu").solve(y, a0)
    assert consume_dispatch() == "xla"
    assert fallback_counts()[("bak_fused", "vmem")] == before + 1
    jr = J.prepare(x, _spec(J, "bak_fused")).solve(y, a0)
    assert jobs.consume_dispatch() == "xla"
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual, scale=y)


@pytest.mark.parametrize("k", [None, 3])
def test_bak_random_order_converges_to_jax(k):
    """The two random streams differ, so the solutions are compared at
    convergence (rtol 0, a fixed budget well past the fp32 floor)."""
    import jax
    x, a, y = _system(114, k=k, noise=0.0)
    spec_kw = dict(max_iter=80, order="random")
    g = torch.Generator().manual_seed(3)
    p = T.prepare(x, T.SolverSpec(method="bak", **spec_kw), device="cpu")
    r = p.solve(y, generator=g)
    assert consume_dispatch() == "xla"
    jr = J.prepare(x, J.SolverSpec(method="bak", **spec_kw)).solve(
        y, key=jax.random.PRNGKey(3))
    _close(r.coef, jr.coef)
    _close(r.coef, a)
    shim = T.solve(x, y, method="bak", order="random", max_iter=80,
                   generator=torch.Generator().manual_seed(3), device="cpu")
    _close(shim.coef, r.coef, tol=0.0)
    with pytest.raises(ValueError, match="Generator"):
        p.solve(y)


def test_bakf_handle_matches_jax():
    x, a, y = _system(115, nvars=20)
    spec_kw = dict(method="bakf", max_iter=12, thr=8)
    r = T.prepare(x, T.SolverSpec(**spec_kw), device="cpu").solve(
        y, a0=np.ones(20, np.float32))            # ignored: not iterative
    assert consume_dispatch() == "xla"
    jr = J.prepare(x, J.SolverSpec(**spec_kw)).solve(y)
    assert jobs.consume_dispatch() == "xla"
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual, scale=y)
    _close(r.sse, jr.sse, scale=jr.sse)
    assert int(r.n_sweeps) == int(jr.n_sweeps) == 20 and bool(r.converged)
    assert tuple(r.history.shape) == (12,) and np.isnan(_np(r.history)[1:]).all()


def test_bakf_rejects_multi_rhs():
    x, _, y = _system(116, k=2)
    p = T.prepare(x, T.SolverSpec(method="bakf", thr=8), device="cpu")
    with pytest.raises(ValueError, match="multi-RHS"):
        p.solve(y)
    with pytest.raises(ValueError, match="multi-RHS"):
        J.prepare(x, J.SolverSpec(method="bakf", thr=8)).solve(y)


def test_import_pulls_in_no_jax_and_no_repro():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
        "repro_torch.obs, repro_torch.core.solvebak, "
        "repro_torch.core.solvebakf, repro_torch.core.precondition, "
        "repro_torch.kernels.block_update, repro_torch.kernels.ref, "
        "repro_torch.kernels.stream_solve, repro_torch.store\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_no_jax_and_needs_a_gpu(tmp_path):
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    src = (root / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from repro." not in src
    assert "from repro import" not in src
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, str(root / "chip_smoke.py")],
                             capture_output=True, text=True, timeout=300,
                             cwd=tmp_path)
        assert out.returncode != 0 and '"ok"' not in out.stdout
