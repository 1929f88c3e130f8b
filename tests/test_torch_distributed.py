"""The port's sharded SolveBakP (``repro_torch.core.distributed``) against
``repro.core.distributed``.

* ``TestAgainstJaxMesh``: one subprocess with 8 forced CPU devices runs
  JAX's four solvers on ``make_debug_mesh((4, 2))`` and the port's on
  ``make_debug_mesh((4, 2), devices=["cpu"] * 8)`` (eight virtual shards),
  on the same numpy inputs: the cases of ``tests/test_distributed_solver.py``'s
  script and the multi-RHS (512 x 64, k 32) solves cold, warm and from a
  ``(vars,)`` start, for every sharding.  Each case is a test here.
  coef and residual agree to 1e-5 of the reference's scale (max |coef|,
  max |y|: the residual of a converged solve is rounding noise), sweep
  counts exactly (rtol 0), histories within rtol 1e-4 plus 1e-7 of the
  first sweep's SSE (the fp32 SSE floor of a converged solve differs by
  reduction order).  A solve warm-started at the exact coefficients sits
  at that floor from its first sweep, so its history is held to JAX's own
  limit for it instead (every SSE below 1e-4).
* In process, JAX's (1, 1)-mesh regressions against the port's (1, 1)
  mesh: the vars-sharded history, the divergence flag, the rhs-sharded API
  and its messages, and the mesh builder.
* The port's 8-shard CPU mesh against its own single-device ``solvebakp``.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_system
from repro.core import solvebakp_rhs_sharded as j_rhs
from repro.core import solvebakp_vars_sharded as j_vars
from repro.launch.mesh import make_debug_mesh as j_mesh
from repro_torch.core import (solvebakp, solvebakp_2d, solvebakp_obs_sharded,
                              solvebakp_rhs_sharded, solvebakp_vars_sharded)
from repro_torch.core.distributed import ShardedDesign, shard_x
from repro_torch.launch.mesh import Mesh, make_debug_mesh, make_mesh

TOL = 1e-5

# (name, kind, y: "single" | "multi", a0: None | "exact" | "vector", knobs)
CASES = [
    ("obs_gram", "obs", "single", None, dict(thr=16, max_iter=50)),
    ("obs_gram_5", "obs", "single", None, dict(thr=16, max_iter=5)),
    ("obs_jacobi", "obs", "single", None,
     dict(thr=8, max_iter=80, mode="jacobi")),
    ("vars_gram", "vars", "single", None,
     dict(thr=16, max_iter=100, omega=0.5)),
    ("2d_gram", "2d", "single", None, dict(thr=16, max_iter=100, omega=0.5)),
] + [
    (f"{kind}_k32_{start or 'cold'}", kind, "multi", start,
     dict(thr=16, max_iter=3 if start == "exact" else 20,
          **({"omega": 0.5} if kind in ("vars", "2d") else {})))
    for kind in ("obs", "rhs", "vars", "2d")
    for start in (None, "exact", "vector")
]

SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax.numpy as jnp, torch
    import repro.core as J
    import repro_torch.core as T
    from repro.launch.mesh import make_debug_mesh as j_mesh
    from repro_torch.launch.mesh import make_debug_mesh as t_mesh

    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    jm = j_mesh((4, 2), ("data", "model"))
    tm = t_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(512, 64)).astype(np.float32)
    a_true = rng.normal(size=(64,)).astype(np.float32)
    A = rng.normal(size=(64, 32)).astype(np.float32)
    a1 = rng.normal(size=(64,)).astype(np.float32)
    ys = {"single": x @ a_true, "multi": x @ A}
    starts = {None: None, "exact": A, "vector": a1}
    fns = {"obs": "solvebakp_obs_sharded", "vars": "solvebakp_vars_sharded",
           "2d": "solvebakp_2d", "rhs": "solvebakp_rhs_sharded"}
    for name, kind, ykey, start, knobs in cases:
        y, a0 = ys[ykey], starts[start]
        knobs = {"mode": "gram", **knobs}
        jr = getattr(J, fns[kind])(
            jnp.array(x), jnp.array(y), jm,
            a0=None if a0 is None else jnp.array(a0), **knobs)
        tr = getattr(T, fns[kind])(
            torch.from_numpy(x), torch.from_numpy(y), tm,
            a0=None if a0 is None else torch.from_numpy(a0), **knobs)
        arrays = {}
        for pkg, r, conv in (("j", jr, np.asarray),
                             ("t", tr, lambda v: v.numpy())):
            for f in ("coef", "residual", "history", "n_sweeps", "sse",
                      "converged"):
                arrays[f"{pkg}_{f}"] = np.asarray(conv(getattr(r, f)))
        arrays["y"] = y
        np.savez(os.path.join(out_dir, name + ".npz"), **arrays)
    print("PARITY_DONE")
""")


@pytest.fixture(scope="module")
def jax_vs_port(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_parity")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(out),
                        json.dumps(CASES)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stdout + "\n" + p.stderr
    assert "PARITY_DONE" in p.stdout
    return out


class TestAgainstJaxMesh:
    @pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
    def test_case(self, jax_vs_port, case):
        r = np.load(jax_vs_port / f"{case[0]}.npz")
        c_scale = float(np.abs(r["j_coef"]).max())
        assert float(np.abs(r["t_coef"] - r["j_coef"]).max()) <= TOL * c_scale
        assert r["t_residual"].shape == r["j_residual"].shape
        y_scale = float(np.abs(r["y"]).max())
        assert (float(np.abs(r["t_residual"] - r["j_residual"]).max())
                <= TOL * y_scale)
        assert int(r["t_n_sweeps"]) == int(r["j_n_sweeps"])  # rtol 0
        n = int(r["j_n_sweeps"])
        if case[3] == "exact":
            assert float(r["t_history"][:n].max()) < 1e-4
            assert float(r["j_history"][:n].max()) < 1e-4
        else:
            np.testing.assert_allclose(
                r["t_history"][:n], r["j_history"][:n], rtol=1e-4,
                atol=1e-7 * float(r["j_history"][0]))
        assert bool(r["t_converged"]) == bool(r["j_converged"])


# --------------------------------------------------- in-process, (1, 1) mesh
@pytest.fixture(scope="module")
def meshes():
    return (j_mesh((1, 1), ("data", "model")),
            make_debug_mesh((1, 1), ("data", "model"), devices=["cpu"]))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


class TestVarsShardedHistory:
    def test_history_holds_sse_trace(self, rng, meshes):
        jm, tm = meshes
        x, y, _ = make_system(rng, 128, 32)
        n = 6
        r = solvebakp_vars_sharded(_t(x), _t(y), tm, thr=8, max_iter=n,
                                   mode="gram", omega=0.5)
        h = r.history.numpy()
        assert h.shape == (n,)
        assert np.all(np.isfinite(h[:n]))
        assert h[0] <= float(np.dot(y, y)) + 1e-3
        assert np.all(np.diff(h) <= 1e-5 * np.maximum(h[:-1], 1.0))
        # on a one-shard mesh vars-sharding is the single-device solver,
        # and JAX's (1, 1)-mesh solver
        ref = solvebakp(_t(x), _t(y), thr=8, max_iter=n, mode="gram",
                        omega=0.5)
        np.testing.assert_allclose(h, ref.history.numpy(), rtol=1e-5)
        jr = j_vars(jnp.array(x), jnp.array(y), jm, thr=8, max_iter=n,
                    mode="gram", omega=0.5)
        np.testing.assert_allclose(h, np.asarray(jr.history), rtol=1e-4)


def _diverging_system(rng, obs=256, nvars=32):
    base = rng.normal(size=(obs, 1)).astype(np.float32)
    x = base + 0.01 * rng.normal(size=(obs, nvars)).astype(np.float32)
    return x, (x @ np.ones(nvars, np.float32))


class TestDivergenceFlag:
    def test_sharded(self, rng, meshes):
        jm, tm = meshes
        x, y = _diverging_system(rng)
        kw = dict(thr=32, max_iter=50, mode="jacobi", omega=1.0, rtol=1e-8)
        r = solvebakp_vars_sharded(_t(x), _t(y), tm, **kw)
        jr = j_vars(jnp.array(x), jnp.array(y), jm, **kw)
        assert not bool(r.converged) and not bool(jr.converged)
        assert int(r.n_sweeps) < 50
        assert int(r.n_sweeps) == int(jr.n_sweeps)


class TestRhsShardedApi:
    def test_requires_multi_rhs(self, rng, meshes):
        jm, tm = meshes
        x, y, _ = make_system(rng, 64, 8)
        for fn, xx, yy, m in ((solvebakp_rhs_sharded, _t(x), _t(y), tm),
                              (j_rhs, jnp.array(x), jnp.array(y), jm)):
            with pytest.raises(ValueError, match="multi-RHS y=\\(obs, k\\)"):
                fn(xx, yy, m, thr=8)

    def test_one_device_matches_single(self, rng, meshes):
        jm, tm = meshes
        x, _, _ = make_system(rng, 96, 12)
        A = rng.normal(size=(12, 4)).astype(np.float32)
        Y = x @ A
        r1 = solvebakp_rhs_sharded(_t(x), _t(Y), tm, thr=8, max_iter=15,
                                   mode="gram")
        r2 = solvebakp(_t(x), _t(Y), thr=8, max_iter=15, mode="gram")
        np.testing.assert_allclose(r1.coef.numpy(), r2.coef.numpy(),
                                   rtol=1e-5, atol=1e-6)
        jr = j_rhs(jnp.array(x), jnp.array(Y), jm, thr=8, max_iter=15,
                   mode="gram")
        np.testing.assert_allclose(r1.coef.numpy(), np.asarray(jr.coef),
                                   rtol=1e-5, atol=1e-6)

    def test_bad_a0_shape_raises(self, rng, meshes):
        jm, tm = meshes
        x, _, _ = make_system(rng, 64, 8)
        Y = rng.normal(size=(64, 2)).astype(np.float32)
        msgs = []
        for fn, xx, yy, m, a0 in (
                (solvebakp_rhs_sharded, _t(x), _t(Y), tm, torch.zeros(5)),
                (j_rhs, jnp.array(x), jnp.array(Y), jm, jnp.zeros((5,)))):
            with pytest.raises(ValueError, match="a0 must be") as ei:
                fn(xx, yy, m, thr=8, a0=a0)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]

    def test_divisibility_messages_match(self, rng):
        """The shape checks raise JAX's messages (a (2, 1) CPU mesh for the
        port; JAX's checks run before it needs the devices)."""
        tm = make_debug_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
        x, _, _ = make_system(rng, 63, 8)
        Y = rng.normal(size=(63, 3)).astype(np.float32)
        with pytest.raises(ValueError, match="obs=63 must divide data axes "
                                             "size 2"):
            solvebakp_obs_sharded(_t(x), _t(Y), tm, thr=8)
        x, _, _ = make_system(rng, 64, 8)
        Y = rng.normal(size=(64, 3)).astype(np.float32)
        with pytest.raises(ValueError, match="k=3 must divide data axes "
                                             "size 2"):
            solvebakp_rhs_sharded(_t(x), _t(Y), tm, thr=8)
        tm2 = make_debug_mesh((1, 3), ("data", "model"), devices=["cpu"] * 3)
        with pytest.raises(ValueError, match="vars=8 must divide model axis "
                                             "size 3"):
            solvebakp_vars_sharded(_t(x), _t(Y), tm2, thr=8)
        with pytest.raises(ValueError, match="y must be"):
            solvebakp_obs_sharded(_t(x), torch.zeros(64, 2, 2), tm, thr=8)


def test_mesh_builder():
    """As JAX's mesh builder test: a one-axis mesh on the process's device,
    with JAX's shape mapping; distinct cards only when they exist."""
    m = make_debug_mesh((1,), ("data",), devices=["cpu"])
    assert isinstance(m, Mesh)
    assert m.shape["data"] == 1 and list(m.shape) == ["data"]
    assert torch.device("cpu") in list(m.devices.flat)
    jm = j_mesh((1,), ("data",))
    assert dict(m.shape) == dict(jm.shape)
    m8 = make_debug_mesh((4, 2), devices=["cpu"] * 8)
    assert tuple(m8.shape.items()) == (("data", 4), ("model", 2))
    assert m8.device_ids() == ("cpu",) * 8
    assert m8.distinct_devices() == (torch.device("cpu"),)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="needs 2 CUDA devices"):
            make_mesh((2,), ("data",))


# --------------------------------------- the 8-shard mesh against one device
@pytest.fixture(scope="module")
def mesh8():
    return make_debug_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def system():
    r = np.random.default_rng(5)
    x = r.normal(size=(256, 48)).astype(np.float32)
    a = r.normal(size=(48,)).astype(np.float32)
    A = r.normal(size=(48, 16)).astype(np.float32)
    return x, a, A


class TestEightShardsAgainstOneDevice:
    def test_obs_sweep_for_sweep(self, mesh8, system):
        x, a, _ = system
        r1 = solvebakp(_t(x), _t(x @ a), thr=16, max_iter=8, mode="gram")
        r8 = solvebakp_obs_sharded(_t(x), _t(x @ a), mesh8, thr=16,
                                   max_iter=8)
        h1 = r1.history.numpy()
        np.testing.assert_allclose(r8.history.numpy(), h1, rtol=1e-4,
                                   atol=1e-7 * h1[0])
        np.testing.assert_allclose(r8.coef.numpy(), r1.coef.numpy(),
                                   atol=1e-5 * np.abs(r1.coef.numpy()).max())

    @pytest.mark.parametrize("a0", [None, "vector"])
    def test_rhs_iterates_match_single(self, mesh8, system, a0):
        x, _, A = system
        start = None if a0 is None else _t(A[:, 0])
        r1 = solvebakp(_t(x), _t(x @ A), thr=16, max_iter=12, mode="gram",
                       a0=start)
        r8 = solvebakp_rhs_sharded(_t(x), _t(x @ A), mesh8, thr=16,
                                   max_iter=12, a0=start)
        np.testing.assert_allclose(r8.coef.numpy(), r1.coef.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert r8.residual.shape == r1.residual.shape == (256, 16)
        assert int(r8.n_sweeps) == int(r1.n_sweeps)

    def test_rhs_stop_is_group_global(self, mesh8, system):
        """With rtol the k shards stop together, within one sweep of the
        single-device multi-RHS solve (the SSE sums in another order)."""
        x, _, A = system
        kw = dict(thr=16, max_iter=200, mode="gram", rtol=1e-6)
        r1 = solvebakp(_t(x), _t(x @ A), **kw)
        r8 = solvebakp_rhs_sharded(_t(x), _t(x @ A), mesh8, **kw)
        assert bool(r8.converged)
        assert abs(int(r8.n_sweeps) - int(r1.n_sweeps)) <= 1

    @pytest.mark.parametrize("fn", [solvebakp_vars_sharded, solvebakp_2d],
                             ids=["vars", "2d"])
    def test_column_shards_converge(self, mesh8, system, fn):
        x, a, _ = system
        r = fn(_t(x), _t(x @ a), mesh8, thr=16, max_iter=150)
        assert float((r.coef - _t(a)).abs().max()) < 1e-3
        assert r.residual.shape == (256,)

    def test_layouts_and_shared_replicas(self, mesh8, system):
        x, _, _ = system
        xt = _t(x)
        nbytes = x.size * 4
        obs = shard_x(xt, mesh8, "obs")
        assert isinstance(obs, ShardedDesign)
        assert [tuple(p.shape) for p in obs.parts] == [(64, 48)] * 4
        assert obs.nbytes == nbytes
        np.testing.assert_array_equal(obs.part(2, 0).numpy(), x[128:192])
        two = shard_x(xt, mesh8, "2d", model_axis="model")
        assert len(two.parts) == 8 and two.nbytes == nbytes
        np.testing.assert_array_equal(two.part(1, 1).numpy(),
                                      x[64:128, 24:48])
        rhs = shard_x(xt, mesh8, "rhs")
        # one replica a distinct device: four shards on the CPU share it
        assert len(rhs.parts) == 4 and len({id(p) for p in rhs.parts}) == 1
        assert rhs.nbytes == nbytes
        assert all(p.data_ptr() != xt.data_ptr() for p in rhs.parts)
        # a laid-out design solves like the tensor it came from
        y = _t(x @ system[1])
        np.testing.assert_array_equal(
            solvebakp_obs_sharded(obs, y, mesh8, thr=16, max_iter=4)
            .coef.numpy(),
            solvebakp_obs_sharded(xt, y, mesh8, thr=16, max_iter=4)
            .coef.numpy())
        with pytest.raises(ValueError, match="laid out for 'obs'"):
            solvebakp_rhs_sharded(obs, _t(x @ system[2]), mesh8, thr=16)
