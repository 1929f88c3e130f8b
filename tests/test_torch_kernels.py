"""repro_torch.kernels against repro.kernels on the CPU (the CUDA kernels
against their plain versions are in test_torch_cuda.py).

JAX's ``fused_solve`` raises on this tree's jax (Pallas ``CostEstimate``
drift), so the port's whole-solve path is held against JAX's
``solvebakp(mode="jacobi")`` and ``solvebakp_persweep_kernel``, which share
its semantics.  Tolerance: coef and residual to 1e-5; n_sweeps exactly only
for rtol=0 and atol-only runs.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvebakp as j_solvebakp
from repro.kernels import bakp_sweep as j_bakp_sweep
from repro.kernels import solvebakp_persweep_kernel as j_persweep
from repro.kernels.cd_sweep import bakp_block_update as j_block_update
from repro.kernels.fused_solve import fused_vmem_bytes as j_fused_bytes
from repro.kernels.ref import ref_bakp_sweep as j_ref_sweep
from repro_torch.kernels import (_build, bakp_sweep, fused_fits, fused_solve,
                                 fused_working_set_bytes, solvebakp_kernel,
                                 solvebakp_persweep_kernel)
from repro_torch.kernels.cd_sweep import bakp_block_update, bakp_sweep_plain
from repro_torch.kernels.fused_solve import fused_solve_plain, solve_init
from repro_torch.kernels.ref import ref_bakp_sweep
from repro_torch.obs import (consume_dispatch, dispatch_counts,
                             fallback_counts)

TOL = dict(rtol=1e-5, atol=1e-5)
_CD = importlib.import_module("repro_torch.kernels.cd_sweep")


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **(tol or TOL))


def _system(seed, obs=256, nvars=32, k=None, noise=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(obs, nvars)).astype(np.float32)
    a = rng.normal(size=(nvars,) if k is None else (nvars, k)).astype(np.float32)
    y = (x @ a + noise * rng.normal(size=(obs,) if k is None
                                    else (obs, k))).astype(np.float32)
    return x, a, y


def _sweep_inputs(seed, obs, nvars, k):
    rng = np.random.default_rng(seed)
    x_t = rng.normal(size=(nvars, obs)).astype(np.float32)
    inv = (1.0 / np.einsum("vo,vo->v", x_t, x_t)).astype(np.float32)
    inv[-1] = 0.0                      # a zero-norm column pins its update
    e = rng.normal(size=(obs,) if k is None else (k, obs)).astype(np.float32)
    return x_t, inv, e


# ------------------------------------------------------------ per sweep
@pytest.mark.parametrize("k", [None, 1, 4])
@pytest.mark.parametrize("block,omega", [(8, 1.0), (16, 0.7)])
def test_bakp_sweep_matches_jax(k, block, omega):
    x_t, inv, e = _sweep_inputs(10, 256, 32, k)
    da, e2 = bakp_sweep(torch.tensor(x_t), torch.tensor(e), torch.tensor(inv),
                        block=block, omega=omega)
    jda, je2 = j_bakp_sweep(jnp.asarray(x_t), jnp.asarray(e),
                            jnp.asarray(inv), block=block, omega=omega)
    assert tuple(da.shape) == jda.shape and tuple(e2.shape) == je2.shape
    _close(da, jda)
    _close(e2, je2)


@pytest.mark.parametrize("k", [None, 3])
def test_ref_bakp_sweep_matches_jax_ref(k):
    x_t, inv, e = _sweep_inputs(11, 200, 24, k)
    da, e2 = ref_bakp_sweep(torch.tensor(x_t), torch.tensor(e),
                            torch.tensor(inv), block=8, omega=0.9)
    jda, je2 = j_ref_sweep(jnp.asarray(x_t), jnp.asarray(e), jnp.asarray(inv),
                           block=8, omega=0.9)
    _close(da, jda)
    _close(e2, je2)
    # The kernel's plain version agrees with the oracle.
    e2d = e if k is not None else e[None]
    pda, pe2 = bakp_sweep_plain(torch.tensor(x_t), torch.tensor(e2d),
                                torch.tensor(inv), block=8, omega=0.9)
    _close(pda.reshape(da.shape), da)
    _close(pe2.reshape(e2.shape), e2)


def test_bakp_block_update_matches_jax():
    x_t, inv, e = _sweep_inputs(12, 128, 16, 2)
    da, e2 = bakp_block_update(torch.tensor(x_t), torch.tensor(inv[:, None]),
                               torch.tensor(e), 0.8)
    jda, je2 = j_block_update(jnp.asarray(x_t), jnp.asarray(inv[:, None]),
                              jnp.asarray(e), 0.8)
    _close(da, jda)
    _close(e2, je2)


def test_bakp_sweep_rejects_ragged_block_and_other_devices():
    x_t, inv, e = _sweep_inputs(13, 64, 12, None)
    with pytest.raises(ValueError, match="multiple of block"):
        bakp_sweep(torch.tensor(x_t), torch.tensor(e), torch.tensor(inv),
                   block=8)
    meta = torch.empty((16, 64), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        bakp_sweep(meta, torch.empty(64, device="meta"),
                   torch.empty(16, device="meta"), block=8)


# ---------------------------------------------------------- whole solve
@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("warm", [False, True])
def test_fused_matches_jax_solvebakp(k, warm):
    x, a, y = _system(20, k=k)
    a0 = (0.8 * a).astype(np.float32) if warm else None
    r = fused_solve(torch.tensor(x.T.copy()), torch.tensor(y),
                    a0=None if a0 is None else torch.tensor(a0), block=8,
                    max_iter=30)
    jr = j_solvebakp(jnp.asarray(x), jnp.asarray(y), thr=8, max_iter=30,
                     a0=None if a0 is None else jnp.asarray(a0))
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual)
    assert int(r.n_sweeps) == int(jr.n_sweeps) == 30
    _close(r.history, jr.history, rtol=1e-4, atol=1e-4)
    assert bool(r.converged) == bool(jr.converged)


@pytest.mark.parametrize("k", [None, 3])
def test_fused_matches_jax_persweep_kernel(k):
    x, a, y = _system(21, k=k)
    r = fused_solve(torch.tensor(x.T.copy()), torch.tensor(y), block=16,
                    max_iter=25, omega=0.9)
    jr = j_persweep(jnp.asarray(x.T), jnp.asarray(y), block=16, max_iter=25,
                    omega=0.9)
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual)
    assert int(r.n_sweeps) == int(jr.n_sweeps) == 25


def test_fused_atol_only_stops_on_the_same_sweep():
    x, _, y = _system(22, noise=0.0)
    kw = dict(block=8, max_iter=200, atol=1e-3)
    r = fused_solve(torch.tensor(x.T.copy()), torch.tensor(y), **kw)
    jr = j_persweep(jnp.asarray(x.T), jnp.asarray(y), **kw)
    assert int(r.n_sweeps) == int(jr.n_sweeps) < 200
    assert bool(r.converged) and bool(jr.converged)
    _close(r.coef, jr.coef)


def test_fused_rtol_run_within_one_sweep():
    x, _, y = _system(23, k=2)
    kw = dict(block=8, max_iter=200, rtol=1e-6)
    r = fused_solve(torch.tensor(x.T.copy()), torch.tensor(y), **kw)
    jr = j_persweep(jnp.asarray(x.T), jnp.asarray(y), **kw)
    assert abs(int(r.n_sweeps) - int(jr.n_sweeps)) <= 1
    _close(r.coef, jr.coef)


def test_fused_takes_cn_and_inv_cn():
    x, _, y = _system(24)
    x_t = torch.tensor(x.T.copy())
    cn = (x_t * x_t).sum(1)
    r1 = fused_solve(x_t, torch.tensor(y), cn=cn, block=8, max_iter=10)
    r2 = fused_solve(x_t, torch.tensor(y), inv_cn=1.0 / cn, block=8,
                     max_iter=10)
    r3 = fused_solve(x_t, torch.tensor(y), block=8, max_iter=10)
    _close(r1.coef, r3.coef)
    _close(r2.coef, r3.coef)


def test_solve_init_broadcasts_a0_over_rhs():
    x, a, y = _system(25, k=3)
    x_t = torch.tensor(x.T.copy())
    a0 = torch.tensor(a[:, 0])
    _, a0m, e0 = solve_init(x_t, torch.tensor(y), None, a0, True)
    assert tuple(a0m.shape) == (32, 3) and tuple(e0.shape) == (3, 256)
    _close(e0, (y - x @ a[:, :1]).T, rtol=1e-4, atol=1e-4)


def test_fused_validation():
    x, _, y = _system(26, obs=128, nvars=16)
    x_t, yt = torch.tensor(x.T.copy()), torch.tensor(y)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        fused_solve(x_t, yt, block=8, variant="bak")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        solvebakp_kernel(x_t, yt, block=8, variant="bak")
    with pytest.raises(ValueError, match="multiple of block"):
        fused_solve(x_t, yt, block=7)
    with pytest.raises(ValueError, match="max_iter"):
        fused_solve(x_t, yt, block=8, max_iter=0)
    with pytest.raises(ValueError, match="a0 must be"):
        fused_solve(x_t, yt, block=8, a0=torch.zeros(5))


def test_working_set_accounting_matches_jax_formula():
    for args in [(128, 1024, 2, 4), (256, 16384, 8, 4), (64, 512, 1, 2)]:
        assert (fused_working_set_bytes(*args, max_iter=50)
                == j_fused_bytes(*args, max_iter=50))
    assert fused_fits(256, 16384, 8, 4, max_iter=100)
    assert not fused_fits(1024, 262144, 8, 4, max_iter=100)


def test_fused_raises_over_budget(monkeypatch):
    x, _, y = _system(27, obs=128, nvars=16)
    monkeypatch.setattr(_CD, "ON_CHIP_BUDGET_BYTES", 1024)
    with pytest.raises(ValueError, match="on-chip budget"):
        fused_solve(torch.tensor(x.T.copy()), torch.tensor(y), block=8)


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("budget,max_iter,path,reason", [
    (None, 30, "fused", None),
    (6 * 1024, 30, "persweep", "vmem"),
    (None, 0, "persweep", "max_iter"),
])
def test_solvebakp_kernel_dispatch(monkeypatch, budget, max_iter, path,
                                   reason):
    x, _, y = _system(28, obs=128, nvars=16)
    if budget is not None:
        monkeypatch.setattr(_CD, "ON_CHIP_BUDGET_BYTES", budget)
    before = fallback_counts().get(("bakp", reason), 0)
    runs = dispatch_counts().get((path, "bakp"), 0)
    consume_dispatch()
    r = solvebakp_kernel(torch.tensor(x.T.copy()), torch.tensor(y), block=8,
                         max_iter=max_iter)
    assert consume_dispatch() == path
    assert dispatch_counts()[(path, "bakp")] == runs + 1
    if reason:
        assert fallback_counts()[("bakp", reason)] == before + 1
    if max_iter == 0:
        # No sweep runs: the start point comes back (JAX's solvers cannot
        # trace a zero-length history, so there is no reference call).
        assert int(r.n_sweeps) == 0 and not bool(r.converged)
        _close(r.coef, np.zeros(16, np.float32))
        _close(r.residual, y)
        return
    jr = j_solvebakp(jnp.asarray(x), jnp.asarray(y), thr=8,
                     max_iter=max_iter)
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual)
    assert int(r.n_sweeps) == int(jr.n_sweeps) == max_iter


@pytest.mark.parametrize("k", [None, 2])
def test_persweep_matches_jax_persweep(k):
    x, a, y = _system(29, k=k)
    a0 = (0.5 * a).astype(np.float32)
    r = solvebakp_persweep_kernel(torch.tensor(x.T.copy()), torch.tensor(y),
                                  a0=torch.tensor(a0), block=8, max_iter=20)
    jr = j_persweep(jnp.asarray(x.T), jnp.asarray(y), a0=jnp.asarray(a0),
                    block=8, max_iter=20)
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual)
    _close(r.history, jr.history, rtol=1e-4, atol=1e-4)
    assert int(r.n_sweeps) == int(jr.n_sweeps) == 20


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_lib_path",
                        lambda name: _build.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("bakp_sweep")


def test_launch_counts_track_kernels_only():
    _build.reset_launch_counts()
    x, _, y = _system(30, obs=64, nvars=8)
    solvebakp_kernel(torch.tensor(x.T.copy()), torch.tensor(y), block=8,
                     max_iter=3)
    # CPU tensors run the plain versions: nothing was launched.
    assert _build.launch_counts() == {"bakp_sweep": 0, "fused_solve": 0}
