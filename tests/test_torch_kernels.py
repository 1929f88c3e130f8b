"""repro_torch.kernels against repro.kernels on the CPU (the CUDA kernels
against their plain versions are in test_torch_cuda.py).

JAX's ``fused_solve`` raises on this tree's jax (Pallas ``CostEstimate``
drift), and so does its ``cd_sweep`` (``pl.store`` is gone), so the port's
whole-solve path is held against JAX's ``solvebakp(mode="jacobi")`` and
``solvebakp_persweep_kernel`` (Algorithm 2) and ``solvebak`` (Algorithm 1),
and its Algorithm-1 sweep against ``ref_cd_sweep``, which share their
semantics.  ``score_features`` and ``block_update`` run in interpret mode
and are compared directly.  Tolerance: coef and residual to 1e-5; n_sweeps
exactly only for rtol=0 and atol-only runs.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvebak as j_solvebak
from repro.core import solvebakp as j_solvebakp
from repro.kernels import bakp_sweep as j_bakp_sweep
from repro.kernels import block_update as j_block_update_k
from repro.kernels import block_update_kernel as j_block_update_kernel
from repro.kernels import score_features as j_score_features
from repro.kernels import score_features_kernel as j_score_features_kernel
from repro.kernels import solvebakp_persweep_kernel as j_persweep
from repro.kernels.cd_sweep import bak_row_update as j_bak_row_update
from repro.kernels.cd_sweep import bakp_block_update as j_block_update
from repro.kernels.fused_solve import fused_vmem_bytes as j_fused_bytes
from repro.kernels.ref import ref_bakp_sweep as j_ref_sweep
from repro.kernels.ref import ref_block_update as j_ref_block_update
from repro.kernels.ref import ref_cd_sweep as j_ref_cd_sweep
from repro.kernels.ref import ref_score_features as j_ref_score_features
from repro_torch.kernels import (_build, bakp_sweep, block_update,
                                 block_update_kernel, cd_sweep, fused_fits,
                                 fused_solve, fused_working_set_bytes,
                                 score_features, score_features_kernel,
                                 solvebakp_kernel, solvebakp_persweep_kernel,
                                 solvebakp_stream_kernel)
from repro_torch.kernels.block_update import (block_update_plain,
                                              score_chunks,
                                              score_features_plain)
from repro_torch.kernels.cd_sweep import (bak_row_update, bakp_block_update,
                                          bakp_sweep_plain, cd_sweep_plain)
from repro_torch.kernels.fused_solve import fused_solve_plain, solve_init
from repro_torch.kernels.ref import (ref_bakp_sweep, ref_block_update,
                                     ref_cd_sweep, ref_score_features)
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
    with pytest.raises(ValueError, match="unknown variant"):
        fused_solve(x_t, yt, block=8, variant="bakq")
    with pytest.raises(ValueError, match="unknown variant"):
        solvebakp_kernel(x_t, yt, block=8, variant="bakq")
    with pytest.raises(ValueError, match="unknown variant"):
        solvebakp_persweep_kernel(x_t, yt, block=8, variant="bakq")
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


# ------------------------------------------- the whole-solve kernel's plan
@pytest.mark.parametrize("k", [1, 8])
def test_fused_plan_keeps_x_in_shared_memory_at_phase_1(k):
    """16,384 x 256 at thr 128 (chip_smoke.py's phase 1): 7 clusters of 16,
    L = 160; each CTA holds its 163,840-byte slice of x, its residual
    slice and one exchange of every right-hand side (12,784 bytes at k 8)
    within one CTA's shared memory."""
    plan = _CD.bakp_plan("fused", 16_384, k, 128, nvars=256)
    assert (plan.regime, plan.ctas, plan.cluster, plan.clusters, plan.L) == (
        "multi_cluster", 112, 16, 7, 160)
    assert (plan.x_in, plan.e_in, plan.stages, plan.group) == (
        "shared", "shared", 0, k)
    assert plan.smem == (_CD.bakp_exchange_bytes(128, k, 16)
                         + 4 * 256 * 160 + 4 * k * 160)
    assert plan.smem <= _CD.SMEM_PER_CTA_BYTES
    if k == 8:
        assert plan.smem == 12_784 + 163_840 + 5_120
    assert plan.xchg_words == 4 * 7 * (16 * _CD.bakp_own(128, k, 16) + 2)


def test_fused_plan_takes_more_ctas_to_keep_x_in_shared_memory():
    """8,192 x 448: at MIN_OBS_PER_CTA obs a CTA (4 clusters, L = 128) the
    slice of x does not fit a CTA; on 6 clusters (L = 96) it does."""
    layout = _CD.bakp_layout(8_192, cluster=16)
    assert layout[1:] == (64, 16, 4, 128)
    assert (_CD.bakp_exchange_bytes(128, 8, 16) + 4 * (448 + 8) * 128
            > _CD.SMEM_PER_CTA_BYTES)
    plan = _CD.bakp_plan("fused", 8_192, 8, 128, nvars=448)
    assert (plan.x_in, plan.ctas, plan.clusters, plan.L, plan.group) == (
        "shared", 96, 6, 96, 8)
    assert plan.smem <= _CD.SMEM_PER_CTA_BYTES


def test_fused_plan_streams_x_from_l2_over_shared_memory():
    """16,384 x 512 (32 MiB, within fused_fits): no CTA the card holds can
    keep its slice of x (332,800 bytes with the residual at L = 160), so
    each block's tile comes through the two-stage ring from the L2."""
    assert fused_fits(512, 16_384, 8, 4, max_iter=100)
    assert 4 * (512 + 8) * 160 > _CD.SMEM_PER_CTA_BYTES
    plan = _CD.bakp_plan("fused", 16_384, 8, 128, nvars=512)
    assert (plan.x_in, plan.stages, plan.e_in, plan.ctas, plan.L,
            plan.group) == ("ring", 2, "shared", 112, 160, 8)
    assert plan.smem == 12_784 + 2 * 4 * 128 * 160 + 4 * 8 * 160
    assert plan.smem <= _CD.SMEM_PER_CTA_BYTES
    # The streaming kernel's plan at the same shape carves the same bytes.
    assert plan.smem == _CD.bakp_plan("stream", 16_384, 8, 128).smem


def test_fused_plan_groups_right_hand_sides():
    """Block 256 at k 64 on the phase 1 design: one exchange of all 64
    right-hand sides (200,944 bytes) does not fit beside the slices of x
    and e (204,800), so a block step runs them in 8 groups of 8; a
    design whose slices leave room runs fewer, wider groups."""
    slices = 4 * (256 + 64) * 160
    assert (_CD.bakp_exchange_bytes(256, 64, 16) + slices
            > _CD.SMEM_PER_CTA_BYTES)
    plan = _CD.bakp_plan("fused", 16_384, 64, 256, nvars=256)
    assert (plan.x_in, plan.group) == ("shared", 8)
    assert plan.smem == _CD.bakp_exchange_bytes(256, 8, 16) + slices
    assert plan.smem <= _CD.SMEM_PER_CTA_BYTES
    assert plan.xchg_words == 4 * 7 * (16 * _CD.bakp_own(256, 8, 16) + 2)
    assert fused_fits(256, 16_384, 64, 4, max_iter=100)
    # Groups spread evenly: 9 right-hand sides where 8 fit are 2 groups
    # of 5 (the last one 4), not 8 and 1.
    room = _CD.bakp_exchange_bytes(256, 8, 16)
    assert _CD._group(256, 9, 16, room) == 5
    assert _CD._group(256, 9, 16, room - 1) == 3


def test_fused_plan_reads_large_blocks_in_place():
    """Block 2,048: one tile is 1.3 MB at L = 160, so neither the slice of
    x nor the ring fits a CTA, and x and the residual are read in place; a
    block whose exchange of one right-hand side overflows a CTA raises."""
    plan = _CD.bakp_plan("fused", 16_384, 1, 2_048, nvars=2_048)
    assert (plan.x_in, plan.e_in, plan.stages, plan.group) == (
        "direct", "device", 0, 1)
    assert plan.smem == _CD.bakp_exchange_bytes(2_048, 1, 16)
    with pytest.raises(ValueError, match="reduce block"):
        _CD.bakp_plan("fused", 256, 1, 32_768, nvars=32_768)


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
    solvebakp_kernel(torch.tensor(x.T.copy()), torch.tensor(y), block=8,
                     max_iter=3, variant="bak")
    score_features_kernel(torch.tensor(x.T.copy()), torch.tensor(y))
    block_update_kernel(torch.tensor(x.T.copy()), torch.tensor(y),
                        torch.ones(8))
    solvebakp_stream_kernel(torch.tensor(x.T.copy()), torch.tensor(y),
                            block=8, max_iter=3)
    # CPU tensors run the plain versions: nothing was launched.
    assert _build.launch_counts() == {
        "bakp_sweep": 0, "fused_solve": 0, "bak_sweep": 0, "bak_fused": 0,
        "score_features": 0, "block_update": 0, "stream_solve": 0}



# --------------------------------------------------- Algorithm-1 sweep
@pytest.mark.parametrize("k", [None, 1, 4])
def test_cd_sweep_matches_jax_ref(k):
    x_t, inv, e = _sweep_inputs(31, 256, 32, k)
    args = (torch.tensor(x_t), torch.tensor(e), torch.tensor(inv))
    jda, je2 = j_ref_cd_sweep(jnp.asarray(x_t), jnp.asarray(e),
                              jnp.asarray(inv))
    for da, e2 in (cd_sweep(*args, block=8), ref_cd_sweep(*args)):
        assert tuple(da.shape) == jda.shape and tuple(e2.shape) == je2.shape
        _close(da, jda)
        _close(e2, je2)
    assert float(np.abs(_np(da)[-1]).max()) == 0.0   # zero-norm column
    e2d = args[1] if k is not None else args[1][None]
    pda, pe2 = cd_sweep_plain(args[0], e2d, args[2])
    _close(pda.reshape(jda.shape), jda)
    _close(pe2.reshape(je2.shape), je2)


def test_bak_row_update_matches_jax():
    x_t, inv, e = _sweep_inputs(32, 128, 4, 3)
    da, e2 = bak_row_update(torch.tensor(x_t[1:2]), float(inv[1]),
                            torch.tensor(e))
    jda, je2 = j_bak_row_update(jnp.asarray(x_t[1:2]), jnp.float32(inv[1]),
                                jnp.asarray(e))
    _close(da, jda)
    _close(e2, je2)


def test_cd_sweep_rejects_ragged_block_and_other_devices():
    x_t, inv, e = _sweep_inputs(33, 64, 12, None)
    with pytest.raises(ValueError, match="multiple of block"):
        cd_sweep(torch.tensor(x_t), torch.tensor(e), torch.tensor(inv),
                 block=8)
    meta = torch.empty((16, 64), device="meta")
    with pytest.raises(ValueError, match="cd_sweep runs on cpu or cuda"):
        cd_sweep(meta, torch.empty(64, device="meta"),
                 torch.empty(16, device="meta"), block=8)


# --------------------------------------------- Algorithm-1 whole solve
@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("warm", [False, True])
def test_fused_bak_matches_jax_solvebak(k, warm):
    x, a, y = _system(34, k=k)
    a0 = (0.8 * a).astype(np.float32) if warm else None
    r = fused_solve(torch.tensor(x.T.copy()), torch.tensor(y),
                    a0=None if a0 is None else torch.tensor(a0), block=8,
                    max_iter=25, omega=0.5, variant="bak")   # omega unused
    jr = j_solvebak(jnp.asarray(x), jnp.asarray(y), max_iter=25,
                    a0=None if a0 is None else jnp.asarray(a0))
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual)
    assert int(r.n_sweeps) == int(jr.n_sweeps) == 25
    _close(r.history, jr.history, rtol=1e-4, atol=1e-4)


def test_fused_bak_atol_only_stops_on_the_same_sweep():
    x, _, y = _system(35, noise=0.0)
    r = fused_solve(torch.tensor(x.T.copy()), torch.tensor(y), block=8,
                    max_iter=200, atol=1e-3, variant="bak")
    jr = j_solvebak(jnp.asarray(x), jnp.asarray(y), max_iter=200, atol=1e-3)
    assert int(r.n_sweeps) == int(jr.n_sweeps) < 200
    assert bool(r.converged) and bool(jr.converged)
    _close(r.coef, jr.coef)


@pytest.mark.parametrize("budget,max_iter,path,reason", [
    (None, 20, "fused", None),
    (6 * 1024, 20, "persweep", "vmem"),
    (None, 0, "persweep", "max_iter"),
])
def test_solvebakp_kernel_bak_dispatch(monkeypatch, budget, max_iter, path,
                                       reason):
    x, _, y = _system(36, obs=128, nvars=16, k=2)
    if budget is not None:
        monkeypatch.setattr(_CD, "ON_CHIP_BUDGET_BYTES", budget)
    before = fallback_counts().get(("bak", reason), 0)
    runs = dispatch_counts().get((path, "bak"), 0)
    consume_dispatch()
    r = solvebakp_kernel(torch.tensor(x.T.copy()), torch.tensor(y), block=8,
                         max_iter=max_iter, variant="bak")
    assert consume_dispatch() == path
    assert dispatch_counts()[(path, "bak")] == runs + 1
    if reason:
        assert fallback_counts()[("bak", reason)] == before + 1
    if max_iter == 0:
        assert int(r.n_sweeps) == 0 and not bool(r.converged)
        _close(r.residual, y)
        return
    jr = j_solvebak(jnp.asarray(x), jnp.asarray(y), max_iter=max_iter)
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual)
    assert int(r.n_sweeps) == int(jr.n_sweeps) == max_iter


@pytest.mark.parametrize("k", [None, 2])
def test_persweep_bak_matches_jax_solvebak(k):
    x, a, y = _system(37, k=k)
    a0 = (0.5 * a).astype(np.float32)
    r = solvebakp_persweep_kernel(torch.tensor(x.T.copy()), torch.tensor(y),
                                  a0=torch.tensor(a0), block=8, max_iter=15,
                                  variant="bak")
    jr = j_solvebak(jnp.asarray(x), jnp.asarray(y), a0=jnp.asarray(a0),
                    max_iter=15)
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual)
    _close(r.history, jr.history, rtol=1e-4, atol=1e-4)
    assert int(r.n_sweeps) == int(jr.n_sweeps) == 15


# ------------------------------------------------------ feature scores
@pytest.mark.parametrize("nvars,obs", [(16, 256), (24, 1000)])
def test_score_features_matches_jax(nvars, obs):
    rng = np.random.default_rng(38)
    x_t = rng.normal(size=(nvars, obs)).astype(np.float32)
    e = rng.normal(size=obs).astype(np.float32)
    inv = (1.0 / np.einsum("vo,vo->v", x_t, x_t)).astype(np.float32)
    js = j_score_features(jnp.asarray(x_t), jnp.asarray(e), jnp.asarray(inv))
    args = (torch.tensor(x_t), torch.tensor(e), torch.tensor(inv))
    scale = float(np.abs(np.asarray(js)).max())
    for s in (score_features(*args), score_features_plain(*args),
              ref_score_features(*args)):
        _close(s, js, rtol=1e-5, atol=1e-5 * scale)
    _close(ref_score_features(*args),
           j_ref_score_features(*map(jnp.asarray, (x_t, e, inv))),
           rtol=1e-5, atol=1e-5 * scale)
    jk = j_score_features_kernel(jnp.asarray(x_t), jnp.asarray(e))
    _close(score_features_kernel(args[0], args[1]), jk, rtol=1e-5,
           atol=1e-5 * scale)


def test_score_features_validation_and_chunks():
    x_t = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="takes e"):
        score_features(x_t, torch.zeros((2, 64)), torch.zeros(4))
    with pytest.raises(ValueError, match="cpu or cuda"):
        score_features(x_t.to("meta"), torch.zeros(64, device="meta"),
                       torch.zeros(4, device="meta"))
    # Chunks tile obs in 128-multiples; few rows get more chunks.
    for nvars, obs in [(1024, 262144), (7, 1001), (5000, 300), (1, 5)]:
        chunk, n = score_chunks(nvars, obs)
        assert chunk % 128 == 0 and (n - 1) * chunk < obs <= n * chunk
    assert score_chunks(1024, 262144)[1] == 5
    assert score_chunks(5000, 300)[1] == 1


# ---------------------------------------------------------- block update
@pytest.mark.parametrize("k", [None, 1, 3])
def test_block_update_matches_jax(k):
    rng = np.random.default_rng(39)
    x_blk = rng.normal(size=(8, 512)).astype(np.float32)
    e = rng.normal(size=(512,) if k is None else (k, 512)).astype(np.float32)
    da = rng.normal(size=(8,) if k is None else (8, k)).astype(np.float32)
    jb = j_block_update_k(jnp.asarray(x_blk), jnp.asarray(e),
                          jnp.asarray(da))
    args = (torch.tensor(x_blk), torch.tensor(e), torch.tensor(da))
    for out in (block_update(*args), block_update_kernel(*args),
                ref_block_update(*args)):
        assert tuple(out.shape) == jb.shape
        _close(out, jb)
    _close(ref_block_update(*args),
           j_ref_block_update(*map(jnp.asarray, (x_blk, e, da))))
    _close(block_update_kernel(*args),
           j_block_update_kernel(*map(jnp.asarray, (x_blk, e, da))))
    e2 = args[1].reshape(-1, 512)
    _close(block_update_plain(args[0], e2, args[2].reshape(8, -1)),
           np.asarray(jb).reshape(-1, 512))


def test_block_update_validation():
    with pytest.raises(ValueError, match="do not match"):
        block_update(torch.zeros((8, 64)), torch.zeros((2, 64)),
                     torch.zeros(8))
    with pytest.raises(ValueError, match="cpu or cuda"):
        block_update(torch.zeros((8, 64), device="meta"),
                     torch.zeros(64, device="meta"),
                     torch.zeros(8, device="meta"))
