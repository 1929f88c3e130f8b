"""The CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one
(the kernels have no CPU mode; the CPU parity tests are
``test_torch_kernels.py`` and friends).  This file imports no JAX, so it
also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: 1e-4 of the reference's largest magnitude — the kernels sum in
a fixed cross-CTA order, cuBLAS in its own.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SolverSpec, prepare
from repro_torch.kernels import (_build, bakp_sweep, block_update, cd_sweep,
                                 fused_solve, score_features,
                                 score_features_kernel, solvebakp_kernel,
                                 stream_solve)
from repro_torch.kernels.block_update import (block_update_plain,
                                              score_features_plain)
from repro_torch.kernels.cd_sweep import bakp_sweep_plain, cd_sweep_plain
from repro_torch.kernels.fused_solve import (fused_cuda, fused_solve_plain,
                                             plain_rtol_stop, solve_init)
from repro_torch.obs import consume_dispatch

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within(a, b, scale=None, tol=TOL):
    ref = (b if scale is None else scale).abs().max().item() or 1.0
    return (a - b).abs().max().item() <= tol * ref


def _system(seed, obs, nvars, k, device):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(obs, nvars)).astype(np.float32)
    a = rng.normal(size=(nvars,) if k is None else (nvars, k)).astype(np.float32)
    y = x @ a
    return (torch.tensor(x, device=device), torch.tensor(a, device=device),
            torch.tensor(y, device=device))


def _want_plan(obs, cluster):
    """The regime and clusters ``cd_sweep.bakp_plan`` gives an H100."""
    from repro_torch.kernels.cd_sweep import CARD_CLUSTERS
    if obs <= cluster * 128:
        return "single_cluster", 1
    return "multi_cluster", min(CARD_CLUSTERS[cluster],
                                 min(-(-obs // 128), 132) // cluster)


@pytest.mark.parametrize("k,block,obs,nvars,cluster,e_in", [
    (1, 8, 2048, 256, 16, "shared"),        # one cluster
    (2, 16, 1000, 64, 8, "shared"),         # one cluster of 4, a ragged slice
    (3, 16, 4096, 256, 16, "shared"),       # two clusters
    (8, 128, 4096, 256, 4, "shared"),
    (8, 128, 16384, 256, 16, "shared"),     # 103 of 112 CTAs own obs
    (1, 32, 200000, 64, 4, "shared"),       # empty slices in the last cluster
    (3, 32, 200000, 64, 8, "shared"),
    (8, 32, 200000, 64, 16, "shared"),
    (9, 16, 200000, 32, 16, "shared"),      # two KC chunks
    (8, 32, 1000003, 32, 16, "device"),     # e in device memory; odd obs
])
def test_sweep_kernel_matches_plain(cuda, monkeypatch, k, block, obs, nvars,
                                    cluster, e_in):
    import importlib
    cd = importlib.import_module("repro_torch.kernels.cd_sweep")
    monkeypatch.setitem(cd.BAKP_CLUSTER, "sweep", cluster)
    rng = np.random.default_rng(40)
    x_t = torch.tensor(rng.normal(size=(nvars, obs)).astype(np.float32),
                       device=cuda)
    inv = 1.0 / (x_t * x_t).sum(1)
    e = torch.tensor(rng.normal(size=(k, obs)).astype(np.float32),
                     device=cuda)
    n0 = _build.launch_counts()["bakp_sweep"]
    da, e2 = bakp_sweep(x_t, e, inv, block=block)
    assert _build.launch_counts()["bakp_sweep"] == n0 + 1
    plan = _build.PLANS["bakp_sweep"]
    assert (plan.regime, plan.clusters) == _want_plan(obs, cluster)
    assert plan.ctas == plan.cluster * plan.clusters and plan.e_in == e_in
    pda, pe2 = bakp_sweep_plain(x_t, e, inv, block=block)
    assert _within(da, pda) and _within(e2, pe2, scale=e)


def test_sweep_kernel_splits_rhs_over_shared_memory(cuda):
    """block 256 x k 64: every RHS's exchange arrays do not fit one CTA's
    shared memory, so the wrapper launches the kernel on two groups of
    32, which compute what one launch would."""
    rng = np.random.default_rng(57)
    x_t = torch.tensor(rng.normal(size=(512, 4096)).astype(np.float32),
                       device=cuda)
    inv = 1.0 / (x_t * x_t).sum(1)
    e = torch.tensor(rng.normal(size=(64, 4096)).astype(np.float32),
                     device=cuda)
    n0 = _build.launch_counts()["bakp_sweep"]
    da, e2 = bakp_sweep(x_t, e, inv, block=256)
    assert _build.launch_counts()["bakp_sweep"] == n0 + 2
    pda, pe2 = bakp_sweep_plain(x_t, e, inv, block=256)
    assert da.shape == (512, 64) and e2.shape == (64, 4096)
    assert _within(da, pda) and _within(e2, pe2, scale=e)


@pytest.mark.parametrize("tag_limit", [None, 64])
def test_sweep_exchange_words_outlive_launches(cuda, monkeypatch, tag_limit):
    """A stream's cross-cluster words are kept from launch to launch, not
    zeroed: each launch's tags start past the last one's, through plans of
    other sizes (the words grow once) and, with a small tag limit, across
    the zeroing before the tags would wrap.  Every launch must still match
    the plain version."""
    import importlib
    cd = importlib.import_module("repro_torch.kernels.cd_sweep")
    if tag_limit is not None:
        monkeypatch.setattr(cd, "_TAG_LIMIT", tag_limit)
    rng = np.random.default_rng(58)
    words = []
    for obs, k in [(4096, 1), (20000, 3)] * 3:
        x_t = torch.tensor(rng.normal(size=(256, obs)).astype(np.float32),
                           device=cuda)
        inv = 1.0 / (x_t * x_t).sum(1)
        e = torch.tensor(rng.normal(size=(k, obs)).astype(np.float32),
                         device=cuda)
        da, e2 = bakp_sweep(x_t, e, inv, block=16)
        assert _build.PLANS["bakp_sweep"].regime == "multi_cluster"
        words.append(cd._xchg[(x_t.device, torch.cuda.current_stream(
            cuda).cuda_stream)][0])
        pda, pe2 = bakp_sweep_plain(x_t, e, inv, block=16)
        assert _within(da, pda) and _within(e2, pe2, scale=e)
    if tag_limit is None:
        assert all(w is words[1] for w in words[2:])


@pytest.mark.parametrize("k", [None, 8])
def test_fused_kernel_matches_plain(cuda, k):
    x, _, y = _system(41, 4096, 128, k, cuda)
    y = y + 0.1 * torch.randn(y.shape, device=cuda)
    x_t = x.T.contiguous()
    multi = y.dim() == 2
    inv, a0m, e0 = solve_init(x_t, y, None, None, multi)
    n0 = _build.launch_counts()["fused_solve"]
    r = fused_solve(x_t, y, block=32, max_iter=15)
    assert _build.launch_counts()["fused_solve"] == n0 + 1
    pc, pe, ph, _, pn, _ = fused_solve_plain(
        x_t, inv, e0, a0m, block=32, max_iter=15, atol_sse=0.0, rtol=0.0,
        omega=1.0)
    assert int(r.n_sweeps) == int(pn) == 15
    coef = r.coef if multi else r.coef[:, None]
    res = r.residual.T if multi else r.residual[None]
    assert _within(coef, pc) and _within(res, pe, scale=e0)
    assert _within(r.history, ph)


def test_fused_kernel_stops_like_plain(cuda):
    x, _, y = _system(42, 4096, 128, 4, cuda)
    x_t = x.T.contiguous()
    r = fused_solve(x_t, y, block=32, max_iter=200, rtol=1e-6)
    inv, a0m, e0 = solve_init(x_t, y, None, None, True)
    _, _, _, _, pn, pconv = fused_solve_plain(
        x_t, inv, e0, a0m, block=32, max_iter=200, atol_sse=0.0, rtol=1e-6,
        omega=1.0)
    assert abs(int(r.n_sweeps) - int(pn)) <= 1 and int(r.n_sweeps) < 200
    assert bool(r.converged) == bool(pconv)


@pytest.mark.parametrize("k,obs,nvars,block,warm,x_in,regime", [
    (None, 2048, 256, 32, False, "shared", "single_cluster"),
    (8, 2048, 256, 32, True, "shared", "single_cluster"),
    (None, 16384, 256, 128, True, "shared", "multi_cluster"),   # phase 1
    (8, 16384, 256, 128, False, "shared", "multi_cluster"),
    (3, 4099, 96, 16, False, "shared", "multi_cluster"),   # 4-byte copies
    (None, 2048, 2048, 32, False, "ring", "single_cluster"),
    (8, 2048, 2048, 32, True, "ring", "single_cluster"),
    (None, 8192, 1024, 64, True, "ring", "multi_cluster"),
    (8, 8192, 1024, 64, False, "ring", "multi_cluster"),
    (3, 4099, 2048, 16, True, "ring", "multi_cluster"),    # 4-byte copies
    (None, 8192, 1024, 1024, False, "direct", "multi_cluster"),
    (8, 8192, 1024, 1024, True, "direct", "multi_cluster"),
])
def test_fused_kernel_regimes_match_plain(cuda, k, obs, nvars, block, warm,
                                          x_in, regime):
    """The whole-solve kernel with x's slice in shared memory (x_shared),
    with each tile through the ring from the L2 (x_l2, designs whose slice
    does not fit a CTA) and with x read in place (blocks whose ring does
    not fit), on one cluster and on several, against the plain version."""
    x, a, y = _system(59, obs, nvars, k, cuda)
    y = y + 0.1 * torch.randn(y.shape, device=cuda)
    x_t = x.T.contiguous()
    multi = y.dim() == 2
    a0 = 0.5 * a if warm else None
    inv, a0m, e0 = solve_init(x_t, y, None, a0, multi)
    n0 = _build.launch_counts()["fused_solve"]
    r = fused_solve(x_t, y, a0=a0, block=block, max_iter=12)
    assert _build.launch_counts()["fused_solve"] == n0 + 1
    plan = _build.PLANS["fused_solve"]
    assert (plan.x_in, plan.regime) == (x_in, regime)
    assert plan.group == (3 if k == 3 else k or 1)
    pc, pe, ph, _, pn, _ = fused_solve_plain(
        x_t, inv, e0, a0m, block=block, max_iter=12, atol_sse=0.0, rtol=0.0,
        omega=1.0)
    assert int(r.n_sweeps) == int(pn) == 12
    coef = r.coef if multi else r.coef[:, None]
    res = r.residual.T if multi else r.residual[None]
    assert _within(coef, pc) and _within(res, pe, scale=e0)
    assert _within(r.history, ph)


@pytest.mark.parametrize("obs,nvars", [(16384, 256), (4096, 512)])
def test_fused_kernel_groups_rhs_in_one_launch(cuda, obs, nvars):
    """Block 256 at k 64: one exchange of all 64 right-hand sides does not
    fit a CTA beside the slices, so each block step runs them in groups,
    still in one launch with one joint stop."""
    x, _, y = _system(60, obs, nvars, 64, cuda)
    y = y + 0.1 * torch.randn(y.shape, device=cuda)
    x_t = x.T.contiguous()
    inv, a0m, e0 = solve_init(x_t, y, None, None, True)
    n0 = _build.launch_counts()["fused_solve"]
    r = fused_solve(x_t, y, block=256, max_iter=10)
    assert _build.launch_counts()["fused_solve"] == n0 + 1
    plan = _build.PLANS["fused_solve"]
    assert 1 < plan.group < 64 and plan.x_in == "shared"
    pc, pe, ph, _, pn, _ = fused_solve_plain(
        x_t, inv, e0, a0m, block=256, max_iter=10, atol_sse=0.0, rtol=0.0,
        omega=1.0)
    assert int(r.n_sweeps) == int(pn) == 10
    assert _within(r.coef, pc) and _within(r.residual.T, pe, scale=e0)
    assert _within(r.history, ph)


def _sse64(e):
    return float((e.double() * e.double()).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 8])
def test_fused_kernel_rtol_stop_at_phase_1(cuda, seed, k):
    """At rtol 1e-7 the stop falls where the SSE meets the residual's fp32
    floor.  On chip_smoke.py's phase 1 design (noise-free), the kernel must
    stop within one sweep of where the rule stops on the plain iterate's
    SSE summed in fp64, with a final residual whose fp64 SSE is within 2x
    of the plain version's: an update that rounds e once a column (an FMA
    chain into e) or a per-CTA SSE summed in fp32 breaks both."""
    x, _, y = _system(seed, 16384, 256, k, cuda)
    x_t = x.T.contiguous()
    inv, a0m, e0 = solve_init(x_t, y, None, None, y.dim() == 2)
    kw = dict(block=128, max_iter=100, atol_sse=0.0, rtol=1e-7, omega=1.0)
    _, ek, _, _, nk, _ = fused_cuda(x_t, inv, e0, a0m, **kw)
    assert _build.PLANS["fused_solve"].x_in == "shared"
    _, ep, _, _, np_, _ = fused_solve_plain(x_t, inv, e0, a0m, **kw)
    rule = plain_rtol_stop(x_t, inv, e0, block=128, rtol=1e-7, max_iter=100)
    assert rule is not None and abs(int(nk) - rule) <= 1, (int(nk), rule,
                                                           int(np_))
    assert _sse64(ek) <= 2 * _sse64(ep), (_sse64(ek), _sse64(ep))


@pytest.mark.parametrize("budget,path", [(None, "fused"), (1024, "persweep")])
def test_kernel_entry_dispatch_on_card(cuda, monkeypatch, budget, path):
    import importlib
    if budget is not None:
        monkeypatch.setattr(importlib.import_module(
            "repro_torch.kernels.cd_sweep"), "ON_CHIP_BUDGET_BYTES", budget)
    x, a, y = _system(43, 8192, 256, 2, cuda)
    _build.reset_launch_counts()
    consume_dispatch()
    r = solvebakp_kernel(x.T.contiguous(), y, block=128, max_iter=100,
                         rtol=1e-7)
    assert consume_dispatch() == path
    kernel = "fused_solve" if path == "fused" else "bakp_sweep"
    assert _build.launch_counts()[kernel] >= 1
    assert _within(r.coef, a)


def test_handle_on_card(cuda):
    x, a, y = _system(44, 8192, 200, None, cuda)   # 200 % 128: padded
    p = prepare(x, SolverSpec(method="bakp_fused", rtol=1e-7, max_iter=100))
    assert p.device.type == "cuda"
    r = p.solve(y, tenant_id="t")
    assert consume_dispatch() == "fused"
    assert r.coef.shape == (200,) and _within(r.coef, a)
    w = p.solve(y + 0.01 * x.sum(1), tenant_id="t")
    assert int(w.n_sweeps) <= int(r.n_sweeps)


# ------------------------------------------------- Algorithm 1 and entries
@pytest.mark.parametrize("k,obs,regime,e_in", [
    (1, 4096, "single_cluster", "registers"),
    (3, 4096, "single_cluster", "registers"),
    (9, 5003, "single_cluster", "shared"),   # two KC chunks, a ragged slice
    (8, 200000, "multi_cluster", "registers"),
    (8, 1000003, "e_device", "device"),
    (8, 3600003, "x_device", "device")])
def test_cd_sweep_kernel_matches_plain(cuda, k, obs, regime, e_in):
    """The plan's regime at each shape: one cluster holding the residual
    slices and the x ring; several clusters with the slices on chip;
    several with the slices in device memory (they do not fit shared
    memory), and with x read from device memory too (not even the ring
    fits).  Odd obs takes the ring's 4-byte copies."""
    from repro_torch.kernels.cd_sweep import bak_grid
    plan = bak_grid(_build.load("bak_sweep").bak_sweep_grid, obs, k)
    assert plan.regime == regime and plan.e_in == e_in
    assert plan.ctas == plan.cluster * plan.clusters
    assert (plan.clusters == 1) == (regime == "single_cluster")
    rng = np.random.default_rng(45)
    nvars = 32 if obs > 100000 else 128
    x_t = torch.tensor(rng.normal(size=(nvars, obs)).astype(np.float32),
                       device=cuda)
    inv = 1.0 / (x_t * x_t).sum(1)
    inv[-1] = 0.0
    e = torch.tensor(rng.normal(size=(k, obs)).astype(np.float32),
                     device=cuda)
    n0 = _build.launch_counts()["bak_sweep"]
    da, e2 = cd_sweep(x_t, e, inv, block=8)
    assert _build.launch_counts()["bak_sweep"] == n0 + 1
    assert _build.PLANS["bak_sweep"] == plan
    pda, pe2 = cd_sweep_plain(x_t, e, inv)
    assert _within(da, pda) and _within(e2, pe2, scale=e)
    assert float(da[-1].abs().max()) == 0.0


@pytest.mark.parametrize("k,obs,nvars,max_iter,regime,e_in", [
    (None, 4096, 128, 6, "single_cluster", "registers"),
    (8, 4096, 128, 6, "single_cluster", "registers"),
    (2, 100000, 64, 6, "single_cluster", "shared"),
    (8, 200000, 32, 6, "multi_cluster", "registers"),
    (8, 1000003, 16, 6, "e_device", "device"),
    (2, 3600003, 16, 3, "x_device", "device")])
def test_bak_fused_kernel_matches_plain(cuda, monkeypatch, k, obs, nvars,
                                        max_iter, regime, e_in):
    import importlib
    # The e_device design is over the on-chip budget, which fused_solve
    # enforces; the kernel itself takes it.
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.kernels.cd_sweep"), "ON_CHIP_BUDGET_BYTES", 1 << 40)
    x, _, y = _system(46, obs, nvars, k, cuda)
    y = y + 0.1 * torch.randn(y.shape, device=cuda)
    x_t = x.T.contiguous()
    multi = y.dim() == 2
    inv, a0m, e0 = solve_init(x_t, y, None, None, multi)
    n0 = _build.launch_counts()["bak_fused"]
    r = fused_solve(x_t, y, block=16, max_iter=max_iter, variant="bak")
    assert _build.launch_counts()["bak_fused"] == n0 + 1
    plan = _build.PLANS["bak_fused"]
    assert (plan.regime, plan.e_in) == (regime, e_in)
    pc, pe, ph, _, pn, _ = fused_solve_plain(
        x_t, inv, e0, a0m, block=16, max_iter=max_iter, atol_sse=0.0,
        rtol=0.0, omega=1.0, variant="bak")
    assert int(r.n_sweeps) == int(pn) == max_iter
    coef = r.coef if multi else r.coef[:, None]
    res = r.residual.T if multi else r.residual[None]
    assert _within(coef, pc) and _within(res, pe, scale=e0)
    assert _within(r.history, ph)


def test_bak_fused_kernel_stops_like_plain_across_clusters(cuda):
    """The stop decision with several clusters: every CTA must take the
    same one from the exchanged SSE, or the solve hangs."""
    x, _, y = _system(55, 200000, 32, 8, cuda)
    y = y + 0.1 * torch.randn(y.shape, device=cuda)
    x_t = x.T.contiguous()
    r = fused_solve(x_t, y, block=16, max_iter=200, rtol=1e-7,
                    variant="bak")
    assert _build.PLANS["bak_fused"].regime == "multi_cluster"
    inv, a0m, e0 = solve_init(x_t, y, None, None, True)
    _, _, _, _, pn, pconv = fused_solve_plain(
        x_t, inv, e0, a0m, block=16, max_iter=200, atol_sse=0.0, rtol=1e-7,
        omega=1.0, variant="bak")
    assert abs(int(r.n_sweeps) - int(pn)) <= 1 and int(r.n_sweeps) < 200
    assert bool(r.converged) and bool(pconv)


def test_bak_kernel_entry_stops_and_solves(cuda):
    x, a, y = _system(47, 8192, 128, 2, cuda)
    consume_dispatch()
    r = solvebakp_kernel(x.T.contiguous(), y, block=128, max_iter=100,
                         rtol=1e-7, variant="bak")
    assert consume_dispatch() == "fused"
    assert int(r.n_sweeps) < 100 and bool(r.converged)
    assert _within(r.coef, a)


def test_score_features_kernel_matches_plain(cuda):
    rng = np.random.default_rng(48)
    for nvars, obs in [(1024, 65536), (7, 1001), (300, 4099)]:
        x_t = torch.tensor(rng.normal(size=(nvars, obs)).astype(np.float32),
                           device=cuda)
        e = torch.tensor(rng.normal(size=obs).astype(np.float32),
                         device=cuda)
        inv = 1.0 / (x_t * x_t).sum(1)
        n0 = _build.launch_counts()["score_features"]
        s = score_features(x_t, e, inv)
        assert _build.launch_counts()["score_features"] == n0 + 1
        assert _within(s, score_features_plain(x_t, e, inv))
    assert _within(score_features_kernel(x_t, e),
                   score_features_plain(x_t, e, inv))


@pytest.mark.parametrize("k,obs", [(None, 65536), (8, 65536), (3, 1001)])
def test_block_update_kernel_matches_plain(cuda, k, obs):
    rng = np.random.default_rng(49)
    x_blk = torch.tensor(rng.normal(size=(64, obs)).astype(np.float32),
                         device=cuda)
    shape_e = (obs,) if k is None else (k, obs)
    e = torch.tensor(rng.normal(size=shape_e).astype(np.float32),
                     device=cuda)
    da = torch.tensor(rng.normal(size=(64,) if k is None else (64, k))
                      .astype(np.float32), device=cuda)
    n0 = _build.launch_counts()["block_update"]
    out = block_update(x_blk, e, da)
    assert _build.launch_counts()["block_update"] == n0 + 1
    want = block_update_plain(x_blk, e.reshape(-1, obs), da.reshape(64, -1))
    assert out.shape == e.shape
    assert _within(out.reshape(-1, obs), want, scale=want)


def test_bak_handle_on_card(cuda):
    x, a, y = _system(50, 8192, 200, None, cuda)   # 200 % 128: padded
    p = prepare(x, SolverSpec(method="bak_fused", rtol=1e-7, max_iter=100))
    r = p.solve(y, tenant_id="t")
    assert consume_dispatch() == "fused"
    assert r.coef.shape == (200,) and _within(r.coef, a)
    w = p.solve(y + 0.01 * x.sum(1), tenant_id="t")
    assert int(w.n_sweeps) <= int(r.n_sweeps)
    g = torch.Generator(device=cuda).manual_seed(0)
    rr = p.solve(y, spec=SolverSpec(method="bak", order="random", rtol=1e-7,
                                    max_iter=100), generator=g)
    assert consume_dispatch() == "xla" and _within(rr.coef, a)


# ----------------------------------------------------- streaming kernel
@pytest.mark.parametrize("k,obs,nvars,block,warm,cluster", [
    (None, 2048, 256, 32, False, 16),  # one cluster; the ring wraps every sweep
    (8, 4096, 224, 32, True, 16),      # 7 blocks: the stage parity flips
    (3, 4099, 96, 16, False, 8),       # obs % 4 != 0: the 4-byte copies
    (8, 16384, 512, 128, True, 16),    # 103 of 112 CTAs own obs
    (None, 200000, 64, 8, False, 4),   # empty slices in the last cluster
    (3, 200000, 64, 8, True, 8),
    (8, 200000, 64, 8, False, 16),
    (8, 1000, 64, 16, True, 4),
])
def test_stream_kernel_matches_plain(cuda, monkeypatch, k, obs, nvars, block,
                                     warm, cluster):
    import importlib
    from repro_torch.kernels.stream_solve import stream_solve_plain
    monkeypatch.setitem(importlib.import_module(
        "repro_torch.kernels.cd_sweep").BAKP_CLUSTER, "stream", cluster)
    x, a, y = _system(51, obs, nvars, k, cuda)
    y = y + 0.1 * torch.randn(y.shape, device=cuda)
    x_t = x.T.contiguous()
    multi = y.dim() == 2
    a0 = 0.5 * a if warm else None
    inv, a0m, e0 = solve_init(x_t, y, None, a0, multi)
    n0 = _build.launch_counts()["stream_solve"]
    r = stream_solve(x_t, y, a0=a0, block=block, max_iter=12)
    assert _build.launch_counts()["stream_solve"] == n0 + 1
    plan = _build.PLANS["stream_solve"]
    assert (plan.regime, plan.clusters) == _want_plan(obs, cluster)
    assert plan.ctas == plan.cluster * plan.clusters
    pc, pe, ph, _, pn, _ = stream_solve_plain(
        x_t, inv, e0, a0m, block=block, max_iter=12, atol_sse=0.0, rtol=0.0,
        omega=1.0)
    assert int(r.n_sweeps) == int(pn) == 12
    coef = r.coef if multi else r.coef[:, None]
    res = r.residual.T if multi else r.residual[None]
    assert _within(coef, pc) and _within(res, pe, scale=e0)
    assert _within(r.history, ph)


@pytest.mark.parametrize("k", [None, 8])
def test_stream_kernel_stops_like_plain(cuda, k):
    from repro_torch.kernels.stream_solve import stream_solve_plain
    x, a, y = _system(52, 8192, 256, k, cuda)
    x_t = x.T.contiguous()
    r = stream_solve(x_t, y, block=64, max_iter=200, rtol=1e-7)
    inv, a0m, e0 = solve_init(x_t, y, None, None, y.dim() == 2)
    _, _, _, _, pn, pconv = stream_solve_plain(
        x_t, inv, e0, a0m, block=64, max_iter=200, atol_sse=0.0, rtol=1e-7,
        omega=1.0)
    assert abs(int(r.n_sweeps) - int(pn)) <= 1 and int(r.n_sweeps) < 200
    assert bool(r.converged) == bool(pconv)
    assert _within(r.coef, a)


def test_stream_kernel_stops_like_plain_across_clusters(cuda):
    """The stop decision with several clusters: every CTA must take the
    same one from the exchanged SSE, or the solve hangs."""
    from repro_torch.kernels.stream_solve import stream_solve_plain
    x, _, y = _system(56, 200000, 64, 8, cuda)
    y = y + 0.1 * torch.randn(y.shape, device=cuda)
    x_t = x.T.contiguous()
    r = stream_solve(x_t, y, block=8, max_iter=200, rtol=1e-7)
    plan = _build.PLANS["stream_solve"]
    assert plan.regime == "multi_cluster" and plan.clusters > 1
    inv, a0m, e0 = solve_init(x_t, y, None, None, True)
    _, _, _, _, pn, pconv = stream_solve_plain(
        x_t, inv, e0, a0m, block=8, max_iter=200, atol_sse=0.0, rtol=1e-7,
        omega=1.0)
    assert abs(int(r.n_sweeps) - int(pn)) <= 1 and int(r.n_sweeps) < 200
    assert bool(r.converged) and bool(pconv)


# 100,000 bytes a CTA: too few for the streaming solve's ring at this
# shape (about 135 KB), enough for the per-sweep kernel's (about 52 KB).
@pytest.mark.parametrize("smem,path", [(None, "stream"),
                                       (100_000, "persweep")])
def test_stream_entry_dispatch_on_card(cuda, monkeypatch, smem, path):
    import importlib
    from repro_torch.kernels import solvebakp_stream_kernel
    if smem is not None:
        monkeypatch.setattr(importlib.import_module(
            "repro_torch.kernels.cd_sweep"), "SMEM_PER_CTA_BYTES", smem)
    x, a, y = _system(53, 8192, 256, 2, cuda)
    _build.reset_launch_counts()
    consume_dispatch()
    r = solvebakp_stream_kernel(x.T.contiguous(), y, block=128, max_iter=100,
                                rtol=1e-7)
    assert consume_dispatch() == path
    kernel = "stream_solve" if path == "stream" else "bakp_sweep"
    assert _build.launch_counts()[kernel] >= 1
    assert _within(r.coef, a)


def test_stream_handles_on_card(cuda):
    from repro_torch.core import UnsupportedSpecError, prepared_from_arrays
    x, a, y = _system(54, 8192, 200, None, cuda)   # 200 % 64: padded
    spec = SolverSpec(method="bakp_stream", thr=64, rtol=1e-7, max_iter=100)
    p = prepare(x, spec)
    r = p.solve(y, tenant_id="t")
    assert consume_dispatch() == "stream"
    assert r.coef.shape == (200,) and _within(r.coef, a)
    h = prepared_from_arrays(x, resident=False, spec=spec)
    assert h.device.type == "cuda" and not h.resident
    assert h.blocks.block_t(64, 0).is_pinned()   # a view of the host tier
    rh = h.solve(y, tenant_id="t")
    assert consume_dispatch() == "stream_host"
    assert rh.coef.device.type == "cuda"
    assert int(rh.n_sweeps) == int(r.n_sweeps) and _within(rh.coef, r.coef)
    y2 = y + 0.01 * x.sum(1)
    w = h.solve(y2, tenant_id="t")
    assert int(w.n_sweeps) < int(rh.n_sweeps)
    assert _within(w.coef, p.solve(y2, a0=rh.coef).coef)
    with pytest.raises(UnsupportedSpecError, match="bakp_stream"):
        h.solve(y, spec=SolverSpec(method="bakp_fused"))


# ------------------------------------------------------------- bf16 x
# Each kernel reads a bf16 x_t as it is stored and widens it as it loads;
# its plain version widens one row or block at a time.  Both run on the
# same bf16 tensor, so they agree to the same 1e-4 as in fp32.  bf16
# launches count and record their plans under "<kernel>_bf16".
def _bf16(t):
    return t.to(torch.bfloat16).contiguous()


@pytest.mark.parametrize("k,obs,nvars,block,warm,x_in,regime", [
    (None, 2048, 256, 32, False, "shared", "single_cluster"),
    (8, 2048, 256, 32, True, "shared", "single_cluster"),
    (None, 16384, 256, 128, True, "shared", "multi_cluster"),   # phase 1
    (8, 16384, 512, 128, False, "shared", "multi_cluster"),   # ring at fp32
    (3, 4099, 96, 16, False, "shared", "multi_cluster"),    # 2-byte copies
    (3, 4102, 96, 16, True, "shared", "multi_cluster"),     # 4-byte copies
    (None, 2048, 4096, 32, False, "ring", "single_cluster"),
    (8, 2048, 4096, 32, True, "ring", "single_cluster"),
    (8, 8192, 2048, 64, False, "ring", "multi_cluster"),
    (3, 4099, 4096, 16, True, "ring", "multi_cluster"),     # 2-byte copies
    (3, 4102, 4096, 16, False, "ring", "multi_cluster"),    # 4-byte copies
    (None, 8192, 2048, 2048, False, "direct", "multi_cluster"),
    (8, 8192, 2048, 2048, True, "direct", "multi_cluster"),
])
def test_bf16_fused_kernel_regimes_match_plain(cuda, k, obs, nvars, block,
                                               warm, x_in, regime):
    x, a, y = _system(61, obs, nvars, k, cuda)
    y = y + 0.1 * torch.randn(y.shape, device=cuda)
    x_t = _bf16(x.T)
    multi = y.dim() == 2
    a0 = 0.5 * a if warm else None
    inv, a0m, e0 = solve_init(x_t, y, None, a0, multi)
    n0 = _build.launch_counts(2)["fused_solve_bf16"]
    r = fused_solve(x_t, y, a0=a0, block=block, max_iter=12)
    assert _build.launch_counts(2)["fused_solve_bf16"] == n0 + 1
    plan = _build.PLANS["fused_solve_bf16"]
    assert (plan.x_in, plan.regime) == (x_in, regime)
    pc, pe, ph, _, pn, _ = fused_solve_plain(
        x_t, inv, e0, a0m, block=block, max_iter=12, atol_sse=0.0, rtol=0.0,
        omega=1.0)
    assert int(r.n_sweeps) == int(pn) == 12
    coef = r.coef if multi else r.coef[:, None]
    res = r.residual.T if multi else r.residual[None]
    assert _within(coef, pc) and _within(res, pe, scale=e0)
    assert _within(r.history, ph)


@pytest.mark.parametrize("k,block,obs,nvars,cluster,e_in", [
    (1, 8, 2048, 256, 16, "shared"),        # one cluster
    (2, 16, 1000, 64, 8, "shared"),         # a ragged slice, 4-byte copies
    (3, 16, 4097, 256, 16, "shared"),       # odd obs: 2-byte copies
    (8, 128, 16384, 256, 16, "shared"),
    (8, 32, 200000, 64, 16, "shared"),
    (9, 16, 200000, 32, 16, "shared"),      # two KC chunks
    (8, 32, 1000003, 32, 16, "device"),     # e in device memory; odd obs
])
def test_bf16_sweep_kernel_matches_plain(cuda, monkeypatch, k, block, obs,
                                         nvars, cluster, e_in):
    import importlib
    cd = importlib.import_module("repro_torch.kernels.cd_sweep")
    monkeypatch.setitem(cd.BAKP_CLUSTER, "sweep", cluster)
    rng = np.random.default_rng(62)
    x_t = _bf16(torch.tensor(rng.normal(size=(nvars, obs)).astype(np.float32),
                             device=cuda))
    inv = 1.0 / (x_t.float() ** 2).sum(1)
    e = torch.tensor(rng.normal(size=(k, obs)).astype(np.float32),
                     device=cuda)
    n0 = _build.launch_counts(2)["bakp_sweep_bf16"]
    da, e2 = bakp_sweep(x_t, e, inv, block=block)
    assert _build.launch_counts(2)["bakp_sweep_bf16"] == n0 + 1
    plan = _build.PLANS["bakp_sweep_bf16"]
    assert (plan.regime, plan.clusters) == _want_plan(obs, cluster)
    assert plan.e_in == e_in
    pda, pe2 = bakp_sweep_plain(x_t, e, inv, block=block)
    assert _within(da, pda) and _within(e2, pe2, scale=e)


@pytest.mark.parametrize("k,obs,regime,e_in", [
    (1, 4096, "single_cluster", "registers"),
    (3, 4098, "single_cluster", "registers"),   # 4-byte copies
    (9, 5003, "single_cluster", "shared"),      # odd obs: 2-byte copies
    (8, 200000, "multi_cluster", "registers"),
    (8, 1000003, "e_device", "device"),
    (8, 7200003, "x_device", "device")])        # a bf16 ring fits at 3.6M
def test_bf16_cd_sweep_kernel_matches_plain(cuda, k, obs, regime, e_in):
    rng = np.random.default_rng(63)
    nvars = 32 if obs > 100000 else 128
    x_t = _bf16(torch.tensor(rng.normal(size=(nvars, obs)).astype(np.float32),
                             device=cuda))
    inv = 1.0 / (x_t.float() ** 2).sum(1)
    inv[-1] = 0.0
    e = torch.tensor(rng.normal(size=(k, obs)).astype(np.float32),
                     device=cuda)
    n0 = _build.launch_counts(2)["bak_sweep_bf16"]
    da, e2 = cd_sweep(x_t, e, inv, block=8)
    assert _build.launch_counts(2)["bak_sweep_bf16"] == n0 + 1
    plan = _build.PLANS["bak_sweep_bf16"]
    assert (plan.regime, plan.e_in) == (regime, e_in)
    pda, pe2 = cd_sweep_plain(x_t, e, inv)
    assert _within(da, pda) and _within(e2, pe2, scale=e)
    assert float(da[-1].abs().max()) == 0.0


@pytest.mark.parametrize("k,obs,nvars,max_iter,regime,e_in", [
    (None, 4096, 128, 6, "single_cluster", "registers"),
    (8, 4098, 128, 6, "single_cluster", "registers"),
    (2, 100001, 64, 6, "single_cluster", "shared"),
    (8, 200000, 32, 6, "multi_cluster", "registers"),
    (8, 1000003, 16, 6, "e_device", "device"),
    (2, 7200003, 16, 3, "x_device", "device")])
def test_bf16_bak_fused_kernel_matches_plain(cuda, monkeypatch, k, obs, nvars,
                                             max_iter, regime, e_in):
    import importlib
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.kernels.cd_sweep"), "ON_CHIP_BUDGET_BYTES", 1 << 40)
    x, _, y = _system(64, obs, nvars, k, cuda)
    y = y + 0.1 * torch.randn(y.shape, device=cuda)
    x_t = _bf16(x.T)
    del x
    multi = y.dim() == 2
    inv, a0m, e0 = solve_init(x_t, y, None, None, multi)
    n0 = _build.launch_counts(2)["bak_fused_bf16"]
    r = fused_solve(x_t, y, block=16, max_iter=max_iter, variant="bak")
    assert _build.launch_counts(2)["bak_fused_bf16"] == n0 + 1
    plan = _build.PLANS["bak_fused_bf16"]
    assert (plan.regime, plan.e_in) == (regime, e_in)
    pc, pe, ph, _, pn, _ = fused_solve_plain(
        x_t, inv, e0, a0m, block=16, max_iter=max_iter, atol_sse=0.0,
        rtol=0.0, omega=1.0, variant="bak")
    assert int(r.n_sweeps) == int(pn) == max_iter
    coef = r.coef if multi else r.coef[:, None]
    res = r.residual.T if multi else r.residual[None]
    assert _within(coef, pc) and _within(res, pe, scale=e0)
    assert _within(r.history, ph)


@pytest.mark.parametrize("k,obs,nvars,block,warm,cluster", [
    (None, 2048, 256, 32, False, 16),  # one cluster; the ring wraps every sweep
    (8, 4096, 224, 32, True, 16),      # 7 blocks: the stage parity flips
    (3, 4099, 96, 16, False, 8),       # odd obs: the 2-byte copies
    (3, 4102, 96, 16, True, 8),        # obs % 8 != 0: the 4-byte copies
    (8, 16384, 4096, 128, True, 16),   # phase 3
    (None, 200000, 64, 8, False, 4),   # empty slices in the last cluster
    (8, 200000, 64, 8, False, 16),
])
def test_bf16_stream_kernel_matches_plain(cuda, monkeypatch, k, obs, nvars,
                                          block, warm, cluster):
    import importlib
    from repro_torch.kernels.stream_solve import stream_solve_plain
    monkeypatch.setitem(importlib.import_module(
        "repro_torch.kernels.cd_sweep").BAKP_CLUSTER, "stream", cluster)
    x, a, y = _system(65, obs, nvars, k, cuda)
    y = y + 0.1 * torch.randn(y.shape, device=cuda)
    x_t = _bf16(x.T)
    multi = y.dim() == 2
    a0 = 0.5 * a if warm else None
    inv, a0m, e0 = solve_init(x_t, y, None, a0, multi)
    n0 = _build.launch_counts(2)["stream_solve_bf16"]
    r = stream_solve(x_t, y, a0=a0, block=block, max_iter=12)
    assert _build.launch_counts(2)["stream_solve_bf16"] == n0 + 1
    plan = _build.PLANS["stream_solve_bf16"]
    assert (plan.regime, plan.clusters) == _want_plan(obs, cluster)
    pc, pe, ph, _, pn, _ = stream_solve_plain(
        x_t, inv, e0, a0m, block=block, max_iter=12, atol_sse=0.0, rtol=0.0,
        omega=1.0)
    assert int(r.n_sweeps) == int(pn) == 12
    coef = r.coef if multi else r.coef[:, None]
    res = r.residual.T if multi else r.residual[None]
    assert _within(coef, pc) and _within(res, pe, scale=e0)
    assert _within(r.history, ph)


def _bf16_rows(rng, rows, obs, cuda, offset=0):
    """A (rows, obs) bf16 tensor on the card; ``offset`` > 0 starts it that
    many elements into its storage, so its rows are not 16-byte aligned."""
    x = torch.tensor(rng.normal(size=rows * obs + offset).astype(np.float32),
                     device=cuda).to(torch.bfloat16)
    return x[offset:].view(rows, obs)


@pytest.mark.parametrize("nvars,obs,offset,vec,nchunks", [
    (1024, 65536, 0, True, 5),      # 16-byte loads, chunks of 256-multiples
    (8448, 4096, 0, True, 1),       # vars alone fills the card: one chunk
    (300, 4100, 0, False, 9),       # obs % 8 == 4: no 16-byte loads
    (7, 1001, 0, False, 4),         # odd obs
    (300, 4096, 1, False, 8),       # rows 2 bytes off 16-byte alignment
])
def test_bf16_score_features_kernel_matches_plain(cuda, nvars, obs, offset,
                                                  vec, nchunks):
    """The score kernel on a bf16 x against its plain version on the same
    bf16 tensor at 1e-5 (both widen it exactly), counted apart, and the
    same bits from two launches."""
    from repro_torch.kernels.block_update import score_chunks
    rng = np.random.default_rng(68)
    x_t = _bf16_rows(rng, nvars, obs, cuda, offset)
    assert (x_t.data_ptr() % 16 == 0 and obs % 8 == 0) == vec
    assert score_chunks(nvars, obs, 2)[1] == nchunks
    e = torch.tensor(rng.normal(size=obs).astype(np.float32), device=cuda)
    inv = 1.0 / (x_t.float() ** 2).sum(1)
    n0, n32 = (_build.launch_counts(2)["score_features_bf16"],
               _build.launch_counts()["score_features"])
    s = score_features(x_t, e, inv)
    assert _build.launch_counts(2)["score_features_bf16"] == n0 + 1
    assert _build.launch_counts()["score_features"] == n32
    assert s.dtype == torch.float32 and s.shape == (nvars,)
    assert _within(s, score_features_plain(x_t, e, inv), tol=1e-5)
    assert torch.equal(s, score_features(x_t, e, inv))
    assert _within(score_features_kernel(x_t, e),
                   score_features_plain(x_t, e, inv), tol=1e-5)


@pytest.mark.parametrize("cb,k,obs,offset", [
    (64, None, 65536, 0),   # 8-byte loads of 4 bf16 values
    (64, 2, 65536, 0),
    (64, 4, 4100, 0),       # obs % 8 == 4 still takes 8-byte loads
    (64, 5, 65536, 0),      # KC 8 carrying 5 right-hand sides
    (256, 8, 262144, 0),    # phase 2's block
    (13, 3, 4100, 0),       # 13 rows: the unrolled row loop's remainder
    (64, 8, 1001, 0),       # odd obs: the scalar path
    (64, 8, 65536, 1),      # rows 2 bytes off 8-byte alignment
    (6400, 8, 4096, 0),     # CB·k·4 at the shared-memory limit
])
def test_bf16_block_update_kernel_matches_plain(cuda, cb, k, obs, offset):
    from repro_torch.kernels.cd_sweep import SMEM_DA_LIMIT_BYTES
    rng = np.random.default_rng(69)
    x_blk = _bf16_rows(rng, cb, obs, cuda, offset)
    nrhs = 1 if k is None else k
    assert cb * nrhs * 4 <= SMEM_DA_LIMIT_BYTES
    shape_e = (obs,) if k is None else (k, obs)
    e = torch.tensor(rng.normal(size=shape_e).astype(np.float32),
                     device=cuda)
    da = torch.tensor(rng.normal(size=(cb,) if k is None else (cb, k))
                      .astype(np.float32), device=cuda)
    n0, n32 = (_build.launch_counts(2)["block_update_bf16"],
               _build.launch_counts()["block_update"])
    out = block_update(x_blk, e, da)
    assert _build.launch_counts(2)["block_update_bf16"] == n0 + 1
    assert _build.launch_counts()["block_update"] == n32
    want = block_update_plain(x_blk, e.reshape(-1, obs), da.reshape(cb, -1))
    assert out.shape == e.shape and out.dtype == torch.float32
    assert _within(out.reshape(-1, obs), want, scale=want, tol=1e-5)
    assert torch.equal(out, block_update(x_blk, e, da))


def test_bf16_streamed_obs_kernels_refuse_fp16_and_big_blocks(cuda):
    from repro_torch.kernels.cd_sweep import SMEM_DA_LIMIT_BYTES
    x = torch.zeros((64, 4096), dtype=torch.float16, device=cuda)
    e = torch.zeros(4096, device=cuda)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        score_features(x, e, torch.ones(64, device=cuda))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        block_update(x, e, torch.zeros(64, device=cuda))
    cb = SMEM_DA_LIMIT_BYTES // (4 * 8) + 1
    with pytest.raises(ValueError, match="shared memory"):
        block_update(torch.zeros((cb, 64), dtype=torch.bfloat16, device=cuda),
                     torch.zeros((8, 64), device=cuda),
                     torch.zeros((cb, 8), device=cuda))


@pytest.mark.parametrize("kernel", ["fused_solve", "bak_fused",
                                    "stream_solve"])
@pytest.mark.parametrize("k", [1, 8])
def test_bf16_rtol_stop_within_a_sweep_of_the_rule(cuda, kernel, k):
    """At rtol 1e-7 on phase 1's design (phase 3's for the streaming
    kernel, at half its width), each whole-solve kernel on a bf16 x stops
    within one sweep of the rule on the plain iterate's fp64 SSE."""
    from repro_torch.kernels.stream_solve import stream_cuda
    nvars = 2048 if kernel == "stream_solve" else 256
    x, _, y = _system(66, 16384, nvars, k, cuda)
    x_t = _bf16(x.T)
    inv, a0m, e0 = solve_init(x_t, y, None, None, y.dim() == 2)
    kw = dict(block=128, max_iter=100, atol_sse=0.0, rtol=1e-7, omega=1.0)
    if kernel == "stream_solve":
        out = stream_cuda(x_t, inv, e0, a0m, **kw)
    else:
        out = fused_cuda(x_t, inv, e0, a0m,
                         variant="bak" if kernel == "bak_fused" else "bakp",
                         **kw)
    rule = plain_rtol_stop(x_t, inv, e0, block=128, rtol=1e-7, max_iter=100,
                           variant="bak" if kernel == "bak_fused" else "bakp")
    assert rule is not None and abs(int(out[4]) - rule) <= 1, (int(out[4]),
                                                              rule)


def test_bf16_handles_on_card(cuda):
    """The handle at bf16 and bf16_fp32acc: the fused kernels on the bf16
    copy (and the fp32 polish), the streaming kernel on it, and no fp32
    copy of x made for the bf16 kernels."""
    x, a, y = _system(67, 16384, 512, 8, cuda)
    spec = SolverSpec(method="bakp_fused", thr=128, max_iter=60)
    p = prepare(x, spec)
    r32 = p.solve(y)
    for method in ("bakp_fused", "bak_fused"):
        _build.reset_launch_counts()
        consume_dispatch()
        rb = p.solve(y, spec=spec.replace(method=method, precision="bf16"))
        assert consume_dispatch() == "fused"
        name = "fused_solve" if method == "bakp_fused" else "bak_fused"
        assert _build.launch_counts(2)[name + "_bf16"] == 1
        assert _build.launch_counts()[name] == 0
        if method == "bakp_fused":
            assert _build.PLANS["fused_solve_bf16"].x_in == "shared"
        ra = p.solve(y, spec=spec.replace(method=method,
                                          precision="bf16_fp32acc",
                                          refine_sweeps=8))
        assert consume_dispatch() == "fused"
        assert _build.launch_counts()[name] == 1      # the fp32 polish
        assert ra.history.shape[0] == 68 and int(ra.n_sweeps) == 68
        assert float((rb.coef - r32.coef).abs().max()) <= 1e-2
        assert float((ra.coef - r32.coef).abs().max()) <= 1e-5
    s = SolverSpec(method="bakp_stream", thr=128, max_iter=60,
                   precision="bf16")
    _build.reset_launch_counts()
    rs = p.solve(y, spec=s)
    assert consume_dispatch() == "stream"
    assert _build.launch_counts(2)["stream_solve_bf16"] == 1
    assert float((rs.coef - r32.coef).abs().max()) <= 1e-2


# ------------------------------------------------------- the serving engine
def test_fused_launches_counted_across_threads(cuda):
    """4 threads, each on a CUDA stream of its own, launch ``fused_solve``
    50 times each: the launch count is exactly 200 and every result equals
    the single-thread one bit for bit."""
    import threading

    x, _, y = _system(71, 16384, 256, 8, cuda)
    p = prepare(x)
    x_t, inv = p.x_t_for(128), p.inv_cn_for(128)
    inv_cn, a0m, e0 = solve_init(x_t, y, inv, None, True)
    kw = dict(block=128, max_iter=20, atol_sse=0.0, rtol=0.0, omega=1.0)
    ref = [t.clone() for t in fused_cuda(x_t, inv_cn, e0, a0m, **kw)[:2]]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    bad, errors = [], []

    def worker():
        try:
            stream = torch.cuda.Stream(device=cuda)
            with torch.cuda.stream(stream):
                for _ in range(50):
                    coef, e = fused_cuda(x_t, inv_cn, e0, a0m, **kw)[:2]
                    stream.synchronize()
                    if not (torch.equal(coef, ref[0])
                            and torch.equal(e, ref[1])):
                        bad.append(float((coef - ref[0]).abs().max()))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert _build.launch_counts()["fused_solve"] == 200
    assert not bad, bad


def _serve_mix(device, seed, *, lanes=True, obs_=2048, nvars=128):
    """A small phase-5 mix: a coalesced bakp group (fused lane with
    prefer_fused), a bakp_gram batch across designs (plain lane) and a
    bak_fused group; fixed sweeps (rtol 0)."""
    from repro_torch import obs as tobs
    from repro_torch.serve import ServeConfig, SolveRequest, SolverServeEngine

    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(obs_, nvars)).astype(np.float32)
    xg = [rng.normal(size=(obs_ // 4, nvars)).astype(np.float32)
          for _ in range(4)]
    xb = rng.normal(size=(obs_, nvars)).astype(np.float32)
    knobs = dict(thr=64, max_iter=12)
    reqs = ([SolveRequest(x=xf, y=xf @ rng.normal(size=nvars).astype(
        np.float32), method="bakp", design_key="f", tenant_id=f"f{t}",
        **knobs) for t in range(4)]
        + [SolveRequest(x=x, y=x @ rng.normal(size=nvars).astype(
            np.float32), method="bakp_gram", design_key=f"g{i}", **knobs)
           for i, x in enumerate(xg)]
        + [SolveRequest(x=xb, y=xb @ rng.normal(size=nvars).astype(
            np.float32), method="bak_fused", design_key="b", **knobs)
           for _ in range(2)])
    eng = SolverServeEngine(ServeConfig(prefer_fused=True,
                                        lane_execution=lanes),
                            registry=tobs.MetricsRegistry(), device=device)
    try:
        return eng.serve(reqs), eng.stats.as_dict()
    finally:
        eng.shutdown()


def test_engine_on_card_matches_cpu_engine(cuda):
    """Phase 5's mix at a small size: the engine on the card (the CUDA
    kernels, plain torch on the card) against the engine on the CPU (the
    kernels' plain versions), request by request."""
    _build.reset_launch_counts()
    card, card_stats = _serve_mix(cuda, 5)
    counts = _build.launch_counts()
    host, host_stats = _serve_mix("cpu", 5)
    assert card_stats == host_stats
    assert counts["fused_solve"] == 1 and counts["bak_fused"] == 1
    for c, h in zip(card, host):
        assert c.error is None and h.error is None
        assert (c.batch_kind, c.n_sweeps, c.telemetry.kernel_path,
                c.telemetry.lane) == (h.batch_kind, h.n_sweeps,
                                      h.telemetry.kernel_path,
                                      h.telemetry.lane)
        scale = max(1.0, float(np.abs(h.coef).max()))
        assert float(np.abs(c.coef - h.coef).max()) <= 1e-5 * scale


def test_stage_rhs_pinned_on_card(cuda):
    """A coalesced group's rows staged in pinned memory, copied without
    blocking and transposed on the card: bit for bit the column layout,
    also for a second group staged at once into the freed buffer while
    the first group's copy may still be in flight."""
    from repro_torch import obs as tobs
    from repro_torch.serve import ServeConfig, SolveRequest, SolverServeEngine
    from repro_torch.serve.batching import rhs_to_device, stage_rhs

    rng = np.random.default_rng(12)
    groups = [[rng.normal(size=1_000_000).astype(np.float32)
               for _ in range(k)] for k in (16, 13)]
    on_card = []
    for rows in groups:
        staged, sse = stage_rhs(rows, 1 << 20, 16, pin=True)
        assert staged.is_pinned()
        assert sse == sum(float(np.dot(y, y)) for y in rows)
        on_card.append(rhs_to_device(staged, cuda))
        del staged
    for rows, ys in zip(groups, on_card):
        want = np.zeros((1 << 20, 16), np.float32)
        for c, y in enumerate(rows):
            want[: y.shape[0], c] = y
        assert ys.is_contiguous() and ys.device.type == "cuda"
        assert np.array_equal(ys.cpu().numpy(), want)

    prev = tobs.set_enabled(True)
    tracer = tobs.get_tracer()
    tracer.clear()
    try:
        x = rng.normal(size=(3000, 64)).astype(np.float32)
        eng = SolverServeEngine(ServeConfig(), registry=tobs.MetricsRegistry(),
                                device=cuda)
        out = eng.serve([SolveRequest(
            x=x, y=x @ rng.normal(size=64).astype(np.float32),
            method="bakp", design_key="d", thr=32, max_iter=12)
            for _ in range(3)])
        eng.shutdown()
        spans = tracer.spans()
    finally:
        tobs.set_enabled(prev)
    assert all(r.error is None and r.batch_kind == "multi_rhs" for r in out)
    by_id = {s.span_id: s for s in spans}
    pads = [s for s in spans if s.name == "engine.pad"]
    copies = [s for s in spans if s.name == "design.y_to_device"]
    assert [s.tags["staging"] for s in pads] == ["pinned"]
    assert [s.tags["bytes"] for s in copies] == [4096 * 4 * 4]
    assert by_id[copies[0].parent_id].name == "engine.solve"


def test_engine_lanes_bitwise_match_serial_on_card(cuda):
    """Flush 3 of phase 5 at a small size: a plain-torch batch on one
    lane's stream beside the fused kernels on another's, against the same
    flush on one serial lane: every coefficient bit-identical."""
    lanes, _ = _serve_mix(cuda, 6, lanes=True)
    serial, _ = _serve_mix(cuda, 6, lanes=False)
    assert {r.telemetry.lane for r in lanes} == {"single:fused",
                                                 "single:xla"}
    for a, b in zip(lanes, serial):
        assert a.error is None and b.error is None
        assert np.array_equal(a.coef, b.coef), a.request_id
        assert a.n_sweeps == b.n_sweeps


def test_engine_fused_and_stream_lanes_in_flight(cuda):
    """A fused-lane group and a stream-lane group, each a multi-cluster
    launch, in one flush: both lanes' kernels in flight at once neither
    hang nor change a bit against the serial lane."""
    from repro_torch import obs as tobs
    from repro_torch.serve import ServeConfig, SolveRequest, SolverServeEngine

    rng = np.random.default_rng(8)
    xf = rng.normal(size=(16384, 256)).astype(np.float32)
    xs = rng.normal(size=(16384, 1024)).astype(np.float32)

    def reqs():
        r = np.random.default_rng(9)
        return ([SolveRequest(x=xf, y=xf @ r.normal(size=256).astype(
            np.float32), method="bakp_fused", design_key="f", thr=128,
            max_iter=20) for _ in range(4)]
            + [SolveRequest(x=xs, y=xs @ r.normal(size=1024).astype(
                np.float32), method="bakp_stream", design_key="s",
                thr=128, max_iter=20) for _ in range(4)])

    out = {}
    for lanes in (True, False):
        _build.reset_launch_counts()
        eng = SolverServeEngine(ServeConfig(lane_execution=lanes),
                                registry=tobs.MetricsRegistry(),
                                device=cuda)
        out[lanes] = eng.serve(reqs())
        eng.shutdown()
        counts = _build.launch_counts()
        assert counts["fused_solve"] == 1 and counts["stream_solve"] == 1
        assert _build.PLANS["fused_solve"].regime == "multi_cluster"
        assert _build.PLANS["stream_solve"].regime == "multi_cluster"
    for a, b in zip(out[True], out[False]):
        assert a.error is None and b.error is None
        assert np.array_equal(a.coef, b.coef)


def test_engine_broken_launch_fails_the_request(cuda, monkeypatch):
    """A ``fused_solve`` launch that returns a CUDA error fails its
    requests with ``KernelError``: the retry ladder does not serve them on
    the plain "bakp" rung, and no launch is counted."""
    from repro_torch import obs as tobs
    from repro_torch.serve import ServeConfig, SolveRequest, SolverServeEngine

    lib = _build.load("fused_solve")

    class Broken:
        """The library, with a launch entry that reports an error."""

        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def bakp_fused_launch(*args):
            return 98  # cudaErrorInvalidDeviceFunction

    monkeypatch.setitem(_build._libs, "fused_solve", Broken())
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2048, 128)).astype(np.float32)
    reqs = [SolveRequest(x=x, y=x @ rng.normal(size=128).astype(np.float32),
                         method="bakp", design_key="broken", thr=64,
                         max_iter=12) for _ in range(2)]
    eng = SolverServeEngine(ServeConfig(prefer_fused=True),
                            registry=tobs.MetricsRegistry(), device=cuda)
    _build.reset_launch_counts()
    plain0 = tobs.dispatch_counts().get(("xla", "bakp"), 0)
    try:
        out = eng.serve(reqs)
    finally:
        eng.shutdown()
    assert all(r.error is not None and "KernelError" in r.error
               and r.retries == 0 and r.batch_kind == "error" for r in out)
    assert eng.stats.retries == 0 and eng.stats.failures == 2
    assert _build.launch_counts()["fused_solve"] == 0
    assert tobs.dispatch_counts().get(("xla", "bakp"), 0) == plain0


# ------------------------------------------- the design store and dispatcher
def _store_requests(x, seed, key, n=4, thr=128, max_iter=40):
    from repro_torch.serve import SolveRequest

    rng = np.random.default_rng(seed)
    return [SolveRequest(x=x, y=x @ rng.normal(size=x.shape[1]).astype(
        np.float32), method="bakp", design_key=key, tenant_id=f"{key}-{t}",
        thr=thr, max_iter=max_iter) for t in range(n)]


def _store_engine(cuda, **cfg):
    from repro_torch import obs as tobs
    from repro_torch.serve import ServeConfig, SolverServeEngine

    return SolverServeEngine(ServeConfig(prefer_fused=True, **cfg),
                             registry=tobs.MetricsRegistry(), device=cuda)


def test_store_demotion_during_inflight_fused_solve(cuda, monkeypatch):
    """The store demotes a design while a lane's ``fused_solve`` on it is
    in flight, and the freed pool is refilled with NaN on another stream:
    the lane holds its handle until its stream is synchronised, so every
    coefficient is bit-identical to the same flush on a storeless
    engine."""
    import threading

    rng = np.random.default_rng(30)
    x = rng.normal(size=(16384, 256)).astype(np.float32)
    ref_eng = _store_engine(cuda)
    ref = ref_eng.serve(_store_requests(x, 31, "d", max_iter=400))
    ref_eng.shutdown()
    eng = _store_engine(cuda, store_device_bytes=1 << 30)
    launched, go = threading.Event(), threading.Event()
    real = eng._call_solver

    def call_and_hold(*args, **kw):
        res = real(*args, **kw)         # the kernel is queued, not done
        launched.set()
        assert go.wait(60.0)
        return res

    monkeypatch.setattr(eng, "_call_solver", call_and_hold)
    _build.reset_launch_counts()
    out = {}
    t = threading.Thread(target=lambda: out.update(
        r=eng.serve(_store_requests(x, 31, "d", max_iter=400))))
    t.start()
    try:
        assert launched.wait(60.0)
        assert eng.store.demote("d") is not None
        assert eng.store.tier("d") == "host"
        torch.cuda.empty_cache()
        junk = [torch.full((1 << 22,), float("nan"), device=cuda)
                for _ in range(16)]
        torch.cuda.synchronize()
        del junk
    finally:
        go.set()
        t.join(timeout=120)
    assert not t.is_alive()
    eng.shutdown()
    assert _build.launch_counts()["fused_solve"] == 1
    for a, b in zip(out["r"], ref):
        assert a.error is None and b.error is None
        assert a.telemetry.kernel_path == "fused"
        assert np.array_equal(a.coef, b.coef), a.request_id


def test_store_promotion_on_dispatch_stream_matches_resident(cuda):
    """A design demoted to the pinned host tier is promoted by the async
    dispatcher's pre-warm, on the dispatch thread's own stream, and solved
    on the fused lane's stream: bit-identical to a storeless engine (the
    tenants' warm starts restored too)."""
    import threading

    from repro_torch.serve import AsyncDispatcher, DispatchConfig

    rng = np.random.default_rng(40)
    x = rng.normal(size=(16384, 256)).astype(np.float32)
    ref_eng = _store_engine(cuda)
    eng = _store_engine(cuda, store_device_bytes=1 << 30)
    for e in (ref_eng, eng):
        assert all(r.error is None
                   for r in e.serve(_store_requests(x, 41, "d")))
    eng.store.demote("d")
    assert eng.store.tier("d") == "host"
    assert next(iter(eng.store._host["d"].x_t.values())).is_pinned()
    threads = []
    real = eng.store.promote

    def promote(key):
        threads.append(threading.current_thread().name)
        return real(key)

    eng.store.promote = promote
    with AsyncDispatcher(eng, DispatchConfig(idle_timeout_s=0.01,
                                             max_batch=4)) as disp:
        tickets = [disp.submit(r) for r in _store_requests(x, 42, "d")]
        out = [t.result(timeout=120) for t in tickets]
    ref = ref_eng.serve(_store_requests(x, 42, "d"))
    ref_eng.shutdown()
    eng.shutdown()
    assert threads[0] == "serve-dispatch"
    assert eng.store.stats.promotions_host == 1
    for a, b in zip(out, ref):
        assert a.error is None and b.error is None
        assert a.warm_start and b.warm_start
        assert a.telemetry.lane == "single:fused"
        assert np.array_equal(a.coef, b.coef), a.request_id


def test_store_disk_promotion_into_solve(cuda, tmp_path):
    """A design demoted through the host tier to CRC-checked disk tiles
    comes back on the next request (every tile verified, copied from a
    pinned buffer) and solves bit-identically to a storeless engine."""
    rng = np.random.default_rng(50)
    xs = [rng.normal(size=(16384, 256)).astype(np.float32) for _ in range(2)]
    ref_eng = _store_engine(cuda)
    # One design's x and x_t (32 MiB) fit the device tier; none fits the
    # host tier, so the first design goes on to disk.
    eng = _store_engine(cuda, store_device_bytes=1 << 25,
                        store_host_bytes=1, store_dir=str(tmp_path))
    for e in (ref_eng, eng):
        for i, x in enumerate(xs):
            assert all(r.error is None
                       for r in e.serve(_store_requests(x, 51 + i, f"d{i}")))
    assert eng.store.tier("d0") == "disk"
    _build.reset_launch_counts()
    out = eng.serve(_store_requests(xs[0], 53, "d0"))
    assert _build.launch_counts()["fused_solve"] == 1
    ref = ref_eng.serve(_store_requests(xs[0], 53, "d0"))
    ref_eng.shutdown()
    eng.shutdown()
    assert eng.store.stats.promotions_disk == 1
    for a, b in zip(out, ref):
        assert a.error is None and a.warm_start == b.warm_start
        assert np.array_equal(a.coef, b.coef), a.request_id


def test_dispatcher_broken_launch_fails_the_ticket(cuda, monkeypatch):
    """A ``fused_solve`` launch that returns a CUDA error, reached through
    the async dispatcher: each ticket fails with ``KernelError``, nothing
    is retried or served on the plain "bakp" rung."""
    from repro_torch import obs as tobs
    from repro_torch.kernels._build import KernelError
    from repro_torch.serve import AsyncDispatcher, DispatchConfig

    lib = _build.load("fused_solve")

    class Broken:
        """The library, with a launch entry that reports an error."""

        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def bakp_fused_launch(*args):
            return 98  # cudaErrorInvalidDeviceFunction

    monkeypatch.setitem(_build._libs, "fused_solve", Broken())
    rng = np.random.default_rng(60)
    x = rng.normal(size=(2048, 128)).astype(np.float32)
    eng = _store_engine(cuda)
    _build.reset_launch_counts()
    plain0 = tobs.dispatch_counts().get(("xla", "bakp"), 0)
    with AsyncDispatcher(eng, DispatchConfig(idle_timeout_s=0.01)) as disp:
        tickets = [disp.submit(r)
                   for r in _store_requests(x, 61, "broken", n=2, thr=64)]
        for t in tickets:
            with pytest.raises(KernelError, match="cudaError_t 98"):
                t.result(timeout=120)
    eng.shutdown()
    assert disp.stats.completed == 2 and disp.inflight == 0
    assert eng.stats.retries == 0 and eng.stats.failures == 2
    assert _build.launch_counts()["fused_solve"] == 0
    assert tobs.dispatch_counts().get(("xla", "bakp"), 0) == plain0


# ------------------------------------------------------ sharded solvers
_SHARDED = [("obs", "solvebakp_obs_sharded", "4", {}),
            ("vars", "solvebakp_vars_sharded", "1x4", {"omega": 0.5}),
            ("2d", "solvebakp_2d", "2x2", {"omega": 0.5}),
            ("rhs", "solvebakp_rhs_sharded", "4", {})]


@pytest.mark.parametrize("kind,fn,spec,kw", _SHARDED,
                         ids=[s[0] for s in _SHARDED])
def test_sharded_solvers_on_virtual_shards_match_cpu(cuda, kind, fn, spec,
                                                     kw):
    """Each sharded solver on four virtual shards of the card against the
    same solve on four virtual CPU shards (the same block order; the sums
    run in another order), cold and warm."""
    import repro_torch.core as T
    from repro_torch.serve import build_serve_mesh

    x, a, y = _system(41, 4096, 256, 8, "cpu")
    m_gpu = build_serve_mesh(spec, devices=[cuda] * 4).mesh
    m_cpu = build_serve_mesh(spec, device="cpu").mesh
    for a0 in (None, 0.5 * a):
        knobs = dict(thr=64, max_iter=12, mode="gram", a0=a0, **kw)
        rg = getattr(T, fn)(x.to(cuda), y.to(cuda), m_gpu,
                            **dict(knobs, a0=None if a0 is None
                                   else a0.to(cuda)))
        rc = getattr(T, fn)(x, y, m_cpu, **knobs)
        assert rg.coef.device.type == "cuda"
        assert _within(rg.coef.cpu(), rc.coef)
        assert _within(rg.residual.cpu(), rc.residual, y)
        assert int(rg.n_sweeps) == int(rc.n_sweeps)
        h = rc.history
        assert ((rg.history.cpu() - h).abs()
                <= 1e-4 * h + 1e-7 * h[0]).all()


def test_sharded_solvers_on_distinct_cards(cuda):
    """The mesh on two distinct cards (the copies between cards) against
    the same mesh as virtual shards of one card: the only check of the
    path between cards, so it skips below two."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import repro_torch.core as T
    from repro_torch.serve import build_serve_mesh

    x, a, y = _system(42, 4096, 256, 8, cuda)
    two = build_serve_mesh("2x1").mesh
    assert [d.index for d in two.devices.flat] == [0, 1]
    one = build_serve_mesh("2x1", devices=[cuda] * 2).mesh
    for kind, fn, kw in (("obs", "solvebakp_obs_sharded", {}),
                         ("rhs", "solvebakp_rhs_sharded", {}),
                         ("2d", "solvebakp_2d", {"omega": 0.5})):
        r2 = getattr(T, fn)(x, y, two, thr=64, max_iter=12, **kw)
        r1 = getattr(T, fn)(x, y, one, thr=64, max_iter=12, **kw)
        assert r2.coef.device == x.device
        assert _within(r2.coef, r1.coef), kind
        assert int(r2.n_sweeps) == int(r1.n_sweeps)


def test_mesh_engine_on_virtual_shards_of_the_card(cuda):
    """The engine on a mesh of four virtual shards of the card: sharded
    placements run on their mesh lanes and match the mesh-less engine."""
    from repro_torch import obs
    from repro_torch.serve import (PlacementPolicy, ServeConfig,
                                   SolveRequest, SolverServeEngine,
                                   build_serve_mesh)

    rng = np.random.default_rng(43)
    x = rng.normal(size=(2048, 64)).astype(np.float32)
    A = rng.normal(size=(64, 32)).astype(np.float32)
    reqs = [SolveRequest(x=x, y=x @ A[:, t], method="bakp", thr=32,
                         max_iter=60, rtol=1e-10, design_key="d",
                         tenant_id=f"t{t}") for t in range(32)]
    eng = SolverServeEngine(
        ServeConfig(placement_policy=PlacementPolicy(
            obs_shard_min_cells=1 << 20, rhs_shard_min_k=32)),
        mesh=build_serve_mesh("4", devices=[cuda] * 4),
        registry=obs.MetricsRegistry())
    ref = SolverServeEngine(ServeConfig(), device=cuda,
                            registry=obs.MetricsRegistry())
    out, base = eng.serve(reqs), ref.serve(reqs)
    assert {r.placement for r in out} == {"rhs_sharded"}
    assert "mesh:rhs_sharded" in eng.lanes.stats()
    for o, b in zip(out, base):
        assert o.error is None
        assert np.abs(o.coef - b.coef).max() <= 1e-5 * np.abs(b.coef).max()
    eng.shutdown()
    ref.shutdown()


@pytest.mark.parametrize("obs,nvars", [(262_144, 256), (16_384, 4_096)])
def test_column_norms_near_fp64_on_card(cuda, obs, nvars):
    """The squared column norms every ``inv_cn`` comes from sit within fp32
    rounding of fp64 on the card (``tools/gram_accuracy.py`` measured
    2.0-3.4e-7 at phases 2, 3 and 8c), not where a batched GEMM's Gram
    diagonal sat (7.7e-5, F3)."""
    from repro_torch.core.types import column_norms_sq, column_norms_sq_t

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(obs, nvars, generator=gen, device=cuda)
    n64 = (x.double() ** 2).sum(0)
    for n in (column_norms_sq(x), column_norms_sq_t(x.T.contiguous())):
        assert ((n.double() - n64).abs() / n64).max().item() <= 1e-6


def test_batched_gram_solve_near_fp64_on_card(cuda):
    """``solvebakp_batched(mode="gram")`` given no factors takes each
    block's Gram from one ``mm`` (``block_grams``): its first sweep's SSE
    sits within fp32 rounding of the fp64 iteration at obs 262,144, where
    the batched ``einsum`` Gram put it 1.13e-4 off (``tools/gram_accuracy.py``,
    F3's family)."""
    from repro_torch.core import solvebakp_batched

    obs, nvars, thr = 262_144, 256, 128
    gen = torch.Generator(device=cuda).manual_seed(0)
    xs = torch.randn(2, obs, nvars, generator=gen, device=cuda)
    a = torch.randn(2, nvars, 1, generator=gen, device=cuda)
    ys = torch.bmm(xs, a)[..., 0]
    res = solvebakp_batched(xs, ys, thr=thr, max_iter=1, mode="gram")
    eye = torch.eye(thr, dtype=torch.float64, device=cuda)
    for i in range(2):
        xd, e = xs[i].double(), ys[i].double()
        for b in range(nvars // thr):
            xb = xd[:, b * thr:(b + 1) * thr]
            chol = torch.linalg.cholesky(xb.T @ xb + 1e-6 * eye)
            e = e - xb @ torch.cholesky_solve((xb.T @ e)[:, None], chol)[:, 0]
        h64 = float((e * e).sum())
        assert abs(float(res.history[i, 0]) - h64) / h64 <= 1e-5


def test_lm_smoke_model_on_card_matches_cpu(cuda):
    """qwen3-8b's smoke model (fp32) on the card against the same weights
    on the CPU: prefill, three decode steps (logits and every cache entry)
    and the probe features."""
    from repro_torch.configs.registry import get
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.model import (init_model, make_smoke_batch,
                                          probe_features)
    from repro_torch.models.params import tree_map

    cfg = get("qwen3-8b").smoke()
    cpu = torch.device("cpu")
    params = {cpu: init_model(cfg, seed=0, device=cpu)}
    params[cuda] = tree_map(lambda t: t.to(cuda), params[cpu])
    toks = make_smoke_batch(cfg, seed=1, batch=2, seq=27, device=cpu)[
        "tokens"]
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    out = {}
    for dev, p in params.items():
        cache = init_cache(cfg, 2, cfg.max_cache_len, device=dev)
        logits, cache = prefill(p, {"tokens": toks[:, :24].to(dev)}, cache)
        seen = [logits]
        for i in range(24, 27):
            logits, cache = decode(p, toks[:, i:i + 1].to(dev), cache)
            seen.append(logits)
        feats = probe_features(cfg, p, toks.to(dev))
        out[dev] = [t.cpu() for t in seen + [feats, cache["k"], cache["v"],
                                             cache["lengths"]]]
    for a, b in zip(out[cuda][:-1], out[cpu][:-1]):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    assert torch.equal(out[cuda][-1], out[cpu][-1])


@pytest.mark.parametrize("arch,change", [
    ("h2o-danube-1.8b", {}), ("gemma2-9b", {}), ("minicpm3-4b", {}),
    ("qwen2-vl-2b", {}), ("qwen3-8b", {"kv_quant": "int8"}),
    ("h2o-danube-1.8b", {"kv_quant": "int8"})])
def test_lm_variants_on_card_match_cpu(cuda, arch, change):
    """Each attention and cache variant's smoke model (fp32) on the card
    against the same weights on the CPU: a prompt past the window of 32,
    three decode steps (logits and every cache entry; int8 codes may
    differ by 1 on at most 0.1% of the entries) and the probe features."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.model import (init_model, make_smoke_batch,
                                          probe_features)
    from repro_torch.models.params import tree_map

    cfg = dataclasses.replace(get(arch).smoke(), **change)
    cpu = torch.device("cpu")
    params = {cpu: init_model(cfg, seed=0, device=cpu)}
    params[cuda] = tree_map(lambda t: t.to(cuda), params[cpu])
    batch = make_smoke_batch(cfg, seed=1, batch=2, seq=43, device=cpu)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    out = {}
    for dev, p in params.items():
        cache = init_cache(cfg, 2, cfg.max_cache_len, device=dev)
        prompt = {k: (v[..., :40] if k == "positions" else v[:, :40]).to(dev)
                  for k, v in batch.items() if k != "labels"}
        logits, cache = prefill(p, prompt, cache)
        seen = [logits]
        for i in range(40, 43):
            logits, cache = decode(p, batch["tokens"][:, i:i + 1].to(dev),
                                   cache)
            seen.append(logits)
        seen.append(probe_features(cfg, p, batch["tokens"][:, :40].to(dev)))
        out[dev] = ([t.cpu() for t in seen],
                    {k: v.cpu() for k, v in cache.items()})
    for a, b in zip(out[cuda][0], out[cpu][0]):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    for name, b in out[cpu][1].items():
        a = out[cuda][1][name]
        if b.dtype == torch.int8:
            d = (a.int() - b.int()).abs()
            assert d.max().item() <= 1 and (d > 0).sum().item() <= \
                1e-3 * d.numel(), name
        elif b.dtype == torch.int32:
            assert torch.equal(a, b), name
        else:
            assert (a - b).abs().max().item() <= \
                1e-4 * b.abs().max().item(), name


def _lora_drawn(params, seed):
    """The hybrid's LoRA ``b_*`` (zero at init) drawn small and random, so
    the per-unit delta is exercised; other trees as they are."""
    units = params["backbone"].get("units")
    if units is None:
        return params
    gen = torch.Generator().manual_seed(seed)
    for name, t in units["lora"].items():
        if name.startswith("b_"):
            t.copy_(0.05 * torch.randn(t.shape, generator=gen))
    return params


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b", "mamba2-370m",
                                  "zamba2-7b"])
def test_lm_families_on_card_match_cpu(cuda, arch):
    """Each MoE, SSM and hybrid smoke model (fp32) on the card against the
    same weights on the CPU: a prompt of 40 tokens (two SSD chunks and a
    ragged tail; MoE capacity drops), three decode steps (logits and every
    cache entry) and the probe features."""
    from repro_torch.configs.registry import get
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.model import (init_model, make_smoke_batch,
                                          probe_features)
    from repro_torch.models.params import tree_map

    cfg = get(arch).smoke()
    cpu = torch.device("cpu")
    params = {cpu: _lora_drawn(init_model(cfg, seed=0, device=cpu), 1)}
    params[cuda] = tree_map(lambda t: t.to(cuda), params[cpu])
    toks = make_smoke_batch(cfg, seed=1, batch=2, seq=43, device=cpu)[
        "tokens"]
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    out = {}
    for dev, p in params.items():
        cache = init_cache(cfg, 2, cfg.max_cache_len, device=dev)
        logits, cache = prefill(p, {"tokens": toks[:, :40].to(dev)}, cache)
        seen = [logits]
        for i in range(40, 43):
            logits, cache = decode(p, toks[:, i:i + 1].to(dev), cache)
            seen.append(logits)
        seen.append(probe_features(cfg, p, toks[:, :40].to(dev)))
        out[dev] = ([t.cpu() for t in seen],
                    {k: v.cpu() for k, v in cache.items()})
    for a, b in zip(out[cuda][0], out[cpu][0]):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    for name, b in out[cpu][1].items():
        a = out[cuda][1][name]
        if b.dtype == torch.int32:
            assert torch.equal(a, b), name
        else:
            assert (a - b).abs().max().item() <= \
                1e-4 * b.abs().max().item(), name


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b"])
def test_lm_moe_decode_step_matches_no_capacity_reference(cuda, arch):
    """A decode step at B 4 drops no assignment, so each MoE layer's output
    on the card equals the no-capacity reference (each token through its
    top-k experts, gate-weighted) within 1e-5 of its magnitude; the same
    layer's routing keeps every assignment."""
    import repro_torch.models.transformer as tt
    from repro_torch.configs.registry import get
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import moe
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.model import init_model, make_smoke_batch

    cfg = get(arch).smoke()
    params = init_model(cfg, seed=2, device=cuda)
    toks = make_smoke_batch(cfg, seed=3, batch=4, seq=33, device=cuda)[
        "tokens"]
    cache = init_cache(cfg, 4, cfg.max_cache_len, device=cuda)
    make_prefill_step(cfg)(params, {"tokens": toks[:, :32]}, cache)
    seen, real = [], tt.apply_moe

    def recording(c, p, h, *ctx):
        y, aux = real(c, p, h, *ctx)
        seen.append((p, h, y))
        return y, aux

    tt.apply_moe = recording
    try:
        make_decode_step(cfg)(params, toks[:, 32:], cache)
    finally:
        tt.apply_moe = real
    assert len(seen) == cfg.n_layers
    for p, h, y in seen:
        ref = moe.apply_moe_no_capacity(cfg, p, h)
        assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
        r = moe.route(cfg, moe.router_logits(p, h.reshape(1, 4, -1)),
                      moe.capacity(cfg, 4))
        assert bool(r.keep.all())


@pytest.mark.parametrize("arch,microbatch", [("qwen3-8b", 1),
                                             ("seamless-m4t-large-v2", 2),
                                             ("arctic-480b", 1)])
def test_train_step_on_card_matches_cpu(cuda, arch, microbatch):
    """One ``make_train_step`` on the card against the CPU from the same
    fp32 smoke state (AdamW; arctic's Adafactor): the metrics within 1e-4
    relative, the optimizer's statistics within 1e-4 of each leaf's
    largest, and the params within what an AdamW first step can turn
    grads agreeing within 1e-4 into (lr·δ·eps/(|g| - δ + eps)², at most
    2·lr, as tests/test_torch_train.py bounds it against JAX)."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_model, make_smoke_batch
    from repro_torch.models.params import tree_items, tree_map
    from repro_torch.optim import make_optimizer

    cfg = dataclasses.replace(get(arch).smoke(), microbatch=microbatch)
    cpu = torch.device("cpu")
    p_cpu = init_model(cfg, seed=4, device=cpu)
    batch = make_smoke_batch(cfg, seed=5, batch=4, seq=32, device=cpu)
    sched = dict(peak_lr=1e-3, warmup=2, total_steps=10)
    out = {}
    for dev in (cpu, cuda):
        p = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
        o = make_optimizer(cfg.optimizer)[0](p)
        p, o, m = make_train_step(cfg, **sched)(
            p, o, {k: v.to(dev) for k, v in batch.items()}, 3)
        out[dev] = (tree_map(lambda t: t.cpu(), p),
                    tree_map(lambda t: t.cpu(), o),
                    {k: float(v) for k, v in m.items()})
    (pc, oc, mc), (pg, og, mg) = out[cpu], out[cuda]
    for k, v in mc.items():
        assert abs(mg[k] - v) <= 1e-4 * max(abs(v), 1e-6), k
    lr = mc["lr"]
    if cfg.optimizer == "adafactor":
        for (name, a), (_, b) in zip(tree_items(og["stats"]),
                                     tree_items(oc["stats"])):
            assert _within(a, b), name
        for (name, a), (_, b) in zip(tree_items(pg), tree_items(pc)):
            assert (a - b).abs().max().item() <= \
                1e-5 * b.abs().max().item(), name
        return
    for part in ("m", "v"):
        for (name, a), (_, b) in zip(tree_items(og[part]),
                                     tree_items(oc[part])):
            assert (a - b).abs().max().item() <= \
                2 * TOL * b.abs().max().item(), (part, name)
    moments = dict(tree_items(oc["m"]))
    for name, b in tree_items(pc):
        a = dict(tree_items(pg))[name]
        g = moments[name] / 0.1                     # the clipped grad
        delta = TOL * g.abs().max().item()
        lo = (g.abs() - delta).clamp(min=0)
        bound = lr * torch.clamp(delta * 1e-8 / (lo + 1e-8) ** 2, max=2.0)
        assert bool(((a - b).abs() <= bound
                     + 1e-5 * b.abs().max()).all()), name


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A tree of card tensors (bf16, fp32, a 0-d int32 count, a leaf past
    the 64 MiB read chunk) saved, restored onto the card and onto the CPU
    bit for bit through the pinned staging buffer; keep-k and a
    ``CheckpointManager`` restore as the train driver does it."""
    from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                        save_checkpoint)
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    from repro_torch.models.params import tree_items

    gen = torch.Generator(device=cuda).manual_seed(6)
    tree = {"params": {"w": torch.randn(3, 5, generator=gen, device=cuda),
                       "big": torch.randn(5, 1 << 22, generator=gen,
                                          device=cuda).bfloat16()},
            "opt": {"count": torch.tensor(7, dtype=torch.int32,
                                          device=cuda)}}
    for step in (1, 2, 3):
        save_checkpoint(str(tmp_path), step, tree, {"data_step": step},
                        keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]
    assert latest_step(str(tmp_path)) == 3
    template = {k: {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                    for n, t in v.items()} for k, v in tree.items()}
    for dev in (cuda, torch.device("cpu")):
        got, extras, step = restore_checkpoint(str(tmp_path), template,
                                               device=dev)
        assert step == 3 and extras == {"data_step": 3}
        for (name, a), (_, b) in zip(tree_items(got), tree_items(tree)):
            assert a.device.type == dev.type and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b.cpu()), name
    got, _, step = CheckpointManager(str(tmp_path)).restore_latest(
        template, device=cuda)
    assert step == 3 and torch.equal(got["params"]["big"],
                                     tree["params"]["big"])


# --------------------------------------- the distributed substrate
def test_compression_on_card_bit_equal_to_cpu(cuda):
    """int8 compression with error feedback on the card: q, the scale and
    the error bit-equal to the CPU's, and deq + err == g + err_prev."""
    from repro_torch.distributed import compression as comp
    gen = torch.Generator(device=cuda).manual_seed(25)
    g = {"w": torch.randn(256, 1024, generator=gen, device=cuda).bfloat16(),
         "b": torch.randn(1024, generator=gen, device=cuda) * 1e-3,
         "zero": torch.zeros(7, 3, device=cuda)}
    err = comp.init_error_tree(g)
    for _ in range(3):
        q, s, new = comp.compressed_tree(g, err)
        for k in g:
            qc, sc, ec = comp.compress(g[k].cpu(), err[k].cpu())
            assert torch.equal(q[k].cpu(), qc), k
            assert torch.equal(s[k].cpu().view(torch.int32),
                               sc.view(torch.int32)), k
            assert torch.equal(new[k].cpu().view(torch.int32),
                               ec.view(torch.int32)), k
            assert torch.equal(comp.decompress(q[k], s[k]) + new[k],
                               g[k].float() + err[k]), k
        err = new


def test_shardctx_moe_groups_rows_on_card(cuda):
    """dbrx-132b's smoke config in fp32 on the card: a prefill of B 4 under
    ``ShardCtx`` on four virtual shards of cuda:0 routes each row as its
    own group: each MoE layer's output equals four ctx-less runs of one
    row each (within 1e-5 of max |y|), with the same drops."""
    import repro_torch.models.transformer as tt
    from repro_torch.configs.registry import get
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe
    from repro_torch.models.common import ShardCtx
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.model import init_model, make_smoke_batch

    cfg = get("dbrx-132b").smoke()
    params = init_model(cfg, seed=3, device=cuda)
    mesh = make_debug_mesh((4, 1), devices=[cuda] * 4)
    ctx = ShardCtx(mesh, make_rules(mesh))
    batch = make_smoke_batch(cfg, seed=4, batch=4, seq=48, device=cuda)
    batch.pop("labels")
    seen, real = [], tt.apply_moe

    def recording(c, p, h, *rest):
        y, aux = real(c, p, h, *rest)
        seen.append((p, h, y))
        return y, aux

    tt.apply_moe = recording
    try:
        with torch.no_grad():
            make_prefill_step(cfg, ctx)(params, batch,
                                        init_cache(cfg, 4, 48, device=cuda))
    finally:
        tt.apply_moe = real
    assert ctx.data_shards == 4 and len(seen) == cfg.n_layers
    with torch.no_grad():
        for p, h, y in seen:
            grouped = moe.route(cfg, moe.router_logits(p, h),
                                moe.capacity(cfg, h.shape[1]))
            for i in range(4):
                yi, _ = moe.apply_moe(cfg, p, h[i:i + 1])
                assert (yi[0] - y[i]).abs().max() <= 1e-5 * y.abs().max()
                one = moe.route(cfg, moe.router_logits(p, h[i:i + 1]),
                                moe.capacity(cfg, h.shape[1]))
                assert int((~one.keep).sum()) == int(
                    (~grouped.keep[i]).sum())


def test_collective_recorder_on_virtual_shards(cuda):
    """The recorder on an obs-sharded solve over four virtual shards of
    cuda:0: its all-reduce bytes are the solver's group sums (block Grams
    and the first SSE once; a (thr, k) inner product a block and the SSE
    a sweep), each over the four shards of the data axis."""
    from repro_torch.core import solvebakp_obs_sharded
    from repro_torch.core.distributed import CollectiveRecorder
    from repro_torch.launch.mesh import make_mesh
    gen = torch.Generator(device=cuda).manual_seed(26)
    x = torch.randn(16_384, 512, generator=gen, device=cuda)
    y = x @ torch.randn(512, 4, generator=gen, device=cuda)
    mesh = make_mesh((4,), ("data",), [cuda] * 4)
    with CollectiveRecorder() as rec:
        res = solvebakp_obs_sharded(x, y, mesh, thr=128, max_iter=6)
    n, nb = int(res.n_sweeps), 512 // 128
    assert rec.bytes_by("all-reduce") == (nb * 128 * 128 * 4 + 4
                                         + n * (nb * 128 * 4 * 4 + 4))
    assert {(k, g, a) for k, _, g, a in rec.records} == {
        ("all-reduce", 4, ("data",)), ("all-gather", 4, ("data",))}
