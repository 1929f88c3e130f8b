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


def _within(a, b, scale=None):
    ref = (b if scale is None else scale).abs().max().item() or 1.0
    return (a - b).abs().max().item() <= TOL * ref


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
    assert h.blocks.host.x_t.is_pinned()
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
