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
from repro_torch.kernels import _build, bakp_sweep, fused_solve, solvebakp_kernel
from repro_torch.kernels.cd_sweep import bakp_sweep_plain
from repro_torch.kernels.fused_solve import fused_solve_plain, solve_init
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


@pytest.mark.parametrize("k,block", [(1, 8), (3, 16), (8, 128)])
def test_sweep_kernel_matches_plain(cuda, k, block):
    rng = np.random.default_rng(40)
    x_t = torch.tensor(rng.normal(size=(256, 4096)).astype(np.float32),
                       device=cuda)
    inv = 1.0 / (x_t * x_t).sum(1)
    e = torch.tensor(rng.normal(size=(k, 4096)).astype(np.float32),
                     device=cuda)
    n0 = _build.launch_counts()["bakp_sweep"]
    da, e2 = bakp_sweep(x_t, e, inv, block=block)
    assert _build.launch_counts()["bakp_sweep"] == n0 + 1
    pda, pe2 = bakp_sweep_plain(x_t, e, inv, block=block)
    assert _within(da, pda) and _within(e2, pe2, scale=e)


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
