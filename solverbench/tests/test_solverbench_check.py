"""The correctness check: a sound run passes; the controls (the reference
in TF32, the nearest precision below the configuration's fp32, put in the
program's place; the program's own bf16 path) and each fault planted
under the timed path come out not correct.

These drive a whole run on the CPU at a small size (the harness's look for
a card is skipped), with the configuration's own limit."""
import dataclasses

import numpy as np
import pytest
import torch

from sbtest import run_tiny, tiny_cell


@pytest.fixture(scope="module")
def cell():
    return tiny_cell()


def _planted(fault):
    """A ``bakp_stream`` that runs the real solve, then breaks its answer
    as ``fault`` says."""
    from repro_torch.core import spec as core_spec
    entry = core_spec.solver_method("bakp_stream")

    def solve(p, y, spec, **kw):
        res = entry.solve(p, y, spec, **kw)
        coef = res.coef.clone()
        if fault == "unchanged":        # the step returns its start state
            return res._replace(coef=torch.zeros_like(coef), residual=y,
                                n_sweeps=torch.zeros_like(res.n_sweeps))
        multi = coef.dim() == 2
        if fault == "half_batch" and multi and coef.shape[1] > 1:
            h = coef.shape[1] // 2      # half left out, the mean of the rest
            coef[:, h:] = coef[:, :h].mean(dim=1, keepdim=True)
        elif fault == "altered":        # one answer altered where produced
            c = coef[:, 0] if multi else coef
            c[0] += 1e-3 * c.abs().max()
        elif fault == "swapped" and multi and coef.shape[1] > 1:
            coef = coef.roll(1, dims=1)  # answers handed to the wrong request
        return res._replace(coef=coef)

    return entry, dataclasses.replace(entry, solve=solve)


def test_sound_run_is_correct(cell):
    out = run_tiny(cell, seed=2 ** 33 + 7)
    assert out.result["correct"], out.checks
    assert out.result["attempted"] > 0 and out.result["failed"] == 0
    assert list(out.result)[-1] == "checks"
    assert out.readings["coef_err"] <= cell.config["check"]["coef_err"]


def test_traced_run_is_correct(cell):
    out = run_tiny(cell, seed=11, trace=True)
    assert out.result["correct"], out.checks
    assert set(out.result["metrics"]) >= {"queue_wait_ms", "rhs_per_solve",
                                          "solve_ms", "sweeps_per_solve"}
    assert out.result["metrics"]["rhs_per_solve"]["value"] > 1
    assert "breakdown" in out.result


def test_reference_control_is_not_correct(cell):
    from harness.cell import reference_control
    got = reference_control(cell, seed=2 ** 35 + 1, device="cpu")
    assert got["coef_err"] > 3 * cell.config["check"]["coef_err"]


def test_control_is_not_correct(cell):
    out = run_tiny(cell, seed=12, precision="bf16")
    assert not out.result["correct"]
    assert out.readings["coef_err"] > 3 * cell.config["check"]["coef_err"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "swapped"])
def test_planted_fault_is_not_correct(cell, fault):
    from repro_torch.core import spec as core_spec
    real, broken = _planted(fault)
    core_spec.register_method(broken, overwrite=True)
    try:
        out = run_tiny(cell, seed=13)
    finally:
        core_spec.register_method(real, overwrite=True)
    assert not out.result["correct"], (fault, out.checks)


def test_unanswered_request_is_not_correct(cell):
    from repro_torch.core import spec as core_spec
    real = core_spec.solver_method("bakp_stream")

    from repro_torch.kernels._build import KernelError

    def raising(p, y, spec, **kw):
        # A broken kernel: the engine fails the ticket instead of serving
        # it on a plain rung, so no answer comes.
        raise KernelError("planted: the kernel never answers")

    core_spec.register_method(dataclasses.replace(real, solve=raising),
                              overwrite=True)
    try:
        out = run_tiny(cell, seed=14)
    finally:
        core_spec.register_method(real, overwrite=True)
    assert not out.result["correct"]
    assert out.result["failed"] > 0


def test_same_seed_same_inputs():
    from harness.inputs import make_designs
    c = tiny_cell()
    a = make_designs(c.config, c.traffic, 2 ** 40 + 3, "cpu")
    b = make_designs(c.config, c.traffic, 2 ** 40 + 3, "cpu")
    assert all(torch.equal(p.x, q.x) and np.array_equal(p.y_pool, q.y_pool)
               for p, q in zip(a, b))
