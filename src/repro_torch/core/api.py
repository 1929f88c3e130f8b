"""One-shot entry points over the spec/prepare model.

Counterpart of ``repro.core.api``.  The primary API is the handle model
(``repro_torch.core.prepare``); ``solve`` and ``fit_linear_probe`` build a
``SolverSpec`` from loose keyword arguments, ``prepare`` the design and run
one solve.  Like ``prepare`` they default to ``device="cuda"`` and raise
without a GPU unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from typing import Optional

import torch

import repro_torch.core.methods  # noqa: F401  (populates the registry)
from repro_torch.core.prepare import prepare
from repro_torch.core.spec import SolverSpec
from repro_torch.core.types import SolveResult


def solve(
    x,
    y,
    *,
    method: str = "bakp_gram",
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    thr: int = 128,
    omega: float = 1.0,
    ridge: float = 1e-6,
    order: str = "cyclic",
    a0=None,
    generator: Optional[torch.Generator] = None,
    spec: Optional[SolverSpec] = None,
    device=None,
) -> SolveResult:
    """One-shot solve: ``prepare(x, spec, device=device).solve(y, a0,
    generator=generator)``; ``generator`` drives ``order="random"``.

    ``spec`` overrides every loose knob when given.  Repeated solves against
    one ``x`` should hold a ``prepare`` handle instead.
    """
    if spec is None:
        spec = SolverSpec(method=method, max_iter=max_iter, atol=atol,
                          rtol=rtol, thr=thr, omega=omega, ridge=ridge,
                          order=order)
    return prepare(x, spec, device=device).solve(y, a0, generator=generator)


def fit_linear_probe(
    features,
    targets,
    *,
    method: str = "bakp_gram",
    max_iter: int = 64,
    rtol: float = 1e-7,
    thr: int = 128,
    a0=None,
    spec: Optional[SolverSpec] = None,
    device=None,
) -> SolveResult:
    """Fit a linear readout ``features @ a ≈ targets``.

    ``features``: (..., tokens, d), flattened over leading axes.
    ``targets``: (..., tokens), or (..., tokens, k) for k readouts fit in
    one multi-RHS pass (coef (d, k)).  ``a0``: optional (d,) / (d, k) start.
    """
    features = torch.as_tensor(features)
    targets = torch.as_tensor(targets)
    feats = features.reshape(-1, features.shape[-1])
    if targets.dim() == features.dim():
        t = targets.reshape(-1, targets.shape[-1])
    else:
        t = targets.reshape(-1)
    if t.shape[0] != feats.shape[0]:
        raise ValueError(
            f"targets {tuple(targets.shape)} do not match features "
            f"{tuple(features.shape)}: expected (..., tokens) or "
            f"(..., tokens, k) with the same leading/token axes")
    return solve(feats, t, method=method, max_iter=max_iter, rtol=rtol,
                 thr=thr, a0=a0, spec=spec, device=device)
