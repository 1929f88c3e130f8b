"""SolveBakF — Algorithm 3 of the paper: greedy forward feature selection.

Counterpart of ``repro.core.solvebakf``.  Each step scores every feature
by the SSE reduction one CD step on it would achieve: with
``da_j = ⟨x_j, e⟩ / ⟨x_j, x_j⟩`` the post-step SSE is
``||e||² − ⟨x_j, e⟩² / ⟨x_j, x_j⟩``, so the pick (paper line 5) is
``argmax_j ⟨x_j, e⟩² / ⟨x_j, x_j⟩``.  As in the JAX package the scoring is
one plain ``x.T @ e`` matvec; the fused score kernel is its own entry
(``repro_torch.kernels.ops.score_features_kernel``).  After each pick the
coefficients are refit on the selected set (paper line 7) with the port's
``solvebakp(mode="gram")``, warm-started from the previous refit.

The fixed-shape formulation of the JAX package is kept, so both compute
the same thing step for step: ``selected`` is a (max_feat,) buffer with −1
slots, the refit matrix is an (obs, max_feat) gather with zero columns for
slots not yet selected (inert for the solver: ``safe_inv`` gives da = 0),
and taken features score −inf.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.solvebakp import solvebakp
from repro_torch.core.types import SelectResult, column_norms_sq, safe_inv


def _gather(xf: torch.Tensor, selected: torch.Tensor, mask: torch.Tensor):
    """The columns ``selected`` of ``xf`` where ``mask``, zero elsewhere."""
    nvars = xf.shape[1]
    idx = torch.where(mask, selected.clamp(0, nvars - 1),
                      torch.zeros_like(selected))
    return xf[:, idx.long()] * mask.float()


def solvebakf(x: torch.Tensor, y: torch.Tensor, *, max_feat: int,
              refit_sweeps: int = 8, refit_thr: int = 16) -> SelectResult:
    """Algorithm 3 (SolveBakF).

    Args:
      x: (obs, vars) feature matrix.
      y: (obs,) target.
      max_feat: number of features to select.
      refit_sweeps: CD sweeps for the per-step refit on the selected set.
      refit_thr: block width for the refit solver.
    Returns:
      ``SelectResult`` with the selection order, refit coefficients and the
      SSE path.
    """
    obs, nvars = x.shape
    dev = x.device
    xf = x.float()
    yf = y.float()
    inv_cn = safe_inv(column_norms_sq(x))
    slots = torch.arange(max_feat, device=dev)

    e = yf
    selected = torch.full((max_feat,), -1, dtype=torch.int32, device=dev)
    coef = torch.zeros((max_feat,), dtype=torch.float32, device=dev)
    sse_path = torch.full((max_feat,), math.nan, dtype=torch.float32,
                          device=dev)
    taken = torch.zeros((nvars,), dtype=torch.bool, device=dev)
    for f in range(max_feat):
        g = xf.T @ e                                  # ⟨x_j, e⟩ for all j
        reduction = torch.where(taken, -math.inf, g * g * inv_cn)
        jhat = torch.argmax(reduction)
        selected[f] = jhat.to(torch.int32)
        taken[jhat] = True
        x_sel = _gather(xf, selected, slots <= f)
        res = solvebakp(x_sel, yf, thr=refit_thr, max_iter=refit_sweeps,
                        mode="gram", a0=coef)
        coef, e = res.coef, res.residual
        sse_path[f] = res.sse
    return SelectResult(selected, coef, sse_path, e)


def stepwise_regression_baseline(x: torch.Tensor, y: torch.Tensor, *,
                                 max_feat: int) -> SelectResult:
    """The paper's comparison baseline (Fig 2): classical forward stepwise
    regression.  Each step trial-fits OLS on (selected + candidate) for
    every candidate, through ridge-stabilised normal equations batched over
    the candidates (``torch.linalg.solve_ex``, where JAX vmaps), and keeps
    the best.  A candidate already selected duplicates a column and makes
    its system singular; as in JAX its SSE is masked to +inf, so the solve
    is left unchecked.
    """
    obs, nvars = x.shape
    dev = x.device
    xf = x.float()
    yf = y.float()
    slots = torch.arange(max_feat, device=dev)
    eye = 1e-5 * torch.eye(max_feat, dtype=torch.float32, device=dev)

    def trial(xs, col_mask):
        # xs (..., obs, max_feat) masked columns; col_mask (..., max_feat).
        g = xs.transpose(-1, -2) @ xs + eye
        b = xs.transpose(-1, -2) @ yf
        coef = torch.linalg.solve_ex(g, b)[0] * col_mask
        r = yf - (xs @ coef[..., None])[..., 0]
        return (r * r).sum(-1), coef

    selected = torch.full((max_feat,), -1, dtype=torch.int32, device=dev)
    sse_path = torch.full((max_feat,), math.nan, dtype=torch.float32,
                          device=dev)
    taken = torch.zeros((nvars,), dtype=torch.bool, device=dev)
    cands = torch.arange(nvars, dtype=torch.int32, device=dev)
    for f in range(max_feat):
        cand_sel = selected.expand(nvars, max_feat).clone()
        cand_sel[:, f] = cands
        cand_mask = slots <= f
        idx = torch.where(cand_mask, cand_sel.clamp(0, nvars - 1),
                          torch.zeros_like(cand_sel)).long()
        xs = xf[:, idx].permute(1, 0, 2) * cand_mask.float()  # (cand, obs, F)
        sses, _ = trial(xs, cand_mask.float())
        sses = torch.where(taken, math.inf, sses)
        jhat = torch.argmin(sses)
        selected[f] = jhat.to(torch.int32)
        taken[jhat] = True
        sse_path[f] = sses[jhat]
    final_mask = selected >= 0
    xs = _gather(xf, selected, final_mask)
    _, coef = trial(xs, final_mask.float())
    residual = yf - xs @ coef
    return SelectResult(selected, coef, sse_path, residual)
