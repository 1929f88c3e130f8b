"""Shared result type and numeric helpers for the BAK solver family.

PyTorch counterpart of ``repro.core.types``.  The JAX module's
``donate_default`` has no counterpart: buffer donation is a ``jax.jit``
argument-aliasing contract, and PyTorch runs eagerly with caller-owned
tensors, so there is nothing to donate.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SolveResult(NamedTuple):
    """Result of a linear-system solve (all fields are tensors).

    Attributes:
      coef:       (vars,) solution ``a`` with ``x @ a ≈ y``; multi-RHS
                  (``y`` of shape (obs, k)): (vars, k).
      residual:   (obs,) final residual ``e = y - x @ a`` (fp32); multi-RHS:
                  (obs, k).
      sse:        0-d fp32 sum of squared residuals at exit (multi-RHS:
                  total over all k systems).
      n_sweeps:   0-d int32, number of full sweeps executed.
      converged:  0-d bool, True if a tolerance criterion fired before
                  ``max_iter`` was exhausted.
      history:    (max_iter,) fp32 SSE after each sweep (NaN for sweeps not
                  executed).
    """

    coef: torch.Tensor
    residual: torch.Tensor
    sse: torch.Tensor
    n_sweeps: torch.Tensor
    converged: torch.Tensor
    history: torch.Tensor


class SelectResult(NamedTuple):
    """Result of SolveBakF greedy feature selection.

    Attributes:
      selected:  (max_feat,) int32 indices of selected columns, in selection
                 order.
      coef:      (max_feat,) fp32 coefficients of the refit on the selected
                 columns (aligned with ``selected``).
      sse_path:  (max_feat,) fp32 SSE after each selection + refit step.
      residual:  (obs,) fp32 final residual.
    """

    selected: torch.Tensor
    coef: torch.Tensor
    sse_path: torch.Tensor
    residual: torch.Tensor


def column_norms_sq(x: torch.Tensor) -> torch.Tensor:
    """Squared column norms ``⟨x_j, x_j⟩`` of (obs, vars) ``x``, accumulated
    in fp32 whatever the input dtype, shape (vars,)."""
    xf = x.float()
    return torch.einsum("ij,ij->j", xf, xf)


def column_norms_sq_t(x_t: torch.Tensor) -> torch.Tensor:
    """``column_norms_sq`` on the transposed (vars, obs) kernel layout: a
    paper-"column" is a contiguous row, so the norms reduce over obs."""
    xf = x_t.float()
    return torch.einsum("vo,vo->v", xf, xf)


def safe_inv(cn: torch.Tensor) -> torch.Tensor:
    """1/cn with zero (not inf) for zero-norm columns: a zero column can
    never reduce the residual, so its update is defined as 0."""
    pos = cn > 0.0
    return torch.where(pos, 1.0 / torch.where(pos, cn, torch.ones_like(cn)),
                       torch.zeros_like(cn))


def warm_retention_ok(res: SolveResult) -> bool:
    """Whether a solve's coefficients are safe to keep as a warm start.

    False exactly when the solve looks diverged: ``converged`` is False AND
    the last finite SSE in its history is materially (>1%) above the first.
    Plain budget exhaustion with a non-increasing history still retains.
    A batched (non-scalar) ``converged`` returns True.
    """
    try:
        conv = np.asarray(torch.as_tensor(res.converged).cpu())
        if conv.ndim != 0 or bool(conv):
            return True
        h = np.asarray(torch.as_tensor(res.history).float().cpu()).ravel()
        h = h[np.isfinite(h)]
        if h.size >= 2 and float(h[-1]) > 1.01 * float(h[0]):
            return False
    except (TypeError, ValueError, RuntimeError):
        return True  # malformed/absent history: keep the coefficients
    return True


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def sweep_stop_flags(sse, sse_prev, sse0, atol_sse, rtol):
    """Per-sweep stopping decision shared by every iterative solver.

    Returns 0-d bool tensors ``(converged, stop)``, computed with fp32
    compares exactly as ``repro.core.types.sweep_stop_flags``:

      * ``stop`` — the absolute tolerance fired, the sweep improved SSE by
        at most ``rtol * sse_prev``, or SSE rose.
      * ``converged`` — the exit may be reported as success: an atol/rtol
        hit, or a rise that stays within the ``1.01 * sse0`` band (a stall
        at the accuracy floor).  A rise above the band is divergence.

    With ``rtol == 0`` the relative and divergence checks are off.  The
    CUDA fused kernel carries a device copy of this function
    (``kernels/csrc/bakp_block.cuh::sweep_stop_flags``).
    """
    sse, sse_prev, sse0 = _f32(sse), _f32(sse_prev), _f32(sse0)
    atol_sse, rtol = _f32(atol_sse), _f32(rtol)
    improved = sse <= sse_prev
    hit_atol = (atol_sse > 0.0) & (sse <= atol_sse)
    hit_rtol = (rtol > 0.0) & improved & ((sse_prev - sse) <= rtol * sse_prev)
    rose = (rtol > 0.0) & ~improved
    converged = hit_atol | hit_rtol | (rose & (sse <= 1.01 * sse0))
    return converged, hit_atol | hit_rtol | rose


def atol_to_sse(obs: int, nrhs: int, atol: float) -> float:
    """The SSE threshold ``f32(obs·k)·f32(atol)²`` computed in fp32, as the
    JAX solvers compute it; returned as the (exact) Python float."""
    return float(np.float32(obs * nrhs) * np.float32(atol) ** 2)
