"""SolveBakP — Algorithm 2 of the paper (block-parallel CD) + Gram-block mode.

Counterpart of ``repro.core.solvebakp``.  The JAX package leaves this path
to XLA, so here it is plain torch (``torch.matmul``, ``torch.linalg``),
eager, on whatever device ``x`` lives on.

``mode="jacobi"`` is the paper-faithful Algorithm 2: the ``thr`` columns of
a block all read the same residual, then the residual is corrected once per
block with a rank-``thr`` update.  ``mode="gram"`` solves each block's
normal equations exactly through cached Cholesky factors of the block Gram
matrices (exact block Gauss–Seidel).  ``omega`` relaxes every block update.
Multi-RHS ``y`` of shape (obs, k) shares one pass over ``x`` per sweep.

The stop check reads one scalar (the stop flag) to the host per sweep; the
fused CUDA kernel (``repro_torch.kernels.fused_solve``) is the path that
decides on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.types import (SolveResult, atol_to_sse,
                                    column_norms_sq, safe_inv,
                                    sweep_stop_flags)


def _pad_cols(x: torch.Tensor, thr: int):
    """Zero-pad columns of x to a multiple of thr; returns (x_pad, mask,
    nblocks) with mask 1 on real columns."""
    obs, nvars = x.shape
    nblocks = -(-nvars // thr)
    pad = nblocks * thr - nvars
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    mask = (torch.arange(nblocks * thr, device=x.device) < nvars).float()
    return x, mask, nblocks


def block_gram_cholesky(xb: torch.Tensor, ridge: float) -> torch.Tensor:
    """Lower Cholesky factors (nblocks, thr, thr) fp32 of the per-block Gram
    matrices of the blocked view ``xb`` (obs, nblocks, thr), with ``ridge``
    on the diagonal (which also makes padded zero columns well-posed)."""
    xf = xb.float()
    gram = torch.einsum("obt,obs->bts", xf, xf)
    thr = xb.shape[-1]
    gram = gram + ridge * torch.eye(thr, dtype=torch.float32,
                                    device=xb.device)[None]
    return torch.linalg.cholesky(gram)


def solvebakp(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    thr: int = 128,
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    omega: float = 1.0,
    mode: str = "jacobi",
    ridge: float = 1e-6,
    a0: Optional[torch.Tensor] = None,
    cn: Optional[torch.Tensor] = None,
    chol: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Algorithm 2 (SolveBakP), blocked over ``thr`` columns.

    Args:
      x: (obs, vars) design.
      y: (obs,) right-hand side, or (obs, k).
      thr: block width (the paper's thread-count parameter).
      max_iter / atol / rtol: sweep budget and tolerances.
      omega: relaxation factor for every block update (1.0 = paper).
      mode: "jacobi" (paper Algorithm 2) or "gram" (exact block CD).
      ridge: diagonal regulariser for mode="gram".
      a0: optional (vars,) or (vars, k) start; (vars,) broadcasts over k.
      cn: optional squared column norms of the padded matrix
        (nblocks·thr,).
      chol: optional ``block_gram_cholesky`` factors (nblocks, thr, thr),
        used by mode="gram".
    Returns:
      ``SolveResult`` with coef truncated to ``vars``; multi-RHS gives
      (vars, k) coef and (obs, k) residual with total-SSE scalars.
    """
    obs, nvars = x.shape
    if y.dim() not in (1, 2):
        raise ValueError(f"y must be (obs,) or (obs, k), got {tuple(y.shape)}")
    multi = y.dim() == 2
    nrhs = y.shape[1] if multi else 1
    y2 = y.reshape(obs, nrhs).float()
    if a0 is not None and tuple(a0.shape) not in ((nvars,), (nvars, nrhs)):
        raise ValueError(
            f"a0 must be ({nvars},) or ({nvars}, {nrhs}) matching x columns "
            f"and y RHS count, got {tuple(a0.shape)}")
    if mode not in ("jacobi", "gram"):
        raise ValueError(f"unknown mode {mode!r}")
    x_pad, mask, nblocks = _pad_cols(x.float(), thr)
    if cn is None:
        cn = column_norms_sq(x_pad)
    inv_cn = safe_inv(cn.float()) * mask
    if mode == "gram" and chol is None:
        chol = block_gram_cholesky(x_pad.reshape(obs, nblocks, thr), ridge)

    a = torch.zeros((nblocks * thr, nrhs), dtype=torch.float32,
                    device=x.device)
    if a0 is not None:
        a[:nvars] = a0.float().reshape(nvars, -1).expand(nvars, nrhs)
    e = y2 - x_pad @ a
    sse0 = torch.dot(e.reshape(-1), e.reshape(-1))
    history = torch.full((max_iter,), math.nan, dtype=torch.float32,
                         device=x.device)
    atol_sse = atol_to_sse(obs, nrhs, atol)
    sse, n, converged = sse0, 0, torch.tensor(False)
    while n < max_iter:
        for b in range(nblocks):
            cols = slice(b * thr, (b + 1) * thr)
            xblk = x_pad[:, cols]                           # (obs, thr)
            g = xblk.T @ e                                  # (thr, k)
            if mode == "jacobi":
                da = g * inv_cn[cols][:, None]
            else:
                da = torch.cholesky_solve(g, chol[b]) * mask[cols][:, None]
            da = omega * da
            e = e - xblk @ da                   # paper line 9
            a[cols] += da
        sse_new = torch.dot(e.reshape(-1), e.reshape(-1))
        history[n] = sse_new
        converged, stop = sweep_stop_flags(sse_new, sse, sse0, atol_sse, rtol)
        sse, n = sse_new, n + 1
        if bool(stop):                          # one host read per sweep
            break
    coef = a[:nvars]
    if not multi:
        coef, e = coef[:, 0], e[:, 0]
    return SolveResult(coef, e, sse, torch.tensor(n, dtype=torch.int32),
                       converged, history)
