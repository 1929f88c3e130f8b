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


def batch_atol_sse(obs: int, atols) -> torch.Tensor:
    """Per-system SSE thresholds ``f32(obs)·f32(atol_i)²`` of a batch of
    single-RHS systems, in fp32 as ``atol_to_sse`` computes one."""
    return torch.tensor([atol_to_sse(obs, 1, float(a)) for a in atols],
                        dtype=torch.float32)


def run_batched_sweeps(sweep, a, e, *, max_iter, atol_sse, rtol):
    """The sweep loop of a batch of systems, as ``jax.vmap`` runs a
    ``lax.while_loop`` over one.

    ``sweep(a, e) -> (a', e')`` advances every system one sweep (a (B, n,
    1), e (B, obs, 1)).  The loop runs while any system is live; a system
    stops by ``sweep_stop_flags`` on its own SSE history and
    ``atol_sse[i]``, and from then on its carry (coefficients, residual,
    SSE, history, ``converged``, sweep count) is frozen with
    ``torch.where``, so each system ends exactly where its single solve
    would.  One host read per sweep for the whole batch (``live.any()``).
    Returns ``(a, e, sse, n_sweeps, converged, history)``, each (B, ...).
    """
    bsz = a.shape[0]
    dev = e.device
    sse0 = torch.einsum("bok,bok->b", e, e)
    history = torch.full((bsz, max_iter), math.nan, dtype=torch.float32,
                         device=dev)
    atol_sse = atol_sse.to(dev)
    sse = sse0
    n = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    converged = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    live = torch.ones((bsz,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter and (it == 0 or bool(live.any())):
        a_new, e_new = sweep(a, e)
        sse_new = torch.einsum("bok,bok->b", e_new, e_new)
        conv_i, stop_i = sweep_stop_flags(sse_new, sse, sse0, atol_sse, rtol)
        col = live[:, None, None]
        a = torch.where(col, a_new, a)
        e = torch.where(col, e_new, e)
        history[:, it] = torch.where(live, sse_new, history[:, it])
        converged = torch.where(live, conv_i, converged)
        sse = torch.where(live, sse_new, sse)
        n = n + live.to(torch.int32)
        live = live & ~stop_i
        it += 1
    return a, e, sse, n, converged, history


def solvebakp_batched(
    xs: torch.Tensor,
    ys: torch.Tensor,
    *,
    thr: int = 128,
    max_iter: int = 50,
    atols=(),
    rtol: float = 0.0,
    omega: float = 1.0,
    mode: str = "jacobi",
    ridge: float = 1e-6,
    cns: Optional[torch.Tensor] = None,
    chols: Optional[torch.Tensor] = None,
    a0s: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Algorithm 2 on a batch of B single-RHS systems with designs of one
    shape: the port's counterpart of ``jax.vmap`` over ``solvebakp``.

    Plain torch over stacked tensors: ``bmm`` for the block products,
    batched ``torch.cholesky_solve`` for ``mode="gram"``, and the stopping
    rule per system (``run_batched_sweeps``).

    Args:
      xs: (B, obs, vars) designs.
      ys: (B, obs) right-hand sides.
      atols: B absolute tolerances, one a system (the serving engine's
        padding-corrected ones); empty means 0 for all.
      cns: optional (B, nblocks·thr) squared column norms (thr-padded).
      chols: optional (B, nblocks, thr, thr) block-Gram factors.
      a0s: optional (B, vars) warm starts (zero rows start cold).
      thr / max_iter / rtol / omega / mode / ridge: as ``solvebakp``.
    Returns:
      ``SolveResult`` with a leading batch axis on every field: coef
      (B, vars), residual (B, obs), sse / n_sweeps / converged (B,),
      history (B, max_iter).
    """
    if xs.dim() != 3 or ys.shape != xs.shape[:2]:
        raise ValueError(f"xs must be (B, obs, vars) and ys (B, obs), got "
                         f"{tuple(xs.shape)} and {tuple(ys.shape)}")
    if mode not in ("jacobi", "gram"):
        raise ValueError(f"unknown mode {mode!r}")
    bsz, obs, nvars = xs.shape
    nblocks = -(-nvars // thr)
    pad = nblocks * thr - nvars
    x_pad = xs.float()
    if pad:
        x_pad = torch.nn.functional.pad(x_pad, (0, pad))
    mask = (torch.arange(nblocks * thr, device=xs.device) < nvars).float()
    if cns is None:
        cns = torch.einsum("bov,bov->bv", x_pad, x_pad)
    inv_cn = safe_inv(cns.float()) * mask
    if mode == "gram" and chols is None:
        xb = x_pad.reshape(bsz, obs, nblocks, thr)
        gram = torch.einsum("bont,bons->bnts", xb, xb)
        gram = gram + ridge * torch.eye(thr, dtype=torch.float32,
                                        device=xs.device)
        chols = torch.linalg.cholesky(gram)
    a = torch.zeros((bsz, nblocks * thr, 1), dtype=torch.float32,
                    device=xs.device)
    if a0s is not None:
        a[:, :nvars, 0] = a0s.float()
    e = ys.float().reshape(bsz, obs, 1) - torch.bmm(x_pad, a)

    def sweep(a, e):
        a = a.clone()
        for b in range(nblocks):
            cols = slice(b * thr, (b + 1) * thr)
            xblk = x_pad[:, :, cols]                        # (B, obs, thr)
            g = torch.bmm(xblk.transpose(1, 2), e)          # (B, thr, 1)
            if mode == "jacobi":
                da = g * inv_cn[:, cols, None]
            else:
                da = (torch.cholesky_solve(g, chols[:, b])
                      * mask[cols][None, :, None])
            da = omega * da
            e = e - torch.bmm(xblk, da)
            a[:, cols] += da
        return a, e

    atol_sse = batch_atol_sse(obs, atols if len(atols) else [0.0] * bsz)
    a, e, sse, n, conv, hist = run_batched_sweeps(
        sweep, a, e, max_iter=max_iter, atol_sse=atol_sse, rtol=rtol)
    return SolveResult(a[:, :nvars, 0], e[:, :, 0], sse, n, conv, hist)
