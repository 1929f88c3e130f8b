"""SolveBak — Algorithm 1 of the paper, bit-faithful serial coordinate descent.

Counterpart of ``repro.core.solvebak``.  For each column ``j`` (cyclically,
or in a fresh random order per sweep):

    da   = ⟨x_j, e⟩ / ⟨x_j, x_j⟩
    e   ←  e - x_j * da
    a_j ←  a_j + da

The JAX package leaves this path to XLA, so here it is plain torch, eager,
on whatever device ``x`` lives on, on the (obs, vars) layout.  The whole
solve on one CUDA launch is the ``bak_fused`` method's kernel
(``repro_torch.kernels.fused_solve``, ``variant="bak"``).  Inner products
accumulate in fp32; multi-RHS ``y`` of shape (obs, k) shares one pass over
``x`` per sweep.  The stop check reads one scalar (the stop flag) to the
host per sweep.

Random order: JAX draws ``jax.random.permutation(fold_in(key, i))`` per
sweep; the port takes a ``torch.Generator`` and draws
``torch.randperm(vars, generator=...)`` per sweep.  The two streams differ,
so the two packages agree on the converged solution, not sweep by sweep.

The JAX entry's ``unroll`` (an XLA loop-unrolling knob) and ``donate`` (a
``jax.jit`` buffer-donation contract) have no meaning in eager PyTorch and
are not taken.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.types import (SolveResult, atol_to_sse,
                                    column_norms_sq, safe_inv,
                                    sweep_stop_flags)


def solvebak(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    a0: Optional[torch.Tensor] = None,
    order: str = "cyclic",
    generator: Optional[torch.Generator] = None,
    cn: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Algorithm 1 (SolveBak).

    Args:
      x: (obs, vars) design (any float dtype; fp32 accumulation).
      y: (obs,) right-hand side, or (obs, k).
      max_iter / atol / rtol: sweep budget and tolerances, as ``solvebakp``.
      a0: optional (vars,) / (vars, k) start; (vars,) broadcasts over k.
      order: "cyclic" (paper Algorithm 1) or "random" (a fresh permutation
        per sweep; needs ``generator``).
      generator: ``torch.Generator`` on ``x``'s device for
        ``order="random"``.
      cn: optional precomputed squared column norms (vars,).
    Returns:
      ``SolveResult``; multi-RHS gives (vars, k) coef and (obs, k) residual
      with total-SSE scalars.
    """
    if x.dim() != 2:
        raise ValueError(f"x must be 2D (obs, vars), got {tuple(x.shape)}")
    if y.dim() not in (1, 2):
        raise ValueError(f"y must be (obs,) or (obs, k), got {tuple(y.shape)}")
    obs, nvars = x.shape
    if order not in ("cyclic", "random"):
        raise ValueError(f"unknown order {order!r}")
    if order == "random" and generator is None:
        raise ValueError("order='random' requires a torch.Generator")
    multi = y.dim() == 2
    nrhs = y.shape[1] if multi else 1
    if a0 is not None and tuple(a0.shape) not in ((nvars,), (nvars, nrhs)):
        raise ValueError(
            f"a0 must be ({nvars},) or ({nvars}, {nrhs}) matching x columns "
            f"and y RHS count, got {tuple(a0.shape)}")
    xf = x.float()
    inv_cn = safe_inv((column_norms_sq(x) if cn is None else cn).float())

    a = torch.zeros((nvars, nrhs), dtype=torch.float32, device=x.device)
    if a0 is not None:
        a[:] = a0.float().reshape(nvars, -1).expand(nvars, nrhs)
    e = y.reshape(obs, nrhs).float() - xf @ a             # paper line 2
    sse0 = torch.dot(e.reshape(-1), e.reshape(-1))
    history = torch.full((max_iter,), math.nan, dtype=torch.float32,
                         device=x.device)
    atol_sse = atol_to_sse(obs, nrhs, atol)
    sse, n, converged = sse0, 0, torch.tensor(False)
    cyclic = range(nvars)
    while n < max_iter:
        perm = (cyclic if order == "cyclic" else
                torch.randperm(nvars, generator=generator,
                               device=generator.device).tolist())
        for j in perm:
            xj = xf[:, j]
            da = (xj @ e) * inv_cn[j]                     # (k,)
            e = e - xj[:, None] * da[None, :]
            a[j] += da
        sse_new = torch.dot(e.reshape(-1), e.reshape(-1))
        history[n] = sse_new
        converged, stop = sweep_stop_flags(sse_new, sse, sse0, atol_sse, rtol)
        sse, n = sse_new, n + 1
        if bool(stop):                          # one host read per sweep
            break
    if not multi:
        a, e = a[:, 0], e[:, 0]
    return SolveResult(a, e, sse, torch.tensor(n, dtype=torch.int32),
                       converged, history)


def solvebak_onesweep(x: torch.Tensor, y: torch.Tensor, a: torch.Tensor,
                      e: torch.Tensor):
    """A single cyclic sweep: ``(a', e')`` after one pass over all columns,
    exactly the inner loop of Algorithm 1 (``y`` is unused, as in JAX)."""
    xf = x.float()
    inv_cn = safe_inv(column_norms_sq(x))
    a, e = a.clone(), e.float()
    for j in range(x.shape[1]):
        xj = xf[:, j]
        da = torch.dot(xj, e) * inv_cn[j]
        a[j] += da
        e = e - xj * da
    return a, e
