"""Solver entries over the CUDA kernels.

Counterpart of ``repro.kernels.ops``.  ``solvebakp_kernel`` is the kernel
entry for the paper's Algorithm 2 (``variant="bakp"``) and Algorithm 1
(``variant="bak"``): the whole-solve kernel (``fused_solve``) when the
design fits the on-chip budget (``fused_fits``), else the per-sweep loop
(``solvebakp_persweep_kernel``), with the same ``record_dispatch`` labels
and reasons as the JAX package.

The per-sweep loop launches one sweep kernel per sweep (``bakp_sweep``, or
``cd_sweep`` for Algorithm 1) from a host loop; the residual goes back to
device memory at every sweep boundary and the stop is decided off the
card, with one host read of the stop flag per sweep, as in the JAX design.
Both paths take CPU tensors too (the plain versions run then), and an
fp32 or a bf16 ``x_t`` (the fit checks read its itemsize).
``solvebakp_stream_kernel`` is the out-of-core entry: the streaming
whole-solve kernel (``stream_solve``) when a CTA's tile ring fits
(``stream_fits``), else the same per-sweep loop.
``score_features_kernel`` and ``block_update_kernel`` are the entries of
the two streamed-obs kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.types import (SolveResult, atol_to_sse,
                                    column_norms_sq_t, safe_inv,
                                    sweep_stop_flags)
from repro_torch.kernels.block_update import block_update, score_features
from repro_torch.kernels.cd_sweep import bakp_sweep, cd_sweep
from repro_torch.kernels.fused_solve import (VARIANTS, fused_fits,
                                             fused_solve, solve_init,
                                             validate_solver_args)
from repro_torch.kernels.stream_solve import stream_fits, stream_solve
from repro_torch.obs import record_dispatch


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")


def solvebakp_persweep_kernel(
    x_t: torch.Tensor,
    y: torch.Tensor,
    *,
    cn: Optional[torch.Tensor] = None,
    inv_cn: Optional[torch.Tensor] = None,
    a0: Optional[torch.Tensor] = None,
    block: int = 256,
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    omega: float = 1.0,
    variant: str = "bakp",
) -> SolveResult:
    """Per-sweep SolveBak/SolveBakP: one sweep launch per sweep from a host
    loop that reads the stop flag once per sweep.  Arguments as
    ``solvebakp_kernel``."""
    _check_variant(variant)
    multi, nrhs, inv_cn = validate_solver_args(x_t, y, cn, inv_cn, a0)
    obs = x_t.shape[1]
    inv_cn, a, e = solve_init(x_t, y, inv_cn, a0, multi)
    sse0 = torch.dot(e.reshape(-1), e.reshape(-1))
    history = torch.full((max_iter,), math.nan, dtype=torch.float32,
                         device=x_t.device)
    atol_sse = atol_to_sse(obs, nrhs, atol)
    sse, n, converged = sse0, 0, torch.tensor(False)
    while n < max_iter:
        if variant == "bak":
            da, e = cd_sweep(x_t, e, inv_cn, block=block)
        else:
            da, e = bakp_sweep(x_t, e, inv_cn, block=block, omega=omega)
        a = a + da
        sse_new = torch.dot(e.reshape(-1), e.reshape(-1))
        history[n] = sse_new
        converged, stop = sweep_stop_flags(sse_new, sse, sse0, atol_sse, rtol)
        sse, n = sse_new, n + 1
        if bool(stop):                       # the one host read per sweep
            break
    n_t = torch.tensor(n, dtype=torch.int32)
    if not multi:
        return SolveResult(a[:, 0], e[0], sse, n_t, converged, history)
    return SolveResult(a, e.T, sse, n_t, converged, history)


def solvebakp_kernel(
    x_t: torch.Tensor,
    y: torch.Tensor,
    *,
    cn: Optional[torch.Tensor] = None,
    inv_cn: Optional[torch.Tensor] = None,
    a0: Optional[torch.Tensor] = None,
    block: int = 256,
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    omega: float = 1.0,
    variant: str = "bakp",
) -> SolveResult:
    """Kernel-path SolveBak/SolveBakP: fused when the design fits, else
    per-sweep.

    Args:
      x_t: (vars, obs) TRANSPOSED design; vars a multiple of ``block``.
      y: (obs,) right-hand side, or (obs, k).
      cn / inv_cn: optional precomputed (inverse) squared column norms.
      a0: optional (vars,) / (vars, k) warm start.
      variant: "bakp" (Algorithm 2 sweeps) or "bak" (Algorithm 1,
        sequential column order; ``omega`` is ignored).
    Returns:
      ``SolveResult``; multi-RHS gives (vars, k) coef and (obs, k) residual.
    """
    _check_variant(variant)
    nvars, obs = x_t.shape
    _, nrhs, inv_cn = validate_solver_args(x_t, y, cn, inv_cn, a0)
    if (max_iter >= 1
            and fused_fits(nvars, obs, nrhs, x_t.element_size(),
                           max_iter=max_iter)):
        record_dispatch("fused", method=variant)
        return fused_solve(x_t, y, inv_cn=inv_cn, a0=a0, block=block,
                           max_iter=max_iter, atol=atol, rtol=rtol,
                           omega=omega, variant=variant)
    reason = "max_iter" if max_iter < 1 else "vmem"
    record_dispatch("persweep", method=variant, reason=reason)
    return solvebakp_persweep_kernel(
        x_t, y, inv_cn=inv_cn, a0=a0, block=block, max_iter=max_iter,
        atol=atol, rtol=rtol, omega=omega, variant=variant)


def solvebakp_stream_kernel(
    x_t: torch.Tensor,
    y: torch.Tensor,
    *,
    cn: Optional[torch.Tensor] = None,
    inv_cn: Optional[torch.Tensor] = None,
    a0: Optional[torch.Tensor] = None,
    block: int = 256,
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    omega: float = 1.0,
) -> SolveResult:
    """Streaming SolveBakP: x stays in device memory and its tiles stream
    through each CTA's shared-memory ring while the residual, coefficients
    and stop state stay on chip (``stream_solve``).  A CTA's shared memory
    does not grow with vars, so designs far over the whole-solve budget
    keep the single-launch, early-exit solve.  Arguments as
    ``solvebakp_kernel`` (Algorithm 2 only); falls back to the per-sweep
    loop when even the ring does not fit or ``max_iter < 1``.
    """
    nvars, obs = x_t.shape
    _, nrhs, inv_cn = validate_solver_args(x_t, y, cn, inv_cn, a0)
    if (max_iter >= 1
            and stream_fits(nvars, obs, nrhs, x_t.element_size(),
                            block=block, max_iter=max_iter)):
        record_dispatch("stream", method="bakp")
        return stream_solve(x_t, y, inv_cn=inv_cn, a0=a0, block=block,
                            max_iter=max_iter, atol=atol, rtol=rtol,
                            omega=omega)
    reason = "max_iter" if max_iter < 1 else "vmem"
    record_dispatch("persweep", method="bakp", reason=reason)
    return solvebakp_persweep_kernel(
        x_t, y, inv_cn=inv_cn, a0=a0, block=block, max_iter=max_iter,
        atol=atol, rtol=rtol, omega=omega, variant="bakp")


def score_features_kernel(x_t: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """SolveBakF feature scores ``⟨x_j, e⟩²/⟨x_j, x_j⟩`` for every row of
    ``x_t`` (vars, obs) against the residual ``e`` (obs,)."""
    inv_cn = safe_inv(column_norms_sq_t(x_t))
    return score_features(x_t, e, inv_cn)


def block_update_kernel(x_t_blk: torch.Tensor, e: torch.Tensor,
                        da: torch.Tensor) -> torch.Tensor:
    """Rank-CB residual correction ``e − x_blkᵀ·da`` (paper Algorithm 2,
    line 9); shapes as ``block_update``."""
    return block_update(x_t_blk, e, da)
