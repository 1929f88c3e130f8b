"""Plain-torch oracles for the CUDA kernels.

Counterpart of ``repro.kernels.ref``: same update order, fp32 accumulation.
Layout convention as the JAX package: the kernels consume ``x_t``, the
TRANSPOSED design of shape (vars, obs), so each paper-"column" is a
contiguous row.
"""
from __future__ import annotations

import torch


def ref_cd_sweep(x_t: torch.Tensor, e: torch.Tensor, inv_cn: torch.Tensor):
    """Sequential (Gauss–Seidel) CD sweep over all rows of ``x_t``.

    Args:
      x_t: (vars, obs) transposed design.
      e: (obs,) residual, or (k, obs) multi-RHS residuals.
      inv_cn: (vars,) inverse squared column norms (0 for zero columns).
    Returns:
      (da, e'): (vars,)/(obs,) for 1-D ``e``, (vars, k)/(k, obs) otherwise.
    """
    nvars, obs = x_t.shape
    single = e.dim() == 1
    e2 = (e.reshape(1, obs) if single else e).float()
    inv = inv_cn.float()
    da = torch.zeros((nvars, e2.shape[0]), dtype=torch.float32,
                     device=x_t.device)
    for j in range(nvars):
        xj = x_t[j].float()
        d = (e2 @ xj) * inv[j]                            # (k,)
        e2 = e2 - d[:, None] * xj[None, :]
        da[j] = d
    if single:
        return da[:, 0], e2[0]
    return da, e2


def ref_bakp_sweep(x_t: torch.Tensor, e: torch.Tensor, inv_cn: torch.Tensor,
                   *, block: int, omega: float = 1.0):
    """Block-Jacobi (SolveBakP) sweep: Gauss–Seidel across blocks of rows of
    ``x_t``, Jacobi within a block.

    Args:
      x_t: (vars, obs); ``vars`` must be a multiple of ``block``.
      e: (obs,) residual, or (k, obs) multi-RHS residuals.
      inv_cn: (vars,) inverse squared column norms (0 for zero columns).
    Returns:
      (da, e'): (vars,)/(obs,) for 1-D ``e``, (vars, k)/(k, obs) otherwise.
    """
    nvars, obs = x_t.shape
    if nvars % block:
        raise ValueError(f"vars ({nvars}) must be a multiple of block ({block})")
    single = e.dim() == 1
    e2 = (e.reshape(1, obs) if single else e).float()
    nblocks = nvars // block
    xb = x_t.reshape(nblocks, block, obs)
    invb = inv_cn.reshape(nblocks, block).float()
    das = []
    for b in range(nblocks):
        xblk = xb[b].float()
        g = e2 @ xblk.T                                   # (k, block)
        da = omega * g * invb[b][None, :]
        e2 = e2 - da @ xblk
        das.append(da)
    da = torch.stack(das).permute(0, 2, 1).reshape(nvars, -1)   # (vars, k)
    if single:
        return da[:, 0], e2[0]
    return da, e2


def ref_block_update(x_t: torch.Tensor, e: torch.Tensor, da: torch.Tensor):
    """Residual correction ``e' = e − x_blkᵀ·da`` (paper Alg. 2 line 9).

    x_t: (block, obs); e: (obs,) or (k, obs); da: (block,) or (block, k).
    """
    ef, daf, xf = e.float(), da.float(), x_t.float()
    if ef.dim() == 1:
        return ef - daf @ xf
    return ef - daf.T @ xf


def ref_score_features(x_t: torch.Tensor, e: torch.Tensor,
                       inv_cn: torch.Tensor):
    """SolveBakF scoring: SSE reduction of a single CD step per feature,
    ``⟨x_j, e⟩² / ⟨x_j, x_j⟩`` (vars,)."""
    g = x_t.float() @ e.float()
    return g * g * inv_cn
