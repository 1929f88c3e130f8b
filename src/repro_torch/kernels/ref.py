"""Plain-torch oracles for the CUDA kernels.

Counterpart of ``repro.kernels.ref``: same update order, fp32 accumulation.
Layout convention as the JAX package: the kernels consume ``x_t``, the
TRANSPOSED design of shape (vars, obs), so each paper-"column" is a
contiguous row.  ``ref_cd_sweep``, ``ref_block_update`` and
``ref_score_features`` arrive with the slices that port their kernels.
"""
from __future__ import annotations

import torch


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
