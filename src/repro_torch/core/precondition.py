"""Column preconditioning for the BAK solvers.

Counterpart of ``repro.core.precondition``.  Coordinate descent's
per-sweep progress depends on column scaling; normalising columns to unit
norm is free to undo (rescale the coefficients) and makes
``⟨x_j, x_j⟩ = 1``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import column_norms_sq


class ColumnScaling(NamedTuple):
    scale: torch.Tensor  # (vars,) multiplier applied to columns (1/||x_j||)


def normalize_columns(x: torch.Tensor):
    """Returns (x_normalised, ColumnScaling).  Zero columns are left as-is."""
    cn = column_norms_sq(x)
    pos = cn > 0
    norm = torch.sqrt(torch.where(pos, cn, torch.ones_like(cn)))
    scale = torch.where(pos, 1.0 / norm, torch.ones_like(cn)).float()
    return (x.float() * scale[None, :]).to(x.dtype), ColumnScaling(scale)


def unscale_coef(coef: torch.Tensor, scaling: ColumnScaling) -> torch.Tensor:
    """Map coefficients of the normalised system back to the original one."""
    return coef * scaling.scale
