"""Plain reference: the least-squares solution of ``x @ a = y`` in fp64.

Independent of the program under test: plain PyTorch, fed only with the
benchmark's own ``x`` and right-hand sides.  The normal equations are
formed in fp64 over row blocks of ``x`` (so a 1 GiB design never needs an
fp64 copy of itself) and solved through a Cholesky factor; for the tall,
well-conditioned Gaussian designs of these cells (condition number of
``x`` about 1.1 to 3) that is exact to about 1e-14.

``coef_error`` then reads the program's coefficients against it.

``solve(..., precision="tf32")`` is the correctness check's control: this
reference put in the program's place and computed in the nearest
precision below the fp32 (TF32 off) that the configurations state.  Every
product's inputs are rounded to TF32's 10-bit mantissa (what a TF32
matmul does to them) and summed and solved in fp32; the rounding is done
here, so the control reads the same on any device.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK_BYTES = 1 << 28   # fp64 bytes of x a block holds


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` rounded to TF32 (10 mantissa bits, to nearest)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def solve(x: torch.Tensor, y_rows: np.ndarray,
          precision: str = "fp64") -> np.ndarray:
    """(vars, n) least-squares solutions for the n right-hand sides
    ``y_rows`` (n, obs), on ``x``'s device: in fp64, or in TF32 (the
    control)."""
    if precision not in ("fp64", "tf32"):
        raise ValueError(f"precision {precision!r}: fp64 or tf32")
    tf32 = precision == "tf32"
    dtype = torch.float32 if tf32 else torch.float64
    cast = to_tf32 if tf32 else (lambda t: t.to(torch.float64))
    obs, nvars = x.shape
    dev = x.device
    gram = torch.zeros((nvars, nvars), dtype=dtype, device=dev)
    rhs = torch.zeros((nvars, y_rows.shape[0]), dtype=dtype, device=dev)
    ys = torch.from_numpy(np.ascontiguousarray(y_rows)).to(dev)
    step = max(1, BLOCK_BYTES // (8 * nvars))
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for r0 in range(0, obs, step):
            xb = cast(x[r0:r0 + step])
            gram += xb.T @ xb
            rhs += xb.T @ cast(ys[:, r0:r0 + step].T)
            del xb
        chol = torch.linalg.cholesky(gram)
        out = torch.cholesky_solve(rhs, chol)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    return out.to(torch.float64).cpu().numpy()


def coef_error(coef: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """max |coef - ref| / max |ref| per row of ``coef`` (n, vars) against
    the rows of ``ref`` (n, vars)."""
    c = coef.astype(np.float64)
    return (np.abs(c - ref).max(axis=1)
            / np.maximum(np.abs(ref).max(axis=1), np.finfo(np.float64).tiny))
