"""HostDesign and StoreBlockSource: what a non-resident handle reads.

Counterpart of ``repro.store.store.HostDesign`` (with ``read_cols``) and
``StoreBlockSource``, cut to what a non-resident ``PreparedDesign``
(``x_pad=None``) needs: a design whose x stays in host memory and reaches
the device one (thr, obs) tile at a time, through
``repro_torch.kernels.stream_solve.stream_solve_blocks``.

The host copy is kept in the transposed (vars, obs) layout, so a paper
"column" is a contiguous row and a tile is a contiguous slice of it: when
the handle's device is a GPU the copy is pinned, and ``block_t`` hands out
views of pinned memory that the host-to-device copy reads directly.

The source reads the ``HostDesign`` it is given.  The tiered
``DesignStore`` of the JAX package (device / host / disk tiers, demotion
and promotion, CRC-checked tile files, quarantine) is a later slice of the
port; nothing here moves bytes between tiers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.types import column_norms_sq_t


@dataclass
class HostDesign:
    """Host-memory copy of one design (see module doc).

    Attributes:
      key: the design's identity (its fingerprint).
      shape: (obs, vars) of the design.
      x_t: (vars, obs) fp32 CPU tensor, the transposed layout; pinned when
        the design is solved on a GPU.
      cn: (vars,) fp32 squared column norms.
    """

    key: str
    shape: Tuple[int, int]
    x_t: torch.Tensor
    cn: torch.Tensor

    @classmethod
    def from_design(cls, x, *, key: str, pin: bool) -> "HostDesign":
        """Copy an (obs, vars) design (array or tensor on any device) into
        host memory in the transposed layout, pinned when ``pin``."""
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.asarray(x, np.float32))
        if x.dim() != 2:
            raise ValueError(f"x must be 2D (obs, vars), got {tuple(x.shape)}")
        obs, nvars = x.shape
        x_t = torch.empty((nvars, obs), dtype=torch.float32, pin_memory=pin)
        x_t.copy_(x.T)
        return cls(key=key, shape=(obs, nvars), x_t=x_t,
                   cn=column_norms_sq_t(x_t))

    def read_cols(self, lo: int, hi: int) -> torch.Tensor:
        """Columns ``lo:hi`` in the transposed layout, (hi-lo, obs) fp32:
        a view of ``x_t`` when every column exists, else a copy whose rows
        at and above ``vars`` are zero (the thr padding)."""
        nvars = self.shape[1]
        if hi <= nvars:
            return self.x_t[lo:hi]
        out = torch.zeros((hi - lo, self.shape[0]), dtype=torch.float32)
        if lo < nvars:
            out[:nvars - lo] = self.x_t[lo:]
        return out


class StoreBlockSource:
    """Per-block fetch interface of a non-resident design: ``shape``
    (obs, vars), ``num_blocks(thr)`` and ``block_t(thr, j)``, the (thr, obs)
    fp32 tile ``j`` of the thr-blocked transposed layout."""

    def __init__(self, host: HostDesign):
        self.host = host
        self.key = host.key
        self.shape = tuple(host.shape)

    def num_blocks(self, thr: int) -> int:
        return -(-self.shape[1] // thr)

    def block_t(self, thr: int, j: int) -> torch.Tensor:
        """Tile ``j``, zero-padded past the real column count."""
        return self.host.read_cols(j * thr, (j + 1) * thr)
