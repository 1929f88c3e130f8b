"""Gradient compression: int8 quantisation with error feedback.

The port of the JAX package's ``distributed/compression.py``.  For
cross-pod gradient reduction the wire format matters: the pod axis link
is the slowest.  ``compress``/``decompress`` implement per-tensor
symmetric int8 with an error-feedback residual carried in the optimizer
loop (Karimireddy et al. 2019) so the quantisation noise does not bias
convergence.  As in the JAX package, no step calls it: it stands alone.

The arithmetic is JAX's, op for op in fp32, so q, the scale and the error
are bit-equal to it, on the CPU and on a card: ``torch.round`` and
``jnp.round`` both round half to even, both divisions are IEEE's, and the
scale keeps JAX's 1e-12 floor.
Trees are the port's nested dicts (``models.params.tree_map`` order).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.params import tree_map


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale fp32 0-d, new_error fp32)."""
    gf = g.float() + err
    # A tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, an ulp off the IEEE quotient JAX computes.
    scale = torch.clamp(gf.abs().max(), min=1e-12) / gf.new_tensor(127.0)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_tree(grads, err_tree):
    """Tree-map compress; returns (q_tree, scale_tree, new_err_tree)."""
    def split(a, b):
        if isinstance(a, dict):
            parts = {k: split(a[k], b[k]) for k in sorted(a)}
            return tuple({k: p[i] for k, p in parts.items()}
                         for i in range(3))
        return compress(a, b)
    return split(grads, err_tree)


def decompressed_tree(q_tree, scale_tree):
    return tree_map(decompress, q_tree, scale_tree)


def init_error_tree(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
