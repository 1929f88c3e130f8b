"""The LR schedule and gradient clipping.

The port of the JAX package's ``optim/schedule.py``.  ``cosine_schedule``
computes in fp32 on the host, as JAX's does on its step counter, so the
rate is JAX's to the bit and no device read is needed.  ``global_norm`` /
``clip_by_global_norm`` run on the device (foreach ops): the norm sums
each leaf's squares in fp32, and the clip scales in fp32 and rounds back
to each grad's dtype, in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.params import tree_items


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1
                    ) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``min_ratio`` of
    it at ``total_steps``.  A 0-d fp32 CPU tensor."""
    s = torch.as_tensor(step).to(torch.float32).cpu()
    warm = peak_lr * s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32: a 0-d tensor on
    the leaves' device."""
    leaves = [t for _, t in tree_items(tree)]
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by min(1, max_norm / the global norm), in fp32 and
    rounded back to its dtype, in place.  Returns (tree, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    leaves = [t for _, t in tree_items(tree)]
    f32 = [t for t in leaves if t.dtype == torch.float32]
    if f32:
        torch._foreach_mul_(f32, scale)
    for t in leaves:
        if t.dtype != torch.float32:
            t.copy_(t.float() * scale)
    return tree, norm
