"""AdamW with decoupled weight decay, fp32 master copies and moments.

The port of the JAX package's ``optim/adamw.py``.  The state is JAX's
tree: ``m``, ``v`` and ``master`` (fp32, each mirroring the parameter
tree) and ``count`` (0-d int32).  ``adamw_update`` writes the new moments,
master copies and count into the state and the parameters, re-cast from
the master (bf16 ones rounded), into ``params``, in place, and returns
both: at full width the state is six times the bf16 weights, too large to
copy.  The arithmetic is JAX's, in fp32, on groups of leaves through
torch's foreach ops; a group holds at most ``GROUP_BYTES`` of fp32 (a
larger leaf is a group of its own), which bounds the temporaries.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models.params import tree_items, tree_map

GROUP_BYTES = 1 << 30


def leaf_groups(*trees) -> List[List[tuple]]:
    """The trees' leaves zipped in tree order, in consecutive groups of at
    most ``GROUP_BYTES`` of fp32."""
    rows = list(zip(*([t for _, t in tree_items(tree)] for tree in trees)))
    groups, size = [[]], 0
    for row in rows:
        n = 4 * row[0].numel()
        if groups[-1] and size + n > GROUP_BYTES:
            groups.append([])
            size = 0
        groups[-1].append(row)
        size += n
    return [g for g in groups if g]


def adamw_init(params) -> Dict[str, Any]:
    """Zero moments, an fp32 master copy of every parameter (a distinct
    buffer even for an fp32 parameter) and a zero count."""
    zeros = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                           device=t.device), params)
    dev = next(t for _, t in tree_items(params)).device
    return {"m": zeros, "v": tree_map(torch.zeros_like, zeros),
            "master": tree_map(lambda t: t.detach().to(torch.float32,
                                                       copy=True), params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """One AdamW step on ``grads``; ``lr`` a float or a 0-d tensor.
    Returns (params, state), updated in place."""
    state["count"] += 1
    cf = state["count"].float()
    bc1 = 1.0 - torch.pow(b1, cf)
    bc2 = 1.0 - torch.pow(b2, cf)
    lr = float(lr)
    for group in leaf_groups(grads, state["m"], state["v"],
                             state["master"], params):
        gs, ms, vs, mas, ps = (list(c) for c in zip(*group))
        g = [t.float() for t in gs]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, g, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, g, g, value=1 - b2)
        del g
        denom = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(ms, bc1)
        torch._foreach_div_(step, denom)
        del denom
        torch._foreach_add_(step, mas, alpha=weight_decay)
        torch._foreach_mul_(step, lr)
        torch._foreach_sub_(mas, step)
        del step
        for p, ma in zip(ps, mas):
            p.copy_(ma)
    return params, state
