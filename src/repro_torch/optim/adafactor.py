"""Adafactor (Shazeer & Stern 2018): a factored second moment and no
first moment, so about 4 bytes a parameter (the fp32 master) plus
O(rows + cols) statistics.

The port of the JAX package's ``optim/adafactor.py``, for the configs
whose AdamW state is too large (arctic-480b).  The moment is factored on
the trailing two dims of every leaf of two or more dims (a stacked (L, r,
c) leaf keeps (L, r) and (L, c)); a 1-D leaf keeps its full second
moment.  The state is JAX's tree: ``stats`` ({"vr", "vc"} or {"v"} per
leaf), ``master`` (fp32) and ``count`` (0-d int32).  ``adafactor_update``
writes the state and the parameters (re-cast from the master) in place,
leaf by leaf (the statistics are per-leaf means), and returns both.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.params import tree_items, tree_map


def _factored(shape) -> bool:
    return len(shape) >= 2


def _stat(p):
    z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                  device=p.device)
    if _factored(p.shape):
        return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
    return {"v": z(p.shape)}


def adafactor_init(params) -> Dict[str, Any]:
    dev = next(t for _, t in tree_items(params)).device
    return {"stats": tree_map(_stat, params),
            "master": tree_map(lambda t: t.detach().to(torch.float32,
                                                       copy=True), params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _stat_leaves(stats, params):
    """Each parameter's statistics dict, in the parameters' tree order."""
    out = []
    for path, _ in tree_items(params):
        node = stats
        for key in path.split("."):
            node = node[key]
        out.append(node)
    return out


@torch.no_grad()
def adafactor_update(grads, state, params, *, lr, decay=0.8, eps=1e-30,
                     clip_threshold=1.0, weight_decay=0.0):
    """One Adafactor step (``beta2 = 1 - count^-decay``, updates clipped
    by their RMS); ``lr`` a float or a 0-d tensor.  Returns (params,
    state), updated in place."""
    state["count"] += 1
    beta2 = 1.0 - state["count"].float() ** (-decay)
    lr = float(lr)
    rows = zip((t for _, t in tree_items(grads)),
               _stat_leaves(state["stats"], params),
               (t for _, t in tree_items(state["master"])),
               (t for _, t in tree_items(params)))
    for g, st, master, p in rows:
        g = g.float()
        g2 = g * g + eps
        if _factored(g.shape):
            vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(dim=-2)
            denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            v_hat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            update = g / torch.sqrt(v_hat + eps)
            st["vr"].copy_(vr)
            st["vc"].copy_(vc)
        else:
            v = beta2 * st["v"] + (1 - beta2) * g2
            update = g / torch.sqrt(v + eps)
            st["v"].copy_(v)
        rms = torch.sqrt((update * update).mean() + eps)
        update = update / torch.clamp(rms / clip_threshold, min=1.0)
        master.sub_(lr * (update + weight_decay * master))
        p.copy_(master)
    return params, state
