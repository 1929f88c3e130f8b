"""Train, prefill and decode steps of the LM stack.

The port of the JAX package's ``launch/steps.py``: each ``make_*_step``
closes over the config and returns the step function, for every family.

``make_train_step``'s step takes (params, opt_state, batch, step) and
returns (params, opt_state, metrics): the loss and its grads (gradient
accumulation over ``cfg.microbatch`` microbatches: one backward of l/k
each, the activations of one microbatch alive at a time), the grads
clipped to ``clip_norm`` by their global norm, the cosine schedule's rate
at ``step`` and one optimizer update (``cfg.optimizer``), the params and
the state updated in place.  The metrics are the mean over microbatches of
``forward_train``'s (``loss``, ``ce_loss``, the aux losses) plus
``grad_norm`` (before the clip) and ``lr``, 0-d tensors.  The batch holds
tensors on the params' device: ``tokens`` and ``labels`` (B, S) int32, an
M-RoPE ``positions`` (3, B, S) (split on its axis 1), enc-dec ``frames``
(B, S_src, d).

The serving steps update the cache in place and return it
(``models.model``); an SSM model's prefill continues from the states in
the cache it is given, so a new prompt takes a fresh cache.  A VLM batch
carries its M-RoPE ``positions`` (3, B, S) to prefill; decode takes them
as an optional (3, B, 1), by default the cache's length on every stream,
as JAX's ``forward_decode``; an enc-dec batch carries its ``frames`` to
prefill, which writes the cross-attention cache once.

Each builder takes a ``ShardCtx`` (default ``NULL_CTX``), which the
forwards read: on a mesh of DTensors the activations are constrained
where JAX constrains them, and the train step pins each grad to its
parameter's placements before the clip (JAX's ``with_sharding_constraint``
to the parameter shardings).  ``abstract_opt_state`` and
``abstract_cell_args`` build a cell's step and its arguments as stand-ins
that allocate nothing, for the dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.sharding import abstract_tensor
from repro_torch.models.common import NULL_CTX, ShardCtx
from repro_torch.models.kvcache import abstract_cache
from repro_torch.models.model import (abstract_model, forward_decode,
                                      forward_prefill, forward_train,
                                      input_specs, model_defs)
from repro_torch.models.params import (ParamDef, spec_for, tree_items,
                                       tree_map)
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedule import clip_by_global_norm, cosine_schedule


def split_microbatches(batch, k: int, ctx=NULL_CTX):
    """The ``k`` microbatches of a batch, as JAX's reshape to (k, B/k, …)
    splits it: microbatch j holds rows j·B/k to (j+1)·B/k - 1 of every
    entry (of axis 1 for the M-RoPE ``positions`` (3, B, S)), each
    constrained to shard its batch over the data axes, as JAX's
    ``_split_microbatches`` constrains the microbatch axis whole and the
    batch within it."""
    def part(name, x, j):
        axis = 1 if name == "positions" else 0
        n = x.shape[axis] // k
        y = x.narrow(axis, j * n, n)
        axes = [None] * y.dim()
        axes[axis] = "batch"
        return ctx.constrain(y, *axes)
    return [{name: part(name, x, j) for name, x in batch.items()}
            for j in range(k)]


def make_train_step(cfg, ctx: Optional[ShardCtx] = None, *,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, clip_norm: float = 1.0):
    ctx = ctx or NULL_CTX
    _, opt_update = make_optimizer(cfg.optimizer)

    def train_step(params, opt_state, batch, step):
        leaves = [t for _, t in tree_items(params)]
        k = cfg.microbatch
        per_mb = []
        for t in leaves:
            t.requires_grad_(True)
        try:
            for mb in split_microbatches(batch, k, ctx):
                loss, m = forward_train(cfg, params, mb, ctx)
                (loss / k).backward()
                per_mb.append({n: v.detach() for n, v in m.items()})
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = tree_map(lambda t: t.grad if t.grad is not None
                         else torch.zeros_like(t), params)
        for t in leaves:
            t.grad = None
        if ctx.mesh is not None:
            grads = tree_map(lambda g, p: _like_placements(g, p), grads,
                             params)
        metrics = {n: torch.stack([m[n] for m in per_mb]).mean()
                   for n in per_mb[0]}
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            lr = cosine_schedule(step, peak_lr=peak_lr, warmup_steps=warmup,
                                 total_steps=total_steps)
            params, opt_state = opt_update(grads, opt_state, params, lr=lr)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step


def _like_placements(g, p):
    """``g`` redistributed to ``p``'s placements where both are DTensors
    and differ (a partial sum reduce-scattered into the FSDP shard)."""
    from torch.distributed.tensor import DTensor
    if (isinstance(g, DTensor) and isinstance(p, DTensor)
            and tuple(g.placements) != tuple(p.placements)):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_prefill_step(cfg, ctx: Optional[ShardCtx] = None):
    ctx = ctx or NULL_CTX

    def prefill_step(params, batch, cache):
        return forward_prefill(cfg, params, batch, cache, ctx)

    return prefill_step


def make_decode_step(cfg, ctx: Optional[ShardCtx] = None):
    ctx = ctx or NULL_CTX

    def decode_step(params, tokens, cache, positions=None):
        return forward_decode(cfg, params, tokens, cache, ctx,
                              positions=positions)

    return decode_step


# ---------------------------------------------------------------------------
# Abstract optimizer state and cell arguments (the dry run's inputs)
# ---------------------------------------------------------------------------

def abstract_opt_state(cfg, mesh=None, rules=None):
    """Stand-ins for ``{adamw,adafactor}_init``'s state (``meta`` tensors,
    or DTensors with ``meta`` shards on a ``DeviceMesh``), each leaf
    sharded as the parameter it mirrors: JAX's ``abstract_opt_state``."""
    defs = model_defs(cfg)
    rules = rules or {}

    def full(d: ParamDef):
        return abstract_tensor(d.shape, torch.float32, mesh,
                               spec_for(d, rules) if mesh is not None
                               else None)

    count = abstract_tensor((), torch.int32, mesh, () if mesh is not None
                            else None)
    if cfg.optimizer == "adamw":
        return {"m": tree_map(full, defs), "v": tree_map(full, defs),
                "master": tree_map(full, defs), "count": count}

    def stat(d: ParamDef):
        if len(d.shape) >= 2:
            vr = ParamDef(d.shape[:-1], d.axes[:-1], d.init)
            vc = ParamDef(d.shape[:-2] + d.shape[-1:],
                          d.axes[:-2] + d.axes[-1:], d.init)
            return {"vr": full(vr), "vc": full(vc)}
        return {"v": full(d)}

    return {"stats": tree_map(stat, defs), "master": tree_map(full, defs),
            "count": count}


def abstract_cell_args(cfg, cell, mesh=None, rules=None):
    """(step, args) of this cell, the arguments stand-ins: JAX's
    ``abstract_cell_args``.  Train: (params, opt_state, batch, step 0),
    the step a host int (the schedule computes on the host); prefill:
    (params, batch, cache); decode: (params, tokens, cache)."""
    ctx = ShardCtx(mesh, rules) if mesh is not None else NULL_CTX
    params = abstract_model(cfg, mesh, rules)
    batch = input_specs(cfg, cell, mesh, rules)
    if cell.kind == "train":
        return make_train_step(cfg, ctx), (
            params, abstract_opt_state(cfg, mesh, rules), batch, 0)
    cache = abstract_cache(cfg, cell.global_batch, cell.seq_len, mesh, rules)
    if cell.kind == "prefill":
        return make_prefill_step(cfg, ctx), (params, batch, cache)
    return make_decode_step(cfg, ctx), (params, batch["tokens"], cache)
