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
prefill, which writes the cross-attention cache once.  The abstract-state
builders wait for the sharded dry run (ROADMAP queue 1 item 3).
"""
from __future__ import annotations

import torch

from repro_torch.models.model import (forward_decode, forward_prefill,
                                      forward_train)
from repro_torch.models.params import tree_items, tree_map
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedule import clip_by_global_norm, cosine_schedule


def split_microbatches(batch, k: int):
    """The ``k`` microbatches of a batch, as JAX's reshape to (k, B/k, …)
    splits it: microbatch j holds rows j·B/k to (j+1)·B/k - 1 of every
    entry (of axis 1 for the M-RoPE ``positions`` (3, B, S))."""
    def part(name, x, j):
        axis = 1 if name == "positions" else 0
        n = x.shape[axis] // k
        return x.narrow(axis, j * n, n)
    return [{name: part(name, x, j) for name, x in batch.items()}
            for j in range(k)]


def make_train_step(cfg, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, clip_norm: float = 1.0):
    _, opt_update = make_optimizer(cfg.optimizer)

    def train_step(params, opt_state, batch, step):
        leaves = [t for _, t in tree_items(params)]
        k = cfg.microbatch
        per_mb = []
        for t in leaves:
            t.requires_grad_(True)
        try:
            for mb in split_microbatches(batch, k):
                loss, m = forward_train(cfg, params, mb)
                (loss / k).backward()
                per_mb.append({n: v.detach() for n, v in m.items()})
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = tree_map(lambda t: t.grad if t.grad is not None
                         else torch.zeros_like(t), params)
        for t in leaves:
            t.grad = None
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


def make_prefill_step(cfg):
    def prefill_step(params, batch, cache):
        return forward_prefill(cfg, params, batch, cache)

    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, tokens, cache, positions=None):
        return forward_decode(cfg, params, tokens, cache, positions)

    return decode_step
