"""Prefill and decode steps of the LM serving path.

The port of the JAX package's ``launch/steps.py`` for serving: each
``make_*_step`` closes over the config and returns the step function, for
every decoder-only family.  The steps update the cache in place and return
it (``models.model``); an SSM model's prefill continues from the states in
the cache it is given, so a new prompt takes a fresh cache.  A VLM
batch carries its M-RoPE ``positions`` (3, B, S) to prefill; decode takes
them as an optional (3, B, 1), by default the cache's length on every
stream, as JAX's ``forward_decode``.  The
train step and the abstract-state builders wait for training and the
sharded dry run (ROADMAP queue 1).
"""
from __future__ import annotations

from repro_torch.models.model import forward_decode, forward_prefill


def make_prefill_step(cfg):
    def prefill_step(params, batch, cache):
        return forward_prefill(cfg, params, batch, cache)

    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, tokens, cache, positions=None):
        return forward_decode(cfg, params, tokens, cache, positions)

    return decode_step
