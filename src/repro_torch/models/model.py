"""Top-level model API for the dense GQA family: the parameter tree, the
prefill and decode forwards, and the linear-probe features.

The port of the JAX package's ``models/model.py`` for serving.  The batch
layout is JAX's, ``{"tokens": (B, S) int32}`` (``make_smoke_batch`` adds
``labels``).  The cache is updated in place (JAX returns a new one from
each step and its serving loop donates the old): ``forward_prefill`` writes
the produced K/V into the preallocated buffers and zeroes the slots past
the prompt, as JAX's zero pad does; ``forward_decode`` writes the new
token's slot and advances ``lengths``.  Both return the cache they were
given.  ``forward_train`` waits for training (ROADMAP queue 1 item 2).

``init_model``, ``make_smoke_batch`` (and ``kvcache.init_cache``) run on
``"cuda"`` unless ``device="cpu"`` is passed, and raise without a GPU.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.prepare import resolve_device
from repro_torch.models.common import (embed_tokens, embedding_defs, rmsnorm,
                                       rmsnorm_def, unembed)
from repro_torch.models.params import init_params, model_dtype
from repro_torch.models.transformer import backbone_defs, run_backbone


def model_defs(cfg) -> Dict[str, Any]:
    """The ``ParamDef`` tree; raises ``NotImplementedError`` for a family
    this port does not run yet."""
    backbone = backbone_defs(cfg)
    return {"embed": embedding_defs(cfg.padded_vocab, cfg.d_model,
                                    cfg.tie_embeddings),
            "final_ln": rmsnorm_def(cfg.d_model),
            "backbone": backbone}


def _positions(cfg, batch, start, s):
    ar = torch.arange(s, device=start.device, dtype=start.dtype)
    return (start[:, None] + ar[None]).expand(batch, s)


def _embed_inputs(cfg, params, batch_inputs):
    return embed_tokens(params["embed"], batch_inputs["tokens"],
                        model_dtype(cfg))


def _pad_cache_seq(buf, entry):
    """Write a produced prefill entry (L, B, S, F) into the cache buffer
    (L, B, Smax, F) in place and zero the slots past S: JAX's zero pad to
    the buffer's shape, without a second cache."""
    s = entry.shape[2]
    if s > buf.shape[2]:
        raise ValueError(f"prompt of {s} tokens over the cache's "
                         f"{buf.shape[2]} slots")
    buf[:, :, :s].copy_(entry)
    buf[:, :, s:].zero_()


def _logits(cfg, params, x):
    x = rmsnorm(x, params["final_ln"])
    return unembed(params["embed"], x, tie=cfg.tie_embeddings,
                   final_softcap=cfg.final_softcap)


def _train_hidden(cfg, params, tokens, dtype):
    """Hidden states of a train-mode pass (no cache) over ``tokens``
    embedded in ``dtype``, before the final norm."""
    b, s = tokens.shape
    x = embed_tokens(params["embed"], tokens, dtype)
    zero = torch.zeros((b,), dtype=torch.int32, device=x.device)
    h, _, _ = run_backbone(cfg, params["backbone"], x, mode="train",
                           positions=_positions(cfg, b, zero, s))
    return h


def forward_prefill(cfg, params, batch, cache):
    """Fill the cache from a full prompt.  Returns (last_logits (B, V),
    cache), the cache written in place."""
    b, s = batch["tokens"].shape
    x = _embed_inputs(cfg, params, batch)
    zero = torch.zeros((b,), dtype=torch.int32, device=x.device)
    x, new_entries, _ = run_backbone(cfg, params["backbone"], x,
                                     mode="prefill",
                                     positions=_positions(cfg, b, zero, s))
    for k, v in new_entries.items():
        _pad_cache_seq(cache[k], v)
    cache["lengths"].fill_(s)
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def forward_decode(cfg, params, tokens, cache):
    """One decode step.  tokens: (B, 1).  Returns (logits (B, V), cache),
    the cache written in place."""
    pos = cache["lengths"][:, None].clone()      # 0-based new position
    lengths = cache["lengths"] + 1
    x = embed_tokens(params["embed"], tokens, model_dtype(cfg))
    x, _, _ = run_backbone(cfg, params["backbone"], x, mode="decode",
                           positions=pos, cache=cache, lengths=lengths)
    cache["lengths"].copy_(lengths)
    return _logits(cfg, params, x)[:, 0], cache


def forward_logits(cfg, params, tokens):
    """Logits at every position of one full forward without a cache, the
    reference a decode step from the cache is held to.  (B, S, V) fp32."""
    return _logits(cfg, params,
                   _train_hidden(cfg, params, tokens, model_dtype(cfg)))


def probe_features(cfg, params, tokens):
    """The linear-probe design (the JAX package's
    ``examples/linear_probe.py``): final-normed hidden states of a
    train-mode pass with the embedding in fp32, so every layer computes in
    fp32 against the model's weights.  (B·S, d_model) fp32."""
    h = _train_hidden(cfg, params, tokens, torch.float32)
    return rmsnorm(h, params["final_ln"]).reshape(-1, cfg.d_model)


def make_smoke_batch(cfg, seed: int = 0, batch: int = 2, seq: int = 32,
                     device=None) -> Dict[str, torch.Tensor]:
    """Random int32 ``tokens`` and ``labels`` (B, S) over the real vocab,
    from ``torch.Generator(device).manual_seed(seed)``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {name: torch.randint(0, cfg.vocab_size, (batch, seq),
                                generator=gen, device=dev, dtype=torch.int32)
            for name in ("tokens", "labels")}


def init_model(cfg, seed: int = 0, dtype=None, device=None):
    """Random parameters by JAX's init law, in ``dtype`` (default the
    model's), drawn from ``torch.Generator(device).manual_seed(seed)``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(model_defs(cfg), gen, dtype or model_dtype(cfg))
