"""Top-level model API for every family (dense, MoE, VLM, SSM, hybrid,
enc-dec): the parameter tree, the train, prefill and decode forwards, and
the linear-probe features.

The port of the JAX package's ``models/model.py``.  The batch layout is
JAX's, ``{"tokens": (B, S) int32, "labels": (B, S) int32}``; the VLM
family (M-RoPE) adds ``"positions"`` (3, B, S) int32, the position
streams (t, h, w) of a prompt whose patch frontend is stubbed
(``make_smoke_batch`` gives each stream ``arange(S)``); the enc-dec family
adds ``"frames"`` (B, S_src, d_model), the stub speech frontend's
embeddings, cast to the model dtype on the way in.  ``forward_train``
returns (loss, metrics): the token-mean fp32 cross entropy plus the MoE
aux losses (their own metric keys, zero for the other decoder families,
absent for enc-dec).  The cache is updated in place (JAX returns a new one
from each step and its serving loop donates the old): ``forward_prefill``
writes the produced entries (a windowed layer's trimmed and rolled into
ring order; enc-dec's cross K/V once) into the preallocated buffers and
zeroes the slots past them, as JAX's zero pad does; ``forward_decode``
writes the new token's slot (and a Mamba2 block's new states) and
advances ``lengths``.  Both return the cache they were given.  The SSM
family's prefill starts from the states in the cache it is given, as
JAX's does: pass a fresh (zeroed) cache for a new prompt.

``init_model``, ``make_smoke_batch`` (and ``kvcache.init_cache``) run on
``"cuda"`` unless ``device="cpu"`` is passed, and raise without a GPU.

``input_specs``, ``abstract_model`` and ``abstract_decode_cache`` build a
cell's inputs as stand-ins that allocate nothing (``meta`` tensors, or on
a ``DeviceMesh`` DTensors with ``meta`` shards under the rules): what the
dry run (``launch/dryrun.py``) runs the steps on.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.prepare import resolve_device
from repro_torch.models import encdec as encdec_lib
from repro_torch.models.common import (NULL_CTX, embed_tokens,
                                       embedding_defs, rmsnorm, rmsnorm_def,
                                       softmax_xent, unembed)
from repro_torch.distributed.sharding import (PartitionSpec,
                                              abstract_tensor, divisible_spec)
from repro_torch.models.kvcache import abstract_cache
from repro_torch.models.params import (abstract_params, init_params,
                                       model_dtype)
from repro_torch.models.transformer import backbone_defs, run_backbone


def model_defs(cfg) -> Dict[str, Any]:
    """The ``ParamDef`` tree; raises ``NotImplementedError`` for a
    configuration this port does not run (``transformer.check_supported``)."""
    backbone = (encdec_lib.encdec_defs(cfg) if cfg.family == "encdec"
                else backbone_defs(cfg))
    return {"embed": embedding_defs(cfg.padded_vocab, cfg.d_model,
                                    cfg.tie_embeddings),
            "final_ln": rmsnorm_def(cfg.d_model),
            "backbone": backbone}


def _positions(cfg, batch, start, s):
    """(B, S) positions from ``start``; for the VLM family (M-RoPE) the
    three streams (3, B, S), each the same."""
    ar = torch.arange(s, device=start.device, dtype=start.dtype)
    pos = (start[:, None] + ar[None]).expand(batch, s)
    if cfg.family == "vlm":
        return pos[None].expand(3, batch, s)
    return pos


def _batch_positions(cfg, batch_inputs):
    """A batch's positions: the VLM family's own ``positions`` (3, B, S),
    JAX's layout; else 0..S-1 on every row."""
    tokens = batch_inputs["tokens"]
    if cfg.family == "vlm":
        return batch_inputs["positions"]
    b, s = tokens.shape
    zero = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
    return _positions(cfg, b, zero, s)


def _embed_inputs(cfg, params, batch_inputs, ctx):
    x = embed_tokens(params["embed"], batch_inputs["tokens"],
                     model_dtype(cfg))
    return ctx.constrain(x, "batch", None, None)


def _logits(cfg, params, x):
    x = rmsnorm(x, params["final_ln"])
    return unembed(params["embed"], x, tie=cfg.tie_embeddings,
                   final_softcap=cfg.final_softcap)


def _train_hidden(cfg, params, tokens, dtype, positions=None, frames=None,
                  ctx=NULL_CTX):
    """Hidden states of a train-mode pass (no cache) over ``tokens``
    embedded in ``dtype``, before the final norm, and the aux losses (none
    for enc-dec, whose decoder attends the encoded ``frames``)."""
    x = ctx.constrain(embed_tokens(params["embed"], tokens, dtype), "batch",
                      None, None)
    if positions is None:
        b, s = tokens.shape
        zero = torch.zeros((b,), dtype=torch.int32, device=x.device)
        positions = _positions(cfg, b, zero, s)
    if cfg.family == "encdec":
        enc_out = encdec_lib.run_encoder(cfg, params["backbone"],
                                         frames.to(dtype), ctx)
        h, _ = encdec_lib.run_decoder(cfg, params["backbone"], x, enc_out,
                                      mode="train", positions=positions,
                                      ctx=ctx)
        return h, {}
    h, _, aux = run_backbone(cfg, params["backbone"], x, mode="train",
                             positions=positions, ctx=ctx)
    return h, aux


def forward_train(cfg, params, batch, ctx=NULL_CTX):
    """The training loss of a batch.  Returns (loss, metrics): the fp32
    token-mean cross entropy of the logits against ``labels`` plus the aux
    losses, and ``ce_loss``, each aux loss under its own key, and
    ``loss``, all 0-d fp32 tensors.  ``ctx`` constrains the activations
    and the logits (batch, vocab) where JAX's does."""
    h, aux = _train_hidden(cfg, params, batch["tokens"], model_dtype(cfg),
                           batch.get("positions"), batch.get("frames"), ctx)
    logits = ctx.constrain(_logits(cfg, params, h), "batch", None,
                           "act_vocab")
    loss = softmax_xent(logits, batch["labels"])
    metrics = {"ce_loss": loss}
    for k, v in aux.items():
        v = torch.as_tensor(v, dtype=torch.float32, device=loss.device)
        loss = loss + v
        metrics[k] = v
    metrics["loss"] = loss
    return loss, metrics


def forward_prefill(cfg, params, batch, cache, ctx=NULL_CTX):
    """Fill the cache from a full prompt (and, for enc-dec, its
    ``frames``).  Returns (last_logits (B, V), cache), the cache written in
    place."""
    s = batch["tokens"].shape[1]
    x = _embed_inputs(cfg, params, batch, ctx)
    pos = _batch_positions(cfg, batch)
    if cfg.family == "encdec":
        enc_out = encdec_lib.run_encoder(
            cfg, params["backbone"], batch["frames"].to(model_dtype(cfg)),
            ctx)
        x, _ = encdec_lib.run_decoder(cfg, params["backbone"], x, enc_out,
                                      mode="prefill", positions=pos,
                                      cache=cache, ctx=ctx)
    else:
        x, _, _ = run_backbone(cfg, params["backbone"], x, mode="prefill",
                               positions=pos, cache=cache, ctx=ctx)
    cache["lengths"].fill_(s)
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def forward_decode(cfg, params, tokens, cache, ctx=NULL_CTX,
                   positions=None):
    """One decode step.  tokens: (B, 1).  Returns (logits (B, V), cache),
    the cache written in place.  Under M-RoPE ``positions`` (3, B, 1)
    defaults, as in JAX, to the cache's length on all three streams."""
    b = tokens.shape[0]
    pos = cache["lengths"][:, None].clone()      # 0-based new position
    if cfg.family == "vlm":
        pos = positions if positions is not None else pos[None].expand(
            3, b, 1)
    lengths = cache["lengths"] + 1
    x = embed_tokens(params["embed"], tokens, model_dtype(cfg))
    if cfg.family == "encdec":
        x, _ = encdec_lib.run_decoder(cfg, params["backbone"], x, None,
                                      mode="decode", positions=pos,
                                      cache=cache, lengths=lengths, ctx=ctx)
    else:
        x, _, _ = run_backbone(cfg, params["backbone"], x, mode="decode",
                               positions=pos, cache=cache, lengths=lengths,
                               ctx=ctx)
    cache["lengths"].copy_(lengths)
    return _logits(cfg, params, x)[:, 0], cache


def forward_logits(cfg, params, tokens, positions=None,
                   at: Optional[int] = None, frames=None):
    """Logits of one full forward without a cache, the reference a decode
    step from the cache is held to: (B, S, V) fp32 at every position, or
    (B, V) at position ``at`` only (the others are not unembedded).
    ``positions`` as ``forward_prefill`` reads them (default 0..S-1 on
    every row, and on every stream under M-RoPE); enc-dec takes its
    ``frames``."""
    h, _ = _train_hidden(cfg, params, tokens, model_dtype(cfg), positions,
                         frames)
    if at is not None:
        return _logits(cfg, params, h[:, at:at + 1])[:, 0]
    return _logits(cfg, params, h)


def probe_features(cfg, params, tokens, positions=None):
    """The linear-probe design (the JAX package's
    ``examples/linear_probe.py``): final-normed hidden states of a
    train-mode pass with the embedding in fp32, so every layer computes in
    fp32 against the model's weights.  (B·S, d_model) fp32."""
    h, _ = _train_hidden(cfg, params, tokens, torch.float32, positions)
    return rmsnorm(h, params["final_ln"]).reshape(-1, cfg.d_model)


def _tok_sds(shape, mesh, rules, dtype=torch.int32):
    """A batch input's stand-in: its batch dim over ``rules["batch"]``
    where it divides."""
    spec = None
    if mesh is not None:
        spec = divisible_spec(mesh, shape,
                              [rules["batch"]] + [None] * (len(shape) - 1))
    return abstract_tensor(shape, dtype, mesh, spec)


def input_specs(cfg, cell, mesh=None, rules=None) -> Dict[str, Any]:
    """Stand-ins for every model input of this cell (JAX's
    ``input_specs``): train and prefill ``tokens`` (and train's
    ``labels``) (B, S), the VLM's ``positions`` (3, B, S) (batch on axis
    1), enc-dec ``frames`` (B, S_src, d) (S_src = S in training, else
    ``src_len_for_decode``); decode one token (B, 1)."""
    rules = rules or {}
    b, s = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        batch = {"tokens": _tok_sds((b, s), mesh, rules),
                 "labels": _tok_sds((b, s), mesh, rules)}
        if cfg.family == "vlm":
            batch["positions"] = abstract_tensor(
                (3, b, s), torch.int32, mesh,
                None if mesh is None else PartitionSpec(
                    None, rules["batch"], None))
        if cfg.family == "encdec":
            src = s if cell.kind == "train" else cfg.src_len_for_decode
            batch["frames"] = _tok_sds((b, src, cfg.d_model), mesh, rules,
                                       model_dtype(cfg))
        if cell.kind == "prefill":
            batch.pop("labels")
        return batch
    return {"tokens": _tok_sds((b, 1), mesh, rules)}


def abstract_decode_cache(cfg, cell, mesh=None, rules=None):
    return abstract_cache(cfg, cell.global_batch, cell.seq_len, mesh, rules)


def abstract_model(cfg, mesh=None, rules=None, dtype=None):
    return abstract_params(model_defs(cfg), dtype or model_dtype(cfg), mesh,
                           rules)


def make_smoke_batch(cfg, seed: int = 0, batch: int = 2, seq: int = 32,
                     device=None) -> Dict[str, torch.Tensor]:
    """Random int32 ``tokens`` and ``labels`` (B, S) over the real vocab,
    from ``torch.Generator(device).manual_seed(seed)``; for the VLM family
    also JAX's ``positions`` (3, B, S), ``arange(S)`` on each stream; for
    enc-dec ``frames`` (B, S, d_model) fp32 standard normal from the same
    generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {name: torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=dev, dtype=torch.int32)
           for name in ("tokens", "labels")}
    if cfg.family == "vlm":
        ar = torch.arange(seq, dtype=torch.int32, device=dev)
        out["positions"] = ar[None, None].expand(3, batch, seq).contiguous()
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, seq, cfg.d_model), generator=gen,
                                    device=dev, dtype=torch.float32)
    return out


def init_model(cfg, seed: int = 0, dtype=None, device=None):
    """Random parameters by JAX's init law, in ``dtype`` (default the
    model's), drawn from ``torch.Generator(device).manual_seed(seed)``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(model_defs(cfg), gen, dtype or model_dtype(cfg))
