"""Decoder-only transformer assembly for the dense family with global GQA
attention: a loop over stacked layer parameters, K/V read and written per
mode.

The port of the JAX package's ``models/transformer.py`` on its ``dense`` /
``global`` branch.  ``run_backbone`` returns final hidden states, the new
cache entries and the auxiliary losses; embedding, unembedding and the
cache bookkeeping live in model.py.  JAX scans over the stacked layers and
returns a new cache from each step; this loops over the layer index and
writes each layer's K/V into the cache it is given, in place.

Configurations this does not run raise ``NotImplementedError`` naming the
ROADMAP item that ports them (``check_supported``), so nothing silently
runs a different model.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (apply_mlp, mlp_defs, rmsnorm,
                                       rmsnorm_def, stacked)
from repro_torch.models.params import tree_map

# The MoE losses; zero for the dense family.
ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense, global-GQA
    configuration, naming the item of ROADMAP.md's queue 1 that ports it."""
    waits = [
        (cfg.family == "moe" or cfg.n_experts > 0, "1e, MoE (dbrx, arctic)"),
        (cfg.family in ("ssm", "hybrid"),
         "1f, SSM and hybrid (mamba2, zamba2)"),
        (cfg.family == "encdec", "1g, enc-dec (seamless)"),
        (cfg.family == "vlm" or bool(cfg.mrope_sections),
         "1h, VLM / M-RoPE (qwen2-vl)"),
        (cfg.layer_pattern == "swa" or (cfg.sliding_window > 0
                                        and cfg.layer_pattern == "global"),
         "1a, the SWA ring cache (h2o-danube)"),
        (cfg.layer_pattern == "alt_local_global" or cfg.post_norm,
         "1b, alternating local/global layers with post-norms and softcaps "
         "(gemma2)"),
        (cfg.attn_type == "mla", "1c, MLA (minicpm3)"),
        (cfg.kv_quant == "int8", "1d, the int8 KV cache"),
    ]
    for hit, item in waits:
        if hit:
            raise NotImplementedError(
                f"{cfg.name}: not ported yet (family {cfg.family!r}, "
                f"layer_pattern {cfg.layer_pattern!r}, attn_type "
                f"{cfg.attn_type!r}, kv_quant {cfg.kv_quant!r}); ROADMAP.md "
                f"queue 1 item {item} ports it")
    if cfg.family != "dense" or cfg.layer_pattern != "global":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / layer_pattern "
            f"{cfg.layer_pattern!r} is not ported")


def dense_block_defs(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": rmsnorm_def(d), "attn": attn_lib.gqa_defs(cfg),
            "ln2": rmsnorm_def(d), "ffn": mlp_defs(d, cfg.d_ff)}


def apply_dense_block(cfg, p, x, *, positions, mode, kv=None, lengths=None,
                      q_offset=0):
    """One pre-norm block.  Returns (x', new_kv).

    ``kv``: decode mode's cache slice (k_flat, v_flat), each (B, Smax,
    Hkv·hd), written in place and returned.  In prefill mode new_kv holds
    the produced keys/values (B, S, Hkv·hd); in train mode it is None.
    """
    b, s, _ = x.shape
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    h = rmsnorm(x, p["ln1"])
    if mode == "decode":
        k4 = kv[0].view(b, -1, hkv, hd)
        v4 = kv[1].view(b, -1, hkv, hd)
        o, _, _ = attn_lib.gqa_decode(cfg, p["attn"], h, positions, k4, v4,
                                      lengths)
        new_kv = kv
    else:
        o, (k4, v4) = attn_lib.gqa_attend(cfg, p["attn"], h, positions,
                                          q_offset=q_offset)
        new_kv = None if mode == "train" else (
            k4.reshape(b, s, hkv * hd), v4.reshape(b, s, hkv * hd))
    x = x + o
    x = x + apply_mlp(p["ffn"], rmsnorm(x, p["ln2"]))
    return x, new_kv


def backbone_defs(cfg) -> Dict[str, Any]:
    check_supported(cfg)
    return {"layers": stacked(dense_block_defs(cfg), cfg.n_layers)}


def run_backbone(cfg, params, x, *, mode, positions, cache=None,
                 lengths=None, q_offset=0):
    """Run all layers.  x: (B, S, d) embedded inputs; ``mode`` "train",
    "prefill" or "decode".

    Returns (hidden, new_cache_entries, aux).  Prefill's entries are the
    produced K/V stacked over layers, (L, B, S, Hkv·hd); decode's are
    ``cache["k"]`` / ``cache["v"]`` themselves, each layer's new token
    written in place; train returns none.
    """
    check_supported(cfg)
    layers = params["layers"]
    produced = []
    for i in range(cfg.n_layers):
        p = tree_map(lambda t: t[i], layers)
        kv = (cache["k"][i], cache["v"][i]) if mode == "decode" else None
        x, new_kv = apply_dense_block(
            cfg, p, x, positions=positions, mode=mode, kv=kv,
            lengths=lengths, q_offset=q_offset)
        produced.append(new_kv)
    if mode == "prefill":
        new_cache = {"k": torch.stack([k for k, _ in produced]),
                     "v": torch.stack([v for _, v in produced])}
    elif mode == "decode":
        new_cache = {"k": cache["k"], "v": cache["v"]}
    else:
        new_cache = {}
    return x, new_cache, dict(ZERO_AUX)
