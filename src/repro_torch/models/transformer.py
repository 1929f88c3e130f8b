"""Decoder-only transformer assembly for the dense and VLM families: the
global, sliding-window (SWA) and gemma2 local/global layer patterns, GQA
(with an optional int8 KV cache) or MLA attention, optional post-norms.  A
loop over stacked layer parameters, K/V read and written per mode.

The port of the JAX package's ``models/transformer.py`` on its
``dense|moe|vlm`` branch without MoE.  ``run_backbone`` returns final
hidden states, the new cache entries and the auxiliary losses; embedding,
unembedding and the cache bookkeeping live in model.py.  JAX scans over the
stacked layers and returns a new cache from each step; this loops over the
layer index and writes each layer's K/V into the cache it is given, in
place.

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

# The MoE losses; zero for the families ported.
ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a configuration this port does not
    run, naming the item of ROADMAP.md's queue 1 that ports it.

    A sliding window on the ``global`` layer pattern raises too: the JAX
    package sizes a ring cache for it but attends without the window, and
    its prefill fails once a prompt passes the window; no config uses it.
    """
    waits = [
        (cfg.family == "moe" or cfg.n_experts > 0, "1e, MoE (dbrx, arctic)"),
        (cfg.family in ("ssm", "hybrid"),
         "1f, SSM and hybrid (mamba2, zamba2)"),
        (cfg.family == "encdec", "1g, enc-dec (seamless)"),
        (cfg.sliding_window > 0 and cfg.layer_pattern == "global",
         "1a, the SWA ring cache, on the swa pattern only (a window on the "
         "global pattern is not run by the JAX package either)"),
    ]
    for hit, item in waits:
        if hit:
            raise NotImplementedError(
                f"{cfg.name}: not ported (family {cfg.family!r}, "
                f"layer_pattern {cfg.layer_pattern!r}, n_experts "
                f"{cfg.n_experts}, sliding_window {cfg.sliding_window}); "
                f"ROADMAP.md queue 1 item {item}")
    if cfg.family not in ("dense", "vlm") or cfg.layer_pattern not in (
            "global", "swa", "alt_local_global"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / layer_pattern "
            f"{cfg.layer_pattern!r} is not ported (ROADMAP.md queue 1)")


def dense_block_defs(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    attn = (attn_lib.mla_defs(cfg) if cfg.attn_type == "mla"
            else attn_lib.gqa_defs(cfg))
    defs = {"ln1": rmsnorm_def(d), "attn": attn,
            "ln2": rmsnorm_def(d), "ffn": mlp_defs(d, cfg.d_ff)}
    if cfg.post_norm:
        defs["post1"] = rmsnorm_def(d)
        defs["post2"] = rmsnorm_def(d)
    return defs


def _prefill_kv(cfg, k4, v4, window):
    """A layer's produced K/V (B, S, Hkv, hd) as its cache entries: the
    last min(window, S) tokens of a windowed layer, rolled so token t sits
    at slot t % window; int8 codes and scales where the cache is int8;
    K/V flat (B, smax, Hkv·hd)."""
    b, s, hkv, hd = k4.shape
    smax = min(window, s) if window else s
    k_keep, v_keep = k4[:, -smax:], v4[:, -smax:]
    if window and s > smax:
        shift = s % smax
        k_keep = torch.roll(k_keep, shift, dims=1)
        v_keep = torch.roll(v_keep, shift, dims=1)
    if cfg.kv_quant == "int8":
        kq8, ks = attn_lib.quantize_kv(k_keep)
        vq8, vs = attn_lib.quantize_kv(v_keep)
        return (kq8.reshape(b, smax, hkv * hd), vq8.reshape(b, smax, hkv * hd),
                ks, vs)
    return (k_keep.reshape(b, smax, hkv * hd),
            v_keep.reshape(b, smax, hkv * hd))


def apply_dense_block(cfg, p, x, *, positions, mode, window=0, kv=None,
                      lengths=None, q_offset=0):
    """One pre-norm block (post-norms on the attention and MLP outputs
    where ``cfg.post_norm``).  Returns (x', new_kv).

    ``kv``: decode mode's cache slices, each (B, Smax, ·), written in place
    and returned: (k_flat, v_flat) for GQA, (k, v, k_scale, v_scale) for
    the int8 cache, (c_kv, k_rope) for MLA.  In prefill mode new_kv holds
    the layer's cache entries as ``_prefill_kv`` (or MLA's latent pair)
    makes them; in train mode it is None.
    """
    b, s, _ = x.shape
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    h = rmsnorm(x, p["ln1"])
    if cfg.attn_type == "mla":
        if mode == "decode":
            o, _, _ = attn_lib.mla_decode(cfg, p["attn"], h, positions,
                                          kv[0], kv[1], lengths)
            new_kv = kv
        else:
            o, latent = attn_lib.mla_attend(cfg, p["attn"], h, positions,
                                            q_offset=q_offset)
            new_kv = None if mode == "train" else latent
    elif mode == "decode":
        k4 = kv[0].view(b, -1, hkv, hd)
        v4 = kv[1].view(b, -1, hkv, hd)
        if cfg.kv_quant == "int8":
            o, *_ = attn_lib.gqa_decode_quant(
                cfg, p["attn"], h, positions, k4, v4, kv[2], kv[3], lengths,
                window=window)
        else:
            o, _, _ = attn_lib.gqa_decode(cfg, p["attn"], h, positions, k4,
                                          v4, lengths, window=window)
        new_kv = kv
    else:
        o, (k4, v4) = attn_lib.gqa_attend(cfg, p["attn"], h, positions,
                                          window=window, q_offset=q_offset)
        new_kv = None if mode == "train" else _prefill_kv(cfg, k4, v4,
                                                          window)
    if cfg.post_norm:
        o = rmsnorm(o, p["post1"])
    x = x + o
    f = apply_mlp(p["ffn"], rmsnorm(x, p["ln2"]))
    if cfg.post_norm:
        f = rmsnorm(f, p["post2"])
    return x + f, new_kv


def backbone_defs(cfg) -> Dict[str, Any]:
    check_supported(cfg)
    if cfg.layer_pattern == "alt_local_global":
        pair = {"local": dense_block_defs(cfg),
                "global": dense_block_defs(cfg)}
        return {"pairs": stacked(pair, cfg.n_layers // 2)}
    return {"layers": stacked(dense_block_defs(cfg), cfg.n_layers)}


def _block_runs(cfg):
    """(sub-tree of a stacked layer, window, its cache entries) for each
    block a layer index runs: a gemma2 pair's local then global block, or
    the one block of every other pattern."""
    if cfg.layer_pattern == "alt_local_global":
        return [("local", cfg.sliding_window, ("k_local", "v_local")),
                ("global", 0, ("k_global", "v_global"))]
    window = cfg.sliding_window if cfg.layer_pattern == "swa" else 0
    if cfg.attn_type == "mla":
        names = ("c_kv", "k_rope")
    elif cfg.kv_quant == "int8":
        names = ("k", "v", "k_scale", "v_scale")
    else:
        names = ("k", "v")
    return [(None, window, names)]


def _write_prefill_entry(buf, entry):
    """Write a layer's produced prefill entry (B, S', ·) into its cache
    slice (B, Smax, ·) in place and zero the slots past S': JAX's zero pad
    to the buffer's shape, without a second cache."""
    s = entry.shape[1]
    if s > buf.shape[1]:
        raise ValueError(f"prefill produced {s} slots, over the cache's "
                         f"{buf.shape[1]}")
    buf[:, :s].copy_(entry)
    buf[:, s:].zero_()


def run_backbone(cfg, params, x, *, mode, positions, cache=None,
                 lengths=None, q_offset=0):
    """Run all layers.  x: (B, S, d) embedded inputs; ``mode`` "train",
    "prefill" or "decode"; ``positions`` (B, S), or (3, B, S) under
    M-RoPE.

    Returns (hidden, new_cache_entries, aux).  Prefill's entries are the
    produced cache entries stacked over layers (or layer pairs), (L, B,
    smax, ·), or, given a ``cache``, its own tensors with each layer's
    entries written in place as it runs (``_write_prefill_entry``); decode's
    are the cache's own tensors, each layer's new token written in place;
    train returns none.  A gemma2 pair runs its local (windowed) layer,
    then its global one.
    """
    check_supported(cfg)
    runs = _block_runs(cfg)
    names = [name for _, _, own in runs for name in own]
    if len(runs) == 2:
        stack, n = params["pairs"], cfg.n_layers // 2
    else:
        stack, n = params["layers"], cfg.n_layers
    produced = {name: [] for name in names}
    for i in range(n):
        for sub, window, own in runs:
            p = tree_map(lambda t: t[i], stack if sub is None else stack[sub])
            kv = (tuple(cache[name][i] for name in own)
                  if mode == "decode" else None)
            x, new_kv = apply_dense_block(
                cfg, p, x, positions=positions, mode=mode, window=window,
                kv=kv, lengths=lengths, q_offset=q_offset)
            if mode == "prefill" and cache is not None:
                for name, t in zip(own, new_kv):
                    _write_prefill_entry(cache[name][i], t)
            elif mode == "prefill":
                for name, t in zip(own, new_kv):
                    produced[name].append(t)
    if mode == "prefill" and cache is None:
        new_cache = {name: torch.stack(ts) for name, ts in produced.items()}
    elif mode != "train":
        new_cache = {name: cache[name] for name in names}
    else:
        new_cache = {}
    return x, new_cache, dict(ZERO_AUX)
