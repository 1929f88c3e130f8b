"""Encoder-decoder backbone (seamless-m4t style, the speech frontend
stubbed).

The port of the JAX package's ``models/encdec.py``.  The encoder is a
bidirectional transformer over precomputed frame embeddings (B, S_src,
d_model): there is no input projection, the frontend is a stub by
contract; each layer ropes q and k at the frames' own positions, attends
without a causal mask, and the stack ends in an RMSNorm.  Each decoder
layer runs causal self-attention (roped), then cross-attention to the
encoder output (no rope on either side, no causal mask), then the SwiGLU
MLP.

Prefill runs the encoder once and writes each decoder layer's self K/V
(B, S_tgt, ·) and cross K/V (B, S_src, ·) into the cache's ``k`` / ``v``
and ``k_cross`` / ``v_cross``, zeroing the slots past them, as JAX's zero
pad to the buffers does; a source longer than ``src_len_for_decode``
raises ``ValueError`` (JAX's prefill fails there too).  Decode's cross
step attends every one of the cache's ``src_len_for_decode`` source
slots, zero-padded ones included, as JAX's does (``src_len =
kx4.shape[1]``): a decode step equals a full forward only at S_src =
``src_len_for_decode``.  In train mode each layer runs under
``transformer.remat``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (apply_mlp, matmul, mlp_defs, rmsnorm,
                                       rmsnorm_def, stacked)
from repro_torch.models.params import unstack
from repro_torch.models.transformer import _Entries, remat


def enc_block_defs(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": rmsnorm_def(d), "attn": attn_lib.gqa_defs(cfg),
            "ln2": rmsnorm_def(d), "ffn": mlp_defs(d, cfg.d_ff)}


def dec_block_defs(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": rmsnorm_def(d), "self_attn": attn_lib.gqa_defs(cfg),
            "ln_x": rmsnorm_def(d), "cross_attn": attn_lib.gqa_defs(cfg),
            "ln2": rmsnorm_def(d), "ffn": mlp_defs(d, cfg.d_ff)}


def encdec_defs(cfg) -> Dict[str, Any]:
    return {"enc": stacked(enc_block_defs(cfg), cfg.n_enc_layers),
            "enc_ln": rmsnorm_def(cfg.d_model),
            "dec": stacked(dec_block_defs(cfg), cfg.n_dec_layers)}


def run_encoder(cfg, params, frames):
    """frames: (B, S_src, d) stub-frontend embeddings → (B, S_src, d)."""
    b, s, _ = frames.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=frames.device)[None].expand(b, s)

    def layer(x, p):
        h = rmsnorm(x, p["ln1"])
        o, _ = attn_lib.gqa_attend(cfg, p["attn"], h, positions,
                                   causal=False)
        x = x + o
        return x + apply_mlp(p["ffn"], rmsnorm(x, p["ln2"]))

    x = frames
    for p in unstack(params["enc"], cfg.n_enc_layers):
        x = remat(cfg, layer, x, p)
    return rmsnorm(x, params["enc_ln"])


def run_decoder(cfg, params, x, enc_out, *, mode, positions, cache=None,
                lengths=None):
    """The decoder stack.  x: (B, S_tgt, d) embedded target tokens.

    Returns (hidden, new_cache_entries).  ``mode`` "train" / "prefill":
    teacher forcing over the whole target, cross K/V from ``enc_out``;
    prefill writes each layer's self and cross K/V into ``cache`` in place
    (or, without a cache, returns them stacked over layers).  "decode": one
    token (``enc_out`` unused), self K/V written at the new slot, cross
    K/V read from the cache.  Train returns no entries."""
    b, s, _ = x.shape
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    entries = _Entries(cache if mode != "train" else None)

    def layer(x, enc_out, p, i):
        h = rmsnorm(x, p["ln1"])
        if mode == "decode":
            o, _, _ = attn_lib.gqa_decode(
                cfg, p["self_attn"], h, positions,
                cache["k"][i].view(b, -1, hkv, hd),
                cache["v"][i].view(b, -1, hkv, hd), lengths)
        else:
            o, (k4, v4) = attn_lib.gqa_attend(cfg, p["self_attn"], h,
                                              positions)
            if mode == "prefill":
                entries.put("k", i, k4.reshape(b, s, hkv * hd), kv=True)
                entries.put("v", i, v4.reshape(b, s, hkv * hd), kv=True)
        x = x + o

        h = rmsnorm(x, p["ln_x"])
        if mode == "decode":
            kx4 = cache["k_cross"][i].view(b, -1, hkv, hd)
            vx4 = cache["v_cross"][i].view(b, -1, hkv, hd)
            q = attn_lib.gqa_query(cfg, p["cross_attn"], h)
            src_len = torch.full((b,), kx4.shape[1], dtype=torch.int32,
                                 device=x.device)
            o = attn_lib.decode_attention(q, kx4, vx4, src_len)
            o = matmul(o.reshape(b, 1, -1), p["cross_attn"]["wo"])
        else:
            # Cross K/V from the encoder output: no rope.
            kc = matmul(enc_out, p["cross_attn"]["wk"]).reshape(
                b, -1, hkv, hd)
            vc = matmul(enc_out, p["cross_attn"]["wv"]).reshape(
                b, -1, hkv, hd)
            o, _ = attn_lib.gqa_attend(cfg, p["cross_attn"], h, positions,
                                       kv_override=(kc, vc))
            if mode == "prefill":
                s_src = kc.shape[1]
                entries.put("k_cross", i, kc.reshape(b, s_src, hkv * hd),
                            kv=True)
                entries.put("v_cross", i, vc.reshape(b, s_src, hkv * hd),
                            kv=True)
        x = x + o
        return x + apply_mlp(p["ffn"], rmsnorm(x, p["ln2"]))

    for i, p in enumerate(unstack(params["dec"], cfg.n_dec_layers)):
        x = (remat(cfg, layer, x, enc_out, p, i) if mode == "train"
             else layer(x, enc_out, p, i))
    names = ("k", "v", "k_cross", "v_cross")
    if mode == "train":
        return x, {}
    if mode == "prefill" and cache is None:
        return x, entries.stacked()
    return x, {name: cache[name] for name in names}
