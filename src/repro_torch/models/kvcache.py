"""KV and state caches of the decoder-only families.

The port of the JAX package's ``models/kvcache.py`` for those layouts, with
the same dict: ``lengths`` (B,) int32 and a leading layer (or layer-pair,
or unit) dim that matches the layer loop.  K/V are stored flat on the
trailing dim (Hkv·hd).  A cache is a plain dict of tensors that the forwards update in
place.  Layouts:

  global GQA    : ``k`` / ``v`` (L, B, Smax, Hkv·hd) in the model dtype.
  SWA           : the same with Smax = min(window, max_len): a ring buffer
                  of ``window`` slots once max_len reaches the window.
  int8 KV       : ``k`` / ``v`` int8 and fp32 ``k_scale`` / ``v_scale``
                  (L, B, Smax, Hkv), linear or ring as above.
  gemma2 pairs  : ``k_local`` / ``v_local`` (L/2, B, min(window, max_len),
                  Hkv·hd) and ``k_global`` / ``v_global`` (L/2, B, max_len,
                  Hkv·hd).
  MLA           : the latent ``c_kv`` (L, B, Smax, kv_lora_rank) and
                  ``k_rope`` (L, B, Smax, qk_rope_dim), no per-head K/V.
  SSM (mamba2)  : ``conv`` (L, B, K-1, conv_dim) in the model dtype and
                  ``ssm`` (L, B, H, P, N) fp32: constant in the sequence
                  length.
  hybrid        : ``conv`` / ``ssm`` (U, M, B, ·) for the M Mamba2 blocks
                  of each of U units, ``conv_tail`` / ``ssm_tail`` (T, B,
                  ·) for the trailing blocks, and ``k`` / ``v`` (U, B,
                  Smax, Hkv·hd) for each unit's invocation of the shared
                  attention block (never int8).
  enc-dec       : the decoder's self-attention ``k`` / ``v`` (L_dec, B,
                  Smax, Hkv·hd) and its cross-attention ``k_cross`` /
                  ``v_cross`` (L_dec, B, src_len_for_decode, Hkv·hd),
                  written once by prefill from the encoder output.

MoE models have their dense pattern's layout.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.prepare import resolve_device
from repro_torch.models.params import model_dtype, tensor_from_numpy
from repro_torch.models.ssm import ssm_dims
from repro_torch.models.transformer import check_supported


def cache_spec_tree(cfg, batch: int, max_len: int) -> Dict[str, Any]:
    """{name: (shape, dtype)} description of the cache: JAX's names,
    shapes and dtypes."""
    check_supported(cfg)
    hkv_hd = cfg.n_kv_heads * cfg.resolved_head_dim
    dt = model_dtype(cfg)
    out: Dict[str, Any] = {"lengths": ((batch,), torch.int32)}
    if cfg.family == "encdec":
        lb = (cfg.n_dec_layers, batch)
        out["k"] = out["v"] = (lb + (max_len, hkv_hd), dt)
        out["k_cross"] = out["v_cross"] = (
            lb + (cfg.src_len_for_decode, hkv_hd), dt)
        return out
    if cfg.family in ("ssm", "hybrid"):
        _, nh, conv_dim = ssm_dims(cfg)
        conv = (batch, cfg.ssm_conv - 1, conv_dim)
        state = (batch, nh, cfg.ssm_head_dim, cfg.ssm_state)
        if cfg.family == "ssm":
            out["conv"] = ((cfg.n_layers,) + conv, dt)
            out["ssm"] = ((cfg.n_layers,) + state, torch.float32)
            return out
        um, t = (cfg.hybrid_units, cfg.mamba_per_unit), cfg.trailing_mamba
        out["conv"] = (um + conv, dt)
        out["ssm"] = (um + state, torch.float32)
        out["conv_tail"] = ((t,) + conv, dt)
        out["ssm_tail"] = ((t,) + state, torch.float32)
        out["k"] = out["v"] = ((cfg.hybrid_units, batch, max_len, hkv_hd),
                               dt)
        return out
    if cfg.layer_pattern == "alt_local_global":
        npairs = cfg.n_layers // 2
        w = min(cfg.sliding_window, max_len)
        out["k_local"] = out["v_local"] = ((npairs, batch, w, hkv_hd), dt)
        out["k_global"] = out["v_global"] = (
            (npairs, batch, max_len, hkv_hd), dt)
    elif cfg.attn_type == "mla":
        lat = (cfg.n_layers, batch, max_len)
        out["c_kv"] = (lat + (cfg.kv_lora_rank,), dt)
        out["k_rope"] = (lat + (cfg.qk_rope_dim,), dt)
    else:
        smax = (min(cfg.sliding_window, max_len) if cfg.sliding_window
                else max_len)
        kv = (cfg.n_layers, batch, smax)
        if cfg.kv_quant == "int8":
            out["k"] = out["v"] = (kv + (hkv_hd,), torch.int8)
            out["k_scale"] = out["v_scale"] = (kv + (cfg.n_kv_heads,),
                                               torch.float32)
        else:
            out["k"] = out["v"] = (kv + (hkv_hd,), dt)
    return out


def init_cache(cfg, batch: int, max_len: int, device=None
               ) -> Dict[str, torch.Tensor]:
    """A zeroed cache on ``device`` (default ``"cuda"``; raises without a
    GPU)."""
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dtype, device=dev)
            for k, (shape, dtype) in cache_spec_tree(cfg, batch,
                                                     max_len).items()}


def cache_bytes(cfg, batch, max_len) -> int:
    return int(sum(np.prod(shape) * dtype.itemsize
                   for shape, dtype in cache_spec_tree(cfg, batch,
                                                       max_len).values()))


def _max_len_of(cfg, cache: Dict[str, Any]) -> int:
    """The ``max_len`` a cache was made for, read off its slots as the JAX
    package's ``_max_len_of`` reads it.  A ring's slots are min(window,
    max_len): every max_len from the window up has that layout.  The SSM
    family's cache has no slots; its layout is the same at every max_len,
    so it falls through to ``cfg.max_cache_len``, which sizes nothing."""
    for k in ("k_global", "c_kv", "k"):
        if k in cache:
            return np.shape(cache[k])[2]
    return cfg.max_cache_len


def cache_from_numpy(cfg, cache: Dict[str, Any], device=None
                     ) -> Dict[str, torch.Tensor]:
    """A JAX cache dict (numpy arrays) as the port's, entry by entry, on
    ``device`` (default ``"cuda"``).  Raises ``ValueError`` when its names,
    shapes or dtypes are not ``cache_spec_tree``'s."""
    dev = resolve_device(device)
    batch = np.shape(cache["lengths"])[0]
    spec = cache_spec_tree(cfg, batch, _max_len_of(cfg, cache))
    if set(cache) != set(spec):
        raise ValueError(f"cache entries {sorted(cache)}, want {sorted(spec)}")
    out = {k: tensor_from_numpy(cache[k], dev) for k in spec}
    for k, (shape, dtype) in spec.items():
        if tuple(out[k].shape) != shape or out[k].dtype != dtype:
            raise ValueError(f"cache {k}: {tuple(out[k].shape)} "
                             f"{out[k].dtype}, want {shape} {dtype}")
    return out
