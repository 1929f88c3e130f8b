"""The KV cache of the dense global-GQA family.

The port of the JAX package's ``models/kvcache.py`` for that layout, with
the same dict: ``lengths`` (B,) int32 and ``k`` / ``v`` of shape
(L, B, Smax, Hkv·hd) in the model dtype, K/V stored flat on the trailing
dim.  A cache is a plain dict of tensors that the forwards update in
place.  The other families' layouts (ring buffers, gemma2's pairs, MLA
latents, int8, SSM states, enc-dec) wait with their models.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.prepare import resolve_device
from repro_torch.models.params import model_dtype, tensor_from_numpy
from repro_torch.models.transformer import check_supported


def cache_spec_tree(cfg, batch: int, max_len: int) -> Dict[str, Any]:
    """{name: (shape, dtype)} description of the cache."""
    check_supported(cfg)
    kv = ((cfg.n_layers, batch, max_len,
           cfg.n_kv_heads * cfg.resolved_head_dim), model_dtype(cfg))
    return {"lengths": ((batch,), torch.int32), "k": kv, "v": kv}


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


def cache_from_numpy(cfg, cache: Dict[str, Any], device=None
                     ) -> Dict[str, torch.Tensor]:
    """A JAX cache dict (numpy arrays) as the port's, entry by entry, on
    ``device`` (default ``"cuda"``).  Raises ``ValueError`` when its names,
    shapes or dtypes are not ``cache_spec_tree``'s."""
    dev = resolve_device(device)
    batch, max_len = np.shape(cache["k"])[1], np.shape(cache["k"])[2]
    spec = cache_spec_tree(cfg, batch, max_len)
    if set(cache) != set(spec):
        raise ValueError(f"cache entries {sorted(cache)}, want {sorted(spec)}")
    out = {k: tensor_from_numpy(cache[k], dev) for k in spec}
    for k, (shape, dtype) in spec.items():
        if tuple(out[k].shape) != shape or out[k].dtype != dtype:
            raise ValueError(f"cache {k}: {tuple(out[k].shape)} "
                             f"{out[k].dtype}, want {shape} {dtype}")
    return out
