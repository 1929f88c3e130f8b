"""Parameter definition machinery.

Models declare their parameters as a tree (nested dicts) of ``ParamDef``
(shape + logical axes + init law), as the JAX package does.  From one
definition tree come ``init_params`` (tensors drawn from a
``torch.Generator``), ``count_params``, and ``params_from_numpy``, which
carries the JAX package's parameter tree across as it is.

Parameters are plain tensors in nested dicts whose keys are JAX's tree
paths (``params["backbone"]["layers"]["attn"]["wq"]``), in JAX's layout:
a weight is (..., d_in, d_out) and is applied as ``x @ w``, and the layers
are stacked on a leading dim.  Nothing is transposed on the way across.
The logical axes are kept for the sharded slice that will read them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.prepare import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis per dim
    init: str = "normal"              # normal | zeros | ones | embed | small
    scale: float = 1.0                # fan-in scaling multiplier

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def model_dtype(cfg) -> torch.dtype:
    """The torch dtype of ``cfg.dtype`` ("bfloat16" or "float32")."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a tree of nested dicts (JAX's key order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def unstack(tree, n: int):
    """The ``n`` layer trees of a tree stacked on a leading dim of ``n``:
    views of its leaves (``unbind``), so the layers' grads go back into
    each stacked leaf in one ``stack`` in backward."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) pairs of a tree of nested dicts, in JAX's
    flattening order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def init_std(d: ParamDef) -> float:
    """The std of a ``normal`` / ``embed`` / ``small`` draw: ``embed`` 1,
    ``small`` 0.02·scale, else scale / sqrt(fan-in) with fan-in the
    second-to-last dim (weights are (..., d_in, d_out)), or the last for
    1-D."""
    if d.init == "embed":
        return 1.0
    if d.init == "small":
        return 0.02 * d.scale
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return d.scale / math.sqrt(max(fan_in, 1))


# A tensor whose fp32 draw passes 8 GiB (a MoE model's stacked experts:
# dbrx's w_gate at 6 layers is 25 GB in fp32) is drawn in flat chunks of
# 1 GiB; every dense config's tensors are drawn whole.
_DRAW_WHOLE_BYTES = 1 << 33
_DRAW_CHUNK_BYTES = 1 << 30


def _init_array(d: ParamDef, generator: torch.Generator, dtype):
    dev = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=dev)
    # Drawn in fp32 and cast, one tensor at a time: the fp32 draw of the
    # largest tensor (or of its chunk) is the only transient.
    n = math.prod(d.shape)
    if 4 * n <= _DRAW_WHOLE_BYTES:
        t = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return t.mul_(init_std(d)).to(dtype)
    out = torch.empty(d.shape, dtype=dtype, device=dev)
    flat, step = out.view(-1), _DRAW_CHUNK_BYTES // 4
    for lo in range(0, n, step):
        t = torch.randn(min(step, n - lo), generator=generator,
                        dtype=torch.float32, device=dev)
        flat[lo:lo + t.numel()] = t.mul_(init_std(d))
    return out


def init_params(defs, generator: torch.Generator, dtype=torch.float32):
    """Tensors for a ``ParamDef`` tree, drawn from ``generator`` on its
    device.  The law is JAX's; the draws are not (``jax.random`` cannot be
    reproduced), so carry JAX's weights with ``params_from_numpy`` where
    values must match."""
    return tree_map(lambda d: _init_array(d, generator, dtype), defs)


def count_params(defs) -> int:
    return int(sum(np.prod(d.shape) for _, d in tree_items(defs)))


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (bf16 from ``ml_dtypes`` included) as a tensor of the
    same dtype on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_numpy(cfg, tree: Dict[str, Any], device=None):
    """The JAX package's parameter tree (nested dicts of numpy arrays, as
    ``jax.tree_util.tree_map(np.asarray, init_model(cfg, key))`` gives) as
    the port's: the same names, shapes, stacking and dtypes, on ``device``
    (default ``"cuda"``; raises without a GPU).  Raises ``ValueError`` when
    a name or shape differs from ``model_defs(cfg)``."""
    from repro_torch.models.model import model_defs

    dev = resolve_device(device)
    want = dict(tree_items(model_defs(cfg)))
    have = dict(tree_items(tree))
    if set(want) != set(have):
        raise ValueError(
            f"parameter names differ from model_defs({cfg.name}): missing "
            f"{sorted(set(want) - set(have))}, unexpected "
            f"{sorted(set(have) - set(want))}")
    for name, d in want.items():
        if tuple(np.shape(have[name])) != tuple(d.shape):
            raise ValueError(f"{name}: shape {np.shape(have[name])}, "
                             f"model_defs has {d.shape}")
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)
