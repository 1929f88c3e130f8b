"""The optimizer of a config (``ModelConfig.optimizer``), and JAX's
optimizer state carried across.

The port of the JAX package's ``optim/api.py``, plus
``opt_state_from_numpy``: with ``params_from_numpy`` it starts the port
from JAX's exact training state, so one step can be held against JAX's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np

from repro_torch.core.prepare import resolve_device
from repro_torch.models.params import tensor_from_numpy, tree_items, tree_map
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update


def make_optimizer(kind: str) -> Tuple[Callable, Callable]:
    """Returns (init_fn(params) -> state, update_fn(grads, state, params,
    lr=...) -> (params', state'))."""
    if kind == "adamw":
        return adamw_init, adamw_update
    if kind == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {kind!r}")


def _want_state(cfg) -> Dict[str, Tuple[tuple, str]]:
    """{dotted path: (shape, dtype name)} of ``cfg.optimizer``'s state."""
    from repro_torch.models.model import model_defs

    defs = dict(tree_items(model_defs(cfg)))
    want = {"count": ((), "int32")}
    if cfg.optimizer == "adamw":
        for part in ("m", "v", "master"):
            want.update({f"{part}.{k}": (d.shape, "float32")
                         for k, d in defs.items()})
        return want
    if cfg.optimizer != "adafactor":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    for k, d in defs.items():
        want[f"master.{k}"] = (d.shape, "float32")
        if len(d.shape) >= 2:
            want[f"stats.{k}.vr"] = (d.shape[:-1], "float32")
            want[f"stats.{k}.vc"] = (d.shape[:-2] + d.shape[-1:], "float32")
        else:
            want[f"stats.{k}.v"] = (d.shape, "float32")
    return want


def opt_state_from_numpy(cfg, state: Dict[str, Any], device=None):
    """The JAX package's optimizer state for ``cfg.optimizer`` (nested
    dicts of numpy arrays, as ``jax.tree_util.tree_map(np.asarray,
    opt_init(params))`` gives) as the port's, on ``device`` (default
    ``"cuda"``; raises without a GPU).  Raises ``ValueError`` when a name,
    shape or dtype is not the state of ``model_defs(cfg)``'s parameters."""
    dev = resolve_device(device)
    want = _want_state(cfg)
    have = dict(tree_items(state))
    if set(want) != set(have):
        raise ValueError(
            f"{cfg.optimizer} state names differ: missing "
            f"{sorted(set(want) - set(have))}, unexpected "
            f"{sorted(set(have) - set(want))}")
    for name, (shape, dtype) in want.items():
        a = np.asarray(have[name])
        if tuple(a.shape) != tuple(shape) or a.dtype.name != dtype:
            raise ValueError(f"{name}: {a.shape} {a.dtype}, want {shape} "
                             f"{dtype}")
    return tree_map(lambda a: tensor_from_numpy(a, dev), state)
