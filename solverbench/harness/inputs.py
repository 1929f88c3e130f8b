"""A cell's inputs, made from ``--seed``: designs and planted right-hand
sides.

One ``torch.Generator`` on the device, seeded from the seed, draws every
design in turn.  A design's x, (obs, vars) fp32, comes from the design
module the configuration names (``designs/<name>.py``, found by
``spec.design``; ``planted_normal``, x ~ N(0, 1), where it names none):
the paper's planted system, or features a model computes from weights
and tokens it draws from the same generator.  Right after each x, a pool
of planted right-hand sides ``y = x @ a`` with ``a ~ N(0, 1)`` is drawn
in the same stream and copied to the host once: the timed window only
submits them.  The order in which clients pick from a pool is drawn from
the seed too, so every seed gives the same sizes and the same amount of
work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from harness import spec

SEED_MOD = 2 ** 64


@dataclass
class Design:
    key: str
    x: torch.Tensor          # (obs, vars) fp32 on the device
    y_pool: np.ndarray       # (pool, obs) fp32 on the host, row j = x @ a_j
    state: torch.Tensor      # the generator's state where x's draw began


def make_designs(config: dict, traffic: dict, seed: int,
                 device) -> List[Design]:
    """``traffic["designs"]`` designs of the configuration's shape, each
    with ``traffic["rhs_pool"]`` planted right-hand sides."""
    obs, nvars = int(config["obs"]), int(config["vars"])
    pool = int(traffic["rhs_pool"])
    draw = spec.design_of(config).draw
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % SEED_MOD)
    out = []
    for d in range(int(traffic["designs"])):
        state = g.get_state()
        x = draw(config, g, device)
        if (tuple(x.shape) != (obs, nvars) or x.dtype != torch.float32
                or x.device.type != torch.device(device).type):
            raise spec.SpecError(
                f"design {config.get('design', spec.DEFAULT_DESIGN)} drew "
                f"{tuple(x.shape)} {x.dtype} on {x.device}; the "
                f"configuration states ({obs}, {nvars}) fp32 on {device}")
        a = torch.randn((nvars, pool), generator=g, device=device,
                        dtype=torch.float32)
        y = (x @ a).T.contiguous().cpu().numpy()
        out.append(Design(key=f"sb{d}-{int(seed) % SEED_MOD:x}", x=x,
                          y_pool=y, state=state))
        del a
    return out


def design_checks(config: dict, designs: List[Design],
                  device) -> Dict[str, float]:
    """The numbers the configuration's design module checks, by name:
    nothing where it has no ``check``."""
    mod = spec.design_of(config)
    if not hasattr(mod, "check"):
        return {}
    got = mod.check(config, designs, device)
    if set(got) != set(mod.CHECKS):
        raise spec.SpecError(f"design check returned {sorted(got)}, its "
                             f"CHECKS name {sorted(mod.CHECKS)}")
    return {name: float(got[name]) for name in mod.CHECKS}


def client_rng(seed: int, client: int) -> np.random.Generator:
    """The stream a client draws its pool indices from."""
    return np.random.default_rng([int(seed) % SEED_MOD, client])
