"""A cell's inputs, made from ``--seed``: designs and planted right-hand
sides.

Each design is ``x ~ N(0, 1)``, (obs, vars) fp32, drawn on the device by a
``torch.Generator`` seeded from the seed.  Beside it, a pool of planted
right-hand sides ``y = x @ a`` with ``a ~ N(0, 1)``, drawn in the same
stream and copied to the host once: the timed window only submits them.
The order in which clients pick from a pool is drawn from the seed too,
so every seed gives the same sizes and the same amount of work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

SEED_MOD = 2 ** 64


@dataclass
class Design:
    key: str
    x: torch.Tensor          # (obs, vars) fp32 on the device
    y_pool: np.ndarray       # (pool, obs) fp32 on the host, row j = x @ a_j


def make_designs(config: dict, traffic: dict, seed: int,
                 device) -> List[Design]:
    """``traffic["designs"]`` designs of the configuration's shape, each
    with ``traffic["rhs_pool"]`` planted right-hand sides."""
    obs, nvars = int(config["obs"]), int(config["vars"])
    pool = int(traffic["rhs_pool"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % SEED_MOD)
    out = []
    for d in range(int(traffic["designs"])):
        x = torch.randn((obs, nvars), generator=g, device=device,
                        dtype=torch.float32)
        a = torch.randn((nvars, pool), generator=g, device=device,
                        dtype=torch.float32)
        y = (x @ a).T.contiguous().cpu().numpy()
        out.append(Design(key=f"sb{d}-{int(seed) % SEED_MOD:x}", x=x,
                          y_pool=y))
        del a
    return out


def client_rng(seed: int, client: int) -> np.random.Generator:
    """The stream a client draws its pool indices from."""
    return np.random.default_rng([int(seed) % SEED_MOD, client])
