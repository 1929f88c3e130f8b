"""``bakp_stream`` runs Algorithm 2 (``work/algorithm2.py``)."""
from __future__ import annotations

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "sb_work_algorithm2", Path(__file__).with_name("algorithm2.py"))
algorithm2 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(algorithm2)


def solve_work(obs: int, nvars: int, k: int, sweeps: int, itemsize: int,
               l2_bytes: int):
    """(bytes, FLOP) a solve of k right-hand sides in ``sweeps`` sweeps
    needs at least."""
    return (algorithm2.solve_bytes(obs, nvars, k, sweeps, itemsize, l2_bytes),
            algorithm2.solve_flops(obs, nvars, k, sweeps))
