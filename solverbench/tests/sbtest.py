"""Shared by the benchmark's CPU tests: the import path, and a cell of the
benchmark cut to a size the CPU runs in seconds."""
import dataclasses
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT / "src"), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402


def tiny_cell(name="tall.shared", obs=6000, nvars=100, designs=2, clients=4):
    """``name`` as BENCHMARK.json has it, at (obs, nvars) with few clients,
    its configuration's correctness limit unchanged."""
    cell = spec.resolve_cell(name)
    cfg = dict(cell.config, obs=obs, vars=nvars)
    tr = dict(cell.traffic, designs=designs, clients_per_design=clients,
              rhs_pool=16, warmup_rounds=1)
    return dataclasses.replace(cell, config=cfg, traffic=tr)


def run_tiny(cell, *, seed=5, seconds=0.6, trace=False, precision=None):
    from harness.cell import run_cell
    return run_cell(cell, seed=seed, seconds=seconds, trace=trace,
                    device="cpu", t_start=time.perf_counter(),
                    precision=precision)
