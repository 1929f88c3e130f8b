"""Least work of the paper's Algorithm 2 (block-Jacobi coordinate
descent), from its shape alone: whatever kernel implements it.

A frozen copy of the kernel bound arithmetic that ``PERF.md`` §3 states
(``bound_ms``): every input read once and every output written once, x at
its itemsize; a sweep does 4·vars·obs·k FLOP (the scores x·e and the
update x^T·da, two multiply-adds an element of x a right-hand side).

A sweep reads all of x.  A whole solve reads x once a sweep when x is
larger than the L2 cache (it cannot stay there between sweeps), else once;
the right-hand sides once, and writes the coefficients and the residual
once.
"""
from __future__ import annotations

F32 = 4


def sweep_bytes(obs: int, nvars: int, k: int, itemsize: int) -> int:
    """One sweep on its own: x; the column scales; the residual in and
    out; the coefficient step out."""
    return itemsize * nvars * obs + F32 * (nvars + 2 * k * obs + nvars * k)


def sweep_flops(obs: int, nvars: int, k: int) -> int:
    return 4 * nvars * obs * k


def solve_bytes(obs: int, nvars: int, k: int, sweeps: int, itemsize: int,
                l2_bytes: int) -> int:
    x_bytes = itemsize * nvars * obs
    x_reads = sweeps if x_bytes > l2_bytes else 1
    return x_reads * x_bytes + F32 * k * (2 * obs + nvars)


def solve_flops(obs: int, nvars: int, k: int, sweeps: int) -> int:
    return sweeps * sweep_flops(obs, nvars, k)

