"""Run one cell of the benchmark once, on the card.

    python solverbench/run.py --workload tall.shared --seed 7 --seconds 20 \
        --trace 0

from the root of a checkout.  The cell's configuration, traffic mix and
metrics come from ``BENCHMARK.json`` and the files it names
(``harness/spec.py``).  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
the correctness check compared, beside its limit); the same checks are
the last lines of standard error.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), when the program cannot be imported, and when
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` was loaded by
the end of the window.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = ROOT / ".solverbench_cache"
# Every build and kernel cache stays at a fixed place inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(ROOT / "src"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from harness import spec
    cell = spec.resolve_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("solverbench: no CUDA device; this benchmark measures the "
              "card and does not fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"solverbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    from harness.cell import run_cell
    out = run_cell(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda:0", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"solverbench: the process loaded {found}; the port must not "
              f"load JAX or the JAX package", file=sys.stderr)
        return 3
    for line in out.info:
        print(line)
    print(json.dumps(out.result), flush=True)
    for line in out.checks:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
