#!/usr/bin/env python3
"""Time the two streamed-obs kernels of one or more trees on one GPU.

    mkdir -p old && git archive <parent> src | tar -x -C old
    python3 tools/streamed_obs_bench.py --src old/src src src old/src

For each ``--src`` (a tree's ``src`` directory, the port's package under
it), in the order given, a fresh process builds that tree's
``score_features`` and ``block_update`` libraries and times each kernel's
wrapper at ``chip_smoke.py``'s phase-2 shapes: the scores of a 1,024 x
262,144 design against one residual, and the correction of k 8 residuals
by a 256-row block of it.  x is fp32 and, where the tree's wrapper takes
it, bf16 (``null`` where it raises ``TypeError``).  Each time is CUDA
events over ``--iters`` launches after two warm-ups; inputs come from a
fixed seed, the same in every process.  Give the trees in turns (parent,
change, change, parent) to compare them within one call.  Prints one JSON
line a tree, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

OBS, VARS, BLOCK, K = 262_144, 1_024, 256, 8


def child(iters: int) -> dict:
    import torch

    from repro_torch.kernels.block_update import (_block_update_cuda,
                                                  _score_features_cuda)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x_t = torch.randn(VARS, OBS, generator=gen, device=dev)
    e = torch.randn(OBS, generator=gen, device=dev)
    e8 = torch.randn(K, OBS, generator=gen, device=dev)
    da = torch.randn(BLOCK, K, generator=gen, device=dev)
    inv = 1.0 / (x_t * x_t).sum(1)

    def cuda_ms(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    row = {}
    for tag, x in (("fp32", x_t), ("bf16", x_t.to(torch.bfloat16))):
        blk = x[:BLOCK]
        for name, fn in (
                ("score_features", lambda: _score_features_cuda(x, e, inv)),
                ("block_update", lambda: _block_update_cuda(blk, e8, da))):
            try:
                row[f"{name}_{tag}_ms"] = cuda_ms(fn)
            except TypeError:
                row[f"{name}_{tag}_ms"] = None
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, nargs="+", required=True)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.iters)), flush=True)
        return 0
    for src in args.src:
        env = {**os.environ, "PYTHONPATH": str(src.resolve())}
        out = subprocess.run(
            [sys.executable, __file__, "--child", "--src", str(src),
             "--iters", str(args.iters)],
            env=env, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        print(json.dumps({"src": str(src),
                          **json.loads(out.stdout.splitlines()[-1])}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
