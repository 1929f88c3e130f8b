#!/usr/bin/env python3
"""How accurately the block-Gram matrices of a tall design come out on the
card, by how they are computed, and what that does to a gram-mode solve.

    python3 tools/gram_accuracy.py [--obs 262144] [--vars 1024] [--thr 128]

On one CUDA device, for a Gaussian (obs, vars) fp32 design: each block's
Gram matrix from one batched product (``torch.einsum`` / ``torch.bmm`` over
the blocked view, what ``block_gram_cholesky`` did before) and from one
``mm`` a block (``core.solvebakp.block_grams``), each against the same
product in fp64 (max absolute error, largest relative error on the
diagonal).  Then the first five sweeps' SSE of ``solvebakp(mode="gram")``
(its factors from ``block_grams``, and again from the batched product), of
``solvebakp_obs_sharded`` on four virtual shards of the card, and of the
same iteration in fp64, with each one's relative distance from fp64.
Prints JSON lines, the card's name and power limit first.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import solvebakp, solvebakp_obs_sharded  # noqa: E402
from repro_torch.core.solvebakp import block_grams  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--obs", type=int, default=262_144)
    ap.add_argument("--vars", type=int, default=1_024)
    ap.add_argument("--thr", type=int, default=128)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--sweeps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gram_accuracy: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(args.obs, args.vars, generator=gen, device=dev)
    a = torch.randn(args.vars, args.k, generator=gen, device=dev)
    y = x @ a
    thr, nblocks = args.thr, args.vars // args.thr
    xb = x.reshape(args.obs, nblocks, thr)
    xd = x.double()
    g64 = torch.stack([xd[:, b * thr:(b + 1) * thr].T
                       @ xd[:, b * thr:(b + 1) * thr]
                       for b in range(nblocks)])
    for name, g in (("batched", torch.einsum("obt,obs->bts", xb, xb)),
                    ("mm_per_block", block_grams(xb))):
        d = (g.double() - g64).abs()
        diag = d.diagonal(dim1=1, dim2=2) / g64.diagonal(dim1=1, dim2=2)
        print(json.dumps({"gram": name, "max_abs_err": d.max().item(),
                          "diag_max_rel_err": diag.max().item()}))

    e = y.double()
    eye = torch.eye(thr, dtype=torch.float64, device=dev)
    chol = [torch.linalg.cholesky(g + 1e-6 * eye) for g in g64]
    h64 = []
    for _ in range(args.sweeps):
        for b in range(nblocks):
            xblk = xd[:, b * thr:(b + 1) * thr]
            e = e - xblk @ torch.cholesky_solve(xblk.T @ e, chol[b])
        h64.append(float((e * e).sum()))
    mesh = make_mesh((4,), ("data",), [dev] * 4)
    batched = torch.linalg.cholesky(
        torch.einsum("obt,obs->bts", xb, xb)
        + 1e-6 * torch.eye(thr, device=dev)[None])
    for name, res in (
            ("solvebakp", solvebakp(x, y, thr=thr, max_iter=args.sweeps,
                                    mode="gram")),
            ("solvebakp_batched_gram", solvebakp(
                x, y, thr=thr, max_iter=args.sweeps, mode="gram",
                chol=batched)),
            ("obs_sharded_4", solvebakp_obs_sharded(
                x, y, mesh, thr=thr, max_iter=args.sweeps))):
        h = res.history.tolist()
        print(json.dumps({"solver": name, "history": h,
                          "rel_to_fp64": [abs(p - q) / q
                                          for p, q in zip(h, h64)]}))
    print(json.dumps({"solver": "fp64", "history": h64,
                      "sse0": float((y.double() ** 2).sum())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
