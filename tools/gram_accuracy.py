#!/usr/bin/env python3
"""How accurately the block-Gram matrices and the column norms of a tall
design come out on the card, by how they are computed, and what that does
to a gram-mode solve.

    python3 tools/gram_accuracy.py [--obs 262144] [--vars 1024] [--thr 128]
    python3 tools/gram_accuracy.py --obs 16384 --vars 4096
    python3 tools/gram_accuracy.py --design probe

On one CUDA device, for a Gaussian (obs, vars) fp32 design, or with
``--design probe`` for ``chip_smoke.py`` phase 8c's linear-probe features
(qwen3-8b at full width, random bf16 weights from seed 0, 4 x 4,096
tokens from seed 9: a 16,384 x 4,096 fp32 matrix): each block's Gram
matrix from one batched product (``torch.einsum`` / ``torch.bmm`` over the
blocked view, what ``block_gram_cholesky`` did before) and from one
``mm`` a block (``core.solvebakp.block_grams``), each against the same
product in fp64 (max absolute error, largest relative error on the
diagonal).  Then the squared column norms every ``inv_cn`` comes from,
``core.types.column_norms_sq`` / ``column_norms_sq_t`` and the batched
solvers' form (``einsum``s, lowered to a batched product, ``aten::bmm``),
beside the diagonal of one ``mm`` a block and a plain ``(x * x).sum`` on
each layout, each's largest relative error against fp64.  Then
the first five sweeps' SSE of ``solvebakp(mode="gram")`` (its factors from
``block_grams``, and again from the batched product), of
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
from repro_torch.core.types import (column_norms_sq,  # noqa: E402
                                    column_norms_sq_t)
from repro_torch.launch.mesh import make_mesh  # noqa: E402


def probe_design(dev) -> torch.Tensor:
    """``chip_smoke.py`` phase 8c's feature matrix (the same seeds)."""
    from repro_torch.configs.registry import get
    from repro_torch.models.model import (init_model, make_smoke_batch,
                                          probe_features)
    cfg = get("qwen3-8b")
    params = init_model(cfg, seed=0, device=dev)
    toks = make_smoke_batch(cfg, seed=9, batch=4, seq=4096,
                            device=dev)["tokens"]
    with torch.no_grad():
        feats = probe_features(cfg, params, toks)
    del params
    torch.cuda.empty_cache()
    return feats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--obs", type=int, default=262_144)
    ap.add_argument("--vars", type=int, default=1_024)
    ap.add_argument("--thr", type=int, default=128)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--sweeps", type=int, default=5)
    ap.add_argument("--design", choices=("gaussian", "probe"),
                    default="gaussian")
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
    if args.design == "probe":
        x = probe_design(dev)
        args.obs, args.vars = x.shape
    else:
        x = torch.randn(args.obs, args.vars, generator=gen, device=dev)
    print(json.dumps({"design": args.design, "shape": list(x.shape)}))
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
    n64 = (xd * xd).sum(0)
    xt = x.T.contiguous()
    for name, n in (
            ("column_norms_sq", column_norms_sq(x)),
            ("column_norms_sq_t", column_norms_sq_t(xt)),
            ("einsum_bov_bov_bv", torch.einsum("bov,bov->bv", x[None],
                                               x[None])[0]),
            ("mm_per_block_diag", block_grams(xb).diagonal(
                dim1=1, dim2=2).reshape(-1)),
            ("sum_of_squares", (x * x).sum(0)),
            ("sum_of_squares_t", (xt * xt).sum(1))):
        print(json.dumps({"norms": name, "max_rel_err": (
            (n.double() - n64).abs() / n64).max().item()}))
    del xt

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
