"""Run the full dry-run matrix (every arch × applicable cell × mesh), one
subprocess a cell (a fresh fake process group each), and tabulate it.

    PYTHONPATH=src python -m repro_torch.launch.sweep --out results/dryrun \\
        [--archs a,b] [--cells c1,c2] [--meshes pod,multipod] [-j 2]

The counterpart of the JAX package's ``launch/sweep.py``.  Each cell runs
``python -m repro_torch.launch.dryrun`` from the repository root (found
from this file) and writes ``<arch>__<cell>_{sp,mp}.json`` under
``--out``; a cell whose JSON is there already is not run again, and a
failed one leaves its output's tail in a ``.err`` file beside it.  At the
end it prints the matrix as a markdown table (``table``).  No device is
touched.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def run_one(arch, cell, multi_pod, outdir):
    out = os.path.join(outdir,
                       f"{arch}__{cell}{'_mp' if multi_pod else '_sp'}.json")
    if os.path.exists(out):
        return arch, cell, multi_pod, "cached", 0.0
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--cell", cell, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    t0 = time.time()
    p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=REPO)
    dt = time.time() - t0
    if p.returncode != 0:
        err_path = out.replace(".json", ".err")
        with open(err_path, "w") as f:
            f.write(p.stdout[-4000:] + "\n---\n" + p.stderr[-8000:])
        return arch, cell, multi_pod, f"FAIL({err_path})", dt
    return arch, cell, multi_pod, "ok", dt


def table(outdir, jobs) -> str:
    """A markdown table of ``jobs`` ((arch, cell, multi_pod)) from their
    JSON under ``outdir``: a row an arch, a column a cell and mesh, each
    entry per-device argument / peak GB, the roofline's bottleneck (c
    compute, m memory, x collective), the useful-flops ratio, and the
    fallbacks it ran through (``launch.dryrun``): ``rN`` ops DTensor could
    not shard, ``vN`` views that gathered, ``wN`` writes into such a view;
    then a line counting the clean cells (none of the three) and those
    run through a fallback, and a line per failed cell with its error's
    last line (from its ``.err``)."""
    cols = sorted({(c, mp) for _, c, mp in jobs},
                  key=lambda k: (list(SHAPE_ORDER).index(k[0]), k[1]))
    archs = list(dict.fromkeys(a for a, _, _ in jobs))
    head = ["arch"] + [f"{c} {'mp' if mp else 'sp'}" for c, mp in cols]
    rows = ["| " + " | ".join(head) + " |", "|---" * len(head) + "|"]
    failed, clean, through = [], 0, 0
    for arch in archs:
        cells = [arch]
        for cell, mp in cols:
            base = os.path.join(outdir,
                                f"{arch}__{cell}_{'mp' if mp else 'sp'}")
            if (arch, cell, mp) not in jobs:
                cells.append("")
            elif os.path.exists(base + ".json"):
                with open(base + ".json") as f:
                    r = json.load(f)
                mem, t = r["memory_analysis"], r["roofline"]
                marks = "".join(
                    f" {tag}{n}" for tag, n in (
                        (tag, sum(r[key].values())) for tag, key in (
                            ("r", "replicated_ops"), ("v", "gathered_views"),
                            ("w", "gathered_view_writes"))) if n)
                clean += not marks
                through += bool(marks)
                cells.append(
                    f"{mem['argument_bytes'] / 1e9:.2f} / "
                    f"{mem['peak_bytes_per_device'] / 1e9:.1f} "
                    f"{'cmx'[('compute_s', 'memory_s', 'collective_s').index(t['bottleneck'])]}"
                    f" {100 * r['useful_flops_ratio']:.1f}%" + marks)
            else:
                cells.append("failed")
                err = "not run"
                if os.path.exists(base + ".err"):
                    lines = [ln for ln in open(base + ".err").read()
                             .splitlines() if "Error" in ln]
                    err = (lines[-1] if lines else "failed")[-200:]
                failed.append(f"- {arch} {cell} {'mp' if mp else 'sp'}: "
                              f"{err}")
        rows.append("| " + " | ".join(cells) + " |")
    summary = (f"{clean} clean, {through} through a fallback, "
               f"{len(failed)} failed")
    return "\n".join(rows + [summary] + failed)


def main(argv=None):
    from repro_torch.configs.registry import all_cells

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--archs", default=None)
    ap.add_argument("--cells", default=None)
    ap.add_argument("--meshes", default="pod,multipod")
    ap.add_argument("-j", type=int, default=2)
    args = ap.parse_args(argv)
    # The cells run from the repository root: a relative --out is the
    # caller's, so make it absolute before anything reads or passes it.
    args.out = os.path.abspath(args.out)

    os.makedirs(args.out, exist_ok=True)
    wanted_archs = set(args.archs.split(",")) if args.archs else None
    wanted_cells = set(args.cells.split(",")) if args.cells else None
    meshes = [m == "multipod" for m in args.meshes.split(",")]

    jobs = []
    for arch, cell in all_cells():
        if wanted_archs and arch not in wanted_archs:
            continue
        if wanted_cells and cell.name not in wanted_cells:
            continue
        for mp in meshes:
            jobs.append((arch, cell.name, mp))

    print(f"{len(jobs)} dry-run cells -> {args.out}", flush=True)
    results = []
    with cf.ThreadPoolExecutor(max_workers=args.j) as ex:
        futs = [ex.submit(run_one, a, c, m, args.out) for a, c, m in jobs]
        for f in cf.as_completed(futs):
            a, c, m, status, dt = f.result()
            print(f"[{len(results)+1}/{len(jobs)}] {a:24s} {c:12s} "
                  f"{'mp' if m else 'sp'}  {status:8s} {dt:6.0f}s",
                  flush=True)
            results.append((a, c, m, status))
    bad = [r for r in results if r[3].startswith("FAIL")]
    print(f"done: {len(results) - len(bad)} ok, {len(bad)} failed")
    for r in bad:
        print("  FAILED:", r)
    print(table(args.out, jobs))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
