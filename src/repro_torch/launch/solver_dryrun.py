"""Dry run of the paper's own workload at pod scale: the port's sharded
SolveBakP on the production mesh, on shards that hold shapes and no data.

    PYTHONPATH=src python -m repro_torch.launch.solver_dryrun \\
        --obs 16777216 --vars 16384 --thr 512 --mode gram [--multi-pod] \\
        [--sharding obs|2d] [--dtype bfloat16] --out results/solver.json

The counterpart of the JAX package's ``launch/solver_dryrun.py``, with its
flags and defaults: a 16M × 16k bf16 system (512 GiB, 2 GiB a chip on one
pod).  The mesh is ``make_production_mesh`` over ``meta`` devices (one
virtual shard a chip); ``solvebakp_obs_sharded`` / ``solvebakp_2d`` run
their own per-shard body on it, for a fixed ``--sweeps`` (``host_stop=
False``: a ``meta`` shard has no stop flag to read; JAX's while loop is
sized by its trip count the same way), under ``launch.cost_analysis``'s
``CostModel`` and a ``CollectiveRecorder``.  Nothing is allocated and no
device is touched (``"device": "meta"``).

One controller runs every shard's ops, so the counts are totals over the
mesh: per-chip numbers are those over the chips (each shard's work is the
same but for the values a group computes once, on its first member, and
copies: the block factors and each ``da``, which JAX computes on every
member).  A group sum counts its bytes once for each member.  The shards
run one after another, so ``temp_bytes`` is the run's high-water mark of
live bytes: one shard's transients (a gram solve widens its x shard to
fp32 once) plus every shard's persistent state, an upper bound for one
chip.  Roofline terms use ``launch.dryrun``'s H100 constants and are
derived numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def run(obs: int = 16_777_216, nvars: int = 16_384, thr: int = 512,
        sweeps: int = 8, mode: str = "gram", sharding: str = "obs",
        dtype: str = "bfloat16", multi_pod: bool = False,
        mesh=None) -> dict:
    """The dry run on the production mesh (or on ``mesh``, a port ``Mesh``
    of ``meta`` devices)."""
    import torch

    from repro_torch.core.distributed import (CollectiveRecorder,
                                              shard_x, solvebakp_2d,
                                              solvebakp_obs_sharded)
    from repro_torch.distributed.sharding import data_axes as _data_axes
    from repro_torch.launch.cost_analysis import CostModel
    from repro_torch.launch.dryrun import (HBM_BW, IB_BW, NODE_GPUS,
                                           NVLINK_BW, PEAK_FLOPS, link_bw)
    from repro_torch.launch.mesh import make_production_mesh

    if mesh is None:
        mesh = make_production_mesh(
            multi_pod=multi_pod, devices=["meta"] * (512 if multi_pod
                                                     else 256))
    shape, names = tuple(mesh.shape.values()), tuple(mesh.axis_names)
    daxes = _data_axes(mesh)
    chips = mesh.devices.size
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    x = torch.empty((obs, nvars), dtype=dt, device="meta")
    y = torch.empty((obs,), dtype=torch.float32, device="meta")
    if sharding == "obs":
        kw = dict(data_axes=daxes + ("model",))
        xs = shard_x(x, mesh, "obs", **kw)
        solve = solvebakp_obs_sharded
    else:
        kw = dict(data_axes=daxes, model_axis="model", omega=0.5)
        xs = shard_x(x, mesh, "2d", data_axes=daxes, model_axis="model")
        solve = solvebakp_2d
    rec = CollectiveRecorder()
    cm = CostModel(recorder=rec)
    cm.track([xs.parts, y])
    t0 = time.perf_counter()
    with cm, rec:
        solve(xs, y, mesh, thr=thr, max_iter=sweeps, mode=mode,
              host_stop=False, **kw)
    t_run = time.perf_counter() - t0
    cm.add_recorded(chips)
    cost = cm.summary()

    per = 1.0 / sweeps / chips           # a sweep, a chip
    coll = {k: v / sweeps for k, v in cost["collectives"].items()
            if k not in ("count", "total")}
    coll_axis = {a: v / sweeps for a, v in cost["collectives_by_axis"].items()}
    per_sweep = {
        "compute_s": cost["flops"] * per / PEAK_FLOPS,
        "memory_s": cost["hbm_bytes"] * per / HBM_BW,
        "collective_s": sum(b / link_bw(shape, ax, names)
                            for ax, b in coll_axis.items()),
    }
    per_sweep["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                                  key=lambda k: per_sweep[k])
    bytes_ideal = obs * nvars * x.element_size()
    flops_ideal = 4.0 * obs * nvars
    ideal = {"memory_s_per_chip": bytes_ideal / chips / HBM_BW,
             "compute_s_per_chip": flops_ideal / chips / PEAK_FLOPS}
    return {
        "workload": {"obs": obs, "vars": nvars, "thr": thr, "mode": mode,
                     "sharding": sharding, "dtype": dtype, "sweeps": sweeps},
        "mesh": "x".join(str(s) for s in shape), "chips": chips,
        "device": "meta", "run_s": t_run,
        "memory_analysis": {
            "argument_bytes": cost["argument_bytes"] // chips,
            "shard_x_bytes": xs.nbytes // chips,
            "temp_bytes": cost["peak_live_bytes"],
            "peak_bytes_per_device": (cost["argument_bytes"] // chips
                                      + cost["peak_live_bytes"]),
        },
        "per_sweep": per_sweep,
        "per_sweep_per_chip": {"flops": cost["flops"] * per,
                               "hbm_bytes": cost["hbm_bytes"] * per},
        "collectives": coll,
        "collectives_by_axis": coll_axis,
        "collective_records": len(rec.records),
        "ideal_per_sweep": ideal,
        "roofline_fraction": ideal["memory_s_per_chip"] / max(
            per_sweep["memory_s"], per_sweep["compute_s"],
            per_sweep["collective_s"]),
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "nvlink_bw": NVLINK_BW, "ib_bw": IB_BW,
                      "node_gpus": NODE_GPUS},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--obs", type=int, default=16_777_216)
    ap.add_argument("--vars", type=int, default=16_384)
    ap.add_argument("--thr", type=int, default=512)
    ap.add_argument("--sweeps", type=int, default=8)
    ap.add_argument("--mode", default="gram", choices=["gram", "jacobi"])
    ap.add_argument("--sharding", default="obs", choices=["obs", "2d"])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args.obs, args.vars, args.thr, args.sweeps, args.mode,
              args.sharding, args.dtype, args.multi_pod)
    js = json.dumps(res, indent=1)
    print(js)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(js)


if __name__ == "__main__":
    main()
