"""Dry run of an (arch × shape cell) on a production mesh: the port's own
step on stand-in state, with its per-device roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --cell train_4k --multi-pod --out results/qwen3_train_mp.json

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles the step for 256 / 512 forced host devices.  Torch has no such
lowering: this runs the port's step itself (``launch.steps``) on
DTensors over a fake process group of 256 (single pod, (16, 16) ``data,
model``) or 512 ranks (multi-pod, (2, 16, 16) ``pod, data, model``),
each DTensor's local shard a ``meta`` tensor of the per-device shape
under the sharding rules.  Nothing is allocated and no device is
touched (the JSON says ``"device": "meta"``); the proof of coherence is
that the step runs at the cell's full shapes under the rules.  The fake
process group lasts for the life of the process, so a dry run is a
process of its own (``launch/sweep.py`` runs one a cell).

The step's ops are counted below DTensor, on one rank's shards, by
``launch.cost_analysis.CostModel``: per-device FLOPs, HBM bytes,
collective bytes by kind and mesh axis, and the high-water mark of live
bytes.  ``argument_bytes`` is the sum of the arguments' local shard bytes
(parameters, optimizer state, batch, cache); the port's decode writes its
cache in place and its train step updates parameters and state in place,
the counterparts of JAX's donated buffers.  ``flop_counter_global`` is
``torch.utils.flop_counter.FlopCounterMode``'s total over the same run:
it sees the DTensor ops, so it counts the global (unsharded) products,
matrix products only: the counterpart of XLA's raw cost analysis, kept for
reference.

The roofline terms use one H100 SXM's published rates (constants below)
and are derived numbers, not measurements.  Outputs JSON: memory
analysis, cost, collectives, roofline terms, MODEL_FLOPS and the
useful-flops ratio.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Dict, Optional, Sequence, Tuple

# H100 SXM constants.  PEAK_FLOPS and HBM_BW: NVIDIA's H100 data sheet (SXM,
# dense bf16 without sparsity; HBM3), as PERF.md §3.
PEAK_FLOPS = 989e12        # bf16 FLOP/s per GPU
HBM_BW = 3.35e12           # B/s per GPU
HBM_BYTES = 80e9           # H100 80GB HBM3
# NVLink 4 (H100 SXM data sheet: 900 GB/s bidirectional): 450 GB/s a
# direction per GPU, within a node of NODE_GPUS.
NVLINK_BW = 450e9
NODE_GPUS = 8
# InfiniBand NDR between nodes: 400 Gb/s = 50 GB/s per GPU (DGX H100: one
# ConnectX-7 adapter per GPU).
IB_BW = 50e9


def mesh_layout(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production mesh's shape and axis names
    (``launch.mesh.make_production_mesh``)."""
    from repro_torch.launch.mesh import make_production_mesh
    m = make_production_mesh(multi_pod=multi_pod,
                             devices=["meta"] * (512 if multi_pod else 256))
    return tuple(m.shape.values()), tuple(m.axis_names)


def _views_gather_where_uneven() -> None:
    """Let ``view`` and ``_unsafe_view`` redistribute as ``reshape`` does.

    DTensor refuses a view that splits a sharded dim into dims the shards
    do not divide: qwen3-8b's K (B, S, 8·128) split over a model axis of 16
    into (B, S, 8, 128).  GSPMD splits inside the heads (half a head a
    device, psums over hd); a DTensor placement cannot express that, so
    the dry run registers the two view ops with DTensor's non-strict view
    rule: the input is gathered over that axis, and the ops after it run
    replicated over it.  That is what DTensor does with JAX's rules, and
    the dry run reports it as it is (collectives and per-device FLOPs);
    a write into such a view would reach the gathered copy, not the
    shards.  The cost model counts each view that gathered
    (``gathered_views`` in the JSON) and each in-place op on one
    (``gathered_view_writes``): a cell with either, or with
    ``replicated_ops``, ran through a fallback a real mesh would not take.
    Process-wide: the dry run is a process of its own."""
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops._view_ops import \
        register_op_strategy_map
    import torch
    for op in (torch.ops.aten.view.default,
               torch.ops.aten._unsafe_view.default):
        register_op_strategy_map(op, torch.Tensor.view,
                                 schema_info=RuntimeSchemaInfo(1))


def fake_device_mesh(shape: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` over a fake process group (backend
    ``"fake"``: collectives return without moving data) whose world is
    the mesh's size; the group is made once a process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(shape)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        _views_gather_where_uneven()
    elif dist.get_world_size() != world:
        raise RuntimeError(f"this process's fake group has "
                           f"{dist.get_world_size()} ranks, the mesh "
                           f"needs {world}")
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=tuple(names))


def link_bw(shape: Sequence[int], axes_of_groups: str,
            names: Sequence[str]) -> float:
    """The slowest link a collective over ``axes_of_groups`` (comma-joined
    mesh axes) crosses: NVLink when each group lies within one node of
    ``NODE_GPUS`` ranks (mesh order, the last axis fastest), else
    InfiniBand."""
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    ranks = [0]
    for a in axes_of_groups.split(","):
        if a not in names:
            return IB_BW
        i = names.index(a)
        ranks = [r + k * strides[i] for r in ranks for k in range(shape[i])]
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) == 1 else IB_BW


def roofline(flops: float, hbm_bytes: float, coll_by_axis: Dict[str, float],
             shape, names) -> Dict:
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": hbm_bytes / HBM_BW,
             "collective_s": sum(b / link_bw(shape, ax, names)
                                 for ax, b in coll_by_axis.items())}
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                              key=lambda k: terms[k])
    return terms


def local_storages(tree) -> Dict[int, int]:
    """Storage → bytes of a tree's tensors (a DTensor's local shard), each
    storage once."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.cost_analysis import _tensors
    out = {}
    for t in _tensors(tree):
        loc = t._local_tensor if isinstance(t, DTensor) else t
        out[loc.untyped_storage()._cdata] = loc.untyped_storage().nbytes()
    return out


def count_step(fn, args, mesh=None):
    """Run ``fn(*args)`` under the cost model (and ``FlopCounterMode``):
    (its output, the ``CostModel``, the FlopCounterMode total)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.cost_analysis import (CostModel,
                                                  axis_names_by_group)
    cm = CostModel(axis_names_by_group(mesh) if mesh is not None else None)
    cm.track(args)
    fc = FlopCounterMode(display=False)
    with implicit_replication(), cm, fc:
        out = fn(*args)
    return out, cm, fc.get_total_flops()


def run_cell(arch, cell, *, multi_pod: bool = False,
             overrides: Optional[Dict] = None, fsdp: bool = True,
             serve_rules: bool = False,
             mesh_shape: Optional[Sequence[int]] = None) -> Dict:
    """The dry run of ``arch`` (a registry name or a ``ModelConfig``) at
    ``cell`` (a ``SHAPE_CELLS`` name or a ``ShapeCell``) on the production
    mesh, or on ``mesh_shape`` (axes ``data, model`` / ``pod, data,
    model``) where given."""
    from repro_torch.configs.base import SHAPE_CELLS
    from repro_torch.configs.registry import get
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.steps import abstract_cell_args

    cfg = get(arch) if isinstance(arch, str) else arch
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPE_CELLS[cell] if isinstance(cell, str) else cell
    if mesh_shape is None:
        shape, names = mesh_layout(multi_pod)
    else:
        shape = tuple(mesh_shape)
        names = ("data", "model") if len(shape) == 2 else (
            "pod", "data", "model")
    chips = math.prod(shape)
    mesh = fake_device_mesh(shape, names)
    rules = make_rules(mesh, fsdp=fsdp, serve=serve_rules)

    t0 = time.perf_counter()
    fn, args = abstract_cell_args(cfg, cell, mesh, rules)
    t_build = time.perf_counter() - t0
    arg = local_storages(args)
    arg_bytes = sum(arg.values())
    t0 = time.perf_counter()
    out, cm, fc_total = count_step(fn, args, mesh)
    t_run = time.perf_counter() - t0
    out_bytes = sum(v for k, v in local_storages(out).items()
                    if k not in arg)

    cost = cm.summary()
    flops, hbm = cost["flops"], cost["hbm_bytes"]
    terms = roofline(flops, hbm, cost["collectives_by_axis"], shape, names)
    n_active = cfg.n_active_params()
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    model_flops = (6.0 if cell.kind == "train" else 2.0) * n_active * tokens
    model_flops_per_chip = model_flops / chips
    peak = arg_bytes + cost["peak_live_bytes"]
    return {
        "arch": cfg.name, "cell": cell.name,
        "mesh": "x".join(str(s) for s in shape), "chips": chips,
        "device": "meta",
        "build_s": t_build, "run_s": t_run,
        "memory_analysis": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": cost["peak_live_bytes"],
            "peak_bytes_per_device": peak,
            "fits_80gb": peak < HBM_BYTES,
        },
        "hlo_cost": {"flops_per_device": flops,
                     "hbm_bytes_per_device": hbm, "ops": cost["ops"]},
        "flop_counter_global": float(fc_total),
        "collectives": cost["collectives"],
        "replicated_ops": cost["replicated_ops"],
        "gathered_views": cost["gathered_views"],
        "gathered_view_writes": cost["gathered_view_writes"],
        "collectives_by_axis": cost["collectives_by_axis"],
        "roofline": terms,
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "nvlink_bw": NVLINK_BW, "ib_bw": IB_BW,
                      "node_gpus": NODE_GPUS, "hbm_bytes": HBM_BYTES},
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flops_ratio": (model_flops_per_chip / flops) if flops
        else 0.0,
        "params_total": cfg.n_params(),
        "params_active": n_active,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True,
                    choices=["train_4k", "prefill_32k", "decode_32k",
                             "long_500k"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--serve-rules", action="store_true",
                    help="weight-stationary sharding (serving)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides")
    args = ap.parse_args(argv)

    overrides = json.loads(args.override) if args.override else None
    res = run_cell(args.arch, args.cell, multi_pod=args.multi_pod,
                   overrides=overrides, fsdp=not args.no_fsdp,
                   serve_rules=args.serve_rules)
    js = json.dumps(res, indent=1)
    print(js)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(js)


if __name__ == "__main__":
    main()
