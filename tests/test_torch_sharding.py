"""The port's sharding rules and abstract state
(``repro_torch.distributed.sharding``, ``models.params`` / ``kvcache`` /
``model``, ``launch.steps``) against the JAX package's, on both
production meshes.

One subprocess forces 512 host devices and runs JAX's ``make_rules`` (the
four ``fsdp`` / ``serve`` combinations) and ``abstract_cell_args`` for
every ``all_cells()`` entry on ``make_production_mesh`` (16, 16) and
(2, 16, 16): each leaf's spec and ``sharding.shard_shape``.  Another runs
the port's on DTensors over a fake process group of 512 ranks (its local
shards ``meta`` tensors).  Each cell × mesh is a test: the same leaves
(parameters by ``spec_for``, optimizer state by ``abstract_opt_state``,
inputs by ``input_specs``, caches by ``cache_shardings``' rules), the same
specs, the same per-device shapes, and the same per-device argument bytes.
JAX's train step is a replicated int32 scalar (4 bytes a device); the
port's is a host int (its schedule runs on the host), so that leaf alone
is left out of the port's side.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs.registry import all_cells
from repro_torch.distributed.sharding import (P, batch_spec, data_axes,
                                              divisible_spec, make_rules,
                                              placements, shard_shape)
from repro_torch.launch.mesh import make_production_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMMON = textwrap.dedent("""
    import json, sys
    import numpy as np

    def spec_json(spec):
        return [None if a is None else (a if isinstance(a, str) else list(a))
                for a in spec]

    def names_of(kind):
        return {"train": ["params", "opt", "batch", "step"],
                "prefill": ["params", "batch", "cache"],
                "decode": ["params", "tokens", "cache"]}[kind]
""")

JAX_SCRIPT = _COMMON + textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from repro.configs.registry import all_cells, get
    from repro.distributed.sharding import make_rules
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import abstract_cell_args

    def leaves(tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            yield ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path), leaf

    res = {}
    for mp in (False, True):
        tag = "mp" if mp else "sp"
        mesh = make_production_mesh(multi_pod=mp)
        res["rules|" + tag] = {
            f"{f}{s}": {k: v if v is None or isinstance(v, str) else list(v)
                        for k, v in make_rules(mesh, fsdp=f,
                                               serve=s).items()}
            for f in (True, False) for s in (True, False)}
        for arch, cell in all_cells():
            _, args = abstract_cell_args(get(arch), cell, mesh,
                                         make_rules(mesh))
            out, total = {}, 0
            for n, a in zip(names_of(cell.kind), args):
                for k, l in leaves(a):
                    ss = l.sharding.shard_shape(l.shape)
                    total += int(np.prod(ss)) * np.dtype(l.dtype).itemsize
                    out[f"{n}.{k}".rstrip(".")] = [
                        list(l.shape), str(np.dtype(l.dtype)),
                        spec_json(l.sharding.spec), list(ss)]
            res[f"{arch}|{cell.name}|{tag}"] = {"leaves": out,
                                                "bytes": total}
    json.dump(res, open(sys.argv[1], "w"))
""")

PORT_SCRIPT = _COMMON + textwrap.dedent("""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.registry import all_cells, get
    from repro_torch.distributed.sharding import make_rules, spec_of
    from repro_torch.launch.dryrun import fake_device_mesh
    from repro_torch.launch.steps import abstract_cell_args
    from repro_torch.models.params import tree_items

    mp_mesh = fake_device_mesh((2, 16, 16), ("pod", "data", "model"))
    sp_mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                         mesh_dim_names=("data", "model"))

    def leaves(tree):
        if isinstance(tree, dict):
            yield from tree_items(tree)
        elif isinstance(tree, torch.Tensor):
            yield "", tree

    res = {}
    for tag, mesh in (("sp", sp_mesh), ("mp", mp_mesh)):
        res["rules|" + tag] = {
            f"{f}{s}": {k: v if v is None or isinstance(v, str) else list(v)
                        for k, v in make_rules(mesh, fsdp=f,
                                               serve=s).items()}
            for f in (True, False) for s in (True, False)}
        for arch, cell in all_cells():
            _, args = abstract_cell_args(get(arch), cell, mesh,
                                         make_rules(mesh))
            out, total = {}, 0
            for n, a in zip(names_of(cell.kind), args):
                for k, l in leaves(a):
                    loc = l._local_tensor
                    assert loc.device.type == "meta" and isinstance(
                        l, DTensor)
                    total += loc.numel() * loc.element_size()
                    out[f"{n}.{k}".rstrip(".")] = [
                        list(l.shape), str(l.dtype).replace("torch.", ""),
                        spec_json(spec_of(l)), list(loc.shape)]
            res[f"{arch}|{cell.name}|{tag}"] = {"leaves": out,
                                                "bytes": total}
    json.dump(res, open(sys.argv[1], "w"))
""")


def _run(script, path, extra_env):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               **extra_env)
    p = subprocess.run([sys.executable, "-c", script, path], env=env,
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    return (_run(JAX_SCRIPT, str(d / "jax.json"), {"JAX_PLATFORMS": "cpu"}),
            _run(PORT_SCRIPT, str(d / "port.json"), {}))


def _norm(spec):
    """A spec with 1-axis tuples as their axis (the same sharding)."""
    return [a[0] if isinstance(a, list) and len(a) == 1 else a for a in spec]


CELLS = [(a, c.name, m) for a, c in all_cells() for m in ("sp", "mp")]


def test_all_cells_listed():
    assert len(all_cells()) == 33


@pytest.mark.parametrize("arch,cell,mesh", CELLS,
                         ids=[f"{a}-{c}-{m}" for a, c, m in CELLS])
def test_cell_specs_shapes_and_bytes(both, arch, cell, mesh):
    jax_res, port_res = both
    j = jax_res[f"{arch}|{cell}|{mesh}"]
    t = port_res[f"{arch}|{cell}|{mesh}"]
    step = j["leaves"].pop("step", None)
    assert set(t["leaves"]) == set(j["leaves"])
    for name, (shape, dtype, spec, local) in j["leaves"].items():
        tshape, tdtype, tspec, tlocal = t["leaves"][name]
        assert tshape == shape and tdtype == dtype, name
        assert _norm(tspec) == _norm(spec), (name, tspec, spec)
        assert tlocal == local, (name, tlocal, local)
    step_bytes = 0 if step is None else 4
    assert step is None or (step[0] == [] and step[3] == [])
    assert t["bytes"] + step_bytes == j["bytes"]


@pytest.mark.parametrize("mesh", ["sp", "mp"])
def test_rules_equal(both, mesh):
    jax_res, port_res = both
    assert port_res[f"rules|{mesh}"] == jax_res[f"rules|{mesh}"]


def test_qwen3_argument_bytes_pinned(both):
    """The per-device byte totals chip_smoke.py phase 13a holds the dry run
    to (JAX's, step included)."""
    jax_res, _ = both
    want = {"train_4k|sp": 452_810_760, "prefill_32k|sp": 668_854_280,
            "decode_32k|sp": 2_480_531_520, "train_4k|mp": 228_562_952,
            "prefill_32k|mp": 334_735_364, "decode_32k|mp": 1_240_573_984}
    assert {k: jax_res[f"qwen3-8b|{k}"]["bytes"] for k in want} == want


def test_spec_helpers():
    mesh = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert data_axes(mesh) == ("pod", "data")
    assert batch_spec(mesh, 3) == P(("pod", "data"), None, None)
    assert divisible_spec(mesh, (1, 4096), [("pod", "data"), "model"]) == \
        P(None, "model")
    assert divisible_spec(mesh, (64, 100), [("pod", "data"), "model"]) == \
        P(("pod", "data"), None)
    assert shard_shape(mesh, (64, 4096), P(("pod", "data"), "model")) == \
        (2, 256)
    from torch.distributed.tensor import Replicate, Shard
    assert placements(mesh, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(mesh, P(None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="out of mesh order"):
        placements(mesh, P(("data", "pod")))
    assert make_rules(mesh)["batch"] == ("pod", "data")
