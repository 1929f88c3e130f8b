"""The port's dry runs: the cost model (``launch/cost_analysis.py``), the
LM dry run (``launch/dryrun.py``), the solver dry run
(``launch/solver_dryrun.py``) and the matrix runner (``launch/sweep.py``).

* The cost model against ``tests/test_hlo_analysis.py``'s five cases: a
  single product's FLOPs, FLOPs that scale with the number of layers (the
  counterpart of a scan's trip count: eager mode runs every layer), bytes
  that scale with size, a nested loop, and a step found and counted.
* On a fake (2, 2) process group, in a subprocess (the group lasts for
  the life of a process): an FSDP-sharded product counts one all-gather
  of the bytes worked out by hand; ``run_cell`` on the smoke config of
  each family (dense, vlm, moe, ssm, hybrid, encdec) × train / prefill /
  decode yields JAX's fields, and its per-device argument bytes equal
  JAX's shard total for the same config, cell and (2, 2) mesh (JAX's side
  in a subprocess with 4 forced host devices; JAX's train step is a 4-byte
  replicated scalar, the port's a host int).  No cell writes into a view
  that DTensor gathered (such a write would miss the shards), and the
  cost model counts one that does.
* ``solver_dryrun`` on a small obs and 2-D case, its recorded collectives
  equal to the count worked out from the solver's group sums.
* ``sweep.py`` over two cells.
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.core.distributed import (CollectiveRecorder,
                                          solvebakp_obs_sharded)
from repro_torch.launch.cost_analysis import CostModel
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.solver_dryrun import run as solver_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"dense": "qwen3-8b", "vlm": "qwen2-vl-2b", "moe": "dbrx-132b",
            "ssm": "mamba2-370m", "hybrid": "zamba2-7b",
            "encdec": "seamless-m4t-large-v2"}
KINDS = ("train", "prefill", "decode")
FIELDS = ("memory_analysis", "hlo_cost", "collectives", "roofline",
          "model_flops_per_chip", "useful_flops_ratio", "params_total",
          "params_active")


def _count(fn, *args):
    cm = CostModel()
    cm.track(args)
    with cm:
        fn(*args)
    return cm.summary()


class TestCostModel:
    def test_single_matmul_flops(self):
        x, w = torch.zeros(64, 128), torch.zeros(128, 32)
        res = _count(lambda a, b: a @ b, x, w)
        expect = 2 * 64 * 128 * 32
        assert abs(res["flops"] - expect) / expect < 0.05

    def test_layers_multiply_flops(self):
        L = 10
        x = torch.zeros(64, 64)

        def f(c):
            for _ in range(L):
                c = torch.tanh(c @ c)
            return c
        res = _count(f, x)
        one = 2 * 64 ** 3
        assert L * one * 0.9 < res["flops"] < L * one * 1.6

    def test_nested_loop(self):
        x = torch.zeros(32, 32)

        def f(c):
            for _ in range(4):
                for _ in range(3):
                    c = c @ c
            return c
        res = _count(f, x)
        assert res["flops"] > 12 * 2 * 32 ** 3 * 0.9

    def test_memory_bytes_scale(self):
        res = _count(lambda a: a + 1.0, torch.zeros(1024, 1024))
        assert 4e6 < res["hbm_bytes"] < 4e7     # read + write 8 MB
        assert res["peak_live_bytes"] == 4 * 1024 * 1024

    def test_step_found_and_counted(self):
        """A whole train step (the smoke qwen3-8b) counts ops, FLOPs at
        least the model's 6·N·tokens, and the same on ``meta`` as on the
        CPU."""
        from repro_torch.configs.registry import get
        from repro_torch.launch.dryrun import count_step
        from repro_torch.launch.steps import abstract_cell_args, \
            make_train_step
        from repro_torch.configs.base import ShapeCell
        from repro_torch.models import model as TM
        from repro_torch.optim import make_optimizer

        cfg = get("qwen3-8b").smoke()
        cell = ShapeCell("t", 32, 4, "train")
        fn, args = abstract_cell_args(cfg, cell)
        _, meta, _ = count_step(fn, args)
        p = TM.init_model(cfg, seed=0, device="cpu")
        opt = make_optimizer(cfg.optimizer)[0](p)
        b = TM.make_smoke_batch(cfg, seed=0, batch=4, seq=32, device="cpu")
        _, real, _ = count_step(make_train_step(cfg), (p, opt, b, 0))
        m, r = meta.summary(), real.summary()
        assert m["ops"] == r["ops"] > 0
        assert m["flops"] == r["flops"] >= 6 * cfg.n_params() * 4 * 32 * 0.5
        assert m["argument_bytes"] == r["argument_bytes"]


FAKE_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.configs.registry import get
    from repro_torch.distributed.sharding import P, abstract_tensor
    from repro_torch.launch.dryrun import count_step, fake_device_mesh, \\
        run_cell

    mesh = fake_device_mesh((2, 2), ("data", "model"))
    out = {}
    x = abstract_tensor((8, 16), torch.float32, mesh, P("data", None))
    w = abstract_tensor((16, 32), torch.float32, mesh, P("data", "model"))
    _, cm, _ = count_step(lambda a, b: a @ b, (x, w), mesh)
    out["fsdp"] = cm.summary()
    # A view that splits a model-sharded dim its 4 shards do not divide
    # gathers; a write into it lands on the gathered copy.
    mesh14 = fake_device_mesh((1, 4), ("data", "model"))
    y = abstract_tensor((4, 8), torch.float32, mesh14, P(None, "model"))
    _, cm, _ = count_step(lambda t: t.view(4, 2, 4).add_(1.0), (y,), mesh14)
    out["view_write"] = cm.summary()
    # The smoke qwen3's 2 KV heads on a model axis of 4: decode views its
    # cache by head, which gathers.
    out["uneven|decode"] = run_cell(
        get("qwen3-8b").smoke(), ShapeCell("t", 64, 8, "decode"),
        mesh_shape=(1, 4))
    for fam, arch in json.loads(sys.argv[2]).items():
        for kind in ("train", "prefill", "decode"):
            out[f"{fam}|{kind}"] = run_cell(
                get(arch).smoke(), ShapeCell("t", 64, 8, kind),
                mesh_shape=(2, 2))
    json.dump(out, open(sys.argv[1], "w"))
""")

JAX_SCRIPT = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.configs.base import ShapeCell
    from repro.configs.registry import get
    from repro.distributed.sharding import make_rules
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.steps import abstract_cell_args

    mesh = make_debug_mesh((2, 2), ("data", "model"))
    out = {}
    for fam, arch in json.loads(sys.argv[2]).items():
        for kind in ("train", "prefill", "decode"):
            _, args = abstract_cell_args(get(arch).smoke(),
                                         ShapeCell("t", 64, 8, kind), mesh,
                                         make_rules(mesh))
            out[f"{fam}|{kind}"] = sum(
                int(np.prod(l.sharding.shard_shape(l.shape)))
                * np.dtype(l.dtype).itemsize
                for l in jax.tree_util.tree_leaves(args))
    json.dump(out, open(sys.argv[1], "w"))
""")


def _start(script, path, **env):
    e = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env)
    return subprocess.Popen([sys.executable, "-c", script, path,
                             json.dumps(FAMILIES)], env=e, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc, path):
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    """The port's runs and JAX's shard totals, the two subprocesses at
    once."""
    d = tmp_path_factory.mktemp("dryrun")
    port = _start(FAKE_SCRIPT, str(d / "port.json"))
    jax = _start(JAX_SCRIPT, str(d / "jax.json"), JAX_PLATFORMS="cpu")
    return _result(port, str(d / "port.json")), _result(
        jax, str(d / "jax.json"))


def test_fsdp_product_counts_one_all_gather(fake):
    """x (8, 16) over data @ w (16, 32) over (data, model): w's FSDP
    shard (8, 16) is gathered over data to (16, 16) fp32 = 1,024 bytes a
    device (the gathered result, as JAX counts it), and the product is
    2·4·16·16 a device."""
    s = fake[0]["fsdp"]
    assert s["collectives"]["all-gather"] == 16 * 16 * 4
    assert s["collectives"]["count"] == 1
    assert s["collectives_by_axis"] == {"data": 16 * 16 * 4}
    assert s["flops"] == 2 * 4 * 16 * 16


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("kind", KINDS)
def test_run_cell_smoke_families(fake, fam, kind):
    port, jax_bytes = fake
    r = port[f"{fam}|{kind}"]
    for k in FIELDS:
        assert k in r, k
    assert r["device"] == "meta" and r["chips"] == 4 and r["mesh"] == "2x2"
    mem = r["memory_analysis"]
    step = 4 if kind == "train" else 0
    assert mem["argument_bytes"] + step == jax_bytes[f"{fam}|{kind}"]
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes"] > 0
    assert mem["fits_80gb"]
    assert r["hlo_cost"]["flops_per_device"] > 0
    assert r["roofline"]["bottleneck"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert r["flop_counter_global"] >= 0
    assert r["gathered_view_writes"] == {}


def test_write_into_a_gathered_view_is_counted(fake):
    s = fake[0]["view_write"]
    assert s["gathered_views"] == {"aten.view.default": 1}
    assert list(s["gathered_view_writes"].values()) == [1]
    assert next(iter(s["gathered_view_writes"])).startswith("aten.add_")


def test_decode_writes_its_cache_not_a_gathered_view(fake):
    """The KV heads do not divide the model axis, so decode's view of the
    cache by head gathers; the new token is still written into the
    cache's own shards."""
    r = fake[0]["uneven|decode"]
    assert r["mesh"] == "1x4"
    assert sum(r["gathered_views"].values()) > 0
    assert r["gathered_view_writes"] == {}


def _obs_hand_count(obs, nvars, thr, sweeps, nrhs, positions):
    """All-reduce bytes a device of the obs-sharded gram solve, from its
    group sums: the block Grams once, the SSE before the sweeps, and per
    sweep one (thr, k) inner product a block and the SSE."""
    nblocks = -(-nvars // thr)
    return (nblocks * thr * thr * 4 + 4
            + sweeps * (nblocks * thr * nrhs * 4 + 4))


@pytest.mark.parametrize("sharding", ["obs", "2d"])
def test_solver_dryrun_small(sharding):
    mesh = make_mesh((4, 2), ("data", "model"), devices=["meta"] * 8)
    r = solver_run(obs=4096, nvars=256, thr=64, sweeps=3, mode="gram",
                   sharding=sharding, dtype="bfloat16", mesh=mesh)
    assert r["device"] == "meta" and r["chips"] == 8
    # bf16 x stays bf16 in its shards
    assert r["memory_analysis"]["shard_x_bytes"] == 4096 * 256 * 2 // 8
    by_axis = {a: v * 3 for a, v in r["collectives_by_axis"].items()}
    gathered = r["collectives"]["all-gather"] * 3
    if sharding == "obs":
        assert r["collectives"]["all-reduce"] * 3 == _obs_hand_count(
            4096, 256, 64, 3, 1, 8)
        assert set(by_axis) == {"data,model"}
    else:
        # a device's share of each group sum (bytes × group / 8 devices):
        # over data, each column shard's 2 block Grams, the SSEs (summed
        # once, on model position 0) and the inner products; over model,
        # each block's residual correction of obs/4 rows
        nb = 128 // 64
        data = (2 * nb * 64 * 64 * 4 * 4 / 8 + 4 * 4 / 8
                + 3 * (2 * nb * 64 * 4 * 4 / 8 + 4 * 4 / 8))
        model = 3 * nb * 4 * (4096 // 4) * 4 * 2 / 8
        assert r["collectives"]["all-reduce"] * 3 == data + model
        assert set(by_axis) == {"data", "model"}
        assert model <= by_axis["model"] <= model + gathered
    assert sum(by_axis.values()) == pytest.approx(
        r["collectives"]["all-reduce"] * 3 + gathered)
    assert 0 < r["roofline_fraction"] <= 1
    assert r["per_sweep"]["bottleneck"] in ("compute_s", "memory_s",
                                            "collective_s")


def test_recorder_on_a_cpu_solve():
    """The recorder sees each group sum of a real solve on virtual shards:
    one per block and sweep plus the SSEs and the Gram, each (kind,
    bytes a member, group size, axes)."""
    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(256, 48, generator=g)
    y = x @ torch.randn(48, 2, generator=g)
    with CollectiveRecorder() as rec:
        r = solvebakp_obs_sharded(x, y, mesh, thr=16, max_iter=5)
    n = int(r.n_sweeps)
    sums = [b for k, b, grp, ax in rec.records if k == "all-reduce"]
    assert all(grp == 4 and ax == ("data",) for _, _, grp, ax in
               rec.records)
    assert sum(sums) == _obs_hand_count(256, 48, 16, n, 2, 4)
    assert CollectiveRecorder.current() is None


def test_sweep_two_cells(tmp_path):
    out = tmp_path / "m"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--out", str(out),
         "--archs", "mamba2-370m", "--cells", "decode_32k", "-j", "2"],
        env=env, capture_output=True, text=True, cwd=str(tmp_path),
        timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "done: 2 ok, 0 failed" in p.stdout
    for tag in ("sp", "mp"):
        r = json.loads((out / f"mamba2-370m__decode_32k_{tag}.json")
                       .read_text())
        assert r["device"] == "meta" and r["chips"] == (256 if tag == "sp"
                                                        else 512)
    again = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--out", str(out),
         "--archs", "mamba2-370m", "--cells", "decode_32k"],
        env=env, capture_output=True, text=True, cwd=str(tmp_path),
        timeout=120)
    assert again.stdout.count("cached") == 2


def test_sweep_relative_out(tmp_path):
    """A relative --out names a directory under the caller's working
    directory, for the cells (which run from the repository root) too."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    rel = "rel_out_" + tmp_path.name
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--out", rel,
         "--archs", "mamba2-370m", "--cells", "decode_32k",
         "--meshes", "pod"],
        env=env, capture_output=True, text=True, cwd=str(tmp_path),
        timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "done: 1 ok, 0 failed" in p.stdout
    m = re.search(r"(\d+) clean, (\d+) through a fallback, 0 failed",
                  p.stdout)
    assert m and int(m[1]) + int(m[2]) == 1
    assert (tmp_path / rel / "mamba2-370m__decode_32k_sp.json").exists()
    assert not os.path.exists(os.path.join(ROOT, rel))
    assert "| failed" not in p.stdout          # no cell of the table
