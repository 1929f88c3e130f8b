"""``ShardCtx`` through the port's models against the JAX package's.

Under a mesh JAX's MoE routes each data shard's tokens as a group of its
own, with capacity per group (G = gcd(B, data shards)): a different
function from the ctx-less one.  One subprocess forces 8 host devices and
runs, for the dbrx-132b and arctic-480b smoke configs at B in {2, 4, 6}
(G = gcd(B, 4)), JAX's ``apply_moe``, ``forward_train``,
``forward_prefill`` / ``forward_decode`` and the train step with
microbatch 2 under ``ShardCtx`` on its (4, 2) mesh, and the port's under
``ShardCtx`` on ``make_debug_mesh((4, 2), devices=["cpu"] * 8)`` (the
port's virtual shards: ``constrain`` keeps a plain tensor as it is), on
JAX's weights and the same numpy inputs.  Each case is a test here.

Tolerances are ``tests/test_torch_models_moe.py``'s: MoE outputs and cache
entries within 1e-5 of the reference's largest magnitude (``MODULE_TOL``),
logits within 1e-4 (``LOGIT_TOL``), the aux losses and the train step's
metrics within 1e-5 relative (``tests/test_torch_train.py``'s
``METRIC_TOL``).  Where JAX's grouped MoE outputs or losses differ from
its ctx-less ones by more than 1e-4 relative (beyond rounding), the
port's must differ from its own ctx-less ones too, and nowhere else.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import kvcache as TK
from repro_torch.models import model as TM
from repro_torch.models.common import NULL_CTX, ShardCtx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE_TOL = 1e-5
LOGIT_TOL = 1e-4
METRIC_TOL = 1e-5

ARCHS = ["dbrx-132b", "arctic-480b"]
BATCHES = [2, 4, 6]

SCRIPT = textwrap.dedent("""
    import os, sys, json, math
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp, torch
    from repro.configs.registry import get as jget
    from repro.distributed.sharding import make_rules as j_rules
    from repro.launch.mesh import make_debug_mesh as j_mesh
    from repro.launch.steps import make_train_step as j_train
    from repro.models import kvcache as JK, model as JM, moe as JMOE
    from repro.models.common import ShardCtx as JCtx
    from repro_torch.configs.registry import get as tget
    from repro_torch.distributed.sharding import make_rules as t_rules
    from repro_torch.launch.mesh import make_debug_mesh as t_mesh
    from repro_torch.launch.steps import make_train_step as t_train
    from repro_torch.models import kvcache as TK, model as TM, moe as TMOE
    from repro_torch.models.common import ShardCtx as TCtx
    from repro_torch.models.params import params_from_numpy, tree_map
    from repro_torch.optim import opt_state_from_numpy
    from repro.optim import make_optimizer as j_opt

    out_path = sys.argv[1]
    MOVED = 1e-4    # the grouping changed a value beyond rounding
    jm = j_mesh((4, 2), ("data", "model"))
    tm = t_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    jctx, tctx = JCtx(jm, j_rules(jm)), TCtx(tm, t_rules(tm))

    def rel(a, b):
        a = np.asarray(a, np.float64); b = np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    def T(a):
        return torch.tensor(np.asarray(a))

    res = {}
    for arch in ("dbrx-132b", "arctic-480b"):
        jcfg, tcfg = jget(arch).smoke(), tget(arch).smoke()
        jp = JM.init_model(jcfg, jax.random.PRNGKey(3))
        npp = jax.tree_util.tree_map(np.asarray, jp)
        tp = params_from_numpy(tcfg, npp, device="cpu")
        jffn = jax.tree_util.tree_map(lambda a: a[0],
                                      jp["backbone"]["layers"]["ffn"])
        tffn = tree_map(lambda t: t[0], tp["backbone"]["layers"]["ffn"])
        for b in (2, 4, 6):
            r = np.random.default_rng(10 * b)
            key = f"{arch}|{b}"
            case = {"groups": math.gcd(b, 4)}
            # apply_moe: grouped and ctx-less
            x = r.standard_normal((b, 12, jcfg.d_model)).astype(np.float32)
            jy, jaux = jax.jit(lambda p, x: JMOE.apply_moe(
                jcfg, p, x, jctx))(jffn, jnp.asarray(x))
            jy0, jaux0 = JMOE.apply_moe(jcfg, jffn, jnp.asarray(x), None)
            ty, taux = TMOE.apply_moe(tcfg, tffn, T(x), tctx)
            ty0, taux0 = TMOE.apply_moe(tcfg, tffn, T(x))
            case["moe_y"] = rel(ty, jy)
            case["moe_aux"] = max(rel(taux[k], jaux[k]) for k in jaux)
            case["jax_aux_differs"] = [rel(jaux[k], jaux0[k]) > MOVED
                                       for k in sorted(jaux)]
            case["port_aux_differs"] = [rel(taux[k], taux0[k]) > MOVED
                                        for k in sorted(jaux)]
            case["jax_y_differs"] = rel(jy, jy0) > MOVED
            case["port_y_differs"] = rel(ty, ty0) > MOVED
            # forward_train
            toks = r.integers(0, jcfg.vocab_size, (b, 16)).astype(np.int32)
            labs = r.integers(0, jcfg.vocab_size, (b, 16)).astype(np.int32)
            jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
            tb = {"tokens": T(toks), "labels": T(labs)}
            jl, jmet = jax.jit(lambda p, bb: JM.forward_train(
                jcfg, p, bb, jctx))(jp, jb)
            tl, tmet = TM.forward_train(tcfg, tp, tb, tctx)
            case["train_metrics"] = max(rel(tmet[k], jmet[k]) for k in jmet)
            jl0, _ = JM.forward_train(jcfg, jp, jb)
            case["jax_loss_differs"] = rel(jl, jl0) > MOVED
            case["port_loss_differs"] = rel(
                tl, TM.forward_train(tcfg, tp, tb)[0]) > MOVED
            # prefill, then two decode steps
            jc = JK.init_cache(jcfg, b, 32)
            tc = TK.init_cache(tcfg, b, 32, device="cpu")
            jlog, jc = jax.jit(lambda p, bb, c: JM.forward_prefill(
                jcfg, p, bb, c, jctx))(jp, {"tokens": jb["tokens"]}, jc)
            tlog, tc = TM.forward_prefill(tcfg, tp, {"tokens": tb["tokens"]},
                                          tc, tctx)
            case["prefill_logits"] = rel(tlog, jlog)
            dec = []
            for i in range(2):
                nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(
                    np.int32)
                jlog, jc = jax.jit(lambda p, t, c: JM.forward_decode(
                    jcfg, p, t, c, jctx))(jp, jnp.asarray(nxt), jc)
                tlog, tc = TM.forward_decode(tcfg, tp, T(nxt), tc, tctx)
                dec.append(rel(tlog, jlog))
            case["decode_logits"] = max(dec)
            case["cache"] = max(rel(tc[k].float(), np.asarray(jc[k],
                                np.float32)) for k in jc if k != "lengths")
            case["lengths"] = bool(np.array_equal(tc["lengths"].numpy(),
                                                  np.asarray(jc["lengths"])))
            res[key] = case
        # train step, microbatch 2, under ctx
        import dataclasses
        jcfg2 = dataclasses.replace(jcfg, microbatch=2)
        tcfg2 = dataclasses.replace(tcfg, microbatch=2)
        r = np.random.default_rng(99)
        toks = r.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
        labs = r.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
        init, _ = j_opt(jcfg.optimizer)
        js = init(jp)
        ts = opt_state_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                               js),
                                  device="cpu")
        sched = dict(peak_lr=1e-3, warmup=2, total_steps=10)
        _, _, jmet = jax.jit(j_train(jcfg2, jctx, **sched))(
            jp, js, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
            jnp.int32(3))
        tp2 = params_from_numpy(tcfg, npp, device="cpu")
        _, _, tmet = t_train(tcfg2, tctx, **sched)(
            tp2, ts, {"tokens": T(toks), "labels": T(labs)}, 3)
        res[f"{arch}|train_step"] = {
            "metrics": {k: [float(tmet[k]), float(jmet[k])] for k in jmet}}
    json.dump(res, open(out_path, "w"))
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shardctx") / "res.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", SCRIPT, path], env=env,
                       capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", BATCHES)
def test_moe_grouped_by_data_shard(results, arch, b):
    c = results[f"{arch}|{b}"]
    assert c["groups"] == {2: 2, 4: 4, 6: 2}[b]
    assert c["moe_y"] <= MODULE_TOL
    assert c["moe_aux"] <= METRIC_TOL
    # outputs and losses move with the grouping wherever JAX's do
    assert c["port_aux_differs"] == c["jax_aux_differs"]
    assert c["port_y_differs"] == c["jax_y_differs"]


def test_grouping_changes_jax_function(results):
    """The grouped MoE is another function: somewhere JAX's output and its
    loss differ from the ctx-less ones (capacity per group drops other
    assignments)."""
    cases = [results[f"{a}|{b}"] for a in ARCHS for b in BATCHES]
    assert any(c["jax_y_differs"] for c in cases)
    assert any(c["jax_loss_differs"] for c in cases)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", BATCHES)
def test_forwards_under_shardctx(results, arch, b):
    c = results[f"{arch}|{b}"]
    assert c["train_metrics"] <= METRIC_TOL
    assert c["port_loss_differs"] == c["jax_loss_differs"]
    assert c["prefill_logits"] <= LOGIT_TOL
    assert c["decode_logits"] <= LOGIT_TOL
    assert c["cache"] <= MODULE_TOL
    assert c["lengths"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_microbatch2_under_shardctx(results, arch):
    for k, (t, j) in results[f"{arch}|train_step"]["metrics"].items():
        assert abs(t - j) <= METRIC_TOL * max(abs(j), 1e-6), (k, t, j)


@pytest.mark.parametrize("arch", ["qwen3-8b", "dbrx-132b", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_null_ctx_changes_nothing(arch):
    """``NULL_CTX``, ``ShardCtx()`` and a one-device mesh's context give the
    ctx-less forwards bit for bit (a (1, 1) mesh has one data shard)."""
    cfg = get(arch).smoke()
    p = TM.init_model(cfg, seed=1, device="cpu")
    batch = TM.make_smoke_batch(cfg, seed=2, batch=2, seq=16, device="cpu")
    one = ShardCtx(make_debug_mesh((1, 1), devices=["cpu"]), {})
    ref_loss, ref_m = TM.forward_train(cfg, p, batch)
    pre = {k: v for k, v in batch.items() if k != "labels"}
    if cfg.family == "encdec":
        pre["frames"] = pre["frames"][:, :cfg.src_len_for_decode]
    c0 = TK.init_cache(cfg, 2, 32, device="cpu")
    ref_pre, _ = make_prefill_step(cfg)(p, pre, c0)
    ref_dec, _ = make_decode_step(cfg)(p, batch["tokens"][:, :1], c0)
    for ctx in (NULL_CTX, ShardCtx(), one):
        loss, m = TM.forward_train(cfg, p, batch, ctx)
        assert torch.equal(loss, ref_loss)
        assert all(torch.equal(m[k], ref_m[k]) for k in ref_m)
        c = TK.init_cache(cfg, 2, 32, device="cpu")
        lp, _ = make_prefill_step(cfg, ctx)(p, pre, c)
        ld, _ = make_decode_step(cfg, ctx)(p, batch["tokens"][:, :1], c)
        assert torch.equal(lp, ref_pre) and torch.equal(ld, ref_dec)
    assert np.isfinite(float(ref_loss))
