"""The port's training path against the JAX package's: ``forward_train``
for all ten configs, its grads against ``jax.grad``, one
``make_train_step`` from the same state (AdamW on qwen3-8b, Adafactor on
arctic-480b, enc-dec seamless-m4t-large-v2 at microbatch 2), a bf16 step,
the microbatch equivalence, and ``cfg.remat``, at each config's
``smoke()`` in fp32 unless stated.

JAX's weights and optimizer state go across with ``params_from_numpy`` and
``opt_state_from_numpy``; batches come from JAX's ``make_smoke_batch``.
Tolerances: the loss and every metric within ``METRIC_TOL`` relative;
each grad leaf within ``GRAD_TOL`` of its largest magnitude; optimizer
state within ``GRAD_TOL`` of each leaf's largest (``v``, a square, twice
it).  Parameters after an AdamW step from a fresh state: the first step
moves an element by lr·g/(|g| + eps), which grads agreeing within
``GRAD_TOL`` can move by at most lr·δ·eps/(|g| - δ + eps)² (δ the grad
bound) and never by more than 2·lr; elements with |g| near eps take
that, all others must agree within ``PARAM_TOL`` of the leaf
(``_adamw_bound``).  The bf16 step: metrics within ``BF16_TOL``,
parameters within one step (2·lr) plus one bf16 rounding.  The microbatch
equivalence: JAX's test's bounds (ce within 2e-3, params rtol = atol =
2e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
from repro.configs.registry import ARCHS, get as jget
from repro.launch.steps import make_train_step as j_make_train_step
from repro.optim import make_optimizer as j_make_optimizer

import repro_torch.models.model as TM
import repro_torch.models.params as TP
from repro_torch.configs.registry import get as tget
from repro_torch.launch.steps import make_train_step, split_microbatches
from repro_torch.optim import make_optimizer, opt_state_from_numpy

METRIC_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
BF16_TOL = 1e-2
ADAM_EPS = 1e-8
SCHED = dict(peak_lr=1e-3, warmup=2, total_steps=10)
STEP = 3                   # past the warmup: lr near its peak


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(port, ref):
    port = _np(port).astype(np.float64)
    ref = _np(ref).astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)


def _leaves(jtree, ttree):
    """(dotted path, JAX leaf as numpy, port leaf) over JAX's tree."""
    for path, a in jax.tree_util.tree_leaves_with_path(jtree):
        node = ttree
        for p in path:
            node = node[p.key]
        yield ".".join(p.key for p in path), np.asarray(a), node


def _cfgs(arch, **change):
    return (dataclasses.replace(tget(arch).smoke(), **change),
            dataclasses.replace(jget(arch).smoke(), **change))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: these tests run many tiny ops, which
    the suite's parallel workers would otherwise make wait on each
    other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX = {}


def _jax_start(arch, batch, seq, change):
    """JAX's weights, batch and optimizer state for the smoke config,
    drawn once per worker."""
    key = (arch, batch, seq, tuple(sorted(change.items())))
    if key not in _JAX:
        jcfg = _cfgs(arch, **change)[1]
        jp = JM.init_model(jcfg, jax.random.PRNGKey(sum(map(ord, arch))))
        jb = JM.make_smoke_batch(jcfg, jax.random.PRNGKey(1), batch=batch,
                                 seq=seq)
        js = j_make_optimizer(jcfg.optimizer)[0](jp)
        _JAX[key] = jp, jb, js
    return _JAX[key]


def _start(arch, *, batch=2, seq=32, **change):
    """JAX's weights, optimizer state and batch for the smoke config, and
    the port's copies (fresh tensors: the train step updates them in
    place)."""
    tcfg, jcfg = _cfgs(arch, **change)
    jp, jb, js = _jax_start(arch, batch, seq, change)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tp = TP.params_from_numpy(tcfg, np_tree(jp), device="cpu")
    ts = opt_state_from_numpy(tcfg, np_tree(js), device="cpu")
    tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
    return (tcfg, tp, ts, tb), (jcfg, jp, js, jb)


_JAX_VALUE_AND_GRAD = {}


def _jax_value_and_grad(arch):
    """JAX's (loss, metrics) and grads of ``forward_train`` for the
    arch's smoke start, one jitted ``value_and_grad`` per worker."""
    if arch not in _JAX_VALUE_AND_GRAD:
        _, (jcfg, jp, _, jb) = _start(arch)
        fn = jax.jit(jax.value_and_grad(
            lambda p: JM.forward_train(jcfg, p, jb), has_aux=True))
        _JAX_VALUE_AND_GRAD[arch] = fn(jp)
    return _JAX_VALUE_AND_GRAD[arch]


def _port_grads(cfg, params, batch):
    leaves = [t for _, t in TP.tree_items(params)]
    for t in leaves:
        t.requires_grad_(True)
    try:
        TM.forward_train(cfg, params, batch)[0].backward()
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = TP.tree_map(lambda t: t.grad, params)
    for t in leaves:
        t.grad = None
    return grads


# --------------------------------------------------------- forward_train

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_train_loss_and_metrics(arch):
    (tcfg, tp, _, tb), _ = _start(arch)
    (jl, jm), _ = _jax_value_and_grad(arch)
    tl, tm = TM.forward_train(tcfg, tp, tb)
    assert sorted(tm) == sorted(jm)
    assert _rel(tl, jl) <= METRIC_TOL
    for k in jm:
        assert tm[k].dtype == torch.float32 and tm[k].dim() == 0
        assert abs(float(tm[k]) - float(jm[k])) <= METRIC_TOL * max(
            abs(float(jm[k])), 1e-6), (k, float(tm[k]), float(jm[k]))
    if tcfg.family == "encdec":
        assert sorted(tm) == ["ce_loss", "loss"]
    else:
        assert {"load_balance", "router_z"} <= set(tm)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_grads_against_jax_grad(arch):
    (tcfg, tp, _, tb), _ = _start(arch)
    _, jg = _jax_value_and_grad(arch)
    tg = _port_grads(tcfg, tp, tb)
    for name, g, t in _leaves(jg, tg):
        assert t.dtype == torch.float32
        assert _rel(t, g) <= GRAD_TOL, name


def test_softmax_xent_with_mask():
    import repro.models.common as JC

    import repro_torch.models.common as TC
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.6
    for m in (None, mask, np.zeros_like(mask)):
        ref = JC.softmax_xent(jnp.array(logits), jnp.array(labels),
                              None if m is None else jnp.array(m))
        out = TC.softmax_xent(torch.tensor(logits), torch.tensor(labels),
                              None if m is None else torch.tensor(m))
        assert out.dtype == torch.float32
        assert abs(float(out) - float(ref)) <= METRIC_TOL * max(
            abs(float(ref)), 1e-6)


# --------------------------------------------------------- the train step

def _adamw_bound(lr, g_jax, delta):
    """Per element, how far two AdamW first steps from one state can land
    when their grads agree within ``delta``: lr·|Δ(g/(|g| + eps))|."""
    lo = np.maximum(np.abs(g_jax) - delta, 0.0)
    return lr * np.minimum(2.0, delta * ADAM_EPS / (lo + ADAM_EPS) ** 2)


@pytest.mark.parametrize("arch,microbatch", [
    ("qwen3-8b", 1), ("arctic-480b", 1), ("seamless-m4t-large-v2", 2)],
    ids=["adamw-qwen3", "adafactor-arctic", "seamless-microbatch2"])
def test_train_step_against_jax(arch, microbatch):
    (tcfg, tp, ts, tb), (jcfg, jp, js, jb) = _start(
        arch, batch=4, microbatch=microbatch)
    jp2, js2, jm = jax.jit(j_make_train_step(jcfg, **SCHED))(
        jp, js, jb, jnp.int32(STEP))
    tp2, ts2, tm = make_train_step(tcfg, **SCHED)(tp, ts, tb, STEP)
    assert tp2 is tp and ts2 is ts                   # updated in place
    assert sorted(tm) == sorted(jm)
    for k in jm:
        tol = 1e-6 if k == "lr" else METRIC_TOL
        assert abs(float(tm[k]) - float(jm[k])) <= tol * max(
            abs(float(jm[k])), 1e-6), (k, float(tm[k]), float(jm[k]))
    assert int(ts["count"]) == int(js2["count"]) == 1
    lr = float(jm["lr"])
    if tcfg.optimizer == "adafactor":
        assert sorted(ts) == ["count", "master", "stats"]
        for name, a, t in _leaves(js2["stats"], ts["stats"]):
            assert _rel(t, a) <= GRAD_TOL, name
        for name, a, t in _leaves(jp2, tp):
            assert _rel(t, a) <= PARAM_TOL, name
        return
    assert sorted(ts) == ["count", "m", "master", "v"]
    for name, a, t in _leaves(js2["m"], ts["m"]):
        assert _rel(t, a) <= GRAD_TOL, name
    for name, a, t in _leaves(js2["v"], ts["v"]):
        assert _rel(t, a) <= 2 * GRAD_TOL, name
    m_jax = dict((n, a) for n, a, _ in _leaves(js2["m"], ts["m"]))
    for name, a, t in _leaves(jp2, tp):
        g = m_jax[name] / 0.1                 # JAX's clipped grad, b1 0.9
        bound = (_adamw_bound(lr, g, GRAD_TOL * np.abs(g).max())
                 + PARAM_TOL * np.abs(a).max())
        assert (np.abs(t.numpy() - a) <= bound).all(), name
    for (_, ma), (_, p) in zip(TP.tree_items(ts["master"]),
                               TP.tree_items(tp)):
        assert torch.equal(ma, p)           # fp32 params are the master


def test_bf16_train_step_against_jax():
    """bf16 weights and grads (the fp32 master and moments): metrics within
    ``BF16_TOL``, the bf16 params within one step plus one rounding."""
    (tcfg, tp, ts, tb), (jcfg, jp, js, jb) = _start(
        "qwen3-8b", batch=4, dtype="bfloat16")
    jp2, js2, jm = jax.jit(j_make_train_step(jcfg, **SCHED))(
        jp, js, jb, jnp.int32(STEP))
    tp2, ts2, tm = make_train_step(tcfg, **SCHED)(tp, ts, tb, STEP)
    for k in ("loss", "ce_loss", "grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= BF16_TOL * abs(
            float(jm[k])), (k, float(tm[k]), float(jm[k]))
    lr = float(jm["lr"])
    for name, a, t in _leaves(jp2, tp2):
        assert t.dtype == torch.bfloat16
        a = a.astype(np.float32)
        assert (np.abs(t.float().numpy() - a)
                <= 2 * lr + 2 ** -7 * np.abs(a)).all(), name
    for name, a, t in _leaves(js2["master"], ts2["master"]):
        assert t.dtype == torch.float32
        assert (np.abs(t.numpy() - a) <= 2 * lr + 1e-6 * np.abs(a)).all()


def test_split_microbatches_follows_jax_reshape():
    tcfg, _ = _cfgs("qwen2-vl-2b")
    b = TM.make_smoke_batch(tcfg, seed=0, batch=6, seq=5, device="cpu")
    b["positions"] = torch.arange(3 * 6 * 5).reshape(3, 6, 5)
    parts = split_microbatches(b, 3)
    assert len(parts) == 3
    for j, part in enumerate(parts):
        assert torch.equal(part["tokens"], b["tokens"][2 * j:2 * j + 2])
        assert torch.equal(part["positions"],
                           b["positions"][:, 2 * j:2 * j + 2])


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b",
                                  "seamless-m4t-large-v2"])
def test_microbatch_equivalence(arch):
    """JAX's ``TestTraining.test_microbatch_equivalence`` on the port, at
    a step with a nonzero rate: one step at microbatch 2 against 1."""
    (tcfg, tp, _, tb), _ = _start(arch, batch=4, microbatch=1)
    outs = []
    for k in (1, 2):
        cfg = dataclasses.replace(tcfg, microbatch=k)
        p = TP.tree_map(torch.clone, tp)
        o = make_optimizer(cfg.optimizer)[0](p)
        p, o, m = make_train_step(cfg, **SCHED)(p, o, tb, STEP)
        outs.append((float(m["ce_loss"]), p))
    assert abs(outs[0][0] - outs[1][0]) < 2e-3
    for (_, a), (_, b) in zip(TP.tree_items(outs[0][1]),
                              TP.tree_items(outs[1][1])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-2,
                                   atol=2e-2)


# --------------------------------------------------------- remat

@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-9b", "dbrx-132b",
                                  "mamba2-370m", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_remat_settings_give_equal_grads(arch):
    """``full`` / ``dots`` / ``none``: the same grads.  Under ``none``
    backward finds every activation saved; under ``dots`` and ``full``
    only the layers' inputs reach autograd's saved tensors, and backward
    recomputes each layer's forward: under ``dots`` all but its matrix
    products, which it kept (as many ``mm`` calls in all as ``none``),
    under ``full`` those too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    (tcfg, tp, _, tb), _ = _start(arch)
    saved, mms, grads = {}, {}, {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        total = [0]

        def pack(t, total=total):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
                CountMM() as count:
            grads[remat] = _port_grads(cfg, tp, tb)
        saved[remat], mms[remat] = total[0], count.mm
    for remat in ("dots", "full"):
        for (name, a), (_, b) in zip(TP.tree_items(grads["none"]),
                                     TP.tree_items(grads[remat])):
            assert _rel(b, a) <= 1e-6, (remat, name)
    assert saved["full"] == saved["dots"] < saved["none"] / 2, saved
    assert mms["none"] == mms["dots"] < mms["full"], mms


def test_opt_state_from_numpy_checks_the_tree():
    (tcfg, _, _, _), (_, _, js, _) = _start("qwen3-8b")
    np_state = jax.tree_util.tree_map(np.asarray, js)
    np_state["m"].pop("final_ln")
    with pytest.raises(ValueError, match="missing"):
        opt_state_from_numpy(tcfg, np_state, device="cpu")
    np_state = jax.tree_util.tree_map(np.asarray, js)
    np_state["count"] = np.zeros((), np.int64)
    with pytest.raises(ValueError, match="count"):
        opt_state_from_numpy(tcfg, np_state, device="cpu")
