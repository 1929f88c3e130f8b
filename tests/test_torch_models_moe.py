"""The port's MoE family against the JAX package's: routing, the MoE
block, arctic's dense residual, the aux losses, an MoE FFN on the dense
family, and dbrx-132b / arctic-480b whole, each at its config's
``smoke()`` in fp32.

Inputs come from numpy with a seed; JAX's weights go across with
``params_from_numpy``.  Routing (the experts chosen, which assignments
capacity keeps, and each one's buffer row) must equal JAX's exactly:
JAX's own intermediates are recorded while its ``apply_moe`` runs.
Tolerance: 1e-5 of the reference's largest magnitude per module and cache
entry (``MODULE_TOL``), 1e-4 for logits after the whole model
(``LOGIT_TOL``).  A 1-token decode routes with another capacity than the
same token inside a longer forward, so MoE decode is held to JAX's
decode, not to the full forward (JAX's test_models_smoke leaves MoE out of
that check for this reason).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.kvcache as JK
import repro.models.model as JM
import repro.models.moe as JMOE
import repro.models.params as JP
import repro.models.transformer as JT
from repro.configs.registry import get as jget

import repro_torch.models.kvcache as TK
import repro_torch.models.model as TM
import repro_torch.models.moe as TMOE
import repro_torch.models.params as TP
import repro_torch.models.transformer as TT
from repro_torch.configs.registry import get as tget
from repro_torch.launch import steps as tsteps

MODULE_TOL = 1e-5
LOGIT_TOL = 1e-4

# name: (arch, changes to its smoke config)
CASES = {
    "dbrx": ("dbrx-132b", {}),
    "arctic": ("arctic-480b", {}),
    # An MoE FFN on the dense family: any family with n_experts > 0 takes it.
    "qwen3_moe": ("qwen3-8b", {"n_experts": 4, "experts_per_token": 2,
                               "moe_d_ff": 64}),
}
ALL = list(CASES)

FULL_PARAMS = {"dbrx-132b": 131_596_523_520, "arctic-480b": 476_850_275_328}


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(port, ref, tol=MODULE_TOL):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    port, ref = port.astype(np.float64), ref.astype(np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(port - ref).max() / scale
    assert err <= tol, f"max |port - ref| = {err:.3g} of max |ref|"


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _cfgs(case):
    arch, change = CASES[case]
    return (dataclasses.replace(tget(arch).smoke(), **change),
            dataclasses.replace(jget(arch).smoke(), **change))


_WEIGHTS = {}


def _weights(case):
    """JAX's random weights for the case (seeded by its name), as JAX's
    tree and carried into the port's."""
    if case not in _WEIGHTS:
        tcfg, jcfg = _cfgs(case)
        jp = JM.init_model(jcfg, jax.random.PRNGKey(sum(map(ord, case))))
        npp = jax.tree_util.tree_map(np.asarray, jp)
        _WEIGHTS[case] = jp, TP.params_from_numpy(tcfg, npp, device="cpu")
    return _WEIGHTS[case]


def _ffn(case, layer=0):
    jp, tp = _weights(case)
    return (jax.tree_util.tree_map(lambda a: a[layer],
                                   jp["backbone"]["layers"]["ffn"]),
            TP.tree_map(lambda t: t[layer], tp["backbone"]["layers"]["ffn"]))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


class _RecordingJax:
    """Stands in for the ``jax`` module inside ``repro.models.moe`` while
    its ``apply_moe`` runs, recording what ``lax.top_k`` returned and the
    arguments of each ``vmap``'d call (the scatter's are (dest, x_rep)):
    JAX's own routing, not a copy of it."""

    def __init__(self):
        self.top_k, self.vmap_args = [], []
        outer = self

        class _Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            def top_k(self, x, k):
                out = jax.lax.top_k(x, k)
                outer.top_k.append(out)
                return out

        self.lax = _Lax()

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn):
        def run(*args):
            self.vmap_args.append(args)
            return jax.vmap(fn)(*args)
        return run


def _jax_moe(monkeypatch, cfg, p, x):
    """JAX's apply_moe on x, with its routing: (y, aux, idx, keep, dest)."""
    rec = _RecordingJax()
    with monkeypatch.context() as m:
        m.setattr(JMOE, "jax", rec)
        y, aux = JMOE.apply_moe(cfg, p, jnp.array(x), None)
    (_, idx), = rec.top_k
    dest = np.asarray(rec.vmap_args[0][0])
    cap = JMOE._capacity(cfg, x.shape[0] * x.shape[1])
    keep = dest != cfg.n_experts * cap
    return y, aux, np.asarray(idx), keep, dest


def _skewed(cfg, p_ffn, b, s, seed, skew):
    """Activations (B, S, d); with ``skew`` each token leans toward expert
    0 so that it takes more assignments than its capacity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if skew:
        w0 = np.asarray(p_ffn["router"])[:, 0]
        x += 40.0 * w0 / np.linalg.norm(w0) ** 2
    return x


# --------------------------------------------------------- routing, block

@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("b,s,skew,drops", [
    (2, 24, True, True),     # expert 0 over its capacity
    (1, 3, False, False),    # 3 tokens, capacity 8: nothing dropped
    (2, 40, False, None),    # random routing at serving size
])
def test_apply_moe_routing_is_jax_exactly(monkeypatch, case, b, s, skew,
                                          drops):
    tcfg, jcfg = _cfgs(case)
    jffn, tffn = _ffn(case, 1)
    x = _skewed(tcfg, jffn, b, s, seed=b * 100 + s, skew=skew)
    jy, jaux, jidx, jkeep, jdest = _jax_moe(monkeypatch, jcfg, jffn, x)
    n = b * s
    cap = TMOE.capacity(tcfg, n)
    assert cap == JMOE._capacity(jcfg, n)
    r = TMOE.route(tcfg, TMOE.router_logits(tffn, _t(x).reshape(1, n, -1)),
                   cap)
    np.testing.assert_array_equal(r.idx.numpy(), jidx)
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)
    np.testing.assert_array_equal(r.dest.numpy(), jdest)
    if drops is not None:
        assert bool((~r.keep).any()) == drops
    y, aux = TMOE.apply_moe(tcfg, tffn, _t(x))
    _close(y, jy)
    assert set(aux) == set(jaux)
    for k in aux:
        _close(aux[k], jaux[k])
    if drops is False:
        _close(TMOE.apply_moe_no_capacity(tcfg, tffn, _t(x)), jy)


@pytest.mark.parametrize("n,want", [(1, 8), (3, 8), (24, 16), (40, 32),
                                    (2048, 1280), (4, 8)])
def test_capacity_is_jax_arithmetic(n, want):
    """int() truncation of the float product, then up to a multiple of 8;
    at least 8 (dbrx smoke: 4 experts, top-2, factor 1.25)."""
    cfg = tget("dbrx-132b").smoke()
    assert TMOE.capacity(cfg, n) == JMOE._capacity(jget("dbrx-132b").smoke(),
                                                   n) == want
    full = tget("dbrx-132b")
    for m in (4, 2048, 8 * 4096 + 3):
        assert TMOE.capacity(full, m) == JMOE._capacity(jget("dbrx-132b"), m)
    arctic = tget("arctic-480b")
    for m in (4, 2048, 10_001):
        assert TMOE.capacity(arctic, m) == JMOE._capacity(
            jget("arctic-480b"), m)


def test_routing_ranks_are_token_major():
    """A hand-made routing: 3 tokens all choosing experts (0, 1) with
    capacity 2 keep tokens 0 and 1 on both experts and drop token 2's two
    assignments to the overflow row; the rank is counted over the
    flattened (token, choice) order."""
    cfg = dataclasses.replace(tget("dbrx-132b").smoke(), n_experts=3,
                              experts_per_token=2)
    logits = torch.tensor([[[5.0, 4.0, 0.0]] * 3])
    r = TMOE.route(cfg, logits, cap=2)
    assert r.idx[0].tolist() == [[0, 1]] * 3
    assert r.keep[0].tolist() == [True, True, True, True, False, False]
    assert r.dest[0].tolist() == [0, 2, 1, 3, 6, 6]
    torch.testing.assert_close(r.gate.sum(-1), torch.ones(1, 3))


def test_dense_residual_runs_beside_the_experts(monkeypatch):
    """Arctic: the dense MLP's output is added to the experts' on every
    token, dropped or not."""
    tcfg, jcfg = _cfgs("arctic")
    jffn, tffn = _ffn("arctic", 0)
    assert "dense" in tffn
    x = _skewed(tcfg, jffn, 2, 24, seed=5, skew=True)
    y, _ = TMOE.apply_moe(tcfg, tffn, _t(x))
    jy, *_ = _jax_moe(monkeypatch, jcfg, jffn, x)
    _close(y, jy)
    no_res = dataclasses.replace(tcfg, dense_residual_d_ff=0)
    y0, _ = TMOE.apply_moe(no_res, tffn, _t(x))
    from repro_torch.models.common import apply_mlp
    _close(y - y0, apply_mlp(tffn["dense"], _t(x)))


def test_apply_moe_bf16_against_jax(monkeypatch):
    """bf16 activations and weights, as served: the router logits widen
    after the bf16 product, the expert products stay bf16, the aux losses
    are fp32; routing equals JAX's and the output agrees to bf16
    rounding."""
    tcfg, jcfg = _cfgs("dbrx")
    jffn, tffn = _ffn("dbrx", 0)
    j16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jffn)
    t16 = TP.tree_map(lambda t: t.to(torch.bfloat16), tffn)
    x = _skewed(tcfg, jffn, 2, 12, seed=9, skew=False)
    x16 = np.asarray(jnp.array(x, jnp.bfloat16))
    y, aux = TMOE.apply_moe(tcfg, t16, torch.tensor(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert all(a.dtype == torch.float32 for a in aux.values())
    jy, jaux, jidx, jkeep, jdest = _jax_moe(monkeypatch, jcfg, j16, x16)
    r = TMOE.route(tcfg, TMOE.router_logits(
        t16, torch.tensor(x).to(torch.bfloat16).reshape(1, 24, -1)),
        TMOE.capacity(tcfg, 24))
    np.testing.assert_array_equal(r.idx.numpy(), jidx)
    np.testing.assert_array_equal(r.dest.numpy(), jdest)
    _close(y.float(), np.asarray(jy, np.float32), 1e-2)


@pytest.mark.parametrize("case", ALL)
def test_moe_defs_and_params(case):
    tcfg, jcfg = _cfgs(case)
    td = dict(TP.tree_items(TM.model_defs(tcfg)))
    jd = {".".join(k.key for k in path): v for path, v in
          jax.tree_util.tree_flatten_with_path(
              JM.model_defs(jcfg),
              is_leaf=lambda x: isinstance(x, JP.ParamDef))[0]}
    assert set(td) == set(jd)
    for name in td:
        assert dataclasses.astuple(td[name]) == dataclasses.astuple(
            jd[name]), name
    assert "backbone.layers.ffn.w_gate" in td
    assert ("backbone.layers.ffn.dense.w_up" in td) == (case == "arctic")
    jp, tp = _weights(case)
    jleaves = {".".join(k.key for k in path): v for path, v in
               jax.tree_util.tree_flatten_with_path(jp)[0]}
    tleaves = dict(TP.tree_items(tp))
    assert set(jleaves) == set(tleaves)
    for name, v in jleaves.items():
        np.testing.assert_array_equal(tleaves[name].numpy(), np.asarray(v))


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_full_size_defs_count_and_cache(arch):
    tcfg, jcfg = tget(arch), jget(arch)
    n = TP.count_params(TM.model_defs(tcfg))
    assert n == JP.count_params(JM.model_defs(jcfg)) == FULL_PARAMS[arch]
    for b, s in ((4, 32768), (1, 8)):
        tspec, jspec = TK.cache_spec_tree(tcfg, b, s), \
            JK.cache_spec_tree(jcfg, b, s)
        assert set(tspec) == set(jspec)
        for name, (shape, dtype) in tspec.items():
            assert shape == jspec[name][0]
            assert str(dtype).split(".")[-1] == np.dtype(
                jspec[name][1]).name
        assert TK.cache_bytes(tcfg, b, s) == JK.cache_bytes(jcfg, b, s)


# --------------------------------------------------------------- backbone

@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_run_backbone_with_aux(case, mode):
    """All layers in each mode: hidden states, the cache entries (decode:
    written in place) and the aux losses summed over layers, against
    JAX's."""
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    rng = np.random.default_rng(17)
    b = 3
    s = 1 if mode == "decode" else 40
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    if mode == "decode":
        lengths = np.array([5, 17, 30], np.int32)
        pos = (lengths - 1)[:, None]
        jc = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
              if v.dtype == jnp.float32 else np.asarray(v)
              for k, v in JK.init_cache(jcfg, b, 32).items()}
        tc = {k: _t(v) for k, v in jc.items() if k != "lengths"}
        th, tnew, taux = TT.run_backbone(tcfg, tp["backbone"], _t(x),
                                         mode=mode, positions=_t(pos),
                                         cache=tc, lengths=_t(lengths))
        jh, jnew, jaux = JT.run_backbone(
            jcfg, jp["backbone"], jnp.array(x), mode=mode,
            positions=jnp.array(pos),
            cache={k: jnp.array(v) for k, v in jc.items()},
            lengths=jnp.array(lengths))
        for name in jnew:
            assert tnew[name] is tc[name]
    else:
        pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
        th, tnew, taux = TT.run_backbone(tcfg, tp["backbone"], _t(x),
                                         mode=mode, positions=_t(pos))
        jh, jnew, jaux = JT.run_backbone(jcfg, jp["backbone"], jnp.array(x),
                                         mode=mode,
                                         positions=jnp.array(pos))
    _close(th, jh)
    assert set(tnew) == set(jnew)
    for name in tnew:
        _close(tnew[name], jnew[name])
    assert set(taux) == set(jaux)
    for k in taux:
        assert torch.is_tensor(taux[k]) and taux[k].dtype == torch.float32
        _close(taux[k], jaux[k])
        assert float(taux[k]) > 0


def test_aux_sums_each_layers_losses():
    """The backbone's aux is the sum of each layer's apply_moe aux on its
    own input (the port's layers run one by one)."""
    tcfg, _ = _cfgs("dbrx")
    _, tp = _weights("dbrx")
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(12)[None].expand(2, 12)
    seen = []
    real = TT.apply_moe

    def recording(cfg, p, h, *ctx):
        y, aux = real(cfg, p, h, *ctx)
        seen.append(aux)
        return y, aux

    TT.apply_moe = recording
    try:
        _, _, aux = TT.run_backbone(tcfg, tp["backbone"], x, mode="train",
                                    positions=pos)
    finally:
        TT.apply_moe = real
    assert len(seen) == tcfg.n_layers
    for k in aux:
        torch.testing.assert_close(aux[k], sum(a[k] for a in seen),
                                   rtol=0, atol=0)


# ------------------------------------------------------- the whole model

def _close_cache(tcache, jcache):
    assert set(tcache) == set(jcache)
    for name in jcache:
        assert tuple(tcache[name].shape) == np.shape(jcache[name]), name
        if name == "lengths":
            np.testing.assert_array_equal(_np(tcache[name]),
                                          _np(jcache[name]))
        else:
            _close(tcache[name], jcache[name])


@pytest.mark.parametrize("case", ALL)
def test_prefill_then_decode_matches(case):
    """Prefill 40 tokens into a cache of 64 slots (capacity drops in the
    prefill's routing), then 3 decode steps: logits and every cache entry
    against JAX's after prefill and after each step."""
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    toks = _tokens(tcfg, 2, 43, seed=7)
    jcache = JK.init_cache(jcfg, 2, 64)
    jl, jcache = JM.forward_prefill(jcfg, jp, {"tokens": jnp.array(
        toks[:, :40])}, jcache)
    tcache = TK.init_cache(tcfg, 2, 64, device="cpu")
    tl, tcache2 = TM.forward_prefill(tcfg, tp, {"tokens": _t(toks[:, :40])},
                                     tcache)
    assert tcache2 is tcache
    _close(tl, jl, LOGIT_TOL)
    _close_cache(tcache, jcache)
    for i in range(40, 43):
        jl, jcache = JM.forward_decode(jcfg, jp, jnp.array(toks[:, i:i + 1]),
                                       jcache)
        tl, tcache = TM.forward_decode(tcfg, tp, _t(toks[:, i:i + 1]),
                                       tcache)
        _close(tl, jl, LOGIT_TOL)
        _close_cache(tcache, jcache)
    assert tcache["lengths"].tolist() == [43, 43]


@pytest.mark.parametrize("case", ["dbrx", "arctic"])
def test_greedy_ids_through_steps(case):
    """launch/steps' prefill and decode against JAX's, greedy ids for 6
    steps."""
    from repro.launch import steps as jsteps
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    toks = _tokens(tcfg, 3, 36, seed=8)
    jl, jc = jsteps.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.array(toks)}, JK.init_cache(jcfg, 3, 64))
    tl, tc = tsteps.make_prefill_step(tcfg)(
        tp, {"tokens": _t(toks)}, TK.init_cache(tcfg, 3, 64, device="cpu"))
    jdecode, tdecode = (jsteps.make_decode_step(jcfg),
                        tsteps.make_decode_step(tcfg))
    jids, tids = [], []
    for _ in range(6):
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = tl.argmax(-1)[:, None].to(torch.int32)
        jids.append(np.asarray(jt)[:, 0])
        tids.append(tt[:, 0].numpy())
        jl, jc = jdecode(jp, jt, jc)
        tl, tc = tdecode(tp, tt, tc)
    np.testing.assert_array_equal(np.stack(tids, 1), np.stack(jids, 1))
    _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("case", ["dbrx", "arctic"])
def test_decode_step_moe_has_no_drops(case):
    """A decode step's MoE at B 4 drops nothing (4 tokens x top-k against
    a capacity of at least 8), so it equals the no-capacity reference
    layer by layer, as chip_smoke holds it on the card."""
    tcfg, _ = _cfgs(case)
    _, tp = _weights(case)
    toks = _tokens(tcfg, 4, 21, seed=11)
    cache = TK.init_cache(tcfg, 4, 32, device="cpu")
    _, cache = TM.forward_prefill(tcfg, tp, {"tokens": _t(toks[:, :20])},
                                  cache)
    seen = []
    real = TT.apply_moe

    def recording(cfg, p, h, *ctx):
        y, aux = real(cfg, p, h, *ctx)
        seen.append((p, h, y))
        return y, aux

    TT.apply_moe = recording
    try:
        TM.forward_decode(tcfg, tp, _t(toks[:, 20:]), cache)
    finally:
        TT.apply_moe = real
    assert len(seen) == tcfg.n_layers
    for p, h, y in seen:
        assert TMOE.capacity(tcfg, 4) >= 4 * tcfg.experts_per_token
        _close(y, TMOE.apply_moe_no_capacity(tcfg, p, h))


@pytest.mark.parametrize("case", ALL)
def test_probe_features_match(case):
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    toks = _tokens(tcfg, 2, 24, seed=10)
    x = JM.embed_tokens(jp["embed"], jnp.array(toks), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(24)[None], (2, 24))
    h, _, _ = JT.run_backbone(jcfg, jp["backbone"], x, mode="train",
                              positions=pos)
    ref = JM.rmsnorm(h, jp["final_ln"]).reshape(-1, jcfg.d_model)
    _close(TM.probe_features(tcfg, tp, _t(toks)), ref)
