"""The port's SSM and hybrid families against the JAX package's: the gated
norm, the causal conv, ``_segsum``, the chunked SSD scan, the Mamba2 block
in its three modes, zamba2's shared block with its LoRA deltas, the
backbones, the caches, and mamba2-370m / zamba2-7b whole, each at its
config's ``smoke()`` in fp32.

Inputs come from numpy with a seed; JAX's weights go across with
``params_from_numpy``.  JAX initialises the hybrid's LoRA ``b_*`` to zero,
so they are drawn at random here (in both packages' trees) to exercise
the delta.  Tolerance: 1e-5 of the reference's largest magnitude per
module and cache entry (``MODULE_TOL``), 1e-4 for logits after the whole
model (``LOGIT_TOL``), and JAX's own bound (rtol = atol = 2e-2) for decode
against the full forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as JC
import repro.models.kvcache as JK
import repro.models.model as JM
import repro.models.params as JP
import repro.models.ssm as JS
import repro.models.transformer as JT
from repro.configs.registry import get as jget

import repro_torch.models.common as TC
import repro_torch.models.kvcache as TK
import repro_torch.models.model as TM
import repro_torch.models.params as TP
import repro_torch.models.ssm as TS
import repro_torch.models.transformer as TT
from repro_torch.configs.registry import get as tget
from repro_torch.launch import steps as tsteps

MODULE_TOL = 1e-5
LOGIT_TOL = 1e-4
JAX_RTOL = JAX_ATOL = 2e-2         # tests/test_models_smoke.py

CASES = {"mamba2": "mamba2-370m", "zamba2": "zamba2-7b"}
ALL = list(CASES)

FULL_PARAMS = {"mamba2-370m": 368_494_080, "zamba2-7b": 5_773_198_656}


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
    return tget(CASES[case]).smoke(), jget(CASES[case]).smoke()


_WEIGHTS = {}


def _weights(case):
    """JAX's random weights for the case (seeded by its name; the hybrid's
    LoRA ``b_*`` and the SSM's ``a_log`` / ``dt_bias`` / ``conv_b``,
    which JAX starts at 0, drawn at random), as JAX's tree and carried
    into the port's."""
    if case not in _WEIGHTS:
        tcfg, jcfg = _cfgs(case)
        jp = JM.init_model(jcfg, jax.random.PRNGKey(sum(map(ord, case))))
        npp = jax.tree_util.tree_map(np.asarray, jp)
        rng = np.random.default_rng(sum(map(ord, case)))

        def rand(path, a):
            name = path[-1].key
            if name.startswith("b_"):
                return (0.05 * rng.standard_normal(a.shape)).astype(a.dtype)
            if name in ("a_log", "dt_bias", "conv_b"):
                return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
            return a

        npp = jax.tree_util.tree_map_with_path(rand, npp)
        jp = jax.tree_util.tree_map(jnp.array, npp)
        _WEIGHTS[case] = jp, TP.params_from_numpy(tcfg, npp, device="cpu")
    return _WEIGHTS[case]


def _mamba_params(case, *index):
    """One Mamba2 block's params (``ln``, ``ssm``) of the stack."""
    jp, tp = _weights(case)
    key = "layers" if case == "mamba2" else "units"
    jb, tb = jp["backbone"][key], tp["backbone"][key]
    if case == "zamba2":
        jb, tb = jb["mamba"], tb["mamba"]
    for i in index:
        jb = jax.tree_util.tree_map(lambda a: a[i], jb)
        tb = TP.tree_map(lambda t: t[i], tb)
    return jb, tb


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    z = rng.standard_normal((2, 5, 48)).astype(np.float32) * 2
    w = rng.standard_normal(48).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = JC.gated_rmsnorm(jnp.array(x, jdt), jnp.array(z, jdt),
                           jnp.array(w, jdt))
    out = TC.gated_rmsnorm(_t(x).to(tdt), _t(z).to(tdt), _t(w).to(tdt))
    assert out.dtype == tdt
    if dtype == "float32":
        _close(out, ref)
    else:
        # bf16: the same two roundings (the norm's, the gate's), and the
        # product's; at most one bf16 ulp apart.
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("s,with_state", [(9, False), (9, True), (2, True),
                                          (1, True), (1, False)])
def test_causal_conv(s, with_state):
    """y and the new state (the last K-1 rows of [state | x]: state rows
    too when S < K-1)."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    y, ns = TS._causal_conv(_t(x), _t(w), _t(b),
                            None if st is None else _t(st))
    jy, jns = JS._causal_conv(jnp.array(x), jnp.array(w), jnp.array(b),
                              None if st is None else jnp.array(st))
    _close(y, jy)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))
    if with_state and s < 3:
        np.testing.assert_array_equal(ns[:, :3 - s].numpy(), st[:, s:])


def test_segsum():
    a = np.random.default_rng(1).standard_normal((2, 3, 7)).astype(
        np.float32)
    out, ref = TS._segsum(_t(a)).numpy(), np.asarray(JS._segsum(
        jnp.array(a)))
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert fin.sum() == 2 * 3 * 28
    _close(out[fin], ref[fin])


@pytest.mark.parametrize("s,chunk,h0", [
    (32, 16, False),    # a chunk multiple
    (37, 16, False),    # a ragged tail (padded with dt = 0)
    (10, 16, False),    # shorter than a chunk
    (37, 16, True),     # from a non-zero state
    (10, 10, True),     # apply_ssm's chunk = min(ssm_chunk, S)
])
def test_ssd_chunked(s, chunk, h0):
    rng = np.random.default_rng(s + chunk)
    b, h, p, g, n = 2, 4, 8, 2, 6
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.5
    a_neg = -np.abs(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) if h0 \
        else None
    y, hf = TS.ssd_chunked(_t(x), _t(dt), _t(a_neg), _t(bm), _t(cm),
                           chunk=chunk, h0=None if st is None else _t(st))
    jy, jhf = JS.ssd_chunked(jnp.array(x), jnp.array(dt), jnp.array(a_neg),
                             jnp.array(bm), jnp.array(cm), chunk=chunk,
                             h0=None if st is None else jnp.array(st))
    assert y.dtype == torch.float32 and hf.dtype == torch.float32
    _close(y, jy)
    _close(hf, jhf)


def test_ssd_chunked_is_the_recurrence():
    """The chunked scan equals the step-by-step recurrence h ← h·exp(dt·A)
    + B ⊗ x·dt, y = C·h (the decode update), from a non-zero state."""
    rng = np.random.default_rng(4)
    b, s, h, p, n = 2, 21, 3, 4, 5
    x = torch.tensor(rng.standard_normal((b, s, h, p)), dtype=torch.float32)
    dt = torch.tensor(np.abs(rng.standard_normal((b, s, h))) * 0.3,
                      dtype=torch.float32)
    a_neg = -torch.tensor(np.abs(rng.standard_normal(h)), dtype=torch.float32)
    bm = torch.tensor(rng.standard_normal((b, s, 1, n)), dtype=torch.float32)
    cm = torch.tensor(rng.standard_normal((b, s, 1, n)), dtype=torch.float32)
    hs = torch.tensor(rng.standard_normal((b, h, p, n)), dtype=torch.float32)
    y, hf = TS.ssd_chunked(x, dt, a_neg, bm, cm, chunk=8, h0=hs)
    ys = []
    for t in range(s):
        hs = hs * torch.exp(dt[:, t] * a_neg)[..., None, None] + \
            x[:, t][..., None] * bm[:, t, 0][:, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", hs, cm[:, t, 0]))
    _close(y, torch.stack(ys, 1))
    _close(hf, hs)


@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("mode,s,states", [
    ("train", 37, False), ("prefill", 37, True), ("prefill", 5, False),
    ("decode", 1, True), ("decode", 1, False)])
def test_apply_ssm(case, mode, s, states):
    tcfg, jcfg = _cfgs(case)
    jb, tb = _mamba_params(case, *((0,) if case == "mamba2" else (1, 0)))
    rng = np.random.default_rng(s)
    din, nh, conv_dim = TS.ssm_dims(tcfg)
    b = 2
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    cs = ss = None
    if states:
        cs = rng.standard_normal((b, tcfg.ssm_conv - 1, conv_dim)).astype(
            np.float32)
        ss = rng.standard_normal((b, nh, tcfg.ssm_head_dim,
                                  tcfg.ssm_state)).astype(np.float32)
    y, (c2, s2) = TS.apply_ssm(
        tcfg, tb["ssm"], _t(x), conv_state=None if cs is None else _t(cs),
        ssm_state=None if ss is None else _t(ss), mode=mode)
    jy, (jc2, js2) = JS.apply_ssm(
        jcfg, jb["ssm"], jnp.array(x),
        conv_state=None if cs is None else jnp.array(cs),
        ssm_state=None if ss is None else jnp.array(ss), mode=mode)
    _close(y, jy)
    _close(c2, jc2)
    assert s2.dtype == torch.float32
    _close(s2, js2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_attn_params_adds_the_lora_delta(dtype):
    """w + a @ b on wq / wk / wv, in the parameters' dtype, once per unit;
    the other shared weights untouched."""
    jp, tp = _weights("zamba2")
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jshared = jax.tree_util.tree_map(lambda a: a.astype(jdt),
                                     jp["backbone"]["shared"])
    tshared = TP.tree_map(lambda t: t.to(tdt), tp["backbone"]["shared"])
    for u in range(2):
        jl = jax.tree_util.tree_map(lambda a: a[u].astype(jdt),
                                    jp["backbone"]["units"]["lora"])
        tl = TP.tree_map(lambda t: t[u].to(tdt),
                         tp["backbone"]["units"]["lora"])
        assert float(np.abs(np.asarray(jl["b_q"], np.float32)).max()) > 0
        out = TT._shared_attn_params(tshared, tl)
        ref = JT._shared_attn_params(jshared, jl)
        for w in ("wq", "wk", "wv"):
            assert out["attn"][w].dtype == tdt
            d = out["attn"][w].float() - tshared["attn"][w].float()
            assert d.abs().max().item() > 0
            if dtype == "float32":
                _close(out["attn"][w], ref["attn"][w])
            else:
                np.testing.assert_allclose(
                    out["attn"][w].float().numpy(),
                    np.asarray(ref["attn"][w], np.float32), rtol=2 ** -7,
                    atol=0)
        assert out["attn"]["wo"] is tshared["attn"]["wo"]
        assert out["ffn"] is tshared["ffn"]
        assert tshared["attn"]["wq"] is not out["attn"]["wq"]


# ------------------------------------------------------- defs and caches

def _jdefs(cfg):
    return {".".join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(
                JM.model_defs(cfg),
                is_leaf=lambda x: isinstance(x, JP.ParamDef))[0]}


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_model_defs_match(arch):
    for tcfg, jcfg in ((tget(arch), jget(arch)),
                       (tget(arch).smoke(), jget(arch).smoke())):
        td = dict(TP.tree_items(TM.model_defs(tcfg)))
        jd = _jdefs(jcfg)
        assert set(td) == set(jd)
        for name in td:
            assert dataclasses.astuple(td[name]) == dataclasses.astuple(
                jd[name]), name
    n = TP.count_params(TM.model_defs(tget(arch)))
    assert n == JP.count_params(JM.model_defs(jget(arch))) == \
        FULL_PARAMS[arch]


@pytest.mark.parametrize("case", ALL)
def test_params_from_numpy_carries_the_nested_tree(case):
    jp, tp = _weights(case)
    jnames = {".".join(k.key for k in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    tnames = dict(TP.tree_items(tp))
    assert set(jnames) == set(tnames)
    for name, v in jnames.items():
        np.testing.assert_array_equal(tnames[name].numpy(), np.asarray(v))
    if case == "zamba2":
        tcfg, _ = _cfgs(case)
        assert tuple(tnames["backbone.units.mamba.ssm.in_proj"].shape[:2]) \
            == (tcfg.hybrid_units, tcfg.mamba_per_unit)
        assert "backbone.units.lora.b_v" in tnames
        assert "backbone.shared.attn.wq" in tnames
        assert "backbone.tail.ln" in tnames
    bad = jax.tree_util.tree_map(np.asarray, jp)
    key = "layers" if case == "mamba2" else "units"
    bad["backbone"][key] = dict(bad["backbone"][key])
    bad["backbone"][key].pop("ln" if case == "mamba2" else "lora")
    with pytest.raises(ValueError, match="missing"):
        TP.params_from_numpy(_cfgs(case)[0], bad, device="cpu")


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
@pytest.mark.parametrize("b,s", [(4, 32768), (2, 64), (1, 524288)])
def test_cache_layout_matches(arch, b, s):
    """Names, shapes and dtypes and bytes equal to JAX's at full size
    (shapes only, nothing allocated); mamba2's is constant in S."""
    tcfg, jcfg = tget(arch), jget(arch)
    tspec, jspec = TK.cache_spec_tree(tcfg, b, s), JK.cache_spec_tree(
        jcfg, b, s)
    assert set(tspec) == set(jspec)
    for name, (shape, dtype) in tspec.items():
        assert shape == jspec[name][0], name
        assert str(dtype).split(".")[-1] == np.dtype(jspec[name][1]).name
    assert TK.cache_bytes(tcfg, b, s) == JK.cache_bytes(jcfg, b, s)
    if arch == "mamba2-370m":
        assert TK.cache_bytes(tcfg, b, s) == TK.cache_bytes(tcfg, b, 8)
        assert tspec["ssm"][1] == torch.float32
        assert tspec["conv"][1] == torch.bfloat16


def test_cache_bytes_of_the_two_models():
    """mamba2's 48 layers of states at B 4 (constant in S); zamba2's 13
    shared-attention K/V of 32,768 slots."""
    assert TK.cache_bytes(tget("mamba2-370m"), 4, 32768) == 203_980_816
    assert TK.cache_bytes(tget("zamba2-7b"), 4, 32768) == 24_938_655_760


@pytest.mark.parametrize("case", ALL)
def test_init_cache_and_cache_from_numpy(case):
    tcfg, jcfg = _cfgs(case)
    cache = TK.init_cache(tcfg, 2, 64, device="cpu")
    assert all(not bool(t.any()) for t in cache.values())
    jc = {k: np.asarray(v) for k, v in JK.init_cache(jcfg, 2, 64).items()}
    back = TK.cache_from_numpy(tcfg, jc, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in back.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
    bad = dict(jc, ssm=jc["ssm"][..., :1])
    with pytest.raises(ValueError, match="ssm"):
        TK.cache_from_numpy(tcfg, bad, device="cpu")


def test_max_len_of_an_ssm_cache_sizes_nothing():
    """mamba2's cache has no slots: ``_max_len_of`` falls through to its
    max_cache_len (524,288), and its layout is the same at every length."""
    cfg = tget("mamba2-370m")
    spec = TK.cache_spec_tree(cfg, 2, 8)
    cache = {k: np.zeros(shape, np.float32 if dt == torch.float32
                         else np.int32 if dt == torch.int32 else np.float16)
             for k, (shape, dt) in spec.items()}
    assert TK._max_len_of(cfg, cache) == cfg.max_cache_len == 524_288
    assert TK.cache_spec_tree(cfg, 2, cfg.max_cache_len) == spec
    assert TK._max_len_of(tget("zamba2-7b"), {"k": np.zeros(
        (13, 2, 96, 8))}) == 96


# --------------------------------------------------------------- backbone

def _states_cache(tcfg, jcfg, b, max_len, rng):
    """A random (non-zero) cache of the family's layout, as numpy."""
    out = {}
    for k, (shape, dt, _) in JK.cache_spec_tree(jcfg, b, max_len).items():
        out[k] = (np.full(shape, 0, np.int32) if k == "lengths" else
                  rng.standard_normal(shape).astype(np.float32))
    return out


@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_run_backbone(case, mode):
    """All layers in each mode from a random cache: hidden states and every
    cache entry (written in place) against JAX's.  The SSM family's
    prefill starts from the cache's states, the hybrid's from zeros, as
    JAX's do; aux stays zero."""
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    rng = np.random.default_rng(23)
    b, max_len = 3, 48
    s = 1 if mode == "decode" else 37
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    jc = _states_cache(tcfg, jcfg, b, max_len, rng)
    lengths = None
    if mode == "decode":
        lengths = np.array([4, 20, 48], np.int32)
        pos = (lengths - 1)[:, None]
    else:
        pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    tc = {k: _t(v) for k, v in jc.items()}
    th, tnew, taux = TT.run_backbone(
        tcfg, tp["backbone"], _t(x), mode=mode, positions=_t(pos),
        cache=None if mode == "train" else tc,
        lengths=None if lengths is None else _t(lengths))
    jh, jnew, jaux = JT.run_backbone(
        jcfg, jp["backbone"], jnp.array(x), mode=mode,
        positions=jnp.array(pos),
        cache=None if mode == "train" else {k: jnp.array(v)
                                            for k, v in jc.items()},
        lengths=None if lengths is None else jnp.array(lengths))
    _close(th, jh)
    assert taux == {k: float(v) for k, v in jaux.items()} == {
        "load_balance": 0.0, "router_z": 0.0}
    assert set(tnew) == set(jnew)
    for name in jnew:
        assert tnew[name] is tc[name]
        ref = np.asarray(jnew[name])
        if mode == "prefill" and name in ("k", "v"):
            # JAX returns the produced S slots; the cache's are zeroed past.
            assert not bool(tnew[name][:, :, s:].any())
            _close(tnew[name][:, :, :s], ref)
        else:
            _close(tnew[name], ref)


@pytest.mark.parametrize("case", ALL)
def test_prefill_without_a_cache_stacks_the_states(case):
    """Prefill with no cache: the produced states (and the hybrid's K/V)
    stacked over the layer dims, as from zeroed states."""
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    x = np.random.default_rng(29).standard_normal(
        (2, 21, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(21)[None], (2, 21)).astype(np.int32)
    th, tnew, _ = TT.run_backbone(tcfg, tp["backbone"], _t(x),
                                  mode="prefill", positions=_t(pos))
    jcache = JK.init_cache(jcfg, 2, 21)
    jh, jnew, _ = JT.run_backbone(jcfg, jp["backbone"], jnp.array(x),
                                  mode="prefill", positions=jnp.array(pos),
                                  cache=jcache)
    _close(th, jh)
    assert set(tnew) == set(jnew)
    for name in jnew:
        _close(tnew[name], jnew[name])


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
@pytest.mark.parametrize("prompt", [40, 12])
def test_prefill_then_decode_matches(case, prompt):
    """Prefill (40 tokens: two chunks and a ragged tail; 12: shorter than
    a chunk), then 3 decode steps: logits and every cache entry against
    JAX's after prefill and after each step."""
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    toks = _tokens(tcfg, 2, prompt + 3, seed=7)
    jcache = JK.init_cache(jcfg, 2, 64)
    jl, jcache = JM.forward_prefill(jcfg, jp, {"tokens": jnp.array(
        toks[:, :prompt])}, jcache)
    tcache = TK.init_cache(tcfg, 2, 64, device="cpu")
    tl, tcache2 = TM.forward_prefill(tcfg, tp, {"tokens": _t(
        toks[:, :prompt])}, tcache)
    assert tcache2 is tcache
    _close(tl, jl, LOGIT_TOL)
    _close_cache(tcache, jcache)
    for i in range(prompt, prompt + 3):
        jl, jcache = JM.forward_decode(jcfg, jp, jnp.array(toks[:, i:i + 1]),
                                       jcache)
        tl, tcache = TM.forward_decode(tcfg, tp, _t(toks[:, i:i + 1]),
                                       tcache)
        _close(tl, jl, LOGIT_TOL)
        _close_cache(tcache, jcache)
    assert tcache["lengths"].tolist() == [prompt + 3] * 2


@pytest.mark.parametrize("case", ALL)
def test_prefill_into_a_used_cache(case):
    """The SSM family's prefill continues from the states in the cache it
    is given (JAX's scan reads them), the hybrid's starts from zeros: both
    as JAX's, on a cache a first prefill left behind."""
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    toks = _tokens(tcfg, 2, 30, seed=12)
    jcache = JK.init_cache(jcfg, 2, 64)
    tcache = TK.init_cache(tcfg, 2, 64, device="cpu")
    for lo, hi in ((0, 18), (18, 30)):
        jl, jcache = JM.forward_prefill(jcfg, jp, {"tokens": jnp.array(
            toks[:, lo:hi])}, jcache)
        tl, tcache = TM.forward_prefill(tcfg, tp, {"tokens": _t(
            toks[:, lo:hi])}, tcache)
        _close(tl, jl, LOGIT_TOL)
        _close_cache(tcache, jcache)
    fresh = TK.init_cache(tcfg, 2, 64, device="cpu")
    lf, _ = TM.forward_prefill(tcfg, tp, {"tokens": _t(toks[:, 18:30])},
                               fresh)
    assert (case == "zamba2") == bool(torch.allclose(lf, tl, atol=1e-6,
                                                      rtol=0))


@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("prompt", [32, 37])
def test_decode_matches_full_forward(case, prompt):
    """Prefill S tokens, decode token S + 1 from the cache, against one
    full forward at that position: JAX's test_decode_matches_forward bound
    (and the fp32 logit tolerance); S = 37 leaves a ragged chunk."""
    tcfg, _ = _cfgs(case)
    _, tp = _weights(case)
    toks = _tokens(tcfg, 2, prompt + 1, seed=9)
    cache = TK.init_cache(tcfg, 2, tcfg.max_cache_len, device="cpu")
    _, cache = TM.forward_prefill(tcfg, tp, {"tokens": _t(toks[:, :prompt])},
                                  cache)
    la, _ = TM.forward_decode(tcfg, tp, _t(toks[:, prompt:]), cache)
    lb = TM.forward_logits(tcfg, tp, _t(toks))[:, -1]
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    _close(la, lb, LOGIT_TOL)
    torch.testing.assert_close(TM.forward_logits(tcfg, tp, _t(toks),
                                                 at=prompt), lb,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ALL)
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


@pytest.mark.parametrize("case", ALL)
def test_probe_features_on_bf16_weights(case):
    """fp32 activations against bf16 weights: JAX promotes each product
    to fp32, the port casts the weight up; the SSD runs in fp32 in both.
    JAX's reference runs op by op (``jax.disable_jit``): compiled, XLA
    drops the bf16 rounding of the hybrid's ``w + a @ b`` where an fp32
    product consumes it (2.8e-3 of the features' magnitude at this size),
    while JAX's code, and the port, form the sum in bf16."""
    tcfg, jcfg = _cfgs(case)
    jp, _ = _weights(case)
    j16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = TP.params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, j16),
                              device="cpu")
    toks = _tokens(tcfg, 2, 24, seed=10)
    with jax.disable_jit():
        x = JC.embed_tokens(j16["embed"], jnp.array(toks), jnp.float32)
        pos = jnp.broadcast_to(jnp.arange(24)[None], (2, 24))
        h, _, _ = JT.run_backbone(jcfg, j16["backbone"], x, mode="train",
                                  positions=pos)
        ref = JC.rmsnorm(h, j16["final_ln"]).reshape(-1, jcfg.d_model)
    feats = TM.probe_features(tcfg, tp, _t(toks))
    assert feats.dtype == torch.float32
    _close(feats, ref)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b",
                                  "dbrx-132b", "arctic-480b"])
def test_make_smoke_batch_and_init_on_cpu(arch):
    """The smoke batch's layout is JAX's; the port's own init is seeded
    and has JAX's tree (the LoRA ``b_*`` zero, as JAX's law)."""
    tcfg, jcfg = tget(arch).smoke(), jget(arch).smoke()
    tb = TM.make_smoke_batch(tcfg, seed=1, batch=3, seq=11, device="cpu")
    jb = JM.make_smoke_batch(jcfg, jax.random.PRNGKey(1), batch=3, seq=11)
    assert set(tb) == set(jb)
    for k in tb:
        assert tuple(tb[k].shape) == jb[k].shape and tb[k].dtype == \
            torch.int32
    a = TM.init_model(tcfg, seed=2, device="cpu")
    b = TM.init_model(tcfg, seed=2, device="cpu")
    for (na, ta), (_, tb_) in zip(TP.tree_items(a), TP.tree_items(b)):
        torch.testing.assert_close(ta, tb_, rtol=0, atol=0, msg=na)
    assert set(dict(TP.tree_items(a))) == set(_jdefs(jcfg))
    if arch == "zamba2-7b":
        assert not bool(a["backbone"]["units"]["lora"]["b_q"].any())


def test_chunked_init_draws(monkeypatch):
    """A tensor past the whole-draw size is drawn in flat fp32 chunks and
    cast: the same law (std, dtype, shape), seeded; tensors under it are
    drawn whole, as before."""
    d = TP.ParamDef((3, 64, 96), ("layers", "embed", "model"), "normal",
                    scale=2.0)
    whole = TP.init_params({"w": d}, torch.Generator().manual_seed(0),
                           torch.bfloat16)["w"]
    monkeypatch.setattr(TP, "_DRAW_WHOLE_BYTES", 4 * 1000)
    monkeypatch.setattr(TP, "_DRAW_CHUNK_BYTES", 4 * 4096)
    a = TP.init_params({"w": d}, torch.Generator().manual_seed(0),
                       torch.bfloat16)["w"]
    b = TP.init_params({"w": d}, torch.Generator().manual_seed(0),
                       torch.bfloat16)["w"]
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == d.shape
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = 2.0 / np.sqrt(64)
    v = a.float().numpy()
    assert abs(v.std() / want - 1) < 0.02 and abs(v.mean()) < 5 * want / \
        np.sqrt(v.size)
    # The chunks are consecutive draws from one generator: the flat stream
    # is the whole draw's.
    torch.testing.assert_close(a, whole, rtol=0, atol=0)
