"""The port's attention and cache variants against the JAX package's, module
by module and as whole models: the SWA ring (h2o-danube-1.8b), gemma2's
local/global pairs with softcaps and post-norms (gemma2-9b), MLA's latent
cache (minicpm3-4b), M-RoPE (qwen2-vl-2b), and the int8 KV cache (on
qwen3-8b and on danube's ring), each at its config's ``smoke()`` in fp32.

Inputs come from numpy with a seed; JAX's weights go across with
``params_from_numpy``.  Tolerance: 1e-5 of the reference's largest
magnitude per module and per cache entry (``MODULE_TOL``), 1e-4 for logits
after the whole model; int8 codes equal, where a code may differ by 1 on
at most 0.1% of the entries (a .5 tie that the fp32 rounding of its
input tips); JAX's own bounds for decode against the full forward (rtol =
atol = 2e-2) and for int8 against the fp cache (greedy tokens equal,
log-softmax within 0.15).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro.models.common as JC
import repro.models.kvcache as JK
import repro.models.model as JM
import repro.models.params as JP
import repro.models.transformer as JT
from repro.configs.registry import get as jget

import repro_torch.models.attention as TA
import repro_torch.models.common as TC
import repro_torch.models.kvcache as TK
import repro_torch.models.model as TM
import repro_torch.models.params as TP
import repro_torch.models.transformer as TT
from repro_torch.configs.registry import get as tget
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps

MODULE_TOL = 1e-5
LOGIT_TOL = 1e-4
JAX_RTOL = JAX_ATOL = 2e-2         # tests/test_models_smoke.py
INT8_LOGSOFTMAX_GAP = 0.15         # tests/test_kv_quant.py

# name: (arch, changes to its smoke config)
CASES = {
    "danube": ("h2o-danube-1.8b", {}),
    "gemma2": ("gemma2-9b", {}),
    "gemma2_2pairs": ("gemma2-9b", {"n_layers": 4}),
    "minicpm3": ("minicpm3-4b", {}),
    "qwen2vl": ("qwen2-vl-2b", {}),
    "qwen3_int8": ("qwen3-8b", {"kv_quant": "int8"}),
    "danube_int8": ("h2o-danube-1.8b", {"kv_quant": "int8"}),
}
MODELS = ["danube", "gemma2", "minicpm3", "qwen2vl"]
ALL = list(CASES)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(port, ref, tol=MODULE_TOL):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    port, ref = port.astype(np.float64), ref.astype(np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(port - ref).max() / scale
    assert err <= tol, f"max |port - ref| = {err:.3g} of max |ref|"


def _close_codes(port, ref):
    """int8 codes: equal, or 1 apart on at most 0.1% of the entries."""
    port, ref = _np(port), _np(ref)
    assert port.dtype == np.int8 and ref.dtype == np.int8
    assert port.shape == ref.shape
    d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).sum() <= 1e-3 * d.size, (d > 0).sum()


def _close_entry(port, ref):
    if _np(ref).dtype == np.int8:
        _close_codes(port, ref)
    elif _np(ref).dtype == np.int32:
        np.testing.assert_array_equal(_np(port), _np(ref))
    else:
        _close(port, ref)


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
    tree and carried into the port's; int8 cases share their base's."""
    tcfg, jcfg = _cfgs(case)
    key = (tcfg.name, tcfg.n_layers)
    if key not in _WEIGHTS:
        jp = JM.init_model(jcfg, jax.random.PRNGKey(sum(map(ord, key[0]))))
        npp = jax.tree_util.tree_map(np.asarray, jp)
        _WEIGHTS[key] = jp, TP.params_from_numpy(tcfg, npp, device="cpu")
    return _WEIGHTS[key]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _positions(cfg, b, s, seed=0, mixed=False):
    """(B, S) positions 0..S-1, or JAX's (3, B, S) M-RoPE streams; with
    ``mixed`` the h and w streams are random (a stubbed image's grid)."""
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    if cfg.family != "vlm":
        return pos
    pos = np.broadcast_to(pos[None], (3, b, s)).copy()
    if mixed:
        pos[1:] = np.random.default_rng(seed).integers(0, s, (2, b, s))
    return pos


def _stack(tree, i):
    return {k: _stack(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ------------------------------------------------------- defs and layout

FULL_PARAMS = {"h2o-danube-1.8b": 1_831_201_280,
               "gemma2-9b": 9_241_705_984,
               "minicpm3-4b": 4_262_025_728,
               "qwen2-vl-2b": 1_543_853_568}


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
def test_params_from_numpy_carries_the_tree(case):
    jp, tp = _weights(case)
    jleaves = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    jnames = {".".join(k.key for k in path): v for path, v in jleaves.items()}
    tnames = dict(TP.tree_items(tp))
    assert set(jnames) == set(tnames)
    for name, v in jnames.items():
        assert tuple(tnames[name].shape) == v.shape, name
        np.testing.assert_array_equal(tnames[name].numpy(), np.asarray(v))
    if case.startswith("gemma2"):
        assert "backbone.pairs.local.post1" in tnames
        assert "backbone.pairs.global.attn.wq" in tnames
        assert "embed.out" not in tnames            # tied
    if case == "minicpm3":
        assert "backbone.layers.attn.kv_down" in tnames


def _same_spec(tcfg, jcfg, b, s):
    tspec = TK.cache_spec_tree(tcfg, b, s)
    jspec = JK.cache_spec_tree(jcfg, b, s)
    assert set(tspec) == set(jspec)
    for name, (shape, dtype) in tspec.items():
        assert shape == jspec[name][0], name
        assert str(dtype).split(".")[-1] == np.dtype(jspec[name][1]).name
    assert TK.cache_bytes(tcfg, b, s) == JK.cache_bytes(jcfg, b, s)


@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("b,s", [(2, 64), (2, 24), (4, 32768)])
def test_cache_layout_matches(case, b, s):
    tcfg, jcfg = _cfgs(case)
    if s == 32768:
        arch, change = CASES[case]
        tcfg = dataclasses.replace(tget(arch), **change)
        jcfg = dataclasses.replace(jget(arch), **change)
    _same_spec(tcfg, jcfg, b, s)


def test_cache_bytes_of_the_four_models():
    """The serving caches at B 4 (JAX's ``cache_bytes``), the ring's
    constant memory, MLA's compression and int8's halving (JAX's bounds in
    test_models_smoke / test_kv_quant)."""
    gb = {a: TK.cache_bytes(tget(a), 4, 32768) for a in FULL_PARAMS}
    assert gb == {"h2o-danube-1.8b": 1_006_632_976,
                  "gemma2-9b": 25_367_150_608,
                  "minicpm3-4b": 4_680_843_280,
                  "qwen2-vl-2b": 3_758_096_400}
    danube = tget("h2o-danube-1.8b")
    assert TK.cache_bytes(danube, 4, 4096) == TK.cache_bytes(
        danube, 4, 524288) == TK.cache_bytes(danube, 4, 1 << 22)
    mla = tget("minicpm3-4b")
    per_head = (mla.n_layers * 32768 * mla.n_heads * (
        mla.qk_nope_dim + mla.qk_rope_dim + mla.v_head_dim) * 2 * 2)
    assert TK.cache_bytes(mla, 1, 32768) < per_head / 10
    q = tget("qwen3-8b")
    q8 = dataclasses.replace(q, kv_quant="int8")
    assert TK.cache_bytes(q8, 4, 32768) == 9_965_666_320
    assert TK.cache_bytes(q8, 128, 32768) < 0.6 * TK.cache_bytes(
        q, 128, 32768)


@pytest.mark.parametrize("case", ALL)
def test_init_cache_and_cache_from_numpy(case):
    tcfg, jcfg = _cfgs(case)
    cache = TK.init_cache(tcfg, 2, 64, device="cpu")
    assert all(not bool(t.any()) for t in cache.values())
    jc = {k: np.asarray(v) for k, v in JK.init_cache(jcfg, 2, 64).items()}
    back = TK.cache_from_numpy(tcfg, jc, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in back.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
    bad = dict(jc)
    name = sorted(k for k in jc if k != "lengths")[0]
    bad[name] = bad[name][:, :1]
    with pytest.raises(ValueError, match=name):
        TK.cache_from_numpy(tcfg, bad, device="cpu")


# --------------------------------------------------------------- modules

@pytest.mark.parametrize("sections,d", [((4, 2, 2), 16), ((16, 24, 24), 128)])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_mrope(sections, d, theta):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
    pos = rng.integers(0, 32768, (3, 2, 7)).astype(np.int32)
    _close(TC.apply_mrope(_t(x), _t(pos), theta, sections),
           JC.apply_mrope(jnp.array(x), jnp.array(pos), theta, sections))
    # Equal streams are RoPE.
    same = np.broadcast_to(pos[:1], pos.shape)
    _close(TC.apply_mrope(_t(x), _t(same), theta, sections),
           TC.apply_rope(_t(x), _t(pos[0]), theta))


def test_apply_mrope_bf16():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 512, (3, 2, 5)).astype(np.int32)
    out = TC.apply_mrope(_t(x, torch.bfloat16), _t(pos), 1e4, (4, 2, 2))
    ref = JC.apply_mrope(jnp.array(x, jnp.bfloat16), jnp.array(pos), 1e4,
                         (4, 2, 2))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("shape,scale", [((2, 5, 2, 16), 1.0),
                                         ((3, 1, 4, 8), 30.0),
                                         ((2, 6, 2, 16), 0.0)])
def test_quantize_and_dequantize_kv(shape, scale):
    rng = np.random.default_rng(len(shape) + int(scale))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    q, s = TA.quantize_kv(_t(x))
    jq, js = JA.quantize_kv(jnp.array(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        d = TA.dequantize_kv(q, s, dt)
        jd = JA.dequantize_kv(jq, js, jdt)
        assert d.dtype == dt
        np.testing.assert_array_equal(d.float().numpy(),
                                      np.asarray(jd, np.float32))


def test_quantize_kv_rounds_ties_to_even():
    """Codes at exact .5 ties: both round half to even."""
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                   np.float32)
    x = row[None, None, None]                   # scale exactly 1
    q, _ = TA.quantize_kv(_t(x))
    jq, _ = JA.quantize_kv(jnp.array(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.numpy().ravel().tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


def _attn_params(case, layer=0):
    jp, tp = _weights(case)
    if "pairs" in jp["backbone"]:
        return (_stack(jp["backbone"]["pairs"]["local"], layer)["attn"],
                _stack(tp["backbone"]["pairs"]["local"], layer)["attn"])
    return (_stack(jp["backbone"]["layers"], layer)["attn"],
            _stack(tp["backbone"]["layers"], layer)["attn"])


@pytest.mark.parametrize("case,window,smax", [
    ("qwen3_int8", 0, 10), ("danube_int8", 32, 32), ("danube_int8", 32, 12)])
def test_gqa_decode_quant(case, window, smax):
    """One int8 decode step, linear (slots clamp at Smax - 1) or ring
    (slot (lengths - 1) % Smax): output and every cache tensor, written in
    place."""
    tcfg, jcfg = _cfgs(case)
    jattn, tattn = _attn_params(case, 1)
    rng = np.random.default_rng(smax)
    b, hkv, hd = 3, tcfg.n_kv_heads, tcfg.resolved_head_dim
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    kq, ks = JA.quantize_kv(jnp.array(
        rng.standard_normal((b, smax, hkv, hd)).astype(np.float32)))
    vq, vs = JA.quantize_kv(jnp.array(
        rng.standard_normal((b, smax, hkv, hd)).astype(np.float32)))
    lengths = np.array([1, 7, smax + 5], np.int32)
    pos = (lengths - 1)[:, None]
    tk, tv, tks, tvs = (_t(np.asarray(a)) for a in (kq, vq, ks, vs))
    o, k2, v2, ks2, vs2 = TA.gqa_decode_quant(
        tcfg, tattn, _t(x), _t(pos), tk, tv, tks, tvs, _t(lengths),
        window=window)
    jo, *jrest = JA.gqa_decode_quant(
        jcfg, jattn, jnp.array(x), jnp.array(pos), kq, vq, ks, vs,
        jnp.array(lengths), window=window)
    assert k2 is tk and v2 is tv and ks2 is tks and vs2 is tvs
    _close(o, jo)
    for port, ref in zip((k2, v2, ks2, vs2), jrest):
        _close_entry(port, ref)
    ring = window and smax == window
    slots = (lengths - 1) % smax if ring else np.minimum(lengths - 1,
                                                         smax - 1)
    written = np.zeros((b, smax), bool)
    written[np.arange(b), slots] = True
    np.testing.assert_array_equal(k2.numpy()[~written],
                                  np.asarray(kq)[~written])


def test_mla_projections():
    tcfg, jcfg = _cfgs("minicpm3")
    jattn, tattn = _attn_params("minicpm3", 1)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9)).astype(np.int32)
    for fn in ("_mla_project_q", "_mla_latent"):
        tout = getattr(TA, fn)(tcfg, tattn, _t(x), _t(pos))
        jout = getattr(JA, fn)(jcfg, jattn, jnp.array(x), jnp.array(pos))
        for a, b in zip(tout, jout):
            _close(a, b)


@pytest.mark.parametrize("s,q_offset", [(40, 0), (24, 8)])
def test_mla_attend(s, q_offset):
    tcfg, jcfg = _cfgs("minicpm3")
    jattn, tattn = _attn_params("minicpm3", 0)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    pos = (q_offset + np.broadcast_to(np.arange(s)[None], (2, s))).astype(
        np.int32)
    o, (ckv, krope) = TA.mla_attend(tcfg, tattn, _t(x), _t(pos),
                                    q_offset=q_offset)
    jo, (jckv, jkrope) = JA.mla_attend(jcfg, jattn, jnp.array(x),
                                       jnp.array(pos), q_offset=q_offset)
    _close(o, jo)
    _close(ckv, jckv)
    _close(krope, jkrope)


def test_mla_decode():
    """Absorbed decode against the latent cache, written in place; the
    valid mask is arange(Smax) < lengths, unclamped (the last row is past
    Smax, its slot clamps)."""
    tcfg, jcfg = _cfgs("minicpm3")
    jattn, tattn = _attn_params("minicpm3", 1)
    rng = np.random.default_rng(12)
    b, smax = 3, 12
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((b, smax, tcfg.kv_lora_rank)).astype(
        np.float32)
    kr = rng.standard_normal((b, smax, tcfg.qk_rope_dim)).astype(np.float32)
    lengths = np.array([1, 6, smax + 3], np.int32)
    pos = (lengths - 1)[:, None]
    tc, tr = _t(ckv), _t(kr)
    o, c2, r2 = TA.mla_decode(tcfg, tattn, _t(x), _t(pos), tc, tr,
                              _t(lengths))
    jo, jc2, jr2 = JA.mla_decode(jcfg, jattn, jnp.array(x), jnp.array(pos),
                                 jnp.array(ckv), jnp.array(kr),
                                 jnp.array(lengths))
    assert c2 is tc and r2 is tr
    _close(o, jo)
    _close(c2, jc2)
    _close(r2, jr2)
    written = np.zeros((b, smax), bool)
    written[[0, 1, 2], [0, 5, smax - 1]] = True
    np.testing.assert_array_equal(c2.numpy()[~written], ckv[~written])


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_gemma2_pair_step(mode):
    """One gemma2 pair, block by block: the local layer (window, ring
    cache) then the global one, each with its post-norms and the
    attention softcap."""
    tcfg, jcfg = _cfgs("gemma2")
    jp, tp = _weights("gemma2")
    jpair = _stack(jp["backbone"]["pairs"], 0)
    tpair = _stack(tp["backbone"]["pairs"], 0)
    rng = np.random.default_rng(13)
    w = tcfg.sliding_window
    b, hkvhd = 2, tcfg.n_kv_heads * tcfg.resolved_head_dim
    s = 1 if mode == "decode" else 40
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32) * 3
    lengths = np.array([45, 50], np.int32)
    pos = ((lengths - 1)[:, None] if mode == "decode" else
           np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32))
    caches = {"local": [rng.standard_normal((b, w, hkvhd)).astype(
                  np.float32) for _ in range(2)],
              "global": [rng.standard_normal((b, 64, hkvhd)).astype(
                  np.float32) for _ in range(2)]}
    tx, jx = _t(x), jnp.array(x)
    for sub, window in (("local", w), ("global", 0)):
        kw = dict(positions=pos, mode=mode, window=window)
        tkv = jkv = None
        if mode == "decode":
            tkv = tuple(_t(c) for c in caches[sub])
            jkv = tuple(jnp.array(c) for c in caches[sub])
        tx, tnew, taux = TT.apply_dense_block(
            tcfg, tpair[sub], tx, kv=tkv,
            lengths=_t(lengths) if mode == "decode" else None,
            **dict(kw, positions=_t(pos)))
        jx, jnew, jaux = JT.apply_dense_block(
            jcfg, jpair[sub], jx, kv=jkv,
            lengths=jnp.array(lengths) if mode == "decode" else None,
            **dict(kw, positions=jnp.array(pos)))
        _close(tx, jx)
        assert taux == {k: float(v) for k, v in jaux.items()}
        if mode == "train":
            assert tnew is None and jnew is None
        else:
            assert len(tnew) == len(jnew) == 2
            for a, c in zip(tnew, jnew):
                _close(a, c)
            if mode == "prefill" and sub == "local":
                assert tnew[0].shape[1] == w            # trimmed to the ring


@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_run_backbone_hidden(case, mode):
    """All layers, train and prefill mode, past the window (40 > 32
    tokens): hidden states and every produced cache entry (a windowed
    layer's trimmed and rolled, int8 codes and scales)."""
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    x = np.random.default_rng(6).standard_normal((2, 40, tcfg.d_model)
                                                 ).astype(np.float32)
    pos = _positions(tcfg, 2, 40, seed=6, mixed=True)
    th, tnew, taux = TT.run_backbone(tcfg, tp["backbone"], _t(x),
                                     mode=mode, positions=_t(pos))
    jh, jnew, jaux = JT.run_backbone(jcfg, jp["backbone"], jnp.array(x),
                                     mode=mode, positions=jnp.array(pos))
    _close(th, jh)
    assert set(tnew) == set(jnew)
    for name in tnew:
        _close_entry(tnew[name], jnew[name])
    assert taux == {k: float(v) for k, v in jaux.items()}


# ------------------------------------------------------- the whole model

def _batch(cfg, tokens, positions=None):
    out = {"tokens": tokens}
    if positions is not None and cfg.family == "vlm":
        out["positions"] = positions
    return out


def _close_cache(tcache, jcache):
    assert set(tcache) == set(jcache)
    for name in jcache:
        assert tuple(tcache[name].shape) == np.shape(jcache[name]), name
        _close_entry(tcache[name], jcache[name])


@pytest.mark.parametrize("case", ALL)
def test_prefill_then_decode_matches(case):
    """Prefill 40 tokens (past the window of 32, into a cache of 64
    slots), then 4 decode steps: logits and every cache entry against
    JAX's after prefill and after each step."""
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    toks = _tokens(tcfg, 2, 44, seed=7)
    pos = _positions(tcfg, 2, 40, seed=7, mixed=True)
    jcache = JK.init_cache(jcfg, 2, 64)
    jl, jcache = JM.forward_prefill(
        jcfg, jp, _batch(jcfg, jnp.array(toks[:, :40]), jnp.array(pos)),
        jcache)
    tcache = TK.init_cache(tcfg, 2, 64, device="cpu")
    tl, tcache2 = TM.forward_prefill(
        tcfg, tp, _batch(tcfg, _t(toks[:, :40]), _t(pos)), tcache)
    assert tcache2 is tcache
    _close(tl, jl, LOGIT_TOL)
    _close_cache(tcache, jcache)
    for i in range(40, 44):
        jl, jcache = JM.forward_decode(jcfg, jp, jnp.array(toks[:, i:i + 1]),
                                       jcache)
        tl, tcache = TM.forward_decode(tcfg, tp, _t(toks[:, i:i + 1]),
                                       tcache)
        _close(tl, jl, LOGIT_TOL)
        _close_cache(tcache, jcache)
    assert tcache["lengths"].tolist() == [44, 44]


@pytest.mark.parametrize("case", ["gemma2", "danube", "danube_int8"])
def test_cache_below_the_window_is_linear(case):
    """With max_len under the window the windowed cache is linear: its
    slot clamps at Smax - 1 (a prompt of 20 and 6 steps into 24 slots)."""
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    toks = _tokens(tcfg, 2, 26, seed=14)
    jcache = JK.init_cache(jcfg, 2, 24)
    tcache = TK.init_cache(tcfg, 2, 24, device="cpu")
    jl, jcache = JM.forward_prefill(jcfg, jp, {"tokens": jnp.array(
        toks[:, :20])}, jcache)
    tl, tcache = TM.forward_prefill(tcfg, tp, {"tokens": _t(toks[:, :20])},
                                    tcache)
    _close_cache(tcache, jcache)
    for i in range(20, 26):
        jl, jcache = JM.forward_decode(jcfg, jp, jnp.array(toks[:, i:i + 1]),
                                       jcache)
        tl, tcache = TM.forward_decode(tcfg, tp, _t(toks[:, i:i + 1]),
                                       tcache)
        _close(tl, jl, LOGIT_TOL)
        _close_cache(tcache, jcache)


def test_prefill_over_the_cache_raises():
    tcfg, _ = _cfgs("minicpm3")
    _, tp = _weights("minicpm3")
    cache = TK.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="over the cache"):
        TM.forward_prefill(tcfg, tp, {"tokens": _t(_tokens(tcfg, 1, 9))},
                           cache)


@pytest.mark.parametrize("case,prompt", [
    ("danube", 32), ("gemma2", 32), ("minicpm3", 32), ("qwen2vl", 32),
    ("danube", 49), ("gemma2", 49), ("gemma2_2pairs", 49), ("danube_int8", 49),
    ("qwen3_int8", 32)])
def test_decode_matches_full_forward(case, prompt):
    """Prefill S tokens, decode token S + 1 from the cache, against one full
    forward at that position (JAX's test_decode_matches_forward; S = 49 is
    past the ring's window of 32, its test_swa_ring_wraparound_decode)."""
    tcfg, _ = _cfgs(case)
    _, tp = _weights(case)
    tcfg = dataclasses.replace(tcfg, max_cache_len=64)
    toks = _tokens(tcfg, 2, prompt + 1, seed=9)
    pos = _positions(tcfg, 2, prompt + 1)
    cache = TK.init_cache(tcfg, 2, tcfg.max_cache_len, device="cpu")
    _, cache = TM.forward_prefill(
        tcfg, tp, _batch(tcfg, _t(toks[:, :prompt]), _t(pos[..., :prompt])),
        cache)
    la, _ = TM.forward_decode(tcfg, tp, _t(toks[:, prompt:]), cache)
    lb = TM.forward_logits(tcfg, tp, _t(toks), positions=_t(pos))[:, -1]
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    if tcfg.kv_quant != "int8":
        _close(la, lb, LOGIT_TOL)
    at = TM.forward_logits(tcfg, tp, _t(toks), positions=_t(pos),
                           at=prompt)
    torch.testing.assert_close(at, lb, rtol=0, atol=1e-6)


def _greedy(step_cfg, params, toks, steps, mod):
    """Prefill then ``steps`` greedy decode steps; the logits of each."""
    cache = mod["init_cache"](step_cfg, 2, step_cfg.max_cache_len)
    logits, cache = mod["prefill"](step_cfg, params, toks, cache)
    outs = [logits]
    for _ in range(steps):
        tok = mod["argmax"](logits)
        logits, cache = mod["decode"](step_cfg, params, tok, cache)
        outs.append(logits)
    return outs


@pytest.mark.parametrize("case,prompt", [("qwen3_int8", 32),
                                         ("danube_int8", 48)])
def test_int8_within_jax_bound_of_the_fp_cache(case, prompt):
    """JAX's test_kv_quant on the port: greedy tokens equal to the fp
    cache's and log-softmax within 0.15 at every step (danube: a prompt
    past the ring's window), and the port's int8 logits against JAX's."""
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    base_t = dataclasses.replace(tcfg, kv_quant="none")
    toks = _tokens(tcfg, 2, prompt, seed=15)
    torch_mod = {
        "init_cache": lambda c, b, s: TK.init_cache(c, b, s, device="cpu"),
        "prefill": lambda c, p, t, cache: TM.forward_prefill(
            c, p, {"tokens": _t(t)}, cache),
        "decode": TM.forward_decode,
        "argmax": lambda lg: lg.argmax(-1)[:, None].to(torch.int32)}
    jax_mod = {
        "init_cache": JK.init_cache,
        "prefill": lambda c, p, t, cache: JM.forward_prefill(
            c, p, {"tokens": jnp.array(t)}, cache),
        "decode": JM.forward_decode,
        "argmax": lambda lg: jnp.argmax(lg, -1)[:, None].astype(jnp.int32)}
    fp = _greedy(base_t, tp, toks, 4, torch_mod)
    q8 = _greedy(tcfg, tp, toks, 4, torch_mod)
    j8 = _greedy(jcfg, jp, toks, 4, jax_mod)
    for a, b, c in zip(fp, q8, j8):
        assert torch.equal(a.argmax(-1), b.argmax(-1))
        gap = (torch.log_softmax(a, -1) - torch.log_softmax(b, -1)).abs()
        assert gap.max().item() < INT8_LOGSOFTMAX_GAP
        _close(b, c, LOGIT_TOL)


@pytest.mark.parametrize("case", MODELS)
def test_greedy_ids_through_steps(case):
    """launch/steps' prefill and decode against JAX's, greedy ids for 6
    steps (VLM: the batch's M-RoPE streams, then decode's default)."""
    from repro.launch import steps as jsteps
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    toks = _tokens(tcfg, 3, 36, seed=8)
    pos = _positions(tcfg, 3, 36, seed=8, mixed=True)
    jl, jc = jsteps.make_prefill_step(jcfg)(
        jp, _batch(jcfg, jnp.array(toks), jnp.array(pos)),
        JK.init_cache(jcfg, 3, 64))
    tl, tc = tsteps.make_prefill_step(tcfg)(
        tp, _batch(tcfg, _t(toks), _t(pos)),
        TK.init_cache(tcfg, 3, 64, device="cpu"))
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


def test_vlm_decode_with_explicit_positions():
    """Decode's (3, B, 1) M-RoPE positions passed through the step, as
    JAX's forward_decode takes them."""
    tcfg, jcfg = _cfgs("qwen2vl")
    jp, tp = _weights("qwen2vl")
    toks = _tokens(tcfg, 2, 21, seed=16)
    pos = _positions(tcfg, 2, 20, seed=16, mixed=True)
    dpos = np.random.default_rng(16).integers(0, 20, (3, 2, 1)).astype(
        np.int32)
    jc = JK.init_cache(jcfg, 2, 64)
    _, jc = JM.forward_prefill(jcfg, jp, _batch(jcfg, jnp.array(toks[:, :20]),
                                                jnp.array(pos)), jc)
    jl, jc = JM.forward_decode(jcfg, jp, jnp.array(toks[:, 20:]), jc,
                               positions=jnp.array(dpos))
    tc = TK.init_cache(tcfg, 2, 64, device="cpu")
    _, tc = TM.forward_prefill(tcfg, tp, _batch(tcfg, _t(toks[:, :20]),
                                                _t(pos)), tc)
    tl, tc = tsteps.make_decode_step(tcfg)(tp, _t(toks[:, 20:]), tc,
                                           positions=_t(dpos))
    _close(tl, jl, LOGIT_TOL)
    _close_cache(tc, jc)


@pytest.mark.parametrize("case", MODELS)
def test_probe_features_match(case):
    tcfg, jcfg = _cfgs(case)
    jp, tp = _weights(case)
    toks = _tokens(tcfg, 2, 24, seed=10)
    pos = _positions(tcfg, 2, 24)
    x = JC.embed_tokens(jp["embed"], jnp.array(toks), jnp.float32)
    h, _, _ = JT.run_backbone(jcfg, jp["backbone"], x, mode="train",
                              positions=jnp.array(pos))
    ref = JC.rmsnorm(h, jp["final_ln"]).reshape(-1, jcfg.d_model)
    _close(TM.probe_features(tcfg, tp, _t(toks)), ref)


@pytest.mark.parametrize("case", MODELS)
def test_make_smoke_batch_layout(case):
    tcfg, jcfg = _cfgs(case)
    tb = TM.make_smoke_batch(tcfg, seed=1, batch=3, seq=11, device="cpu")
    jb = JM.make_smoke_batch(jcfg, jax.random.PRNGKey(1), batch=3, seq=11)
    assert set(tb) == set(jb)
    for k in tb:
        assert tuple(tb[k].shape) == jb[k].shape and tb[k].dtype == \
            torch.int32
    if "positions" in jb:
        np.testing.assert_array_equal(tb["positions"].numpy(),
                                      np.asarray(jb["positions"]))


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_serve_cli_on_cpu(capsys, arch):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "40", "--gen", "4"]
    out = tserve.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 40 tok x2: ")
    assert lines[1].startswith("decode 4 steps: ")
    assert out.shape == (2, 4) and out.dtype == np.int32
    assert ((out >= 0) & (out < tget(arch).smoke().padded_vocab)).all()
    np.testing.assert_array_equal(tserve.main(argv), out)    # seeded
