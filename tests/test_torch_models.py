"""The port's LM serving path against the JAX package's, module by module,
at qwen3-8b's ``smoke()`` (fp32, 2 layers, d_model 64).

Inputs come from numpy with a seed; JAX's weights go across with
``params_from_numpy`` (the port cannot reproduce ``jax.random``'s draws,
so its own init is held by its statistics only).  Tolerance: 1e-5 of the
reference's largest magnitude per module, 1e-4 for logits after the whole
model (and JAX's own bound, rtol = atol = 2e-2, for the decode-versus-
forward check).
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
from repro.launch import steps as jsteps

import repro_torch.models.attention as TA
import repro_torch.models.common as TC
import repro_torch.models.kvcache as TK
import repro_torch.models.model as TM
import repro_torch.models.params as TP
import repro_torch.models.transformer as TT
from repro_torch.configs.registry import get as tget
from repro_torch.launch import steps as tsteps

MODULE_TOL = 1e-5
LOGIT_TOL = 1e-4


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(port, ref, tol=MODULE_TOL):
    port, ref = _np(port).astype(np.float64), _np(ref).astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(port - ref).max() / scale
    assert err <= tol, f"max |port - ref| = {err:.3g} of max |ref|"


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def cfgs():
    return tget("qwen3-8b").smoke(), jget("qwen3-8b").smoke()


@pytest.fixture(scope="module")
def weights(cfgs):
    """JAX's random weights, as numpy and carried into the port."""
    tcfg, jcfg = cfgs
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jp, TP.params_from_numpy(tcfg, npp, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------- params

def test_params_from_numpy_carries_the_tree(cfgs, weights):
    tcfg, _ = cfgs
    jp, tp = weights
    jleaves = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    jnames = {".".join(k.key for k in path): v for path, v in jleaves.items()}
    tnames = dict(TP.tree_items(tp))
    assert set(jnames) == set(tnames)
    assert "backbone.layers.attn.wq" in tnames
    for name, v in jnames.items():
        assert tuple(tnames[name].shape) == v.shape, name
        assert tnames[name].dtype == torch.float32
        np.testing.assert_array_equal(tnames[name].numpy(), np.asarray(v))
    assert TP.count_params(TM.model_defs(tcfg)) == JP.count_params(
        JM.model_defs(cfgs[1]))


def test_params_from_numpy_bf16_and_mismatches(cfgs):
    tcfg, jcfg = cfgs
    jp = JM.init_model(jcfg, jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    tp = TP.params_from_numpy(tcfg, npp, device="cpu")
    wq = tp["backbone"]["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(),
        np.asarray(jp["backbone"]["layers"]["attn"]["wq"], np.float32))
    bad = dict(npp, final_ln=np.ones((3,), np.float32))
    with pytest.raises(ValueError, match="final_ln"):
        TP.params_from_numpy(tcfg, bad, device="cpu")
    missing = {k: v for k, v in npp.items() if k != "final_ln"}
    with pytest.raises(ValueError, match="missing"):
        TP.params_from_numpy(tcfg, missing, device="cpu")


def test_model_defs_match(cfgs):
    tcfg, jcfg = cfgs
    for cfg_t, cfg_j in ((tcfg, jcfg), (tget("qwen3-8b"), jget("qwen3-8b"))):
        td = dict(TP.tree_items(TM.model_defs(cfg_t)))
        jd = {".".join(k.key for k in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(
                  JM.model_defs(cfg_j),
                  is_leaf=lambda x: isinstance(x, JP.ParamDef))[0]}
        assert set(td) == set(jd)
        for name in td:
            assert dataclasses.astuple(td[name]) == dataclasses.astuple(
                jd[name]), name
    full = tget("qwen3-8b")
    assert TP.count_params(TM.model_defs(full)) == JP.count_params(
        JM.model_defs(jget("qwen3-8b")))


@pytest.mark.parametrize("kind", ["normal", "small", "embed", "zeros",
                                  "ones"])
def test_init_params_statistics(kind):
    """Each ParamDef kind's law (JAX's): normal std = scale/sqrt(fan-in),
    small 0.02·scale, embed 1, zeros, ones; drawn fp32, cast after."""
    d = TP.ParamDef((3, 256, 512), ("layers", "embed", "model"), kind,
                    scale=2.0)
    gen = torch.Generator().manual_seed(0)
    t = TP.init_params({"w": d}, gen, torch.bfloat16)["w"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == d.shape
    jd = JP.ParamDef(d.shape, d.axes, kind, d.scale)
    j = np.asarray(JP.init_params({"w": jd}, jax.random.PRNGKey(0),
                                  jnp.float32)["w"])
    v = t.float().numpy()
    if kind in ("zeros", "ones"):
        np.testing.assert_array_equal(v, j)
        return
    want = {"normal": 2.0 / np.sqrt(256), "small": 0.04, "embed": 1.0}[kind]
    assert TP.init_std(d) == pytest.approx(want)
    n = v.size
    for sample in (v, j):
        assert abs(sample.mean()) < 5 * want / np.sqrt(n)
        assert abs(sample.std() / want - 1) < 0.01


def test_init_model_on_cpu(cfgs):
    tcfg, _ = cfgs
    a = TM.init_model(tcfg, seed=1, device="cpu")
    b = TM.init_model(tcfg, seed=1, device="cpu")
    for (na, ta), (_, tb) in zip(TP.tree_items(a), TP.tree_items(b)):
        assert ta.device.type == "cpu"
        torch.testing.assert_close(ta, tb, rtol=0, atol=0, msg=na)
    ln = a["backbone"]["layers"]["ln1"]
    assert tuple(ln.shape) == (2, 64) and bool((ln == 1).all())


def test_entry_points_default_to_the_card(cfgs):
    if torch.cuda.is_available():
        pytest.skip("the default device is present")
    tcfg, _ = cfgs
    for fn in (lambda: TM.init_model(tcfg),
               lambda: TM.make_smoke_batch(tcfg),
               lambda: TK.init_cache(tcfg, 2, 8),
               lambda: TP.params_from_numpy(tcfg, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


# --------------------------------------------------------------- modules

def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    _close(TC.rmsnorm(_t(x), _t(w)), JC.rmsnorm(jnp.array(x), jnp.array(w)))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 32768, (2, 7)).astype(np.int32)
    _close(TC.apply_rope(_t(x), _t(pos), theta),
           JC.apply_rope(jnp.array(x), jnp.array(pos), theta))
    _close(TC.rope_freqs(16, theta), JC.rope_freqs(16, theta))


def test_mlp_and_unembed(cfgs, weights):
    tcfg, _ = cfgs
    jp, tp = weights
    x = np.random.default_rng(2).standard_normal((2, 3, 64)).astype(
        np.float32)
    jffn = jax.tree_util.tree_map(lambda a: a[0],
                                  jp["backbone"]["layers"]["ffn"])
    tffn = {k: v[0] for k, v in tp["backbone"]["layers"]["ffn"].items()}
    _close(TC.apply_mlp(tffn, _t(x)), JC.apply_mlp(jffn, jnp.array(x)))
    _close(TC.unembed(tp["embed"], _t(x), tie=False),
           JC.unembed(jp["embed"], jnp.array(x), tie=False))
    _close(TC.unembed(tp["embed"], _t(x)[..., :64], tie=True,
                      final_softcap=3.0),
           JC.unembed(jp["embed"], jnp.array(x), tie=True,
                      final_softcap=3.0))
    tok = _tokens(tcfg, 2, 5)
    _close(TC.embed_tokens(tp["embed"], _t(tok), torch.float32),
           JC.embed_tokens(jp["embed"], jnp.array(tok), jnp.float32))


@pytest.mark.parametrize("causal_mode", ["masked", "triangular"])
@pytest.mark.parametrize("sq,sk,q_offset,window,causal,softcap", [
    (40, 40, 0, 0, True, 0.0),       # padding on both sides
    (32, 64, 32, 0, True, 0.0),      # prefill continuation
    (48, 48, 0, 20, True, 0.0),      # window
    (24, 56, 32, 16, True, 5.0),     # window + offset + softcap
    (40, 24, 0, 0, False, 0.0),      # not causal, padded keys
])
def test_flash_attention(causal_mode, sq, sk, q_offset, window, causal,
                         softcap):
    rng = np.random.default_rng(sq + sk + window)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=16,
              k_chunk=16, q_offset=q_offset, causal_mode=causal_mode)
    _close(TA.flash_attention(_t(q), _t(k), _t(v), **kw),
           JA.flash_attention(jnp.array(q), jnp.array(k), jnp.array(v),
                              **kw))


@pytest.mark.parametrize("softcap", [0.0, 7.0])
def test_decode_attention(softcap):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    lengths = np.array([1, 13, 25], np.int32)      # the last past Smax
    _close(TA.decode_attention(_t(q), _t(kc), _t(vc), _t(lengths),
                               softcap=softcap),
           JA.decode_attention(jnp.array(q), jnp.array(kc), jnp.array(vc),
                               jnp.array(lengths), softcap=softcap))


def test_gqa_decode_cache_writes(cfgs, weights):
    tcfg, jcfg = cfgs
    jp, tp = weights
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    kc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    lengths = np.array([1, 6, 12], np.int32)       # slots 0, 5, and 9
    pos = (lengths - 1)[:, None]
    jattn = jax.tree_util.tree_map(lambda a: a[1],
                                   jp["backbone"]["layers"]["attn"])
    tattn = {k: v[1] for k, v in tp["backbone"]["layers"]["attn"].items()}
    tk, tv = _t(kc), _t(vc)
    o, k2, v2 = TA.gqa_decode(tcfg, tattn, _t(x), _t(pos), tk, tv,
                              _t(lengths))
    jo, jk2, jv2 = JA.gqa_decode(jcfg, jattn, jnp.array(x), jnp.array(pos),
                                 jnp.array(kc), jnp.array(vc),
                                 jnp.array(lengths))
    assert k2 is tk and v2 is tv            # written in place
    _close(o, jo)
    _close(k2, jk2)
    _close(v2, jv2)
    written = np.zeros((3, 10), bool)
    written[[0, 1, 2], [0, 5, 9]] = True
    np.testing.assert_array_equal(k2.numpy()[~written], kc[~written])


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_run_backbone_hidden(cfgs, weights, mode):
    tcfg, jcfg = cfgs
    jp, tp = weights
    x = np.random.default_rng(6).standard_normal((2, 40, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(40)[None], (2, 40)).astype(np.int32)
    th, tnew, taux = TT.run_backbone(tcfg, tp["backbone"], _t(x),
                                     mode=mode, positions=_t(pos))
    jh, jnew, jaux = JT.run_backbone(jcfg, jp["backbone"], jnp.array(x),
                                     mode=mode, positions=jnp.array(pos))
    _close(th, jh)
    assert set(tnew) == set(jnew)
    for name in tnew:
        _close(tnew[name], jnew[name])
    assert taux == {k: float(v) for k, v in jaux.items()}


def test_kvcache_layout(cfgs):
    tcfg, jcfg = cfgs
    for (ct, cj, b, s) in ((tcfg, jcfg, 2, 64),
                           (tget("qwen3-8b"), jget("qwen3-8b"), 4, 32768)):
        tspec = TK.cache_spec_tree(ct, b, s)
        jspec = JK.cache_spec_tree(cj, b, s)
        assert set(tspec) == set(jspec)
        for name, (shape, dtype) in tspec.items():
            assert shape == jspec[name][0]
            assert str(dtype).split(".")[-1] == np.dtype(
                jspec[name][1]).name
        assert TK.cache_bytes(ct, b, s) == JK.cache_bytes(cj, b, s)
    assert TK.cache_bytes(tget("qwen3-8b"), 4, 32768) == 19_327_352_848
    cache = TK.init_cache(tcfg, 2, 64, device="cpu")
    assert all(not bool(t.any()) for t in cache.values())
    jc = {k: np.asarray(v) for k, v in JK.init_cache(jcfg, 2, 64).items()}
    back = TK.cache_from_numpy(tcfg, jc, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in back.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
    with pytest.raises(ValueError, match="lengths"):
        TK.cache_from_numpy(tcfg, dict(jc, lengths=jc["lengths"]
                                       .astype(np.int64)), device="cpu")


# ------------------------------------------------------- the whole model

def _prefill_pair(cfgs, weights, tokens, max_len):
    tcfg, jcfg = cfgs
    jp, tp = weights
    b = tokens.shape[0]
    jcache = JK.init_cache(jcfg, b, max_len)
    jl, jcache = JM.forward_prefill(jcfg, jp, {"tokens": jnp.array(tokens)},
                                    jcache)
    tcache = TK.init_cache(tcfg, b, max_len, device="cpu")
    tl, tcache2 = TM.forward_prefill(tcfg, tp, {"tokens": _t(tokens)},
                                     tcache)
    assert tcache2 is tcache
    return (jl, jcache), (tl, tcache)


def _close_cache(tcache, jcache):
    assert set(tcache) == set(jcache)
    for name in jcache:
        if name == "lengths":
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jcache[name]))
        else:
            _close(tcache[name], jcache[name])


def test_prefill_then_decode_matches(cfgs, weights):
    tcfg, jcfg = cfgs
    jp, tp = weights
    toks = _tokens(tcfg, 2, 40, seed=7)
    (jl, jcache), (tl, tcache) = _prefill_pair(cfgs, weights, toks[:, :37],
                                               64)
    _close(tl, jl, LOGIT_TOL)
    _close_cache(tcache, jcache)
    # A stale cache: prefill zeroes the slots past the prompt, as JAX's pad.
    stale = TK.init_cache(tcfg, 2, 64, device="cpu")
    stale["k"].fill_(7.0)
    TM.forward_prefill(tcfg, tp, {"tokens": _t(toks[:, :37])}, stale)
    _close_cache(stale, jcache)
    for i in range(37, 40):
        jl, jcache = JM.forward_decode(jcfg, jp, jnp.array(toks[:, i:i + 1]),
                                       jcache)
        tl, tcache = TM.forward_decode(tcfg, tp, _t(toks[:, i:i + 1]),
                                       tcache)
        _close(tl, jl, LOGIT_TOL)
        _close_cache(tcache, jcache)
    assert tcache["lengths"].tolist() == [40, 40]


def test_greedy_ids_through_steps(cfgs, weights):
    tcfg, jcfg = cfgs
    jp, tp = weights
    toks = _tokens(tcfg, 3, 12, seed=8)
    jprefill, jdecode = (jsteps.make_prefill_step(jcfg),
                         jsteps.make_decode_step(jcfg))
    tprefill, tdecode = (tsteps.make_prefill_step(tcfg),
                         tsteps.make_decode_step(tcfg))
    jl, jc = jprefill(jp, {"tokens": jnp.array(toks)},
                      JK.init_cache(jcfg, 3, 64))
    tl, tc = tprefill(tp, {"tokens": _t(toks)},
                      TK.init_cache(tcfg, 3, 64, device="cpu"))
    jids, tids = [], []
    for _ in range(8):
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = tl.argmax(-1)[:, None].to(torch.int32)
        jids.append(np.asarray(jt)[:, 0])
        tids.append(tt[:, 0].numpy())
        jl, jc = jdecode(jp, jt, jc)
        tl, tc = tdecode(tp, tt, tc)
    np.testing.assert_array_equal(np.stack(tids, 1), np.stack(jids, 1))
    _close(tl, jl, LOGIT_TOL)


def test_decode_matches_full_forward(cfgs, weights):
    """The port's own check: decoding token S from the cache gives the
    full forward's logits at position S (JAX's bound in
    test_models_smoke, and the fp32 logit tolerance)."""
    tcfg, _ = cfgs
    _, tp = weights
    toks = _tokens(tcfg, 2, 33, seed=9)
    cache = TK.init_cache(tcfg, 2, tcfg.max_cache_len, device="cpu")
    _, cache = TM.forward_prefill(tcfg, tp, {"tokens": _t(toks[:, :32])},
                                  cache)
    la, _ = TM.forward_decode(tcfg, tp, _t(toks[:, 32:33]), cache)
    lb = TM.forward_logits(tcfg, tp, _t(toks))[:, -1]
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=2e-2, atol=2e-2)
    _close(la, lb, LOGIT_TOL)


def test_probe_features_on_bf16_weights(cfgs):
    """fp32 activations against bf16 weights: JAX promotes each product to
    fp32, the port casts the weight up; the two agree to fp32 rounding."""
    tcfg, jcfg = cfgs
    jp = JM.init_model(jcfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    tp = TP.params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    toks = _tokens(tcfg, 2, 24, seed=10)
    x = JC.embed_tokens(jp["embed"], jnp.array(toks), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(24)[None], (2, 24))
    h, _, _ = JT.run_backbone(jcfg, jp["backbone"], x, mode="train",
                              positions=pos)
    ref = JC.rmsnorm(h, jp["final_ln"]).reshape(-1, jcfg.d_model)
    feats = TM.probe_features(tcfg, tp, _t(toks))
    assert feats.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(feats, ref)


# Ids kept from when the int8, MLA, SWA, post-norm and MoE variants raised
# too.
@pytest.mark.parametrize("change,item", [
    pytest.param(dict(sliding_window=32), "1a", id="change3-1a"),
])
def test_variants_of_the_dense_family_raise(cfgs, weights, change, item):
    cfg = dataclasses.replace(cfgs[0], **change)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        TM.model_defs(cfg)
    x = torch.zeros((1, 4, 64))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        TT.run_backbone(cfg, weights[1]["backbone"], x, mode="train",
                        positions=torch.zeros((1, 4), dtype=torch.int32))


def test_lm_modules_import_neither_jax_nor_repro():
    import subprocess
    import sys
    code = ("import sys\n"
            "import repro_torch.configs.registry, repro_torch.models.model\n"
            "import repro_torch.models.kvcache, repro_torch.launch.serve\n"
            "import repro_torch.launch.steps, repro_torch.models.attention\n"
            "import repro_torch.models.common, repro_torch.models.params\n"
            "import repro_torch.models.transformer\n"
            "import repro_torch.models.moe, repro_torch.models.ssm\n"
            "import repro_torch.models.encdec, repro_torch.optim\n"
            "import repro_torch.data, repro_torch.checkpoint\n"
            "import repro_torch.distributed.fault_tolerance\n"
            "import repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
