"""The port's enc-dec family (seamless-m4t-large-v2) against the JAX
package's: cross-attention (``gqa_qkv``'s ``rope`` flag, ``gqa_attend``'s
``kv_override``), the encoder, the decoder in its three modes, the cache
layout, prefill and decode, and the serve CLI, at the config's
``smoke()`` in fp32 (and prefill / decode once in bf16).

Inputs come from numpy with a seed; JAX's weights go across with
``params_from_numpy``.  Tolerance: 1e-5 of the reference's largest
magnitude per module and cache entry (``MODULE_TOL``), 1e-4 for logits
after the whole model (``LOGIT_TOL``), JAX's own bound (rtol = atol =
2e-2) for decode against the full forward, and in bf16 ``BF16_TOL`` of the
largest logit or cache entry.

JAX's decode attends every one of the cache's ``src_len_for_decode``
source slots, the zero-padded ones included; the port does the same, so
a decode step equals a full forward only at S_src = src_len_for_decode
(JAX's ``test_decode_matches_forward`` leaves seamless out for this).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro.models.encdec as JE
import repro.models.kvcache as JK
import repro.models.model as JM
from repro.configs.registry import get as jget

import repro_torch.models.attention as TA
import repro_torch.models.encdec as TE
import repro_torch.models.kvcache as TK
import repro_torch.models.model as TM
import repro_torch.models.params as TP
from repro_torch.configs.registry import get as tget
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps

MODULE_TOL = 1e-5
LOGIT_TOL = 1e-4
JAX_RTOL = JAX_ATOL = 2e-2         # tests/test_models_smoke.py
BF16_TOL = 2e-2
ARCH = "seamless-m4t-large-v2"


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(port, ref, tol=MODULE_TOL):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    port, ref = port.astype(np.float64), ref.astype(np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(port - ref).max() / scale
    assert err <= tol, f"max |port - ref| = {err:.3g} of max |ref|"


def _t(a):
    return torch.tensor(np.asarray(a))


def _cfgs(dtype="float32"):
    t = dataclasses.replace(tget(ARCH).smoke(), dtype=dtype)
    j = dataclasses.replace(jget(ARCH).smoke(), dtype=dtype)
    return t, j


_WEIGHTS = {}


def _weights(dtype="float32"):
    """JAX's random weights of the smoke config (bf16 too), as JAX's tree
    and carried into the port's."""
    if dtype not in _WEIGHTS:
        tcfg, jcfg = _cfgs(dtype)
        jp = JM.init_model(jcfg, jax.random.PRNGKey(7))
        npp = jax.tree_util.tree_map(np.asarray, jp)
        _WEIGHTS[dtype] = jp, TP.params_from_numpy(tcfg, npp, device="cpu")
    return _WEIGHTS[dtype]


def _batch(cfg, b, s, s_src, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "frames": rng.standard_normal((b, s_src, cfg.d_model)).astype(
                np.float32)}


def _dec_params(i):
    jp, tp = _weights()
    return (jax.tree_util.tree_map(lambda a: a[i], jp["backbone"]["dec"]),
            TP.tree_map(lambda t: t[i], tp["backbone"]["dec"]))


# ------------------------------------------------------ cross-attention

@pytest.mark.parametrize("rope", [True, False])
def test_gqa_qkv_rope_flag(rope):
    tcfg, jcfg = _cfgs()
    jp, tp = _dec_params(0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None] + 3, (2, 9)).astype(np.int32)
    ref = JA.gqa_qkv(jcfg, jp["cross_attn"], jnp.array(x), jnp.array(pos),
                     rope=rope)
    out = TA.gqa_qkv(tcfg, tp["cross_attn"], _t(x), _t(pos), rope=rope)
    for o, r in zip(out, ref):
        _close(o, r)
    if not rope:
        _close(TA.gqa_query(tcfg, tp["cross_attn"], _t(x)), ref[0])


@pytest.mark.parametrize("s_src", [5, 23, 40])
def test_gqa_attend_kv_override(s_src):
    """Cross-attention: no rope, no causal mask, the keys and values
    given (over one K/V chunk of the smoke config's 32 and over two)."""
    tcfg, jcfg = _cfgs()
    jp, tp = _dec_params(1)
    rng = np.random.default_rng(s_src)
    hkv, hd = tcfg.n_kv_heads, tcfg.resolved_head_dim
    x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    k = rng.standard_normal((2, s_src, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((2, s_src, hkv, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7)).astype(np.int32)
    ref, (rk, rv) = JA.gqa_attend(jcfg, jp["cross_attn"], jnp.array(x),
                                  jnp.array(pos),
                                  kv_override=(jnp.array(k), jnp.array(v)))
    out, (ok, ov) = TA.gqa_attend(tcfg, tp["cross_attn"], _t(x), _t(pos),
                                  kv_override=(_t(k), _t(v)))
    _close(out, ref)
    _close(ok, rk)
    _close(ov, rv)


# ------------------------------------------------------ encoder, decoder

@pytest.mark.parametrize("s_src", [16, 32, 45])
def test_run_encoder(s_src):
    tcfg, jcfg = _cfgs()
    jp, tp = _weights()
    frames = np.random.default_rng(2).standard_normal(
        (2, s_src, tcfg.d_model)).astype(np.float32)
    ref = JE.run_encoder(jcfg, jp["backbone"], jnp.array(frames))
    _close(TE.run_encoder(tcfg, tp["backbone"], _t(frames)), ref)


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("s,s_src", [(12, 32), (33, 20)])
def test_run_decoder_teacher_forced(mode, s, s_src):
    """Train and prefill (no cache: the entries stacked over layers, as
    JAX's scan returns them)."""
    tcfg, jcfg = _cfgs()
    jp, tp = _weights()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, s_src, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (2, s)).astype(np.int32)
    rh, rc = JE.run_decoder(jcfg, jp["backbone"], jnp.array(x),
                            jnp.array(enc), mode=mode,
                            positions=jnp.array(pos))
    th, tc = TE.run_decoder(tcfg, tp["backbone"], _t(x), _t(enc), mode=mode,
                            positions=_t(pos))
    _close(th, rh)
    assert sorted(tc) == sorted(rc)
    for name in rc:
        _close(tc[name], rc[name])


def test_run_decoder_decode():
    """One decode step from a JAX cache filled with random entries: the
    hidden state, the written self K/V slot, the cross entries
    untouched."""
    tcfg, jcfg = _cfgs()
    jp, tp = _weights()
    b, smax, src = 2, 24, tcfg.src_len_for_decode
    rng = np.random.default_rng(3)
    spec = JK.cache_spec_tree(jcfg, b, smax)
    cache = {k: rng.standard_normal(shape).astype(np.float32)
             for k, (shape, dtype, _) in spec.items() if k != "lengths"}
    cache["lengths"] = np.array([5, 17], np.int32)
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    pos = cache["lengths"][:, None]
    lengths = cache["lengths"] + 1
    rh, rc = JE.run_decoder(
        jcfg, jp["backbone"], jnp.array(x), None, mode="decode",
        positions=jnp.array(pos), cache=jax.tree_util.tree_map(jnp.array,
                                                               cache),
        lengths=jnp.array(lengths))
    tcache = TK.cache_from_numpy(tcfg, cache, device="cpu")
    th, tcn = TE.run_decoder(tcfg, tp["backbone"], _t(x), None,
                             mode="decode", positions=_t(pos), cache=tcache,
                             lengths=_t(lengths))
    _close(th, rh)
    assert tcn["k"] is tcache["k"] and tcache["k_cross"].shape[2] == src
    for name in rc:
        _close(tcn[name], rc[name])
    np.testing.assert_array_equal(tcache["v_cross"].numpy(),
                                  cache["v_cross"])


# ------------------------------------------------------ the cache layout

@pytest.mark.parametrize("smoke", [True, False])
def test_cache_layout(smoke):
    tcfg, jcfg = tget(ARCH), jget(ARCH)
    if smoke:
        tcfg, jcfg = tcfg.smoke(), jcfg.smoke()
    tspec = TK.cache_spec_tree(tcfg, 4, 32_768)
    jspec = JK.cache_spec_tree(jcfg, 4, 32_768)
    assert sorted(tspec) == sorted(jspec) == [
        "k", "k_cross", "lengths", "v", "v_cross"]
    for k, (shape, dtype) in tspec.items():
        assert shape == jspec[k][0]
        assert str(dtype).split(".")[-1] == jnp.dtype(jspec[k][1]).name
    assert TK.cache_bytes(tcfg, 4, 32_768) == JK.cache_bytes(jcfg, 4, 32_768)
    if not smoke:
        assert TK.cache_bytes(tcfg, 4, 32_768) == 14_495_514_640


def test_params_tree_and_count():
    tcfg, jcfg = tget(ARCH), jget(ARCH)
    want = {k: d.shape for k, d in TP.tree_items(TM.model_defs(tcfg))}
    assert TP.count_params(TM.model_defs(tcfg)) == 2_034_886_656
    jdefs = jax.tree_util.tree_leaves_with_path(
        JM.model_defs(jcfg), is_leaf=lambda d: hasattr(d, "init"))
    have = {".".join(p.key for p in path): d.shape for path, d in jdefs}
    assert want == have
    # JAX's n_params() formula leaves out each decoder layer's
    # cross-attention V projection, the norms and the padded vocab rows.
    d = tcfg.d_model
    cross_v = tcfg.n_dec_layers * d * tcfg.n_kv_heads * tcfg.resolved_head_dim
    norms = (2 * tcfg.n_enc_layers + 3 * tcfg.n_dec_layers + 2) * d
    pad = 2 * (tcfg.padded_vocab - tcfg.vocab_size) * d
    assert 2_034_886_656 - tcfg.n_params() == cross_v + norms + pad


def test_smoke_batch_has_frames():
    tcfg, _ = _cfgs()
    b = TM.make_smoke_batch(tcfg, seed=3, batch=2, seq=20, device="cpu")
    assert sorted(b) == ["frames", "labels", "tokens"]
    assert b["frames"].shape == (2, 20, tcfg.d_model)
    assert b["frames"].dtype == torch.float32
    again = TM.make_smoke_batch(tcfg, seed=3, batch=2, seq=20, device="cpu")
    assert torch.equal(b["frames"], again["frames"])


# ------------------------------------------------------ prefill, decode

_SERVED = {}


def _serve_both(dtype, s, s_src, steps, smax=48, seed=0):
    """Prefill then ``steps`` greedy decode steps (JAX's tokens fed to
    both), in both packages, once per worker: (JAX's logits and cache
    after each call, the port's), and the prompt."""
    key = (dtype, s, s_src, steps, smax, seed)
    if key not in _SERVED:
        _SERVED[key] = _serve(_cfgs(dtype), _weights(dtype), s, s_src, steps,
                              smax, seed)
    return _SERVED[key]


def _serve(cfg_pair, weights, s, s_src, steps, smax, seed):
    tcfg, jcfg = cfg_pair
    jp, tp = weights
    nb = _batch(tcfg, 2, s, s_src, seed)
    nb.pop("labels")
    jcache = JK.init_cache(jcfg, 2, smax)
    tcache = TK.init_cache(tcfg, 2, smax, device="cpu")
    jl, jcache = JM.forward_prefill(
        jcfg, jp, {k: jnp.array(v) for k, v in nb.items()}, jcache)
    tl, tcache = tsteps.make_prefill_step(tcfg)(
        tp, {k: _t(v) for k, v in nb.items()}, tcache)
    out = [((jl, dict(jcache)), (tl, {k: v.clone()
                                      for k, v in tcache.items()}))]
    decode = tsteps.make_decode_step(tcfg)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jcache = JM.forward_decode(jcfg, jp, jnp.array(tok), jcache)
        tl, tcache = decode(tp, _t(tok), tcache)
        out.append(((jl, dict(jcache)), (tl, {k: v.clone()
                                              for k, v in tcache.items()})))
    return out, nb


@pytest.mark.parametrize("s_src", [32, 19], ids=["src_full", "src_short"])
def test_prefill_and_decode_against_jax(s_src):
    """At S_src = src_len_for_decode and below it: the cross cache's
    zero-padded slots and the decode steps that attend them are JAX's."""
    out, _ = _serve_both("float32", 12, s_src, 3)
    for (jl, jc), (tl, tc) in out:
        _close(tl, jl, LOGIT_TOL)
        assert sorted(tc) == sorted(jc)
        for name in jc:
            if name == "lengths":
                np.testing.assert_array_equal(tc[name].numpy(), jc[name])
            else:
                _close(tc[name], jc[name])
    src = _cfgs()[0].src_len_for_decode
    pad = out[0][1][1]["k_cross"][:, :, s_src:]
    assert pad.shape[2] == src - s_src and not pad.any()


def test_decode_attends_the_padded_source_slots():
    """Below src_len_for_decode the decode step differs from the full
    forward (JAX's quirk, kept): the zero keys take softmax mass."""
    tcfg, _ = _cfgs()
    _, tp = _weights()
    out, nb = _serve_both("float32", 12, 19, 3)
    tok = np.asarray(out[0][0][0].argmax(-1))[:, None].astype(np.int32)
    full = torch.cat([_t(nb["tokens"]), _t(tok)], 1)
    ref = TM.forward_logits(tcfg, tp, full, at=12, frames=_t(nb["frames"]))
    dec = out[1][1][0]
    assert (dec - ref).abs().max() > 10 * LOGIT_TOL * ref.abs().max()


def test_decode_matches_forward_at_full_source():
    """At S_src = src_len_for_decode a decode step equals one full forward
    at JAX's bound (and far inside it)."""
    tcfg, _ = _cfgs()
    _, tp = _weights()
    out, nb = _serve_both("float32", 12, 32, 3)
    toks = [np.asarray(out[i][0][0].argmax(-1))[:, None].astype(np.int32)
            for i in range(2)]
    full = torch.cat([_t(nb["tokens"])] + [_t(t) for t in toks], 1)
    for i in (1, 2):
        ref = TM.forward_logits(tcfg, tp, full[:, :12 + i], at=11 + i,
                                frames=_t(nb["frames"]))
        dec = out[i][1][0]
        np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=JAX_RTOL,
                                   atol=JAX_ATOL)
        _close(dec, ref, LOGIT_TOL)


def test_prefill_and_decode_bf16():
    """bf16 weights and cache: the logits of prefill and two decode steps
    and every cache entry within ``BF16_TOL`` of JAX's largest (bf16
    roundings of the residual stream, a few units of the last place,
    carried through the layers)."""
    out, _ = _serve_both("bfloat16", 12, 32, 2)
    for (jl, jc), (tl, tc) in out:
        _close(tl, jl, BF16_TOL)
        for name in ("k", "v", "k_cross", "v_cross"):
            assert tc[name].dtype == torch.bfloat16
            _close(tc[name].float(), np.asarray(jc[name], np.float32),
                   BF16_TOL)


def test_prefill_source_past_the_cross_cache_raises():
    """JAX's prefill fails past src_len_for_decode (its pad goes
    negative); the port raises ``ValueError``."""
    tcfg, _ = _cfgs()
    _, tp = _weights()
    nb = _batch(tcfg, 2, 8, tcfg.src_len_for_decode + 1)
    cache = TK.init_cache(tcfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="over the cache"):
        TM.forward_prefill(tcfg, tp, {k: _t(v) for k, v in nb.items()},
                           cache)


# ------------------------------------------------------ the serve CLI

@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_serve_cli_on_cpu(capsys, temperature):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "24", "--gen", "4", "--temperature", temperature]
    out = tserve.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 24 tok x2: ")
    assert lines[1].startswith("decode 4 steps: ") and "tok/s" in lines[1]
    assert lines[2] == "generated ids:"
    assert out.shape == (2, 4) and out.dtype == np.int32
    assert ((out >= 0) & (out < tget(ARCH).smoke().padded_vocab)).all()
    np.testing.assert_array_equal(tserve.main(argv), out)    # seeded
