"""Decoder-only transformer assembly for the dense, MoE, VLM, SSM and
hybrid families: the global, sliding-window (SWA) and gemma2 local/global
layer patterns, GQA (with an optional int8 KV cache) or MLA attention,
optional post-norms, a SwiGLU or MoE FFN; Mamba2 blocks (mamba2); and
zamba2's units of Mamba2 blocks, each unit followed by one shared
attention + MLP block specialised by the unit's LoRA deltas, then trailing
Mamba2 blocks.  A loop over stacked layer parameters, the cache read and
written per mode.

The port of the JAX package's ``models/transformer.py``.  ``run_backbone``
returns final hidden states, the new cache entries and the auxiliary
losses (the MoE losses summed over layers, zero elsewhere); embedding,
unembedding and the cache bookkeeping live in model.py.  JAX scans over the
stacked layers and returns a new cache from each step; this loops over the
layer index and writes each layer's entries into the cache it is given, in
place.  In train mode each loop body (a layer, a gemma2 pair, a hybrid
unit) runs under ``remat`` as ``cfg.remat`` says; the enc-dec stacks
(``models/encdec.py``) share it.

A window on the ``global`` layer pattern raises ``NotImplementedError``
(``check_supported``), so nothing silently runs a different model.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (NULL_CTX, apply_mlp, matmul,
                                       mlp_defs, rmsnorm, rmsnorm_def,
                                       stacked)
from repro_torch.models.moe import apply_moe, moe_defs
from repro_torch.models.params import ParamDef, tree_map, unstack
from repro_torch.models.ssm import apply_ssm, ssm_defs

# The MoE losses of a block without experts, and the start of their sum.
ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a configuration this port does not
    run.

    A sliding window on the ``global`` layer pattern raises: the JAX
    package sizes a ring cache for it but attends without the window, and
    its prefill fails once a prompt passes the window; no config uses it.
    """
    if cfg.sliding_window > 0 and cfg.layer_pattern == "global":
        raise NotImplementedError(
            f"{cfg.name}: not ported (family {cfg.family!r}, layer_pattern "
            f"{cfg.layer_pattern!r}, sliding_window {cfg.sliding_window}); "
            f"ROADMAP.md queue 1 item 1a, the SWA ring cache, on the swa "
            f"pattern only (a window on the global pattern is not run by "
            f"the JAX package either)")
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid",
                          "encdec") or \
            cfg.layer_pattern not in ("global", "swa", "alt_local_global"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / layer_pattern "
            f"{cfg.layer_pattern!r} is not ported (ROADMAP.md queue 1)")


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the matrix products without
    batch dims (``x @ w``: aten ``mm`` / ``addmm``; JAX's
    ``checkpoint_dots_with_no_batch_dims``) and recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg, fn, *args):
    """``fn(*args)`` under ``cfg.remat`` where autograd records it, as JAX
    wraps each layer loop's body (``_remat``): ``full`` keeps only the
    body's inputs and recomputes the rest in backward
    (``torch.utils.checkpoint``), ``dots`` keeps the matrix products'
    outputs too (selective checkpointing), ``none`` runs it plainly.  The
    numbers do not change with the setting.  JAX's
    ``optimization_barrier`` (it stops XLA saving fp32 copies of the
    carried activations) has no counterpart: torch saves what it is
    given.  ``fn`` is called again in backward, so it must take
    everything it reads from the loop as ``args``."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)


def dense_block_defs(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    attn = (attn_lib.mla_defs(cfg) if cfg.attn_type == "mla"
            else attn_lib.gqa_defs(cfg))
    ffn = moe_defs(cfg) if cfg.n_experts else mlp_defs(d, cfg.d_ff)
    defs = {"ln1": rmsnorm_def(d), "attn": attn,
            "ln2": rmsnorm_def(d), "ffn": ffn}
    if cfg.post_norm:
        defs["post1"] = rmsnorm_def(d)
        defs["post2"] = rmsnorm_def(d)
    return defs


def _prefill_kv(cfg, k4, v4, window):
    """A layer's produced K/V (B, S, Hkv, hd) as its cache entries: the
    last min(window, S) tokens of a windowed layer, rolled so token t sits
    at slot t % window; int8 codes and scales where the cache is int8;
    K/V flat (B, smax, Hkv·hd)."""
    b, s, hkv, hd = k4.shape
    smax = min(window, s) if window else s
    k_keep, v_keep = k4[:, -smax:], v4[:, -smax:]
    if window and s > smax:
        shift = s % smax
        k_keep = torch.roll(k_keep, shift, dims=1)
        v_keep = torch.roll(v_keep, shift, dims=1)
    if cfg.kv_quant == "int8":
        kq8, ks = attn_lib.quantize_kv(k_keep)
        vq8, vs = attn_lib.quantize_kv(v_keep)
        return (kq8.reshape(b, smax, hkv * hd), vq8.reshape(b, smax, hkv * hd),
                ks, vs)
    return (k_keep.reshape(b, smax, hkv * hd),
            v_keep.reshape(b, smax, hkv * hd))


def apply_dense_block(cfg, p, x, *, positions, mode, window=0, kv=None,
                      lengths=None, ctx=NULL_CTX, q_offset=0):
    """One pre-norm block (post-norms on the attention and FFN outputs
    where ``cfg.post_norm``; the MoE FFN where ``cfg.n_experts``).
    Returns (x', new_kv, aux): aux the MoE losses, else ``ZERO_AUX``.

    ``kv``: decode mode's cache slices, each (B, Smax, ·), written in place
    and returned: (k_flat, v_flat) for GQA, (k, v, k_scale, v_scale) for
    the int8 cache, (c_kv, k_rope) for MLA.  In prefill mode new_kv holds
    the layer's cache entries as ``_prefill_kv`` (or MLA's latent pair)
    makes them; in train mode it is None.
    """
    h = rmsnorm(x, p["ln1"])
    if cfg.attn_type == "mla":
        if mode == "decode":
            o, _, _ = attn_lib.mla_decode(cfg, p["attn"], h, positions,
                                          kv[0], kv[1], lengths)
            new_kv = kv
        else:
            o, latent = attn_lib.mla_attend(cfg, p["attn"], h, positions,
                                            q_offset=q_offset)
            new_kv = None if mode == "train" else latent
    elif mode == "decode":
        # The cache itself, (B, Smax, Hkv·hd): the decode writes it before
        # it views it by head (``attention._write_slot``).
        if cfg.kv_quant == "int8":
            o, *_ = attn_lib.gqa_decode_quant(
                cfg, p["attn"], h, positions, kv[0], kv[1], kv[2], kv[3],
                lengths, window=window)
        else:
            o, _, _ = attn_lib.gqa_decode(cfg, p["attn"], h, positions,
                                          kv[0], kv[1], lengths,
                                          window=window)
        new_kv = kv
    else:
        o, (k4, v4) = attn_lib.gqa_attend(cfg, p["attn"], h, positions,
                                          window=window, q_offset=q_offset)
        new_kv = None if mode == "train" else _prefill_kv(cfg, k4, v4,
                                                          window)
    if cfg.post_norm:
        o = rmsnorm(o, p["post1"])
    x = ctx.constrain(x + o, "batch", None, None)
    h = rmsnorm(x, p["ln2"])
    if cfg.n_experts:
        f, aux = apply_moe(cfg, p["ffn"], h, ctx)
    else:
        f, aux = apply_mlp(p["ffn"], h), dict(ZERO_AUX)
    if cfg.post_norm:
        f = rmsnorm(f, p["post2"])
    return ctx.constrain(x + f, "batch", None, None), new_kv, aux


def ssm_block_defs(cfg) -> Dict[str, Any]:
    return {"ln": rmsnorm_def(cfg.d_model), "ssm": ssm_defs(cfg)}


def apply_ssm_block(cfg, p, x, *, mode, conv_state=None, ssm_state=None,
                    ctx=NULL_CTX):
    """One pre-norm Mamba2 block.  Returns (x', conv_state', ssm_state')."""
    y, (conv_state, ssm_state) = apply_ssm(
        cfg, p["ssm"], rmsnorm(x, p["ln"]), conv_state=conv_state,
        ssm_state=ssm_state, mode=mode)
    return (ctx.constrain(x + y, "batch", None, None), conv_state,
            ssm_state)


def _shared_block_defs(cfg) -> Dict[str, Any]:
    """Zamba2's shared transformer block and a unit's LoRA deltas on its
    QKV (the ``b_*`` start at zero)."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    r, kv = cfg.shared_lora_rank, cfg.n_kv_heads * hd
    shared = {"ln1": rmsnorm_def(d), "attn": attn_lib.gqa_defs(cfg),
              "ln2": rmsnorm_def(d), "ffn": mlp_defs(d, cfg.d_ff)}
    lora = {
        "a_q": ParamDef((d, r), ("embed", None), "small"),
        "b_q": ParamDef((r, h * hd), (None, "model"), "zeros"),
        "a_k": ParamDef((d, r), ("embed", None), "small"),
        "b_k": ParamDef((r, kv), (None, "model"), "zeros"),
        "a_v": ParamDef((d, r), ("embed", None), "small"),
        "b_v": ParamDef((r, kv), (None, "model"), "zeros"),
    }
    return shared, lora


def backbone_defs(cfg) -> Dict[str, Any]:
    check_supported(cfg)
    if cfg.family == "ssm":
        return {"layers": stacked(ssm_block_defs(cfg), cfg.n_layers)}
    if cfg.family == "hybrid":
        shared, lora = _shared_block_defs(cfg)
        mamba = stacked(ssm_block_defs(cfg), cfg.mamba_per_unit, "layers")
        return {"units": stacked({"mamba": mamba, "lora": lora},
                                 cfg.hybrid_units, "units"),
                "shared": shared,
                "tail": stacked(ssm_block_defs(cfg), cfg.trailing_mamba)}
    if cfg.layer_pattern == "alt_local_global":
        pair = {"local": dense_block_defs(cfg),
                "global": dense_block_defs(cfg)}
        return {"pairs": stacked(pair, cfg.n_layers // 2)}
    return {"layers": stacked(dense_block_defs(cfg), cfg.n_layers)}


def _shared_attn_params(shared, lora):
    """Zamba2: the shared block with one unit's LoRA deltas added to its
    QKV weights, ``w + a @ b`` in the parameters' dtype, as JAX forms it
    once per unit invocation."""
    attn = dict(shared["attn"])
    for w, a, b in (("wq", "a_q", "b_q"), ("wk", "a_k", "b_k"),
                    ("wv", "a_v", "b_v")):
        attn[w] = attn[w] + matmul(lora[a], lora[b])
    return {**shared, "attn": attn}


def _block_runs(cfg):
    """(sub-tree of a stacked layer, window, its cache entries) for each
    block a layer index runs: a gemma2 pair's local then global block, or
    the one block of every other pattern."""
    if cfg.layer_pattern == "alt_local_global":
        return [("local", cfg.sliding_window, ("k_local", "v_local")),
                ("global", 0, ("k_global", "v_global"))]
    window = cfg.sliding_window if cfg.layer_pattern == "swa" else 0
    if cfg.attn_type == "mla":
        names = ("c_kv", "k_rope")
    elif cfg.kv_quant == "int8":
        names = ("k", "v", "k_scale", "v_scale")
    else:
        names = ("k", "v")
    return [(None, window, names)]


def _write_prefill_entry(buf, entry):
    """Write a layer's produced prefill entry (B, S', ·) into its cache
    slice (B, Smax, ·) in place and zero the slots past S': JAX's zero pad
    to the buffer's shape, without a second cache."""
    s = entry.shape[1]
    if s > buf.shape[1]:
        raise ValueError(f"prefill produced {s} slots, over the cache's "
                         f"{buf.shape[1]}")
    buf[:, :s].copy_(entry)
    buf[:, s:].zero_()


class _Entries:
    """Where a prefill's or a decode's new cache entries go: each written
    into its slice of the cache in place (a K/V entry by
    ``_write_prefill_entry``, a state by ``copy_``), or, in a prefill
    without a cache, collected and stacked over the layer dims at the end
    (``lead``: the stacked dims of an entry, when more than one)."""

    def __init__(self, cache, lead=None):
        self.cache, self.lead = cache, lead or {}
        self.produced: Dict[str, list] = {}

    def put(self, name, index, t, kv=False):
        if self.cache is None:
            self.produced.setdefault(name, []).append(t)
        elif kv:
            _write_prefill_entry(self.cache[name][index], t)
        else:
            self.cache[name][index].copy_(t)

    def stacked(self):
        return {name: torch.stack(ts).unflatten(0, self.lead.get(
                    name, (len(ts),)))
                for name, ts in self.produced.items()}


def _ssm_layer(cfg, p, x, *, mode, entries, names, index, from_cache,
               ctx):
    """One Mamba2 block at ``index`` of the cache entries ``names`` (conv
    state, SSM state).  It starts from the cache's states where
    ``from_cache`` (decode; the SSM family's prefill, whose scan JAX feeds
    the cache), else from zeros (the hybrid's prefill), and writes its
    new states to ``entries``."""
    if mode == "train":
        return apply_ssm_block(cfg, p, x, mode=mode, ctx=ctx)[0]
    cache = entries.cache
    cs = ss = None
    if from_cache and cache is not None:
        cs, ss = (cache[n][index] for n in names)
    x, cs, ss = apply_ssm_block(cfg, p, x, mode=mode, conv_state=cs,
                                ssm_state=ss, ctx=ctx)
    for name, t in zip(names, (cs, ss)):
        entries.put(name, index, t)
    return x


def _run_dense(cfg, params, x, *, mode, positions, cache, lengths, q_offset,
               entries, ctx):
    runs = _block_runs(cfg)
    if len(runs) == 2:
        stack, n = params["pairs"], cfg.n_layers // 2
    else:
        stack, n = params["layers"], cfg.n_layers

    def index(x, p, i):
        """The blocks of layer index ``i`` (a gemma2 pair's two)."""
        aux, new = dict(ZERO_AUX), []
        for sub, window, own in runs:
            kv = (tuple(cache[name][i] for name in own)
                  if mode == "decode" else None)
            x, new_kv, a = apply_dense_block(
                cfg, p if sub is None else p[sub], x, positions=positions,
                mode=mode, window=window, kv=kv, lengths=lengths, ctx=ctx,
                q_offset=q_offset)
            aux = {k: aux[k] + a[k] for k in aux}
            new.append((own, new_kv))
        return x, aux, new

    aux = dict(ZERO_AUX)
    for i, p in enumerate(unstack(stack, n)):
        if mode == "train":
            x, a = remat(cfg, lambda x, p, i: index(x, p, i)[:2], x, p, i)
        else:
            x, a, new = index(x, p, i)
        aux = {k: aux[k] + a[k] for k in aux}
        if mode == "prefill":
            for own, new_kv in new:
                for name, t in zip(own, new_kv):
                    entries.put(name, i, t, kv=True)
    return x, [name for _, _, own in runs for name in own], aux


def _run_ssm(cfg, params, x, *, mode, entries, ctx):
    for i, p in enumerate(unstack(params["layers"], cfg.n_layers)):
        if mode == "train":
            x = remat(cfg, lambda x, p: apply_ssm_block(
                cfg, p, x, mode=mode, ctx=ctx)[0], x, p)
            continue
        x = _ssm_layer(cfg, p, x, mode=mode, entries=entries,
                       names=("conv", "ssm"), index=i, from_cache=True,
                       ctx=ctx)
    return x, ["conv", "ssm"]


def _run_hybrid(cfg, params, x, *, mode, positions, cache, lengths,
                q_offset, entries, ctx):
    b, s, _ = x.shape
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    decode = mode == "decode"

    def unit(x, up, shared, u):
        """Unit ``u``: its Mamba2 blocks, then the shared block."""
        for m, mp in enumerate(unstack(up["mamba"], cfg.mamba_per_unit)):
            x = _ssm_layer(cfg, mp, x, mode=mode, entries=entries,
                           names=("conv", "ssm"), index=(u, m),
                           from_cache=decode, ctx=ctx)
        sp = _shared_attn_params(shared, up["lora"])
        h = rmsnorm(x, sp["ln1"])
        if decode:
            o, _, _ = attn_lib.gqa_decode(
                cfg, sp["attn"], h, positions, cache["k"][u],
                cache["v"][u], lengths)
        else:
            o, (k4, v4) = attn_lib.gqa_attend(cfg, sp["attn"], h, positions,
                                              q_offset=q_offset)
            if mode == "prefill":
                entries.put("k", u, k4.reshape(b, s, hkv * hd), kv=True)
                entries.put("v", u, v4.reshape(b, s, hkv * hd), kv=True)
        x = ctx.constrain(x + o, "batch", None, None)
        x = x + apply_mlp(sp["ffn"], rmsnorm(x, sp["ln2"]))
        return ctx.constrain(x, "batch", None, None)

    for u, up in enumerate(unstack(params["units"], cfg.hybrid_units)):
        x = (remat(cfg, unit, x, up, params["shared"], u) if mode == "train"
             else unit(x, up, params["shared"], u))
    for t, tp in enumerate(unstack(params["tail"], cfg.trailing_mamba)):
        if mode == "train":
            x = remat(cfg, lambda x, p: apply_ssm_block(
                cfg, p, x, mode=mode, ctx=ctx)[0], x, tp)
            continue
        x = _ssm_layer(cfg, tp, x, mode=mode, entries=entries,
                       names=("conv_tail", "ssm_tail"), index=t,
                       from_cache=decode, ctx=ctx)
    return x, ["conv", "ssm", "k", "v", "conv_tail", "ssm_tail"]


def run_backbone(cfg, params, x, *, mode, positions, cache=None,
                 lengths=None, ctx=NULL_CTX, q_offset=0):
    """Run all layers.  x: (B, S, d) embedded inputs; ``mode`` "train",
    "prefill" or "decode"; ``positions`` (B, S), or (3, B, S) under
    M-RoPE.

    Returns (hidden, new_cache_entries, aux).  Prefill's entries are the
    produced cache entries stacked over layers (or layer pairs, or units
    and their layers), (L, B, smax, ·) for K/V, or, given a ``cache``, its
    own tensors with each layer's entries written in place as it runs
    (``_write_prefill_entry``); decode's are the cache's own tensors, each
    layer's new token (or new states) written in place; train returns
    none.  A gemma2 pair runs its local (windowed) layer, then its global
    one.  The SSM family's prefill starts from the cache's states (zero in
    a fresh cache), as JAX's; the hybrid's from zeros.  ``aux`` sums each
    MoE layer's losses over the layers.  ``ctx`` constrains the residual
    stream after each block, where JAX's does, and groups the MoE's
    tokens by data shard.
    """
    check_supported(cfg)
    lead = ({"conv": (cfg.hybrid_units, cfg.mamba_per_unit),
             "ssm": (cfg.hybrid_units, cfg.mamba_per_unit)}
            if cfg.family == "hybrid" else None)
    entries = _Entries(cache if mode != "train" else None, lead)
    aux = dict(ZERO_AUX)
    if cfg.family == "ssm":
        x, names = _run_ssm(cfg, params, x, mode=mode, entries=entries,
                            ctx=ctx)
    elif cfg.family == "hybrid":
        x, names = _run_hybrid(cfg, params, x, mode=mode,
                               positions=positions, cache=cache,
                               lengths=lengths, q_offset=q_offset,
                               entries=entries, ctx=ctx)
    else:
        x, names, aux = _run_dense(cfg, params, x, mode=mode,
                                   positions=positions, cache=cache,
                                   lengths=lengths, q_offset=q_offset,
                                   entries=entries, ctx=ctx)
    if mode == "prefill" and cache is None:
        new_cache = entries.stacked()
    elif mode != "train":
        new_cache = {name: cache[name] for name in names}
    else:
        new_cache = {}
    return x, new_cache, aux
