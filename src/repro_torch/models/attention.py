"""Attention: GQA (+qk-norm, softcap, window, M-RoPE) and MLA, with
flash-style chunked computation: an online softmax over (q_chunk x
k_chunk) blocks with fp32 statistics, so no (S x S) score tensor is ever
built.

The port of the JAX package's ``models/attention.py``, in plain torch ops
as JAX writes it in plain XLA (there is no kernel to port).  Two causal
schedules:
  * ``masked``      — every query chunk visits every K/V chunk and masks.
  * ``triangular``  — each query chunk visits only the K/V chunks its
                      causal / window footprint reaches.

Enc-dec cross-attention is ``gqa_attend`` with ``kv_override``: the
encoder's keys and values, no rope, no causal mask.  The decode functions
(``gqa_decode``, ``gqa_decode_quant`` on the int8
cache, ``mla_decode`` on the latent cache) write the new token into the
cache tensors they are given, in place (JAX returns updated copies), and
attend over the whole cache widened to fp32 with the unwritten slots
masked, as JAX does.  A ring buffer (a window's cache of exactly
``window`` slots) writes slot ``(lengths - 1) % Smax``; any other cache
``min(lengths - 1, Smax - 1)``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import (apply_mrope, apply_rope, matmul,
                                       rmsnorm, rmsnorm_def)
from repro_torch.models.params import ParamDef

_NEG = -2.0e30


# ---------------------------------------------------------------------------
# Flash-style chunked attention core
# ---------------------------------------------------------------------------

def _attn_block(qc, kc, vc, q_pos, k_pos, *, causal, window, softcap, scale,
                kv_valid):
    """One (q_chunk x k_chunk) attention block with online-softmax stats.

    qc: (B, Qc, Hkv, G, D); kc/vc: (B, Kc, Hkv, D).
    Returns (m, l, acc): s-max (B,Hkv,G,Qc), sumexp, weighted V.
    """
    s = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(), kc.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = k_pos[None, :] < kv_valid          # padded KV masked out
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    s = s.masked_fill(~mask, _NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, vc.float())
    return m, l, acc


def _merge(m1, l1, a1, m2, l2, a2):
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return m, l1 * c1 + l2 * c2, a1 * c1[..., None] + a2 * c2[..., None]


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_chunk: int = 512,
    k_chunk: int = 1024,
    q_offset: int = 0,
    causal_mode: str = "masked",
) -> torch.Tensor:
    """q: (B,Sq,H,D); k/v: (B,Sk,Hkv,D) → (B,Sq,H,D).

    ``q_offset`` is the absolute position of q[.,0] (prefill continuation).
    """
    b, sq0, h, d = q.shape
    _, sk0, hkv, _ = k.shape
    g = h // hkv
    scale = d ** -0.5
    q_chunk = min(q_chunk, sq0)
    k_chunk = min(k_chunk, sk0)
    # Pad both sequence dims to chunk multiples; padded KV positions are
    # masked, padded Q rows are sliced off at the end.
    sq = -(-sq0 // q_chunk) * q_chunk
    sk = -(-sk0 // k_chunk) * k_chunk
    if sq != sq0:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq - sq0))
    if sk != sk0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sk - sk0))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sk - sk0))
    nq, nk = sq // q_chunk, sk // k_chunk
    q5 = q.reshape(b, sq, hkv, g, d)
    ar_q = torch.arange(q_chunk, device=q.device)
    ar_k = torch.arange(k_chunk, device=q.device)

    def run_q_chunk(qi, kv_range):
        qc = q5[:, qi * q_chunk:(qi + 1) * q_chunk]
        qp = q_offset + qi * q_chunk + ar_q
        m = torch.full((b, hkv, g, q_chunk), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hkv, g, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        for ki in kv_range:
            sl = slice(ki * k_chunk, (ki + 1) * k_chunk)
            blk = _attn_block(qc, k[:, sl], v[:, sl], qp, ki * k_chunk + ar_k,
                              causal=causal, window=window, softcap=softcap,
                              scale=scale, kv_valid=sk0)
            m, l, acc = _merge(m, l, acc, *blk)
        out = acc / torch.clamp(l, min=1e-30)[..., None]    # (B,Hkv,G,Qc,D)
        return out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, d)

    outs = []
    for qi in range(nq):
        lo, hi = 0, nk
        if causal_mode == "triangular" and causal:
            hi = min(nk, (q_offset + (qi + 1) * q_chunk - 1) // k_chunk + 1)
            if window:
                lo = max(0, (q_offset + qi * q_chunk - window) // k_chunk)
        outs.append(run_q_chunk(qi, range(lo, hi)))
    out = torch.cat(outs, dim=1)
    return out[:, :sq0].to(q.dtype)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor, *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffer) cache.

    q: (B,1,H,D); caches: (B,Smax,Hkv,D); lengths: (B,) tokens already in
    cache INCLUDING the current one.  The whole cache is widened to fp32
    and the slots at or past ``lengths`` are masked, as in JAX.  For ring
    buffers (window>0, Smax == window) every slot older than ``window`` has
    been overwritten, so all written slots are valid.
    """
    b, _, h, d = q.shape
    _, smax, hkv, _ = k_cache.shape
    g = h // hkv
    scale = d ** -0.5
    q5 = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", q5.float(), k_cache.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    slot = torch.arange(smax, device=q.device)
    valid = slot[None, :] < torch.clamp(lengths, max=smax)[:, None]
    s = s.masked_fill(~valid[:, None, None], _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# int8 KV-cache quantization
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8.  x: (..., hkv, hd) → (q int8,
    scale fp32 (..., hkv)); rounds half to even, as ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype
                  ) -> torch.Tensor:
    """The codes times their scale in fp32, rounded to ``dtype`` (the
    model's) before any attention widens them again, as JAX does."""
    return (q.float() * scale[..., None].float()).to(dtype)


def _cache_slot(lengths, smax, window):
    """The slot a decode step writes: ``(lengths - 1) % Smax`` in a ring
    buffer (a window's cache of exactly ``window`` slots), else
    ``min(lengths - 1, Smax - 1)``."""
    if window and smax == window:
        return (lengths - 1) % smax
    return torch.clamp(lengths - 1, max=smax - 1)


def _write_slot(cache, slot, new):
    """``cache[b, slot[b]] = new[b]`` for every row b, in place: cache (B,
    Smax, ...), new (B, ...) with as many elements a row as the cache's
    trailing dims (reshaped to them).  A scatter along the slot dim, so a
    cache sharded on its batch or its trailing dim (a DTensor) is written
    shard by shard.  The caller passes the cache itself, never a view
    that splits its trailing dim: on a DTensor whose shards do not divide
    the split, the view is a gathered copy, and a write there would miss
    the shards."""
    new = new.reshape((new.shape[0],) + tuple(cache.shape[2:]))
    idx = slot.long().view((-1, 1) + (1,) * (new.dim() - 1)).expand(
        (new.shape[0], 1) + tuple(new.shape[1:]))
    cache.scatter_(1, idx, new.unsqueeze(1))


def gqa_decode_quant(cfg, p, x, positions, kq8, vq8, ks, vs, lengths, *,
                     window=0):
    """One-token decode against an int8 ring or linear cache.

    kq8/vq8: (B, Smax, Hkv, hd) or the cache's own (B, Smax, Hkv·hd) int8;
    ks/vs: (B, Smax, Hkv) fp32, all written in place at the new token's
    slot (``_write_slot``).  The whole cache is dequantized to the model
    dtype for the step.  Returns (out, kq8, vq8, ks, vs) as given.
    """
    b = x.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = gqa_qkv(cfg, p, x, positions)        # k/v: (B,1,Hkv,hd)
    slot = _cache_slot(lengths, kq8.shape[1], window)
    kq_new, ks_new = quantize_kv(k[:, 0])
    vq_new, vs_new = quantize_kv(v[:, 0])
    for buf, new in ((kq8, kq_new), (vq8, vq_new), (ks, ks_new),
                     (vs, vs_new)):
        _write_slot(buf, slot, new)
    k4 = dequantize_kv(kq8.view(b, -1, hkv, hd), ks, x.dtype)
    v4 = dequantize_kv(vq8.view(b, -1, hkv, hd), vs, x.dtype)
    o = decode_attention(q, k4, v4, lengths, window=window,
                         softcap=cfg.attn_softcap)
    return matmul(o.reshape(b, 1, -1), p["wo"]), kq8, vq8, ks, vs


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def gqa_defs(cfg) -> Dict[str, ParamDef]:
    d, h, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    kv_axis = None if cfg.replicate_kv else "model"
    defs = {
        "wq": ParamDef((d, h * hd), ("embed", "model")),
        "wk": ParamDef((d, hkv * hd), ("embed", kv_axis)),
        "wv": ParamDef((d, hkv * hd), ("embed", kv_axis)),
        "wo": ParamDef((h * hd, d), ("model", "embed")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_def(hd)
        defs["k_norm"] = rmsnorm_def(hd)
    return defs


def gqa_query(cfg, p, x):
    """The queries alone, projected and normalised, unroped: (B,S,H,hd).
    Cross-attention's side of the decoder (its keys and values come from
    the encoder)."""
    b, s, _ = x.shape
    q = matmul(x, p["wq"]).reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)
    return rmsnorm(q, p["q_norm"]) if cfg.qk_norm else q


def gqa_qkv(cfg, p, x, positions, *, rope=True):
    """Project + normalise + rope (none where ``rope`` is False, as JAX's
    enc-dec cross-attention asks).  x: (B,S,d) → q (B,S,H,hd), k/v
    (B,S,Hkv,hd)."""
    b, s, _ = x.shape
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    q = gqa_query(cfg, p, x)
    k = matmul(x, p["wk"]).reshape(b, s, hkv, hd)
    v = matmul(x, p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    if not rope:
        return q, k, v
    if cfg.mrope_sections:              # positions: (3, B, S)
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(cfg, p, x, positions, *, window=0, causal=True, q_offset=0,
               kv_override=None):
    """Full-sequence attention (train / prefill).  Returns (out, (k, v)).

    ``kv_override`` (k, v), each (B, S_kv, Hkv, hd), is enc-dec
    cross-attention: the queries (``gqa_query``; JAX projects K/V of ``x``
    too and XLA drops them) attend those keys and values with no rope on
    either side and no causal mask, and (k, v) are returned."""
    b, s, _ = x.shape
    if kv_override is not None:
        q, (k, v), causal = gqa_query(cfg, p, x), kv_override, False
    else:
        q, k, v = gqa_qkv(cfg, p, x, positions)
    o = flash_attention(
        q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap,
        q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk, q_offset=q_offset,
        causal_mode=cfg.causal_mode)
    return matmul(o.reshape(b, s, -1), p["wo"]), (k, v)


def gqa_decode(cfg, p, x, positions, k_cache, v_cache, lengths, *, window=0):
    """One-token decode.  x: (B,1,d); caches (B,Smax,Hkv,hd) or the
    cache's own (B,Smax,Hkv·hd), written in place at slot ``min(lengths -
    1, Smax - 1)`` (``lengths`` already counts the new token; a ring
    buffer's slot is ``(lengths - 1) % Smax``; ``_write_slot``), then read
    as (B,Smax,Hkv,hd).  Returns (out, k_cache, v_cache) as given."""
    b = x.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = gqa_qkv(cfg, p, x, positions)     # k/v: (B,1,Hkv,hd)
    slot = _cache_slot(lengths, k_cache.shape[1], window)
    _write_slot(k_cache, slot, k[:, 0].to(k_cache.dtype))
    _write_slot(v_cache, slot, v[:, 0].to(v_cache.dtype))
    o = decode_attention(q, k_cache.view(b, -1, hkv, hd),
                         v_cache.view(b, -1, hkv, hd), lengths,
                         window=window, softcap=cfg.attn_softcap)
    return matmul(o.reshape(b, 1, -1), p["wo"]), k_cache, v_cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek style)
# ---------------------------------------------------------------------------

def mla_defs(cfg) -> Dict[str, ParamDef]:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "q_down": ParamDef((d, qr), ("embed", None)),
        "q_norm": rmsnorm_def(qr),
        "q_up": ParamDef((qr, h * (dn + dr)), (None, "model")),
        "kv_down": ParamDef((d, kvr + dr), ("embed", None)),
        "kv_norm": rmsnorm_def(kvr),
        "k_up": ParamDef((kvr, h * dn), (None, "model")),
        "v_up": ParamDef((kvr, h * dv), (None, "model")),
        "wo": ParamDef((h * dv, d), ("model", "embed")),
    }


def _mla_project_q(cfg, p, x, positions):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr) roped)."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    ql = rmsnorm(matmul(x, p["q_down"]), p["q_norm"])
    q = matmul(ql, p["q_up"]).reshape(b, s, cfg.n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(cfg, p, x, positions):
    """The compressed KV stream: (c_kv (B,S,kvr) normed, k_rope (B,S,dr)
    roped)."""
    kv = matmul(x, p["kv_down"])
    kvr = cfg.kv_lora_rank
    c_kv = rmsnorm(kv[..., :kvr], p["kv_norm"])
    k_rope = apply_rope(kv[..., kvr:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_attend(cfg, p, x, positions, *, q_offset=0):
    """Train / prefill MLA: per-head K/V expanded from the latent stream
    through the shared flash path (Hkv == H; v zero-padded to the qk
    width, sliced after).  Returns (out, (c_kv, k_rope)), the latent pair
    being what the cache stores."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_project_q(cfg, p, x, positions)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = matmul(c_kv, p["k_up"]).reshape(b, s, h, dn)
    v = matmul(c_kv, p["v_up"]).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1)
    v_pad = torch.nn.functional.pad(v, (0, dn + dr - dv))
    o = flash_attention(q, k, v_pad, causal=True, q_chunk=cfg.q_chunk,
                        k_chunk=cfg.k_chunk, q_offset=q_offset,
                        causal_mode=cfg.causal_mode)[..., :dv]
    return matmul(o.reshape(b, s, -1), p["wo"]), (c_kv, k_rope)


def mla_decode(cfg, p, x, positions, ckv_cache, krope_cache, lengths):
    """Absorbed-matmul MLA decode: q_nope times k_up's transpose lands in
    the latent space, so scores and values come from the latent cache
    without expanding it to per-head K/V (fp32 einsums, as JAX's).  The
    caches (B, Smax, kvr) and (B, Smax, dr) are written in place at slot
    ``min(lengths - 1, Smax - 1)``; slots at or past ``lengths`` are
    masked.  Returns (out, ckv_cache, krope_cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv, kvr = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                       cfg.kv_lora_rank)
    q_nope, q_rope = _mla_project_q(cfg, p, x, positions)   # (B,1,H,.)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)        # (B,1,.)
    smax = ckv_cache.shape[1]
    slot = _cache_slot(lengths, smax, 0)
    _write_slot(ckv_cache, slot, c_kv[:, 0].to(ckv_cache.dtype))
    _write_slot(krope_cache, slot, k_rope[:, 0].to(krope_cache.dtype))

    ckv = ckv_cache.float()
    k_up = p["k_up"].reshape(kvr, h, dn).float()
    q_lat = torch.einsum("bhd,khd->bhk", q_nope[:, 0].float(), k_up)
    s_lat = torch.einsum("bhk,bsk->bhs", q_lat, ckv)
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                          krope_cache.float())
    s = (s_lat + s_rope) * (dn + dr) ** -0.5
    valid = torch.arange(smax, device=x.device)[None] < lengths[:, None]
    s = s.masked_fill(~valid[:, None], _NEG)
    pattn = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsk->bhk", pattn, ckv)          # (B,H,kvr)
    v_up = p["v_up"].reshape(kvr, h, dv).float()
    o = torch.einsum("bhk,khd->bhd", o_lat, v_up)
    o = o.reshape(b, 1, h * dv).to(x.dtype)
    return matmul(o, p["wo"]), ckv_cache, krope_cache
