"""GQA attention (+qk-norm, softcap, window) with flash-style chunked
computation: an online softmax over (q_chunk x k_chunk) blocks with fp32
statistics, so no (S x S) score tensor is ever built.

The port of the JAX package's ``models/attention.py`` for GQA, in plain
torch ops as JAX writes it in plain XLA (there is no kernel to port).  Two
causal schedules:
  * ``masked``      — every query chunk visits every K/V chunk and masks.
  * ``triangular``  — each query chunk visits only the K/V chunks its
                      causal / window footprint reaches.

``gqa_decode`` writes the new token's K/V into the cache tensors it is
given, in place (JAX returns updated copies).  MLA and the int8 KV cache
wait (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import (apply_rope, matmul, rmsnorm,
                                       rmsnorm_def)
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


def gqa_qkv(cfg, p, x, positions):
    """Project + normalise + rope.  x: (B,S,d) → q (B,S,H,hd), k/v
    (B,S,Hkv,hd)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = matmul(x, p["wq"]).reshape(b, s, h, hd)
    k = matmul(x, p["wk"]).reshape(b, s, hkv, hd)
    v = matmul(x, p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(cfg, p, x, positions, *, window=0, causal=True, q_offset=0):
    """Full-sequence attention (train / prefill).  Returns (out, (k, v))."""
    b, s, _ = x.shape
    q, k, v = gqa_qkv(cfg, p, x, positions)
    o = flash_attention(
        q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap,
        q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk, q_offset=q_offset,
        causal_mode=cfg.causal_mode)
    return matmul(o.reshape(b, s, -1), p["wo"]), (k, v)


def gqa_decode(cfg, p, x, positions, k_cache, v_cache, lengths, *, window=0):
    """One-token decode.  x: (B,1,d); caches (B,Smax,Hkv,hd), written in
    place at slot ``min(lengths - 1, Smax - 1)`` (``lengths`` already counts
    the new token; a ring buffer's slot is ``(lengths - 1) % Smax``).
    Returns (out, k_cache, v_cache)."""
    b = x.shape[0]
    q, k, v = gqa_qkv(cfg, p, x, positions)     # k/v: (B,1,Hkv,hd)
    smax = k_cache.shape[1]
    if window and smax == window:       # ring buffer (SWA)
        slot = (lengths - 1) % smax
    else:
        slot = torch.clamp(lengths - 1, max=smax - 1)
    bidx = torch.arange(b, device=x.device)
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, lengths,
                         window=window, softcap=cfg.attn_softcap)
    return matmul(o.reshape(b, 1, -1), p["wo"]), k_cache, v_cache
