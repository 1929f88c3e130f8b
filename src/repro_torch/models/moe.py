"""Mixture-of-Experts block: top-k routing with capacity-bounded scatter
dispatch (MaxText's "dropping" style, with a scatter and a gather in place
of the O(N·E·C) dispatch einsum).

The port of the JAX package's ``models/moe.py``.  JAX splits the tokens
into G groups, one per data shard of its ``ShardCtx``, and routes each
group on its own; the port has no sharding context, so G = 1: every token
of the batch is in one group.  The (G, N, ·) shapes are kept so that a
sharded slice finds its counterpart.  Routing is JAX's exactly:

  * the router logits are ``x @ router`` in the promoted dtype, widened to
    fp32; softmax, ``torch.topk`` (sorted descending, as ``lax.top_k``),
    gates renormalised over the k chosen;
  * an assignment's rank in its expert is a ``cumsum`` over the flattened
    (N·k) assignments, token-major; a rank at or past the capacity is
    dropped: it goes to the overflow row ``E·cap``, which is cut off;
  * a token's k copies sit next to each other (``repeat_interleave``, JAX's
    ``jnp.repeat``).

The expert FFN (SwiGLU) is one batched product over the experts, as JAX's
``einsum`` is: every expert computes its ``cap`` rows, filled or not.
Arctic's ``dense_residual_d_ff`` MLP runs beside the experts on every
token.  The aux losses (Switch's load balance and the router z-loss) are
computed in every mode, as in JAX.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import apply_mlp, matmul, mlp_defs
from repro_torch.models.params import ParamDef


def moe_defs(cfg) -> Dict[str, ParamDef]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    defs = {
        "router": ParamDef((d, e), ("embed", None), "small"),
        "w_gate": ParamDef((e, d, f), ("experts", "embed", "moe_ff")),
        "w_up": ParamDef((e, d, f), ("experts", "embed", "moe_ff")),
        "w_down": ParamDef((e, f, d), ("experts", "moe_ff", "embed")),
    }
    if cfg.dense_residual_d_ff:
        defs["dense"] = mlp_defs(d, cfg.dense_residual_d_ff)
    return defs


def capacity(cfg, n_tokens: int) -> int:
    """Slots an expert has for ``n_tokens`` tokens: JAX's ``_capacity``,
    the float product truncated by ``int()``, then rounded up to 8."""
    c = int(cfg.capacity_factor * cfg.experts_per_token * n_tokens
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    probs: torch.Tensor   # (G, N, E) fp32 softmax of the router logits
    gate: torch.Tensor    # (G, N, k) fp32, renormalised over the k chosen
    idx: torch.Tensor     # (G, N, k) int64 experts, by descending prob
    keep: torch.Tensor    # (G, N·k) bool: the assignment fits its expert
    dest: torch.Tensor    # (G, N·k) int64 row of the (E·cap + 1) buffer
    cap: int


def router_logits(p, xg: torch.Tensor) -> torch.Tensor:
    """(G, N, E) fp32 logits: ``xg @ router`` in the promoted dtype (the
    model's), then widened, as JAX computes them."""
    return matmul(xg, p["router"]).float()


def route(cfg, logits: torch.Tensor, cap: int) -> Routing:
    """Top-k routing with capacity ``cap`` of (G, N, E) fp32 logits."""
    e, k = cfg.n_experts, cfg.experts_per_token
    g, n, _ = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = idx.reshape(g, n * k)
    counts = F.one_hot(flat_e, e).cumsum(dim=1)            # (G, Nk, E)
    ranks = counts.gather(2, flat_e[..., None])[..., 0] - 1
    keep = ranks < cap
    dest = torch.where(keep, flat_e * cap + ranks,
                       torch.full_like(flat_e, e * cap))
    return Routing(probs, gate, idx, keep, dest, cap)


def _einsum(eq: str, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum`` in the promoted dtype of the two, as JAX computes it."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.einsum(eq, a.to(dt), w.to(dt))


def apply_moe(cfg, p, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) → (B, S, d), and the aux-loss dict."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    g, n = 1, b * s
    xg = x.reshape(g, n, d)
    logits = router_logits(p, xg)
    r = route(cfg, logits, capacity(cfg, n))
    cap = r.cap

    # Switch's load-balance loss (mean router prob times the share of
    # first choices, per expert) and the router z-loss, fp32 scalars.
    me = r.probs.mean(dim=(0, 1))
    ce = F.one_hot(r.idx[..., 0], e).float().mean(dim=(0, 1))
    aux = {"load_balance": e * (me * ce).sum() * cfg.aux_loss_coef,
           "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean()
           * cfg.router_z_loss}

    # Scatter each kept assignment's token row to its slot; the dropped
    # ones all land on the overflow row e·cap, which is cut off.
    rows = e * cap + 1
    x_rep = xg.repeat_interleave(k, dim=1)                  # (G, Nk, d)
    base = torch.arange(g, device=x.device)[:, None] * rows
    buf = x.new_zeros((g * rows, d)).index_add_(
        0, (r.dest + base).reshape(-1), x_rep.reshape(-1, d))
    h = buf.view(g, rows, d)[:, :e * cap].reshape(g, e, cap, d)

    hg = _einsum("gecd,edf->gecf", h, p["w_gate"])
    hu = _einsum("gecd,edf->gecf", h, p["w_up"])
    ho = _einsum("gecf,efd->gecd", F.silu(hg) * hu, p["w_down"])

    out_buf = torch.cat([ho.reshape(g, e * cap, d),
                         ho.new_zeros((g, 1, d))], dim=1)
    y = out_buf.gather(1, r.dest[..., None].expand(g, n * k, d))
    y = y * (r.gate.reshape(g, -1, 1) * r.keep[..., None]).to(y.dtype)
    y = y.reshape(g, n, k, d).sum(dim=2).reshape(b, s, d)

    if cfg.dense_residual_d_ff:
        y = y + apply_mlp(p["dense"], x)
    return y, aux


def apply_moe_no_capacity(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """The reference a batch that drops no assignment is held to: each
    token through its top-k experts one at a time, gate-weighted, in the
    promoted dtype, with no buffer and no capacity (plus the dense
    residual).  A loop over (token, choice) pairs: for a decode step's few
    tokens only."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gate, idx = torch.topk(torch.softmax(router_logits(p, xf[None])[0],
                                         dim=-1),
                           cfg.experts_per_token, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    rows = []
    for t, experts in enumerate(idx.tolist()):
        acc = None
        for j, ex in enumerate(experts):
            h = xf[t:t + 1]
            f = F.silu(matmul(h, p["w_gate"][ex])) * matmul(h, p["w_up"][ex])
            out = matmul(f, p["w_down"][ex]) * gate[t, j].to(f.dtype)
            acc = out if acc is None else acc + out
        rows.append(acc)
    y = torch.cat(rows).reshape(b, s, d)
    if cfg.dense_residual_d_ff:
        y = y + apply_mlp(p["dense"], x)
    return y
