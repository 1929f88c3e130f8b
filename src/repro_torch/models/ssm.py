"""Mamba2 / SSD (state-space duality) block, arXiv:2405.21060.

The port of the JAX package's ``models/ssm.py``.  Train and prefill run
the chunked SSD algorithm: the sequence is split into chunks of
``ssm_chunk`` (or of the whole sequence, if shorter); within a chunk the
quadratic "attention-like" form runs as batched products, across chunks a
linear recurrence carries the (heads × head_dim × state) SSM state, a loop
over the chunks where JAX scans.  Decode is the O(1) recurrent update.
Everything inside ``ssd_chunked`` is fp32; its output is cast back to the
input's dtype before the gated norm.

Layer structure (Mamba2):
  in_proj → [z | xBC | dt],  causal depthwise conv over xBC, SiLU,
  SSD(x·dt, exp(dt·A), B, C) + D·x,  gated RMSNorm(·, z), out_proj.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import gated_rmsnorm, matmul, rmsnorm_def
from repro_torch.models.params import ParamDef


def ssm_dims(cfg):
    """(d_inner, SSM heads, conv channels) of a config."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def ssm_defs(cfg) -> Dict[str, ParamDef]:
    d = cfg.d_model
    din, nh, conv_dim = ssm_dims(cfg)
    return {
        "in_proj": ParamDef((d, din + conv_dim + nh), ("embed", "model")),
        "conv_w": ParamDef((cfg.ssm_conv, conv_dim), (None, "model")),
        "conv_b": ParamDef((conv_dim,), ("model",), "zeros"),
        "a_log": ParamDef((nh,), ("model",), "zeros"),
        "d_skip": ParamDef((nh,), ("model",), "ones"),
        "dt_bias": ParamDef((nh,), ("model",), "zeros"),
        "norm": rmsnorm_def(din),
        "out_proj": ParamDef((din, d), ("model", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C); state: (B, K-1,
    C), the K-1 inputs before x (zeros if None).

    Returns (y (B, S, C), new_state (B, K-1, C)): the new state is the
    last K-1 rows of [state | x], so state rows where S < K-1.
    """
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xx = torch.cat([state, x], dim=1)                 # (B, S+K-1, C)
    y = sum(xx[:, i:i + x.shape[1]] * w[i][None, None] for i in range(k))
    new_state = xx[:, -(k - 1):] if k > 1 else state
    return y + b[None, None], new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums: out[..., i, j] = sum over
    (j, i] of a, the log-domain decay matrix of SSD; -inf above the
    diagonal, so its ``exp`` is 0 there.  a: (..., Q)."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a_neg, bmat, cmat, *, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan, in fp32.

    x:     (B, S, H, P)  inputs (already x·dt)
    dt:    (B, S, H)     discretisation steps (softplus'd)
    a_neg: (H,)          negative continuous-time A (dA = dt·a_neg ≤ 0)
    bmat:  (B, S, G, N)  input mixers (group g serves H/G heads in a row)
    cmat:  (B, S, G, N)  output mixers
    h0:    (B, H, P, N)  initial state (zeros if None)
    Returns (y (B, S, H, P), h_final (B, H, P, N)).
    """
    b, s0, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    # Pad the sequence to a chunk multiple; padded steps carry dt = 0, so
    # their decay is exp(0) = 1 and their state contribution dt·B⊗x is 0.
    s = -(-s0 // chunk) * chunk
    if s != s0:
        x = F.pad(x, (0, 0, 0, 0, 0, s - s0))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, s - s0))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, s - s0))
        dt = F.pad(dt, (0, 0, 0, s - s0))
    nc = s // chunk
    rep = h // g

    def to_chunks(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc = to_chunks(x.float())
    dac = to_chunks((dt * a_neg[None, None]).float())          # (B,nc,Q,H)
    bc = to_chunks(bmat.float()).repeat_interleave(rep, dim=3)  # (B,nc,Q,H,N)
    cc = to_chunks(cmat.float()).repeat_interleave(rep, dim=3)

    da_h = dac.movedim(-1, 2)                # (B,nc,H,Q)
    seg = torch.exp(_segsum(da_h))           # (B,nc,H,Q,Q) intra-chunk decay
    cum = torch.cumsum(da_h, dim=-1)         # (B,nc,H,Q)
    total = cum[..., -1]                     # (B,nc,H)

    # Intra-chunk (quadratic): y_ij = C_i·B_j seg_ij x_j.
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc) * seg
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores, xc)

    # Chunk states: S_c = sum_j exp(total - cum_j) B_j ⊗ x_j.
    decay_tail = torch.exp(total[..., None] - cum)             # (B,nc,H,Q)
    states = torch.einsum("bchq,bcqhn,bcqhp->bchpn", decay_tail, bc, xc)

    # Inter-chunk recurrence: the state entering each chunk.
    hprev = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * torch.exp(total[:, c])[..., None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                      # (B,nc,H,P,N)

    # Inter-chunk output: y_i += C_i · h_prev · exp(cum_i).
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", cc, h_prevs) * \
        torch.exp(cum.movedim(2, -1))[..., None]               # (B,nc,Q,H,1)

    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s0]
    return y, hprev


def apply_ssm(cfg, p, x: torch.Tensor, *, conv_state=None, ssm_state=None,
              mode: str = "train"):
    """Mamba2 block.  x: (B, S, d).

    mode "train" / "prefill": chunked SSD over the whole sequence from
    (conv_state, ssm_state) (zeros if None).  mode "decode": the S == 1
    recurrent update of (conv_state, ssm_state).
    Returns (y, (conv_state', ssm_state')): the conv state in x's dtype,
    the SSM state in fp32.
    """
    b, s, _ = x.shape
    din, nh, conv_dim = ssm_dims(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    hd = cfg.ssm_head_dim

    zxbcdt = matmul(x, p["in_proj"])
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + conv_dim]
    dt_raw = zxbcdt[..., din + conv_dim:]
    # softplus as jax.nn.softplus: log(1 + exp(.)), with no threshold.
    dt = torch.logaddexp(dt_raw.float() + p["dt_bias"].float(),
                         torch.zeros((), device=x.device))      # (B,S,H)
    a_neg = -torch.exp(p["a_log"].float())                      # (H,)

    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :din].reshape(b, s, nh, hd)
    bmat = xbc[..., din:din + g * n].reshape(b, s, g, n)
    cmat = xbc[..., din + g * n:].reshape(b, s, g, n)

    if mode == "decode":
        if s != 1:
            raise ValueError(f"decode takes one token a row, got {s}")
        da = torch.exp(dt[:, 0] * a_neg[None])                  # (B,H)
        xdt = xs[:, 0].float() * dt[:, 0][..., None]            # (B,H,P)
        bmat1 = bmat[:, 0].repeat_interleave(nh // g, dim=1)    # (B,H,N)
        cmat1 = cmat[:, 0].repeat_interleave(nh // g, dim=1)
        if ssm_state is None:
            ssm_state = torch.zeros((b, nh, hd, n), dtype=torch.float32,
                                    device=x.device)
        ssm_state = ssm_state * da[..., None, None] + \
            torch.einsum("bhp,bhn->bhpn", xdt, bmat1.float())
        y = torch.einsum("bhpn,bhn->bhp", ssm_state, cmat1.float())
        y = y + p["d_skip"].float()[None, :, None] * xs[:, 0].float()
        y = y.reshape(b, 1, din).to(x.dtype)
    else:
        xdt = xs.float() * dt[..., None]
        y, ssm_state = ssd_chunked(xdt, dt, a_neg, bmat, cmat,
                                   chunk=min(cfg.ssm_chunk, s), h0=ssm_state)
        y = y + p["d_skip"].float()[None, None, :, None] * xs.float()
        y = y.reshape(b, s, din).to(x.dtype)

    y = gated_rmsnorm(y, z, p["norm"])
    return matmul(y, p["out_proj"]), (conv_state, ssm_state)
