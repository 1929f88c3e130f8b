"""Shared model components: RMSNorm, RoPE, the SwiGLU MLP, embeddings.

The port of the JAX package's ``models/common.py`` for the decoder-only
families.  Every module follows the defs/apply pattern: ``*_defs`` returns
a tree of ``ParamDef``, the functions take a matching tree of tensors.
Activations stay in their dtype; norms and rope (and M-RoPE) compute in
fp32.

Matmuls follow JAX's dtype promotion: ``x @ w`` with an fp32 ``x`` and a
bf16 ``w`` computes in fp32 (``matmul``), where ``torch.matmul`` would
raise on the mixed dtypes.  ``softmax_xent`` is the training loss.
``ShardCtx`` is the sharding context the forwards take (``NULL_CTX``: no
mesh).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (divisible_spec, mesh_axes,
                                              placements)
from repro_torch.models.params import ParamDef, tree_map


def stacked(defs, n: int, axis_name: str = "layers"):
    """Prepend a stacking dim (the layer loop's) to every ParamDef."""
    return tree_map(lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes,
                                       d.init, d.scale), defs)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as JAX computes it."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_def(dim: int) -> ParamDef:
    return ParamDef((dim,), (None,), "ones")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's out-norm, in JAX's order: RMSNorm(x) * silu(z), the gate
    computed in fp32 and cast to x's dtype before the product."""
    return rmsnorm(x, w, eps) * F.silu(z.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) — half-split, not
    interleaved.  x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                    # (D/2,)
    ang = positions.float()[..., None] * inv                # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the D/2 frequency slots are split into
    ``sections`` = (t, h, w) groups, and group g rotates by position
    stream g.  x: (B, S, H, D); positions: (3, B, S) int."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    inv = rope_freqs(d, theta, x.device)                    # (D/2,)
    pos = positions.float()
    # Section by section (slices, no index tensor: nothing waits on the
    # device).
    bounds = [sum(sections[:g]) for g in range(len(sections) + 1)]
    ang = torch.cat([pos[g][..., None] * inv[bounds[g]:bounds[g + 1]]
                     for g in range(len(sections))], dim=-1)  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("embed", "model")),
        "w_up": ParamDef((d_model, d_ff), ("embed", "model")),
        "w_down": ParamDef((d_ff, d_model), ("model", "embed")),
    }


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    return matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_defs(vocab: int, d_model: int, tie: bool
                   ) -> Dict[str, ParamDef]:
    defs = {"tok": ParamDef((vocab, d_model), ("model", "embed"), "small")}
    if not tie:
        defs["out"] = ParamDef((d_model, vocab), ("embed", "model"), "small")
    return defs


def embed_tokens(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["tok"][tokens].to(dtype)


def unembed(p, x: torch.Tensor, *, tie: bool, final_softcap: float = 0.0
            ) -> torch.Tensor:
    """fp32 logits over the padded vocab; the weight is cast to ``x``'s
    dtype first, as JAX does."""
    w = p["tok"].T if tie else p["out"]
    logits = (x @ w.to(x.dtype)).float()
    if final_softcap:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    return logits


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32 (the log-sum-exp too).  logits
    (..., V), labels (...) int; with ``mask`` (...) the mean over the
    masked-in tokens (at least one counted)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    # The label's logit is subtracted before its trailing dim is dropped:
    # on vocab-sharded DTensor logits the gather is a masked partial sum,
    # which DTensor can reduce only at the gather's own shape.
    nll = (lse[..., None] - logits.gather(-1, labels[..., None].long()))[
        ..., 0]
    if mask is not None:
        maskf = mask.float()
        return (nll * maskf).sum() / torch.clamp(maskf.sum(), min=1.0)
    return nll.mean()


class ShardCtx:
    """Optional sharding context threaded through the forward pass.

    Holds the mesh (a port ``Mesh`` or a torch ``DeviceMesh``) and the
    logical-axis rules (``distributed.sharding.make_rules``).
    ``data_shards`` is the product of the mesh's non-``model`` axes: the
    MoE routes each data shard's tokens as a group of its own
    (``moe.apply_moe``), as JAX's does under a mesh.

    ``constrain(x, *axes)`` is the counterpart of JAX's
    ``with_sharding_constraint``: a ``DTensor`` is redistributed to the
    placements of ``divisible_spec`` for those logical axes; a plain
    tensor, or any tensor without a mesh, is returned as it is (one
    controller holds the whole tensor, as on the port's virtual shards).
    """

    def __init__(self, mesh=None, rules=None):
        self.mesh = mesh
        self.rules = rules or {}
        self.data_shards = 1
        if mesh is not None:
            for name, size in mesh_axes(mesh).items():
                if name != "model":
                    self.data_shards *= size

    def constrain(self, x, *axes):
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        spec = divisible_spec(
            self.mesh, x.shape,
            [self.rules.get(a) if a is not None else None for a in axes])
        want = placements(self.mesh, spec)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)


NULL_CTX = ShardCtx()
