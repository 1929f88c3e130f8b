"""Streamed-obs kernels: the rank-CB residual correction
(``csrc/block_update.cu``) and the SolveBakF feature scores
(``csrc/score_features.cu``), with their plain torch versions.

Counterpart of ``repro.kernels.block_update`` (``block_update``,
``score_features``).  Neither kernel keeps anything on chip across calls,
so obs is unbounded.  The JAX entries take ``col_block`` / ``obs_tile``,
the VMEM tile sizes of the Pallas grid, and assert that they divide vars
and obs; those are TPU constraints, and the CUDA kernels mask their ragged
edges themselves, so the port takes any vars and obs.

Both wrappers follow the device of their tensors: CPU tensors run the
plain version, CUDA tensors launch the kernel, anything else raises.  x is
fp32 or bf16 (``cd_sweep.X_DTYPES``), as the Pallas kernels widen x as
they load it; the kernels widen a bf16 x the same way and count its
launches under ``"<name>_bf16"``.  The other operands are fp32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cd_sweep import SMEM_DA_LIMIT_BYTES, X_DTYPES

# Warps the score kernel aims to keep in flight (32 per SM on 132 SMs);
# with fewer feature rows than this, obs is split into chunks.
_SCORE_TARGET_WARPS = 132 * 32
# Bytes of x a warp loads in one step (32 lanes x 16 bytes): obs per score
# chunk are a multiple of this over x's itemsize (128 fp32, 256 bf16).
_SCORE_CHUNK_BYTES = 32 * 16


def _on(name: str, x: torch.Tensor, *tensors) -> str:
    """The device type ``name`` runs on: that of ``x``, shared by every
    operand."""
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return x.device.type


# ------------------------------------------------------------ block update
def block_update_plain(x_t_blk, e2, da2):
    """Plain version of the block-update kernel on the (k, obs) layout:
    ``e2 - da2ᵀ·x_blk`` with da2 (CB, k)."""
    return e2.float() - da2.float().T @ x_t_blk.float()


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.dtype not in X_DTYPES:
        raise TypeError(f"{name} takes fp32 or bf16 x, got {x.dtype}")


def _block_update_cuda(x_t_blk, e2, da2):
    cb, obs = x_t_blk.shape
    nrhs = e2.shape[0]
    _check_x("block_update", x_t_blk)
    if cb * nrhs * 4 > SMEM_DA_LIMIT_BYTES:
        raise ValueError(
            f"CB·k = {cb}·{nrhs} increments exceed the kernel's "
            f"{SMEM_DA_LIMIT_BYTES} bytes of shared memory")
    lib = _build.load("block_update")
    dev = x_t_blk.device
    with torch.cuda.device(dev):
        x = x_t_blk.contiguous()
        e_in = e2.float().contiguous()
        da = da2.float().contiguous()
        e_out = torch.empty_like(e_in)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.block_update_launch(
            x.data_ptr(), x.element_size(), da.data_ptr(), e_in.data_ptr(),
            e_out.data_ptr(), cb, obs, nrhs, stream), "block_update_launch")
        _build.count_launch(_build.launch_key("block_update",
                                              x.element_size()))
    return e_out


def block_update(x_t_blk, e, da):
    """``e' = e − x_blkᵀ·da`` (paper Algorithm 2, line 9).

    Args:
      x_t_blk: (CB, obs) transposed column block.
      e: (obs,) residual, or (k, obs) multi-RHS residuals.
      da: (CB,) or (CB, k) block coefficient increments.
    Returns:
      The corrected residual, fp32, the same shape as ``e``.
    """
    cb, obs = x_t_blk.shape
    single = e.dim() == 1
    e2 = e.reshape(1, obs) if single else e
    nrhs = e2.shape[0]
    if tuple(e2.shape) != (nrhs, obs) or da.numel() != cb * nrhs:
        raise ValueError(
            f"block_update: x_t_blk {tuple(x_t_blk.shape)}, e "
            f"{tuple(e.shape)} and da {tuple(da.shape)} do not match")
    da2 = da.reshape(cb, nrhs)
    if _on("block_update", x_t_blk, e, da) == "cpu":
        out = block_update_plain(x_t_blk, e2, da2)
    else:
        out = _block_update_cuda(x_t_blk, e2, da2)
    return out[0] if single else out


# --------------------------------------------------------- feature scores
def score_features_plain(x_t, e, inv_cn):
    """Plain version of the score kernel: ``⟨x_j, e⟩²·inv_cn_j``."""
    g = x_t.float() @ e.float()
    return g * g * inv_cn.float()


def score_chunks(nvars: int, obs: int, itemsize: int = 4):
    """``(chunk, nchunks)``: obs per chunk (a multiple of 128 for an fp32
    x, 256 for a bf16 one of ``itemsize`` 2) and their count, enough (row,
    chunk) warps to fill the card where vars alone is too few."""
    align = _SCORE_CHUNK_BYTES // itemsize
    want = max(1, -(-_SCORE_TARGET_WARPS // max(nvars, 1)))
    nchunks = max(1, min(want, -(-obs // align)))
    chunk = -(-obs // nchunks)
    chunk = -(-chunk // align) * align
    return chunk, -(-obs // chunk)


def _score_features_cuda(x_t, e, inv_cn):
    nvars, obs = x_t.shape
    _check_x("score_features", x_t)
    lib = _build.load("score_features")
    dev = x_t.device
    chunk, nchunks = score_chunks(nvars, obs, x_t.element_size())
    with torch.cuda.device(dev):
        x = x_t.contiguous()
        ev = e.float().contiguous()
        inv = inv_cn.float().contiguous()
        out = torch.empty((nvars,), dtype=torch.float32, device=dev)
        part = torch.empty((nchunks if nchunks > 1 else 0, nvars),
                           dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.score_features_launch(
            x.data_ptr(), x.element_size(), ev.data_ptr(), inv.data_ptr(),
            out.data_ptr(), part.data_ptr(), nvars, obs, chunk, nchunks,
            stream), "score_features_launch")
        _build.count_launch(_build.launch_key("score_features",
                                              x.element_size()))
    return out


def score_features(x_t, e, inv_cn):
    """SolveBakF scores for all features, ``⟨x_j, e⟩²/⟨x_j, x_j⟩``, in one
    pass over x.

    Args:
      x_t: (vars, obs); e: (obs,) single residual; inv_cn: (vars,).
    Returns: (vars,) fp32 scores.
    """
    nvars, obs = x_t.shape
    if tuple(e.shape) != (obs,) or tuple(inv_cn.shape) != (nvars,):
        raise ValueError(
            f"score_features: x_t {tuple(x_t.shape)} takes e ({obs},) and "
            f"inv_cn ({nvars},), got {tuple(e.shape)} and "
            f"{tuple(inv_cn.shape)}")
    if _on("score_features", x_t, e, inv_cn) == "cpu":
        return score_features_plain(x_t, e, inv_cn)
    return _score_features_cuda(x_t, e, inv_cn)
