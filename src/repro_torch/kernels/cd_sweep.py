"""One sweep of either solver: the CUDA kernels ``csrc/bak_sweep.cu``
(Algorithm 1) and ``csrc/bakp_sweep.cu`` (Algorithm 2), with their plain
torch versions.

Counterpart of ``repro.kernels.cd_sweep`` (``bak_row_update``,
``cd_sweep``, ``bakp_block_update``, ``bakp_sweep``).

``cd_sweep`` and ``bakp_sweep`` follow the device of the tensors they are
given: CPU tensors run the plain versions (``cd_sweep_plain``,
``bakp_sweep_plain``), CUDA tensors launch the kernels, and anything else
raises.  Both kernels split obs across CTAs: the Algorithm-2 kernel over a
cooperative grid (``csrc/bakp_block.cuh``), the Algorithm-1 kernels over
thread-block clusters in one of three regimes (``bak_grid``,
``csrc/bak_column.cuh``).  The JAX ``cd_sweep``
stages ``block`` rows per grid step and checks a VMEM budget; here
``block`` only has to divide vars (as in JAX), since the Algorithm-1 kernel
walks the columns one at a time whatever the block.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# On-chip budget of the whole-solve kernel's working set, in bytes; replaces
# the JAX package's TPU figure ``VMEM_BUDGET_BYTES`` (64 MiB of VMEM).  The
# port's fused kernel reads x through the L2 cache every sweep, so the
# budget is an L2 figure: 40 MiB, 80% of an H100's 50 MiB L2, leaving the
# rest to the scratch, the residual traffic and other streams' lines (see
# PERF.md).  A fixed constant keeps dispatch deterministic on any host;
# ``fused_fits`` reads it at call time, so tests may patch it.
ON_CHIP_BUDGET_BYTES = 40 * 1024 * 1024

# Shared memory the kernels may take for one block's increments (block·k
# fp32); an H100 block can use up to 227 KB.
SMEM_DA_LIMIT_BYTES = 200 * 1024

# Fewest obs one CTA of the cooperative grid owns.
MIN_OBS_PER_CTA = 128

# CTAs in a thread-block cluster of the Algorithm-1 kernels, from the sweep
# over {2, 4, 8, 16} at the phase 1 shapes (PERF.md); ``bak_grid`` reads it
# at call time.
BAK_CLUSTER = 16

# ``bak_plan``'s regimes and residual placements, by the codes it returns
# (csrc/bak_column.cuh).
BAK_REGIMES = ("single_cluster", "multi_cluster", "e_device", "x_device")
BAK_E_PLACES = ("device", "shared", "registers")

_grid_cache: dict = {}


def bak_row_update(xj: torch.Tensor, inv_j, e: torch.Tensor):
    """One Algorithm-1 column update on loaded values (plain torch).

    Args: xj (1, obs) column; inv_j its inverse squared norm; e (k, obs).
    Returns (da, e'): (1, k) increment and the corrected residual(s).
    """
    da = (xj @ e.T) * inv_j                               # <x_j, e>, (1, k)
    return da, e - da.T @ xj


def cd_sweep_plain(x_t, e2, inv_cn):
    """Plain version of the Algorithm-1 sweep kernel on the (k, obs)
    layout: returns (da (vars, k), e' (k, obs))."""
    nvars = x_t.shape[0]
    inv = inv_cn.reshape(nvars).float()
    e = e2.float()
    da = torch.empty((nvars, e.shape[0]), dtype=torch.float32,
                     device=x_t.device)
    for j in range(nvars):
        d, e = bak_row_update(x_t[j:j + 1].float(), inv[j], e)
        da[j] = d[0]
    return da, e


def bakp_block_update(xb: torch.Tensor, inv: torch.Tensor, e: torch.Tensor,
                      omega: float):
    """One Algorithm-2 block update on loaded values (plain torch).

    Args: xb (CB, obs) block; inv (CB, 1); e (k, obs); omega relaxation.
    Returns (da, e'): (CB, k) increments and the corrected residual(s).
    """
    g = xb @ e.T                                          # (CB, k)
    da = omega * g * inv
    return da, e - da.T @ xb


def bakp_sweep_plain(x_t, e2, inv_cn, *, block, omega=1.0):
    """Plain version of the sweep kernel on the (k, obs) layout: returns
    (da (vars, k), e' (k, obs))."""
    nvars = x_t.shape[0]
    inv = inv_cn.reshape(nvars, 1).float()
    e = e2.float()
    das = []
    for b in range(0, nvars, block):
        da, e = bakp_block_update(x_t[b:b + block].float(), inv[b:b + block],
                                  e, omega)
        das.append(da)
    return torch.cat(das), e


def cooperative_grid(lib_fn, obs: int, k: int, block: int) -> int:
    """CTAs for a cooperative launch: at most what the card holds at once
    for this kernel, and at least ``MIN_OBS_PER_CTA`` obs per CTA."""
    key = (lib_fn.__name__, torch.cuda.current_device(), k, block)
    if key not in _grid_cache:
        out = ctypes.c_int(0)
        _build.check(lib_fn(k, block, ctypes.addressof(out)),
                     lib_fn.__name__)
        _grid_cache[key] = out.value
    return max(1, min(_grid_cache[key], -(-obs // MIN_OBS_PER_CTA)))


class BakPlan(NamedTuple):
    """Launch plan of the Algorithm-1 kernels (``bak_plan``)."""
    regime: str         # one of BAK_REGIMES
    ctas: int
    cluster: int        # CTAs per cluster
    clusters: int
    e_in: str           # where the residual slices live: BAK_E_PLACES
    xchg_words: int     # int32 words of the cross-cluster exchange


def bak_grid(lib_fn, obs: int, k: int) -> BakPlan:
    """Launch plan of the Algorithm-1 kernels: one cluster of
    ``BAK_CLUSTER`` CTAs (fewer for small obs) when the residual slices and
    the x ring fit it, else clusters of ``BAK_CLUSTER`` CTAs, one CTA per SM
    and at least ``MIN_OBS_PER_CTA`` obs each, with the residual slices on
    chip when they fit and in device memory otherwise (``e_device``), and x
    read from device memory too where even the x ring does not fit a CTA
    (``x_device``).  On chip means registers for k <= 8 and at most 12
    positions a thread, else shared memory."""
    cluster = BAK_CLUSTER
    key = (lib_fn.__name__, torch.cuda.current_device(), obs, k, cluster)
    if key not in _grid_cache:
        out = (ctypes.c_int * 6)()
        _build.check(lib_fn(obs, k, MIN_OBS_PER_CTA, cluster,
                            ctypes.addressof(out)), lib_fn.__name__)
        _grid_cache[key] = BakPlan(BAK_REGIMES[out[0]], out[1], out[2],
                                   out[3], BAK_E_PLACES[out[4]], out[5])
    return _grid_cache[key]


def bak_exchange(plan: BakPlan, device) -> "torch.Tensor | None":
    """Zeroed cross-cluster exchange slots for one launch (None for one
    cluster): a sequence number left from an earlier launch would pass the
    kernel's wait."""
    if plan.xchg_words == 0:
        return None
    return torch.zeros((plan.xchg_words,), dtype=torch.int32, device=device)


def check_kernel_args(x_t: torch.Tensor, nrhs: int, block: int, *tensors):
    """What the CUDA kernels take: fp32 contiguous x_t on one device with
    every other operand, vars a multiple of block, and one block's
    increments within shared memory (``block=1`` for the Algorithm-1
    kernels, which hold one column's k increments)."""
    if x_t.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take fp32 x_t, got {x_t.dtype}")
    if not x_t.is_contiguous():
        raise ValueError("x_t must be contiguous (vars, obs)")
    if x_t.shape[0] % block:
        raise ValueError(
            f"vars ({x_t.shape[0]}) must be a multiple of block ({block})")
    for t in tensors:
        if t is not None and t.device != x_t.device:
            raise ValueError(f"operands on {t.device} and {x_t.device}")
    if block * nrhs * 4 > SMEM_DA_LIMIT_BYTES:
        raise ValueError(
            f"block·k = {block}·{nrhs} increments exceed the kernels' "
            f"{SMEM_DA_LIMIT_BYTES} bytes of shared memory; reduce block or "
            f"split the right-hand sides")


def _bakp_sweep_cuda(x_t, e2, inv_cn, *, block, omega):
    nvars, obs = x_t.shape
    nrhs = e2.shape[0]
    check_kernel_args(x_t, nrhs, block, e2, inv_cn)
    lib = _build.load("bakp_sweep")
    dev = x_t.device
    with torch.cuda.device(dev):
        grid = cooperative_grid(lib.bakp_sweep_grid, obs, nrhs, block)
        e_in = e2.float().contiguous()
        inv = inv_cn.float().contiguous()
        e_out = torch.empty_like(e_in)
        da = torch.empty((nvars, nrhs), dtype=torch.float32, device=dev)
        partials = torch.empty((grid, block, nrhs), dtype=torch.float32,
                               device=dev)
        da_buf = torch.empty((block, nrhs), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.LAUNCHES["bakp_sweep"] += 1
        _build.check(lib.bakp_sweep_launch(
            x_t.data_ptr(), inv.data_ptr(), e_in.data_ptr(), e_out.data_ptr(),
            da.data_ptr(), partials.data_ptr(), da_buf.data_ptr(), nvars, obs,
            nrhs, block, float(omega), grid, stream), "bakp_sweep_launch")
    return da, e_out


def _cd_sweep_cuda(x_t, e2, inv_cn):
    nvars, obs = x_t.shape
    nrhs = e2.shape[0]
    check_kernel_args(x_t, nrhs, 1, e2, inv_cn)
    lib = _build.load("bak_sweep")
    dev = x_t.device
    with torch.cuda.device(dev):
        plan = bak_grid(lib.bak_sweep_grid, obs, nrhs)
        e_in = e2.float().contiguous()
        inv = inv_cn.float().contiguous()
        e_out = torch.empty_like(e_in)
        da = torch.empty((nvars, nrhs), dtype=torch.float32, device=dev)
        xchg = bak_exchange(plan, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.LAUNCHES["bak_sweep"] += 1
        _build.PLANS["bak_sweep"] = plan
        _build.check(lib.bak_sweep_launch(
            x_t.data_ptr(), inv.data_ptr(), e_in.data_ptr(), e_out.data_ptr(),
            da.data_ptr(), None if xchg is None else xchg.data_ptr(), nvars,
            obs, nrhs, BAK_REGIMES.index(plan.regime), plan.ctas,
            plan.cluster, stream), "bak_sweep_launch")
    return da, e_out


def _sweep(name, plain, cuda, x_t, e, inv_cn, block_of, **kw):
    """Shared wrapper of the two sweeps: shape checks (vars a multiple of
    ``block_of``), the 1-D ``e`` form and the device rule."""
    nvars, obs = x_t.shape
    if nvars % block_of:
        raise ValueError(
            f"vars ({nvars}) must be a multiple of block ({block_of})")
    single = e.dim() == 1
    e2 = e.reshape(1, obs) if single else e
    if x_t.device.type == "cpu":
        da, e_out = plain(x_t, e2, inv_cn, **kw)
    elif x_t.device.type == "cuda":
        da, e_out = cuda(x_t, e2, inv_cn, **kw)
    else:
        raise ValueError(f"{name} runs on cpu or cuda, not {x_t.device}")
    if single:
        return da[:, 0], e_out[0]
    return da, e_out


def cd_sweep(x_t, e, inv_cn, *, block=256):
    """One paper-faithful Algorithm-1 sweep, strictly in column order.

    Args:
      x_t: (vars, obs) transposed design; vars a multiple of ``block``.
      e: (obs,) residual, or (k, obs) for k right-hand sides.
      inv_cn: (vars,) inverse squared column norms.
    Returns:
      (da, e'): (vars,)/(obs,) for 1-D ``e``, (vars, k)/(k, obs) otherwise.
    """
    return _sweep("cd_sweep", cd_sweep_plain, _cd_sweep_cuda, x_t, e, inv_cn,
                  block)


def bakp_sweep(x_t, e, inv_cn, *, block=256, omega=1.0):
    """One SolveBakP (block-Jacobi) sweep over every column block.

    Args:
      x_t: (vars, obs) transposed design; vars a multiple of ``block``.
      e: (obs,) residual, or (k, obs) for k right-hand sides.
      inv_cn: (vars,) inverse squared column norms.
    Returns:
      (da, e'): (vars,)/(obs,) for 1-D ``e``, (vars, k)/(k, obs) otherwise.
    """
    return _sweep("bakp_sweep", bakp_sweep_plain, _bakp_sweep_cuda, x_t, e,
                  inv_cn, block, block=block, omega=omega)
