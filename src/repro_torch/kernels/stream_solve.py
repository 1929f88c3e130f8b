"""Streaming whole-solve SolveBakP: the CUDA kernel ``csrc/stream_solve.cu``,
its plain torch version, and the out-of-core host-block loop.

Counterpart of ``repro.kernels.stream_solve``.  The whole-solve kernel
(``fused_solve``) is admitted only while the design fits the L2 budget;
this one leaves x in device memory and streams it, so a design of any size
that fits the card keeps the single-launch, early-exit solve.  Each CTA of
a persistent grid of thread-block clusters keeps its residual slice in
shared memory for the whole solve and copies its (block × L) slice of
every column block's tile into a two-stage shared-memory ring one block
step ahead of the compute (see the source), so x crosses device memory
once per sweep.

Fit check: a CTA's shared memory (the block step's exchange arrays, the
ring and its residual slice, ``stream_smem_bytes``) must fit
``cd_sweep.SMEM_PER_CTA_BYTES``.  The launch is ``cd_sweep.bakp_plan``'s:
clusters of ``cd_sweep.BAKP_CLUSTER["stream"]`` CTAs, at most
``cd_sweep.MAX_CTAS`` CTAs, at most as many clusters as an H100 holds at
once (``cd_sweep.CARD_CLUSTERS``) and at least
``cd_sweep.MIN_OBS_PER_CTA`` obs a CTA; every constant lives in
``cd_sweep`` alone and is read at call time, so dispatch is the same on
any host and tests may patch them there.
On the card the wrapper plans with the card's SM count and the clusters
the CUDA runtime says it holds, and raises if that plan does not fit.

x_t is fp32 or bf16; a bf16 x halves the ring (``stream_smem_bytes`` at
itemsize 2) and the bytes a sweep reads.

``stream_solve`` follows the device of its tensors: CPU tensors run the
plain version (``stream_solve_plain``), CUDA tensors launch the kernel,
anything else raises.

``stream_solve_blocks`` is the out-of-core entry: a host loop over a block
source (``shape``, ``num_blocks(thr)``, ``block_t(thr, j)``, as
``repro_torch.store.StoreBlockSource``) for designs whose bytes stay in
host memory.  Plain torch on the device of ``inv_cn``: on a GPU each tile
goes through a pinned staging buffer (unless the source hands out pinned
memory) and its host-to-device copy runs on a side stream while the
previous tile computes; the stop flag is read once per sweep.
"""
from __future__ import annotations

import importlib
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import SolveResult, atol_to_sse, sweep_stop_flags
from repro_torch.kernels import _build
from repro_torch.kernels.fused_solve import (fused_solve_plain, solve_init,
                                             validate_solver_args)

# Budget and block math live with the per-sweep kernel: its constants
# (``SMEM_PER_CTA_BYTES``, ``MAX_CTAS``, ...) are read there at call time.
_cd = importlib.import_module("repro_torch.kernels.cd_sweep")


def stream_x_resident_bytes(block: int, obs: int, itemsize: int) -> int:
    """x bytes on chip during a streaming solve: every CTA's two ring
    stages together hold two (block, obs) tiles, whatever ``vars`` is."""
    return 2 * block * obs * itemsize


def stream_plan(obs: int, nrhs: int = 1, *, block: int = 256,
                itemsize: int = 4, ctas: Optional[int] = None,
                max_clusters: Optional[int] = None) -> "_cd.BakpPlan":
    """The launch plan (``cd_sweep.BakpPlan``) for x of ``itemsize`` bytes
    an element on at most ``ctas`` SMs (default ``cd_sweep.MAX_CTAS``) and
    ``max_clusters`` clusters (default what an H100 holds at once)."""
    cap = _cd.MAX_CTAS if ctas is None else min(_cd.MAX_CTAS, ctas)
    return _cd.bakp_plan("stream", obs, nrhs, block, itemsize=itemsize,
                         max_ctas=cap, max_clusters=max_clusters)


def stream_smem_bytes(obs: int, nrhs: int, itemsize: int, *, block: int,
                      ctas: Optional[int] = None) -> int:
    """Shared memory of one CTA, the plan's own count: the block step's
    exchange arrays (``cd_sweep.bakp_exchange_bytes``), the ring
    (2·block·L·itemsize) and the residual slice (k·L·4)."""
    return stream_plan(obs, nrhs, block=block, itemsize=itemsize,
                       ctas=ctas).smem


def stream_fits(nvars: int, obs: int, nrhs: int, itemsize: int, *,
                block: int, max_iter: int = 1) -> bool:
    """Whether a streaming solve's per-CTA shared memory fits
    ``cd_sweep.SMEM_PER_CTA_BYTES``.  ``nvars`` and ``max_iter`` do not enter: the
    coefficients and the history stay in device memory."""
    return (stream_smem_bytes(obs, nrhs, itemsize, block=block)
            <= _cd.SMEM_PER_CTA_BYTES)


def stream_solve_plain(x_t, inv_cn, e0, a0m, *, block, max_iter, atol_sse,
                       rtol, omega):
    """Plain version of the streaming kernel on its own operands: the
    whole-solve Algorithm-2 loop (``fused_solve_plain``), which shares its
    block step and stopping rule.  Returns (coef, e, history, sse,
    n_sweeps, converged)."""
    return fused_solve_plain(x_t, inv_cn, e0, a0m, block=block,
                             max_iter=max_iter, atol_sse=atol_sse, rtol=rtol,
                             omega=omega, variant="bakp")


def stream_cuda(x_t, inv_cn, e0, a0m, *, block, max_iter, atol_sse, rtol,
                omega):
    """The CUDA kernel on the plain version's operands and outputs."""
    nvars, obs = x_t.shape
    nrhs = e0.shape[0]
    _cd.check_kernel_args(x_t, nrhs, block, inv_cn, e0, a0m)
    lib = _build.load("stream_solve")
    dev = x_t.device
    with torch.cuda.device(dev):
        plan = _cd.bakp_grid(lib.stream_solve_clusters, "stream", obs, nrhs,
                             block, itemsize=x_t.element_size())
        if plan.smem > _cd.SMEM_PER_CTA_BYTES:
            raise ValueError(
                f"stream_solve needs {plan.smem} bytes of shared memory per "
                f"CTA on {plan.ctas} CTAs, over {_cd.SMEM_PER_CTA_BYTES}; use "
                f"the per-sweep path (solvebakp_persweep_kernel)")
        inv = inv_cn.float().contiguous()
        e0c = e0.float().contiguous()
        a0c = a0m.float().contiguous()
        f32 = dict(dtype=torch.float32, device=dev)
        coef = torch.empty((nvars, nrhs), **f32)
        e = torch.empty((nrhs, obs), **f32)
        hist = torch.empty((max_iter,), **f32)
        sse = torch.empty((1,), **f32)
        n = torch.empty((1,), dtype=torch.int32, device=dev)
        conv = torch.empty((1,), dtype=torch.int32, device=dev)
        # Tags: one a block step, one a per-sweep SSE (and the first).
        xchg, tag0 = _cd.bakp_exchange(
            plan, dev, max(max_iter * (nvars // block), max_iter + 1))
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = _build.launch_key("stream_solve", x_t.element_size())
        _build.LAUNCHES[key] += 1
        _build.PLANS[key] = plan
        _build.check(lib.stream_solve_launch(
            x_t.data_ptr(), x_t.element_size(), inv.data_ptr(),
            e0c.data_ptr(), a0c.data_ptr(), coef.data_ptr(), e.data_ptr(),
            hist.data_ptr(), sse.data_ptr(), n.data_ptr(), conv.data_ptr(),
            None if xchg is None else xchg.data_ptr(), tag0, nvars, obs, nrhs,
            block, max_iter, float(atol_sse), float(rtol), float(omega),
            _cd.BAKP_REGIMES.index(plan.regime), plan.ctas, plan.cluster,
            plan.smem, stream), "stream_solve_launch")
    return coef, e, hist, sse[0], n[0], conv[0] != 0


def stream_solve(
    x_t: torch.Tensor,
    y: torch.Tensor,
    *,
    inv_cn: Optional[torch.Tensor] = None,
    cn: Optional[torch.Tensor] = None,
    a0: Optional[torch.Tensor] = None,
    block: int = 256,
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    omega: float = 1.0,
) -> SolveResult:
    """Streaming whole-solve SolveBakP (see module doc).

    Arguments as ``fused_solve`` minus ``variant`` (Algorithm 2 only).
    ``x_t`` may be any size that fits the card; only the per-CTA shared
    memory (``stream_smem_bytes``) must fit ``cd_sweep.SMEM_PER_CTA_BYTES``.
    """
    nvars, obs = x_t.shape
    if nvars % block != 0:
        raise ValueError(
            f"vars ({nvars}) must be a multiple of block ({block}); pad "
            f"columns (PreparedDesign.x_t_for does this)")
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    multi, nrhs, inv_cn = validate_solver_args(x_t, y, cn, inv_cn, a0)
    smem = stream_smem_bytes(obs, nrhs, x_t.element_size(), block=block)
    if smem > _cd.SMEM_PER_CTA_BYTES:
        raise ValueError(
            f"stream_solve needs {smem} bytes of shared memory per CTA, "
            f"over {_cd.SMEM_PER_CTA_BYTES}; reduce block ({block}) / nrhs "
            f"({nrhs}), or use the per-sweep path")
    inv_cn, a0m, e0 = solve_init(x_t, y, inv_cn, a0, multi)
    kw = dict(block=block, max_iter=max_iter,
              atol_sse=atol_to_sse(obs, nrhs, atol), rtol=float(rtol),
              omega=float(omega))
    if x_t.device.type == "cpu":
        coef, e, hist, sse, n, conv = stream_solve_plain(x_t, inv_cn, e0,
                                                         a0m, **kw)
    elif x_t.device.type == "cuda":
        coef, e, hist, sse, n, conv = stream_cuda(x_t, inv_cn, e0, a0m, **kw)
    else:
        raise ValueError(f"stream_solve runs on cpu or cuda, not {x_t.device}")
    if not multi:
        return SolveResult(coef[:, 0], e[0], sse, n, conv, hist)
    return SolveResult(coef, e.T, sse, n, conv, hist)


class _TileFeed:
    """Tiles ``j`` of a block source on ``device``.

    On a GPU, two slots: ``prefetch(j)`` puts tile ``j`` in a pinned
    staging buffer (or takes the source's own pinned tile) and copies it to
    the slot's device buffer on a side stream; ``take(j)`` makes the
    current stream wait for that copy; ``release(j)`` marks the compute
    that read the slot, which the next copy into it waits for.  The host
    refills a staging buffer only after its previous copy has finished.
    On the CPU the tile is used as the source returns it.
    """

    def __init__(self, blocks, block: int, device: torch.device):
        self.blocks, self.block, self.device = blocks, block, device
        self.cuda = device.type == "cuda"
        if self.cuda:
            obs = blocks.shape[0]
            f32 = dict(dtype=torch.float32)
            self.staging = [torch.empty((block, obs), pin_memory=True, **f32)
                            for _ in range(2)]
            self.dev = [torch.empty((block, obs), device=device, **f32)
                        for _ in range(2)]
            self.side = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.freed = [torch.cuda.Event() for _ in range(2)]
            self.src = [None, None]           # keeps a pinned source alive

    def _host(self, j: int) -> torch.Tensor:
        tile = self.blocks.block_t(self.block, j)
        if isinstance(tile, torch.Tensor):
            return tile.to(torch.float32)
        return torch.from_numpy(np.asarray(tile, np.float32))

    def prefetch(self, j: int) -> None:
        if not self.cuda:
            return
        slot = j % 2
        tile = self._host(j)
        self.copied[slot].synchronize()       # the staging buffer is free
        if not (tile.is_pinned() and tile.is_contiguous()):
            self.staging[slot].copy_(tile)
            tile = self.staging[slot]
        self.src[slot] = tile
        with torch.cuda.stream(self.side):
            self.side.wait_event(self.freed[slot])
            self.dev[slot].copy_(tile, non_blocking=True)
            self.copied[slot].record(self.side)

    def take(self, j: int) -> torch.Tensor:
        if not self.cuda:
            return self._host(j).to(self.device)
        slot = j % 2
        torch.cuda.current_stream(self.device).wait_event(self.copied[slot])
        return self.dev[slot]

    def release(self, j: int) -> None:
        if self.cuda:
            self.freed[j % 2].record(torch.cuda.current_stream(self.device))


def stream_solve_blocks(
    blocks,
    y,
    *,
    inv_cn: torch.Tensor,
    a0=None,
    block: int = 256,
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    omega: float = 1.0,
) -> SolveResult:
    """Out-of-core SolveBakP over a block source (host-memory designs).

    ``blocks`` has ``shape`` (obs, vars) and ``block_t(thr, j)``, the
    (thr, obs) fp32 tile ``j`` of the transposed layout (a tensor or an
    array).  The solve runs on the device of ``inv_cn``, which must already
    be in the thr-padded layout (``PreparedDesign.inv_cn_for(block)``); one
    tile is on the device at a time, plus the next one in flight.  The
    block update (``cd_sweep.bakp_block_update``) and the stopping rule
    (``sweep_stop_flags``) are the resident paths', so the results agree
    to fp32 rounding.  With ``max_iter < 1`` it returns the start point.
    """
    obs_p, vars_p = blocks.shape
    nblocks = -(-vars_p // block)
    vars_pb = nblocks * block
    dev = inv_cn.device
    if not torch.is_tensor(y):
        y = torch.from_numpy(np.asarray(y, np.float32))
    y = y.to(device=dev, dtype=torch.float32)
    if y.dim() not in (1, 2):
        raise ValueError(f"y must be (obs,) or (obs, k), got {tuple(y.shape)}")
    multi = y.dim() == 2
    nrhs = y.shape[1] if multi else 1
    if a0 is not None and tuple(a0.shape) not in ((vars_pb,), (vars_pb, nrhs)):
        raise ValueError(
            f"a0 must be ({vars_pb},) or ({vars_pb}, {nrhs}), "
            f"got {tuple(a0.shape)}")
    inv = inv_cn.float().reshape(vars_pb, 1)
    e = y.reshape(obs_p, nrhs).T.contiguous()
    feed = _TileFeed(blocks, block, dev)

    def tiles():
        """(j, tile) over every block, the next tile's copy in flight."""
        feed.prefetch(0)
        for j in range(nblocks):
            if j + 1 < nblocks:
                feed.prefetch(j + 1)
            yield j, feed.take(j)
            feed.release(j)

    a = torch.zeros((vars_pb, nrhs), dtype=torch.float32, device=dev)
    if a0 is not None:               # a copy: the loop adds into ``a``
        a0 = torch.as_tensor(np.asarray(a0, np.float32)
                             if not torch.is_tensor(a0) else a0)
        a.copy_(a0.reshape(vars_pb, -1).expand(vars_pb, nrhs))
        for j, xb in tiles():       # e0 = y.T - a0.T @ x_t, one tile a time
            e = e - a[j * block:(j + 1) * block].T @ xb
    sse0 = torch.dot(e.reshape(-1), e.reshape(-1))
    atol_sse = atol_to_sse(obs_p, nrhs, atol)
    hist = torch.full((max(max_iter, 0),), math.nan, dtype=torch.float32,
                      device=dev)
    sse, n, converged = sse0, 0, torch.tensor(False)
    while n < max_iter:
        for j, xb in tiles():
            sl = slice(j * block, (j + 1) * block)
            da, e = _cd.bakp_block_update(xb, inv[sl], e, omega)
            a[sl] += da
        sse_new = torch.dot(e.reshape(-1), e.reshape(-1))
        hist[n] = sse_new
        converged, stop = sweep_stop_flags(sse_new, sse, sse0, atol_sse,
                                           float(rtol))
        sse, n = sse_new, n + 1
        if bool(stop):                       # the one host read per sweep
            break
    n_t = torch.tensor(n, dtype=torch.int32)
    if not multi:
        return SolveResult(a[:, 0], e[0], sse, n_t, converged, hist)
    return SolveResult(a, e.T, sse, n_t, converged, hist)
