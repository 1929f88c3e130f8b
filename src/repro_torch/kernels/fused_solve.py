"""Whole-solve SolveBak / SolveBakP: the CUDA kernels ``csrc/bak_fused.cu``
(``variant="bak"``, Algorithm 1) and ``csrc/fused_solve.cu``
(``variant="bakp"``, Algorithm 2), with their plain torch version.

Counterpart of ``repro.kernels.fused_solve``: one launch runs every sweep
of the solve, reduces the per-sweep SSE and evaluates ``sweep_stop_flags``
on the card, and exits early without a host synchronisation per sweep.  It
takes precomputed ``inv_cn``, a warm start ``a0`` and k ≥ 1 right-hand
sides sharing one x.  ``variant="bak"`` walks the columns strictly in order
and updates ``coef`` row by row; it has no relaxation, so ``omega`` is
ignored there, as in the JAX kernel.

Fit check: ``fused_fits`` admits a solve whose working set
(``fused_working_set_bytes``) fits ``cd_sweep.ON_CHIP_BUDGET_BYTES``; the
callers (``ops.solvebakp_kernel``, the ``bakp_fused`` method) dispatch on it.
The Algorithm-2 kernel's launch is ``cd_sweep.bakp_plan("fused", ...)``:
thread-block clusters of ``cd_sweep.BAKP_CLUSTER["fused"]`` CTAs, each CTA
keeping its slice of x in shared memory for the whole solve where it fits
(``x_in`` "shared", the x_shared regime), else reading each block's tile
from the L2 ("ring" or "direct", the x_l2 regime), with the right-hand
sides of a block step in groups where one exchange of all of them does not
fit a CTA; every admitted solve is one launch with one joint stop.

x_t is fp32 or bf16 (precision "bf16": the handle's ``x_bf16_for``).  The
kernels read a bf16 x as it is stored and widen it as they load it, the
plain version one row or block at a time; everything else is fp32, and
the fit check and the plan count x at its itemsize, so a bf16 design twice
as large fits.  A warm start's ``e0 = y − a0ᵀ·x_t`` is a plain matrix
product on the widened x (``solve_init``), as the JAX package computes it
outside its kernel.

``fused_solve`` follows the device of its tensors: CPU tensors run the
plain version (``fused_solve_plain``, a host loop that reads the stop flag
once per sweep), CUDA tensors launch the kernel, anything else raises.
"""
from __future__ import annotations

import importlib
import math
from typing import Optional

import torch

from repro_torch.core.types import (SolveResult, atol_to_sse,
                                    column_norms_sq_t, safe_inv,
                                    sweep_stop_flags)
from repro_torch.kernels import _build

# The budget and kernel-argument checks live with the per-sweep kernel;
# read the module at call time so a patched budget takes effect.
_cd = importlib.import_module("repro_torch.kernels.cd_sweep")


def fused_working_set_bytes(nvars: int, obs: int, nrhs: int, itemsize: int,
                            *, max_iter: int = 1) -> int:
    """Bytes one fused solve keeps on chip: x (nvars·obs·itemsize), the
    residual in and out (2·k·obs·4), a0 and coef (2·nvars·k·4), inv_cn
    (nvars·4) and the history (max_iter·4)."""
    return (nvars * obs * itemsize
            + 2 * nrhs * obs * 4
            + 2 * nvars * nrhs * 4
            + nvars * 4
            + max_iter * 4)


def fused_fits(nvars: int, obs: int, nrhs: int, itemsize: int,
               *, max_iter: int = 1) -> bool:
    """Whether a fused solve fits ``cd_sweep.ON_CHIP_BUDGET_BYTES``."""
    return fused_working_set_bytes(nvars, obs, nrhs, itemsize,
                                   max_iter=max_iter) <= _cd.ON_CHIP_BUDGET_BYTES


def validate_solver_args(x_t, y, cn, inv_cn, a0):
    """Shared shape validation and norm resolution for the kernel solver
    entries.  Returns (multi, nrhs, inv_cn), with ``cn`` folded into
    ``inv_cn`` when only the raw norms were given."""
    nvars, obs = x_t.shape
    if y.dim() not in (1, 2):
        raise ValueError(f"y must be (obs,) or (obs, k), got {tuple(y.shape)}")
    multi = y.dim() == 2
    nrhs = y.shape[1] if multi else 1
    if a0 is not None and tuple(a0.shape) not in ((nvars,), (nvars, nrhs)):
        raise ValueError(
            f"a0 must be ({nvars},) or ({nvars}, {nrhs}) matching x_t rows "
            f"and y RHS count, got {tuple(a0.shape)}")
    if inv_cn is None and cn is not None:
        inv_cn = safe_inv(cn)
    return multi, nrhs, inv_cn


def solve_init(x_t, y, inv_cn, a0, multi):
    """Shared initialisation of the fused and per-sweep paths: the inverse
    norms, and the (vars, k) coefficients and (k, obs) residual
    ``e0 = y2ᵀ − a0mᵀ·x_t`` in fp32; a (vars,) ``a0`` broadcasts over k.

    Returns ``(inv_cn, a0m, e0)``.
    """
    nvars, obs = x_t.shape
    nrhs = y.shape[1] if multi else 1
    if inv_cn is None:
        inv_cn = safe_inv(column_norms_sq_t(x_t))
    y2 = y.reshape(obs, nrhs).float()
    if a0 is None:
        a0m = torch.zeros((nvars, nrhs), dtype=torch.float32, device=x_t.device)
        e0 = y2.T.contiguous()
    else:
        a0m = a0.float().reshape(nvars, -1).expand(nvars, nrhs).contiguous()
        e0 = y2.T - a0m.T @ x_t.float()
    return inv_cn, a0m, e0


VARIANTS = ("bakp", "bak")


def fused_solve_plain(x_t, inv_cn, e0, a0m, *, block, max_iter, atol_sse,
                      rtol, omega, variant="bakp"):
    """Plain version of the fused kernels on their own operands: returns
    (coef (vars, k), e (k, obs), history, sse, n_sweeps, converged).
    ``variant="bak"`` updates one column at a time (``omega`` unused)."""
    nvars = x_t.shape[0]
    inv = inv_cn.reshape(nvars, 1).float()
    e = e0.float()
    coef = a0m.float().clone()
    hist = torch.full((max_iter,), math.nan, dtype=torch.float32,
                      device=x_t.device)
    sse0 = torch.dot(e.reshape(-1), e.reshape(-1))
    sse, n, converged = sse0, 0, torch.tensor(False)
    while n < max_iter:
        if variant == "bak":
            for j in range(nvars):
                da, e = _cd.bak_row_update(x_t[j:j + 1].float(), inv[j, 0], e)
                coef[j] += da[0]
        else:
            for b in range(0, nvars, block):
                da, e = _cd.bakp_block_update(x_t[b:b + block].float(),
                                              inv[b:b + block], e, omega)
                coef[b:b + block] += da
        sse_new = torch.dot(e.reshape(-1), e.reshape(-1))
        hist[n] = sse_new
        converged, stop = sweep_stop_flags(sse_new, sse, sse0, atol_sse,
                                           rtol)
        sse, n = sse_new, n + 1
        if bool(stop):                       # the one host read per sweep
            break
    return (coef, e, hist, sse, torch.tensor(n, dtype=torch.int32),
            converged)



def rtol_stop(sses, sse0: float, rtol: float) -> Optional[int]:
    """The sweep (from 1) at which the stopping rule (``sweep_stop_flags``
    at ``rtol``, atol 0) stops on the per-sweep SSEs ``sses``, an iterable
    read lazily, or None if it never does."""
    prev = sse0
    for n, sse in enumerate(sses, 1):
        if bool(sweep_stop_flags(sse, prev, sse0, 0.0, rtol)[1]):
            return n
        prev = sse
    return None


def plain_rtol_stop(x_t, inv_cn, e0, *, block, rtol, max_iter,
                    variant="bakp") -> Optional[int]:
    """Where the stopping rule stops on the plain iterate's SSE summed in
    fp64, within ``max_iter`` sweeps: the witness an rtol stop is held to.
    At rtol 1e-7 two fp32 SSEs a sweep apart differ by about an ulp, so a
    kernel and the plain version, each summing in its own order, can stop
    a sweep apart near the residual's floor; this sum leaves out that
    rounding (``tools/stop_witness.py`` prints it sweep by sweep)."""
    def sses():
        e = e0.float()
        for _ in range(max_iter):
            if variant == "bak":
                _, e = _cd.cd_sweep_plain(x_t, e, inv_cn)
            else:
                _, e = _cd.bakp_sweep_plain(x_t, e, inv_cn, block=block)
            yield float((e.double() * e.double()).sum())
    sse0 = float(torch.dot(e0.reshape(-1), e0.reshape(-1)))
    return rtol_stop(sses(), sse0, rtol)

def _bak_fused_cuda(x_t, inv_cn, e0, a0m, *, max_iter, atol_sse, rtol):
    nvars, obs = x_t.shape
    nrhs = e0.shape[0]
    _cd.check_kernel_args(x_t, nrhs, 1, inv_cn, e0, a0m)
    lib = _build.load("bak_fused")
    dev = x_t.device
    with torch.cuda.device(dev):
        plan = _cd.bak_grid(lib.bak_fused_grid, obs, nrhs, x_t.element_size())
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
        xchg = _cd.bak_exchange(plan, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = _build.launch_key("bak_fused", x_t.element_size())
        _build.check(lib.bak_fused_launch(
            x_t.data_ptr(), x_t.element_size(), inv.data_ptr(),
            e0c.data_ptr(), a0c.data_ptr(), coef.data_ptr(), e.data_ptr(),
            hist.data_ptr(), sse.data_ptr(), n.data_ptr(), conv.data_ptr(),
            None if xchg is None else xchg.data_ptr(), nvars, obs, nrhs,
            max_iter, float(atol_sse), float(rtol),
            _cd.BAK_REGIMES.index(plan.regime), plan.ctas, plan.cluster,
            stream), "bak_fused_launch")
        _build.count_launch(key, plan)
    return coef, e, hist, sse[0], n[0], conv[0] != 0


def fused_cuda(x_t, inv_cn, e0, a0m, *, block, max_iter, atol_sse, rtol,
               omega, variant="bakp"):
    """The CUDA kernel of ``variant`` on the plain version's operands and
    outputs (``fused_solve_plain``'s signature)."""
    if variant == "bak":
        return _bak_fused_cuda(x_t, inv_cn, e0, a0m, max_iter=max_iter,
                               atol_sse=atol_sse, rtol=rtol)
    return _fused_cuda(x_t, inv_cn, e0, a0m, block=block, max_iter=max_iter,
                       atol_sse=atol_sse, rtol=rtol, omega=omega)


def _fused_cuda(x_t, inv_cn, e0, a0m, *, block, max_iter, atol_sse, rtol,
                omega):
    nvars, obs = x_t.shape
    nrhs = e0.shape[0]
    _cd.check_kernel_args(x_t, nrhs, block, inv_cn, e0, a0m)
    lib = _build.load("fused_solve")
    dev = x_t.device
    with torch.cuda.device(dev):
        plan = _cd.bakp_grid(lib.bakp_fused_clusters, "fused", obs, nrhs,
                             block, nvars=nvars, itemsize=x_t.element_size())
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
        # Tags: one an exchange (a group of a block step), one a per-sweep
        # SSE (and the first).
        steps = max_iter * (nvars // block) * -(-nrhs // plan.group)
        xchg, tag0 = _cd.bakp_exchange(plan, dev, max(steps, max_iter + 1))
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = _build.launch_key("fused_solve", x_t.element_size())
        _build.check(lib.bakp_fused_launch(
            x_t.data_ptr(), x_t.element_size(), inv.data_ptr(),
            e0c.data_ptr(), a0c.data_ptr(), coef.data_ptr(), e.data_ptr(),
            hist.data_ptr(), sse.data_ptr(), n.data_ptr(), conv.data_ptr(),
            None if xchg is None else xchg.data_ptr(), tag0, nvars, obs,
            nrhs, block, plan.group, max_iter, float(atol_sse), float(rtol),
            float(omega), _cd.BAKP_X_IN.index(plan.x_in),
            _cd.BAKP_REGIMES.index(plan.regime), plan.ctas, plan.cluster,
            plan.smem, stream), "bakp_fused_launch")
        _build.count_launch(key, plan)
    return coef, e, hist, sse[0], n[0], conv[0] != 0


def fused_solve(
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
    variant: str = "bakp",
) -> SolveResult:
    """Whole-solve SolveBakP (see module doc).

    Args:
      x_t: (vars, obs) TRANSPOSED design; vars a multiple of ``block``.
      y: (obs,) right-hand side, or (obs, k).
      inv_cn / cn: optional precomputed inverse / raw squared column norms
        (vars,); ``inv_cn`` wins; neither → computed from ``x_t``.
      a0: optional (vars,) / (vars, k) warm start.
      block / max_iter / atol / rtol / omega: as ``solvebakp_kernel``.
      variant: "bakp" (Algorithm 2) or "bak" (Algorithm 1, sequential
        column order; ``omega`` is ignored).
    Returns:
      ``SolveResult``; multi-RHS gives (vars, k) coef and (obs, k) residual
      with total-SSE accounting.
    """
    nvars, obs = x_t.shape
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if nvars % block != 0:
        raise ValueError(
            f"vars ({nvars}) must be a multiple of block ({block}); pad "
            f"columns (PreparedDesign.x_t_for does this)")
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    multi, nrhs, inv_cn = validate_solver_args(x_t, y, cn, inv_cn, a0)
    ws = fused_working_set_bytes(nvars, obs, nrhs, x_t.element_size(),
                                 max_iter=max_iter)
    if ws > _cd.ON_CHIP_BUDGET_BYTES:
        raise ValueError(
            f"fused_solve working set {ws / 2**20:.1f} MiB exceeds the "
            f"on-chip budget ({_cd.ON_CHIP_BUDGET_BYTES / 2**20:.0f} MiB); "
            f"use the per-sweep path (solvebakp_persweep_kernel) or reduce "
            f"obs ({obs}) / vars ({nvars}) / nrhs ({nrhs}).")
    inv_cn, a0m, e0 = solve_init(x_t, y, inv_cn, a0, multi)
    kw = dict(block=block, max_iter=max_iter,
              atol_sse=atol_to_sse(obs, nrhs, atol),
              rtol=float(rtol),
              omega=float(omega), variant=variant)
    if x_t.device.type == "cpu":
        coef, e, hist, sse, n, conv = fused_solve_plain(x_t, inv_cn, e0, a0m,
                                                        **kw)
    elif x_t.device.type == "cuda":
        coef, e, hist, sse, n, conv = fused_cuda(x_t, inv_cn, e0, a0m, **kw)
    else:
        raise ValueError(f"fused_solve runs on cpu or cuda, not {x_t.device}")
    if not multi:
        return SolveResult(coef[:, 0], e[0], sse, n, conv, hist)
    return SolveResult(coef, e.T, sse, n, conv, hist)
