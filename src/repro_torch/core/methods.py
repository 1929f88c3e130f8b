"""Built-in solver methods of the PyTorch port, registered against
``repro_torch.core.spec``.

  * "bak"        — Algorithm 1, serial CD (plain torch), cyclic or random
                   order (``order="random"`` takes ``generator=``).
  * "bakp"       — Algorithm 2, block-Jacobi CD (plain torch).
  * "bakp_gram"  — exact block CD through cached block-Gram Cholesky.
  * "bakp_fused" — Algorithm 2 on the whole-solve CUDA kernel
                   (``repro_torch.kernels.fused_solve``) for designs within
                   the on-chip budget; larger ones fall back to "bakp"'s
                   plain path, recorded ``xla``/``vmem`` as in the JAX
                   package.
  * "bak_fused"  — Algorithm 1 on the whole-solve kernel's ``variant="bak"``
                   body; over the budget, "bak"'s plain path (cyclic).
  * "bakp_stream" — Algorithm 2 with x streamed: resident designs run the
                   streaming whole-solve CUDA kernel
                   (``repro_torch.kernels.stream_solve``) while a CTA's
                   tile ring fits, else the per-sweep kernel loop;
                   non-resident handles run the host-block loop
                   (``stream_solve_blocks``).
  * "bakf"       — Algorithm 3 run to full selection: greedy forward CD over
                   every column with a refit per step.  Single-RHS; ignores
                   warm starts.
  * "lstsq"      — least-squares baseline (minimum norm through the SVD,
                   ``lstsq_svd``, as ``jnp.linalg.lstsq``).
  * "normal"     — normal-equation Cholesky with ``SolverSpec.ridge``.

Dispatch labels are the JAX package's: the plain torch family records
``xla`` (the route the JAX package leaves to XLA), the kernel routes
``fused`` / ``stream`` / ``persweep``, the host-block loop
``stream_host``.

Precision, as in the JAX registry: "bakp_fused" and "bak_fused" run
"fp32", "bf16" and "bf16_fp32acc", "bakp_stream" "fp32" and "bf16".  A
bf16 solve hands the kernels the handle's bf16 copy of x
(``PreparedDesign.x_bf16_for``), which they read and widen to fp32 as
they go; the norms, residual, coefficients and SSE stay fp32.
"bf16_fp32acc" then polishes with up to ``refine_sweeps`` fp32 sweeps
(``_refine_fp32``).

Batching across designs, as in the JAX registry: "bak" (cyclic order
only), "bakp" and "bakp_gram" are ``batchable`` and carry a ``vmap_one``
that builds the batch solver the serving engine stacks same-bucket
designs into (``solvebak_batched`` / ``solvebakp_batched``: plain torch
over (B, obs, vars), where the JAX package runs ``jit(vmap(one))`` of its
XLA solvers, outside any Pallas kernel).  Multi-GPU placements arrive
with a later slice, so no entry here claims them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.solvebak import solvebak, solvebak_batched
from repro_torch.core.solvebakf import solvebakf
from repro_torch.core.solvebakp import solvebakp, solvebakp_batched
from repro_torch.core.spec import (_ITER_FIELDS, MethodEntry, SolverSpec,
                                   register_method)
from repro_torch.core.types import SolveResult
from repro_torch.obs import record_dispatch


# --------------------------------------------------------------- BAK family
def _bak_solve(p, y, spec: SolverSpec, *, a0=None, generator=None):
    record_dispatch("xla", method="bak")
    return solvebak(p.x_pad, y, max_iter=spec.max_iter, atol=spec.atol,
                    rtol=spec.rtol, a0=a0, order=spec.order,
                    generator=generator, cn=p.cn)


def _bak_vmap_one(spec: SolverSpec):
    if spec.order != "cyclic":
        # A batch carries no generator (nor does a serving request), so
        # random order is not batchable; the single path rejects it too.
        raise ValueError(
            f"order={spec.order!r} requires a torch.Generator and is not "
            f"batchable; serve it with order='cyclic'")

    def batch(xs, ys, cns, atols, *, chols=None, a0s=None):
        return solvebak_batched(xs, ys, max_iter=spec.max_iter, atols=atols,
                                rtol=spec.rtol, cns=cns, a0s=a0s)
    return batch


def _bakp_vmap_one(mode: str):
    def build(spec: SolverSpec):
        def batch(xs, ys, cns, atols, *, chols=None, a0s=None):
            return solvebakp_batched(
                xs, ys, thr=spec.thr, max_iter=spec.max_iter, atols=atols,
                rtol=spec.rtol, omega=spec.omega, mode=mode,
                ridge=spec.ridge, cns=cns,
                chols=chols if mode == "gram" else None, a0s=a0s)
        return batch
    return build


def _prep_bak(p, spec: SolverSpec):
    p.cn  # property access builds the lazy column norms


def _bakp_solve(mode: str):
    method_name = "bakp" if mode == "jacobi" else "bakp_gram"

    def kernel(p, y, spec: SolverSpec, *, a0=None, generator=None):
        record_dispatch("xla", method=method_name)
        return solvebakp(
            p.x_pad, y, thr=spec.thr, max_iter=spec.max_iter, atol=spec.atol,
            rtol=spec.rtol, omega=spec.omega, mode=mode, ridge=spec.ridge,
            cn=p.cn_for_thr(spec.thr),
            chol=(p.chol_for(spec.thr, spec.ridge) if mode == "gram"
                  else None),
            a0=a0)
    return kernel


def _prep_bakp(p, spec: SolverSpec):
    p.cn_for_thr(spec.thr)


def _prep_bakp_gram(p, spec: SolverSpec):
    p.cn_for_thr(spec.thr)
    p.chol_for(spec.thr, spec.ridge)


# ------------------------------------------------------ whole-solve kernel
def _refine_fp32(p, y, spec: SolverSpec, lp: SolveResult, *, variant: str,
                 nrhs: int) -> SolveResult:
    """fp32 polish of ``precision="bf16_fp32acc"`` (iterative refinement).

    Starts from the low-precision coefficients: ``solve_init`` recomputes
    the residual in fp32 against the fp32 design, then up to
    ``spec.refine_sweeps`` fp32 sweeps run from it, honouring
    ``atol``/``rtol``, on the whole-solve kernel where it fits at fp32
    itemsize, else on the per-sweep loop.  It records no dispatch: the
    solve's path stays the low-precision route that moved most of the
    bytes.  Sweeps add, histories concatenate (``max_iter +
    refine_sweeps`` long) and ``converged`` is the OR."""
    from repro_torch.kernels.fused_solve import fused_fits, fused_solve
    from repro_torch.kernels.ops import solvebakp_persweep_kernel

    block = spec.thr
    obs_p = p.shape[0]
    x_t = p.x_t_for(block)
    kw = dict(inv_cn=p.inv_cn_for(block), a0=lp.coef, block=block,
              max_iter=spec.refine_sweeps, atol=spec.atol, rtol=spec.rtol,
              omega=spec.omega if variant == "bakp" else 1.0,
              variant=variant)
    if fused_fits(x_t.shape[0], obs_p, nrhs, x_t.element_size(),
                  max_iter=spec.refine_sweeps):
        pol = fused_solve(x_t, y, **kw)
    else:
        pol = solvebakp_persweep_kernel(x_t, y, **kw)
    return SolveResult(
        pol.coef, pol.residual, pol.sse, lp.n_sweeps + pol.n_sweeps,
        lp.converged | pol.converged, torch.cat([lp.history, pol.history]))


def _fused_method(variant: str):
    """Algorithm 2 (``variant="bakp"``) or 1 (``"bak"``) on the whole-solve
    kernel, over the handle's cached transposed padded design and inverse
    norms.  Over the on-chip budget (or with ``max_iter < 1``) an fp32
    solve runs the plain path of the same algorithm, "bakp" or "bak",
    instead.  A bf16 solve reads the handle's bf16 copy and fits at
    itemsize 2, so designs twice as large stay on the kernel; one over the
    budget even then runs the per-sweep loop on the bf16 copy (never the
    fp32 plain path).  "bf16_fp32acc" adds the ``_refine_fp32`` polish."""
    method = f"{variant}_fused"

    def kernel(p, y, spec: SolverSpec, *, a0=None, generator=None):
        # Imported at call time: the kernels import repro_torch.core.types,
        # so a module-level import here would tie the two packages' import
        # order.
        from repro_torch.kernels.fused_solve import fused_fits, fused_solve
        from repro_torch.kernels.ops import solvebakp_persweep_kernel

        block = spec.thr
        lowp = spec.precision != "fp32"
        polish = spec.precision == "bf16_fp32acc" and spec.refine_sweeps > 0
        obs_p, vars_p = p.shape
        nrhs = y.shape[1] if y.dim() == 2 else 1
        vars_pb = -(-vars_p // block) * block
        itemsize = 2 if lowp else p.x_pad.element_size()
        fits = (spec.max_iter >= 1
                and fused_fits(vars_pb, obs_p, nrhs, itemsize,
                               max_iter=spec.max_iter))
        if spec.max_iter < 1 or (not fits and not lowp):
            record_dispatch("xla", method=method,
                            reason="max_iter" if spec.max_iter < 1 else "vmem")
            if variant == "bak":
                return solvebak(p.x_pad, y, max_iter=spec.max_iter,
                                atol=spec.atol, rtol=spec.rtol, a0=a0,
                                cn=p.cn)
            return solvebakp(p.x_pad, y, thr=block, max_iter=spec.max_iter,
                             atol=spec.atol, rtol=spec.rtol, omega=spec.omega,
                             mode="jacobi", cn=p.cn_for_thr(block), a0=a0)
        if a0 is not None and vars_pb != vars_p:
            a0 = torch.nn.functional.pad(
                a0, (0, 0) * (a0.dim() - 1) + (0, vars_pb - vars_p))
        x_t = p.x_bf16_for(block) if lowp else p.x_t_for(block)
        kw = dict(inv_cn=p.inv_cn_for(block), a0=a0, block=block,
                  max_iter=spec.max_iter, atol=spec.atol, rtol=spec.rtol,
                  omega=spec.omega if variant == "bakp" else 1.0,
                  variant=variant)
        if fits:
            record_dispatch("fused", method=method)
            res = fused_solve(x_t, y, **kw)
        else:
            # bf16 over the budget: the per-sweep loop on the bf16 copy
            # keeps the halved bytes where they matter most.
            record_dispatch("persweep", method=method, reason="vmem")
            res = solvebakp_persweep_kernel(x_t, y, **kw)
        if polish:
            res = _refine_fp32(p, y, spec, res, variant=variant, nrhs=nrhs)
        if vars_pb != vars_p:
            res = res._replace(coef=res.coef[:vars_p])
        return res
    return kernel


def _prep_fused(p, spec: SolverSpec):
    p.x_t_for(spec.thr)
    p.inv_cn_for(spec.thr)
    if spec.precision != "fp32":
        p.x_bf16_for(spec.thr)


# ------------------------------------------------- streaming out-of-core
def _stream_solve_method(p, y, spec: SolverSpec, *, a0=None, generator=None):
    """Algorithm 2 with x streamed rather than held on chip.

    Resident designs run the streaming kernel: x stays in device memory
    and each CTA copies its slice of every tile through a two-stage
    shared-memory ring while the residual and coefficients stay on chip
    (under "bf16" the ring holds the handle's bf16 copy, and the fit is
    checked at itemsize 2).  When even the ring does not fit a CTA, the
    per-sweep kernel loop (``persweep``/``vmem``).  Non-resident handles
    take the host-block loop (``stream_host``), fetching fp32 tiles from
    host memory per block whatever the precision, as the JAX package
    does.  Same block-Jacobi math and stopping rule as
    "bakp"/"bakp_fused" either way.
    """
    from repro_torch.kernels.ops import solvebakp_persweep_kernel
    from repro_torch.kernels.stream_solve import (stream_fits, stream_solve,
                                                  stream_solve_blocks)

    block = spec.thr
    lowp = spec.precision != "fp32"
    obs_p, vars_p = p.shape
    nrhs = y.shape[1] if y.dim() == 2 else 1
    vars_pb = -(-vars_p // block) * block
    if spec.max_iter < 1 and p.resident:
        record_dispatch("xla", method="bakp_stream", reason="max_iter")
        return solvebakp(p.x_pad, y, thr=block, max_iter=spec.max_iter,
                         atol=spec.atol, rtol=spec.rtol, omega=spec.omega,
                         mode="jacobi", cn=p.cn_for_thr(block), a0=a0)
    if a0 is not None and vars_pb != vars_p:
        a0 = torch.nn.functional.pad(
            a0, (0, 0) * (a0.dim() - 1) + (0, vars_pb - vars_p))
    kw = dict(inv_cn=p.inv_cn_for(block), a0=a0, block=block,
              max_iter=spec.max_iter, atol=spec.atol, rtol=spec.rtol,
              omega=spec.omega)
    if not p.resident:
        record_dispatch("stream_host", method="bakp_stream")
        res = stream_solve_blocks(p.blocks, y, **kw)
    else:
        x_t = p.x_bf16_for(block) if lowp else p.x_t_for(block)
        if stream_fits(vars_pb, obs_p, nrhs, x_t.element_size(),
                       block=block, max_iter=spec.max_iter):
            record_dispatch("stream", method="bakp_stream")
            res = stream_solve(x_t, y, **kw)
        else:
            # Even one CTA's ring is over its shared memory (very large
            # obs): the per-sweep loop also holds one block at a time.
            record_dispatch("persweep", method="bakp_stream", reason="vmem")
            res = solvebakp_persweep_kernel(x_t, y, variant="bakp", **kw)
    if vars_pb != vars_p:
        res = res._replace(coef=res.coef[:vars_p])
    return res


def _prep_stream(p, spec: SolverSpec):
    p.inv_cn_for(spec.thr)
    if p.resident:
        p.x_t_for(spec.thr)
        if spec.precision != "fp32":
            p.x_bf16_for(spec.thr)


# ---------------------------------------------------- greedy selection (A3)
def _bakf_solve(p, y, spec: SolverSpec, *, a0=None, generator=None):
    """Algorithm 3 run to full selection as a solver: greedily order every
    column by SSE reduction, refitting after each pick; the final refit
    over all columns is an exact-block CD solve."""
    record_dispatch("xla", method="bakf")
    nvars = p.shape[1]
    sel = solvebakf(p.x_pad, y, max_feat=nvars, refit_sweeps=spec.max_iter,
                    refit_thr=min(spec.thr, nvars))
    coef = torch.zeros((nvars,), dtype=torch.float32, device=p.device)
    coef[sel.selected.long()] = sel.coef
    e = sel.residual
    sse = torch.dot(e, e)
    hist = torch.full((spec.max_iter,), math.nan, dtype=torch.float32,
                      device=p.device)
    hist[0] = sse
    return SolveResult(coef, e, sse, torch.tensor(nvars, dtype=torch.int32),
                       torch.tensor(True), hist)


# ----------------------------------------------------------- direct methods
def _direct_result(x, y, coef, max_iter: int) -> SolveResult:
    e = y - x @ coef
    sse = torch.dot(e.reshape(-1), e.reshape(-1))
    hist = torch.full((max_iter,), math.nan, dtype=torch.float32,
                      device=x.device)
    hist[0] = sse
    return SolveResult(coef, e, sse, torch.tensor(1, dtype=torch.int32),
                       torch.tensor(True), hist)


def lstsq_svd(x: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares through the SVD, as ``jnp.linalg.lstsq``
    computes it: singular values below ``eps·max(m, n)·s_max`` are dropped,
    so zero columns (a serving bucket's padding) get zero coefficients.
    ``torch.linalg.lstsq`` is no substitute: its CPU default ("gelsy")
    returns wrong coefficients on such rank-deficient designs in about
    half of seeded trials, and on CUDA it takes full-rank designs only."""
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    rcond = torch.finfo(x.dtype).eps * max(x.shape)
    mask = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vh.mT @ (s_inv[:, None] * (u.mT @ rhs))


def _lstsq_solve(p, y, spec: SolverSpec, *, a0=None, generator=None):
    record_dispatch("xla", method="lstsq")
    rhs = y if y.dim() == 2 else y[:, None]
    coef = lstsq_svd(p.x_pad, rhs)
    return _direct_result(p.x_pad, y, coef if y.dim() == 2 else coef[:, 0],
                          spec.max_iter)


def _normal_solve(p, y, spec: SolverSpec, *, a0=None, generator=None):
    record_dispatch("xla", method="normal")
    x = p.x_pad
    g = x.T @ x + spec.ridge * torch.eye(x.shape[1], dtype=torch.float32,
                                         device=x.device)
    rhs = x.T @ (y if y.dim() == 2 else y[:, None])
    coef = torch.cholesky_solve(rhs, torch.linalg.cholesky(g))
    return _direct_result(x, y, coef if y.dim() == 2 else coef[:, 0],
                          spec.max_iter)


# ------------------------------------------------------------- registration
register_method(MethodEntry(
    name="bak", solve=_bak_solve, consumes=_ITER_FIELDS + ("order",),
    iterative=True, multi_rhs=True, batchable=True, blocked=False,
    prepare=_prep_bak, vmap_one=_bak_vmap_one, fallback="lstsq",
    summary="Algorithm 1: serial cyclic coordinate descent"))
register_method(MethodEntry(
    name="bakp", solve=_bakp_solve("jacobi"),
    consumes=_ITER_FIELDS + ("thr", "omega"),
    iterative=True, multi_rhs=True, batchable=True, blocked=True,
    prepare=_prep_bakp, vmap_one=_bakp_vmap_one("jacobi"),
    fallback="bakp_stream",
    summary="Algorithm 2: block-Jacobi coordinate descent"))
register_method(MethodEntry(
    name="bakp_gram", solve=_bakp_solve("gram"),
    consumes=_ITER_FIELDS + ("thr", "omega", "ridge"),
    iterative=True, multi_rhs=True, batchable=True, blocked=True,
    needs_chol=True, prepare=_prep_bakp_gram,
    vmap_one=_bakp_vmap_one("gram"), fallback="bakp",
    summary="exact block CD via cached block-Gram Cholesky (beyond-paper)"))
register_method(MethodEntry(
    name="bakp_fused", solve=_fused_method("bakp"),
    consumes=_ITER_FIELDS + ("thr", "omega", "precision", "refine_sweeps"),
    iterative=True, multi_rhs=True, blocked=True,
    precisions=("fp32", "bf16", "bf16_fp32acc"), lane="fused",
    prepare=_prep_fused, fallback="bakp",
    summary="Algorithm 2 on the whole-solve CUDA kernel (sweeps, SSE and "
            "stop on the card; plain bakp path over the on-chip budget)"))
register_method(MethodEntry(
    name="bak_fused", solve=_fused_method("bak"),
    consumes=_ITER_FIELDS + ("thr", "precision", "refine_sweeps"),
    iterative=True, multi_rhs=True, blocked=True,
    precisions=("fp32", "bf16", "bf16_fp32acc"), lane="fused",
    prepare=_prep_fused, fallback="bak",
    summary="Algorithm 1 on the whole-solve CUDA kernel (sequential column "
            "order; plain bak path over the on-chip budget)"))
register_method(MethodEntry(
    name="bakp_stream", solve=_stream_solve_method,
    consumes=_ITER_FIELDS + ("thr", "omega", "precision"),
    iterative=True, multi_rhs=True, blocked=True, streams=True,
    precisions=("fp32", "bf16"), lane="stream", prepare=_prep_stream,
    fallback="lstsq",
    summary="Algorithm 2 streaming out-of-core: x tiles double-buffered "
            "from device memory through each CTA's shared memory, or "
            "fetched per block from host memory for non-resident designs"))
register_method(MethodEntry(
    name="lstsq", solve=_lstsq_solve, consumes=(),
    iterative=False, multi_rhs=True,
    summary="least-squares baseline (the paper's comparison column)"))
register_method(MethodEntry(
    name="normal", solve=_normal_solve, consumes=("ridge",),
    iterative=False, multi_rhs=True, fallback="lstsq",
    summary="normal-equation Cholesky with SolverSpec.ridge diagonal"))
register_method(MethodEntry(
    name="bakf", solve=_bakf_solve, consumes=("max_iter", "thr"),
    iterative=False, multi_rhs=False,
    summary="Algorithm 3 to full selection: greedy forward CD + refit"))
