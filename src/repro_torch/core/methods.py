"""Built-in solver methods of the PyTorch port, registered against
``repro_torch.core.spec``.

  * "bakp"       — Algorithm 2, block-Jacobi CD (plain torch).
  * "bakp_gram"  — exact block CD through cached block-Gram Cholesky.
  * "bakp_fused" — Algorithm 2 on the whole-solve CUDA kernel
                   (``repro_torch.kernels.fused_solve``) for designs within
                   the on-chip budget; larger ones fall back to "bakp"'s
                   plain path, recorded ``xla``/``vmem`` as in the JAX
                   package.
  * "lstsq"      — least-squares baseline (``torch.linalg.lstsq``).
  * "normal"     — normal-equation Cholesky with ``SolverSpec.ridge``.

Dispatch labels are the JAX package's: the plain torch family records
``xla`` (the route the JAX package leaves to XLA), the kernel routes
``fused`` / ``persweep``.  "bak", "bak_fused", "bakf" and "bakp_stream",
bf16 precisions, multi-GPU placements and cross-design batching arrive
with later slices, so no entry here claims them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.solvebakp import solvebakp
from repro_torch.core.spec import (_ITER_FIELDS, MethodEntry, SolverSpec,
                                   register_method)
from repro_torch.core.types import SolveResult
from repro_torch.obs import record_dispatch


# --------------------------------------------------------------- BAK family
def _bakp_solve(mode: str):
    method_name = "bakp" if mode == "jacobi" else "bakp_gram"

    def kernel(p, y, spec: SolverSpec, *, a0=None):
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
def _fused_solve(p, y, spec: SolverSpec, *, a0=None):
    """Algorithm 2 on the whole-solve kernel, over the handle's cached
    transposed padded design and inverse norms.  Over the on-chip budget
    (or with ``max_iter < 1``) it runs the plain "bakp" path instead."""
    # Imported at call time: the kernels import repro_torch.core.types, so
    # a module-level import here would tie the two packages' import order.
    from repro_torch.kernels.fused_solve import fused_fits, fused_solve

    block = spec.thr
    obs_p, vars_p = p.shape
    nrhs = y.shape[1] if y.dim() == 2 else 1
    vars_pb = -(-vars_p // block) * block
    if spec.max_iter < 1 or not fused_fits(vars_pb, obs_p, nrhs,
                                           p.x_pad.element_size(),
                                           max_iter=spec.max_iter):
        record_dispatch("xla", method="bakp_fused",
                        reason="max_iter" if spec.max_iter < 1 else "vmem")
        return solvebakp(p.x_pad, y, thr=block, max_iter=spec.max_iter,
                         atol=spec.atol, rtol=spec.rtol, omega=spec.omega,
                         mode="jacobi", cn=p.cn_for_thr(block), a0=a0)
    if a0 is not None and vars_pb != vars_p:
        a0 = torch.nn.functional.pad(
            a0, (0, 0) * (a0.dim() - 1) + (0, vars_pb - vars_p))
    record_dispatch("fused", method="bakp_fused")
    res = fused_solve(p.x_t_for(block), y, inv_cn=p.inv_cn_for(block), a0=a0,
                      block=block, max_iter=spec.max_iter, atol=spec.atol,
                      rtol=spec.rtol, omega=spec.omega, variant="bakp")
    if vars_pb != vars_p:
        res = res._replace(coef=res.coef[:vars_p])
    return res


def _prep_fused(p, spec: SolverSpec):
    p.x_t_for(spec.thr)
    p.inv_cn_for(spec.thr)


# ----------------------------------------------------------- direct methods
def _direct_result(x, y, coef, max_iter: int) -> SolveResult:
    e = y - x @ coef
    sse = torch.dot(e.reshape(-1), e.reshape(-1))
    hist = torch.full((max_iter,), math.nan, dtype=torch.float32,
                      device=x.device)
    hist[0] = sse
    return SolveResult(coef, e, sse, torch.tensor(1, dtype=torch.int32),
                       torch.tensor(True), hist)


def _lstsq_solve(p, y, spec: SolverSpec, *, a0=None):
    record_dispatch("xla", method="lstsq")
    rhs = y if y.dim() == 2 else y[:, None]
    coef = torch.linalg.lstsq(p.x_pad, rhs).solution
    return _direct_result(p.x_pad, y, coef if y.dim() == 2 else coef[:, 0],
                          spec.max_iter)


def _normal_solve(p, y, spec: SolverSpec, *, a0=None):
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
    name="bakp", solve=_bakp_solve("jacobi"),
    consumes=_ITER_FIELDS + ("thr", "omega"),
    iterative=True, multi_rhs=True, blocked=True, prepare=_prep_bakp,
    fallback="bakp_stream",
    summary="Algorithm 2: block-Jacobi coordinate descent"))
register_method(MethodEntry(
    name="bakp_gram", solve=_bakp_solve("gram"),
    consumes=_ITER_FIELDS + ("thr", "omega", "ridge"),
    iterative=True, multi_rhs=True, blocked=True, needs_chol=True,
    prepare=_prep_bakp_gram, fallback="bakp",
    summary="exact block CD via cached block-Gram Cholesky (beyond-paper)"))
register_method(MethodEntry(
    name="bakp_fused", solve=_fused_solve,
    consumes=_ITER_FIELDS + ("thr", "omega", "precision", "refine_sweeps"),
    iterative=True, multi_rhs=True, blocked=True, lane="fused",
    prepare=_prep_fused, fallback="bakp",
    summary="Algorithm 2 on the whole-solve CUDA kernel (sweeps, SSE and "
            "stop on the card; plain bakp path over the on-chip budget)"))
register_method(MethodEntry(
    name="lstsq", solve=_lstsq_solve, consumes=(),
    iterative=False, multi_rhs=True,
    summary="least-squares baseline (the paper's comparison column)"))
register_method(MethodEntry(
    name="normal", solve=_normal_solve, consumes=("ridge",),
    iterative=False, multi_rhs=True, fallback="lstsq",
    summary="normal-equation Cholesky with SolverSpec.ridge diagonal"))
