"""prepare()/PreparedDesign — the design-handle half of the solver API.

Counterpart of ``repro.core.prepare``:

    spec = SolverSpec(method="bakp_fused", rtol=1e-7)
    design = prepare(x, spec)              # once per design, on the GPU
    res1 = design.solve(y1)                # cheap per-RHS solves
    res2 = design.solve(y2, a0=res1.coef)  # warm-started re-solve

``PreparedDesign`` owns, per design matrix: the fp32 device copy
``x_pad``; its content ``fingerprint``; the squared column norms, their
thr-padded layouts and inverses (``cn_for_thr``, ``inv_cn_for``); the
transposed padded copy per block width (``x_t_for``, the CUDA kernels'
layout); block-Gram Cholesky factors per ``(thr, ridge)``; and an LRU of
per-tenant warm-start coefficients.  All of it is built lazily under a
per-design lock.  The bf16 tier, mesh copies, lane residency and
non-resident (store-backed) handles arrive with their slices.

Device rule: ``prepare`` puts the design on ``device``, which defaults to
``"cuda"``; with no GPU present it raises unless the caller passes
``device="cpu"``.  It never falls back to the CPU by itself.

``prepared_from_arrays`` builds a handle from a JAX ``PreparedDesign``'s
state exported as numpy arrays (``x_pad``, Cholesky factors, warm
coefficients), so both packages can be shown to compute the same thing
from the same state.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.spec import (SolverSpec, UnsupportedSpecError,
                                   ensure_precision_supported, solver_method)
from repro_torch.core.types import (SolveResult, column_norms_sq, safe_inv,
                                    warm_retention_ok)


def resolve_device(device=None) -> torch.device:
    """The device a handle lives on: ``device``, or ``"cuda"`` by default.
    Raises when CUDA is asked for and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch path on the CPU")
    return dev


def as_f32(v, device) -> torch.Tensor:
    """``v`` as an fp32 tensor on ``device``.  Arrays and lists are copied
    (a caller's later write cannot reach the solver's copy); a tensor
    already fp32 on ``device`` is used as it is."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(v, np.float32), device=device)


def design_fingerprint(x, *, _prefix: str = "d") -> str:
    """Content fingerprint of a design (shape + dtype + bytes); the same
    bytes give the same fingerprint as ``repro.core.prepare``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(x))
    h = hashlib.blake2b(digest_size=16)
    h.update(str((a.shape, a.dtype.str)).encode())
    h.update(a.view(np.uint8).data)
    return f"{_prefix}:{h.hexdigest()}"


@dataclass
class PreparedDesign:
    """Per-design solver state + the ``solve`` handle (see module doc)."""

    x_pad: torch.Tensor                   # (obs, vars) fp32 on the device
    spec: Optional[SolverSpec] = None     # default spec bound by prepare()
    fingerprint: Optional[str] = None
    chol: Dict[Tuple[int, float], torch.Tensor] = field(default_factory=dict)
    max_tenants: int = 64
    _cn: Optional[torch.Tensor] = field(default=None, repr=False)
    _cn_thr: Dict[int, torch.Tensor] = field(default_factory=dict, repr=False)
    _inv_cn: Dict[int, torch.Tensor] = field(default_factory=dict, repr=False)
    _x_t: Dict[int, torch.Tensor] = field(default_factory=dict, repr=False)
    _warm: "OrderedDict[str, torch.Tensor]" = field(default_factory=OrderedDict,
                                                    repr=False)
    _lock: threading.RLock = field(default_factory=threading.RLock,
                                   repr=False, compare=False)

    # ------------------------------------------------------------ identity
    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.x_pad.shape)

    @property
    def device(self) -> torch.device:
        return self.x_pad.device

    def design_key(self) -> str:
        """The fingerprint handed to ``prepare``, or (lazily) the content
        hash of the design's bytes."""
        with self._lock:
            if self.fingerprint is None:
                self.fingerprint = design_fingerprint(self.x_pad)
            return self.fingerprint

    # --------------------------------------------- per-tenant warm starts
    def warm_coef(self, tenant_id: Optional[str]) -> Optional[torch.Tensor]:
        """Last stored coefficients for ``tenant_id`` (None = cold)."""
        if tenant_id is None:
            return None
        with self._lock:
            coef = self._warm.get(tenant_id)
            if coef is not None:
                self._warm.move_to_end(tenant_id)
            return coef

    def store_coef(self, tenant_id: Optional[str], coef) -> None:
        """Retain a copy of a tenant's solved coefficients, LRU-bounded."""
        if tenant_id is None:
            return
        coef = as_f32(coef, self.device).clone()
        with self._lock:
            self._warm[tenant_id] = coef
            self._warm.move_to_end(tenant_id)
            while len(self._warm) > self.max_tenants:
                self._warm.popitem(last=False)

    # ------------------------------------------------- derived design state
    @property
    def cn(self) -> torch.Tensor:
        """Squared column norms (vars,), computed on first use."""
        with self._lock:
            if self._cn is None:
                self._cn = column_norms_sq(self.x_pad)
            return self._cn

    def cn_for_thr(self, thr: int) -> torch.Tensor:
        """Column norms zero-extended to a multiple of ``thr``."""
        vars_p = self.shape[1]
        pad = -(-vars_p // thr) * thr - vars_p
        if pad == 0:
            return self.cn
        with self._lock:
            if thr not in self._cn_thr:
                self._cn_thr[thr] = torch.cat(
                    [self.cn, self.cn.new_zeros((pad,))])
            return self._cn_thr[thr]

    def inv_cn_for(self, thr: int) -> torch.Tensor:
        """Inverse squared column norms in the thr-padded layout (0 on
        padded columns, which pins their updates to 0)."""
        with self._lock:
            if thr not in self._inv_cn:
                self._inv_cn[thr] = safe_inv(self.cn_for_thr(thr))
            return self._inv_cn[thr]

    def x_t_for(self, thr: int) -> torch.Tensor:
        """Contiguous TRANSPOSED copy (vars_pad, obs), vars zero-padded to a
        multiple of ``thr``: the CUDA kernels' layout, built once."""
        with self._lock:
            if thr not in self._x_t:
                vars_p = self.shape[1]
                pad = -(-vars_p // thr) * thr - vars_p
                x_t = self.x_pad.T
                if pad:
                    x_t = torch.nn.functional.pad(x_t, (0, 0, 0, pad))
                self._x_t[thr] = x_t.contiguous()
            return self._x_t[thr]

    def chol_for(self, thr: int, ridge: float) -> torch.Tensor:
        """Block-Gram Cholesky factors for (thr, ridge), computed once."""
        from repro_torch.core.solvebakp import _pad_cols, block_gram_cholesky

        key = (int(thr), float(ridge))
        with self._lock:
            if key not in self.chol:
                x, _, nblocks = _pad_cols(self.x_pad, thr)
                self.chol[key] = block_gram_cholesky(
                    x.reshape(self.shape[0], nblocks, thr), ridge)
            return self.chol[key]

    def warm_method_state(self, spec: SolverSpec) -> None:
        """Run ``spec.method``'s prepare hook (norm layouts, Gram factors,
        the transposed copy)."""
        entry = solver_method(spec.method)
        if entry.prepare is not None:
            entry.prepare(self, spec)

    # ---------------------------------------------------------------- solve
    def solve(
        self,
        y,
        a0=None,
        *,
        spec: Optional[SolverSpec] = None,
        generator: Optional[torch.Generator] = None,
        tenant_id: Optional[str] = None,
        placement=None,
    ) -> SolveResult:
        """Solve ``x @ a ≈ y`` against this design.

        Args:
          y: (obs,) or (obs, k) right-hand side(s), tensor or array; moved
            to the design's device as fp32.
          a0: optional (vars,)/(vars, k) warm start; direct methods ignore it.
          spec: overrides the spec bound at ``prepare`` time.
          generator: ``torch.Generator`` on the design's device for
            ``order="random"`` (where the JAX handle takes a PRNG ``key``).
          tenant_id: when set and ``a0`` is None, warm-start from the
            tenant's last stored coefficients and store the new solution
            back afterwards (unless the solve diverged).
          placement: only single-device placements run here; a sharded one
            raises ``UnsupportedSpecError`` until the multi-GPU slice.
        """
        spec = spec if spec is not None else self.spec
        if spec is None:
            raise ValueError(
                "no SolverSpec bound to this PreparedDesign; pass spec=")
        entry = ensure_precision_supported(spec)
        if placement is not None and getattr(placement, "sharded", False):
            raise UnsupportedSpecError(
                f"placement {getattr(placement, 'kind', placement)!r} is "
                f"sharded; the PyTorch port runs on one device until its "
                f"multi-GPU slice")
        y = as_f32(y, self.device)
        if y.dim() == 2 and not entry.multi_rhs:
            raise ValueError(
                f"method {spec.method!r} does not support multi-RHS "
                f"y of shape {tuple(y.shape)}")
        store_tenant = None
        if a0 is None and tenant_id is not None and entry.iterative:
            store_tenant = tenant_id
            warm = self.warm_coef(tenant_id)
            # A stored coefficient only warm-starts a compatible solve:
            # (vars,) broadcasts over RHS, (vars, k) must match k.
            nvars = self.shape[1]
            nrhs = y.shape[1] if y.dim() == 2 else 1
            if warm is not None and tuple(warm.shape) in ((nvars,),
                                                          (nvars, nrhs)):
                a0 = warm
        if a0 is not None and not entry.iterative:
            a0 = None
        if a0 is not None:
            a0 = as_f32(a0, self.device)
        res = entry.solve(self, y, spec, a0=a0, generator=generator)
        if store_tenant is not None and warm_retention_ok(res):
            self.store_coef(store_tenant, res.coef)
        return res


def prepare(
    x,
    spec: Optional[SolverSpec] = None,
    *,
    device=None,
    fingerprint: Optional[str] = None,
    max_tenants: int = 64,
) -> PreparedDesign:
    """Build a ``PreparedDesign`` for ``x`` (see module doc).

    Args:
      x: (obs, vars) design, copied to ``device`` as fp32 (an fp32 tensor
        already on ``device`` is used without a copy).
      spec: default ``SolverSpec``; when given, the method's prepare hook
        runs now so the first ``solve`` is as cheap as a repeat one.
      device: where the design lives; default ``"cuda"`` (raises when no
        GPU is present — pass ``"cpu"`` for the plain path).
      fingerprint: caller-known identity for ``x`` (skips hashing).
      max_tenants: LRU bound on retained warm-start coefficients.
    """
    if spec is not None:
        ensure_precision_supported(spec)
    dev = resolve_device(device)
    x = as_f32(x, dev)
    if x.dim() != 2:
        raise ValueError(f"x must be 2D (obs, vars), got {tuple(x.shape)}")
    prepared = PreparedDesign(x_pad=x.contiguous(), spec=spec,
                              fingerprint=fingerprint,
                              max_tenants=max_tenants)
    if spec is not None:
        prepared.warm_method_state(spec)
    return prepared


def prepared_from_arrays(
    x_pad,
    *,
    fingerprint: Optional[str] = None,
    chol: Optional[Mapping[Tuple[int, float], np.ndarray]] = None,
    warm: Optional[Mapping[str, np.ndarray]] = None,
    spec: Optional[SolverSpec] = None,
    device=None,
    max_tenants: int = 64,
) -> PreparedDesign:
    """Build the port's handle from another handle's state as arrays.

    Args:
      x_pad: (obs, vars) design exactly as the source handle holds it.
      fingerprint: the source handle's ``design_key()``.
      chol: block-Gram Cholesky factors keyed by ``(thr, ridge)``.
      warm: per-tenant warm-start coefficients, least recently used first.
      spec / device / max_tenants: as ``prepare``.
    """
    p = prepare(x_pad, None, device=device, fingerprint=fingerprint,
                max_tenants=max_tenants)
    p.spec = spec
    for (thr, ridge), factors in (chol or {}).items():
        p.chol[(int(thr), float(ridge))] = as_f32(factors, p.device)
    for tenant, coef in (warm or {}).items():
        p.store_coef(tenant, np.asarray(coef))
    if spec is not None:
        ensure_precision_supported(spec)
        p.warm_method_state(spec)
    return p
