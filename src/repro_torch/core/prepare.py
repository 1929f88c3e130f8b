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
layout) and its bf16 cast (``x_bf16_for``, the quantized tier the bf16
precisions read); block-Gram Cholesky factors per ``(thr, ridge)``; the
per-placement sharded copies a mesh solve reads (``x_for_placement``: a
``core.distributed.ShardedDesign`` on the mesh's devices); and an LRU of
per-tenant warm-start coefficients.  All of it is built lazily under a
per-design lock.  ``snapshot_state`` / ``restore_state`` are what the
tiered design store reads from a handle it demotes and writes back to one
it promotes (the sharded copies are not kept: the next warm rebuilds
them).  ``bind_home`` / ``warm_lane_state`` / ``resident_lanes`` serve the
serving engine's lanes.

Streams: a handle is built on one thread's CUDA stream and solved on
others (each serving lane has a stream of its own).  Every tensor the
handle caches is therefore complete on the device when its builder
returns (``_settled``: one wait on the building stream, paid once per
built tensor), so a reader on another stream never sees it half written.

A NON-RESIDENT handle has ``x_pad=None``: its x stays in a
``repro_torch.store.DesignStore``'s host or disk tier and reaches the
device block by block through ``blocks`` (a ``StoreBlockSource``), with an
explicit ``device`` for the solve.  Only methods registered
``streams=True`` (``bakp_stream``) solve it; every accessor that needs x
raises ``UnsupportedSpecError``.

Device rule: ``prepare`` puts the design on ``device``, which defaults to
``"cuda"``; with no GPU present it raises unless the caller passes
``device="cpu"``.  It never falls back to the CPU by itself.

``prepared_from_arrays`` builds a handle from a JAX ``PreparedDesign``'s
state exported as numpy arrays (``x_pad``, Cholesky factors, warm
coefficients; for a non-resident handle the host ``x_pad`` and the column
norms), so both packages can be shown to compute the same thing from the
same state.
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
                                   ensure_precision_supported, solver_method,
                                   streaming_methods)
from repro_torch.core.types import (SolveResult, column_norms_sq, safe_inv,
                                    warm_retention_ok)


# Sharded placement kind → the ``core.distributed`` layout it reads.
_SHARD_KINDS = {"obs_sharded": "obs", "rhs_sharded": "rhs", "mesh_2d": "2d"}


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


def _settled(t: torch.Tensor) -> torch.Tensor:
    """``t`` once the stream that built it has finished writing it (see
    the module doc); CPU tensors pass through."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


def host_copy(t: torch.Tensor, *, pin: bool) -> torch.Tensor:
    """A CPU copy of ``t`` (on any device), in pinned memory when ``pin``;
    a device tensor is copied on the calling thread's stream."""
    out = torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=pin)
    out.copy_(t)
    return out


def device_copy(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``, settled: a pinned host tensor is copied
    asynchronously on the calling thread's stream, then waited for (see
    ``_settled``); a tensor already there is returned as it is."""
    return _settled(t.to(device, non_blocking=t.is_pinned()))


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

    x_pad: Optional[torch.Tensor]         # (obs, vars) fp32 on the device;
    # None for a non-resident handle, whose x is fetched through ``blocks``
    spec: Optional[SolverSpec] = None     # default spec bound by prepare()
    fingerprint: Optional[str] = None
    chol: Dict[Tuple[int, float], torch.Tensor] = field(default_factory=dict)
    max_tenants: int = 64
    blocks: Optional[object] = None       # StoreBlockSource of a
    # non-resident handle (shape / num_blocks(thr) / block_t(thr, j))
    home: Optional[str] = None            # placement kind this design
    # primarily serves from (bind_home, first wins)
    mesh: Optional[object] = None         # serve.placement.ServeMesh bound
    # as the default for placement-routed solves
    _device: Optional[torch.device] = field(default=None, repr=False)
    _cn: Optional[torch.Tensor] = field(default=None, repr=False)
    _cn_thr: Dict[int, torch.Tensor] = field(default_factory=dict, repr=False)
    _inv_cn: Dict[int, torch.Tensor] = field(default_factory=dict, repr=False)
    _x_t: Dict[int, torch.Tensor] = field(default_factory=dict, repr=False)
    _x_bf16: Dict[int, torch.Tensor] = field(default_factory=dict,
                                             repr=False)
    _warm: "OrderedDict[str, torch.Tensor]" = field(default_factory=OrderedDict,
                                                    repr=False)
    # Tenants whose warm coefficients came back with a demoted design's
    # state (restore_state), not from a solve on this handle.
    _warm_restored: set = field(default_factory=set, repr=False)
    _sharded: Dict[object, object] = field(default_factory=dict, repr=False)
    _lock: threading.RLock = field(default_factory=threading.RLock,
                                   repr=False, compare=False)

    # ------------------------------------------------------------ identity
    @property
    def shape(self) -> Tuple[int, int]:
        if self.x_pad is not None:
            return tuple(self.x_pad.shape)
        return tuple(self.blocks.shape)

    @property
    def device(self) -> torch.device:
        """Where solves run: the resident design's device, or the one a
        non-resident handle was built for."""
        return self.x_pad.device if self.x_pad is not None else self._device

    @property
    def resident(self) -> bool:
        """Whether x is on the device (vs fetched block by block)."""
        return self.x_pad is not None

    def _require_x(self, what: str) -> torch.Tensor:
        """The resident design, or a clear error on a non-resident one."""
        if self.x_pad is None:
            raise UnsupportedSpecError(
                f"{what} needs the device-resident design, but this "
                f"PreparedDesign is non-resident (x blocks stream from host "
                f"memory); solve with a streaming method "
                f"{streaming_methods()}")
        return self.x_pad

    def design_key(self) -> str:
        """The fingerprint handed to ``prepare``, or (lazily) the content
        hash of the design's bytes."""
        with self._lock:
            if self.fingerprint is None:
                self.fingerprint = design_fingerprint(
                    self._require_x("design_key"))
            return self.fingerprint

    # --------------------------------------------- per-tenant warm starts
    def warm_coef(self, tenant_id: Optional[str]) -> Optional[torch.Tensor]:
        """Last stored coefficients for ``tenant_id`` (None = cold)."""
        return self.warm_coef_source(tenant_id)[0]

    def warm_coef_source(self, tenant_id: Optional[str]):
        """(coefficients, source) for ``tenant_id``: source ``"handle"``
        where a solve on this handle stored them, ``"restored"`` where
        they came back with the design's state from a lower store tier;
        (None, None) when cold."""
        if tenant_id is None:
            return None, None
        with self._lock:
            coef = self._warm.get(tenant_id)
            if coef is None:
                return None, None
            self._warm.move_to_end(tenant_id)
            return coef, ("restored" if tenant_id in self._warm_restored
                          else "handle")

    def store_coef(self, tenant_id: Optional[str], coef) -> None:
        """Retain a copy of a tenant's solved coefficients, LRU-bounded."""
        if tenant_id is None:
            return
        coef = _settled(as_f32(coef, self.device).clone())
        with self._lock:
            self._warm[tenant_id] = coef
            self._warm.move_to_end(tenant_id)
            self._warm_restored.discard(tenant_id)
            while len(self._warm) > self.max_tenants:
                self._warm.popitem(last=False)

    def store_coefs(self, tenant_ids, coefs: torch.Tensor) -> None:
        """Retain the coefficients of a coalesced group: column ``c`` of
        ``coefs`` (vars, k) for ``tenant_ids[c]`` (None skips a column),
        in one copy on the device and one settle for the whole group."""
        cols = [c for c, t in enumerate(tenant_ids) if t is not None]
        if not cols:
            return
        rows = _settled(as_f32(coefs, self.device).T[cols].contiguous())
        with self._lock:
            for row, c in enumerate(cols):
                self._warm[tenant_ids[c]] = rows[row]
                self._warm.move_to_end(tenant_ids[c])
                self._warm_restored.discard(tenant_ids[c])
            while len(self._warm) > self.max_tenants:
                self._warm.popitem(last=False)

    # ------------------------------------------------- derived design state
    @property
    def cn(self) -> torch.Tensor:
        """Squared column norms (vars,), computed on first use."""
        with self._lock:
            if self._cn is None:
                self._cn = _settled(column_norms_sq(
                    self._require_x("column norms")))
            return self._cn

    def cn_for_thr(self, thr: int) -> torch.Tensor:
        """Column norms zero-extended to a multiple of ``thr``."""
        vars_p = self.shape[1]
        pad = -(-vars_p // thr) * thr - vars_p
        if pad == 0:
            return self.cn
        with self._lock:
            if thr not in self._cn_thr:
                self._cn_thr[thr] = _settled(torch.cat(
                    [self.cn, self.cn.new_zeros((pad,))]))
            return self._cn_thr[thr]

    def inv_cn_for(self, thr: int) -> torch.Tensor:
        """Inverse squared column norms in the thr-padded layout (0 on
        padded columns, which pins their updates to 0)."""
        with self._lock:
            if thr not in self._inv_cn:
                self._inv_cn[thr] = _settled(safe_inv(self.cn_for_thr(thr)))
            return self._inv_cn[thr]

    def x_t_for(self, thr: int) -> torch.Tensor:
        """Contiguous TRANSPOSED copy (vars_pad, obs), vars zero-padded to a
        multiple of ``thr``: the CUDA kernels' layout, built once."""
        with self._lock:
            if thr not in self._x_t:
                x_t = self._require_x("x_t_for").T
                vars_p = x_t.shape[0]
                pad = -(-vars_p // thr) * thr - vars_p
                if pad:
                    x_t = torch.nn.functional.pad(x_t, (0, 0, 0, pad))
                self._x_t[thr] = _settled(x_t.contiguous())
            return self._x_t[thr]

    def x_bf16_for(self, thr: int) -> torch.Tensor:
        """Quantized cache tier: ``x_t_for(thr)`` cast once to bf16 (round
        to nearest even), contiguous and memoised per ``thr``.  The bf16
        precisions' kernels read this copy (half the bytes of x) while the
        norms, residual, coefficients and SSE stay fp32; ``x_t_for`` stays
        cached beside it for fp32 solves and the fp32 polish."""
        with self._lock:
            if thr not in self._x_bf16:
                self._x_bf16[thr] = _settled(self.x_t_for(thr).to(
                    torch.bfloat16).contiguous())
            return self._x_bf16[thr]

    def chol_for(self, thr: int, ridge: float) -> torch.Tensor:
        """Block-Gram Cholesky factors for (thr, ridge), computed once."""
        from repro_torch.core.solvebakp import _pad_cols, block_gram_cholesky

        key = (int(thr), float(ridge))
        with self._lock:
            if key not in self.chol:
                x, _, nblocks = _pad_cols(self._require_x("chol_for"),
                                          thr)
                self.chol[key] = _settled(block_gram_cholesky(
                    x.reshape(self.shape[0], nblocks, thr), ridge))
            return self.chol[key]

    def x_for_placement(self, placement, smesh):
        """``x_pad`` laid out for a sharded placement on ``smesh`` (a
        ``serve.placement.ServeMesh``): a ``ShardedDesign`` of row blocks
        (``obs_sharded``), one replica a distinct device, shared by the
        shards on it (``rhs_sharded``), or (row, column) blocks
        (``mesh_2d``), each a copy on its shard's device.  Built once per
        placement under the lock, each tensor settled before it is
        published; a single-device placement returns ``x_pad``."""
        if placement is None or not placement.sharded:
            return self.x_pad
        from repro_torch.core.distributed import shard_grid, shard_x

        kind = _SHARD_KINDS.get(placement.kind)
        if kind is None:
            raise ValueError(f"unknown placement kind {placement.kind!r}")
        with self._lock:
            grid = shard_grid(smesh.mesh, kind, smesh.data_axes,
                              smesh.model_axis)
            sharded = self._sharded.get(placement)
            if sharded is None or sharded.grid != grid:
                sharded = shard_x(self._require_x("x_for_placement"),
                                  smesh.mesh, kind,
                                  data_axes=smesh.data_axes,
                                  model_axis=smesh.model_axis)
                for t in set(sharded.parts):
                    _settled(t)
                self._sharded[placement] = sharded
            return sharded

    def drop_sharded(self) -> None:
        """Forget the sharded copies (the design store's demotion: a solve
        in flight keeps the copy it holds)."""
        with self._lock:
            self._sharded.clear()

    def warm_method_state(self, spec: SolverSpec) -> None:
        """Run ``spec.method``'s prepare hook (norm layouts, Gram factors,
        the transposed copy)."""
        entry = solver_method(spec.method)
        if entry.prepare is not None:
            entry.prepare(self, spec)

    # ------------------------------------------------ tier snapshot/restore
    def snapshot_state(self, *, pin: bool) -> dict:
        """What the design store keeps of this handle when it leaves the
        device, as CPU tensors: the kernels' per-thr transposed fp32 / bf16
        layouts (``x_t`` / ``x_bf16``, pinned when ``pin``), the column
        norms (``cn``), the Cholesky factors (``chol``), the per-tenant
        warm coefficients (``warm``, least recently used first) and the
        home lane (``home``).  The copies run on the calling thread's
        stream."""
        with self._lock:
            return dict(
                x_t={t: host_copy(a, pin=pin) for t, a in self._x_t.items()},
                x_bf16={t: host_copy(a, pin=pin)
                        for t, a in self._x_bf16.items()},
                cn=None if self._cn is None else host_copy(self._cn,
                                                           pin=False),
                chol={k: host_copy(v, pin=False)
                      for k, v in self.chol.items()},
                warm=OrderedDict((t, host_copy(c, pin=False))
                                 for t, c in self._warm.items()),
                home=self.home)

    def restore_state(self, *, cn=None, chol=(), warm=(), home=None,
                      x_t=(), x_bf16=()) -> None:
        """Install state a ``snapshot_state`` took (CPU or device tensors,
        keyed as it keys them): each tensor is copied to this handle's
        device and settled before it is published.  Layouts already built
        are kept; a bound home stays bound (first wins)."""
        dev = self.device
        with self._lock:
            if cn is not None:
                self._cn = device_copy(cn, dev)
            for k, v in dict(chol).items():
                self.chol[k] = device_copy(v, dev)
            for t, c in dict(warm).items():
                self._warm[t] = device_copy(c, dev)
                self._warm_restored.add(t)
            for t, a in dict(x_t).items():
                if t not in self._x_t:
                    self._x_t[t] = device_copy(a, dev)
            for t, a in dict(x_bf16).items():
                if t not in self._x_bf16:
                    self._x_bf16[t] = device_copy(a, dev)
            if home is not None and self.home is None:
                self.home = home

    # ------------------------------------------------------ lane residency
    def bind_home(self, placement=None) -> str:
        """Bind (first wins) and return this design's home placement kind:
        ``"single"`` or a sharded placement's kind.  A design warmed for an
        obs-sharded bucket keeps that home when single-device leftovers
        later solve against it too."""
        kind = placement.kind if placement is not None else "single"
        with self._lock:
            if self.home is None:
                self.home = kind
            return self.home

    def warm_lane_state(self, spec: SolverSpec, placement=None,
                        mesh=None) -> None:
        """Warm every resident tier a (spec, placement) solve needs — the
        method's prepare hook (thr-padded norms, Gram factors, the
        kernels' transposed and bf16 copies) plus a sharded placement's
        copy on ``mesh`` (default: the one bound at ``prepare``) — and bind
        the design's home.  Idempotent; the serving cache calls it on the
        flush thread (the dispatcher on its own), so the lanes find their
        state built and settled."""
        self.bind_home(placement)
        self.warm_method_state(spec)
        mesh = mesh if mesh is not None else self.mesh
        if (placement is not None and placement.sharded and mesh is not None
                and self.x_pad is not None):
            self.x_for_placement(placement, mesh)

    def resident_lanes(self) -> Tuple[str, ...]:
        """Which per-lane resident tiers this design holds: ``"single"``
        (``x_pad``) for a resident handle, plus ``"fused"`` (the kernels'
        transposed layout), ``"fused_bf16"`` (the quantized tier) and each
        sharded placement kind with a copy on its mesh."""
        with self._lock:
            out = ["single"] if self.x_pad is not None else []
            if self._x_t:
                out.append("fused")
            if self._x_bf16:
                out.append("fused_bf16")
            out.extend(sorted({p.kind for p in self._sharded}))
            return tuple(out)

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
        mesh=None,
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
          placement / mesh: mesh-sharded execution (the serving placement
            layer; ``mesh`` defaults to the one bound at ``prepare``).  A
            sharded placement runs the method's sharded backend; a method
            registered without one (``shardable=False``) raises
            ``UnsupportedSpecError``.
        """
        spec = spec if spec is not None else self.spec
        if spec is None:
            raise ValueError(
                "no SolverSpec bound to this PreparedDesign; pass spec=")
        entry = ensure_precision_supported(spec)
        if self.x_pad is None and not entry.streams:
            raise UnsupportedSpecError(
                f"method {spec.method!r} cannot solve a non-resident design "
                f"(x blocks stay in host memory, not on the device); use a "
                f"streaming method {streaming_methods()}")
        shard_kw = {}
        if placement is not None and placement.sharded:
            if not entry.shardable:
                raise UnsupportedSpecError(
                    f"method {spec.method!r} has no sharded backend for "
                    f"placement {placement.kind!r}")
            shard_kw = dict(placement=placement,
                            mesh=mesh if mesh is not None else self.mesh)
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
        res = entry.solve(self, y, spec, a0=a0, generator=generator,
                          **shard_kw)
        if store_tenant is not None and warm_retention_ok(res):
            self.store_coef(store_tenant, res.coef)
        return res


def prepare(
    x,
    spec: Optional[SolverSpec] = None,
    mesh=None,
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
      mesh: optional ``repro_torch.serve.placement.ServeMesh`` bound as
        the default for placement-routed solves.
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
    prepared = PreparedDesign(x_pad=_settled(x.contiguous()), spec=spec,
                              fingerprint=fingerprint, mesh=mesh,
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
    resident: bool = True,
    cn=None,
) -> PreparedDesign:
    """Build the port's handle from another handle's state as arrays.

    Args:
      x_pad: (obs, vars) design exactly as the source handle holds it (for
        a non-resident source, the host copy its store keeps).
      fingerprint: the source handle's ``design_key()``.
      chol: block-Gram Cholesky factors keyed by ``(thr, ridge)``.
      warm: per-tenant warm-start coefficients, least recently used first.
      spec / device / max_tenants: as ``prepare``.
      resident: False builds a NON-RESIDENT handle: ``x_pad`` goes to the
        host tier of a ``DesignStore`` of its own (the transposed layout,
        pinned when ``device`` is a GPU), and solves fetch it block by
        block (``bakp_stream``).
      cn: the source's squared column norms (vars,); computed from the
        host copy when omitted.
    """
    if resident:
        p = prepare(x_pad, None, device=device, fingerprint=fingerprint,
                    max_tenants=max_tenants)
    else:
        from repro_torch.obs import MetricsRegistry
        from repro_torch.store.store import DesignStore

        # A store of its own with no device budget: the design lands on
        # its host tier, and the handle streams blocks from there.
        store = DesignStore(device_bytes=0, device=device,
                            registry=MetricsRegistry())
        p = store.build(fingerprint or "", x_pad, max_tenants=max_tenants)
        p.fingerprint = fingerprint
        if cn is not None:
            p._cn = device_copy(as_f32(cn, "cpu"), p.device)
    p.spec = spec
    for (thr, ridge), factors in (chol or {}).items():
        p.chol[(int(thr), float(ridge))] = _settled(as_f32(factors,
                                                           p.device))
    for tenant, coef in (warm or {}).items():
        p.store_coef(tenant, np.asarray(coef))
    if spec is not None:
        ensure_precision_supported(spec)
        p.warm_method_state(spec)
    return p
