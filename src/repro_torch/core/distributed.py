"""Distributed SolveBakP of the PyTorch port: the paper's §6 parallelisation
over a device mesh.

Counterpart of ``repro.core.distributed``, with its four shardings and
their signatures and defaults:

* **obs-sharded** (``solvebakp_obs_sharded``) — rows of ``x`` shard over the
  data axes; the block inner products ⟨x_k, e⟩ sum over the row shards once
  a block step.
* **vars-sharded** (``solvebakp_vars_sharded``) — columns shard over the
  model axis; each shard updates its local block Jacobi-style from a shared
  residual, then the residual correction sums the shards' rank-thr updates
  (default ``mode="gram"``, ``omega=0.5``: the cross-shard block is
  shards·thr wide).
* **2-D** (``solvebakp_2d``) — both: inner products sum over the data
  axes, residual corrections over the model axis.
* **rhs-sharded** (``solvebakp_rhs_sharded``) — the multi-RHS ``k`` axis
  shards over the data axes and ``x`` is replicated; the only collective
  is the per-sweep SSE, so the stopping decision (and history) is the
  group-global one of the single-device multi-RHS solve.

One controller drives the whole mesh, as ``shard_map`` does: a solve runs
one per-shard body (``_bakp_local``) over the shards' tensors, each on its
own device, and writes the collectives out.  A sum over a group (the JAX
``psum``) adds the members' partials in rank order on the group's first
device and copies the result to each member's device; on a virtual mesh
(shards repeating one device) that copy is a no-op.  Values replicated
across a group (the block factors, each ``da`` of the data-summed kinds)
are computed once, on the group's first device, and copied to the members:
the values JAX's replicated computation gives.  Launches are asynchronous
per device, so shards on distinct cards overlap.  The stop flag is read to
the host once a sweep, as the port's plain solvers do.  Nothing is
compiled, so there is no program cache.

``_KINDS`` states how x, y and a0 split: contiguous row and column blocks
in the mesh's device order, as ``NamedSharding`` lays them out.  A design
is laid out once by ``shard_x`` (a ``ShardedDesign``: a fresh copy of each
block on its shard's device in x's dtype, positions holding one block on
one device sharing it); the solvers take it or a plain tensor, which they
lay out themselves.  As in JAX, a shard keeps x's dtype and each block is
widened to fp32 where it is read (a bf16 design holds half an fp32 one's
bytes; the widening is exact, so the values are the same).  Results:
``coef`` whole (what JAX returns replicated) and the ``residual``
gathered, both on the device of the mesh's first shard.

A ``CollectiveRecorder`` in a ``with`` block sees every collective written
out here: each group sum (``_psum``, an all-reduce) and the gathers of
the result, as (kind, bytes a member sends, group size, mesh axes).  With
none active they record nothing.  ``host_stop=False`` (on the obs and
2-D solvers, the two the solver dry run drives) runs every one of
``max_iter`` sweeps without reading the stop flag to the host: the dry
run's ``meta`` shards (``launch/solver_dryrun.py``) hold no values, and
JAX's compiled while loop is sized by its trip count the same way.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.solvebakp import block_grams
from repro_torch.core.types import (SolveResult, atol_to_sse,
                                    column_norms_sq, safe_inv,
                                    sweep_stop_flags)


@dataclass(frozen=True)
class _Kind:
    """How one sharding lays out its operands.  ``"d"`` = the data group
    (the product of the data axes), ``"m"`` = the model axis, None = whole.
    The residual corrections sum over the model positions and the SSE over
    the data positions (a group of one where the kind does not split that
    axis); ``g_data`` says whether the block inner products (and the block
    factors) sum over the data positions too."""

    x: Tuple[Optional[str], Optional[str]]    # (rows, columns)
    y: Tuple[Optional[str], Optional[str]]    # (rows, right-hand sides)
    a0: Tuple[Optional[str], Optional[str]]   # (vars, right-hand sides)
    g_data: bool

    def uses(self, axis: str) -> bool:
        return axis in self.x + self.y + self.a0


# The JAX table of shard_map specs: the (x, y, a0) splits and whether the
# inner products psum over the data axes.
_KINDS = {
    "obs": _Kind(("d", None), ("d", None), (None, None), True),
    "vars": _Kind((None, "m"), (None, None), ("m", None), False),
    "2d": _Kind(("d", "m"), ("d", None), ("m", None), True),
    "rhs": _Kind((None, None), (None, "d"), (None, "d"), False),
}


class CollectiveRecorder:
    """Records the collectives written out in this module while active
    (``with recorder:``), on the thread that entered it: ``records`` holds
    (kind, bytes a member sends, group size, mesh axes) per collective;
    ``busy`` is positive while a collective's own arithmetic runs (a cost
    counter leaves it out of the compute it counts)."""

    _active = threading.local()

    def __init__(self):
        self.records: List[Tuple[str, int, int, Tuple[str, ...]]] = []
        self.busy = 0

    def __enter__(self):
        self._prev = getattr(CollectiveRecorder._active, "rec", None)
        CollectiveRecorder._active.rec = self
        return self

    def __exit__(self, *exc):
        CollectiveRecorder._active.rec = self._prev

    @classmethod
    def current(cls) -> Optional["CollectiveRecorder"]:
        return getattr(cls._active, "rec", None)

    def bytes_by(self, kind: Optional[str] = None) -> int:
        """Bytes sent by one member, summed over the recorded
        collectives (of ``kind``)."""
        return sum(b for k, b, _, _ in self.records
                   if kind is None or k == kind)


class _Collective:
    """Reports one collective to the active recorder and marks its
    arithmetic as the collective's own."""

    def __init__(self, kind: str, t: torch.Tensor, group: int,
                 axes: Tuple[str, ...]):
        self.rec = CollectiveRecorder.current() if group > 1 else None
        if self.rec is not None:
            self.rec.records.append(
                (kind, t.numel() * t.element_size(), group, axes))

    def __enter__(self):
        if self.rec is not None:
            self.rec.busy += 1

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.busy -= 1


@dataclass(frozen=True)
class ShardGrid:
    """The compute positions of one sharding: ``d`` data positions by ``m``
    model positions, position (i, j) on ``devices[i * m + j]``.  Mesh axes
    a sharding does not split (the model axis of an obs-sharded solve)
    replicate; their positions compute nothing the first one does not.
    ``data_axes`` / ``model_axis`` name the mesh axes the positions span
    (what a collective over them is reported under)."""

    devices: Tuple[torch.device, ...]
    d: int
    m: int
    data_axes: Tuple[str, ...] = field(default=(), compare=False)
    model_axis: Tuple[str, ...] = field(default=(), compare=False)

    def dev(self, i: int, j: int) -> torch.device:
        return self.devices[i * self.m + j]

    def positions(self) -> List[Tuple[int, int]]:
        return [(i, j) for i in range(self.d) for j in range(self.m)]


def shard_grid(mesh, kind: str, data_axes: Sequence[str] = ("data",),
               model_axis: Optional[str] = None) -> ShardGrid:
    """Where each position of ``kind`` runs on ``mesh``: the data index is
    flattened over ``data_axes`` in order (major first), as a
    ``PartitionSpec((a, b))`` splits; axes left out sit at 0."""
    k = _KINDS[kind]
    data_axes = tuple(data_axes)
    sizes = [mesh.shape[a] for a in data_axes]
    d = int(np.prod(sizes)) if k.uses("d") else 1
    m = int(mesh.shape[model_axis]) if k.uses("m") else 1
    devs = []
    for i in range(d):
        idx = (dict(zip(data_axes, np.unravel_index(i, sizes)))
               if k.uses("d") else {})
        for j in range(m):
            if k.uses("m"):
                idx = dict(idx, **{model_axis: j})
            devs.append(mesh.device_at(idx))
    return ShardGrid(tuple(devs), d, m,
                     data_axes if k.uses("d") else (),
                     (model_axis,) if k.uses("m") else ())


def _part(t: torch.Tensor, split, i: int, j: int, grid: ShardGrid):
    """Block (i, j) of ``t`` under ``split`` (per dim: "d", "m" or None),
    as a view."""
    for dim, ax in enumerate(split):
        if ax is None:
            continue
        n, pos = (grid.d, i) if ax == "d" else (grid.m, j)
        size = t.shape[dim] // n
        t = t.narrow(dim, pos * size, size)
    return t


@dataclass(frozen=True)
class ShardedDesign:
    """``x`` laid out for one sharding: ``parts[i * m + j]`` is position
    (i, j)'s block, a contiguous copy in x's dtype on its device.  Positions that
    hold the same block on the same device share one tensor (the replicas
    of an rhs-sharded design on a virtual mesh)."""

    kind: str
    shape: Tuple[int, int]
    grid: ShardGrid
    parts: Tuple[torch.Tensor, ...]

    def part(self, i: int, j: int) -> torch.Tensor:
        return self.parts[i * self.grid.m + j]

    @property
    def nbytes(self) -> int:
        """Bytes the layout holds, each shared tensor counted once."""
        return sum(t.untyped_storage().nbytes()
                   for t in {id(t): t for t in self.parts}.values())


def _check_divides(kind: str, obs: int, nvars: int, grid: ShardGrid,
                   nrhs: Optional[int] = None) -> None:
    """The JAX solvers' shape checks (their messages)."""
    k = _KINDS[kind]
    if k.x[0] == "d" and obs % grid.d:
        raise ValueError(f"obs={obs} must divide data axes size {grid.d}")
    if k.x[1] == "m" and nvars % grid.m:
        raise ValueError(
            f"vars={nvars} must divide model axis size {grid.m}")
    if kind == "rhs" and nrhs is not None and nrhs % grid.d:
        raise ValueError(f"k={nrhs} must divide data axes size {grid.d}")


def shard_x(x: torch.Tensor, mesh, kind: str, *,
            data_axes: Sequence[str] = ("data",),
            model_axis: Optional[str] = None) -> ShardedDesign:
    """Lay ``x`` (obs, vars) out for ``kind`` on ``mesh``: each block copied
    once to each device that holds it (row blocks for "obs", column blocks
    for "vars", both for "2d", the whole design for "rhs").  The copies
    run on the calling thread's streams."""
    if kind not in _KINDS:
        raise ValueError(f"unknown sharding {kind!r}")
    grid = shard_grid(mesh, kind, data_axes, model_axis)
    obs, nvars = x.shape
    _check_divides(kind, obs, nvars, grid)
    split = _KINDS[kind].x
    made: Dict[tuple, torch.Tensor] = {}
    parts = []
    for i, j in grid.positions():
        dev = grid.dev(i, j)
        key = (i if split[0] else None, j if split[1] else None, str(dev))
        if key not in made:
            blk = _part(x, split, i, j, grid)
            made[key] = torch.empty(tuple(blk.shape), dtype=x.dtype,
                                    device=dev).copy_(blk)
        parts.append(made[key])
    return ShardedDesign(kind, (obs, nvars), grid, tuple(parts))


def _psum(parts: Sequence[torch.Tensor], to: Sequence[torch.device],
          axes: Tuple[str, ...] = ()):
    """A group's sum: ``parts`` (rank order) added in order on the first
    member's device, then copied to each device of ``to`` (a no-op where
    the sum already lives there).  An all-reduce over ``axes`` to the
    active ``CollectiveRecorder``."""
    with _Collective("all-reduce", parts[0], len(parts), axes):
        acc = parts[0]
        for t in parts[1:]:
            acc = acc + t.to(acc.device)
        return [acc.to(d) for d in to]


def _gather(parts: Sequence[torch.Tensor], dim: int, to: torch.device,
            axes: Tuple[str, ...]):
    """The members' blocks concatenated along ``dim`` on ``to``: an
    all-gather over ``axes`` to the active ``CollectiveRecorder``."""
    with _Collective("all-gather", parts[0], len(parts), axes):
        return torch.cat([t.to(to) for t in parts], dim)


def _bakp_local(xs: ShardedDesign, ys: Dict[int, torch.Tensor],
                a0s: Optional[Dict[tuple, torch.Tensor]], atol_sse: float,
                rtol: float, *, nvars_loc: int, thr: int, max_iter: int,
                omega: float, mode: str, ridge: float,
                host_stop: bool = True):
    """SolveBakP sweeps over every shard of ``xs``: the body of the JAX
    ``_bakp_local``, run once per position with its collectives written out.

    ``ys[i]`` is data position i's right-hand sides (obs_loc, k_loc) on
    ``dev(i, 0)``; ``a0s[(i, j)]`` position (i, j)'s warm start (nvars_loc,
    k_loc), or None (cold).  Each column shard pads its own columns to a
    multiple of ``thr`` with a mask, so with several model positions the
    local block order is not the single-device one.  Each block of x is
    widened to fp32 where it is read.  Returns (coef, residual, sse, n,
    converged, history), coef (vars, k) and residual (obs, k) on the first
    shard's device.
    """
    kind = _KINDS[xs.kind]
    grid = xs.grid
    daxes, maxes = grid.data_axes, grid.model_axis
    dev = grid.dev
    dev0 = dev(0, 0)
    pos = grid.positions()
    nblocks = -(-nvars_loc // thr)
    width = nblocks * thr
    pad = width - nvars_loc
    padded: Dict[int, torch.Tensor] = {}
    xp = {}
    for i, j in pos:
        t = xs.part(i, j)
        if id(t) not in padded:  # shared replicas pad once
            padded[id(t)] = torch.nn.functional.pad(t, (0, pad)) if pad else t
        xp[i, j] = padded[id(t)]
    masks = {d: (torch.arange(width, device=d) < nvars_loc).float()
             for d in set(grid.devices)}
    # The positions that compute each block's ``da``: one a model index
    # when the inner products sum over data (the rest of its group receive
    # a copy), else every position (rhs: each holds its own right-hand
    # sides).
    heads = [(0, j) for j in range(grid.m)] if kind.g_data else pos

    def group(h):
        """The positions whose partials make head ``h``'s sums and that
        take its ``da``."""
        return [(i, h[1]) for i in range(grid.d)] if kind.g_data else [h]

    factor = {}
    for j in range(grid.m):
        d0 = dev(0, j)
        if mode == "gram":
            gram = _psum([block_grams(xp[p].reshape(-1, nblocks, thr))
                          for p in group((0, j))], [d0], daxes)[0]
            gram = gram + ridge * torch.eye(thr, dtype=torch.float32,
                                            device=d0)[None]
            f = torch.linalg.cholesky(gram)
        else:
            cn = _psum([column_norms_sq(xp[p]) for p in group((0, j))],
                       [d0], daxes)[0]
            f = safe_inv(cn) * masks[d0]
        for p in heads:
            if p[1] == j:
                factor[p] = f.to(dev(*p))

    nrhs_loc = ys[0].shape[1]
    a = {p: torch.zeros((width, nrhs_loc), dtype=torch.float32,
                        device=dev(*p)) for p in heads}
    e: Dict[tuple, torch.Tensor] = {}
    for i in range(grid.d):
        e_i = ys[i]
        if a0s is not None:
            # Warm residual: column shards each contribute x_loc @ a0_loc.
            corr = _psum([xp[i, j].float() @ a0s[i, j]
                          for j in range(grid.m)], [dev(i, 0)], maxes)[0]
            e_i = e_i - corr
        for j in range(grid.m):
            e[i, j] = e_i.to(dev(i, j))
    if a0s is not None:
        for p in heads:
            a[p] += a0s[p]

    def sse_of():
        return _psum([torch.dot(e[i, 0].reshape(-1), e[i, 0].reshape(-1))
                      for i in range(grid.d)], [dev0], daxes)[0]

    sse0 = sse_of()
    history = torch.full((max_iter,), math.nan, dtype=torch.float32,
                         device=dev0)
    sse, n, converged = sse0, 0, torch.tensor(False)
    while n < max_iter:
        for b in range(nblocks):
            cols = slice(b * thr, (b + 1) * thr)
            da = {}
            for h in heads:
                g = _psum([xp[p][:, cols].float().T @ e[p]
                           for p in group(h)], [dev(*h)], daxes)[0]
                f = factor[h]
                if mode == "jacobi":
                    d_h = g * f[cols][:, None]
                else:
                    d_h = (torch.cholesky_solve(g, f[b])
                           * masks[dev(*h)][cols][:, None])
                d_h = omega * d_h
                a[h][cols] += d_h
                for p in group(h):
                    da[p] = d_h.to(dev(*p))
            # Residual correction: Jacobi across the model positions.
            for i in range(grid.d):
                corr = _psum([xp[i, j][:, cols].float() @ da[i, j]
                              for j in range(grid.m)], [dev(i, 0)],
                             maxes)[0]
                e_i = e[i, 0] - corr
                for j in range(grid.m):
                    e[i, j] = e_i.to(dev(i, j))
        sse_new = sse_of()
        history[n] = sse_new
        converged, stop = sweep_stop_flags(sse_new, sse, sse0, atol_sse, rtol)
        sse, n = sse_new, n + 1
        if host_stop and bool(stop):            # one host read per sweep
            break
    # coef: model positions stack vars, data heads (rhs) stack columns.
    coef = _gather(
        [_gather([a[i, j][:nvars_loc] for j in range(grid.m)], 0, dev0,
                 maxes)
         for i in sorted({h[0] for h in heads})], 1, dev0, daxes)
    resid_dim = 0 if kind.y[0] == "d" else 1
    resid = _gather([e[i, 0] for i in range(grid.d)], resid_dim, dev0,
                    daxes)
    return coef, resid, sse, n, converged, history


def _solve_sharded(kind, x, y, mesh, *, data_axes, model_axis, thr,
                   max_iter, atol, rtol, omega, mode, ridge, a0, host_stop):
    """Shared driver: normalise y / a0, lay out and run the shards, reshape
    back (the JAX driver's checks and messages)."""
    if not isinstance(x, (ShardedDesign, torch.Tensor)):
        x = torch.as_tensor(np.asarray(x, np.float32))
    obs, nvars = x.shape
    y = torch.as_tensor(y, dtype=torch.float32)
    if y.dim() not in (1, 2):
        raise ValueError(f"y must be (obs,) or (obs, k), got {tuple(y.shape)}")
    multi = y.dim() == 2
    nrhs = y.shape[1] if multi else 1
    y2 = y.reshape(obs, nrhs)
    if a0 is not None:
        a0 = torch.as_tensor(a0, dtype=torch.float32)
        if tuple(a0.shape) not in ((nvars,), (nvars, nrhs)):
            raise ValueError(
                f"a0 must be ({nvars},) or ({nvars}, {nrhs}) matching x "
                f"columns and y RHS count, got {tuple(a0.shape)}")
        # (vars,) broadcasts across all right-hand sides, so rhs-sharding
        # slices it per shard like any other (vars, k).
        a0 = a0.reshape(nvars, -1).expand(nvars, nrhs)
    if mode not in ("jacobi", "gram"):
        raise ValueError(f"unknown mode {mode!r}")
    grid = shard_grid(mesh, kind, data_axes, model_axis)
    if kind == "rhs" and not multi:
        raise ValueError("rhs-sharded solve needs multi-RHS y=(obs, k)")
    _check_divides(kind, obs, nvars, grid, nrhs)
    if isinstance(x, ShardedDesign):
        if x.kind != kind or x.grid != grid:
            raise ValueError(
                f"x is laid out for {x.kind!r} on {len(x.grid.devices)} "
                f"positions, not for this {kind!r} solve on this mesh")
        xs = x
    else:
        xs = shard_x(x, mesh, kind, data_axes=data_axes,
                     model_axis=model_axis)
    k = _KINDS[kind]
    ys = {i: _part(y2, k.y, i, 0, grid).to(grid.dev(i, 0))
          for i in range(grid.d)}
    nvars_loc = nvars // grid.m
    a0s = None
    if a0 is not None:
        pad = -(-nvars_loc // thr) * thr - nvars_loc
        a0s = {}
        for i, j in grid.positions():
            blk = _part(a0, k.a0, i, j, grid).to(grid.dev(i, j))
            a0s[i, j] = torch.nn.functional.pad(blk, (0, 0, 0, pad))
    coef, e, sse, n, converged, history = _bakp_local(
        xs, ys, a0s, atol_to_sse(obs, nrhs, atol), rtol,
        nvars_loc=nvars_loc, thr=int(thr), max_iter=int(max_iter),
        omega=float(omega), mode=mode, ridge=float(ridge),
        host_stop=host_stop)
    if not multi:
        coef, e = coef[:, 0], e[:, 0]
    return SolveResult(coef, e, sse, torch.tensor(n, dtype=torch.int32),
                       converged, history)


def solvebakp_obs_sharded(
    x,
    y,
    mesh,
    *,
    data_axes: Sequence[str] = ("data",),
    thr: int = 128,
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    omega: float = 1.0,
    mode: str = "gram",
    ridge: float = 1e-6,
    a0=None,
    host_stop: bool = True,
) -> SolveResult:
    """SolveBakP with rows sharded over ``data_axes`` of ``mesh``.

    ``x`` is (obs, vars) with obs divisible by the product of the data axis
    sizes (a tensor, or a ``ShardedDesign`` from ``shard_x(x, mesh,
    "obs")``); ``y`` is (obs,) or (obs, k); ``a0`` an optional (vars,) or
    (vars, k) warm start.  Block structure and update order are the
    single-device ``solvebakp``'s, only the inner products sum over the row
    shards, so the iterates agree to reduction-order rounding.  The result
    is on the first shard's device (module doc).
    """
    return _solve_sharded(
        "obs", x, y, mesh, data_axes=data_axes, model_axis=None, thr=thr,
        max_iter=max_iter, atol=atol, rtol=rtol, omega=omega, mode=mode,
        ridge=ridge, a0=a0, host_stop=host_stop)


def solvebakp_vars_sharded(
    x,
    y,
    mesh,
    *,
    model_axis: str = "model",
    thr: int = 128,
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    omega: float = 0.5,
    mode: str = "gram",
    ridge: float = 1e-6,
    a0=None,
) -> SolveResult:
    """SolveBakP with columns sharded over ``model_axis``.

    Each shard sweeps its local blocks Jacobi-style against the shared
    residual; every block step ends with the summed rank-(M·thr) residual
    correction.  Defaults to gram + ω=0.5 damping (module doc).  ``y`` may
    be (obs, k); ``a0`` warm starts split by columns with the coefficients.
    """
    return _solve_sharded(
        "vars", x, y, mesh, data_axes=(), model_axis=model_axis, thr=thr,
        max_iter=max_iter, atol=atol, rtol=rtol, omega=omega, mode=mode,
        ridge=ridge, a0=a0, host_stop=True)


def solvebakp_2d(
    x,
    y,
    mesh,
    *,
    data_axes: Sequence[str] = ("data",),
    model_axis: str = "model",
    thr: int = 128,
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    omega: float = 0.5,
    mode: str = "gram",
    ridge: float = 1e-6,
    a0=None,
    host_stop: bool = True,
) -> SolveResult:
    """2-D sharded SolveBakP: obs over the data axes, vars over the model
    axis.  ⟨x_k, e⟩ partials sum over data; residual corrections over
    model.  Multi-RHS ``y`` and warm starts thread through as in the 1-D
    variants."""
    return _solve_sharded(
        "2d", x, y, mesh, data_axes=data_axes, model_axis=model_axis,
        thr=thr, max_iter=max_iter, atol=atol, rtol=rtol, omega=omega,
        mode=mode, ridge=ridge, a0=a0, host_stop=host_stop)


def solvebakp_rhs_sharded(
    x,
    y,
    mesh,
    *,
    data_axes: Sequence[str] = ("data",),
    thr: int = 128,
    max_iter: int = 50,
    atol: float = 0.0,
    rtol: float = 0.0,
    omega: float = 1.0,
    mode: str = "gram",
    ridge: float = 1e-6,
    a0=None,
) -> SolveResult:
    """SolveBakP with the multi-RHS ``k`` axis sharded over ``data_axes``.

    ``x`` is replicated (one copy a distinct device); each shard runs the
    same block sweeps against its own (obs, k/D) slice of right-hand sides.
    The only collective is the per-sweep SSE, so the stopping decision (and
    history) is group-global: iterates and sweep counts are the
    single-device multi-RHS solve's.  ``y`` must be (obs, k) with k
    divisible by the data axes product; ``a0`` may be (vars,) (broadcast)
    or (vars, k) (split with ``y``).
    """
    return _solve_sharded(
        "rhs", x, y, mesh, data_axes=data_axes, model_axis=None, thr=thr,
        max_iter=max_iter, atol=atol, rtol=rtol, omega=omega, mode=mode,
        ridge=ridge, a0=a0, host_stop=True)
