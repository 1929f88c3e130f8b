"""Per-device cost of a step, counted from the aten ops it runs.

The counterpart of the JAX package's ``launch/hlo_analysis.py``.  Torch
has no HLO: ``CostModel`` is a ``TorchDispatchMode`` that sees each aten
op on the **local** tensors, below DTensor (it declines a DTensor op, so
DTensor runs it on the shards and the mode sees what each device
computes), and counts:

  flops      — 2·M·N·K for ``mm``, ``bmm``, ``addmm`` and ``baddbmm``
               (the attention products among them: the port's attention
               is chunked einsums), and 1 a result element for every
               other op: JAX's floor for elementwise work;
  hbm_bytes  — operand plus result bytes at every op: in eager mode each
               op is a kernel, the counterpart of a fusion boundary;
  collectives— bytes by kind and by mesh axis, from the c10d functional
               ops that DTensor emits (result bytes, as JAX counts them:
               an all-gather's gathered result, a reduce-scatter's input)
               and from ``core.distributed.CollectiveRecorder`` (the
               sharded solvers' written-out collectives);
  peak       — the high-water mark of the live bytes the counted ops
               allocated (a storage is counted once, however many views
               share it, and freed when its last tensor dies), on top of
               the arguments.

Two fallbacks change what the step computes from what a real mesh would,
and both are counted by op name in ``summary()``: ``replicated_ops``,
the ops DTensor refused and that ran replicated (``CostModel._dtensor``),
and ``gathered_views``, the view ops on a DTensor that moved data: a
view that splits a sharded dim the shards do not divide runs under
DTensor's non-strict view rule (registered by ``launch.dryrun``), which
gathers its input over that axis.  A write into such a view lands on the
gathered copy, not on the shards: ``gathered_view_writes`` counts the
in-place ops whose target shares a gathered view's storage.

View ops (no data moves: ``view``, ``permute``, ``expand``, slicing…) and
ops that touch no counted tensor are not counted.  The counted tensors are
the step's arguments (a DTensor's local shard) and every output of a
counted op; a tensor the step builds from nothing (``arange``, ``zeros``)
counts from its first use with one of them.  So the same step counts the
same on ``meta`` shards and on a card.

JAX's HLO analysis must multiply each ``while`` body by its trip count
(XLA's own cost analysis visits a scanned layer once).  That problem does
not arise here: eager mode runs every layer, microbatch and chunk, and
each op is counted as it runs.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_MATMUL = {aten.mm.default, aten.bmm.default, aten.addmm.default,
           aten.baddbmm.default}
# Ops that move no data: a view's result aliases its input; the rest only
# set metadata.
_FREE = {aten._unsafe_view.default, aten.detach.default,
         aten.lift_fresh.default, aten.empty.memory_format,
         aten.empty_strided.default, aten.empty_like.default,
         aten.new_empty.default, aten.new_empty_strided.default}
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
_C10D = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_VIEW: Dict[object, bool] = {}


def _is_view(func) -> bool:
    v = _VIEW.get(func)
    if v is None:
        v = _VIEW[func] = any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return v


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


_WRITTEN: Dict[object, tuple] = {}


def _written(func, args, kwargs):
    """The tensors ``func`` writes in place: its arguments whose schema
    marks a write (``self`` of ``add_``, ``out=`` of an out variant)."""
    idx = _WRITTEN.get(func)
    if idx is None:
        idx = _WRITTEN[func] = tuple(
            (i, a.name) for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write)
    for i, name in idx:
        t = kwargs.get(name, args[i] if i < len(args) else None)
        yield from _tensors(t)


def _matmul_flops(func, args) -> float:
    if func in (aten.mm.default, aten.addmm.default):
        a, b = (args[0], args[1]) if func is aten.mm.default else \
            (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = (args[0], args[1]) if func is aten.bmm.default else \
        (args[1], args[2])
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


_UNCACHEABLE = object()
_FUNCTIONAL: Dict[object, bool] = {}


def _functional(func) -> bool:
    """The op writes none of its arguments and its results alias none
    (``_unsafe_view`` aliases its input without saying so)."""
    ok = _FUNCTIONAL.get(func)
    if ok is None:
        sch = func._schema
        ok = _FUNCTIONAL[func] = func is not aten._unsafe_view.default and \
            not any(a.alias_info is not None
                    for a in list(sch.arguments) + list(sch.returns))
    return ok


def _arg_key(x):
    if isinstance(x, torch.Tensor):
        if type(x) is not torch.Tensor or not x.is_meta:
            raise TypeError
        return ("T", tuple(x.shape), x.stride(), x.dtype,
                x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_arg_key(y) for y in x)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return (type(x), x)
    raise TypeError


def _meta_key(func, args, kwargs):
    """The cache key of a functional op on ``meta`` tensors, else None."""
    if not _functional(func):
        return None
    try:
        key = (func, _arg_key(args),
               tuple((k, _arg_key(v)) for k, v in sorted(kwargs.items())))
    except TypeError:
        return None
    return key if any(isinstance(a, torch.Tensor) for a in _tensors(args)) \
        else None


def _meta_sig(out):
    """What ``_meta_make`` needs to remake ``out``: a tensor or a flat
    tuple / list of tensors, else ``_UNCACHEABLE``."""
    def one(t):
        return (tuple(t.shape), t.stride(), t.dtype)
    if isinstance(out, torch.Tensor) and out.is_meta:
        return one(out)
    if isinstance(out, (tuple, list)) and out and all(
            isinstance(t, torch.Tensor) and t.is_meta for t in out):
        return (type(out), [one(t) for t in out])
    return _UNCACHEABLE


def _meta_make(sig):
    def one(s):
        return torch.empty_strided(s[0], s[1], dtype=s[2], device="meta")
    if isinstance(sig[0], type):
        return sig[0](one(s) for s in sig[1])
    return one(sig)


class CostModel(TorchDispatchMode):
    """Counts a step's per-device FLOPs, HBM bytes, collectives and live
    bytes (module doc).  ``track(tree)`` marks the arguments before the
    step runs; ``axis_of`` maps a process group's name to its mesh axis
    (``DeviceMesh``: ``axis_names_by_group``)."""

    def __init__(self, axis_of: Optional[Dict[str, str]] = None,
                 recorder=None):
        super().__init__()
        self.replicated: Dict[str, int] = defaultdict(int)
        self.gathered_views: Dict[str, int] = defaultdict(int)
        self.gathered_view_writes: Dict[str, int] = defaultdict(int)
        # storage key -> storage of each gathered view's local copy (held,
        # so that a key is not reused while the check can still see it)
        self._gathered: Dict[int, object] = {}
        self._dtensor_op = False
        self.axis_of = dict(axis_of or {})
        self.recorder = recorder
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.hbm_bytes = 0.0
        self.ops = 0
        self.coll: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
        self.coll_by_axis: Dict[str, float] = defaultdict(float)
        self.coll_count = 0
        self.argument_bytes = 0
        self.live = 0
        self.peak_live = 0
        self._tracked: set = set()      # ids of live counted tensors
        self._storages: Dict[int, list] = {}
        self._meta_cache: Dict[tuple, object] = {}

    # -- the arguments -------------------------------------------------------
    def track(self, tree) -> int:
        """Mark every tensor of ``tree`` (a DTensor's local shard) as an
        argument; returns their bytes (each storage once)."""
        from torch.distributed.tensor import DTensor
        seen, total = set(), 0
        for t in _tensors(tree):
            local = t._local_tensor if isinstance(t, DTensor) else t
            self._mark(local)
            key = local.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += local.untyped_storage().nbytes()
        self.argument_bytes += total
        return total

    def _mark(self, t: torch.Tensor, alloc: bool = False) -> None:
        """Count ``t`` from now on (until it dies); with ``alloc`` its
        storage joins the live bytes."""
        key = None
        if alloc:
            key = t.untyped_storage()._cdata
            entry = self._storages.get(key)
            if entry is None:
                entry = self._storages[key] = [
                    t.untyped_storage().nbytes(), 0]
                self.live += entry[0]
                self.peak_live = max(self.peak_live, self.live)
            entry[1] += 1
        self._tracked.add(id(t))
        weakref.finalize(t, self._forget, id(t), key)

    def _forget(self, tid: int, key: Optional[int]) -> None:
        self._tracked.discard(tid)
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    # -- the ops -------------------------------------------------------------
    def _run(self, func, args, kwargs):
        """``func`` on its arguments; on ``meta`` tensors a functional op's
        outputs are made from a cache of their shapes, strides and dtypes
        by argument signature (torch's meta kernels are Python: the cost of
        a dry run)."""
        key = _meta_key(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        hit = self._meta_cache.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            hit = self._meta_cache[key] = _meta_sig(out)
            return out
        if hit is _UNCACHEABLE:
            return func(*args, **kwargs)
        return _meta_make(hit)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._dtensor_op:
                self._dtensor_op = False
                return NotImplemented    # DTensor runs it, we see its shards
            return self._dtensor(func, args, kwargs)
        out = self._run(func, args, kwargs)
        if self._gathered:
            for t in _written(func, args, kwargs):
                if t.untyped_storage()._cdata in self._gathered:
                    self.gathered_view_writes[str(func)] += 1
                    break
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        if not any(id(t) in self._tracked for t in ins):
            return out
        outs = list(_tensors(out))
        view = _is_view(func)
        for t in outs:
            if id(t) not in self._tracked:
                self._mark(t, alloc=not view)
        rec = self.recorder
        if rec is not None and rec.busy:
            return out                   # a recorded collective's own adds
        ns = func.namespace
        if ns == "_c10d_functional":
            self._collective(func, args, outs)
            return out
        if _is_view(func) or func in _FREE:
            return out
        self.ops += 1
        self.hbm_bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs)
        if func in _MATMUL:
            mm = _matmul_flops(func, args)
            self.flops += mm
            self.matmul_flops += mm
        else:
            self.flops += sum(t.numel() for t in outs)
        return out

    def _dtensor(self, func, args, kwargs):
        """A DTensor op, run by DTensor on its shards with this mode active
        for them.  Where DTensor has no sharding for it (no strategy, none
        that keeps an in-place op's placement, or a failure in its
        propagation), an in-place op runs again with its other inputs
        redistributed to its target's placements; failing that, the op
        runs on the local tensors of its inputs replicated over the whole
        mesh, its results replicated DTensors (an in-place result
        re-sharded into its target's shard).  The redistributions count as
        collectives.  Each such op is counted in ``replicated`` by name:
        what this torch's DTensor cannot shard.  A view op that DTensor
        ran with a collective (the non-strict view rule's gather) is
        counted in ``gathered_views`` and its result's storage kept for
        the write check of ``__torch_dispatch__``."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map_only

        def run(a, kw):
            self._dtensor_op = True
            try:
                with self:
                    return func(*a, **kw)
            finally:
                self._dtensor_op = False

        # What DTensor raises where it cannot shard an op: no strategy, an
        # in-place op whose placement would change, a failed propagation, or
        # a local view its redistribution left impossible.  A genuine error
        # raises again from the replicated run below.
        refused = (RuntimeError, NotImplementedError, IndexError)
        n_coll = self.coll_count
        try:
            out = run(args, kwargs)
        except refused:
            pass
        else:
            if self.coll_count > n_coll and (
                    _is_view(func) or func is aten._unsafe_view.default):
                self.gathered_views[str(func)] += 1
                for t in _tensors(out):
                    st = (t._local_tensor if isinstance(t, DTensor)
                          else t).untyped_storage()
                    self._gathered[st._cdata] = st
            return out
        sch = func._schema.arguments
        target = args[0] if sch and sch[0].alias_info is not None and \
            sch[0].alias_info.is_write else None
        if isinstance(target, DTensor):
            def like(t):
                if t is target or t.dim() != target.dim():
                    return t
                return t.redistribute(t.device_mesh, target.placements)
            with self:
                la, lk = tree_map_only(DTensor, like, (args, kwargs))
            try:
                out = run(la, lk)
                self.replicated[str(func) + " (inputs to target)"] += 1
                return out
            except refused:
                pass
        self.replicated[str(func)] += 1
        mesh = next(t.device_mesh for t in _tensors((args, kwargs))
                    if isinstance(t, DTensor))
        rep = [Replicate()] * mesh.ndim

        def local(t):
            return t.redistribute(mesh, rep)._local_tensor.contiguous()

        with self:
            la, lk = tree_map_only(DTensor, local, (args, kwargs))
            out = tree_map_only(torch.Tensor, lambda t: DTensor.from_local(
                t, mesh, rep, run_check=False), func(*la, **lk))
        if isinstance(target, DTensor):
            with self:
                back = out.redistribute(target.device_mesh,
                                        target.placements)
                target._local_tensor.copy_(back._local_tensor)
            return target
        return out

    def _collective(self, func, args, outs) -> None:
        kind = _C10D.get(func._schema.name.split("::")[-1])
        if kind is None:                 # wait_tensor, broadcast, ...
            return
        group = args[-1] if isinstance(args[-1], str) else None
        b = float(sum(_nbytes(t) for t in outs))
        if kind == "reduce-scatter":
            b = float(sum(_nbytes(t) for t in _tensors(args[0])))
        self.coll[kind] += b
        self.coll_by_axis[self.axis_of.get(group, str(group))] += b
        self.coll_count += 1
        self.hbm_bytes += sum(_nbytes(t) for t in outs)

    # -- results -------------------------------------------------------------
    def add_recorded(self, positions: int) -> None:
        """Add the ``recorder``'s collectives, per device: a group's
        bytes times its size over the ``positions`` that run the step
        (every device joins one group of each collective call)."""
        for kind, b, group, axes in self.recorder.records:
            per_device = b * group / positions
            self.coll[kind] += per_device
            self.coll_by_axis[",".join(axes) or "-"] += per_device
            self.coll_count += 1

    def summary(self) -> Dict:
        coll = dict(self.coll)
        coll["count"] = self.coll_count
        coll["total"] = sum(self.coll[k] for k in _COLLECTIVES)
        return {"flops": self.flops, "matmul_flops": self.matmul_flops,
                "hbm_bytes": self.hbm_bytes,
                "ops": self.ops, "collectives": coll,
                "replicated_ops": dict(self.replicated),
                "gathered_views": dict(self.gathered_views),
                "gathered_view_writes": dict(self.gathered_view_writes),
                "collectives_by_axis": dict(self.coll_by_axis),
                "argument_bytes": self.argument_bytes,
                "peak_live_bytes": self.peak_live}


def axis_names_by_group(mesh) -> Dict[str, str]:
    """Process-group name → mesh axis name of a ``DeviceMesh``."""
    return {mesh.get_group(name).group_name: name
            for name in mesh.mesh_dim_names}
