"""Logical-axis → mesh-axis rules (MaxText-style, compact).

The port of the JAX package's ``distributed/sharding.py``: one rule table
per mesh flavour.  ``pod`` composes with ``data`` for all batch-like and
FSDP sharding, so the same model code runs on the single-pod (16, 16) and
multi-pod (2, 16, 16) meshes.

A ``PartitionSpec`` is JAX's: one entry per tensor dim, each None
(replicated), a mesh axis name, or a tuple of them (the first the major).
``placements`` turns one into DTensor placements, one per mesh dim
(``Shard(d)`` where that mesh axis splits dim d, else ``Replicate()``),
and ``shard_shape`` gives a device's block of a global shape, as JAX's
``NamedSharding.shard_shape`` does.  The functions read only
``mesh.axis_names`` and ``mesh.shape``, so they take the port's ``Mesh``
(``repro_torch.launch.mesh``) and a ``DeviceMesh`` (through ``mesh_axes``)
alike.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: a tuple of per-dim axes."""

    def __new__(cls, *axes: Axis):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> "OrderedDict[str, int]":
    """Axis name → size, in axis order, of a port ``Mesh`` or a torch
    ``DeviceMesh`` (whose ``mesh_dim_names`` name its dims)."""
    names = getattr(mesh, "axis_names", None)
    if names is not None:
        return OrderedDict(mesh.shape)
    return OrderedDict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def make_rules(mesh, *, fsdp: bool = True,
               serve: bool = False) -> Dict[str, Axis]:
    """Rules keyed by logical axis name.

    data-like axes map to every non-model mesh axis (so the "pod" axis of
    the multi-pod mesh shards batch/FSDP too).

    ``serve=True`` switches to weight-stationary sharding: no FSDP (weights
    are never re-gathered per step), and MoE expert weights shard 2-D
    (experts → model, ff → data axes) so giant expert tables still fully
    shard without per-step gathers.
    """
    daxes = data_axes(mesh)
    return {
        # activations
        "batch": daxes,
        "seq": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "act_experts": "model",
        # weights
        "embed": None if serve else (daxes if fsdp else None),
        "model": "model",                        # TP dim (heads, mlp, vocab)
        "experts": "model",                      # expert parallelism
        "moe_ff": daxes if serve else None,      # 2-D EP for serving
        "layers": None,
        "units": None,
        "none": None,
    }


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a != "model")


def axis_size(mesh, axes: Axis) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def divisible_spec(mesh, shape, axes_per_dim) -> PartitionSpec:
    """P(...) where any dim whose size does not divide its mapped mesh axes
    falls back to replicated (e.g. batch=1 decode cells)."""
    spec = []
    for dim, ax in zip(shape, axes_per_dim):
        if ax is None or dim % axis_size(mesh, ax):
            spec.append(None)
        else:
            spec.append(ax)
    return PartitionSpec(*spec)


def batch_spec(mesh, ndim: int) -> PartitionSpec:
    """P over batch dim 0, replicated elsewhere."""
    return PartitionSpec(data_axes(mesh), *([None] * (ndim - 1)))


class NamedSharding:
    """``jax.sharding.NamedSharding``: a spec on a mesh."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return shard_shape(self.mesh, shape, self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({dict(mesh_axes(self.mesh))}, {self.spec})"


def abstract_tensor(shape, dtype, mesh=None, spec=None):
    """A stand-in that allocates nothing: a ``meta`` tensor of ``shape``,
    or, on a ``DeviceMesh``, a ``DTensor`` of that global shape whose local
    shard is a ``meta`` tensor of the per-device shape under ``spec``."""
    import torch

    shape = tuple(int(n) for n in shape)
    if mesh is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    from torch.distributed.tensor import DTensor

    spec = PartitionSpec(*spec) if spec is not None else PartitionSpec()
    local = torch.empty(shard_shape(mesh, shape, spec), dtype=dtype,
                        device="meta")
    glob = torch.empty(shape, dtype=dtype, device="meta")
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=glob.shape,
                              stride=glob.stride())


def _dim_axes(ax: Axis) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def placements(mesh, spec):
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where the spec maps that axis to tensor dim d, else
    ``Replicate()``.  Several axes on one dim split it major-first in mesh
    order, which is DTensor's order; a spec that lists them in another
    order, or names an axis twice, raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        axes = _dim_axes(ax)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: dim {d} lists mesh axes {axes} "
                             f"out of mesh order {tuple(names)}")
        for i in pos:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {names[i]!r} "
                                 f"twice")
            out[i] = Shard(d)
    return tuple(out)


def spec_of(t) -> PartitionSpec:
    """The ``PartitionSpec`` of a DTensor's placements (the inverse of
    ``placements``; a plain tensor's is all None)."""
    from torch.distributed.tensor import DTensor, Shard

    per_dim = [[] for _ in range(t.dim())]
    if isinstance(t, DTensor):
        for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
            if isinstance(p, Shard):
                per_dim[p.dim].append(name)
    return PartitionSpec(*(None if not a else a[0] if len(a) == 1
                           else tuple(a) for a in per_dim))


def shard_shape(mesh, shape, spec) -> Tuple[int, ...]:
    """A device's block of ``shape`` under ``spec`` (the first device's
    where a dim does not divide: ceil, as DTensor's chunks)."""
    return tuple(-(-dim // axis_size(mesh, ax)) if ax is not None else dim
                 for dim, ax in zip(shape, tuple(spec) + (None,) *
                                    (len(shape) - len(spec))))
