"""Device meshes of the PyTorch port.

Counterpart of ``repro.launch.mesh``.  A ``Mesh`` is a grid of
``torch.device``s with axis names, as ``jax.sharding.Mesh`` is a grid of
jax devices: the sharded solvers (``repro_torch.core.distributed``) and the
serving engine's mesh placements lay a design out over it.  One process
drives the whole mesh (the single-controller shape of ``shard_map``); the
collectives are written out in ``core.distributed``.

A mesh may repeat a device: four shards on ``cuda:0`` (or eight on the
CPU) are *virtual shards*, which run the sharded arithmetic and routing on
one card, as the JAX tests force virtual host devices on the CPU.  A
repeat is only ever asked for: ``devices=None`` takes distinct cards
``cuda:0..n-1`` and raises when the process sees fewer.

``make_production_mesh`` waits for ``launch/solver_dryrun.py``, its only
caller.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _as_device(d) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index is the
    process's current card."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices.

    ``devices`` is a numpy object array of ``torch.device`` whose shape is
    the axis sizes, in ``axis_names`` order.  Hashable by identity (a mesh
    keys lanes through ``device_ids``, not through itself).
    """

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """Axis name → size, in axis order (``jax.sharding.Mesh.shape``)."""
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def device_ids(self) -> Tuple[str, ...]:
        """Every shard's device name in mesh order: a mesh lane's device
        identity (``repro_torch.serve.lanes.LaneKey.devices``)."""
        return tuple(str(d) for d in self.devices.flat)

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in first-use order."""
        return tuple(dict.fromkeys(self.devices.flat))

    def device_at(self, index: dict) -> torch.device:
        """The device at ``{axis: position}``; axes left out are at 0."""
        return self.devices[tuple(int(index.get(a, 0))
                                  for a in self.axis_names)]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``Mesh`` of ``shape`` with axis names ``axes``.

    ``devices=None`` takes distinct cards ``cuda:0..n-1`` and raises
    ``ValueError`` naming both counts when the process sees fewer than
    ``n = prod(shape)``.  An explicit ``devices`` list (length ``n``, mesh
    order) may repeat a device: virtual shards, e.g. ``["cpu"] * 8`` or
    ``[cuda:0] * 4``.
    """
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")
    n = int(np.prod(shape))
    if devices is None:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if seen < n:
            raise ValueError(
                f"a mesh of shape {shape} needs {n} CUDA devices and this "
                f"process sees {seen}; pass devices= (a device may repeat: "
                f"virtual shards) to build it on fewer")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [_as_device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a mesh of shape {shape} needs {n} devices, "
                             f"got {len(devs)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    return Mesh(devices=grid.reshape(shape), axis_names=axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    devices: Optional[Sequence] = None) -> Mesh:
    """Small mesh for tests (``make_mesh`` with JAX's defaults)."""
    return make_mesh(shape, axes, devices)
