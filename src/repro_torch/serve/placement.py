"""Placement layer — routing serving buckets onto mesh-sharded solvers.

Counterpart of ``repro.serve.placement``.  A ``Placement`` names which
backend a bucket's solves run on, a ``PlacementPolicy`` picks one per
bucket from its padded size, and a ``ServeMesh`` wraps the device mesh
(``repro_torch.launch.mesh.Mesh``) the sharded placements run over.
Placement is part of the engine's grouping key, so single-device and
sharded solves never mix inside a batch.

Placements (backends in ``repro_torch.core.distributed``):

  * ``single``       — the single-device solver family (default; the only
                       placement when the engine has no mesh).
  * ``obs_sharded``  — ``solvebakp_obs_sharded``: design rows shard over the
                       mesh data axes, for buckets whose padded
                       ``obs_p × vars_p`` cell count reaches
                       ``obs_shard_min_cells``.
  * ``rhs_sharded``  — ``solvebakp_rhs_sharded``: a large same-design
                       multi-RHS group's ``k`` axis shards over the data
                       devices, ``x`` replicated; chosen per *group* (k is
                       known after design coalescing) when
                       ``k_pad >= rhs_shard_min_k``.
  * ``mesh_2d``      — ``solvebakp_2d``: rows over data axes and columns
                       over the model axis.  Off by default
                       (``mesh_2d_min_cells=None``): its cross-shard Jacobi
                       block changes the iterates (needs ω damping).

Sharded placements apply only to methods registered ``shardable`` ("bakp",
"bakp_gram") and only when the padded bucket divides the mesh axes;
everything else stays ``single``.  The rules are the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

import repro_torch.core.methods  # noqa: F401  (populates the registry)
from repro_torch import obs
from repro_torch.core.spec import is_registered, solver_method

_m_decisions = obs.default_registry().counter(
    "serve_placement_decisions_total",
    "placement routing decisions, by level and chosen kind")


def _is_shardable(method: str) -> bool:
    """Placement-eligible iff the registry entry says ``shardable``."""
    return is_registered(method) and solver_method(method).shardable


@dataclass(frozen=True)
class Placement:
    """Where a bucket's solves run.  Frozen/hashable: part of group keys."""

    kind: str = "single"  # single | obs_sharded | rhs_sharded | mesh_2d

    @property
    def sharded(self) -> bool:
        return self.kind != "single"

    def lane_key(self, method: str) -> str:
        """Stable execution-lane identity for this placement + method:
        ``"single:<MethodEntry.lane>"`` ("xla" for the plain torch family,
        "fused" for the whole-solve kernels, "stream" for the streaming
        one), or ``"mesh:<kind>"`` for a sharded placement."""
        if self.sharded:
            return f"mesh:{self.kind}"
        lane = solver_method(method).lane if is_registered(method) else "xla"
        return f"single:{lane}"


SINGLE = Placement("single")
OBS_SHARDED = Placement("obs_sharded")
RHS_SHARDED = Placement("rhs_sharded")
MESH_2D = Placement("mesh_2d")


@dataclass(frozen=True)
class PlacementPolicy:
    """Size thresholds mapping buckets/groups onto placements.

    Attributes:
      obs_shard_min_cells: padded ``obs_p * vars_p`` at or above which a
        bucket's solves route to the obs-sharded backend (default 2²¹ cells
        = 8 MiB of fp32).
      rhs_shard_min_k: padded RHS count at or above which a same-design
        multi-RHS group in a ``single`` bucket upgrades to the k-sharded
        backend (``k_pad`` must divide by the data axes product).
      mesh_2d_min_cells: cell count at or above which a bucket routes to
        the 2-D backend instead (needs a model axis); None disables it.
    """

    obs_shard_min_cells: int = 1 << 21
    rhs_shard_min_k: int = 32
    mesh_2d_min_cells: Optional[int] = None


@dataclass(frozen=True)
class ServeMesh:
    """The engine's device mesh + the axis names the backends shard over."""

    mesh: object                       # repro_torch.launch.mesh.Mesh
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = None

    @property
    def data_size(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.data_axes]))

    @property
    def model_size(self) -> int:
        return int(self.mesh.shape[self.model_axis]) if self.model_axis else 1

    def describe(self) -> str:
        axes = ", ".join(f"{a}={self.mesh.shape[a]}"
                         for a in self.mesh.axis_names)
        return f"ServeMesh({axes})"


def mesh_device_count(spec: str) -> int:
    """Devices a ``"D"``/``"DxM"`` spec needs."""
    return int(np.prod([int(p) for p in spec.lower().split("x")]))


def build_serve_mesh(spec: str, devices: Optional[Sequence] = None, *,
                     device=None) -> ServeMesh:
    """Build a ``ServeMesh`` from a ``"D"`` or ``"DxM"`` spec string.

    ``"8"`` → a 1-D (data=8) mesh; ``"4x2"`` → (data=4, model=2).  By
    default the shards are distinct cards ``cuda:0..n-1`` (``ValueError``
    naming both counts when the process sees fewer).  ``devices`` lists
    the shards' devices in mesh order and may repeat one (virtual shards,
    e.g. ``[cuda:0] * 4``); ``device="cpu"`` puts every shard on the CPU,
    as the JAX package forces virtual host devices there.
    """
    from repro_torch.launch.mesh import make_mesh

    parts = [int(p) for p in spec.lower().split("x")]
    if not parts or any(p < 1 for p in parts) or len(parts) > 2:
        raise ValueError(f"mesh spec must be 'D' or 'DxM', got {spec!r}")
    n = int(np.prod(parts))
    if devices is None and device is not None:
        import torch

        if torch.device(device).type == "cpu":
            devices = ["cpu"] * n
    if len(parts) == 1 or parts[1] == 1:
        mesh = make_mesh((parts[0],), ("data",), devices)
        return ServeMesh(mesh=mesh, data_axes=("data",), model_axis=None)
    mesh = make_mesh(tuple(parts), ("data", "model"), devices)
    return ServeMesh(mesh=mesh, data_axes=("data",), model_axis="model")


def placement_for_bucket(bucket: Tuple[int, int], method: str,
                         policy: PlacementPolicy,
                         smesh: Optional[ServeMesh]) -> Placement:
    """Bucket-level placement (known before design coalescing)."""
    chosen = SINGLE
    if smesh is not None and _is_shardable(method):
        obs_p, vars_p = bucket
        cells = obs_p * vars_p
        if (policy.mesh_2d_min_cells is not None
                and cells >= policy.mesh_2d_min_cells
                and smesh.model_size > 1
                and obs_p % smesh.data_size == 0
                and vars_p % smesh.model_size == 0):
            chosen = MESH_2D
        elif (cells >= policy.obs_shard_min_cells
                and obs_p % smesh.data_size == 0):
            chosen = OBS_SHARDED
    _m_decisions.inc(1, level="bucket", kind=chosen.kind)
    return chosen


def placement_for_group(base: Placement, k_pad: int,
                        policy: PlacementPolicy,
                        smesh: Optional[ServeMesh]) -> Placement:
    """Group-level upgrade: a large-k same-design group in a single-device
    bucket shards its RHS axis instead (obs- and 2-D-sharded buckets
    already span the mesh, so they keep their bucket placement)."""
    if (smesh is not None and base.kind == "single"
            and k_pad >= policy.rhs_shard_min_k
            and k_pad % smesh.data_size == 0):
        _m_decisions.inc(1, level="group", kind=RHS_SHARDED.kind)
        return RHS_SHARDED
    return base
