"""Placement layer — where a serving bucket's solves run.

Counterpart of ``repro.serve.placement``, single-device only: the port has
one placement, ``single`` (the current device), until its multi-GPU slice
brings the sharded backends (``obs_sharded``, ``rhs_sharded``,
``mesh_2d``).  ``Placement`` and ``PlacementPolicy`` keep the JAX
package's fields, so a placement means the same thing in both packages and
``Placement.lane_key`` names the same lanes; asking for a mesh
(``ServeMesh``, ``build_serve_mesh``, or the placement functions with a
mesh) raises ``UnsupportedSpecError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import repro_torch.core.methods  # noqa: F401  (populates the registry)
from repro_torch import obs
from repro_torch.core.spec import UnsupportedSpecError, solver_method

_m_decisions = obs.default_registry().counter(
    "serve_placement_decisions_total",
    "placement routing decisions, by level and chosen kind")

_MESH_SLICE = ("sharded placements need a device mesh, which arrives with "
               "the PyTorch port's multi-GPU slice; the port serves on one "
               "device")


def _registered(method: str) -> bool:
    try:
        solver_method(method)
    except ValueError:
        return False
    return True


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
        lane = solver_method(method).lane if _registered(method) else "xla"
        return f"single:{lane}"


SINGLE = Placement("single")


@dataclass(frozen=True)
class PlacementPolicy:
    """Size thresholds mapping buckets/groups onto sharded placements (the
    JAX package's fields; without a mesh no threshold applies)."""

    obs_shard_min_cells: int = 1 << 21
    rhs_shard_min_k: int = 32
    mesh_2d_min_cells: Optional[int] = None


class ServeMesh:
    """A device mesh for sharded serving: not available in the port yet."""

    def __init__(self, *args, **kwargs):
        raise UnsupportedSpecError(_MESH_SLICE)


def build_serve_mesh(spec: str) -> ServeMesh:
    """Raises: meshes arrive with the multi-GPU slice."""
    raise UnsupportedSpecError(f"mesh {spec!r}: {_MESH_SLICE}")


def placement_for_bucket(bucket: Tuple[int, int], method: str,
                         policy: PlacementPolicy,
                         smesh=None) -> Placement:
    """Bucket-level placement: ``single``; a mesh raises."""
    if smesh is not None:
        raise UnsupportedSpecError(_MESH_SLICE)
    _m_decisions.inc(1, level="bucket", kind=SINGLE.kind)
    return SINGLE


def placement_for_group(base: Placement, k_pad: int,
                        policy: PlacementPolicy, smesh=None) -> Placement:
    """Group-level placement: ``base``; a mesh raises."""
    if smesh is not None:
        raise UnsupportedSpecError(_MESH_SLICE)
    return base
