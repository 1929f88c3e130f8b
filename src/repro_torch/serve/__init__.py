"""repro_torch.serve — the batched multi-tenant solver-serving engine.

Counterpart of ``repro.serve`` (synchronous path): requests are bucketed
by padded power-of-two shape, same-design requests coalesce into one
multi-RHS solve (one pass over ``x`` serves every tenant that shares it;
on the whole-solve CUDA kernel, one launch), remaining same-bucket
requests of a batchable method are solved as one batch across designs,
per-design state lives on ``PreparedDesign`` handles in an LRU cache, and
the solves run on execution lanes — a thread and a CUDA stream per kernel
path.  Every entry point runs on the GPU unless the caller passes
``device="cpu"``.

Layout:
  types.py     SolveRequest / ServedSolve records.
  batching.py  pow-2 shape buckets, exact zero padding, design
               fingerprints, deterministic request grouping.
  cache.py     LRU DesignCache of PreparedDesign handles.
  placement.py Placement / PlacementPolicy, single-device (mesh
               placements raise until the multi-GPU slice).
  lanes.py     execution lanes — one executor thread and CUDA stream per
               (device, kernel path), supervised, with a circuit breaker
               onto a serial fallback lane.
  engine.py    SolverServeEngine — submit / serve / flush.

Later slices: the tiered design store (``ServeConfig.store_*`` raises),
the async dispatcher, mesh placements.
"""
from repro_torch.core.prepare import PreparedDesign
from repro_torch.core.spec import SolverSpec, UnsupportedSpecError
from repro_torch.obs import SolveTelemetry
from repro_torch.serve.batching import (bucket_shape, design_fingerprint,
                                        group_requests, next_pow2, pad_x,
                                        pad_y, prepare_request)
from repro_torch.serve.cache import CacheStats, DesignCache, DesignEntry
from repro_torch.serve.engine import ServeConfig, ServeStats, SolverServeEngine
from repro_torch.serve.lanes import (LaneExecutor, LaneKey, LanePool,
                                     LaneShutdown, LaneStats, LaneWork,
                                     LaneWorkerDeath, current_lane, lane_for)
from repro_torch.serve.placement import (Placement, PlacementPolicy,
                                         ServeMesh, build_serve_mesh,
                                         placement_for_bucket,
                                         placement_for_group)
from repro_torch.serve.types import ServedSolve, SolveRequest

__all__ = [
    "CacheStats",
    "DesignCache",
    "DesignEntry",
    "LaneExecutor",
    "LaneKey",
    "LanePool",
    "LaneShutdown",
    "LaneStats",
    "LaneWork",
    "LaneWorkerDeath",
    "Placement",
    "PlacementPolicy",
    "PreparedDesign",
    "ServeConfig",
    "ServeMesh",
    "ServeStats",
    "ServedSolve",
    "SolveRequest",
    "SolveTelemetry",
    "SolverServeEngine",
    "SolverSpec",
    "UnsupportedSpecError",
    "bucket_shape",
    "build_serve_mesh",
    "current_lane",
    "design_fingerprint",
    "group_requests",
    "lane_for",
    "next_pow2",
    "pad_x",
    "pad_y",
    "placement_for_bucket",
    "placement_for_group",
    "prepare_request",
]
