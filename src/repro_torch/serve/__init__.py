"""repro_torch.serve — the batched multi-tenant solver-serving engine.

Counterpart of ``repro.serve``: requests are bucketed
by padded power-of-two shape, same-design requests coalesce into one
multi-RHS solve (one pass over ``x`` serves every tenant that shares it;
on the whole-solve CUDA kernel, one launch), remaining same-bucket
requests of a batchable method are solved as one batch across designs,
per-design state lives on ``PreparedDesign`` handles in an LRU cache (a
view over the tiered ``repro_torch.store.DesignStore`` when
``ServeConfig.store_*`` is set), the solves run on execution lanes — a
thread and a CUDA stream per kernel path — an engine built with a device
mesh routes big buckets and large same-design groups onto the
mesh-sharded solvers (placements, each on a mesh lane), and
``AsyncDispatcher`` puts a deadline-aware async front end over the
engine.  Every entry point runs on the GPU unless the caller passes
``device="cpu"``.

Layout:
  types.py     SolveRequest / ServedSolve records.
  batching.py  pow-2 shape buckets, exact zero padding, design
               fingerprints, deterministic request grouping.
  cache.py     LRU DesignCache of PreparedDesign handles, or a view over
               a DesignStore's device tier.
  placement.py Placement / PlacementPolicy / ServeMesh — where a bucket
               solves: single-device, obs-, rhs-sharded or 2-D on a mesh.
  lanes.py     execution lanes — one executor thread and CUDA stream per
               (device, kernel path), a stream a distinct card for a mesh
               lane, supervised, with a circuit breaker onto a serial
               fallback lane.
  engine.py    SolverServeEngine — submit / serve / flush.
  dispatch.py  AsyncDispatcher — intake queue, dispatch thread (on a CUDA
               stream of its own), flush policy (full / deadline margin /
               idle), backpressure, cancel, drain.
"""
from repro_torch.core.prepare import PreparedDesign
from repro_torch.core.spec import SolverSpec, UnsupportedSpecError
from repro_torch.obs import SolveTelemetry
from repro_torch.serve.batching import (bucket_shape, design_fingerprint,
                                        group_requests, next_pow2, pad_x,
                                        pad_y, prepare_request)
from repro_torch.serve.cache import CacheStats, DesignCache, DesignEntry
from repro_torch.serve.dispatch import (AsyncDispatcher, DispatchConfig,
                                        DispatcherStopped, DispatchStats,
                                        QueueFullError, SolveTicket,
                                        TicketCancelled)
from repro_torch.serve.engine import ServeConfig, ServeStats, SolverServeEngine
from repro_torch.serve.lanes import (LaneExecutor, LaneKey, LanePool,
                                     LaneShutdown, LaneStats, LaneWork,
                                     LaneWorkerDeath, current_lane, lane_for)
from repro_torch.serve.placement import (Placement, PlacementPolicy,
                                         ServeMesh, build_serve_mesh,
                                         mesh_device_count,
                                         placement_for_bucket,
                                         placement_for_group)
from repro_torch.serve.types import ServedSolve, SolveRequest
from repro_torch.store import DesignStore, StoreStats

__all__ = [
    "AsyncDispatcher",
    "CacheStats",
    "DesignCache",
    "DesignEntry",
    "DesignStore",
    "DispatchConfig",
    "DispatchStats",
    "DispatcherStopped",
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
    "QueueFullError",
    "ServeConfig",
    "ServeMesh",
    "ServeStats",
    "ServedSolve",
    "SolveRequest",
    "SolveTelemetry",
    "SolveTicket",
    "SolverServeEngine",
    "SolverSpec",
    "StoreStats",
    "TicketCancelled",
    "UnsupportedSpecError",
    "bucket_shape",
    "build_serve_mesh",
    "current_lane",
    "design_fingerprint",
    "group_requests",
    "lane_for",
    "mesh_device_count",
    "next_pow2",
    "pad_x",
    "pad_y",
    "placement_for_bucket",
    "placement_for_group",
    "prepare_request",
]
