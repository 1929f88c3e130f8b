"""repro_torch.store — the tiered (device / host / disk) design store.

Counterpart of ``repro.store``: ``DesignStore`` makes device memory the
hot tier of a three-tier store.  LRU demotion replaces eviction (device →
pinned host record → CRC-checked disk tiles), promotion restores every
piece of snapshotted state (norms, Cholesky factors, per-tenant warm-start
coefficients), and designs too large for the device budget are served
through a non-resident handle (``StoreBlockSource`` + the ``bakp_stream``
method's host-block loop).  See ``repro_torch.store.store``.
"""
from repro_torch.store.store import (DesignStore, DiskDesign, HostDesign,
                                     StoreBlockSource, StoreStats,
                                     TileCorruptionError)

__all__ = [
    "DesignStore",
    "DiskDesign",
    "HostDesign",
    "StoreBlockSource",
    "StoreStats",
    "TileCorruptionError",
]
