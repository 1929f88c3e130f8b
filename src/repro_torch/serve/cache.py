"""Design cache — LRU of ``PreparedDesign`` handles for repeated-X traffic.

Counterpart of ``repro.serve.cache`` without the tiered store (a later
slice of the port).  Serving workloads are dominated by repeated design
matrices (the same feature matrix queried with many targets: probes,
ablations, per-user heads), so everything about a solve that depends only
on ``x`` lives on one ``repro_torch.core.PreparedDesign`` per design,
cached across requests and keyed by the design fingerprint: the padded
device copy of ``x``, the column norms and their per-``thr`` layouts, the
kernels' transposed and bf16 copies, the block-Gram Cholesky factors, and
each tenant's last solved coefficients (warm starts), LRU-bounded.

Entries are LRU-evicted so memory is bounded by ``max_entries`` designs.
The cache-level lock only covers the LRU map; the per-design state has the
handle's own lock.  A handle is built, and its method state warmed, on the
thread that calls ``get_or_build`` (the engine's flush thread); the handle
settles every tensor it caches before returning it (see
``repro_torch.core.prepare``), so the lanes' streams read it whole.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch import obs
from repro_torch.core.prepare import PreparedDesign, prepare
from repro_torch.core.spec import SolverSpec

# The JAX package's name for a cache entry: the handle itself.
DesignEntry = PreparedDesign


@dataclass
class CacheStats:
    """Per-cache counters (convenience mirror of the ``serve_cache_*``
    families this cache records into its registry)."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate}


class DesignCache:
    """LRU cache: design key → ``PreparedDesign`` on ``device``.

    Thread-safe: the LRU bookkeeping is guarded by a lock.  Entry
    *construction* runs outside the lock; on a build race the first
    ``put`` wins and the loser's entry is dropped.
    """

    def __init__(self, max_entries: int = 64, max_tenants: int = 64,
                 registry: Optional[obs.MetricsRegistry] = None,
                 device=None):
        self.max_entries = max_entries
        self.max_tenants = max_tenants
        self.device = device
        self.stats = CacheStats()
        reg = registry or obs.default_registry()
        self._m_hits = reg.counter(
            "serve_cache_hits_total", "design-cache lookups served resident")
        self._m_misses = reg.counter(
            "serve_cache_misses_total", "design-cache lookups that built")
        self._m_evictions = reg.counter(
            "serve_cache_evictions_total", "designs LRU-evicted")
        self._m_resident = reg.gauge(
            "serve_cache_entries", "designs currently resident")
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, PreparedDesign]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str,
            record_stats: bool = True) -> Optional[PreparedDesign]:
        """Fetch (and LRU-touch) an entry.  ``record_stats=False`` makes the
        lookup invisible to hit/miss accounting."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                if record_stats:
                    self.stats.misses += 1
                    self._m_misses.inc()
                return None
            self._entries.move_to_end(key)
            if record_stats:
                self.stats.hits += 1
                self._m_hits.inc()
            return entry

    def put(self, key: str, entry: PreparedDesign) -> PreparedDesign:
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:  # build race: first writer wins
                self._entries.move_to_end(key)
                return existing
            self._entries[key] = entry
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
                self._m_evictions.inc()
            self._m_resident.set(len(self._entries))
            return entry

    def get_or_build(self, key: str, build_x_pad,
                     spec: Optional[SolverSpec] = None,
                     record_stats: bool = True
                     ) -> Tuple[PreparedDesign, bool]:
        """Fetch the ``PreparedDesign`` for ``key``, preparing it on miss.

        ``build_x_pad`` is a zero-arg callable returning the bucket-padded
        design matrix (an array, or a tensor already on the device) — only
        invoked on a miss, so hits skip the padding and the copy to the
        device entirely.  ``spec`` (optional)
        additionally warms the method's derived state (thr-padded norms,
        block-Gram Cholesky, the kernels' transposed / bf16 copies) on hit
        AND miss, and binds the entry's home placement ("single";
        ``PreparedDesign.warm_lane_state``).  Returns (entry, cache_hit).
        """
        entry = self.get(key, record_stats)
        hit = entry is not None
        if not hit:
            built = prepare(build_x_pad(), device=self.device,
                            fingerprint=key,
                            max_tenants=self.max_tenants)
            entry = self.put(key, built)
        if spec is not None:
            entry.warm_lane_state(spec)
        else:
            entry.bind_home()
        return entry, hit
