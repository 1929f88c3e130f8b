"""Design cache — LRU of ``PreparedDesign`` handles for repeated-X traffic.

Counterpart of ``repro.serve.cache``.  Serving workloads are dominated
by repeated design matrices (the same feature matrix queried with many
targets: probes, ablations, per-user heads), so everything about a solve
that depends only on ``x`` lives on one ``repro_torch.core.PreparedDesign``
per design, cached across requests and keyed by the design fingerprint:
the padded device copy of ``x``, the column norms and their per-``thr``
layouts, the kernels' transposed and bf16 copies, the block-Gram Cholesky
factors, the sharded copies a mesh placement reads, and each tenant's
last solved coefficients (warm starts), LRU-bounded.

Entries are LRU-evicted so memory is bounded by ``max_entries`` designs.
The cache-level lock only covers the LRU map; the per-design state has the
handle's own lock.  A handle is built, and its method state warmed, on the
thread that calls ``get_or_build`` (the engine's flush thread); the handle
settles every tensor it caches before returning it (see
``repro_torch.core.prepare``), so the lanes' streams read it whole.

With a ``repro_torch.store.DesignStore`` attached (``store=``), the cache
is a view over the store's device tier: eviction becomes demotion (device
→ host → disk, warm-start state kept), a lookup that misses the device
tier tries a promotion before rebuilding from source, and designs too
large for the device budget come back as non-resident streaming handles
served by the ``bakp_stream`` method.  Without a store the behaviour is
the plain LRU's.
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
                 device=None, store=None):
        self.max_entries = max_entries
        self.max_tenants = max_tenants
        self.device = device
        self.store = store  # Optional[repro_torch.store.DesignStore]
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
        if self.store is not None:
            return len(self.store)  # device-tier resident count
        return len(self._entries)

    def _record_lookup(self, hit: bool, record_stats: bool) -> None:
        if not record_stats:
            return
        with self._lock:
            if hit:
                self.stats.hits += 1
                self._m_hits.inc()
            else:
                self.stats.misses += 1
                self._m_misses.inc()

    def _sync_evictions(self, demotions_before: int) -> None:
        """Mirror store demotions into the eviction counters, so
        ``serve_cache_evictions_total`` keeps reading the device tier's
        turnover."""
        delta = self.store.stats.demotions_device - demotions_before
        if delta > 0:
            with self._lock:
                self.stats.evictions += delta
                self._m_evictions.inc(delta)
        self._m_resident.set(len(self.store))

    def get(self, key: str,
            record_stats: bool = True) -> Optional[PreparedDesign]:
        """Fetch (and LRU-touch) an entry.  ``record_stats=False`` makes the
        lookup invisible to hit/miss accounting (the dispatcher's pre-warm
        uses it, so each request logs one cache event, at flush time).
        Store-backed: the device-resident entry or the non-resident
        streaming handle; never promotes (``get_or_build`` does)."""
        if self.store is not None:
            entry = self.store.get(key)
            self._record_lookup(entry is not None, record_stats)
            return entry
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
        if self.store is not None:
            before = self.store.stats.demotions_device
            out = self.store.admit(key, entry)
            self._sync_evictions(before)
            return out
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
                     record_stats: bool = True,
                     placement=None, mesh=None
                     ) -> Tuple[PreparedDesign, bool]:
        """Fetch the ``PreparedDesign`` for ``key``, preparing it on miss.

        ``build_x_pad`` is a zero-arg callable returning the bucket-padded
        design matrix (an array, or a tensor already on the device) — only
        invoked on a miss, so hits skip the padding and the copy to the
        device entirely.  ``spec`` (optional)
        additionally warms the method's derived state (thr-padded norms,
        block-Gram Cholesky, the kernels' transposed / bf16 copies) on hit
        AND miss (``PreparedDesign.warm_lane_state``).  ``placement`` /
        ``mesh`` extend the warm to the placement's sharded copy on the
        mesh and bind the entry's home placement (first wins).  Returns
        (entry, cache_hit).

        Store-backed: a device-tier miss first tries ``store.promote`` —
        a design climbing back from its host or disk record (warm
        coefficients and Cholesky factors restored) counts as a hit, since
        ``build_x_pad`` never runs.  Only a design no tier holds is built
        from source (``store.build``: resident, or non-resident when over
        the device budget).
        """
        if self.store is not None:
            entry = self.store.get(key)
            hit = entry is not None
            if not hit:
                before = self.store.stats.demotions_device
                promoted = self.store.promote(key)
                if promoted is not None:
                    entry, hit = promoted, True
                self._sync_evictions(before)
            self._record_lookup(hit, record_stats)
            if not hit:
                before = self.store.stats.demotions_device
                entry = self.store.build(key, build_x_pad(),
                                         max_tenants=self.max_tenants)
                self._sync_evictions(before)
        else:
            entry = self.get(key, record_stats)
            hit = entry is not None
            if not hit:
                built = prepare(build_x_pad(), device=self.device,
                                fingerprint=key,
                                max_tenants=self.max_tenants)
                entry = self.put(key, built)
        if spec is not None:
            entry.warm_lane_state(spec, placement=placement, mesh=mesh)
        else:
            entry.bind_home(placement)
            if (placement is not None and placement.sharded
                    and mesh is not None and entry.x_pad is not None):
                entry.x_for_placement(placement, mesh)
        if self.store is not None:
            self.store.refresh_gauges()
        return entry, hit
