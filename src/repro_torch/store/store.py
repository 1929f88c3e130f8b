"""DesignStore — the tiered (device / host / disk) design residency store.

Counterpart of ``repro.store.store``.  A solve's working set is one column
block plus the small accumulators (the paper: "for each iteration, only
one dimension of the given input matrix X is utilized"), so device memory
is the *hot tier* of a three-tier store and the number of designs a server
holds is bounded by disk, not by the card's memory.

Tiers, hottest first:

  * **device** — a ``PreparedDesign`` with ``x_pad`` (and its lazily built
    ``x_t_for`` / ``x_bf16_for`` copies and mesh-sharded copies,
    ``x_for_placement``) on the card.  Bounded by
    ``device_bytes`` (storage bytes, ``_entry_device_bytes``) and
    ``max_entries``.
  * **host** — a ``HostDesign`` record in host memory: the per-thr
    transposed fp32 / bf16 layouts (or ``x_pad`` when none was built),
    pinned when the store's device is a GPU, plus the small derived state
    — column norms, block-Gram Cholesky factors, the lane home — and the
    per-tenant warm-coefficient LRU, so a returning tenant still
    warm-starts after its design was demoted.  Bounded by ``host_bytes``
    (the bytes of its x layouts).
  * **disk** — one ``(thr, obs)`` fp32 tile file a column block of the
    transposed layout under ``<disk_dir>/<fingerprint>/``, memmapped on
    read; the small state stays in memory on the ``DiskDesign`` record.
    Unbounded.

Transitions are demotions, not deletions: the device tier over budget
demotes its LRU entry to host; the host tier over budget demotes to disk
(or, with no ``disk_dir``, drops only the x bytes and keeps a state-only
record, so warm coefficients and Cholesky factors survive a rebuild).
``promote`` climbs back up, restoring every snapshotted piece of state
onto a fresh ``PreparedDesign``; a disk promotion deletes its tile files.
The serving cache's ``get_or_build`` promotes, and the async dispatcher's
pre-warm calls it on the dispatch thread, so a cold-tier design climbs
while its request waits in the intake queue.

Designs whose padded x exceeds ``device_bytes`` outright never become
resident: ``build`` keeps their bytes in the host / disk tiers and returns
a non-resident ``PreparedDesign`` (``x_pad=None``) whose ``blocks`` is a
``StoreBlockSource``, the per-block fetch interface of the ``bakp_stream``
method's host-block loop (``repro_torch.kernels.stream_solve``).  A tile
served from the host tier is a view of its pinned record (the tile feed
copies it to the card as it is); a disk tile is a memmap, which the feed
copies into a pinned staging buffer first.

On the card.  Every copy between tiers runs on the calling thread's CUDA
stream (the flush thread's, the dispatch thread's own, or a lane's): a
promotion copies from a pinned host buffer to the device and settles each
rebuilt tensor (``core.prepare._settled``) before the handle is published,
so a lane reading it on another stream sees it whole.  A demotion copies
the layouts to pinned host memory and only drops the store's reference:
the handle keeps its tensors, and a solve in flight holds its handle until
its lane's stream is synchronised (``obs.sync_device`` in the engine), so
the caching allocator cannot hand those bytes to another tensor while a
kernel still reads them.

Metrics: ``store_bytes{tier}`` / ``store_resident{tier}`` gauges,
``store_promotions_total{from,to}`` counting every tier move in both
directions, the ``store_fetch_latency_seconds{tier}`` histogram over
promotions and block fetches, and ``store_tile_corruption_total``.

Concurrency: one store ``RLock`` guards the tier maps; per-design state
has each ``PreparedDesign``'s own lock.  Lock order: the store's lock,
then a handle's; nothing here is called with a handle's lock held, and the
kernels' launch-count and exchange-word locks are leaves under both.  A
warm-coefficient write that lands on a demoted handle after its snapshot
is lost: the best-effort warm contract of the JAX store.

Crash safety: every tile file carries a 16-byte header — magic, CRC32 of
the payload, payload bytes — written through a temp file, ``fsync`` and an
atomic ``os.replace``; the format is byte for byte the JAX store's, so
each store reads the other's tiles.  Reads verify once a tile; promotion
verifies every tile.  A tile that fails raises ``TileCorruptionError`` and
the design is quarantined: its tile directory is renamed aside, the disk
record and any streaming handle are dropped, and a state-only stub keeps
the warm coefficients, Cholesky factors and norms, so the next ``build``
from the request's design restores the tenants' state.

Mesh copies: a resident design's sharded copies (one a placement, on the
mesh's devices) count as device bytes.  A demotion drops them, with the
handle's other device state; a promotion does not rebuild them (the next
warm for the placement does).
"""
from __future__ import annotations

import logging
import os
import shutil
import struct
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.prepare import (PreparedDesign, device_copy,
                                      host_copy, prepare, resolve_device)
from repro_torch.core.types import column_norms_sq_t
from repro_torch.resilience import faults

_log = logging.getLogger(__name__)

#: Tile width used when a design reaches the host or disk tier without any
#: transposed layout built yet (no solve touched it while resident).
DEFAULT_TILE = 128

#: Tile-file header: magic, CRC32 of the payload, payload byte count.
_TILE_MAGIC = b"DTL1"
_TILE_HEADER = struct.Struct("<4sIQ")


class TileCorruptionError(RuntimeError):
    """A disk tile failed its integrity check (bad magic / length / CRC or
    an unreadable file).  Carries the design ``key`` and tile ``path``; the
    store quarantines the whole design before this propagates, so the
    caller's recovery is to rebuild from the design source (the serving
    engine's retry ladder does exactly that)."""

    def __init__(self, key: str, path: Path, detail: str):
        super().__init__(
            f"design {key!r}: corrupt tile {path.name} ({detail})")
        self.key = key
        self.path = path


def _write_tile_atomic(path: Path, tile) -> None:
    """Crash-safe tile write: header + payload into a temp file, flushed
    and ``fsync``ed, then atomically renamed over ``path``.  A reader (or
    a restart) sees the old file, no file, or the whole new file."""
    if isinstance(tile, torch.Tensor):
        tile = tile.numpy()
    payload = np.ascontiguousarray(tile, np.float32).tobytes()
    header = _TILE_HEADER.pack(_TILE_MAGIC, zlib.crc32(payload),
                               len(payload))
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _entry_device_bytes(entry: PreparedDesign) -> int:
    """Device bytes a resident ``PreparedDesign`` holds: the storage of
    ``x_pad``, of every built kernel layout (transposed fp32, bf16) and of
    every sharded copy (on any device of its mesh), each storage counted
    once however many views or shards share it (the replicas of an
    rhs-sharded copy on a virtual mesh).  The small vectors (norms,
    Cholesky factors) are O(vars) and ignored."""
    with entry._lock:
        storages = {}
        for t in (entry.x_pad, *entry._x_t.values(),
                  *entry._x_bf16.values(),
                  *(p for sh in entry._sharded.values() for p in sh.parts)):
            if t is not None:
                s = t.untyped_storage()
                storages[(str(t.device), s.data_ptr())] = s.nbytes()
    return sum(storages.values())


def _pad_rows(x_t: torch.Tensor, thr: int) -> torch.Tensor:
    """Zero rows appended up to a multiple of ``thr``."""
    pad = -(-x_t.shape[0] // thr) * thr - x_t.shape[0]
    return torch.nn.functional.pad(x_t, (0, 0, 0, pad)) if pad else x_t


@dataclass
class HostDesign:
    """Host-memory record of one design (see module doc).

    ``x_t`` / ``x_bf16`` hold the per-thr kernel layouts (vars padded to a
    multiple of thr, obs) as CPU tensors, pinned when the store's device is
    a GPU; ``x_pad`` (obs, vars) is kept only when no transposed layout
    existed, so the design is always rebuilt from exactly one copy.  A
    state-only record (all three empty) survives an x-byte drop and still
    restores warm / Cholesky state on a rebuild.  ``cn``, ``chol`` and
    ``warm`` (least recently used first) are CPU tensors.
    """

    key: str
    shape: Tuple[int, int]                      # (obs_p, vars_p)
    max_tenants: int = 64
    x_pad: Optional[torch.Tensor] = None
    x_t: Dict[int, torch.Tensor] = field(default_factory=dict)
    x_bf16: Dict[int, torch.Tensor] = field(default_factory=dict)
    cn: Optional[torch.Tensor] = None
    chol: Dict[Tuple[int, float], torch.Tensor] = field(default_factory=dict)
    warm: "OrderedDict[str, torch.Tensor]" = field(default_factory=OrderedDict)
    home: Optional[str] = None

    @classmethod
    def from_design(cls, x, *, key: str, pin: bool) -> "HostDesign":
        """A record holding the (obs, vars) design ``x`` (array, or tensor on
        any device) in the transposed layout at tile width
        ``min(DEFAULT_TILE, vars)``, pinned when ``pin``, with its squared
        column norms, computed from the host copy (as the JAX store
        computes them on the host)."""
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.asarray(x, np.float32))
        if x.dim() != 2:
            raise ValueError(f"x must be 2D (obs, vars), got {tuple(x.shape)}")
        obs, nvars = x.shape
        thr = min(DEFAULT_TILE, nvars)
        src = _pad_rows(x.T.float(), thr)
        x_t = torch.empty(tuple(src.shape), dtype=torch.float32,
                          pin_memory=pin)
        x_t.copy_(src)
        cn = column_norms_sq_t(x_t[:nvars])
        return cls(key=key, shape=(obs, nvars), x_t={thr: x_t}, cn=cn)

    @property
    def nbytes(self) -> int:
        total = 0 if self.x_pad is None else self.x_pad.nbytes
        for d in (self.x_t, self.x_bf16):
            for a in d.values():
                total += a.nbytes
        return total

    def has_x(self) -> bool:
        return self.x_pad is not None or bool(self.x_t)

    def drop_x(self) -> None:
        self.x_pad = None
        self.x_t = {}
        self.x_bf16 = {}

    def read_cols(self, lo: int, hi: int) -> torch.Tensor:
        """Columns ``lo:hi`` of the design in the transposed layout,
        (hi-lo, obs) fp32: a view of the record's layout where it holds
        every row (pinned when the record is), else a copy whose rows at
        and above ``vars`` are zero (the thr padding)."""
        obs_p, vars_p = self.shape
        src = next(iter(self.x_t.values())) if self.x_t else None
        if src is not None and hi <= src.shape[0]:
            return src[lo:hi]
        out = torch.zeros((hi - lo, obs_p), dtype=torch.float32)
        real = min(hi, vars_p) - lo
        if real <= 0:
            return out
        if src is not None:
            stop = min(hi, src.shape[0])
            out[: stop - lo] = src[lo:stop]
        elif self.x_pad is not None:
            out[:real] = self.x_pad[:, lo:lo + real].T
        else:
            raise RuntimeError(
                f"design {self.key!r}: X bytes were dropped (host budget "
                f"exceeded with no disk tier configured); only warm/derived "
                f"state survives — configure DesignStore(disk_dir=...)")
        return out


@dataclass
class DiskDesign:
    """Disk-tier record: per-block tile files plus the small state that
    stays in memory (norms, Cholesky factors, warm coefficients)."""

    key: str
    shape: Tuple[int, int]
    tile_dir: Path
    thr: int                                     # tile width of the files
    nblocks: int
    max_tenants: int = 64
    cn: Optional[torch.Tensor] = None
    chol: Dict[Tuple[int, float], torch.Tensor] = field(default_factory=dict)
    warm: "OrderedDict[str, torch.Tensor]" = field(default_factory=OrderedDict)
    home: Optional[str] = None
    _verified: Set[int] = field(default_factory=set, repr=False)

    @property
    def nbytes(self) -> int:
        return self.nblocks * self.thr * self.shape[0] * 4

    def tile_path(self, j: int) -> Path:
        return self.tile_dir / f"t{self.thr}_b{j}.bin"

    def verify_tile(self, j: int) -> torch.Tensor:
        """Full checked read of one (thr, obs) fp32 tile: header magic,
        payload length and CRC32 all validated.  Raises
        ``TileCorruptionError`` on any mismatch (or an unreadable file)."""
        path = self.tile_path(j)
        try:
            with open(path, "rb") as f:
                header = f.read(_TILE_HEADER.size)
                payload = bytearray(f.read())
        except OSError as exc:
            raise TileCorruptionError(self.key, path, f"unreadable: {exc}")
        try:
            magic, crc, nbytes = _TILE_HEADER.unpack(header)
        except struct.error:
            raise TileCorruptionError(self.key, path, "truncated header")
        # Chaos site: flip one byte of the payload read (the file is not
        # touched), so the CRC check below trips as on real corruption.
        if faults.hit("store.tile_corrupt", self.key) is not None \
                and payload:
            payload[0] ^= 0xFF
        if magic != _TILE_MAGIC:
            raise TileCorruptionError(self.key, path, "bad magic")
        if len(payload) != nbytes \
                or nbytes != self.thr * self.shape[0] * 4:
            raise TileCorruptionError(
                self.key, path,
                f"payload is {len(payload)} bytes, header says {nbytes}")
        if zlib.crc32(payload) != crc:
            raise TileCorruptionError(self.key, path, "CRC32 mismatch")
        self._verified.add(j)
        return torch.frombuffer(payload, dtype=torch.float32).reshape(
            self.thr, self.shape[0])

    def tile(self, j: int) -> torch.Tensor:
        """One (thr, obs) fp32 tile, memmapped (copy-on-write: a write
        never reaches the file).  The first touch of each tile runs the
        full integrity check; later reads map the payload directly."""
        if j not in self._verified:
            self.verify_tile(j)
        return torch.from_numpy(np.memmap(
            self.tile_path(j), dtype=np.float32, mode="c",
            shape=(self.thr, self.shape[0]), offset=_TILE_HEADER.size))

    def read_cols(self, lo: int, hi: int) -> torch.Tensor:
        """Columns ``lo:hi`` in the transposed layout: one tile's memmap
        when the range is exactly that tile, else a zero-padded copy."""
        if lo % self.thr == 0 and hi - lo == self.thr \
                and hi <= self.nblocks * self.thr:
            return self.tile(lo // self.thr)
        out = torch.zeros((hi - lo, self.shape[0]), dtype=torch.float32)
        stop = min(hi, self.nblocks * self.thr)
        pos = lo
        while pos < stop:
            j = pos // self.thr
            t_lo = pos - j * self.thr
            t_hi = min(self.thr, stop - j * self.thr)
            out[pos - lo: pos - lo + (t_hi - t_lo)] = self.tile(j)[t_lo:t_hi]
            pos = j * self.thr + t_hi
        return out

    def delete_tiles(self) -> None:
        shutil.rmtree(self.tile_dir, ignore_errors=True)


class StoreBlockSource:
    """Per-block fetch interface of a non-resident design.

    The ``bakp_stream`` method's host-block loop pulls (thr, obs) fp32
    tiles of the transposed layout through this, wherever the bytes live
    (host memory or disk): the source resolves the tier on every fetch, so
    a design demoted to disk mid-solve keeps serving blocks.
    """

    def __init__(self, store: "DesignStore", key: str,
                 shape: Tuple[int, int]):
        self._store = store
        self.key = key
        self.shape = tuple(shape)               # (obs_p, vars_p)

    def num_blocks(self, thr: int) -> int:
        return -(-self.shape[1] // thr)

    def block_t(self, thr: int, j: int) -> torch.Tensor:
        """Tile ``j`` of the thr-blocked transposed layout, (thr, obs)
        fp32, zero-padded past the real column count."""
        return self._store._fetch_block(self.key, thr, j)


@dataclass
class StoreStats:
    """Per-store counters (convenience mirror of the ``store_*`` metric
    families)."""

    admits: int = 0
    builds_nonresident: int = 0
    demotions_device: int = 0      # device → host
    demotions_disk: int = 0        # host → disk
    promotions_host: int = 0       # host → device
    promotions_disk: int = 0       # disk → device
    x_drops: int = 0               # host X bytes dropped (no disk tier)
    tile_corruptions: int = 0      # designs quarantined off the disk tier

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class DesignStore:
    """Three-tier byte-budgeted design residency store (see module doc).

    Args:
      device_bytes: device-tier budget.  None = unbounded (only
        ``max_entries`` demotes).  A design whose padded x alone exceeds it
        is never admitted resident: it is built non-resident, its bytes on
        the host / disk tiers.  Admission counts x_pad's bytes only, while
        ``device_used`` also counts the layouts built later (transposed,
        bf16), and the byte check never demotes the last resident design.
        So a design between half the budget and the whole of it, once its
        transposed layout exists (or when it is promoted with one), can
        hold the tier over budget alone, every other design demoted — as
        the JAX store does.
      host_bytes: host-tier budget; overflow demotes LRU host records to
        disk (or drops their x bytes when no ``disk_dir`` is set).
      disk_dir: directory for the tile files; None disables the disk tier.
      max_entries: LRU entry-count bound on the device tier (None =
        bytes only).
      registry: ``repro_torch.obs`` metrics registry (process default if
        None).
      device: where resident designs and solves live — default ``"cuda"``
        (raises without a GPU; pass ``"cpu"`` for the plain path).  The
        host tier's x layouts are pinned when it is a GPU.
    """

    def __init__(self, device_bytes: Optional[int] = None,
                 host_bytes: Optional[int] = None,
                 disk_dir: Optional[str] = None,
                 max_entries: Optional[int] = None,
                 registry: Optional[obs.MetricsRegistry] = None,
                 device=None):
        self.device_bytes = device_bytes
        self.host_bytes = host_bytes
        self.disk_dir = Path(disk_dir) if disk_dir is not None else None
        self.max_entries = max_entries
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self.stats = StoreStats()
        reg = registry or obs.default_registry()
        g_bytes = reg.gauge("store_bytes",
                            "bytes resident per design-store tier")
        g_res = reg.gauge("store_resident",
                          "designs resident per design-store tier")
        self._g_bytes = {t: g_bytes.labels(tier=t)
                         for t in ("device", "host", "disk")}
        self._g_res = {t: g_res.labels(tier=t)
                       for t in ("device", "host", "disk")}
        self._m_moves = reg.counter(
            "store_promotions_total",
            "design tier transitions (demotions AND promotions), "
            "by from/to tier")
        h_fetch = reg.histogram(
            "store_fetch_latency_seconds",
            "tier-promotion and streaming block-fetch latency, by source "
            "tier", buckets=obs.LATENCY_BUCKETS)
        self._h_fetch = {t: h_fetch.labels(tier=t)
                         for t in ("host", "disk")}
        self._m_corruption = reg.counter(
            "store_tile_corruption_total",
            "designs quarantined after a disk tile failed its CRC/header "
            "check")
        self._lock = threading.RLock()
        self._device: "OrderedDict[str, PreparedDesign]" = OrderedDict()
        self._host: "OrderedDict[str, HostDesign]" = OrderedDict()
        self._disk: "OrderedDict[str, DiskDesign]" = OrderedDict()
        # Non-resident handles (x_pad=None, blocks=StoreBlockSource): kept
        # here so repeat requests reuse one handle (and its warm
        # coefficients / inverse norms).
        self._nonres: Dict[str, PreparedDesign] = {}

    # ------------------------------------------------------------ accounting
    def __len__(self) -> int:
        """Device-resident design count (the ``DesignCache`` contract)."""
        with self._lock:
            return len(self._device)

    def device_used(self) -> int:
        with self._lock:
            return sum(_entry_device_bytes(e) for e in self._device.values())

    def host_used(self) -> int:
        with self._lock:
            return sum(h.nbytes for h in self._host.values())

    def disk_used(self) -> int:
        with self._lock:
            return sum(d.nbytes for d in self._disk.values())

    def tier(self, key: str) -> str:
        """Where a design's x bytes live: "device" / "host" / "disk" /
        "none"."""
        with self._lock:
            if key in self._device:
                return "device"
            h = self._host.get(key)
            if h is not None and h.has_x():
                return "host"
            if key in self._disk:
                return "disk"
            return "none"

    def _update_gauges(self) -> None:
        self._g_bytes["device"].set(self.device_used())
        self._g_bytes["host"].set(self.host_used())
        self._g_bytes["disk"].set(self.disk_used())
        self._g_res["device"].set(len(self._device))
        self._g_res["host"].set(len(self._host))
        self._g_res["disk"].set(len(self._disk))

    def refresh_gauges(self) -> None:
        """Re-read the tiers' bytes into the gauges: a resident design
        grows after admission (its kernel layouts, its sharded copies), and
        the serving cache calls this once it has warmed one."""
        with self._lock:
            self._update_gauges()

    def _move(self, src: str, dst: str) -> None:
        self._m_moves.inc(1, **{"from": src, "to": dst})

    # ----------------------------------------------------------------- reads
    def get(self, key: str) -> Optional[PreparedDesign]:
        """The servable handle for ``key``: the device-resident entry or
        the non-resident streaming handle.  LRU-touches; never promotes."""
        with self._lock:
            entry = self._device.get(key)
            if entry is not None:
                self._device.move_to_end(key)
                return entry
            nr = self._nonres.get(key)
            if nr is not None:
                if key in self._host:
                    self._host.move_to_end(key)
                return nr
            return None

    # ------------------------------------------------------------- admission
    def admit(self, key: str, entry: PreparedDesign) -> PreparedDesign:
        """Insert a resident design into the device tier, demoting LRU
        entries while over budget.  Build races resolve first-writer-wins."""
        with self._lock:
            existing = self._device.get(key)
            if existing is not None:
                self._device.move_to_end(key)
                return existing
            self._device[key] = entry
            self.stats.admits += 1
            self._enforce_device()
            self._update_gauges()
            return entry

    def _enforce_device(self) -> None:
        """Demote LRU device entries while over the byte budget or entry
        cap; the most recent admission stays even when it alone exceeds
        the budget (designs known to exceed it are built non-resident)."""
        if self.max_entries is not None:
            while len(self._device) > self.max_entries:
                self._demote_lru()
        if self.device_bytes is not None:
            while (len(self._device) > 1
                   and self.device_used() > self.device_bytes):
                self._demote_lru()

    def _demote_lru(self) -> None:
        # The key alone: a reference held here would keep the demoted
        # handle's device tensors alive until this returns.
        self.demote(next(iter(self._device)))

    # -------------------------------------------------------------- demotion
    def demote(self, key: str) -> Optional[HostDesign]:
        """Device → host: copy every reusable piece of the resident handle
        (kernel layouts, norms, Cholesky factors, the warm-coefficient
        LRU, its home) into a ``HostDesign``, then drop the device entry
        and its sharded copies.  Enforces the host budget afterwards (host
        → disk)."""
        with self._lock:
            entry = self._device.pop(key, None)
            if entry is None:
                return None
            snap = HostDesign(key=key, shape=tuple(entry.x_pad.shape),
                              max_tenants=entry.max_tenants,
                              **entry.snapshot_state(pin=self._pin))
            entry.drop_sharded()
            if not snap.x_t:
                snap.x_pad = host_copy(entry.x_pad, pin=self._pin)
            self._host[key] = snap
            self._host.move_to_end(key)
            self.stats.demotions_device += 1
            self._move("device", "host")
            self._enforce_host()
            self._update_gauges()
            return snap

    def _enforce_host(self) -> None:
        if self.host_bytes is None:
            return
        while self.host_used() > self.host_bytes:
            # LRU order, skipping records that no longer hold X bytes
            # (state-only stubs cost nothing and must survive).
            victim = next((k for k, h in self._host.items() if h.has_x()),
                          None)
            if victim is None:
                return
            self._demote_to_disk(victim)

    def _demote_to_disk(self, key: str) -> None:
        host = self._host[key]
        if self.disk_dir is None:
            # No disk tier: drop the X bytes, keep the state-only record so
            # warm coefficients / Cholesky factors still restore on rebuild.
            host.drop_x()
            self.stats.x_drops += 1
            return
        obs_p, vars_p = host.shape
        thr = next(iter(host.x_t)) if host.x_t else min(DEFAULT_TILE, vars_p)
        nblocks = -(-vars_p // thr)
        tile_dir = self.disk_dir / _fs_key(key)
        tile_dir.mkdir(parents=True, exist_ok=True)
        rec = DiskDesign(key=key, shape=host.shape, tile_dir=tile_dir,
                         thr=thr, nblocks=nblocks,
                         max_tenants=host.max_tenants, cn=host.cn,
                         chol=host.chol, warm=host.warm, home=host.home)
        for j in range(nblocks):
            _write_tile_atomic(rec.tile_path(j),
                               host.read_cols(j * thr, (j + 1) * thr))
        del self._host[key]
        self._disk[key] = rec
        self._disk.move_to_end(key)
        self.stats.demotions_disk += 1
        self._move("host", "disk")

    # ------------------------------------------------------------- promotion
    def promote(self, key: str) -> Optional[PreparedDesign]:
        """Climb ``key`` back to the hottest tier it fits.

        host / disk → device rebuilds the ``PreparedDesign`` from the
        record's bytes and restores every piece of state — norms,
        Cholesky factors, kernel layouts and the warm-coefficient LRU.  A
        disk promotion deletes its tile files.  Designs too large for the
        device budget come back as (or keep) their non-resident streaming
        handle.  Returns None when the key is unknown, only a state-only
        stub remains, or a tile failed its check (the design is then
        quarantined): the caller rebuilds from the design source, and
        ``build`` restores the stub's state."""
        with self._lock:
            hit = self._device.get(key)
            if hit is not None:
                self._device.move_to_end(key)
                return hit
            host = self._host.get(key)
            if host is not None and host.has_x():
                t0 = obs.now()
                entry = self._rebuild_from_host(host)
                if entry is None:          # over device budget: stays put
                    return self._nonres_handle(key, host.shape)
                del self._host[key]
                self._nonres.pop(key, None)
                self.stats.promotions_host += 1
                self._move("host", "device")
                self._h_fetch["host"].observe(obs.now() - t0)
                return self.admit(key, entry)
            disk = self._disk.get(key)
            if disk is not None:
                t0 = obs.now()
                try:
                    entry = self._rebuild_from_disk(disk)
                except TileCorruptionError as exc:
                    # Quarantine the damaged design; the caller sees a miss
                    # and rebuilds from the design source (with the stub's
                    # warm/derived state restored by ``build``).
                    self._quarantine(key, disk, exc)
                    return None
                if entry is None:
                    return self._nonres_handle(key, disk.shape)
                disk.delete_tiles()
                del self._disk[key]
                self._nonres.pop(key, None)
                self.stats.promotions_disk += 1
                self._move("disk", "device")
                self._h_fetch["disk"].observe(obs.now() - t0)
                return self.admit(key, entry)
            return None

    def _fits_device(self, shape: Tuple[int, int]) -> bool:
        return (self.device_bytes is None
                or shape[0] * shape[1] * 4 <= self.device_bytes)

    def _resident_from_t(self, key, shape, max_tenants, thr,
                         x_t: torch.Tensor) -> PreparedDesign:
        """A resident handle from a transposed layout already on the
        device: ``x_pad`` is its transpose, ``x_t_for(thr)`` the layout."""
        entry = prepare(x_t[:shape[1]].T, device=self.device,
                        fingerprint=key, max_tenants=max_tenants)
        entry.restore_state(x_t={thr: x_t})
        return entry

    def _rebuild_from_host(self, host: HostDesign
                           ) -> Optional[PreparedDesign]:
        if not self._fits_device(host.shape):
            return None
        if host.x_t:
            thr, x_t = next(iter(host.x_t.items()))
            entry = self._resident_from_t(
                host.key, host.shape, host.max_tenants, thr,
                device_copy(x_t, self.device))
        else:
            entry = prepare(host.x_pad, device=self.device,
                            fingerprint=host.key,
                            max_tenants=host.max_tenants)
        entry.restore_state(cn=host.cn, chol=host.chol, warm=host.warm,
                            home=host.home, x_t=host.x_t,
                            x_bf16=host.x_bf16)
        return entry

    def _rebuild_from_disk(self, disk: DiskDesign
                           ) -> Optional[PreparedDesign]:
        if not self._fits_device(disk.shape):
            return None
        # verify_tile, not tile: promotion reads every byte anyway, so it
        # is THE place to pay for a full integrity sweep — a tile the
        # streaming path already blessed still gets re-checked here.
        x_t = torch.empty((disk.nblocks * disk.thr, disk.shape[0]),
                          dtype=torch.float32, pin_memory=self._pin)
        for j in range(disk.nblocks):
            x_t[j * disk.thr:(j + 1) * disk.thr] = disk.verify_tile(j)
        entry = self._resident_from_t(
            disk.key, disk.shape, disk.max_tenants, disk.thr,
            device_copy(x_t, self.device))
        entry.restore_state(cn=disk.cn, chol=disk.chol, warm=disk.warm,
                            home=disk.home)
        return entry

    # ------------------------------------------------------------------ build
    def build(self, key: str, x_pad, *,
              max_tenants: int = 64) -> PreparedDesign:
        """Build the servable handle for a design from its padded matrix
        (an array, or a tensor on any device).

        Fits the device budget → a resident ``prepare``d handle, admitted
        to the device tier (demoting LRU entries as needed).  Over budget →
        the bytes land on the host tier (spilling to disk under the host
        budget) and a non-resident streaming handle comes back.  Either
        way, a surviving state-only stub (warm coefficients, Cholesky) from
        an earlier X-byte drop or a quarantine is restored onto the new
        handle."""
        if not torch.is_tensor(x_pad):
            x_pad = np.asarray(x_pad, np.float32)
        shape = tuple(x_pad.shape)
        with self._lock:
            existing = self.get(key)
            if existing is not None:
                return existing
            stub = self._host.get(key)
            if self._fits_device(shape):
                entry = prepare(x_pad, device=self.device, fingerprint=key,
                                max_tenants=max_tenants)
                if stub is not None:
                    entry.restore_state(cn=stub.cn, chol=stub.chol,
                                        warm=stub.warm, home=stub.home)
                    del self._host[key]
                return self.admit(key, entry)
            # Non-resident: x bytes live on the host tier; the handle
            # streams blocks through the store.
            host = stub if stub is not None else HostDesign(
                key=key, shape=shape, max_tenants=max_tenants)
            host.shape = shape
            host.max_tenants = max_tenants
            if not host.has_x():
                src = HostDesign.from_design(x_pad, key=key, pin=self._pin)
                host.x_t = src.x_t
                if host.cn is None:
                    host.cn = src.cn
            self._host[key] = host
            self._host.move_to_end(key)
            self.stats.builds_nonresident += 1
            entry = self._nonres_handle(key, host.shape)
            self._enforce_host()
            self._update_gauges()
            return entry

    def _nonres_handle(self, key: str,
                       shape: Tuple[int, int]) -> PreparedDesign:
        handle = self._nonres.get(key)
        if handle is not None:
            return handle
        rec = self._host.get(key) or self._disk.get(key)
        cn = rec.cn if rec is not None else None
        handle = PreparedDesign(
            x_pad=None, fingerprint=key,
            max_tenants=rec.max_tenants if rec is not None else 64,
            blocks=StoreBlockSource(self, key, shape), _device=self.device,
            _cn=(None if cn is None
                 else device_copy(cn, self.device)))
        if rec is not None:
            handle.restore_state(chol=rec.chol, warm=rec.warm, home=rec.home)
        self._nonres[key] = handle
        return handle

    # --------------------------------------------------------- quarantine
    def _quarantine(self, key: str, disk: DiskDesign,
                    exc: TileCorruptionError) -> None:
        """Take a damaged design off the disk tier (must hold the lock).

        The tile directory is renamed aside (``.quarantine``) for forensic
        inspection rather than deleted, the disk record AND any live
        streaming handle are dropped (a stale handle would keep fetching
        the dead tiles), and a state-only ``HostDesign`` stub keeps the
        warm coefficients / Cholesky / norms so a rebuild from the design
        source restores the tenant state."""
        _log.warning("quarantining design %r: %s", key, exc)
        del self._disk[key]
        self._nonres.pop(key, None)
        qdir = disk.tile_dir.with_name(disk.tile_dir.name + ".quarantine")
        try:
            shutil.rmtree(qdir, ignore_errors=True)
            os.replace(disk.tile_dir, qdir)
        except OSError:
            shutil.rmtree(disk.tile_dir, ignore_errors=True)
        if key not in self._host:
            self._host[key] = HostDesign(
                key=key, shape=disk.shape, max_tenants=disk.max_tenants,
                cn=disk.cn, chol=disk.chol, warm=disk.warm, home=disk.home)
        self.stats.tile_corruptions += 1
        self._m_corruption.inc(1)
        self._update_gauges()

    # ----------------------------------------------------------- block fetch
    def _fetch_block(self, key: str, thr: int, j: int) -> torch.Tensor:
        t0 = obs.now()
        with self._lock:
            host = self._host.get(key)
            if host is not None and host.has_x():
                out = host.read_cols(j * thr, (j + 1) * thr)
                self._h_fetch["host"].observe(obs.now() - t0)
                return out
            disk = self._disk.get(key)
            if disk is not None:
                # Chaos site: stall the disk read (deadline storms against
                # the streaming path).
                faults.maybe_delay("store.read_delay", key)
                try:
                    out = disk.read_cols(j * thr, (j + 1) * thr)
                except TileCorruptionError as exc:
                    self._quarantine(key, disk, exc)
                    raise
                self._h_fetch["disk"].observe(obs.now() - t0)
                return out
            entry = self._device.get(key)
            if entry is not None:
                # A design promoted mid-solve: serve blocks off the
                # resident copy.
                x = entry.x_pad
                lo, hi = j * thr, (j + 1) * thr
                out = x.new_zeros((thr, x.shape[0]))
                real = min(hi, x.shape[1]) - lo
                if real > 0:
                    out[:real] = x[:, lo:lo + real].T
                self._h_fetch["host"].observe(obs.now() - t0)
                return out
        raise KeyError(f"design {key!r} has no X bytes in any store tier")

    # ------------------------------------------------------------- lifecycle
    def keys(self) -> List[str]:
        with self._lock:
            return list({*self._device, *self._host, *self._disk,
                         *self._nonres})

    def close(self) -> None:
        """Drop every tier (deleting disk tiles).  For tests and
        benchmarks; a serving store lives as long as its engine."""
        with self._lock:
            for rec in self._disk.values():
                rec.delete_tiles()
            self._device.clear()
            self._host.clear()
            self._disk.clear()
            self._nonres.clear()
            self._update_gauges()


def _fs_key(key: str) -> str:
    """Filesystem-safe tile-directory name for a design fingerprint."""
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in key)
