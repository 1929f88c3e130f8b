"""Execution lanes — per-kernel-path executor threads for the serving
stack.

Counterpart of ``repro.serve.lanes``.  A **lane** is a (device, kernel
path) pair with its own executor thread, its own most-urgent-first queue of
batches and, on a GPU, its own CUDA stream: the worker thread enters
``torch.cuda.stream(lane_stream)`` for its whole life, so every kernel and
copy a lane's work issues queues on that stream, and batches on different
lanes (the plain torch family, the whole-solve kernels, the streaming
kernel) overlap on the card.  The engine's ``flush()`` builds batches and
*submits* work units here; each lane drains independently.  A lane's work
waits for its own stream before it reports a result (the engine times a
solve to the end of its stream's work), so a finished work has finished
on the device too.

Routing is one table lookup (``lane_for``): a method lands on its
registry-declared single-device lane (``MethodEntry.lane`` — "xla" for
the plain torch family, "fused" for the whole-solve CUDA kernels,
"stream" for ``"bakp_stream"``) on the engine's device; a sharded
placement with a mesh lands on its mesh lane (``"mesh:<kind>"``), which
owns the mesh's whole device set and one CUDA stream per distinct card of
it, all current on its thread.  ``Placement.lane_key`` supplies the kind
half of the identity; ``LaneKey.devices`` the device half.

Concurrency contract:

  * one thread per lane, started lazily on first submit;
  * per-lane FIFO broken by urgency: works submit with an ``urgency``
    (``inf`` = plain FIFO by submission order);
  * ``LanePool(serial=True)`` maps every key to ONE ``"serial"`` lane (one
    thread, one stream), reachable via
    ``ServeConfig(lane_execution=False)``;
  * ``current_lane()`` marks lane threads (thread-local): engine flushes
    nested inside a lane work run their units inline instead of
    re-submitting, so a lane can never deadlock waiting on itself;
  * per-lane gauges (``serve_lane_queue_depth`` / ``serve_lane_inflight``)
    and a ``LaneStats`` counter mirror record into the engine's registry.

Shutdown: ``shutdown(drain=True)`` finishes queued work then parks the
thread; ``drain=False`` abandons queued works (their ``error`` is set and
their events fire, so no waiter hangs) and stops after the in-flight work
completes.

Supervision: lane executors survive worker-thread death.  An exception
escaping the loop *outside* the per-work try (a harness bug, or the
``"lane.worker"`` fault-injection site) fails only the in-flight work (its
``error``/``on_fail``/event fire, so no waiter hangs), counts
``serve_lane_restarts_total{lane}``, dips the ``serve_lane_health`` gauge
to 0, and hands the intact queue (and the lane's stream) to a fresh worker
thread after a jittered, bounded backoff.  After ``max_restarts``
*consecutive* crashes (any completed work resets the streak) the lane's
circuit breaker trips: health pins at 0, queued works are rerouted, and
``LanePool.submit`` sends all later traffic for that key to the
``SERIAL_LANE`` fallback executor (which never trips — it restarts
forever, the fallback of last resort).
"""
from __future__ import annotations

import contextlib
import heapq
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.resilience import faults
from repro_torch.serve.placement import Placement, ServeMesh

_SINGLE = Placement()


def _device_ids(device=None) -> Tuple[str, ...]:
    """Device identity of a lane: the engine's ``torch.device`` (default
    ``"cuda"``, the port's default device) as its name."""
    return (str(torch.device("cuda" if device is None else device)),)


@dataclass(frozen=True)
class LaneKey:
    """Identity of one execution lane: the placement/kernel-path kind
    (``Placement.lane_key`` string, e.g. ``"single:xla"``, ``"single:fused"``,
    ``"mesh:obs_sharded"``) plus the devices it owns (``("cuda:0",)``, or a
    mesh's ``device_ids()``).  Frozen/hashable: keys the pool's executor
    map and the per-lane metric labels."""

    label: str
    devices: Tuple[str, ...] = ()


#: The one lane of a ``LanePool(serial=True)`` (and the breaker's fallback).
SERIAL_LANE = LaneKey("serial", ())


def lane_for(method: str, placement: Optional[Placement] = None,
             device=None, smesh: Optional[ServeMesh] = None) -> LaneKey:
    """spec→lane routing: one registry/placement table lookup.  A sharded
    placement with a mesh owns the mesh's device set; methods otherwise
    land on ``device`` (default ``"cuda"``) under their registry
    ``MethodEntry.lane`` kind."""
    if placement is not None and placement.sharded and smesh is not None:
        return LaneKey(placement.lane_key(method), smesh.mesh.device_ids())
    return LaneKey((placement or _SINGLE).lane_key(method),
                   _device_ids(device))


class LaneWork:
    """One unit of lane work: a zero-arg callable plus completion event.

    ``urgency`` orders the lane's queue (lower = sooner; ties resolve
    FIFO by submission sequence).  ``error`` carries an exception the
    callable raised (or the shutdown abandonment), for the waiter to
    re-raise or translate; the event always fires, so waiters never hang.

    ``on_fail`` (optional) is invoked with the exception when the work is
    failed *without its callable completing* — worker-thread death,
    shutdown abandonment, a tripped breaker with no reroute — before the
    event fires (an async dispatcher settles its tickets there); it must
    be cheap and must not raise (failures are swallowed).
    """

    __slots__ = ("fn", "urgency", "size", "tag", "on_fail", "enqueued_at",
                 "started_at", "error", "_event")

    def __init__(self, fn: Callable[[], None], urgency: float = float("inf"),
                 size: int = 1, tag: str = "",
                 on_fail: Optional[Callable[[BaseException], None]] = None):
        self.fn = fn
        self.urgency = float(urgency)
        self.size = int(size)
        self.tag = tag
        self.on_fail = on_fail
        self.enqueued_at = obs.now()
        self.started_at: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


@dataclass
class LaneStats:
    """Per-lane counters (convenience mirror of the ``serve_lane_*``
    gauges; see ``ServeStats`` for the pattern)."""

    batches: int = 0
    requests: int = 0
    failures: int = 0
    busy_s: float = 0.0
    max_queue_depth: int = 0
    restarts: int = 0      # worker-thread deaths survived by restart
    tripped: bool = False  # circuit breaker open (rerouting to serial)

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class LaneShutdown(RuntimeError):
    """The lane was shut down before (or while) the work could run."""


class LaneWorkerDeath(RuntimeError):
    """The lane's worker thread died while this work was in flight.

    Only the in-flight work gets this error — queued works survive the
    restart.  ``__cause__`` carries the exception that killed the thread.
    """


# Thread-local lane marker: set once per executor thread, read by the
# engine to run nested flushes inline (a lane must never block on itself).
_lane_local = threading.local()


def current_lane() -> Optional[LaneKey]:
    """The ``LaneKey`` of the lane thread we are on (None elsewhere)."""
    return getattr(_lane_local, "current", None)


class LaneExecutor:
    """One lane: a supervised daemon thread draining a most-urgent-first
    work heap, with a CUDA stream of its own on each distinct card of
    ``devices`` (one for a single-device lane, the mesh's for a mesh lane),
    all current on the lane's thread.

    Supervision knobs (instance attributes, patchable in tests):
    ``max_restarts`` — consecutive crashes before the circuit breaker
    trips (any completed work resets the streak; a lane with no
    ``on_trip`` reroute — e.g. the serial fallback itself — never trips
    and just keeps restarting); ``backoff_base_s``/``backoff_cap_s`` —
    the jittered exponential restart backoff bounds.
    """

    max_restarts: int = 3
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 1.0

    def __init__(self, key: LaneKey,
                 registry: Optional[obs.MetricsRegistry] = None,
                 max_restarts: Optional[int] = None, devices=()):
        self.key = key
        devs = list(dict.fromkeys(torch.device(d) for d in devices
                                  if d is not None))
        self.device = devs[0] if devs else None
        #: The lane's CUDA streams, one a distinct card (none off the GPU);
        #: every worker thread of this lane, restarts included, runs inside
        #: them.  ``stream`` is the first card's.
        self.streams = [torch.cuda.Stream(device=d) for d in devs
                        if d.type == "cuda"]
        self.stream = self.streams[0] if self.streams else None
        self.stats = LaneStats()
        if max_restarts is not None:
            self.max_restarts = int(max_restarts)
        #: Reroute hook the pool installs: called (outside the lane lock)
        #: with the queued works of a lane whose breaker just tripped.
        self.on_trip: Optional[Callable[[List[LaneWork]], None]] = None
        reg = registry or obs.default_registry()
        self._g_depth = reg.gauge(
            "serve_lane_queue_depth",
            "fired batches waiting per execution lane").labels(
                lane=key.label)
        self._g_inflight = reg.gauge(
            "serve_lane_inflight",
            "batches submitted and not yet finished per execution "
            "lane").labels(lane=key.label)
        self._c_restarts = reg.counter(
            "serve_lane_restarts_total",
            "lane worker-thread deaths survived by supervised "
            "restart").labels(lane=key.label)
        self._g_health = reg.gauge(
            "serve_lane_health",
            "1 = lane serving normally, 0 = crashed (restarting) or "
            "circuit-broken").labels(lane=key.label)
        self._g_health.set(1.0)
        self._cv = threading.Condition()
        self._heap: List[Tuple[float, int, LaneWork]] = []
        self._seq = 0
        self._inflight = 0      # submitted, not yet finished
        self._stopping = False
        self._tripped = False
        self._consec_crashes = 0
        self._current: Optional[LaneWork] = None  # worker-thread owned
        self._thread: Optional[threading.Thread] = None

    @property
    def tripped(self) -> bool:
        return self._tripped

    # ------------------------------------------------------------ submit
    def submit(self, work: LaneWork) -> LaneWork:
        with self._cv:
            if self._stopping:
                raise LaneShutdown(f"lane {self.key.label} is shut down")
            if self._tripped:
                raise LaneShutdown(
                    f"lane {self.key.label} circuit breaker is open")
            heapq.heappush(self._heap, (work.urgency, self._seq, work))
            self._seq += 1
            self._inflight += 1
            depth = len(self._heap)
            self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                             depth)
            self._g_depth.set(depth)
            self._g_inflight.set(self._inflight)
            if self._thread is None:
                self._spawn_locked()
            self._cv.notify_all()
        return work

    def _spawn_locked(self) -> None:
        self._thread = threading.Thread(
            target=self._run,
            name=f"serve-lane-{self.key.label}", daemon=True)
        self._thread.start()

    # -------------------------------------------------------------- loop
    def _run(self) -> None:
        """Worker-thread body: the drain loop under a supervisor.

        ``_loop`` returning means a clean stop.  Anything escaping it is
        worker-thread death: ``_handle_crash`` fails ONLY the in-flight
        work (queued works stay on the heap), then — unless the breaker
        tripped — a replacement thread is spawned after a jittered,
        bounded backoff and this one exits.
        """
        _lane_local.current = self.key
        try:
            with contextlib.ExitStack() as ctx:
                if self.streams:
                    ctx.enter_context(torch.cuda.device(self.stream.device))
                for s in self.streams:
                    ctx.enter_context(torch.cuda.stream(s))
                self._loop()
            return
        except BaseException as exc:
            if not self._handle_crash(exc):
                return  # breaker tripped: health stays 0, no replacement
        delay = min(self.backoff_cap_s,
                    self.backoff_base_s * (2 ** (self._consec_crashes - 1)))
        time.sleep(delay * (0.5 + random.random()))
        with self._cv:
            self._spawn_locked()
        self._g_health.set(1.0)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._stopping:
                    self._cv.wait()
                if not self._heap:  # stopping and drained
                    return
                _, _, work = heapq.heappop(self._heap)
                self._g_depth.set(len(self._heap))
            t0 = obs.now()
            work.started_at = t0
            self._current = work
            # Chaos sites: a "lane.worker" raise here is OUTSIDE the
            # per-work try — exactly a worker-thread death; "lane.delay"
            # simulates a slow device (deadline storms).  Both are no-ops
            # without an armed FaultPlan.
            faults.maybe_raise("lane.worker", self.key.label)
            faults.maybe_delay("lane.delay", self.key.label)
            try:
                work.fn()
            except BaseException as exc:  # surfaced via work.error
                work.error = exc
                self.stats.failures += 1
            dt = obs.now() - t0
            self._current = None
            with self._cv:
                self.stats.batches += 1
                self.stats.requests += work.size
                self.stats.busy_s += dt
                self._inflight -= 1
                self._consec_crashes = 0  # completed work resets the streak
                self._g_inflight.set(self._inflight)
                self._cv.notify_all()
            work._event.set()

    # -------------------------------------------------------- supervision
    @staticmethod
    def _fail_work(work: LaneWork, exc: BaseException) -> None:
        """Settle a work that will never run its callable to completion:
        error + on_fail + event, so no waiter hangs."""
        work.error = exc
        if work.on_fail is not None:
            try:
                work.on_fail(exc)
            except Exception:
                pass  # on_fail must not take the supervisor down
        work._event.set()

    def _handle_crash(self, exc: BaseException) -> bool:
        """Account one worker-thread death.  Returns True when a
        replacement thread should spawn (False = breaker tripped)."""
        work, self._current = self._current, None
        with self._cv:
            self._consec_crashes += 1
            self.stats.failures += 1
            self.stats.restarts += 1
            if work is not None:
                # Fail ONLY the in-flight work; queued works survive.
                self._inflight -= 1
                self.stats.batches += 1
                self.stats.requests += work.size
            trip = (self.on_trip is not None
                    and self._consec_crashes > self.max_restarts)
            abandoned: List[LaneWork] = []
            if trip:
                self._tripped = True
                self.stats.tripped = True
                abandoned = [w for _, _, w in self._heap]
                self._heap.clear()
                self._inflight -= len(abandoned)
                self._g_depth.set(0)
            self._g_inflight.set(self._inflight)
            self._cv.notify_all()
        self._c_restarts.inc(1)
        self._g_health.set(0.0)
        if work is not None:
            death = LaneWorkerDeath(
                f"lane {self.key.label} worker thread died: "
                f"{type(exc).__name__}: {exc}")
            death.__cause__ = exc
            self._fail_work(work, death)
        if trip and abandoned:
            try:
                self.on_trip(abandoned)
            except Exception:
                for w in abandoned:
                    self._fail_work(w, LaneShutdown(
                        f"lane {self.key.label} circuit breaker open and "
                        f"reroute failed"))
        return not trip

    # --------------------------------------------------------- lifecycle
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted work has finished."""
        deadline = None if timeout is None else obs.now() + timeout
        with self._cv:
            while self._inflight > 0:
                remaining = (None if deadline is None
                             else deadline - obs.now())
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the lane.  ``drain`` (default) runs queued work first;
        otherwise queued works are abandoned (``error`` set, ``on_fail``
        invoked, events fired) and only the in-flight work completes."""
        abandoned: List[LaneWork] = []
        with self._cv:
            self._stopping = True
            if not drain and self._heap:
                abandoned = [w for _, _, w in self._heap]
                self._heap.clear()
                self._inflight -= len(abandoned)
                self._g_depth.set(0)
                self._g_inflight.set(self._inflight)
            self._cv.notify_all()
            thread = self._thread
        for w in abandoned:
            self._fail_work(w, LaneShutdown(
                f"lane {self.key.label} shut down"))
        # A supervised restart may have handed the queue to a replacement
        # thread while we joined the old one — follow the chain until the
        # live thread is the one we joined.
        while thread is not None:
            thread.join(timeout)
            with self._cv:
                nxt = self._thread
            if nxt is thread or timeout is not None:
                break
            thread = nxt

    @property
    def inflight(self) -> int:
        with self._cv:
            return self._inflight


class LanePool:
    """Lazily-created ``LaneExecutor`` map, keyed by ``LaneKey``.

    ``device`` is the engine's device: its single-device lanes run on it,
    each on a CUDA stream of its own when it is a GPU (None: plain threads,
    no device); a mesh lane runs on its key's devices.
    ``serial=True`` collapses every key to ``SERIAL_LANE`` — one executor
    thread and one stream for everything
    (``ServeConfig.lane_execution=False``).

    Circuit breaking: every non-serial executor gets an ``on_trip`` hook
    that reroutes its queued works to the serial fallback executor when
    its breaker opens (> ``max_restarts`` consecutive worker-thread
    deaths), and ``submit`` routes new work for a tripped lane there too —
    the fleet degrades to the serial lane for that traffic
    instead of erroring it.  The serial lane itself has no ``on_trip`` and
    therefore never trips (it just keeps restarting).
    """

    def __init__(self, registry: Optional[obs.MetricsRegistry] = None,
                 serial: bool = False, max_restarts: int = 3, device=None):
        self.registry = registry or obs.default_registry()
        self.device = None if device is None else torch.device(device)
        self.serial = serial
        self.max_restarts = max_restarts
        self._lock = threading.Lock()
        self._lanes: Dict[LaneKey, LaneExecutor] = {}

    # ----------------------------------------------------------- routing
    def lane_for(self, method: str, placement: Optional[Placement] = None,
                 smesh: Optional[ServeMesh] = None) -> LaneKey:
        if self.serial:
            return SERIAL_LANE
        return lane_for(method, placement, self.device, smesh)

    def executor(self, key: LaneKey) -> LaneExecutor:
        with self._lock:
            ex = self._lanes.get(key)
            if ex is None:
                mesh_lane = key.label.startswith("mesh:") and key.devices
                ex = self._lanes[key] = LaneExecutor(
                    key, self.registry, max_restarts=self.max_restarts,
                    devices=key.devices if mesh_lane else [self.device])
                if key != SERIAL_LANE:
                    ex.on_trip = self._reroute_serial
            return ex

    def _reroute_serial(self, works: List[LaneWork]) -> None:
        """Trip hook: hand a broken lane's queued works to the serial
        fallback executor (called from the dying lane's thread).  A work
        the serial lane cannot take (pool mid-shutdown) is settled
        individually so the ones already resubmitted are never touched
        twice."""
        serial = self.executor(SERIAL_LANE)
        for w in works:
            try:
                serial.submit(w)
            except Exception as exc:
                LaneExecutor._fail_work(w, exc)

    def submit(self, key: LaneKey, work: LaneWork) -> LaneWork:
        ex = self.executor(key)
        if ex.tripped and key != SERIAL_LANE:
            ex = self.executor(SERIAL_LANE)
        return ex.submit(work)

    # ------------------------------------------------------------- reads
    def lane_keys(self) -> List[LaneKey]:
        with self._lock:
            return list(self._lanes)

    def stats(self) -> Dict[str, dict]:
        """Per-lane counters keyed by lane label (live lanes only)."""
        with self._lock:
            lanes = dict(self._lanes)
        return {k.label: ex.stats.as_dict() for k, ex in lanes.items()}

    @property
    def inflight(self) -> int:
        with self._lock:
            lanes = list(self._lanes.values())
        return sum(ex.inflight for ex in lanes)

    # --------------------------------------------------------- lifecycle
    def drain(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else obs.now() + timeout
        with self._lock:
            lanes = list(self._lanes.values())
        ok = True
        for ex in lanes:
            remaining = None if deadline is None else deadline - obs.now()
            ok = ex.drain(remaining) and ok
        return ok

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop every lane thread.  The pool stays usable: stopped lanes
        are dropped from the map, so a later submit lazily starts a fresh
        executor for its key (their ``LaneStats`` start over)."""
        with self._lock:
            lanes, self._lanes = list(self._lanes.values()), {}
        for ex in lanes:
            ex.shutdown(drain=drain, timeout=timeout)
