"""repro_torch.obs — telemetry for the port's solver-serving stack.

Counterpart of ``repro.obs``, stdlib only at import time (torch is touched
lazily, by the profiler hooks and the device clock):

  metrics.py    Counter / Gauge / Histogram (fixed log-spaced buckets) in a
                thread-safe ``MetricsRegistry``; ``snapshot()`` → plain
                dict, ``render_prometheus()`` → text exposition format.
  trace.py      ``now()`` — the serving clock; ``sync_device`` (a solve is
                timed to the end of its stream's work); ``span()``, the
                port's one instrumentation call: spans with ids, parent
                ids and the ``batch`` / ``request_id`` link tags in a ring
                buffer (``Tracer.dropped``, ``Tracer.reserve``), mapped
                onto the profiler's clock by ``Tracer.unix_ns``, and named
                on ``start_profiling``'s trace (``record_function`` plus
                NVTX); ``SolveTelemetry`` per-request records; the
                kernel-path relay (``record_dispatch`` /
                ``consume_dispatch`` with the plain ``dispatch_counts`` /
                ``fallback_counts``).
  profiling.py  ``start_profiling()`` / ``stop_profiling()``: a
                ``torch.profiler`` trace of every thread.
  export.py     ``write_metrics_json`` and the stdlib ``http.server``
                Prometheus scrape endpoint (``start_metrics_server``).

Kill switch: ``REPRO_OBS_DISABLED=1`` makes every hook a no-op
(``set_enabled`` flips it at runtime).  The relay's plain counters count
either way.
"""
from repro_torch.obs.export import (MetricsServer, start_metrics_server,
                                    write_metrics_json)
from repro_torch.obs.metrics import (COUNT_BUCKETS, LATENCY_BUCKETS, Counter,
                                     Gauge, Histogram, MetricsRegistry,
                                     default_registry, enabled, log_buckets,
                                     set_enabled)
from repro_torch.obs.profiling import (all_threads_config,
                                       profiling_active, start_profiling,
                                       stop_profiling)
from repro_torch.obs.trace import (SolveTelemetry, SpanRecord, Tracer,
                                   consume_dispatch, dispatch_counts,
                                   fallback_counts, get_tracer, now,
                                   record_dispatch, reset_counters,
                                   self_seconds, span, sync_device)

__all__ = [
    "COUNT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "MetricsRegistry",
    "MetricsServer",
    "SolveTelemetry",
    "SpanRecord",
    "Tracer",
    "all_threads_config",
    "consume_dispatch",
    "default_registry",
    "dispatch_counts",
    "enabled",
    "fallback_counts",
    "get_tracer",
    "log_buckets",
    "now",
    "profiling_active",
    "record_dispatch",
    "reset_counters",
    "self_seconds",
    "set_enabled",
    "span",
    "start_metrics_server",
    "start_profiling",
    "stop_profiling",
    "sync_device",
    "write_metrics_json",
]
