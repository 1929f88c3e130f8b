"""repro_torch.obs — telemetry for the port's solver-serving stack.

Counterpart of ``repro.obs``, stdlib only at import time (torch is touched
lazily, by the profiler hooks and the device clock):

  metrics.py    Counter / Gauge / Histogram (fixed log-spaced buckets) in a
                thread-safe ``MetricsRegistry``; ``snapshot()`` → plain
                dict, ``render_prometheus()`` → text exposition format.
  trace.py      ``now()`` — the serving clock; ``sync_device`` (a solve is
                timed to the end of its stream's work); ``span()`` tracing
                into a ring buffer + optional JSONL sink;
                ``SolveTelemetry`` per-request records; the kernel-path
                relay (``record_dispatch`` / ``consume_dispatch`` with the
                plain ``dispatch_counts`` / ``fallback_counts``).
  profiling.py  ``profile_region()`` / ``start_profiling()`` over
                ``torch.profiler`` and NVTX ranges.
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
from repro_torch.obs.profiling import (profile_region, profiling_active,
                                       start_profiling, stop_profiling)
from repro_torch.obs.trace import (SolveTelemetry, SpanRecord, Tracer,
                                   consume_dispatch, dispatch_counts,
                                   fallback_counts, get_tracer, now,
                                   record_dispatch, reset_counters, span,
                                   sync_device)

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
    "consume_dispatch",
    "default_registry",
    "dispatch_counts",
    "enabled",
    "fallback_counts",
    "get_tracer",
    "log_buckets",
    "now",
    "profile_region",
    "profiling_active",
    "record_dispatch",
    "reset_counters",
    "set_enabled",
    "span",
    "start_metrics_server",
    "start_profiling",
    "stop_profiling",
    "sync_device",
    "write_metrics_json",
]
