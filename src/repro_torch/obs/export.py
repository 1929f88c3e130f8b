"""Exporters — JSON snapshots and a Prometheus ``/metrics`` endpoint.

The port's own copy of ``repro.obs.export``.

Both read the same ``MetricsRegistry.snapshot()``, so a scraped dashboard
and an archived benchmark artifact can never disagree about what the engine
measured.

``start_metrics_server`` is stdlib ``http.server`` (ThreadingHTTPServer on
a daemon thread): no new dependencies, good enough for a scrape endpoint —
it serves

  * ``/metrics``       — Prometheus text exposition format,
  * ``/metrics.json``  — the snapshot as JSON,
  * ``/healthz``       — liveness probe.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry, default_registry


def write_metrics_json(path: str,
                       registry: Optional[MetricsRegistry] = None,
                       extra: Optional[dict] = None) -> dict:
    """Write ``registry.snapshot()`` (plus optional ``extra`` metadata under
    ``"meta"``) to ``path`` as JSON; returns the written document."""
    reg = registry or default_registry()
    doc = {"metrics": reg.snapshot()}
    if extra:
        doc["meta"] = extra
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    return doc


class MetricsServer:
    """Handle for a running scrape endpoint (``close()`` to stop)."""

    def __init__(self, registry: MetricsRegistry, host: str, port: int):
        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802  (http.server API)
                if self.path.split("?")[0] == "/metrics":
                    body = reg.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?")[0] == "/metrics.json":
                    body = json.dumps(reg.snapshot(), sort_keys=True).encode()
                    ctype = "application/json"
                elif self.path.split("?")[0] == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not access-log news
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]  # resolved (port=0 OK)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-http",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(port: int,
                         registry: Optional[MetricsRegistry] = None,
                         host: str = "0.0.0.0") -> MetricsServer:
    """Serve ``/metrics`` (+ ``/metrics.json``, ``/healthz``) on ``port``
    from a daemon thread.  ``port=0`` binds an ephemeral port (tests);
    read the resolved one off the returned handle."""
    return MetricsServer(registry or default_registry(), host, port)
