"""Live metrics export: a background HTTP endpoint and a periodic JSONL loop
(``repro/obs/server.py``), stdlib only.

* ``MetricsServer``: a daemon-thread ``ThreadingHTTPServer`` on
  ``127.0.0.1`` exposing ``/metrics`` (Prometheus text exposition through
  ``obs.export.prometheus_text``), ``/metrics.json`` (the raw snapshot as
  JSON) and ``/healthz``.  Each request calls ``snapshot_fn()`` afresh, so
  a scrape costs one snapshot: one synchronization, the protocol
  ``telemetry()`` itself pays.  With ``snapshot_fn=engine.telemetry`` a
  scrape waits for the engine's lock while a decode graph is captured or
  replayed (``ServeEngine.telemetry``);
* ``SnapshotLogger``: a daemon thread appending one JSONL snapshot per
  ``interval_s`` through ``obs.export.append_jsonl``: the event log a
  deployment without a scraper tails.

Both are started by ``launch/serve.py`` (``--metrics-port``,
``--snapshot-every``) and are context managers, so tests and short jobs shut
them down deterministically.  Port 0 binds an ephemeral port (``.port``
reports the real one).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.obs.export import append_jsonl, prometheus_text

__all__ = ["MetricsServer", "SnapshotLogger"]


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return v.item()
    return v


class MetricsServer:
    """Serve live registry snapshots over HTTP from a daemon thread.

    ``snapshot_fn`` is typically ``engine.telemetry`` or
    ``registry.snapshot``; it runs on the HTTP thread per request and only
    reads host mirrors and device tensors (one pull).  Routes: ``/metrics`` (Prometheus
    text), ``/metrics.json`` (JSON object), ``/healthz`` (``ok``).
    Snapshot errors surface as HTTP 500 with the exception text rather
    than killing the thread."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Any]], *,
                 host: str = "127.0.0.1", port: int = 0,
                 prefix: str = "awrp"):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: N802 — stdlib name
                """Silence per-request stderr logging."""

            def _send(self, code: int, body: str, ctype: str) -> None:
                """Write one complete response."""
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 — stdlib name
                """Route ``/metrics`` / ``/metrics.json`` / ``/healthz``."""
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    self._send(200, "ok\n", "text/plain")
                    return
                if path not in ("/metrics", "/metrics.json"):
                    self._send(404, "not found\n", "text/plain")
                    return
                try:
                    snap = outer.snapshot_fn()
                    if path == "/metrics":
                        body = prometheus_text(snap, prefix=outer.prefix)
                        ctype = "text/plain; version=0.0.4"
                    else:
                        body = json.dumps(
                            {k: _jsonable(v) for k, v in snap.items()}
                        ) + "\n"
                        ctype = "application/json"
                except Exception as e:  # noqa: BLE001 — keep serving
                    self._send(500, f"snapshot error: {e}\n", "text/plain")
                    return
                self._send(200, body, ctype)

        self.snapshot_fn = snapshot_fn
        self.prefix = prefix
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        """The bound port (resolves ``port=0`` ephemeral binds)."""
        return self._httpd.server_address[1]

    def start(self) -> "MetricsServer":
        """Start serving on a daemon thread; idempotent."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="metrics-server", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Shut the server down and join its thread."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class SnapshotLogger:
    """Append one JSONL registry snapshot per ``interval_s`` from a
    daemon thread (``obs.export.append_jsonl`` — each line carries a
    ``ts`` and any ``extra`` fields).  ``stop()`` writes one final
    snapshot so short runs always log at least one line; snapshot errors
    are counted (``.errors``) and skipped, never fatal."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Any]],
                 path: str, *, interval_s: float = 10.0,
                 extra: Optional[Dict[str, Any]] = None):
        self.snapshot_fn = snapshot_fn
        self.path = str(path)
        self.interval_s = float(interval_s)
        self.extra = dict(extra or {})
        self.lines = 0
        self.errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _write_once(self) -> None:
        try:
            append_jsonl(self.path, self.snapshot_fn(), extra=self.extra)
            self.lines += 1
        except Exception:  # noqa: BLE001 — logging must not kill serving
            self.errors += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write_once()

    def start(self) -> "SnapshotLogger":
        """Start the periodic loop on a daemon thread; idempotent."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="snapshot-logger", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop, join, and append one final snapshot."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None
        self._write_once()

    def __enter__(self) -> "SnapshotLogger":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
