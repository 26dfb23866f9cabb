"""Tiny threaded HTTP server exposing ``/healthz`` and ``/metrics``.

Serves the :mod:`repro_torch.obs.meters` registry snapshot as JSON.  Stdlib
only (``http.server`` in a daemon thread), binds port 0 on request so
tests never collide, and shuts down cleanly via ``stop()``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.obs.meters import MetricsRegistry, get_registry


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry  # set on the server class at start

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload, indent=2).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0]
        try:
            if path == "/healthz":
                snap = self.server.registry.snapshot()  # type: ignore[attr-defined]
                self._send(200, {"status": "ok",
                                 "uptime_s": snap["uptime_s"]})
            elif path == "/metrics":
                snap = self.server.registry.snapshot()  # type: ignore[attr-defined]
                self._send(200, snap)
            else:
                self._send(404, {"error": f"no route {path}"})
        except Exception as e:  # noqa: BLE001 — endpoint must not crash server
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, fmt, *args) -> None:  # silence per-request stderr
        pass


class ObsHTTPServer:
    """Background /healthz + /metrics server over a metrics registry."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.registry = registry or get_registry()  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"obs-http:{self.port}")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
