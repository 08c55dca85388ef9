"""The validator client's own observability server: /metrics + /health.

The reference VC runs its own HTTP server for Prometheus scrapes
(lighthouse/validator_client/src/http_metrics/) separate from the
beacon node's — a VC on another host must be scrapable without reaching
through a BN:

  GET /metrics   Prometheus text exposition of the process registry
  GET /health    JSON liveness: key count, last duty slot, duty totals

Same stdlib ThreadingHTTPServer shape as http_api.server, deliberately
tiny: two read-only routes, no chain access, safe to run on any VC.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..common.metrics import REGISTRY


class _Handler(BaseHTTPRequestHandler):
    vc = None  # ValidatorClient | None, injected by the server class

    def log_message(self, *args):  # quiet
        pass

    def _send(self, status: int, body: bytes, content_type: str):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._send(200, REGISTRY.gather().encode(), "text/plain; version=0.0.4")
        elif path == "/health":
            vc = self.vc
            payload = {"status": "ok"}
            if vc is not None:
                payload["keys"] = len(vc.store.pubkeys())
                payload["last_duty_slot"] = vc.last_duty_slot
                payload["duties"] = dict(vc.duty_totals)
            body = json.dumps(payload).encode()
            self._send(200, body, "application/json")
        else:
            body = json.dumps({"code": 404, "message": "unknown endpoint"}).encode()
            self._send(404, body, "application/json")


class MetricsServer:
    """Owns the VC's observability socket + serving thread."""

    def __init__(self, vc=None, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundHandler", (_Handler,), {"vc": vc})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "MetricsServer":
        self.thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
