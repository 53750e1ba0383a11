"""HTTP front end of the micro-batching enhancement server.

Standard library only (``http.server``): each worker thread parses one
request, decodes the image bytes, submits them to the shared
:class:`~serving.EnhanceServer` (which owns the device and batches
concurrent requests), and encodes the result in the request's own format.
N requests in flight become device batches of up to ``max_batch``.

Endpoints:
  * ``POST /enhance``: body JPEG/PNG bytes; response the enhanced image in
    the same format (PNG in, PNG out; JPEG in, JPEG out where PIL is
    present, else 400 since it cannot be decoded). 400 on an undecodable
    body, 503 when the server is saturated (``overflow='reject'``), 500
    when the backend fails.
  * ``GET /healthz``: 200 ``ok``.
  * ``GET /stats``: JSON request counts by status and the p50/p99 enhance
    latency over a ring of recent requests, and under ``server`` the
    batching server's counters (``EnhanceServer.stats``).

The port of the JAX package's ``http_server.py``.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.io.codec import (
    decode_image,
    encode_image,
)
from low_light_image_enhancement_tpu_torch.serving import (
    EnhanceServer,
    ServerSaturated,
)

# request bodies above this are rejected before decode (a 16K x 16K RGB
# PNG is ~1 GB decoded): the bound protects host memory
MAX_BODY_BYTES = 64 * 1024 * 1024


def _sniff(body: bytes):
    """(codec format name, content type) from the container's magic bytes,
    or None."""
    if body[:4] == b"\x89PNG":
        return "PNG", "image/png"
    if body[:2] == b"\xff\xd8":
        return "JPEG", "image/jpeg"
    return None


class _Stats:
    """Request counts by status and a ring of the last ``maxlen`` enhance
    latencies, under a lock."""

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self.by_status: dict = {}
        self._lat = collections.deque(maxlen=maxlen)

    def record(self, status: int, latency_s: Optional[float] = None) -> None:
        with self._lock:
            self.by_status[status] = self.by_status.get(status, 0) + 1
            if latency_s is not None:
                self._lat.append(latency_s)

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            counts = dict(self.by_status)
        out = {"requests_by_status": counts,
               "requests_total": sum(counts.values())}
        if lat:
            out["enhance_latency_ms"] = {
                "p50": round(lat[len(lat) // 2] * 1e3, 3),
                "p99": round(lat[min(len(lat) - 1,
                                     int(len(lat) * 0.99))] * 1e3, 3),
                "window": len(lat),
            }
        return out


class _Handler(BaseHTTPRequestHandler):
    # set by HttpEnhanceServer: the shared EnhanceServer and the stats
    enhance_server: EnhanceServer = None
    stats: _Stats = None
    protocol_version = "HTTP/1.1"
    # Nagle's algorithm with delayed ACKs stalls small request/response
    # pairs by tens of ms
    disable_nagle_algorithm = True

    def log_message(self, *a):  # quiet: /stats carries the signal
        pass

    def _respond(self, code: int, body: bytes, ctype: str,
                 latency_s: Optional[float] = None) -> None:
        if self.stats is not None:
            self.stats.record(code, latency_s)
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - http.server API
        if self.path == "/healthz":
            self._respond(200, b"ok", "text/plain")
        elif self.path == "/stats":
            body = json.dumps({**self.stats.snapshot(),
                               "server": self.enhance_server.stats()}
                              ).encode()
            self._respond(200, body, "application/json")
        else:
            self._respond(404, b"not found", "text/plain")

    def do_POST(self):  # noqa: N802 - http.server API
        try:
            n = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            n = 0
        if self.path != "/enhance":
            # an unread body would desync this keep-alive connection
            self.close_connection = True
            self._respond(404, b"not found", "text/plain")
            return
        if n <= 0 or n > MAX_BODY_BYTES:
            self.close_connection = True
            self._respond(400, b"Content-Length required (bounded)",
                          "text/plain")
            return
        body = self.rfile.read(n)
        fmt = _sniff(body)
        if fmt is None:
            self._respond(400, b"body is not JPEG or PNG", "text/plain")
            return
        try:
            img = decode_image(body)
        except Exception:  # noqa: BLE001 - any decode failure is a 400
            self._respond(400, b"undecodable image", "text/plain")
            return
        t0 = time.monotonic()
        try:
            out = self.enhance_server.enhance(img)
        except ServerSaturated:
            self._respond(503, b"server saturated", "text/plain")
            return
        except Exception as e:  # noqa: BLE001 - any backend failure
            # (a close during shutdown, a kernel fault, a shape rejection)
            # still gets an HTTP response and a stats record
            self._respond(500, f"enhance failed: {e}".encode()[:512],
                          "text/plain")
            return
        self._respond(200, encode_image(out, format=fmt[0]), fmt[1],
                      latency_s=time.monotonic() - t0)


class HttpEnhanceServer:
    """A ThreadingHTTPServer bound to (host, port) over an EnhanceServer
    (made from ``config`` and ``server_kwargs``, ``device`` among them, when
    none is given). ``port=0`` binds a free port (read ``.port``)."""

    def __init__(
        self,
        config: PipelineConfig = PipelineConfig(),
        host: str = "127.0.0.1",
        port: int = 8000,
        enhance_server: Optional[EnhanceServer] = None,
        **server_kwargs,
    ):
        self._own_backend = enhance_server is None
        self.backend = enhance_server or EnhanceServer(config,
                                                       **server_kwargs)
        self.stats = _Stats()
        handler = type("Handler", (_Handler,),
                       {"enhance_server": self.backend, "stats": self.stats})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HttpEnhanceServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._own_backend:
            self.backend.close()
