"""HTTP front for the serve engine: predict + health + metrics.

The port's copy of ``tpuframe/serve/server.py``: a stdlib
``ThreadingHTTPServer`` over :class:`~tpuframe_torch.serve.engine.
ServeEngine`.  Endpoints:

- ``POST /predict`` — body is an ``.npy`` blob (``np.save`` of one request
  payload).  Optional header ``X-Deadline-Ms`` propagates the client
  deadline into scheduling; optional ``X-Trace-Id`` (sanitized at the door)
  arms per-hop request tracing and is echoed back.  The admission verdict
  is the HTTP status: 200 served (JSON ``{"output": [...], "latency_ms":
  ...}``), 400 invalid payload, 413 oversized body, 429 shed/rejected under
  load, 503 draining, 504 timed out.  429/503 carry a ``Retry-After``
  header of roughly one queue-drain.
- ``GET /healthz`` — ``{"status": "ok"|"draining", "draining": bool,
  "queue_depth": N}``.
- ``GET /metrics`` — Prometheus text from the process registry.

:meth:`ServingServer.run_forever` blocks until a preemption notice
(SIGTERM, or a request on the process-wide watcher), then drains the
engine and closes the server.
"""

from __future__ import annotations

import io
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from tpuframe_torch.serve.admission import (
    InvalidRequest,
    RequestRejected,
    RequestShed,
    sanitize_trace_id,
)
from tpuframe_torch.track.telemetry import get_telemetry

__all__ = ["ServingServer"]


class ServingServer:
    """Serve ``engine`` over HTTP from a daemon thread.

    ``port=0`` picks a free port; read it back from ``.port``/``.url``.
    """

    def __init__(self, engine: Any, *, host: str = "127.0.0.1", port: int = 0,
                 result_timeout_s: float = 60.0):
        self.engine = engine
        self.result_timeout_s = float(result_timeout_s)
        # one request payload, exactly: item bytes + .npy header slack
        item = np.zeros(engine.item_shape, engine.dtype)
        self.max_body_bytes = int(item.nbytes) + 4096
        tele = get_telemetry()
        registry = tele.registry
        server_self = self

        class _Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, obj: dict,
                      headers: dict | None = None) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?")[0]
                if path == "/metrics":
                    body = registry.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/healthz":
                    eng = server_self.engine
                    self._send(200, {
                        "status": "draining" if eng.draining else "ok",
                        "draining": bool(eng.draining),
                        "queue_depth": eng.queue_depth(),
                    })
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] != "/predict":
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length") or 0)
                # transport-level size door: the body is bounded by the
                # engine's fixed request signature BEFORE any read/parse
                # allocates it — a declared 16 GB Content-Length must
                # not OOM the box on its way to validate_payload
                if not 0 < n <= server_self.max_body_bytes:
                    self._send(413, {
                        "error": f"body must be 1..{server_self.max_body_bytes}"
                                 " bytes (one .npy request payload)",
                        "verdict": "invalid",
                    })
                    return
                raw = self.rfile.read(n)
                try:
                    payload = np.load(io.BytesIO(raw), allow_pickle=False)
                except Exception:
                    self._send(400, {"error": "body must be an .npy blob "
                                              "(np.save of one payload)"})
                    return
                deadline = self.headers.get("X-Deadline-Ms")
                try:
                    deadline_ms = float(deadline) if deadline else None
                except ValueError:
                    deadline_ms = None
                trace = sanitize_trace_id(self.headers.get("X-Trace-Id"))
                thdrs = {"X-Trace-Id": trace} if trace is not None else None
                try:
                    res = server_self.engine.submit(
                        payload, deadline_ms=deadline_ms, trace=trace)
                    out = res.result(timeout=server_self.result_timeout_s)
                except InvalidRequest as e:
                    self._send(400, {"error": str(e), "verdict": "invalid"},
                               headers=thdrs)
                except RequestRejected as e:
                    code = 503 if e.verdict == "rejected-draining" else 429
                    self._send(code, {"error": str(e), "verdict": e.verdict},
                               headers={**server_self._retry_after(),
                                        **(thdrs or {})})
                except RequestShed as e:
                    self._send(429, {"error": str(e), "verdict": e.verdict},
                               headers={**server_self._retry_after(),
                                        **(thdrs or {})})
                except TimeoutError as e:
                    self._send(504, {"error": str(e), "verdict": "timeout"},
                               headers=thdrs)
                else:
                    doc = {
                        "output": out.tolist(),
                        "latency_ms": round((res.latency_s or 0.0) * 1e3, 3),
                        "verdict": res.verdict,
                    }
                    if trace is not None:
                        # the final hop: serialization + socket write
                        with tele.span("serve/respond", trace=trace):
                            self._send(200, doc, headers=thdrs)
                    else:
                        self._send(200, doc)

            def log_message(self, *args):  # requests must not spam stderr
                pass

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="tpuframe-torch-serve-http", daemon=True,
        )
        self._thread.start()

    def _retry_after(self) -> dict:
        """``Retry-After`` for a shedding/draining reply: roughly one
        queue-drain from now — queued items over the largest batch shape,
        one batch wait each — clamped to [1, 30] s.  An estimate to space
        client retries out, not a promise of capacity."""
        eng = self.engine
        batches = math.ceil(max(1, eng.queue_depth()) / max(eng.buckets))
        wait_s = batches * (eng.knobs.batch_wait_ms / 1e3)
        return {"Retry-After": str(max(1, min(30, math.ceil(wait_s))))}

    def run_forever(self, poll_s: float = 0.25) -> None:
        """Block until a preemption notice, then drain gracefully: the
        engine rejects new requests and finishes the in-flight ones, and the
        HTTP server shuts down.  Installs the process-wide watcher."""
        from tpuframe_torch.fault import preempt

        watcher = preempt.install()
        while not watcher.wait(poll_s):
            pass
        self.engine.drain(reason=f"preempt:{watcher.reason}")
        self.close()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)
