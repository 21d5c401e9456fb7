"""Stdlib-only threaded HTTP front end for the serving tier (≙
``mxnet_tpu/serve/server.py``; the same endpoints, codes and JSON).

Endpoints:

- ``POST /v1/predict`` — body ``{"model": name, "inputs": nested list}``
  (one item or a small batch); responds ``{"model", "outputs",
  "batched"}``.  Unknown model → 404; admission-control rejection
  (bounded queue full) → 429 with ``Retry-After``, shedding load
  instead of collapsing; deadline overrun → 504.
- ``GET /v1/models`` — registry inventory with per-model engine/batcher
  stats.
- ``GET /healthz`` — READINESS, not liveness: 200 only when every
  registered model's bucket ladder is precompiled and the replica is
  not draining; 503 with ``{"status": "warming"|"draining"}``
  otherwise.  The router (router.py) keys admission off this.
- ``GET /metrics`` — Prometheus text exposition via
  ``telemetry.dump_prometheus()`` (the ``serve.*`` section carries the
  SLA histograms the router scrapes for least-loaded weights).
- ``POST /admin/drain`` / ``POST /admin/undrain`` — replica lifecycle:
  draining sheds NEW predicts with 503 + Retry-After while queued work
  finishes, and flips ``/healthz`` so the router stops routing here.

429 (queue full) and 503 (draining) responses carry a ``Retry-After``
derived from the live queue depth × the batcher's EWMA per-item
service time, jittered so shed clients don't retry in lockstep.

``MXNET_SERVE_FAULT=server:...`` (faults.py) injects delay / error /
black-hole faults at this layer for chaos testing.

Nothing beyond ``http.server``/``json`` — the serving tier must not
grow dependencies the training image doesn't have.
"""
from __future__ import annotations

import json
import os
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as onp

from .. import telemetry as _telemetry
from . import faults as _faults
from .batcher import BatcherClosed, QueueFull, RequestError
from .registry import ModelRegistry

__all__ = ["InferenceServer"]


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog is 5: a burst of concurrent clients
    # connecting at once would see connection resets
    request_queue_size = 128

_MAX_BODY = 64 << 20


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    registry: ModelRegistry = None    # type: ignore[assignment]

    # silence per-request stderr lines; telemetry carries the rates
    def log_message(self, fmt, *args):
        pass

    def _reply(self, code: int, body, content_type="application/json",
               headers=None):
        raw = body if isinstance(body, bytes) else \
            json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(raw)

    def do_GET(self):
        _telemetry.counter_add("serve.http_requests")
        if self.path == "/healthz":
            draining = bool(getattr(self.server, "draining", False))
            models = self.registry.health()
            ready = not draining and all(
                s == "ready" for s in models.values())
            status = ("draining" if draining
                      else "ok" if ready else "warming")
            self._reply(200 if ready else 503,
                        {"status": status, "ready": ready,
                         "models": models})
        elif self.path == "/metrics":
            self._reply(200, _telemetry.dump_prometheus().encode(),
                        content_type="text/plain; version=0.0.4")
        elif self.path == "/v1/models":
            self._reply(200, self.registry.stats())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def _retry_after(self, batcher=None) -> str:
        if batcher is not None:
            return f"{batcher.retry_after_s():.3f}"
        # no batcher context (e.g. drain before model resolution):
        # jittered constant, same anti-lockstep property
        return f"{random.uniform(0.75, 1.25):.3f}"

    def do_POST(self):
        _telemetry.counter_add("serve.http_requests")
        # consume the body up front: replying on a keep-alive socket
        # with unread body bytes corrupts the NEXT request on the
        # connection (they get parsed as a request line)
        try:
            n = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            n = -1
        if n < 0 or n > _MAX_BODY:
            self.close_connection = True    # can't safely drain stream
            self._reply(400, {"error": f"bad Content-Length {n}"})
            return
        raw = self.rfile.read(n) if n else b""
        if self.path in ("/admin/drain", "/admin/undrain"):
            self.server.draining = self.path == "/admin/drain"
            queued = sum(
                m["batcher"]["queued_items"]
                for m in self.registry.stats()["models"].values())
            self._reply(200, {"status": "draining" if self.server.draining
                              else "ok", "queued_items": queued})
            return
        if self.path != "/v1/predict":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        fault = _faults.maybe("server")
        if fault is not None:
            mode, secs = fault
            if mode == "delay":
                _faults.apply_delay(secs)
            elif mode == "black_hole":
                # hold the socket, then drop it with no response: the
                # client sees a hang then a connection error — the
                # shape a router timeout/retry must absorb
                _faults.apply_delay(secs)
                self.close_connection = True
                return
            else:   # error
                self._reply(500,
                            {"error": "injected fault "
                                      "(MXNET_SERVE_FAULT)"})
                return
        if getattr(self.server, "draining", False):
            _telemetry.counter_add("serve.http_503_draining")
            self._reply(503, {"error": "replica is draining"},
                        headers={"Retry-After": self._retry_after()})
            return
        try:
            if not raw:
                raise ValueError("missing request body")
            req = json.loads(raw)
            model = req["model"]
            inputs = onp.asarray(req["inputs"])
        except (KeyError, ValueError, TypeError) as e:
            self._reply(400, {"error": f"bad request: {e}"})
            return
        # adopt the caller's trace context (router or any client that
        # sent X-MXNet-Trace) so this request's spans join its trace; no
        # header → this span roots a fresh trace
        trace_hdr = self.headers.get(_telemetry.TRACE_HEADER)
        try:
            with _telemetry.span("serve.request",
                                 parent=(trace_hdr or None), model=model):
                # a warm swap (publish) closes the old entry's batcher:
                # a request that met it closed goes to the new entry
                for attempt in range(2):
                    entry = self.registry.get(model)
                    try:
                        outs = entry.batcher.submit(inputs)
                        break
                    except BatcherClosed:
                        if attempt:
                            raise
        except KeyError as e:
            self._reply(404, {"error": str(e)})
            return
        except QueueFull as e:
            _telemetry.counter_add("serve.http_429")
            self._reply(429, {"error": f"overloaded: {e}"},
                        headers={"Retry-After":
                                 self._retry_after(entry.batcher)})
            return
        except TimeoutError as e:
            self._reply(504, {"error": str(e)})
            return
        except (ValueError, RequestError, BatcherClosed) as e:
            self._reply(400 if isinstance(e, ValueError) else 500,
                        {"error": str(e)})
            return
        self._reply(200, {
            "model": model,
            "outputs": [o.tolist() for o in outs],
            "batched": bool(inputs.ndim > len(entry.engine.item_shape)),
        })


class InferenceServer:
    """Threaded HTTP server over a :class:`ModelRegistry`.

    ``port=0`` binds an ephemeral port (read it back from ``.port``
    after :meth:`start`) — the tests' localhost round-trip mode.
    """

    def __init__(self, registry: ModelRegistry,
                 host: Optional[str] = None, port: Optional[int] = None):
        self.registry = registry
        self.host = host if host is not None else \
            os.environ.get("MXNET_SERVE_HOST", "127.0.0.1")
        if port is None:
            port = int(os.environ.get("MXNET_SERVE_PORT", "8080"))
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": registry})
        self._httpd = _HTTPServer((self.host, int(port)), handler)
        self._httpd.daemon_threads = True
        # drain flag lives on the httpd instance so every handler
        # thread sees it via self.server (no globals, per-server state)
        self._httpd.draining = False
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def draining(self) -> bool:
        return bool(self._httpd.draining)

    def drain(self):
        """Stop admitting new predicts (503 + Retry-After); queued work
        keeps draining through the batchers; ``/healthz`` flips to
        ``draining`` so a router stops routing here."""
        self._httpd.draining = True
        return self

    def undrain(self):
        self._httpd.draining = False
        return self

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"serve-http-{self.port}", daemon=True)
        self._thread.start()
        return self

    def stop(self, close_registry: bool = False):
        """Stop accepting, join the acceptor thread, release the socket;
        optionally drain and close the registry too."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(10.0)
            self._thread = None
        self._httpd.server_close()
        if close_registry:
            self.registry.close()

    def serve_forever(self):
        """Foreground mode for `python -m mxnet_tpu_torch.serve`."""
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop(close_registry=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
