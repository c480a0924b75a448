"""HTTP front end for the serving engine (stdlib-only).

Endpoints:
    POST /v1/predict   {"obs_traj": [[x, y] * obs_len],
                        "scene_class_map": optional [SH][SW] or
                                           [T_obs][SH][SW] class ids,
                        "pred_len": optional int}
                    -> {"trajs": [K][T][2], "logprobs": [K],
                        "pred_len": T}
    GET  /healthz      -> {"ok": true}
    GET  /stats        -> engine counters (occupancy, latency, errors)

The handler threads only do JSON I/O; all device work funnels through
the engine's single batcher, so concurrent HTTP requests become one
padded device batch (see :mod:`multiverse_torch.serving.engine`). The
port's own copy of ``multiverse_tpu/serving/server.py``: the same
endpoints and wire formats.

Transport notes (these dominate serving cost on the host, not the
device):

* connections are **keep-alive** (HTTP/1.1 + Content-Length on every
  response), so closed-loop clients pay TCP setup once, not per
  request;
* a client sending ``Accept: application/x-mvt-tensor`` gets the
  prediction as a **binary frame** instead of JSON: one JSON header
  line (shape metadata) + raw little-endian float32 ``trajs`` bytes +
  ``logprobs`` bytes (:mod:`multiverse_torch.serving.wire`).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from multiverse_torch.serving.engine import (
    EngineOverloadedError,
    ServingEngine,
)
from multiverse_torch.serving.wire import (
    TENSOR_CONTENT_TYPE,
    build_tensor_frame,
)


def _make_handler(engine: ServingEngine):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1: keep-alive connections (every response carries
        # Content-Length, so persistence is safe)
        protocol_version = "HTTP/1.1"

        # quiet the default per-request stderr logging
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, payload: dict,
                  extra_headers: dict = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_tensor(self, result):
            """Binary frame (see :mod:`multiverse_torch.serving.wire`)."""
            body = build_tensor_frame(result)
            self.send_response(200)
            self.send_header("Content-Type", TENSOR_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                self._send(200, engine.stats.snapshot())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/predict":
                self._send(404, {"error": "not found"})
                return
            # body-framing guards, mirrored from the asyncio front end:
            # on a keep-alive connection an UNREAD body desyncs every
            # later request on the socket, so both rejects must also
            # close the connection
            if "chunked" in self.headers.get(
                    "Transfer-Encoding", "").lower():
                self._send(400, {"error": "chunked bodies unsupported"},
                           extra_headers={"Connection": "close"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length < 0:
                    raise ValueError(length)
            except ValueError:
                self._send(400, {"error": "bad Content-Length"},
                           extra_headers={"Connection": "close"})
                return
            try:
                req = json.loads(self.rfile.read(length))
                obs = np.asarray(req["obs_traj"], np.float32)
                scene = req.get("scene_class_map")
                if scene is not None:
                    scene = np.asarray(scene)
                result = engine.predict(
                    obs, scene_class_map=scene,
                    pred_len=req.get("pred_len"))
                if TENSOR_CONTENT_TYPE in \
                        self.headers.get("Accept", ""):
                    self._send_tensor(result)
                else:
                    self._send(200, {
                        "trajs": result.trajs.tolist(),
                        "logprobs": result.logprobs.tolist(),
                        "pred_len": result.pred_len,
                    })
            except (KeyError, ValueError, TypeError) as exc:
                self._send(400, {"error": str(exc)})
            except EngineOverloadedError as exc:
                # bounded-queue backpressure: one batch's worth of time
                # is the natural retry hint (fixed batch shape = known cost)
                self._send(503, {"error": str(exc)},
                           extra_headers={"Retry-After": "1"})
            except Exception as exc:  # engine/device failure
                self._send(500, {"error": str(exc)})

    return Handler


class _Server(ThreadingHTTPServer):
    # the stdlib default listen backlog of 5 refuses connections the
    # moment clients arrive in bursts — exactly the load a dynamic
    # batcher exists to absorb
    request_queue_size = 1024
    daemon_threads = True


class PredictionServer:
    """ThreadingHTTPServer wrapper owning a ServingEngine."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 8500):
        self.engine = engine
        self.httpd = _Server(
            (host, port), _make_handler(engine))
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start_background(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="mvt-serving-http",
            daemon=True)
        self._thread.start()

    def serve_forever(self):
        self.httpd.serve_forever()

    def close(self, close_engine: bool = True):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if close_engine:
            self.engine.close()
