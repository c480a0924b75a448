"""Event-loop HTTP front end for the serving engine (stdlib asyncio).

The threaded front end (:mod:`multiverse_torch.serving.server`) spawns
one handler thread per connection; under many concurrent clients those
threads spend their time in GIL and scheduler churn. This server
replaces all of them with ONE event loop:

* minimal HTTP/1.1 parsing over asyncio streams, keep-alive by
  default, Content-Length framing both ways;
* the same endpoints and wire formats as the threaded server
  (`POST /v1/predict` JSON in; JSON or the binary
  ``application/x-mvt-tensor`` frame out; `GET /healthz`, `/stats`);
* engine integration without waiter threads: ``ServingEngine.submit``
  takes an ``on_done`` hook, bridged to an ``asyncio.Future`` via
  ``loop.call_soon_threadsafe`` — the loop never blocks on the device,
  and the engine's batcher/resolver threads never touch sockets.

The port's own copy of ``multiverse_tpu/serving/aserver.py``.
"""

from __future__ import annotations

import asyncio
import json
import threading
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

_MAX_BODY = 64 * 1024 * 1024


def _json_response(code: int, payload: dict, keep_alive: bool,
                   extra_headers: Optional[dict] = None) -> bytes:
    body = json.dumps(payload).encode()
    return _raw_response(code, "application/json", body, keep_alive,
                         extra_headers)


def _raw_response(code: int, ctype: str, body: bytes,
                  keep_alive: bool,
                  extra_headers: Optional[dict] = None) -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              500: "Internal Server Error",
              503: "Service Unavailable"}.get(code, "Error")
    extras = "".join(f"{k}: {v}\r\n"
                     for k, v in (extra_headers or {}).items())
    head = (f"HTTP/1.1 {code} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{extras}"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            f"\r\n").encode()
    return head + body


class AsyncPredictionServer:
    """Single-event-loop HTTP server owning a ServingEngine.

    Same construction surface as :class:`PredictionServer`:
    ``start_background()`` / ``serve_forever()`` / ``close()`` and a
    ``.port`` attribute bound before traffic starts.
    """

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 8500):
        self.engine = engine
        self.host, self._port_req = host, port
        self.port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stopped = threading.Event()

    # ------------------------------------------------------ lifecycle

    def start_background(self):
        self._thread = threading.Thread(
            target=self._run, name="mvt-serving-aio", daemon=True)
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("asyncio server failed to start")

    def serve_forever(self):
        self._run()

    def wait(self):
        """Block until the background server stops (Ctrl-C to exit)."""
        if self._thread is not None:
            self._thread.join()

    def _run(self):
        asyncio.run(self._main())

    async def _main(self):
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self._port_req,
            backlog=2048)
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        try:
            async with self._server:
                await self._server.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            self._stopped.set()

    def close(self, close_engine: bool = True):
        if self._loop is not None and not self._stopped.is_set():
            def _shutdown():
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()
            try:
                self._loop.call_soon_threadsafe(_shutdown)
            except RuntimeError:
                pass   # loop stopped between the check and the call
            self._stopped.wait(5)
        if self._thread is not None:
            self._thread.join(timeout=5)
        if close_engine:
            self.engine.close()

    # ----------------------------------------------------- connection

    async def _reject_and_discard(self, reader, writer, payload: dict):
        """Queue a 400 and best-effort drain the unread request bytes:
        closing with data pending in the kernel receive buffer can RST
        the socket and destroy the response we just wrote, so the
        client would see ECONNRESET instead of the 400."""
        writer.write(_json_response(400, payload, False))
        try:
            await writer.drain()
            budget = 1 << 20
            while budget > 0:
                chunk = await asyncio.wait_for(
                    reader.read(65536), timeout=0.25)
                if not chunk:
                    break
                budget -= len(chunk)
        except (asyncio.TimeoutError, ConnectionError, OSError,
                ValueError):
            pass

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        blank_lines = 0
        try:
            while True:
                try:
                    request_line = await reader.readline()
                except ConnectionError:
                    break
                except ValueError:
                    # readline() raises ValueError when no newline
                    # arrives within the stream's 64 KB line limit
                    # (it converts LimitOverrunError internally) —
                    # same abuse case as an overlong header line, so
                    # same answer: 400 and close (the rest of the
                    # stream is unframed garbage)
                    await self._reject_and_discard(
                        reader, writer,
                        {"error": "request line too long"})
                    break
                if not request_line:
                    break
                if request_line in (b"\r\n", b"\n"):
                    # RFC 7230 §3.5: tolerate blank line(s) between
                    # keep-alive requests (legacy clients send a
                    # trailing CRLF after the body) — bounded so a
                    # blank-line flood cannot spin the loop
                    blank_lines += 1
                    if blank_lines > 16:
                        break
                    continue
                blank_lines = 0
                parts = request_line.decode("latin-1").split()
                if len(parts) < 2:
                    break
                method, path = parts[0], parts[1]
                headers = {}
                n_header_lines = 0
                try:
                    while True:
                        line = await reader.readline()
                        if line in (b"\r\n", b"\n", b""):
                            break
                        # bound header COUNT inside the loop: distinct
                        # keys would otherwise grow `headers` without
                        # limit on an abusive stream that never sends
                        # the blank line
                        n_header_lines += 1
                        if n_header_lines > 256:
                            raise ValueError("too many header lines")
                        k, _, v = line.decode("latin-1").partition(":")
                        headers[k.strip().lower()] = v.strip()
                except ValueError:
                    # a header line beyond the stream's 64 KB line
                    # limit (or past the count bound) — reject rather
                    # than die with an unhandled task exception (the
                    # rest of the stream is unframed garbage, so close
                    # the connection)
                    await self._reject_and_discard(
                        reader, writer, {"error": "bad headers"})
                    break
                if "transfer-encoding" in headers:
                    # only Content-Length framing is supported; parsing
                    # a chunked body as length-0 would leave the chunks
                    # in the stream and desync keep-alive framing
                    await self._reject_and_discard(
                        reader, writer,
                        {"error": "transfer-encoding unsupported"})
                    break
                try:
                    length = int(headers.get("content-length", "0"))
                except ValueError:
                    length = -1
                if not 0 <= length <= _MAX_BODY:
                    await self._reject_and_discard(
                        reader, writer, {"error": "bad content-length"})
                    break
                body = await reader.readexactly(length) if length else b""
                keep = headers.get("connection", "keep-alive"
                                   ).lower() != "close"
                resp = await self._dispatch(method, path, headers, body,
                                            keep)
                writer.write(resp)
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _dispatch(self, method: str, path: str, headers: dict,
                        body: bytes, keep: bool) -> bytes:
        if method == "GET" and path == "/healthz":
            return _json_response(200, {"ok": True}, keep)
        if method == "GET" and path == "/stats":
            return _json_response(200, self.engine.stats.snapshot(),
                                  keep)
        if method != "POST" or path != "/v1/predict":
            return _json_response(404, {"error": "not found"}, keep)
        # the 400 arm wraps ONLY the synchronous request-parse/submit
        # phase: a KeyError/ValueError/TypeError here is the client's
        # input.  An asynchronous failure (pending.error, set by the
        # engine's _fail on a batch that died in the device step) is a
        # SERVER fault on a request that already passed validation —
        # it must be a 500 even when the underlying exception type is
        # ValueError/TypeError (device errors often are), or clients
        # treat an outage as their own bad input and never retry.
        try:
            req = json.loads(body)
            obs = np.asarray(req["obs_traj"], np.float32)
            scene = req.get("scene_class_map")
            if scene is not None:
                scene = np.asarray(scene)

            fut = self._loop.create_future()

            def on_done(pending, loop=self._loop):
                loop.call_soon_threadsafe(
                    lambda: fut.cancelled() or fut.set_result(pending))
            # submit never blocks (queue put); the loop awaits the
            # engine's completion hook instead of a waiter thread
            self.engine.submit(obs, scene_class_map=scene,
                               pred_len=req.get("pred_len"),
                               on_done=on_done)
        except (KeyError, ValueError, TypeError) as exc:
            return _json_response(400, {"error": str(exc)}, keep)
        except EngineOverloadedError as exc:
            # bounded-queue backpressure: one batch's worth of time is
            # the natural retry hint (fixed batch shape = known cost)
            return _json_response(503, {"error": str(exc)}, keep,
                                  extra_headers={"Retry-After": "1"})
        except Exception as exc:
            return _json_response(500, {"error": str(exc)}, keep)
        try:
            pending = await fut
            if pending.error is not None:
                return _json_response(
                    500, {"error": str(pending.error)}, keep)
            result = pending.result
            if TENSOR_CONTENT_TYPE in headers.get("accept", ""):
                return _raw_response(200, TENSOR_CONTENT_TYPE,
                                     build_tensor_frame(result), keep)
            return _json_response(200, {
                "trajs": result.trajs.tolist(),
                "logprobs": result.logprobs.tolist(),
                "pred_len": result.pred_len,
            }, keep)
        except Exception as exc:  # response assembly / await failure
            return _json_response(500, {"error": str(exc)}, keep)
