"""Minimal stdlib client for the prediction server.

Holds one persistent keep-alive connection per instance (HTTP/1.1;
reconnects transparently if the server closed an idle socket) and can
request the binary tensor transport (``binary=True``): raw float32
frames instead of the JSON round-trip of the K x T x 2 trajectory
tensor. The port's own copy of ``multiverse_tpu/serving/client.py``;
it talks to either package's server.

Error contract: non-200 responses raise ``urllib.error.HTTPError``
with ``.code`` set, exactly like the urllib-based client this replaces.
"""

from __future__ import annotations

import http.client
import io
import json
import urllib.error
from typing import Optional

import numpy as np

from multiverse_torch.serving.wire import (
    TENSOR_CONTENT_TYPE,
    parse_tensor_frame,
)


class PredictionClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8500,
                 timeout: float = 30.0, binary: bool = False):
        self.host, self.port = host, int(port)
        self.timeout = timeout
        self.binary = binary
        self._conn: Optional[http.client.HTTPConnection] = None

    # --------------------------------------------------------- plumbing

    def close(self):
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def _roundtrip(self, method: str, path: str, body=None,
                   headers=None):
        """One request over the persistent connection.

        A keep-alive socket the server has since closed surfaces as a
        connection-level error on the NEXT request — retry once on a
        fresh connection; errors on the retry propagate.

        Retry scope: a stale idle keep-alive only exists on a REUSED
        connection, so a non-idempotent POST is retried only when the
        failed attempt reused one.  On a fresh connection the same
        error means the server died mid-request — re-sending could
        enqueue a prediction the engine already admitted (and, under
        --max_queue backpressure, burn a slot during exactly the
        failure windows it protects).  GETs (health/stats) are
        idempotent and always retry once."""
        for attempt in (0, 1):
            reused = self._conn is not None
            try:
                if self._conn is None:
                    self._conn = http.client.HTTPConnection(
                        self.host, self.port, timeout=self.timeout)
                self._conn.request(method, path, body=body,
                                   headers=headers or {})
                resp = self._conn.getresponse()
                data = resp.read()  # fully drain: keeps the conn reusable
                if resp.will_close:
                    self.close()
                return resp.status, resp.getheader("Content-Type", ""), \
                    data
            except TimeoutError:
                # the server is slow, not the socket stale — retrying
                # would double the wait AND enqueue the prediction twice
                # on an already-saturated engine
                self.close()
                raise
            except (http.client.HTTPException, ConnectionError,
                    BrokenPipeError, OSError):
                self.close()
                if attempt or not (reused or method == "GET"):
                    raise

    def _check(self, status: int, path: str, data: bytes):
        if status != 200:
            raise urllib.error.HTTPError(
                f"http://{self.host}:{self.port}{path}", status,
                data.decode(errors="replace"), None, io.BytesIO(data))

    def _get(self, path: str) -> dict:
        status, _, data = self._roundtrip("GET", path)
        self._check(status, path, data)
        return json.loads(data)

    # -------------------------------------------------------------- API

    def healthy(self) -> bool:
        try:
            return bool(self._get("/healthz").get("ok"))
        except OSError:
            return False

    def stats(self) -> dict:
        return self._get("/stats")

    def predict(
        self,
        obs_traj,
        scene_class_map=None,
        pred_len: Optional[int] = None,
        binary: Optional[bool] = None,
    ) -> dict:
        """Returns {"trajs": [K][T][2], "logprobs": [K], "pred_len": T}
        with numpy arrays for the array fields."""
        payload = {"obs_traj": np.asarray(obs_traj).tolist()}
        if scene_class_map is not None:
            payload["scene_class_map"] = np.asarray(
                scene_class_map).tolist()
        if pred_len is not None:
            payload["pred_len"] = int(pred_len)
        headers = {"Content-Type": "application/json"}
        if self.binary if binary is None else binary:
            headers["Accept"] = TENSOR_CONTENT_TYPE
        status, ctype, data = self._roundtrip(
            "POST", "/v1/predict", body=json.dumps(payload).encode(),
            headers=headers)
        self._check(status, "/v1/predict", data)
        if ctype.startswith(TENSOR_CONTENT_TYPE):
            return parse_tensor_frame(data)
        out = json.loads(data)
        out["trajs"] = np.asarray(out["trajs"], np.float32)
        out["logprobs"] = np.asarray(out["logprobs"], np.float32)
        return out
