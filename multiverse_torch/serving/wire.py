"""Binary tensor-frame wire format for prediction responses.

One frame = one JSON header line (tensor shapes + pred_len) followed by
raw little-endian float32 ``trajs`` bytes then ``logprobs`` bytes. Both
HTTP front ends speak this frame when the client sends
``Accept: application/x-mvt-tensor``; serialising the K x T x 2
trajectory tensor as JSON floats costs far more host CPU and bytes than
``ndarray.tobytes()``.

The port's own copy of ``multiverse_tpu/serving/wire.py``: the frame is
byte for byte the JAX package's, so a client of either server talks to
both. This module is the single owner of the format in the port: both
producers (:mod:`.server`, :mod:`.aserver`) and the consumer
(:mod:`.client`) build and parse through it.
"""

from __future__ import annotations

import json

import numpy as np

TENSOR_CONTENT_TYPE = "application/x-mvt-tensor"


def build_tensor_frame(result) -> bytes:
    """Encode a :class:`~.engine.PredictionResult` as one binary frame."""
    trajs = np.ascontiguousarray(result.trajs, np.float32)
    logprobs = np.ascontiguousarray(result.logprobs, np.float32)
    header = json.dumps({
        "trajs_shape": list(trajs.shape),
        "logprobs_shape": list(logprobs.shape),
        "pred_len": result.pred_len,
    }).encode() + b"\n"
    return header + trajs.tobytes() + logprobs.tobytes()


def parse_tensor_frame(data: bytes) -> dict:
    """Decode one frame.

    Returns ``{"trajs": [K,T,2] f32, "logprobs": [K] f32,
    "pred_len": int}`` — the same dict shape as the JSON response path.
    """
    nl = data.index(b"\n")
    head = json.loads(data[:nl])
    ts = tuple(head["trajs_shape"])
    n_traj = int(np.prod(ts))
    # copy out of the response buffer: np.frombuffer over (immutable)
    # bytes yields read-only views, but the JSON path returns writable
    # arrays and callers may mutate results in place — the K×T×2 copy
    # is a few KB
    trajs = np.frombuffer(
        data, np.float32, count=n_traj,
        offset=nl + 1).reshape(ts).copy()
    ls = tuple(head["logprobs_shape"])
    logprobs = np.frombuffer(
        data, np.float32, count=int(np.prod(ls)),
        offset=nl + 1 + n_traj * 4).reshape(ls).copy()
    return {"trajs": trajs, "logprobs": logprobs,
            "pred_len": head["pred_len"]}
