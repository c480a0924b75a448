"""Observability helpers of the port: the loss moving average and the
``torch.profiler`` trace scope (the port's copies of
``multiverse_tpu/utils.py``'s ``MovingAverage`` and ``profile_trace``)."""

from __future__ import annotations

import contextlib
import os
from collections import deque
from typing import Optional


class MovingAverage:
    """Fixed-window moving average (reference: code/pred_utils.py:310-331)."""

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("size must be positive")
        self._q = deque(maxlen=size)

    def put(self, val) -> None:
        if val is not None:
            self._q.append(float(val))

    def me(self) -> float:
        if not self._q:
            return 0.0
        return sum(self._q) / len(self._q)

    def __repr__(self) -> str:
        return "%.6f" % self.me()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """``torch.profiler`` scope (CPU, and CUDA when there is a card)
    that writes a Chrome trace into ``logdir``; no-op when it is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
