"""The benchmark's own spans and its reading of the profiler's trace.

Spans go around the harness's calls into the program's layers; each
records its host time always, and in a traced run also a
``torch.profiler.record_function`` range named ``mvbench.<span>``, so
that the trace can say what the host was doing while the device idled.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

PREFIX = "mvbench."


class Spans:
    """Host time and count of each named span."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(PREFIX + name) \
            if self.annotate else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def wrap(self, module, attr: str, name: str):
        """Put a span around every call of ``module.attr`` (a function
        the program looks up at call time); returns an undo."""
        fn = getattr(module, attr)

        def spanned(*a, **kw):
            with self(name):
                return fn(*a, **kw)

        setattr(module, attr, spanned)
        return lambda: setattr(module, attr, fn)


def _times(e) -> Tuple[float, float]:
    """(start, end) of a kineto event in seconds."""
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s * 1e-9, (s + e.duration_ns()) * 1e-9
    s = e.start_us()
    return s * 1e-6, (s + e.duration_us()) * 1e-6


class Trace:
    """What a profiled window holds: each device operation's interval
    and name, and the benchmark's spans."""

    def __init__(self, prof):
        self.device: List[Tuple[float, float, str]] = []
        self.spans: List[Tuple[float, float, str]] = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            on_device = str(e.device_type()).endswith("CUDA")
            if name.startswith(PREFIX):
                # a span: its host range (the profiler also mirrors it
                # on the device's timeline, which is no operation)
                if not on_device:
                    s, t = _times(e)
                    self.spans.append((s, t, name[len(PREFIX):]))
            elif on_device:
                s, t = _times(e)
                self.device.append((s, t, name))
        window = [sp for sp in self.spans if sp[2] == "window"]
        if window:
            self.t0, self.t1 = window[0][0], window[0][1]
        elif self.device:
            self.t0 = min(d[0] for d in self.device)
            self.t1 = max(d[1] for d in self.device)
        else:
            self.t0 = self.t1 = 0.0
        self.device.sort()

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for s, t, _ in self.device:
            s, t = max(s, self.t0), min(t, self.t1)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], t))
            else:
                out.append((s, t))
        return out

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals())

    def kernel_seconds(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``needles``."""
        return sum(t - s for s, t, n in self.device
                   if any(x in n for x in needles))

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for s, t, n in self.device:
            by[n] += t - s
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle device time inside the window by the innermost span
        open when each gap began; the largest ``k`` sums."""
        spans = sorted(sp for sp in self.spans if sp[2] != "window")
        by: Dict[str, float] = defaultdict(float)
        active: List[Tuple[float, float, str]] = []
        nxt = 0
        at = self.t0
        for s, t in self.busy_intervals() + [(self.t1, self.t1)]:
            if s > at:
                while nxt < len(spans) and spans[nxt][0] <= at:
                    active.append(spans[nxt])
                    nxt += 1
                active = [sp for sp in active if sp[1] > at]
                name = max(active)[2] if active else "outside spans"
                by[name] += s - at
            at = max(at, t)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:k]]


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)
