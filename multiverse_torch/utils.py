"""Observability helpers of the port: the loss moving average, the
``torch.profiler`` trace scope (the port's copies of
``multiverse_tpu/utils.py``'s ``MovingAverage`` and ``profile_trace``),
and the program's span recorder.

Spans and counters are recorded only while a ``torch.profiler`` records
(``profile_trace`` opens one): off, ``span`` costs one flag test and
reads no clock. On, each span is stamped on the profiler's own clock, so
a reader can place it among the trace's device intervals, and also opens
a range in the profiler's trace. The recorder is one per process, as the
profiler is."""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _torch_profiler


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
    that writes a Chrome trace into ``logdir`` (``trace.json``) and the
    program's spans recorded in it (``spans.json``: each name's count,
    total and self seconds, the counters, the spans dropped); no-op
    when it is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset_spans()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    snap = span_snapshot()
    counters: dict = defaultdict(int)
    for c in snap["counters"]:
        counters[c.name] += c.value
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"spans": span_summary(snap["spans"]),
                   "counters": counters, "dropped": snap["dropped"]},
                  f, indent=1, sort_keys=True)


# ---------------------------------------------------------------- spans

# the monotonic clock every span reads (profiler time = this + an offset
# taken once when recording starts: wall time can step)
_clock = time.perf_counter_ns


def _clock_offset() -> int:
    """Unix-epoch ns less ``_clock`` ns: the tightest of three bracketed
    readings."""
    best = None
    for _ in range(3):
        p0 = _clock()
        wall = time.time_ns()
        p1 = _clock()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, wall - (p0 + p1) // 2)
    return best[1]


class SpanRecord(NamedTuple):
    name: str
    start_ns: int            # the profiler's clock (Unix epoch), ns
    end_ns: int
    id: int
    parent: Optional[int]    # the enclosing span on the same thread
    thread: int
    batch: Optional[int]     # shared by every span of one batch


class CounterRecord(NamedTuple):
    name: str
    t_ns: int                # the profiler's clock, ns
    value: int
    thread: int
    batch: Optional[int]


class SpanRecorder:
    """A bounded in-memory store of spans and counters; when full, each
    new record pushes out the oldest and counts as dropped."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.reset()

    def reset(self) -> None:
        """Empty the store; the clock's offset is taken anew at the next
        span recorded."""
        with self._lock:
            self._spans: deque = deque(maxlen=self.capacity)
            self._counters: deque = deque(maxlen=self.capacity)
            self._dropped = 0
            self._offset: Optional[int] = None

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def to_profiler_ns(self, t: int) -> int:
        """A ``_clock`` reading on the profiler's clock (Unix epoch ns,
        as ``torch.profiler`` stamps its events)."""
        if self._offset is None:
            with self._lock:
                if self._offset is None:
                    self._offset = _clock_offset()
        return t + self._offset

    def _add(self, store: deque, rec) -> None:
        with self._lock:
            if len(store) == self.capacity:
                self._dropped += 1
            store.append(rec)

    def add_span(self, sp: "Span") -> None:
        self._add(self._spans, SpanRecord(
            sp.name, self.to_profiler_ns(sp.start),
            self.to_profiler_ns(sp.end), sp.id, sp.parent,
            threading.get_ident(), sp.batch))

    def add_count(self, name: str, value: int) -> None:
        s = self.stack()
        self._add(self._counters, CounterRecord(
            name, self.to_profiler_ns(_clock()), value,
            threading.get_ident(), s[-1].batch if s else None))

    def snapshot(self) -> dict:
        """{"spans": [SpanRecord], "counters": [CounterRecord],
        "dropped": n}: a copy of the store."""
        with self._lock:
            return {"spans": list(self._spans),
                    "counters": list(self._counters),
                    "dropped": self._dropped}


_RECORDER = SpanRecorder()


class _Timed:
    """Host seconds between entry and exit (``start``, ``end``: ``_clock``
    readings)."""

    __slots__ = ("start", "end")
    batch = None

    def __enter__(self):
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.end = _clock()

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Span(_Timed):
    """One recorded span; also a range in the profiler's trace."""

    __slots__ = ("name", "batch", "id", "parent", "_range")

    def __init__(self, name: str, batch: Optional[int]):
        self.name = name
        self.batch = batch

    def __enter__(self):
        stack = _RECORDER.stack()
        outer = stack[-1] if stack else None
        self.id = next(_RECORDER._ids)
        self.parent = outer.id if outer is not None else None
        if self.batch is None:
            self.batch = outer.batch if outer is not None else self.id
        stack.append(self)
        self.start = _clock()
        # a plain (not a user-annotation) range: the profiler copies user
        # annotations onto the device's timeline, where a trace reader
        # would take them for device work
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(None, None, None)
        self.end = _clock()
        _RECORDER.stack().pop()
        _RECORDER.add_span(self)


class _Off:
    """What ``span`` returns while nothing records: no clock, no range."""

    __slots__ = ()
    batch = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def span(name: str, batch: Optional[int] = None, timed: bool = False):
    """A context manager for one span named ``name``. ``batch``: the
    batch it belongs to (default: the enclosing span's on this thread,
    else a new batch, the span's own id). With ``timed`` it keeps its
    host ``seconds`` even while nothing records (the caller's counter
    reads the same two clock readings as the span)."""
    if _torch_profiler._is_profiler_enabled:
        return Span(name, batch)
    return _Timed() if timed else _OFF


def count(name: str, value: int = 1) -> None:
    """Add ``value`` to the counter ``name`` at this moment, in the batch
    of this thread's innermost span; only while a profiler records."""
    if _torch_profiler._is_profiler_enabled:
        _RECORDER.add_count(name, value)


def span_snapshot() -> dict:
    """The recorder's contents (``SpanRecorder.snapshot``)."""
    return _RECORDER.snapshot()


def reset_spans() -> None:
    _RECORDER.reset()


def span_summary(spans) -> dict:
    """{name: {"count", "total_s", "self_s"}}: a span's self time is its
    duration less its children's."""
    inner: dict = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            inner[s.parent] += s.end_ns - s.start_ns
    out: dict = {}
    for s in spans:
        d = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        dur = s.end_ns - s.start_ns
        d["count"] += 1
        d["total_s"] += dur * 1e-9
        d["self_s"] += (dur - inner[s.id]) * 1e-9
    return out
