"""The program's own spans and counters in a traced window.

``multiverse_torch.utils`` records them while the profiler records,
stamped on the profiler's clock, so they sit among ``Trace.device``'s
intervals without any range of the profiler's. A reader keeps the spans
and counters that start inside ``[trace.t0, trace.t1]``. On a program
that records none (one that predates the recorder), every reading here
is None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Interval = Tuple[float, float]

# the enqueuing thread is the one that opens the decode's batches
ENQUEUER = "decode.batch"


def snapshot() -> Optional[dict]:
    try:
        from multiverse_torch.utils import span_snapshot
    except ImportError:
        return None
    return span_snapshot()


def in_window(trace) -> Optional[Tuple[list, list]]:
    """(spans, counters) that start in the window, times in seconds:
    spans as (start, end, name, thread), counters as (name, value)."""
    snap = snapshot()
    if snap is None:
        return None
    spans = [(s.start_ns * 1e-9, s.end_ns * 1e-9, s.name, s.thread)
             for s in snap["spans"]]
    spans = [s for s in spans if trace.t0 <= s[0] <= trace.t1]
    counters = [(c.name, c.value) for c in snap["counters"]
                if trace.t0 <= c.t_ns * 1e-9 <= trace.t1]
    return spans, counters


def host_seconds(trace, name: str) -> Optional[float]:
    """Host seconds of the spans ``name`` in the window; None where the
    program recorded none."""
    got = in_window(trace)
    if got is None:
        return None
    found = [t - s for s, t, n, _ in got[0] if n == name]
    return sum(found) if found else None


def steps(trace) -> int:
    """The beam steps the program counted in the window."""
    got = in_window(trace)
    if got is None:
        return 0
    return sum(v for n, v in got[1] if n == "beam.steps")


def per_batch_ms(facts, trace, name: str) -> Optional[float]:
    if not facts.get("batches"):
        return None
    s = host_seconds(trace, name)
    return None if s is None else s / facts["batches"] * 1e3


def per_step_us(trace, name: str) -> Optional[float]:
    n = steps(trace)
    if not n:
        return None
    s = host_seconds(trace, name)
    return None if s is None else s / n * 1e6


def union(intervals) -> List[Interval]:
    out: List[Interval] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The intersection of two sorted lists of disjoint intervals."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        s, t = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < t:
            out.append((s, t))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def total(intervals) -> float:
    return sum(t - s for s, t in intervals)


def idle_split(trace) -> Optional[Dict[str, float]]:
    """The window's idle device seconds, split by the enqueuing thread's
    innermost span at each idle moment: ``beam_steps`` (``beam.step`` or
    a span under it), ``forward_rest`` (inside ``decode.forward``, outside
    the steps) and ``host_rest`` (every other moment). Spans of other
    threads (the resolver's) decide nothing: they enqueue no work."""
    got = in_window(trace)
    if got is None or trace.window_s <= 0:
        return None
    spans = got[0]
    threads = {th for _, _, n, th in spans if n == ENQUEUER}
    if not threads:
        return None

    def cover(name):
        return union((max(s, trace.t0), min(t, trace.t1))
                     for s, t, n, th in spans if n == name and th in threads)

    idle, at = [], trace.t0
    for s, t in trace.busy_intervals() + [(trace.t1, trace.t1)]:
        if s > at:
            idle.append((at, s))
        at = max(at, t)
    steps_ = cover("beam.step")
    forward = intersect(idle, cover("decode.forward"))
    beam = total(intersect(idle, steps_))
    rest = total(forward) - total(intersect(forward, steps_))
    return {"beam_steps": beam, "forward_rest": rest,
            "host_rest": total(idle) - beam - rest}


def idle_pct(trace, part: str) -> Optional[float]:
    split = idle_split(trace)
    return None if split is None else 100.0 * split[part] / trace.window_s
