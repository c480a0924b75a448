"""The readers of the program's spans (``mvbench/program_spans.py`` and
the eight metrics over it) on a synthetic trace and span snapshot."""

import pytest

from multiverse_torch.utils import CounterRecord, SpanRecord
from mvbench import program_spans, run
from mvbench.trace import Trace

BASE = 1_790_000_000 * 10**9      # the profiler's clock: Unix epoch ns
MAIN, RESOLVER = 11, 22
IDLE = ("idle_pct.decode.beam_steps", "idle_pct.decode.forward_rest",
        "idle_pct.decode.host_rest")
HOST = ("beam.step_us", "beam.select_us", "decode.encode_ms",
        "decode.reg_ms", "decode.wait_ms")


def ns(t):
    return BASE + int(round(t * 1e9))


def trace(busy, t0=0.0, t1=10.0):
    tr = Trace.__new__(Trace)
    tr.device = sorted((BASE * 1e-9 + s, BASE * 1e-9 + t, "k")
                       for s, t in busy)
    tr.spans = []
    tr.t0, tr.t1 = BASE * 1e-9 + t0, BASE * 1e-9 + t1
    return tr


def snap(spans, counters=()):
    return {"spans": [SpanRecord(n, ns(s), ns(t), i, None, th, 1)
                      for i, (n, s, t, th) in enumerate(spans)],
            "counters": [CounterRecord(n, ns(t), v, MAIN, 1)
                         for n, t, v in counters],
            "dropped": 0}


# window [0, 10] s; the device idles in [1, 3], [4, 6] and [7, 9]
BUSY = [(0, 1), (3, 4), (6, 7), (9, 10)]
SPANS = [("decode.batch", 0.5, 9.5, MAIN),
         ("decode.forward", 1.5, 8.0, MAIN),
         ("beam.step", 2.0, 5.0, MAIN),
         ("beam.select", 2.5, 3.0, MAIN),
         ("decode.encode", 1.5, 2.0, MAIN),
         ("decode.wait", 8.5, 9.0, MAIN),
         # the resolver's spans decide no gap, whatever their names
         ("decode.fetch", 6.5, 9.5, RESOLVER),
         ("beam.step", 7.5, 9.0, RESOLVER)]
COUNTERS = [("beam.steps", 5.0, 25)]


def read(name, facts, tr):
    return run.load_module("metrics", name).read(facts, tr, None)


@pytest.fixture
def spans(monkeypatch):
    def use(spans=SPANS, counters=COUNTERS):
        monkeypatch.setattr(program_spans, "snapshot",
                            lambda: snap(spans, counters))
    use()
    return use


def test_idle_goes_to_the_main_threads_innermost_span(spans):
    tr = trace(BUSY)
    got = [read(n, {}, tr) for n in IDLE]
    # beam steps: [2, 3] and [4, 5]; the rest of decode.forward: [1.5, 2],
    # [4, 6] less [4, 5], [7, 8]; the rest of the idle: [1, 1.5], [8, 9]
    assert got == pytest.approx([20.0, 25.0, 15.0])


def test_idle_shares_sum_to_idle_pct(spans):
    for busy in (BUSY, [(0.2, 0.3), (2.2, 4.4), (8.0, 8.1)], []):
        tr = trace(busy)
        whole = read("idle_pct.decode", {}, tr)
        assert sum(read(n, {}, tr) for n in IDLE) == pytest.approx(
            whole, abs=1e-6)


def test_host_times_per_batch_and_per_step(spans):
    tr = trace(BUSY)
    facts = {"batches": 2}
    got = {n: read(n, facts, tr) for n in HOST}
    # the resolver's beam.step is a span of the window like any other:
    # host time, not a gap's owner
    assert got["beam.step_us"] == pytest.approx((3.0 + 1.5) / 25 * 1e6)
    assert got["beam.select_us"] == pytest.approx(0.5 / 25 * 1e6)
    assert got["decode.encode_ms"] == pytest.approx(0.5 / 2 * 1e3)
    assert got["decode.wait_ms"] == pytest.approx(0.5 / 2 * 1e3)
    assert got["decode.reg_ms"] is None


def test_spans_outside_the_window_are_dropped(spans):
    spans(SPANS + [("decode.encode", -3.0, -1.0, MAIN),
                   ("decode.encode", 10.5, 12.0, MAIN),
                   ("beam.step", 11.0, 13.0, MAIN)],
          COUNTERS + [("beam.steps", 12.0, 25)])
    tr = trace(BUSY)
    assert read("decode.encode_ms", {"batches": 1}, tr) == \
        pytest.approx(500.0)
    assert read("beam.step_us", {}, tr) == pytest.approx(4.5 / 25 * 1e6)
    assert [read(n, {}, tr) for n in IDLE] == pytest.approx(
        [20.0, 25.0, 15.0])


def test_readers_give_none_without_batches_steps_or_spans(spans,
                                                          monkeypatch):
    tr = trace(BUSY)
    for n in ("decode.encode_ms", "decode.wait_ms"):
        assert read(n, {"batches": 0}, tr) is None
    spans(SPANS, [])
    for n in ("beam.step_us", "beam.select_us"):
        assert read(n, {"batches": 2}, tr) is None
    spans([s for s in SPANS if s[0] != "decode.batch"])
    assert all(read(n, {}, tr) is None for n in IDLE)
    # a program that predates the recorder
    monkeypatch.setattr(program_spans, "snapshot", lambda: None)
    assert all(read(n, {"batches": 2}, tr) is None for n in IDLE + HOST)
