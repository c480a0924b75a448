"""The program's span recorder (``multiverse_torch.utils``) and the spans
of the offline decode: off, a span records nothing and reads no clock;
under ``torch.profiler``, each batch's spans nest as documented, share
one batch id across the main and the resolver thread, sit on the
profiler's clock beside its own events, and give ``timings`` its sums.
The card-only probe holds the spans' clock to the device trace's.

No JAX here: the card runs this file with ``--noconftest``."""

import threading
import time
from collections import defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multiverse_torch import utils
from multiverse_torch.config import MultiverseConfig
from multiverse_torch.inference import (
    run_multifuture_inference,
    synthesize_multifuture_inputs,
)
from multiverse_torch.models import Multiverse

SMALL = dict(emb_size=8, enc_hidden_size=16, dec_hidden_size=16,
             scene_conv_dim=8, scene_h=12, scene_w=16, beam_size=3,
             use_gnn=True, use_scene_enc=True, diverse_beam=True,
             diverse_gamma=0.01, fix_num_timestep=1,
             compute_dtype="float32")
BATCH_CHILDREN = ["decode.make_batch", "decode.upload", "decode.forward",
                  "decode.copy_out"]


def decode(timings=None):
    """Five trajectories in batches of two on the CPU; returns T."""
    cfg = MultiverseConfig(**SMALL).validate()
    inputs = synthesize_multifuture_inputs(cfg, 5, seed=0,
                                           max_pred_len=cfg.pred_len + 2)
    run_multifuture_inference(Multiverse.init(cfg, seed=0), inputs, cfg,
                              batch_size=2, device="cpu", timings=timings)
    return int(inputs.pred_lengths.max())


@pytest.fixture(scope="module")
def traced():
    utils.reset_spans()
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T = decode(timings)
    events = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        events[e.name()].append((e.start_ns(),
                                 e.start_ns() + e.duration_ns()))
    snap = utils.span_snapshot()
    utils.reset_spans()
    return dict(spans=snap["spans"], counters=snap["counters"],
                dropped=snap["dropped"], timings=timings, T=T,
                events=events, main=threading.get_ident())


def test_untraced_decode_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock")

    utils.reset_spans()
    monkeypatch.setattr(utils, "_clock", no_clock)
    decode()
    snap = utils.span_snapshot()
    assert snap["spans"] == [] and snap["counters"] == []
    assert snap["dropped"] == 0
    # off, every span is one shared object: nothing is allocated
    assert utils.span("a") is utils.span("b", batch=3)


def test_traced_decode_spans_nest_per_batch(traced):
    spans, T, main = traced["spans"], traced["T"], traced["main"]
    assert traced["dropped"] == 0
    children = defaultdict(list)
    for s in spans:
        children[s.parent].append(s)

    def names(sid):
        return [c.name for c in sorted(children[sid],
                                       key=lambda c: c.start_ns)]

    batches = [s for s in spans if s.name == "decode.batch"]
    assert len(batches) == traced["timings"]["batches"] == 3
    ids = {b.id for b in batches}
    assert {b.batch for b in batches} == ids
    steps = defaultdict(int)
    for c in traced["counters"]:
        assert c.name == "beam.steps" and c.thread == main
        steps[c.batch] += c.value
    assert steps == {i: T for i in ids}
    for b in batches:
        assert b.parent is None and b.thread == main
        assert names(b.id) == BATCH_CHILDREN
        forward = [c for c in children[b.id]
                   if c.name == "decode.forward"][0]
        assert names(forward.id) == (["decode.encode", "beam.prepare"]
                                     + ["beam.step"] * T
                                     + ["beam.backtrace", "decode.reg"])
        for st in children[forward.id]:
            if st.name == "beam.step":
                assert names(st.id) == ["beam.select"]

    def under(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s

    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.thread == main and s.name != "decode.wait":
            assert s.batch == under(s).id
    # the resolver's spans: another thread, the same batch ids
    for name in ("decode.fetch", "decode.pack"):
        got = [s for s in spans if s.name == name]
        assert sorted(s.batch for s in got) == sorted(ids)
        assert all(s.thread != main and s.parent is None for s in got)
    waits = [s for s in spans if s.name == "decode.wait"]
    assert sorted(s.batch for s in waits) == sorted(ids)
    assert all(s.thread == main and s.parent is None for s in waits)


def test_spans_sit_on_the_profilers_clock(traced):
    """Each span of the main thread (whose ranges this build's profiler
    records) starts and ends within 1 ms of its range's event."""
    by_name = defaultdict(list)
    for s in traced["spans"]:
        if s.thread == traced["main"]:
            by_name[s.name].append((s.start_ns, s.end_ns))
    assert len(by_name) == 12
    for name, got in by_name.items():
        want = sorted(traced["events"][name])
        assert len(want) == len(got), name
        for (s, t), (es, et) in zip(sorted(got), want):
            assert abs(s - es) <= 1e6 and abs(t - et) <= 1e6, name


def test_timings_are_the_spans_sums(traced):
    spans, t = traced["spans"], traced["timings"]

    def seconds(*names):
        return sum(s.end_ns - s.start_ns for s in spans
                   if s.name in names) * 1e-9

    assert seconds("decode.batch") == pytest.approx(t["build_s"], rel=1e-9)
    assert seconds(*BATCH_CHILDREN) == pytest.approx(t["build_s"],
                                                     rel=0.02)
    assert seconds("decode.fetch") == pytest.approx(t["fetch_s"], rel=1e-9)
    assert seconds("decode.pack") == pytest.approx(t["pack_s"], rel=1e-9)


def test_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(utils, "_RECORDER", utils.SpanRecorder(capacity=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with utils.span("s%d" % i):
                pass
    snap = utils.span_snapshot()
    assert [s.name for s in snap["spans"]] == ["s2", "s3", "s4", "s5"]
    assert snap["dropped"] == 2


def test_span_summary_gives_self_time():
    rec = utils.SpanRecord
    spans = [rec("inner", 20, 50, 2, 1, 7, 1),
             rec("inner", 60, 70, 3, 1, 7, 1),
             rec("outer", 0, 100, 1, None, 7, 1)]
    got = utils.span_summary(spans)
    assert got["outer"]["count"] == 1 and got["inner"]["count"] == 2
    assert got["outer"]["self_s"] == pytest.approx(60e-9)
    assert got["inner"]["total_s"] == pytest.approx(40e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("cpu_activity", [True, False])
def test_span_clock_matches_the_device_trace(cpu_activity):
    """Launch, synchronise, a span around 20 ms of sleep, launch: the
    device's idle gap between the two kernels has the span's bounds,
    within 0.5 ms; also with the profiler's CUDA activity alone, where
    no range of the program's is traced."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device trace comes from it")
    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum().item()
    utils.reset_spans()
    acts = [ProfilerActivity.CUDA]
    if cpu_activity:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        x @ x
        torch.cuda.synchronize()
        with utils.span("probe.sleep"):
            time.sleep(0.02)
        x @ x
        torch.cuda.synchronize()
    sp = [s for s in utils.span_snapshot()["spans"]
          if s.name == "probe.sleep"]
    utils.reset_spans()
    assert len(sp) == 1
    dev = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if str(e.device_type()).endswith("CUDA"))
    assert len(dev) >= 2
    end, gaps = dev[0][1], []
    for s, t in dev[1:]:
        if s > end:
            gaps.append((s - end, end, s))
        end = max(end, t)
    _, g0, g1 = max(gaps)
    assert abs(g0 - sp[0].start_ns) <= 5e5, (g0, sp[0])
    assert abs(g1 - sp[0].end_ns) <= 5e5, (g1, sp[0])
