"""Each driver at a tiny size on the CPU, called as a function (the
command itself refuses to run without a card), the result line's keys,
and what a run does without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mvbench import run

ROOT = Path(__file__).resolve().parents[2]
# float32 on the CPU: there the program equals the reference, which the
# limits (set from bf16 runs on the card) take for granted
TINY = dict(emb_size=8, enc_hidden_size=16, dec_hidden_size=16,
            scene_conv_dim=8, scene_h=12, scene_w=16,
            compute_dtype="float32")
CELLS = {
    "flagship.decode_b16": (dict(TINY, beam_size=4),
                            dict(pool=64, chunk=32, sample_per_chunk=3,
                                 min_pred_len=3, max_pred_len=6)),
}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_run(cell, seed=2**31 + 101, trace=False, seconds=1.0):
    overrides, workload = CELLS[cell]
    return run.execute(cell, seed, seconds, trace, "cpu", 0.0,
                       overrides=overrides, workload=workload)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_driver_runs_tiny_on_cpu(cell, trace):
    out = tiny_run(cell, trace=trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in run.cell_metrics(
        cell, "per_layer" if trace else "end_to_end")}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
        assert all(m["value"] > 0 for m in out["metrics"].values())
    else:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)


def test_same_seed_same_inputs():
    from mvbench.drivers import decode

    overrides, workload = CELLS["flagship.decode_b16"]
    wl = dict(run.load_json("workloads", "flagship.decode_b16"), **workload)
    cfg = run.load_json("configs", "multiverse_flagship")
    states = [decode.setup(run.Ctx("c", wl, cfg, 77, torch.device("cpu"),
                                   run_spans()), overrides)
              for _ in range(2)]
    a, b = states
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
    assert (a.pool["obs_traj"] == b.pool["obs_traj"]).all()
    assert a.sample == b.sample


def run_spans():
    from mvbench.trace import Spans

    return Spans()


def test_command_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "mvbench", "--workload", "flagship.decode_b16",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_cells_run_on_the_card():
    """One short run of every cell, where there is a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for w in run.benchmark()["workloads"]:
        p = subprocess.run(
            [sys.executable, "-m", "mvbench", "--workload", w["name"],
             "--seed", "3", "--seconds", "2", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert p.returncode == 0, p.stderr[-2000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"], out["checks"]
