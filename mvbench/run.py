"""One run of one benchmark cell:

    python3 -m mvbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell's files by name: ``mvbench/workloads/<cell>.json`` (its
configuration, driver and traffic), ``mvbench/configs/<config>.json``,
``mvbench/drivers/<driver>.py`` (one kind of window) and, in a traced
run, ``mvbench/metrics/<metric>.py`` for each per-layer metric that
``BENCHMARK.json`` lists for the cell. Sets up and warms the cell's own
shapes (``setup_s``), measures for ``--seconds``, checks what the timed
path produced against the plain reference (``mvbench/reference``), and
prints one JSON object as the last line of its standard output. Without
a CUDA card it prints no result and exits with 2.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
BLOCKED = ("jax", "jaxlib", "flax", "multiverse_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / (name + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``mvbench/<kind>/<name>.py`` as a module: imported where the name
    is an identifier (a driver), else loaded from its file (a metric's
    name holds dots)."""
    if name.isidentifier():
        return importlib.import_module("mvbench.%s.%s" % (kind, name))
    path = HERE / kind / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "mvbench_%s_%s" % (kind, name.replace(".", "_")), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that
    ``BENCHMARK.json`` gives this cell."""
    spec = benchmark()
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if m["moves"] in names
            and cell in m.get("workloads", [cell])]


def blocked_modules() -> list:
    """Top-level names of the loaded modules that the port must not
    load, compared whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(BLOCKED))


def fix_env() -> None:
    """Every cache the run may write, at a fixed path in the checkout
    (the kernels build into the program's own ``_build``), and one
    intra-op thread: the decode's host work is one Python thread, which
    a pool of threads competing for the host's cores slows and spreads
    (PERF.md §2)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def card(torch, chips: int) -> Optional[dict]:
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "power_limit": smi[0].split(",")[-1].strip() if smi else
            "not read"}


def limited(got: dict, ctx) -> dict:
    """{name: (number, limit)} for every number the traffic file gives a
    limit; the launch counters are read on a card only."""
    limits = ctx.workload["limits"]
    absent = set(limits) - set(got)
    if ctx.device.type != "cuda":
        absent.discard("launches_missing")
    if absent:
        raise KeyError("no reading of %s" % ", ".join(sorted(absent)))
    return {k: (got[k], lim) for k, lim in limits.items() if k in got}


class Ctx:
    """What a driver is given: the cell, its configuration, the seed,
    the device and the spans."""

    def __init__(self, cell: str, workload: dict, config: dict, seed: int,
                 device, spans, seconds: float = 0.0):
        self.cell = cell
        self.seconds = seconds
        self.workload = workload
        self.config = config
        self.seed = seed
        self.device = device
        self.spans = spans


def execute(cell: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, overrides=None, workload=None,
            facts: Optional[dict] = None) -> dict:
    """Set up, warm, measure, check. Returns the result's fields. The
    tests on the CPU pass ``overrides`` (configuration fields) and
    ``workload`` (traffic fields) for their small sizes; ``facts``, a
    dict, receives the driver's own readings (the sweep's)."""
    import torch

    from mvbench.trace import Spans, Trace, profiler

    workload = dict(load_json("workloads", cell), **(workload or {}))
    config = load_json("configs", workload["config"])
    driver = load_module("drivers", workload["driver"])
    spans = Spans(annotate=trace)
    ctx = Ctx(cell, workload, config, seed, torch.device(device), spans,
              seconds)
    state = driver.setup(ctx, overrides)
    setup_s = time.perf_counter() - t_start
    log("set-up %.3f s" % setup_s)

    tr = None
    if trace:
        undo = driver.instrument(state)
        with profiler() as prof:
            with spans("window"):
                driver.window(state, seconds)
        for u in undo:
            u()
        tr = Trace(prof)
    else:
        driver.window(state, seconds)
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    res = driver.result(state)
    if facts is not None:
        facts.update({k: v for k, v in res["facts"].items() if k != "cfg"})
    driver.release(state)
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(state)
    correct = all(v <= lim for v, lim in checks.values())

    e2e = {m["name"]: m for m in cell_metrics(cell, "end_to_end")}
    metrics = {}
    if trace:
        for m in cell_metrics(cell, "per_layer"):
            reader = load_module("metrics", m["name"])
            v = reader.read(res["facts"], tr, ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        got = dict(res["metrics"], setup_s=setup_s)
        metrics = {k: {"value": got[k], "unit": m["unit"]}
                   for k, m in e2e.items() if k in got}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if cuda
           else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(t_start: float, argv=None) -> int:
    p = argparse.ArgumentParser(prog="mvbench", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fix_env()
    import torch

    torch.set_num_threads(1)
    workload = load_json("workloads", args.workload)
    found = card(torch, workload["chips"])
    if found is None:
        log("mvbench: no CUDA card (or fewer than %d): no result"
            % workload["chips"])
        return 2
    log("card: %s x%d, power limit %s" % (found["kind"], found["count"],
                                          found["power_limit"]))
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda:0", t_start)
    bad = blocked_modules()
    if bad:
        log("mvbench: loaded %s: no result" % ", ".join(bad))
        return 3
    for k, c in out["checks"].items():
        log("check %s %.6g limit %.6g" % (k, c["value"], c["limit"]))
    print(json.dumps(out), flush=True)
    return 0
