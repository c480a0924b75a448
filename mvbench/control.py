"""The readings that a cell's limits are set from, on the chip:

    python3 -m mvbench.control --workload <cell> --mode <mode> --seeds 1,2,3

One process sets up the cell once per seed and prints, per seed, one
JSON line of the numbers its check compares (no limits applied). The
cell's driver (``mvbench/drivers/<driver>.py``) names its modes
(``MODES``) and reads them (``control_readings``): ``program`` gives
the lower readings, ``control``, the next precision below the
configuration's, the upper ones.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from mvbench import run
from mvbench.trace import Spans


def readings(cell: str, seed: int, mode: str, seconds: float,
             device="cuda:0", overrides=None, workload=None) -> dict:
    wl = dict(run.load_json("workloads", cell), **(workload or {}))
    config = run.load_json("configs", wl["config"])
    driver = run.load_module("drivers", wl["driver"])
    if mode not in driver.MODES:
        raise ValueError("driver %r reads no mode %r" % (wl["driver"], mode))
    ctx = run.Ctx(cell, wl, config, seed, torch.device(device), Spans(),
                  seconds)
    got = driver.control_readings(ctx, mode, seconds, overrides)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mvbench.control", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    run.fix_env()
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        run.log("mvbench.control: no CUDA card")
        return 2
    seconds = args.seconds if args.seconds is not None \
        else run.benchmark()["run_seconds"]
    for seed in [int(x) for x in args.seeds.split(",")]:
        t0 = time.perf_counter()
        got = readings(args.workload, seed, args.mode, seconds)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": got,
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
