"""mvt-torch-train: the training command of the port.

The counterpart of ``mvt-train`` (``multiverse_tpu/cli/train.py``;
reference: code/train.py), with the same flags: periodic save and val
eval, best-model tracking on grid{val_grid_num}_traj_ade, the NaN-loss
abort within one ``--loss_fetch_period``, moving-average loss displays
and ``val_perf.json``. Differences:

* the step runs data-parallel over every visible GPU with no flag, as
  ``mvt-train`` does over every chip: one process a GPU
  (``multiverse_torch/parallel``), the data axis the largest divisor of
  ``--batch_size`` that fits them, ``CUDA_VISIBLE_DEVICES`` limiting
  them; ``--model_parallel N`` splits the weights and optimizer slots
  of each data index over N GPUs (tensor parallelism,
  ``parallel/tensor.py``), and fewer than N visible GPUs is an error;
* ``--device`` picks the device (default cuda, every visible GPU;
  ``cuda:N`` one GPU; there is no CPU fallback, ``--device cpu`` runs
  one process with the plain PyTorch versions of the kernels, or
  ``--model_parallel`` gloo ranks on the host, the counterpart of the
  JAX package's virtual CPU devices);
* checkpoints are orbax steps in the JAX package's layout
  (``train/checkpoints.py``), the whole weights however the ranks split
  them, which ``mvt-torch-test``, ``mvt-torch-serve`` and
  ``mvt-torch-multifuture-inference`` read from the run directory or as
  a step, and the JAX package's ``mvt-test``, ``mvt-serve`` and
  ``mvt-train --load`` read as their own;
  ``--load``/``--load_best``/``--load_from`` read them, the JAX
  package's steps and the port's earlier npz files alike (a checkpoint
  with more grid scales pruned to the model); on a JAX run directory,
  new saves continue above its latest step, and none of its steps is
  deleted;
* ``--profile`` writes a ``torch.profiler`` trace.

On the card with ``--compute_dtype bfloat16`` the class decoder's graph
attention runs the hand-written kernels K4 (forward) and K5 (backward)
at every decode step, and the periodic eval's class decode the fused
decode step (K1, or K2/K3/K7 under ``--decode_quant``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

from multiverse_torch.cli.common import (
    LossBuffer,
    add_model_args,
    add_train_args,
    config_from_args,
)
from multiverse_torch.data.dataset import read_data
from multiverse_torch.data.prefetch import prefetch
from multiverse_torch.models import Multiverse
from multiverse_torch.parallel import (
    Mesh,
    gather_params,
    init_sharded_train_state,
    launch,
    make_mesh,
    make_mesh_for_batch,
    make_sharded_eval_step,
    make_sharded_train_step,
    shard_batch,
)
from multiverse_torch.train.checkpoints import (
    CheckpointManager,
    load_checkpoint,
    process_out_dirs,
    run_dir,
)
from multiverse_torch.train.evaluate import evaluate
from multiverse_torch.train.trainer import build_optimizer
from multiverse_torch.utils import MovingAverage, profile_trace

PROG = "mvt-torch-train"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=PROG, description=__doc__)
    parser.add_argument("prepropath", type=str)
    parser.add_argument("outbasepath", type=str,
                        help="full path will be outbasepath/modelname/runId")
    parser.add_argument("modelname", type=str)
    parser.add_argument("--runId", type=int, default=0)
    parser.add_argument("--load", action="store_true")
    parser.add_argument("--load_best", action="store_true")
    parser.add_argument("--load_from", type=str, default=None,
                        help="an npz checkpoint, an orbax step directory "
                             "of the JAX package, or a save/best directory "
                             "of either (its latest step)")
    parser.add_argument("--val_grid_num", type=int, default=0,
                        help="which grid scale for the validation metric")
    parser.add_argument("--save_period", type=int, default=300)
    parser.add_argument("--loss_moving_avg_step", default=100, type=int)
    parser.add_argument("--loss_fetch_period", default=20, type=int,
                        help="fetch the per-step losses to the host every "
                             "N steps (1: NaN abort on the exact step; "
                             "larger keeps the card's stream unblocked, "
                             "the abort then lags at most N steps)")
    parser.add_argument("--check_model", action="store_true",
                        help="print parameter shapes and exit")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", default=None,
                        help="directory for a torch.profiler trace")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="ranks (GPUs) each weight is split over "
                             "(tensor parallelism); 1 = data-parallel only")
    parser.add_argument("--per_scene_eval", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    add_model_args(parser)
    add_train_args(parser)
    return parser


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but CUDA is not available; pass "
            "--device cpu to train with the plain PyTorch versions" % name)
    return device


def train_mesh(device: torch.device, batch_size: int,
               model_parallel: int = 1) -> Mesh:
    """For ``--device cuda``, every visible GPU: ``model_parallel`` of
    them a data index, the data axis the largest divisor of the batch
    size that fits the rest (one process a GPU); for ``--device cpu``,
    ``model_parallel`` ranks on the host; else the one device of
    ``cuda:N``. Raises ``ValueError`` where the devices do not fit
    ``model_parallel``."""
    if device.type == "cuda" and device.index is None:
        return make_mesh_for_batch(batch_size, model_parallel)
    if device.type == "cpu":
        return make_mesh(devices=[device] * model_parallel,
                         model_parallel=model_parallel)
    return make_mesh(devices=[device], model_parallel=model_parallel)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.check_model:
        cfg = config_from_args(args)
        for name, p in Multiverse.init(cfg).named_parameters():
            print("%s %s" % (name.replace(".", "/"), tuple(p.shape)))
        return {}
    try:
        mesh = train_mesh(device, args.batch_size, args.model_parallel)
    except ValueError as exc:
        sys.exit("%s: --model_parallel %d: %s"
                 % (PROG, args.model_parallel, exc))
    return launch(train_worker, mesh, args)[0]


def _quiet(*_args, **_kw) -> None:
    pass


def train_worker(mesh: Mesh, args: argparse.Namespace) -> dict:
    """One rank of ``mvt-torch-train``: every rank iterates the same
    seeded global batch stream and trains on its data index's block of
    each batch (the same examples in each step, and the gathered eval
    outputs in order, at any world size) with its block of the weights;
    at each save every rank gathers the whole weights, which rank 0
    alone writes (it alone prints the step lines and writes the run
    directory) and every rank evaluates. Returns the rank's step count,
    world size, collective calls and best validation point."""
    # full f32 products, as the JAX package's Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config_from_args(args)
    log = print if mesh.is_main else _quiet

    train_data = read_data(args.prepropath, "train", cfg)
    val_data = read_data(args.prepropath, "val", cfg)
    model = Multiverse.init(cfg, seed=args.seed, trainable=True)

    if mesh.is_main:
        outpath = process_out_dirs(args.outbasepath, args.modelname,
                                   args.runId)
        with open(os.path.join(outpath, "config.json"), "w") as f:
            f.write(cfg.to_json())
    else:
        outpath = run_dir(args.outbasepath, args.modelname, args.runId)
    ckpt = CheckpointManager(outpath, create=mesh.is_main)

    # a checkpoint with more grid scales than the model is pruned to it;
    # every rank loads the same one
    loaded = None
    if args.load_from is not None:
        loaded = load_checkpoint(args.load_from, model)
    elif args.load or args.load_best:
        loaded = ckpt.restore_params(model, best=args.load_best)
    if loaded is not None:
        model = loaded
    tx = build_optimizer(cfg, train_data.num_examples)
    model, opt_state = init_sharded_train_state(model, tx, mesh)
    # new saves continue above any steps already in this run dir (the
    # schedule restarts at 0, as the reference's restore does); read
    # before the first step, so before rank 0 can save one
    step_offset = ckpt.latest_step() or 0

    train_step = make_sharded_train_step(cfg, tx, mesh)
    eval_step = make_sharded_eval_step(cfg, mesh)

    def evaluate_whole(whole):
        """The val split's metrics on the whole weights."""
        def eval_fn(batch):
            cl, rg = eval_step(whole, shard_batch(mesh, batch))
            return ({i: v.cpu().numpy() for i, v in cl.items()},
                    {i: v.cpu().numpy() for i, v in rg.items()})

        return evaluate(val_data, cfg, eval_fn,
                        per_scene_eval=args.per_scene_eval)

    steps_per_epoch = int(math.ceil(train_data.num_examples / cfg.batch_size))
    num_steps = steps_per_epoch * cfg.num_epochs
    log("batch_size:%d, epochs:%d, %d steps/epoch, total %d steps, "
        "eval/save every %d steps, mesh=%s, device=%s (%s)" % (
            cfg.batch_size, cfg.num_epochs, steps_per_epoch, num_steps,
            args.save_period, mesh.shape, mesh.device,
            mesh.backend if mesh.group is not None else "no group"))

    metric = "grid%d_traj_ade" % args.val_grid_num
    best = {metric: float("inf"), "step": -1}
    loss_ma = MovingAverage(args.loss_moving_avg_step)
    wd_ma = MovingAverage(args.loss_moving_avg_step)
    val_perf = []
    finalperf = None
    global_step = 0
    loss_buf = LossBuffer(loss_ma, args.loss_fetch_period,
                          aux_mas={"wd": wd_ma})

    with profile_trace(args.profile if mesh.is_main else None):
        if loaded is not None:
            # the loaded model's validation baseline, so best tracking
            # never ends worse than the starting checkpoint
            evalperf = evaluate_whole(gather_params(mesh, model))
            best[metric] = evalperf[metric]
            best["step"] = step_offset
            val_perf.append((None, evalperf, step_offset, False))
            log("loaded baseline: val %s=%.4f" % (metric, evalperf[metric]))

        # steps/s flush to flush: the flush's copy to the host is the
        # sync point
        sync_t, sync_step = time.perf_counter(), 0
        dropout = cfg.keep_prob < 1.0
        with prefetch(train_data.get_batches(
                cfg.batch_size, num_steps=num_steps), depth=2) as batches:
            for batch, _ in batches:
                global_step += 1
                # one dropout seed per step (each rank folds in its own)
                rng = (args.seed + 1) * 1_000_003 + global_step \
                    if dropout else None
                losses = train_step(model, opt_state,
                                    shard_batch(mesh, batch), rng)
                loss_buf.put(global_step, losses["total"],
                             aux={"wd": losses["wd"]})
                if global_step % args.save_period == 0 \
                        or global_step == num_steps:
                    loss_buf.flush()
                    now = time.perf_counter()
                    steps_per_sec = (global_step - sync_step) / max(
                        now - sync_t, 1e-9)
                    sync_t, sync_step = now, global_step
                    whole = gather_params(mesh, model)
                    if mesh.is_main:
                        ckpt.save(global_step + step_offset, whole)
                    # every rank evaluates its data index's shard and
                    # gets every one's outputs: the same metrics, the
                    # same best
                    evalperf = evaluate_whole(whole)
                    log("step %d: loss(ma)=%s wd(ma)=%s %.1f steps/s "
                        "| val: %s (best %s=%.4f @%d)" % (
                            global_step, loss_ma, wd_ma, steps_per_sec,
                            {k: round(v, 4) for k, v in sorted(
                                evalperf.items()) if "@T" not in k},
                            metric, best[metric], best["step"]))
                    is_best = evalperf[metric] < best[metric]
                    if is_best:
                        best[metric] = evalperf[metric]
                        best["step"] = global_step + step_offset
                        if mesh.is_main:
                            ckpt.save(global_step + step_offset, whole,
                                      best=True)
                    # every eval point is recorded: val_perf.json holds
                    # the whole curve
                    val_perf.append((loss_ma.me(), evalperf,
                                     global_step + step_offset, is_best))
                    finalperf = evalperf
        loss_buf.flush()

    if mesh.is_main:
        with open(os.path.join(outpath, "val_perf.json"), "w") as f:
            # json has no Infinity: a run too short to eval stores null
            best_out = dict(best)
            if math.isinf(best_out[metric]):
                best_out[metric] = None
            json.dump({"best": best_out, "val_perf": val_perf}, f,
                      indent=2, default=float)
    if finalperf is not None:
        log("best val %s: %.4f at step %d; final %s=%.4f" % (
            metric, best[metric], best["step"], metric, finalperf[metric]))
    return {"steps": global_step, "world": mesh.world,
            "collectives": mesh.collectives, "best": best}


if __name__ == "__main__":
    main()
