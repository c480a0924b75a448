"""mvt-torch-train-simaug: SimAug training of the port, adversarial-
feature and multi-view-mixup training on simulation data.

The counterpart of ``mvt-train-simaug`` (``multiverse_tpu/cli/
train_simaug.py``; reference: SimAug/code/train.py), with the same
flags: the base trainer's plus the ``--adv_train``, ``--multiview_train``,
``--use_mixup`` ... family, ``--keep_prob`` defaulting to 0.7 and the
scene encoder forced on. Validation runs the clean eval forward every
``--save_period`` steps (``--only_scene`` restricts it to one scene).
As in ``mvt-torch-train``:

* ``--device`` picks the device (default cuda; no CPU fallback,
  ``--device cpu`` runs the plain PyTorch versions of the kernels);
* the train step runs on one device and ``--model_parallel`` other
  than 1 is refused; the periodic eval runs over every visible GPU, as
  the JAX trainer's does over every chip (``make_mesh_for_batch`` and
  ``make_sharded_eval_step``): rank 0 trains, and at each eval sends
  the weights to the other ranks, which wait for them between evals;
* checkpoints are orbax steps in the JAX package's layout
  (``train/checkpoints.py``), which its commands read as their own;
  ``--load``/``--load_best``/``--load_from`` read them, the JAX
  package's steps and the port's earlier npz files alike, and new saves
  continue above a JAX run directory's latest step without deleting
  any of its steps.

On the card with ``--compute_dtype bfloat16`` every tower pass (the
attack's and the outer step's) runs the class decoder's graph attention
through K4 and its backward through K5, and the periodic eval's class
decode runs the fused decode step (K1).
"""

from __future__ import annotations

import argparse
import dataclasses
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
from multiverse_torch.cli.train import resolve_device, train_mesh
from multiverse_torch.config import MultiverseConfig
from multiverse_torch.data.dataset import batch_to_device, read_data
from multiverse_torch.data.multiview import MultiviewDataset
from multiverse_torch.data.prefetch import prefetch
from multiverse_torch.models import Multiverse
from multiverse_torch.models.simaug import (
    SimAugConfig,
    make_simaug_train_step,
)
from multiverse_torch.parallel import (
    Mesh,
    broadcast_params,
    launch,
    make_sharded_eval_step,
    shard_batch,
)
from multiverse_torch.train.checkpoints import (
    CheckpointManager,
    load_checkpoint,
    process_out_dirs,
)
from multiverse_torch.train.evaluate import evaluate
from multiverse_torch.train.trainer import build_optimizer
from multiverse_torch.utils import MovingAverage

PROG = "mvt-torch-train-simaug"

# rank 0 to the eval ranks: evaluate the weights that follow, or end
_CMD_STOP, _CMD_EVAL = 0, 1
# the eval ranks wait in a broadcast while rank 0 trains between evals
EVAL_WAIT_S = 7 * 24 * 3600.0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=PROG, description=__doc__)
    parser.add_argument("prepropath", type=str)
    parser.add_argument("outbasepath", type=str)
    parser.add_argument("modelname", type=str)
    parser.add_argument("--runId", type=int, default=0)
    parser.add_argument("--load", action="store_true")
    parser.add_argument("--load_best", action="store_true")
    parser.add_argument("--load_from", type=str, default=None,
                        help="an npz checkpoint, an orbax step directory "
                             "of the JAX package, or a save/best directory "
                             "of either (its latest step)")
    parser.add_argument("--val_grid_num", type=int, default=0)
    parser.add_argument("--only_scene", default=None,
                        help="restrict the in-training val eval to one "
                             "scene token (reference: SimAug/code/"
                             "train.py:51, pred_utils.py:501-505)")
    parser.add_argument("--save_period", type=int, default=300)
    parser.add_argument("--loss_moving_avg_step", default=100, type=int)
    parser.add_argument("--loss_fetch_period", default=20, type=int,
                        help="fetch per-step losses every N steps "
                             "(see mvt-torch-train)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="only 1: SimAug trains on one device")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    add_model_args(parser)
    add_train_args(parser)
    # the SimAug trainer defaults to input dropout 0.7, the base trainer
    # to 1.0 (reference: SimAug/code/train.py:159-160 against
    # code/train.py:120): the published SimAug recipes pass no
    # --keep_prob and so ran at 0.7
    parser.set_defaults(keep_prob=0.7)
    # the SimAug tower always convolves the scene input (the reference
    # comments the flag out, SimAug/code/train.py:97)
    parser.set_defaults(use_scene_enc=True)
    # SimAug knobs (reference: SimAug/code/train.py:109-144)
    parser.add_argument("--adv_train", action="store_true")
    parser.add_argument("--adv_epsilon", type=float, default=0.1)
    parser.add_argument("--adv_step_size", type=float, default=0.001)
    parser.add_argument("--adv_num_iter", type=int, default=30)
    parser.add_argument("--adv_start_from_clean_prob",
                        default=0.0, type=float)
    parser.add_argument("--adv_use_fgsm", action="store_true")
    parser.add_argument("--standard_aug", action="store_true")
    parser.add_argument("--norm_feat", action="store_true")
    parser.add_argument("--use_mixup", action="store_true")
    parser.add_argument("--mixup_alpha", type=float, default=1.0)
    parser.add_argument("--mixup_mix_adv", action="store_true")
    parser.add_argument("--multiview_train", action="store_true")
    parser.add_argument("--multiview_max_num", type=int, default=3)
    parser.add_argument("--multiview_exp", default=3, type=int)
    parser.add_argument("--multiview_random", action="store_true")
    parser.add_argument("--multiview_max_weight_for_first",
                        action="store_true")
    parser.add_argument("--multiview_use_adv_for_loss", action="store_true")
    parser.add_argument("--double_weighting", action="store_true")
    parser.add_argument("--fl_gamma", default=1.0, type=float)
    return parser


# the fields SimAugConfig adds to MultiverseConfig, each a flag above
SIMAUG_FIELDS = tuple(
    f.name for f in dataclasses.fields(SimAugConfig)
    if f.name not in {g.name for g in dataclasses.fields(MultiverseConfig)})


def simaug_config_from_args(args: argparse.Namespace) -> SimAugConfig:
    """The configuration of a parsed command line: the base trainer's
    fields and the SimAug ones."""
    return SimAugConfig(
        **dataclasses.asdict(config_from_args(args)),
        **{k: getattr(args, k) for k in SIMAUG_FIELDS},
    ).validate()


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.model_parallel != 1:
        sys.exit("%s: --model_parallel %d: SimAug trains on one device, "
                 "as mvt-train-simaug does (mvt-torch-train splits the "
                 "weights)" % (PROG, args.model_parallel))
    device = resolve_device(args.device)
    mesh = dataclasses.replace(train_mesh(device, args.batch_size),
                               timeout_s=EVAL_WAIT_S)
    return launch(simaug_worker, mesh, args)[0]


class ShardedEval:
    """The val split's metrics over every rank of ``mesh``: rank 0's
    weights sent to every rank, each rank's block of each val batch
    decoded (``make_sharded_eval_step``), the outputs gathered on
    every rank. Rank 0 calls :meth:`evaluate` at each eval and
    :meth:`stop` at the end; the other ranks :meth:`serve` until then."""

    def __init__(self, mesh: Mesh, cfg, val_data, only_scene):
        self.mesh, self.cfg, self.val_data = mesh, cfg, val_data
        self.only_scene = only_scene
        self.step = make_sharded_eval_step(cfg, mesh)

    def _command(self, cmd: int = -1) -> int:
        """Rank 0's ``cmd``, on every rank."""
        return int(self.mesh.broadcast(torch.tensor(
            [cmd], dtype=torch.int64, device=self.mesh.device)).item())

    def _metrics(self, model) -> dict:
        broadcast_params(self.mesh, model)

        def eval_fn(batch):
            cl, rg = self.step(model, shard_batch(self.mesh, batch))
            return ({i: v.cpu().numpy() for i, v in cl.items()},
                    {i: v.cpu().numpy() for i, v in rg.items()})

        return evaluate(self.val_data, self.cfg, eval_fn,
                        only_scene=self.only_scene)

    def evaluate(self, model) -> dict:
        self._command(_CMD_EVAL)
        return self._metrics(model)

    def stop(self) -> None:
        self._command(_CMD_STOP)

    def serve(self, model) -> int:
        """An eval rank: evaluate into ``model`` until rank 0 stops;
        returns the evals made."""
        evals = 0
        while self._command() == _CMD_EVAL:
            self._metrics(model)
            evals += 1
        return evals


def simaug_worker(mesh: Mesh, args: argparse.Namespace) -> dict:
    """One rank of ``mvt-torch-train-simaug``: rank 0 trains on its
    device and writes the run directory; every rank takes part in the
    periodic eval (:class:`ShardedEval`). Returns the rank's world size,
    evals and, on rank 0, the steps, the best validation point and every
    eval's metrics."""
    # full f32 products, as the JAX package's Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mesh.device
    cfg = simaug_config_from_args(args)
    val_data = read_data(args.prepropath, "val", cfg)
    sharded_eval = ShardedEval(mesh, cfg, val_data, args.only_scene)
    if not mesh.is_main:
        model = Multiverse.init(cfg, device=device)
        return {"world": mesh.world, "evals": sharded_eval.serve(model)}
    # a failure is not sent on: the launch stops the eval ranks
    result = train(mesh, args, cfg, val_data, sharded_eval)
    sharded_eval.stop()
    return result


def train(mesh: Mesh, args: argparse.Namespace, cfg: SimAugConfig,
          val_data, sharded_eval: ShardedEval) -> dict:
    """Rank 0's training loop (see :func:`simaug_worker`)."""
    device = mesh.device
    train_base = read_data(args.prepropath, "train", cfg)
    train_data = MultiviewDataset(
        train_base, cfg, max_views=cfg.multiview_max_num)
    if cfg.multiview_train and train_data.num_views != cfg.multiview_max_num:
        cfg = cfg.replace(
            multiview_max_num=train_data.num_views).validate()
        print("multiview_max_num -> %d (from data)" % train_data.num_views)

    model = Multiverse.init(cfg, seed=args.seed, trainable=True)
    outpath = process_out_dirs(args.outbasepath, args.modelname, args.runId)
    with open(os.path.join(outpath, "config.json"), "w") as f:
        f.write(cfg.to_json())
    ckpt = CheckpointManager(outpath)

    # a checkpoint with more grid scales than the model is pruned to it
    loaded = None
    if args.load_from is not None:
        loaded = load_checkpoint(args.load_from, model)
    elif args.load or args.load_best:
        loaded = ckpt.restore_params(model, best=args.load_best)
    if loaded is not None:
        model = loaded.requires_grad_(True)
    model = model.to(device)
    # new saves continue above any steps already in this run dir
    step_offset = ckpt.latest_step() or 0

    tx = build_optimizer(cfg, train_data.num_examples)
    opt_state = tx.init(dict(model.named_parameters()))
    train_step = make_simaug_train_step(cfg, tx)

    steps_per_epoch = int(
        math.ceil(train_data.num_examples / cfg.batch_size))
    num_steps = steps_per_epoch * cfg.num_epochs
    metric = "grid%d_traj_ade" % args.val_grid_num
    best = {metric: float("inf"), "step": -1}
    loss_ma = MovingAverage(args.loss_moving_avg_step)
    global_step = 0
    finalperf = None
    evals = []

    print("SimAug training: %d steps, views=%d, mode=%s, device=%s, "
          "eval mesh=%s" % (
              num_steps, train_data.num_views,
              "adv" if cfg.adv_train else
              "multiview" if cfg.multiview_train else
              "standard_aug" if cfg.standard_aug else "clean", device,
              mesh.shape))

    loss_buf = LossBuffer(loss_ma, args.loss_fetch_period)
    # steps/s flush to flush: the flush's copy to the host is the sync
    sync_t, sync_step = time.perf_counter(), 0
    with prefetch(train_data.get_batches(
            cfg.batch_size, num_steps=num_steps), depth=2) as batches:
        for batch, _ in batches:
            global_step += 1
            # one seed a step: the attack's, the augmentation's and the
            # dropout's draws
            seed = (args.seed + 1) * 1_000_003 + global_step
            losses = train_step(model, opt_state,
                                batch_to_device(batch, device), seed)
            loss_buf.put(global_step, losses["total"])

            if (global_step % args.save_period == 0
                    or global_step == num_steps):
                loss_buf.flush()
                now = time.perf_counter()
                steps_per_sec = (global_step - sync_step) / max(
                    now - sync_t, 1e-9)
                sync_t, sync_step = now, global_step
                ckpt.save(global_step + step_offset, model)
                evalperf = sharded_eval.evaluate(model)
                evals.append(evalperf)
                print("step %d: loss(ma)=%s %.2f steps/s | val %s=%.4f "
                      "(best %.4f @%d)" % (
                          global_step, loss_ma, steps_per_sec,
                          metric, evalperf[metric],
                          best[metric], best["step"]))
                if evalperf[metric] < best[metric]:
                    best[metric] = evalperf[metric]
                    best["step"] = global_step + step_offset
                    ckpt.save(global_step + step_offset, model, best=True)
                finalperf = evalperf

    loss_buf.flush()
    with open(os.path.join(outpath, "val_perf.json"), "w") as f:
        best_out = dict(best)
        if math.isinf(best_out[metric]):
            best_out[metric] = None   # json has no Infinity token
        json.dump({"best": best_out}, f, indent=2, default=float)
    if finalperf is not None:
        print("best val %s: %.4f at step %d" % (
            metric, best[metric], best["step"]))
    return {"world": mesh.world, "steps": global_step, "best": best,
            "evals": evals}


if __name__ == "__main__":
    main()
