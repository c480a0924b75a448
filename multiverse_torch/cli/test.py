"""mvt-torch-test: single-future evaluation of a trained checkpoint.

The counterpart of ``mvt-test`` (``multiverse_tpu/cli/test.py``;
reference: code/test.py): loads the test split, restores a checkpoint
of the port or of the JAX package (the latest step of the run
directory's ``save``, or of ``best`` with ``--load_best``, npz or
orbax; or ``--load_from`` an npz file, an orbax step directory or a
``save``/``best`` directory), pruned to the configuration's parameters
as the JAX package prunes, runs the
full evaluate loop and prints the metric table in the same format.
``--device`` picks the device (default cuda: the eval and the beam
decode shard each batch over every visible GPU, the world the largest
divisor of ``--batch_size`` that fits them, one process a GPU, as
``mvt-test`` shards over its chips; ``cuda:N`` or ``cpu`` is one
device). With ``--use_beam_search`` and ``--save_output`` the beam ids
and log-probs of the beam decode go into the output pickle as well.
"""

from __future__ import annotations

import argparse

import torch

from multiverse_torch.cli.common import add_model_args, config_from_args
from multiverse_torch.cli.train import resolve_device, train_mesh
from multiverse_torch.data.dataset import read_data
from multiverse_torch.models import BeamOutputs, Multiverse
from multiverse_torch.parallel import (
    Mesh,
    launch,
    make_sharded_beam_step,
    make_sharded_eval_step,
    replicate,
    shard_batch,
)
from multiverse_torch.train.checkpoints import (
    CheckpointManager,
    load_checkpoint,
    run_dir,
)
from multiverse_torch.train.evaluate import evaluate


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mvt-torch-test",
                                     description=__doc__)
    parser.add_argument("prepropath", type=str)
    parser.add_argument("outbasepath", type=str)
    parser.add_argument("modelname", type=str)
    parser.add_argument("--runId", type=int, default=0)
    parser.add_argument("--load_best", action="store_true")
    parser.add_argument("--load_from", type=str, default=None,
                        help="an npz checkpoint, an orbax step directory "
                             "of the JAX package, or a save/best directory "
                             "of either (its latest step)")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--save_output", default=None)
    parser.add_argument("--use_gt_grid", action="store_true")
    parser.add_argument("--per_scene_eval", action="store_true")
    parser.add_argument("--only_scene", default=None,
                        help="restrict evaluation to one scene token "
                             "(e.g. 0400)")
    parser.add_argument("--show_center_only", action="store_true",
                        help="include the grid-center-only ADE/FDE "
                             "ablation in the key-metric summary")
    parser.add_argument("--show_grid_acc_at_T", action="store_true",
                        help="include per-timestep accuracies at "
                             "T=0,4,9,11 in the key-metric summary")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    add_model_args(parser)
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    return launch(test_worker, train_mesh(device, args.batch_size),
                  args)[0]


def test_worker(mesh: Mesh, args: argparse.Namespace) -> dict:
    """One rank of ``mvt-torch-test``: the eval forward and the beam
    decode of its block of every batch, the outputs gathered on every
    rank; rank 0 prints the table and writes ``--save_output``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config_from_args(args)
    test_data = read_data(args.prepropath, "test", cfg)

    # a checkpoint with more grid scales than the model is pruned to it
    # (the published flow trains --use_grids 1,1 and tests at 1,0)
    template = Multiverse.init(cfg)
    if args.load_from is not None:
        model = load_checkpoint(args.load_from, template)
    else:
        ckpt = CheckpointManager(run_dir(
            args.outbasepath, args.modelname, args.runId), create=False)
        model = ckpt.restore_params(template, best=args.load_best)
    model = replicate(mesh, model)
    eval_step = make_sharded_eval_step(cfg, mesh)
    # eval_fn and beam_fn get the same batch back to back: upload the
    # rank's block once
    placed = {"src": None, "dev": None}

    def on_device(batch):
        if placed["src"] is not batch:
            placed["src"], placed["dev"] = batch, shard_batch(mesh, batch)
        return placed["dev"]

    def eval_fn(batch):
        cl, rg = eval_step(model, on_device(batch))
        return ({i: v.cpu().numpy() for i, v in cl.items()},
                {i: v.cpu().numpy() for i, v in rg.items()})

    beam_fn = None
    if cfg.use_beam_search:
        beam_step = make_sharded_beam_step(cfg, mesh)

        def beam_fn(batch):
            beam, _ = beam_step(model, on_device(batch))
            return BeamOutputs(*(None if t is None else t.cpu().numpy()
                                 for t in beam))

    perf = evaluate(test_data, cfg, eval_fn, batch_size=args.batch_size,
                    per_scene_eval=args.per_scene_eval,
                    use_gt_grid=args.use_gt_grid,
                    save_output=args.save_output, beam_step_fn=beam_fn,
                    only_scene=args.only_scene,
                    write_output=mesh.is_main)
    if not mesh.is_main:
        return perf

    # the metric table (reference: code/test.py:157-182): every metric
    # on its own "key, value" line, then the key metrics' names and
    # values on two lines
    print("performance:")
    key_metrics = []
    for i in cfg.active_scales:
        key_metrics += ["grid%d_acc" % i, "grid%d_traj_ade" % i,
                        "grid%d_traj_fde" % i]
        if args.show_center_only:
            key_metrics += ["grid%d_traj_centerOnly_ade" % i,
                            "grid%d_traj_centerOnly_fde" % i]
        if args.show_grid_acc_at_T:
            key_metrics += ["grid%d_acc_@T=%d" % (i, t)
                            for t in (0, 4, 9, 11)]
    if args.per_scene_eval:
        scenes = ["0000", "0002", "0400", "0401", "0500"]
        key_metrics += ["%s_ade" % s for s in scenes]
        key_metrics += ["%s_fde" % s for s in scenes]
    numbers = []
    for k in sorted(perf):
        print("%s, %s" % (k, perf[k]))
        if k in key_metrics:
            numbers.append(("%s" % perf[k], k))
    print(" ".join(k for _, k in numbers))
    print(" ".join(v for v, _ in numbers))
    return perf


if __name__ == "__main__":
    main()
