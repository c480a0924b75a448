"""Shared argparse -> MultiverseConfig plumbing of the port's commands.

The port's own copy of ``multiverse_tpu/cli/common.py``
(``add_model_args``, ``add_train_args``, ``config_from_args``,
``LossBuffer``): the same flag names, defaults and help, so a command
line of the JAX package's ``mvt-train`` or ``mvt-serve`` carries over.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from multiverse_torch.config import MultiverseConfig


class LossBuffer:
    """Device-side buffer of the per-step losses of a train loop.

    A per-step fetch of the loss would synchronise the host with the
    card once per step; instead the scalars stay on the device and one
    batched ``.cpu()`` of them all, stacked, runs every
    ``--loss_fetch_period`` steps. The NaN abort (reference:
    code/train.py:256-259) then fires within one period of the bad step.
    ``aux_mas`` ({"wd": MovingAverage}) are side series fed per step
    through the same transfer.
    """

    def __init__(self, loss_ma, period: int, aux_mas: dict = None):
        self._ma = loss_ma
        self._period = max(1, period)
        self._aux_mas = aux_mas or {}
        self._pending: list = []   # [(step, scalar, {name: scalar})]

    def put(self, step: int, loss: torch.Tensor, aux: dict = None) -> None:
        self._pending.append((step, loss, aux or {}))
        if len(self._pending) >= self._period:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        names = list(self._aux_mas)
        rows = [torch.stack([loss.float().reshape(())] + [
            aux[k].float().reshape(()) for k in names])
            for _, loss, aux in self._pending]
        values = torch.stack(rows).cpu().tolist()   # one transfer
        steps = [s for s, _, _ in self._pending]
        self._pending.clear()
        for s, row in zip(steps, values):
            if math.isnan(row[0]):
                print("nan loss at step %d" % s)
                sys.exit(1)
            self._ma.put(row[0])
            for k, v in zip(names, row[1:]):
                self._aux_mas[k].put(v)


def add_model_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--obs_len", type=int, default=8)
    parser.add_argument("--pred_len", type=int, default=12)
    parser.add_argument("--emb_size", type=int, default=32)
    parser.add_argument("--enc_hidden_size", type=int, default=256)
    parser.add_argument("--dec_hidden_size", type=int, default=256)
    parser.add_argument("--activation_func", type=str, default="tanh",
                        help="relu/lrelu/tanh")
    parser.add_argument("--scene_conv_kernel", default=3, type=int)
    parser.add_argument("--scene_h", default=36, type=int)
    parser.add_argument("--scene_w", default=64, type=int)
    parser.add_argument("--scene_class", default=11, type=int)
    parser.add_argument("--scene_conv_dim", default=64, type=int)
    parser.add_argument("--convlstm_kernel", default=3, type=int)
    parser.add_argument("--scene_grid_strides", default="2,4")
    parser.add_argument("--use_grids", default="1,0")
    parser.add_argument("--video_h", type=int, default=1080)
    parser.add_argument("--video_w", type=int, default=1920)
    parser.add_argument("--use_gnn", action="store_true")
    parser.add_argument("--use_scene_enc", action="store_true")
    parser.add_argument("--use_single_decoder", action="store_true")
    parser.add_argument("--use_teacher_forcing", action="store_true")
    parser.add_argument("--train_w_onehot", action="store_true")
    parser.add_argument("--use_soft_grid_class", action="store_true")
    parser.add_argument("--soft_grid", default=1, type=int)
    parser.add_argument("--mask_grid_regression", action="store_true")
    parser.add_argument("--use_beam_search", action="store_true")
    parser.add_argument("--diverse_beam", action="store_true")
    parser.add_argument("--diverse_gamma", type=float, default=1.0)
    parser.add_argument("--fix_num_timestep", type=int, default=0)
    parser.add_argument("--beam_size", type=int, default=5)
    parser.add_argument("--norm_input", action="store_true",
                        help="scale scene one-hot maps to [-1,1] before "
                             "the scene CNN (a model trained with this "
                             "must be run with it)")
    parser.add_argument("--compute_dtype", default="float32",
                        help="float32|bfloat16 conv/matmul compute")
    parser.add_argument("--decode_quant", default="none",
                        help="none|int8|int8a|int8_dyn: int8 tier of the "
                             "fused decode step (with bfloat16)")
    parser.add_argument("--beam_select", default="twostage",
                        choices=["twostage", "dense"],
                        help="beam successor selection: 'twostage' "
                             "(per-beam top-K then global top-K over "
                             "K*K, the same winners and ties as dense) "
                             "or 'dense' (the full-row form)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each encoder/decoder step in the "
                             "backward (torch.utils.checkpoint) instead "
                             "of keeping its activations")
    parser.add_argument("--fuse_scan_pairs",
                        action=argparse.BooleanOptionalAction,
                        default=True,
                        help="accepted for command lines of the JAX "
                             "package; the port runs the separate scans "
                             "(the same math)")


def add_train_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--grid_loss_weight", default=1.0, type=float)
    parser.add_argument("--grid_reg_loss_weight", default=0.1, type=float)
    parser.add_argument("--wd", default=0.0001, type=float)
    parser.add_argument("--clip_gradient_norm", default=10.0, type=float)
    parser.add_argument("--optimizer", default="adadelta")
    parser.add_argument("--use_cosine_lr", action="store_true")
    parser.add_argument("--learning_rate_decay", default=0.95, type=float)
    parser.add_argument("--num_epoch_per_decay", default=2.0, type=float)
    parser.add_argument("--init_lr", default=0.2, type=float)
    parser.add_argument("--emb_lr", type=float, default=1.0)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_epochs", type=int, default=100)
    parser.add_argument("--keep_prob", default=1.0, type=float)


def config_from_args(args: argparse.Namespace) -> MultiverseConfig:
    grid_kw = MultiverseConfig.parse_strides(
        args.scene_grid_strides, args.use_grids)
    train_kw = {name: getattr(args, name) for name in (
        "grid_loss_weight", "grid_reg_loss_weight", "wd",
        "clip_gradient_norm", "optimizer", "use_cosine_lr",
        "learning_rate_decay", "num_epoch_per_decay", "init_lr", "emb_lr",
        "batch_size", "num_epochs", "keep_prob", "remat", "fuse_scan_pairs")
        if hasattr(args, name)}
    return MultiverseConfig(
        obs_len=args.obs_len,
        pred_len=args.pred_len,
        emb_size=args.emb_size,
        enc_hidden_size=args.enc_hidden_size,
        dec_hidden_size=args.dec_hidden_size,
        activation=args.activation_func,
        scene_conv_kernel=args.scene_conv_kernel,
        scene_h=args.scene_h,
        scene_w=args.scene_w,
        scene_class=args.scene_class,
        scene_conv_dim=args.scene_conv_dim,
        convlstm_kernel=args.convlstm_kernel,
        video_h=args.video_h,
        video_w=args.video_w,
        use_gnn=args.use_gnn,
        use_scene_enc=args.use_scene_enc,
        use_single_decoder=args.use_single_decoder,
        use_teacher_forcing=args.use_teacher_forcing,
        train_w_onehot=args.train_w_onehot,
        use_soft_grid_class=args.use_soft_grid_class,
        soft_grid=args.soft_grid,
        mask_grid_regression=args.mask_grid_regression,
        use_beam_search=args.use_beam_search,
        diverse_beam=args.diverse_beam,
        diverse_gamma=args.diverse_gamma,
        fix_num_timestep=args.fix_num_timestep,
        beam_size=args.beam_size,
        norm_input=args.norm_input,
        compute_dtype=args.compute_dtype,
        decode_quant=args.decode_quant,
        beam_select=args.beam_select,
        **grid_kw,
        **train_kw,
    ).validate()
