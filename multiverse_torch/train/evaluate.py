"""Evaluation: grid accuracy, ADE/FDE from center+offset reconstruction.

The port's own copy of ``multiverse_tpu/train/evaluate.py`` (numpy; it
reads the port's dataset). reference: code/pred_utils.py:354-586
`evaluate` — the metric math is reproduced exactly but vectorized per
batch (the reference loops per example per timestep in Python).
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, Optional

import numpy as np

from multiverse_torch.config import MultiverseConfig
from multiverse_torch.data.dataset import TrajectoryDataset

ACTEV_SCENES = ("0000", "0002", "0400", "0401", "0500")


def get_scene(videoname: str) -> str:
    """Scene/camera token from an ActEV videoname
    (reference: code/pred_utils.py:303-307)."""
    s = videoname.split("_S_")[-1]
    return s.split("_")[0][:4]


def evaluate(
    dataset: TrajectoryDataset,
    cfg: MultiverseConfig,
    step_fn: Callable,
    batch_size: Optional[int] = None,
    per_scene_eval: bool = False,
    use_gt_grid: bool = False,
    save_output: Optional[str] = None,
    beam_step_fn: Optional[Callable] = None,
    only_scene: Optional[str] = None,
    write_output: bool = True,
) -> Dict[str, float]:
    """Run the full split and compute the reference metric table.

    step_fn(batch: Batch) -> (class_logits dict, reg dict) as numpy
    arrays [N, T, h, w, 1] / [N, T, h, w, 2] (the numpy batch goes in:
    the step uploads it).
    beam_step_fn: optional, returns BeamOutputs for the active scale.
    only_scene: restrict every metric (and the output pickle) to the
        examples whose traj_key scene matches — the reference skips
        non-matching examples entirely inside its eval loop
        (reference: SimAug/code/pred_utils.py:501-505, exposed on
        SimAug/code/test.py:50 and train.py:51).
    write_output: False on a data-parallel rank other than 0: it makes
        every step call rank 0 makes (``save_output`` decides whether
        the beam step runs) but writes no pickle.
    """
    batch_size = batch_size or cfg.batch_size
    pred_len = cfg.pred_len
    S = cfg.num_scales
    if len(cfg.active_scales) != 1 and (per_scene_eval
                                        or beam_step_fn is not None):
        # the per-scene lists and the beam pickle fields are keyed per
        # EXAMPLE: a second active scale would append twice per example
        # and silently corrupt them (the reference asserts exactly one
        # grid for these paths, code/pred_utils.py:375,424)
        raise ValueError(
            "per_scene_eval / beam outputs need exactly one active "
            "grid scale (got use_grids with %d active)"
            % len(cfg.active_scales))

    correct = {i: [] for i in range(S)}
    correct_at_t = {i: [[] for _ in range(pred_len)] for i in range(S)}
    l2 = {i: [] for i in range(S)}          # [n][pred_len] displacement
    l2_center = {i: [] for i in range(S)}
    l2_scenes = {s: [] for s in ACTEV_SCENES}

    out_data = None
    if save_output is not None:
        out_data = {"obs_list": [], "pred_gt_list": [], "seq_ids": []}
        for i in range(S):
            out_data["grid%s_class" % i] = []
            out_data["grid%s_gt_class" % i] = []
            out_data["grid%s_pred_traj" % i] = []
            out_data["grid_center_%d" % i] = dataset.grid_centers[i]
        if beam_step_fn is not None:
            out_data["beam_grid_ids"] = []
            out_data["beam_logprobs"] = []

    for batch, extras in dataset.get_batches(
            batch_size, full=True, shuffle=False):
        class_logits, reg_out = step_fn(batch)
        n = extras["original_batch_size"]
        # ex_idx: original example indices that survive the scene
        # filter — all downstream per-example arrays are sliced to it,
        # while extras/beam lookups go through the original index
        if only_scene is not None:
            ex_idx = np.asarray(
                [a for a in range(n)
                 if get_scene(extras["traj_key"][a]) == only_scene],
                np.int64)
        else:
            ex_idx = np.arange(n)
        beam = None
        if beam_step_fn is not None and out_data is not None:
            # beam ids/logprobs only feed the output pickle
            # (reference: code/pred_utils.py:379-394) — without
            # --save_output the K-beam decode would be paid and thrown
            # away on every eval batch
            beam = beam_step_fn(batch)

        for i in cfg.active_scales:
            h, w = cfg.scene_grids[i]
            logits = np.asarray(class_logits[i])[:n].reshape(
                n, pred_len, h * w)[ex_idx]
            sel = logits.argmax(axis=2)  # [m, T]
            gt_cells = extras["pred_grid_class"][:n, i][ex_idx]  # [m, T]
            if use_gt_grid:
                sel = gt_cells

            ok = sel == gt_cells
            correct[i].extend(ok.reshape(-1).tolist())
            for t in range(pred_len):
                correct_at_t[i][t].extend(ok[:, t].tolist())

            centers = dataset.grid_centers[i].reshape(-1, 2)
            reg = np.asarray(reg_out[i])[:n].reshape(
                n, pred_len, h * w, 2)[ex_idx]
            off = np.take_along_axis(
                reg, sel[..., None, None], axis=2)[:, :, 0]
            pred_pts = centers[sel] + off              # [m, T, 2]
            center_pts = centers[sel]

            gt_traj = extras["pred_traj"][:n][ex_idx]  # [m, T, 2]
            d = np.sqrt(((gt_traj - pred_pts) ** 2).sum(-1))  # [m, T]
            dc = np.sqrt(((gt_traj - center_pts) ** 2).sum(-1))
            l2[i].extend(d.tolist())
            l2_center[i].extend(dc.tolist())

            if per_scene_eval:
                for j, a in enumerate(ex_idx):
                    scene = get_scene(extras["traj_key"][a])
                    if scene in l2_scenes:
                        l2_scenes[scene].append(d[j])

            if out_data is not None:
                # j indexes the filtered per-example arrays, a the
                # original batch (extras / beam outputs)
                for j, a in enumerate(ex_idx):
                    # divergence from the reference (intentional): the
                    # reference records seq_ids/obs/gt only when grid 0
                    # is ACTIVE (pred_utils.py:521 `if j == 0`), so a
                    # --use_grids 0,1 run writes empty id lists; here
                    # they key off the lowest ACTIVE scale so the
                    # pickle is always self-describing
                    if i == min(cfg.active_scales):
                        out_data["seq_ids"].append(extras["traj_key"][a])
                        out_data["obs_list"].append(extras["obs_traj"][a])
                        out_data["pred_gt_list"].append(gt_traj[j])
                    out_data["grid%s_pred_traj" % i].append(pred_pts[j])
                    out_data["grid%s_gt_class" % i].append(gt_cells[j])
                    out_data["grid%s_class" % i].append(logits[j])
                    if beam is not None:
                        out_data["beam_grid_ids"].append(
                            np.asarray(beam.ids)[a])
                        out_data["beam_logprobs"].append(
                            np.asarray(beam.logprobs)[a])

    perf: Dict[str, float] = {}
    for i in cfg.active_scales:
        if only_scene is not None and not l2[i]:
            # a scene filter that matched nothing is a caller error; an
            # empty split without the filter keeps the reference's
            # non-fatal nan metrics
            raise ValueError(
                "no examples matched only_scene=%r (scenes present: "
                "use --per_scene_eval to list them)" % (only_scene,))
        perf["grid%d_acc" % i] = float(np.mean(correct[i])) \
            if correct[i] else float("nan")
        for t in range(pred_len):
            perf["grid%d_acc_@T=%d" % (i, t)] = float(
                np.mean(correct_at_t[i][t])) \
                if correct_at_t[i][t] else float("nan")
        # empty-split eval stays non-fatal: nan metrics, like averaging
        # zero examples in the reference's accumulator tables
        d = np.asarray(l2[i]) if l2[i] \
            else np.full((1, pred_len), np.nan)
        dc = np.asarray(l2_center[i]) if l2_center[i] \
            else np.full((1, pred_len), np.nan)
        perf["grid%d_traj_ade" % i] = float(d.mean())
        perf["grid%d_traj_fde" % i] = float(d[:, -1].mean())
        perf["grid%d_traj_centerOnly_ade" % i] = float(dc.mean())
        perf["grid%d_traj_centerOnly_fde" % i] = float(dc[:, -1].mean())

    if per_scene_eval:
        for scene in ACTEV_SCENES:
            diffs = l2_scenes[scene]
            if diffs:
                arr = np.asarray(diffs)
                perf["%s_ade" % scene] = float(arr.mean())
                perf["%s_fde" % scene] = float(arr[:, -1].mean())
            else:
                perf["%s_ade" % scene] = 0.0
                perf["%s_fde" % scene] = 0.0

    if out_data is not None and write_output:
        # numpy string array: the reference's evaluate_sdd parses
        # numpy.str_/bytes seq ids, not plain python str
        # (reference: SimAug/code/evaluate_sdd.py:14-19)
        out_data["seq_ids"] = np.asarray(out_data["seq_ids"])
        with open(save_output, "wb") as f:
            pickle.dump(out_data, f)
        print("saved output at %s" % save_output)
    return perf
