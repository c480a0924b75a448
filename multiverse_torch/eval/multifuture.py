"""Multi-future evaluation: minADE/minFDE over K hypotheses and grid
NLL from beam probabilities.

The port's own copy of ``multiverse_tpu/eval/multifuture.py`` (whose
geometry import needs jax), over ``multiverse_torch.geometry``: metric-
exact rebuilds of reference: code/multifuture_eval_trajs.py and
code/multifuture_eval_trajs_prob.py, vectorized, as library functions
that run on in-memory outputs as well as on the pickle files. The
commands (``multiverse_torch.cli``) keep the reference's argument order
and print format.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterable, Optional

import numpy as np

from multiverse_torch.geometry import xy_to_cell_np

CAMERA_GROUPS = ("45-degree", "top-down", "all")


def _camera_group(traj_id: str) -> str:
    """cam4 is the top-down view (reference:
    code/multifuture_eval_trajs.py:71)."""
    return "top-down" if traj_id.split("_")[-1] == "cam4" else "45-degree"


def _load_gt(gt_path: str, traj_id: str) -> dict:
    with open(os.path.join(gt_path, "%s.p" % traj_id), "rb") as f:
        return pickle.load(f)


def evaluate_multifuture_trajs(
    prediction: Dict[str, list],
    gt_path: str,
    gt_trajs: Optional[Dict[str, dict]] = None,
) -> Dict[str, float]:
    """minADE_K / minFDE_K per GT future, grouped by camera.

    For each ground-truth future: over the K predicted trajectories,
    pick the one with minimum summed displacement (ADE pick) and the
    one with minimum final displacement (FDE pick); the chosen
    trajectory's per-timestep errors all enter the average
    (reference: code/multifuture_eval_trajs.py:41-85 — note the mean is
    over *timesteps*, not over futures).

    Args:
        prediction: {traj_id: [K][T][2]}.
        gt_path: directory of per-traj_id GT pickles
            ({future_id: {"x_agent_traj": [(frame, pid, x, y), ...]}}).
        gt_trajs: optional preloaded GT dict (overrides gt_path reads).
    Returns:
        {"minade_45-degree": ..., "minfde_top-down": ..., ...}
    """
    ade_err = {k: [] for k in CAMERA_GROUPS}
    fde_err = {k: [] for k in CAMERA_GROUPS}

    for traj_id, preds in prediction.items():
        group = _camera_group(traj_id)
        gt = gt_trajs[traj_id] if gt_trajs is not None \
            else _load_gt(gt_path, traj_id)
        preds = np.asarray([np.asarray(p, np.float64) for p in preds])

        for future_id in gt:
            gt_traj = np.asarray(
                [pt[2:] for pt in gt[future_id]["x_agent_traj"]],
                np.float64)
            T = len(gt_traj)
            if len(preds[0]) < T:
                raise ValueError(
                    f"{traj_id}: prediction length {len(preds[0])} < "
                    f"GT future length {T}")
            # [K, T] displacement per hypothesis per step
            d = np.sqrt(
                ((preds[:, :T] - gt_traj[None]) ** 2).sum(-1))
            ade_pick = d.sum(axis=1).argmin()
            fde_pick = d[:, -1].argmin()
            ade_err[group].extend(d[ade_pick].tolist())
            fde_err[group].append(float(d[fde_pick, -1]))
            ade_err["all"].extend(d[ade_pick].tolist())
            fde_err["all"].append(float(d[fde_pick, -1]))

    out: Dict[str, float] = {}
    for k in CAMERA_GROUPS:
        out["minade_%s" % k] = float(np.mean(ade_err[k])) \
            if ade_err[k] else float("nan")
        out["minfde_%s" % k] = float(np.mean(fde_err[k])) \
            if fde_err[k] else float("nan")
    return out


def _softmax(x: np.ndarray, axis=None) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    y = np.exp(x)
    return y / y.sum(axis=axis, keepdims=True)


def evaluate_multifuture_nll(
    predictions: Dict[str, tuple],
    gt_path: str,
    scene_h: int = 18,
    scene_w: int = 32,
    video_h: int = 1080,
    video_w: int = 1920,
    time_list: Iterable[int] = (0, 1, 2, 3, 4),
    gt_trajs: Optional[Dict[str, dict]] = None,
) -> Dict[str, float]:
    """Grid NLL of GT cells under the beam mixture at early timesteps.

    Per trajectory: per-cell probability = softmax over beams'
    per-step logits, mixture-weighted by the softmaxed beam logprobs;
    NLL averaged over the GT futures alive at that timestep
    (reference: code/multifuture_eval_trajs_prob.py:25-43, 79-109).

    Args:
        predictions: {traj_id: (beam_logits [1, K, T, H*W],
                                beam_logprobs [1, K])}.
    Returns:
        {"nll_T=1": ..., ..., "count_T=1": ...}
    """
    nlls = {t: [] for t in time_list}
    eps = np.finfo(float).eps

    for traj_id, (beams, logprobs) in predictions.items():
        gt = gt_trajs[traj_id] if gt_trajs is not None \
            else _load_gt(gt_path, traj_id)
        probs = _softmax(np.squeeze(np.asarray(logprobs)))      # [K]
        cell_p = _softmax(np.squeeze(np.asarray(beams)), axis=-1)  # [K,T,HW]
        if cell_p.shape[-1] != scene_h * scene_w:
            raise ValueError(
                f"{traj_id}: beam grid {cell_p.shape[-1]} != "
                f"{scene_h}x{scene_w}")

        for t in time_list:
            gt_xys = [
                gt[fid]["x_agent_traj"][t][2:]
                for fid in gt
                if len(gt[fid]["x_agent_traj"]) > t
            ]
            if not gt_xys:
                continue
            # mixture over beams at step t
            grid_prob = (cell_p[:, t, :] * probs[:, None]).sum(0)  # [HW]
            cells = xy_to_cell_np(
                np.asarray(gt_xys, np.float64),
                video_h, video_w, scene_h, scene_w)
            nll = float(np.mean(-np.log(grid_prob[cells] + eps)))
            nlls[t].append(nll)

    out: Dict[str, float] = {}
    for t in time_list:
        key = "T=%d" % (t + 1)
        out["nll_%s" % key] = float(np.mean(nlls[t])) \
            if nlls[t] else float("nan")
        out["count_%s" % key] = len(nlls[t])
    return out
