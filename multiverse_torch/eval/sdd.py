"""Stanford-Drone evaluation: pixel errors rescaled to each video's
original resolution.

The port's own copy of ``multiverse_tpu/eval/sdd.py``.

reference: SimAug/code/evaluate_sdd.py — predictions are made in
1920×1080 space; each video's error is scaled by the mean of its
original-to-eval resolution ratios.
"""

from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np

EVAL_RESOLUTION = (1920.0, 1080.0)


def load_resize_records(changelst_path: str) -> Dict[str, float]:
    """Parse the resize-record lst: `video_id,WxH,rotated` per line
    (reference: SimAug/code/evaluate_sdd.py:27-33)."""
    scales: Dict[str, float] = {}
    with open(changelst_path) as f:
        for line in f:
            video_id, ori_reso, rotated = line.strip().split(",")
            w, h = ori_reso.split("x")
            if rotated == "True":
                w, h = h, w
            scales[video_id] = (
                float(w) / EVAL_RESOLUTION[0]
                + float(h) / EVAL_RESOLUTION[1]) / 2.0
    return scales


def parse_seq_id(seq_id) -> Tuple[str, str, str]:
    """`videoA_0_frameidx_trackid` → (video_id, frame_idx, track_id)
    (reference: SimAug/code/evaluate_sdd.py:14-19)."""
    if isinstance(seq_id, bytes):
        seq_id = seq_id.decode()
    parts = str(seq_id).split("_")
    return "_".join(parts[:2]), parts[-2], parts[-1]


def evaluate_sdd(
    output_pickle: str,
    changelst_path: str,
    eval_grid: int = 0,
) -> Dict[str, float]:
    """ADE/FDE with per-video rescaling (reference:
    SimAug/code/evaluate_sdd.py:35-68)."""
    scales = load_resize_records(changelst_path)
    with open(output_pickle, "rb") as f:
        data = pickle.load(f)

    pred_gt = np.asarray(data["pred_gt_list"], np.float64)
    pred_traj = np.asarray(data["grid%s_pred_traj" % eval_grid], np.float64)

    diffs, scale_changes = [], []
    for n in range(len(pred_gt)):
        video_id, _, _ = parse_seq_id(data["seq_ids"][n])
        d = np.sqrt(((pred_gt[n] - pred_traj[n]) ** 2).sum(axis=1))
        diffs.append(d * scales[video_id])
        scale_changes.append(scales[video_id])

    flat = np.concatenate(diffs)
    return {
        "ade": float(flat.mean()),
        "fde": float(np.mean([d[-1] for d in diffs])),
        "scale_changes": float(np.mean(scale_changes)),
    }
