"""Seeded pedestrian walks and the flagship recipe's flags, shared by
the two campaigns (the port's copy of ``campaign.py``'s walks).

A walker starts at a uniform point of the ``±LIM`` m area (or within
``center_r`` of its centre), heading anywhere, at 0.35-0.7 m a 0.4 s
sample; 30% of walkers curve 2-6 degrees a sample. Each sample adds 3
degrees of heading noise and 3 cm of position noise; a walker reflects
off the area's edge. The same ``RandomState`` draws give the same walks
as the JAX package's campaign."""

from __future__ import annotations

import math

import numpy as np

LIM = 7.0          # world-coordinate reflection bound (camera sees ~10m)
CAM_W, CAM_H = 192, 108
DROP = 10          # ethucy drop_frame
MF_START = 32      # ethucy start index (prepared_data.FRAME_RANGE)
OBS_LEN, PRED_LEN = 8, 12

# the published flagship training command, TRAINING.md Step 2
# (scene_class from the generated id2name; video dims are the camera's)
FLAGSHIP_MODEL = [
    "--obs_len", "8", "--pred_len", "12", "--emb_size", "32",
    "--enc_hidden_size", "256", "--dec_hidden_size", "256",
    "--activation_func", "tanh", "--scene_h", "36", "--scene_w", "64",
    "--scene_conv_kernel", "3", "--scene_conv_dim", "64",
    "--scene_grid_strides", "2,4", "--use_grids", "1,1",
    "--video_h", str(CAM_H), "--video_w", str(CAM_W),
    "--use_gnn", "--use_scene_enc", "--train_w_onehot",
    "--scene_class", "11",
]
FLAGSHIP_TRAIN = [
    "--wd", "0.001", "--keep_prob", "1.0", "--batch_size", "20",
    "--init_lr", "0.3", "--learning_rate_decay", "0.95",
    "--num_epoch_per_decay", "2.0", "--grid_loss_weight", "1.0",
    "--grid_reg_loss_weight", "0.2", "--val_grid_num", "0",
]


def _reflect(state):
    x, y, th = state["x"], state["y"], state["th"]
    if abs(x) > LIM:
        th = math.pi - th
        x = max(-LIM, min(LIM, x))
    if abs(y) > LIM:
        th = -th
        y = max(-LIM, min(LIM, y))
    state.update(x=x, y=y, th=th)


def walk_init(rnd, center_r=None):
    if center_r is None:
        x, y = rnd.uniform(-LIM + 1, LIM - 1, 2)
    else:
        r, a = rnd.uniform(0, center_r), rnd.uniform(0, 2 * math.pi)
        x, y = r * math.cos(a), r * math.sin(a)
    return {
        "x": float(x), "y": float(y),
        "th": float(rnd.uniform(0, 2 * math.pi)),
        # meters per 0.4s sample
        "v": float(rnd.uniform(0.35, 0.7)),
        # 30% of walkers curve gently (deg/sample)
        "om": (math.radians(rnd.uniform(2.0, 6.0)) * rnd.choice([-1, 1])
               if rnd.random() < 0.3 else 0.0),
    }


def walk_steps(rnd, state, n):
    """Advance `state` n samples; returns [n, 2] xy."""
    out = np.zeros((n, 2))
    for i in range(n):
        state["th"] += state["om"] + rnd.normal(0.0, math.radians(3.0))
        state["x"] += state["v"] * math.cos(state["th"]) \
            + rnd.normal(0.0, 0.03)
        state["y"] += state["v"] * math.sin(state["th"]) \
            + rnd.normal(0.0, 0.03)
        _reflect(state)
        out[i] = (state["x"], state["y"])
    return out


def rows_from_xy(xy, pid, frame0=0):
    return [(frame0 + i * DROP, pid, float(p[0]), float(p[1]), 0.5)
            for i, p in enumerate(xy)]
