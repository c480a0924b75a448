"""Seeded input generators, frozen for the benchmark.

A copy of the port's ``synthesize_multifuture_inputs``
(``multiverse_torch/inference.py``) as it stood when the benchmark was
defined, over plain numpy and a dict of arrays, so that a change to
the program cannot change what a cell feeds it. A traffic file
(``mvbench/workloads/<cell>.json``) gives its sizes.

``--seed`` may exceed 32 bits; numpy's ``RandomState`` takes its low 32
bits (:func:`np_seed`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mvbench.traffic.geometry import grid_shape, rasterize


def np_seed(seed: int, salt: int = 0) -> int:
    return (int(seed) + int(salt)) % (1 << 32)


def grids(model: dict):
    return [grid_shape(model["scene_h"], model["scene_w"], s)
            for s in model["scene_grid_strides"]]


def one_hot_maps(rnd: np.random.RandomState, n: int, model: dict
                 ) -> np.ndarray:
    """``n`` random one-hot scene maps [n, SH, SW, C] uint8."""
    sh, sw, c = model["scene_h"], model["scene_w"], model["scene_class"]
    labels = rnd.randint(0, c, size=(n, sh, sw))
    return (labels[..., None] == np.arange(c)).astype(np.uint8)


def multifuture_inputs(model: dict, num_traj: int, seed: int,
                       min_pred_len: int, max_pred_len: int
                       ) -> Dict[str, np.ndarray]:
    """Random-walk observations with the shapes of a Forking Paths run
    (``synthesize_multifuture_inputs``): obs [N, T_obs, 2] px, their
    cells and offsets on every grid, one random scene map per two
    trajectories, each observed step reading one at random, and each
    trajectory's future length uniform in [min, max]."""
    rnd = np.random.RandomState(np_seed(seed))
    vw, vh, T_obs = model["video_w"], model["video_h"], model["obs_len"]
    gr = grids(model)
    start = rnd.uniform([vw * 0.2, vh * 0.2], [vw * 0.8, vh * 0.8],
                        size=(num_traj, 1, 2))
    steps = rnd.normal(0.0, 25.0, size=(num_traj, T_obs, 2))
    obs = (start + np.cumsum(steps, axis=1)).astype(np.float32)
    obs[..., 0] = np.clip(obs[..., 0], 1.0, vw - 1.0)
    obs[..., 1] = np.clip(obs[..., 1], 1.0, vh - 1.0)
    cls = np.zeros((num_traj, len(gr), T_obs), np.int32)
    tgts = [np.zeros((num_traj, T_obs, h, w, 2), np.float32)
            for (h, w) in gr]
    for n in range(num_traj):
        c, t = rasterize(obs[n], vh, vw, gr)
        cls[n] = c
        for i in range(len(gr)):
            tgts[i][n] = t[i]
    F = max(1, num_traj // 2)
    scene_feat = one_hot_maps(rnd, F, model)
    obs_scene = rnd.randint(0, F, size=(num_traj, T_obs)).astype(np.int32)
    pred_lengths = rnd.randint(min_pred_len, max_pred_len + 1,
                               size=num_traj).astype(np.int32)
    return {
        "traj_ids": ["scene_%04d_%d_cam1" % (n, n) for n in range(num_traj)],
        "obs_traj": obs, "obs_grid_class": cls, "obs_grid_target": tgts,
        "obs_scene": obs_scene, "scene_feat": scene_feat,
        "pred_lengths": pred_lengths,
    }
