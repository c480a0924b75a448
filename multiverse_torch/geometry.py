"""Grid geometry: cell centers, trajectory -> cell rasterisation, dense
regression targets, and one-hot cell maps.

Port of ``multiverse_tpu/geometry.py``: the numpy helpers are the same
functions (that module imports jax at load time, so they are kept here),
and ``xy_to_cell`` and ``one_hot_grid`` work on torch tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def grid_centers(video_h: int, video_w: int, h: int, w: int) -> np.ndarray:
    """Per-cell pixel-space centers, shape [h, w, 2] ((x, y) order)."""
    h_gap, w_gap = video_h / h, video_w / w
    centers_x = np.cumsum(np.full(w, w_gap)) - w_gap / 2.0
    centers_y = np.cumsum(np.full(h, h_gap)) - h_gap / 2.0
    xx = np.tile(centers_x[None, :], [h, 1])
    yy = np.tile(centers_y[:, None], [1, w])
    return np.stack((xx, yy), axis=-1)


def xy_to_cell_np(
    xy: np.ndarray, video_h: int, video_w: int, h: int, w: int
) -> np.ndarray:
    """Pixel (x, y) -> flat cell id in [0, h*w), ceil semantics, clamped
    to the border cell. Returns [...] int32 (row-major over (y, x))."""
    h_gap, w_gap = video_h / h, video_w / w
    x_idx = np.ceil(xy[..., 0] / w_gap).astype(np.int64)
    y_idx = np.ceil(xy[..., 1] / h_gap).astype(np.int64)
    x_idx = np.clip(x_idx, 1, w) - 1
    y_idx = np.clip(y_idx, 1, h) - 1
    return (y_idx * w + x_idx).astype(np.int32)


def xy_to_cell(xy: torch.Tensor, video_h: int, video_w: int, h: int,
               w: int) -> torch.Tensor:
    """Torch twin of :func:`xy_to_cell_np` for the device, in the
    tensor's own type (f32 for the serving step, as the JAX package's
    ``xy_to_cell``). Returns [...] int32."""
    h_gap, w_gap = video_h / h, video_w / w
    x_idx = torch.ceil(xy[..., 0] / w_gap).to(torch.int32)
    y_idx = torch.ceil(xy[..., 1] / h_gap).to(torch.int32)
    x_idx = torch.clamp(x_idx, 1, w) - 1
    y_idx = torch.clamp(y_idx, 1, h) - 1
    return y_idx * w + x_idx


def dense_regression_targets_np(
    xy: np.ndarray, centers: np.ndarray
) -> np.ndarray:
    """target[t, i, j] = xy[t] - center[i, j]: [T, h, w, 2] float32."""
    return (xy[:, None, None, :] - centers[None, :, :, :]).astype(np.float32)


def rasterize_traj_np(
    xy: np.ndarray,
    video_h: int,
    video_w: int,
    grids: Tuple[Tuple[int, int], ...],
) -> Tuple[np.ndarray, list]:
    """Rasterise one [T, 2] trajectory onto every grid scale. Returns
    (cell ids [num_scales, T] int32, per scale [T, h, w, 2] targets)."""
    T = xy.shape[0]
    classes = np.zeros((len(grids), T), dtype=np.int32)
    targets = []
    for i, (h, w) in enumerate(grids):
        classes[i] = xy_to_cell_np(xy, video_h, video_w, h, w)
        centers = grid_centers(video_h, video_w, h, w)
        targets.append(dense_regression_targets_np(xy, centers))
    return classes, targets


def one_hot_grid(cell_ids: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Flat cell ids [...] -> float32 one-hot maps [..., h, w, 1]."""
    oh = torch.nn.functional.one_hot(cell_ids.long(), h * w).float()
    return oh.reshape(tuple(cell_ids.shape) + (h, w, 1))
