"""Grid geometry for the generators and the reference: cell centers,
pixel -> cell rasterisation and dense regression targets (numpy).

Frozen copies of the numpy helpers of ``multiverse_torch/geometry.py``.
"""

from __future__ import annotations

import numpy as np


def grid_shape(scene_h: int, scene_w: int, stride: int):
    # banker's rounding, as the configuration derives its grids
    return int(round(scene_h / stride)), int(round(scene_w / stride))


def grid_centers(video_h: int, video_w: int, h: int, w: int) -> np.ndarray:
    """Per-cell pixel-space centers, [h, w, 2] in (x, y) order."""
    h_gap, w_gap = video_h / h, video_w / w
    centers_x = np.cumsum(np.full(w, w_gap)) - w_gap / 2.0
    centers_y = np.cumsum(np.full(h, h_gap)) - h_gap / 2.0
    xx = np.tile(centers_x[None, :], [h, 1])
    yy = np.tile(centers_y[:, None], [1, w])
    return np.stack((xx, yy), axis=-1)


def xy_to_cell(xy: np.ndarray, video_h: int, video_w: int, h: int,
               w: int) -> np.ndarray:
    """Pixel (x, y) -> flat cell id, ceil semantics, clamped to the
    border cell; int32."""
    h_gap, w_gap = video_h / h, video_w / w
    x_idx = np.ceil(xy[..., 0] / w_gap).astype(np.int64)
    y_idx = np.ceil(xy[..., 1] / h_gap).astype(np.int64)
    x_idx = np.clip(x_idx, 1, w) - 1
    y_idx = np.clip(y_idx, 1, h) - 1
    return (y_idx * w + x_idx).astype(np.int32)


def rasterize(xy: np.ndarray, video_h: int, video_w: int, grids):
    """One [T, 2] trajectory onto every grid: (cell ids [S, T] int32,
    per scale [T, h, w, 2] offsets xy - center)."""
    classes = np.zeros((len(grids), xy.shape[0]), dtype=np.int32)
    targets = []
    for i, (h, w) in enumerate(grids):
        classes[i] = xy_to_cell(xy, video_h, video_w, h, w)
        centers = grid_centers(video_h, video_w, h, w)
        targets.append((xy[:, None, None, :] - centers[None]).astype(
            np.float32))
    return classes, targets
