"""Trajectory visualization primitives.

The port's copy of ``multiverse_tpu/vis/trajs.py`` (host numpy, cv2 and
scipy; no torch): the same arrays from the same inputs.

Rebuilds of the reference's overlay renderers
(reference: code/vis_multifuture_trajs_video.py:27-135,
SimAug/code/visualize_output.py, SimAug/code/visualize.py:37-47):
obs yellow / GT green / prediction red-or-heatmap, where the heatmap
rasterizes the predicted polylines, blurs with a σ=10 gaussian and
overlays an AUTUMN colormap.  The polyline rasterization here is
vectorized (the reference draws 40 interpolated points per segment in
a Python loop per pixel).

cv2 is imported lazily so headless installs can use everything that
doesn't touch images.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

OBS_COLOR = (0, 255, 255)    # BGR yellow
GT_COLOR = (0, 255, 0)       # green
PRED_COLOR = (0, 0, 255)     # red


def _cv2():
    import cv2

    return cv2


def plot_traj(img: np.ndarray, traj, color: Tuple[int, int, int],
              thickness: int = 2) -> np.ndarray:
    """Polyline overlay (reference:
    code/vis_multifuture_trajs_video.py:48-56)."""
    cv2 = _cv2()
    traj = np.asarray(traj, np.float32)
    for p1, p2 in zip(traj[:-1], traj[1:]):
        img = cv2.line(img, tuple(int(v) for v in p1),
                       tuple(int(v) for v in p2),
                       color=color, thickness=thickness)
    return img


def rasterize_polylines(
    trajs: Iterable[Sequence],
    imgh: int,
    imgw: int,
    points_per_segment: int = 40,
) -> np.ndarray:
    """Binary [imgh, imgw] mask of all trajectory polylines.

    Vectorized replacement for the per-point loop at
    reference: code/vis_multifuture_trajs_video.py:104-118 (same
    round-then-clamp index semantics).
    """
    layer = np.zeros((imgh, imgw), np.float64)
    t = np.linspace(0.0, 1.0, points_per_segment)
    for traj in trajs:
        traj = np.asarray(traj, np.float64)
        idx = np.clip(np.round(traj) - 1.0, 0.0, None)
        idx[:, 0] = np.minimum(idx[:, 0], imgw - 1)
        idx[:, 1] = np.minimum(idx[:, 1], imgh - 1)
        if len(idx) < 2:
            continue
        p1, p2 = idx[:-1], idx[1:]                       # [S, 2]
        pts = p1[:, None, :] + (p2 - p1)[:, None, :] * t[None, :, None]
        pts = pts.reshape(-1, 2).astype(np.int64)
        layer[pts[:, 1], pts[:, 0]] = 1.0
    return layer


def heatmap_overlay(
    frame: np.ndarray,
    trajs: Iterable[Sequence],
    sigma: float = 10.0,
    colormap: Optional[int] = None,
) -> np.ndarray:
    """Gaussian-blurred trajectory heatmap composited onto a frame
    (reference: code/vis_multifuture_trajs_video.py:104-135)."""
    cv2 = _cv2()
    from scipy.ndimage import gaussian_filter

    imgh, imgw = frame.shape[:2]
    layer = rasterize_polylines(trajs, imgh, imgw)
    blurred = np.uint8(gaussian_filter(layer, sigma=sigma) * 255)
    _, mask = cv2.threshold(blurred, 1, 255, cv2.THRESH_BINARY)
    cmap = cv2.COLORMAP_AUTUMN if colormap is None else colormap
    heat = cv2.applyColorMap(blurred, cmap)
    heat = cv2.bitwise_and(heat, heat, mask=mask)
    return cv2.addWeighted(frame, 1.0, heat, 1.0, 0)


def render_multifuture_frame(
    frame: np.ndarray,
    gt: dict,
    predictions: Sequence,
    show_obs: bool = False,
    use_heatmap: bool = False,
    plot_points: bool = False,
    show_less_gt: bool = False,
) -> np.ndarray:
    """One annotated frame: GT futures green, obs yellow, predictions
    red polylines or heatmap (reference:
    code/vis_multifuture_trajs_video.py:95-159)."""
    cv2 = _cv2()
    max_len = max(
        (len(gt[fid]["x_agent_traj"]) for fid in gt), default=0)

    if use_heatmap:
        frame = heatmap_overlay(frame, predictions)

    for fid in gt:
        points = gt[fid]["x_agent_traj"]
        gt_len = int(max_len / 2) if show_less_gt else len(points)
        frame = plot_traj(
            frame, [p[2:] for p in points[:gt_len]], GT_COLOR)
        if show_obs and "obs_traj" in gt[fid]:
            frame = plot_traj(
                frame, [p[2:] for p in gt[fid]["obs_traj"]], OBS_COLOR)

    for pred in predictions:
        pred = np.asarray(pred)[:max_len]
        if plot_points:
            for x, y in pred:
                frame = cv2.circle(frame, (int(x), int(y)), radius=5,
                                   color=(255, 0, 0), thickness=1)
        if not use_heatmap:
            frame = plot_traj(frame, pred, PRED_COLOR)
    return frame


def draw_grid(img: np.ndarray, grid_hw: Tuple[int, int]) -> np.ndarray:
    """Overlay the grid-cell boundaries
    (reference: SimAug/code/visualize.py:49-65)."""
    cv2 = _cv2()
    imgh, imgw = img.shape[:2]
    gh, gw = grid_hw
    for r in range(gh):
        y = int(imgh / gh * r)
        img = cv2.line(img, (0, y), (imgw, y), (255, 0, 0), 1)
    for c in range(gw):
        x = int(imgw / gw * c)
        img = cv2.line(img, (x, 0), (x, imgh), (255, 0, 0), 1)
    return img


def grid_prob_heatmap(
    frame: np.ndarray,
    cell_probs: np.ndarray,          # [H*W], sums to 1
    grid_centers: np.ndarray,        # [H*W, 2] pixel centers
    sigma: float = 10.0,
    colormap: Optional[int] = None,
    alpha: float = 0.7,
) -> np.ndarray:
    """Per-cell probability heatmap composited onto a frame: stamp
    each cell's probability at its center, gaussian-blur, min-max
    rescale, colormap (reference: SimAug/code/visualize.py:67-112)."""
    cv2 = _cv2()
    from scipy.ndimage import gaussian_filter

    imgh, imgw = frame.shape[:2]
    layer = np.zeros((imgh, imgw), np.float64)
    centers = np.asarray(grid_centers).reshape(-1, 2)
    for k, (cx, cy) in enumerate(centers):
        # clamp centers from a different calibration into the frame
        layer[min(int(cy), imgh - 1),
              min(int(cx), imgw - 1)] = float(cell_probs[k])
    blurred = gaussian_filter(layer, sigma=sigma)
    span = blurred.max() - blurred.min()
    if span > 0:
        blurred = (blurred - blurred.min()) / span
    blurred = np.uint8(blurred * 255)
    _, mask = cv2.threshold(blurred, 1, 255, cv2.THRESH_BINARY)
    cmap = cv2.COLORMAP_JET if colormap is None else colormap
    heat = cv2.applyColorMap(blurred, cmap)
    heat = cv2.bitwise_and(heat, heat, mask=mask)
    return cv2.addWeighted(frame, 1.0, heat, alpha, 0)


def grid_class_path_heatmap(
    frame: np.ndarray,
    cell_ids: np.ndarray,            # [T] int cell ids through time
    grid_centers: np.ndarray,        # [H*W, 2] pixel centers
    label: str,
    sigma: float = 10.0,
    colormap: Optional[int] = None,
    alpha: float = 0.7,
) -> np.ndarray:
    """One beam's cell-id path rendered as a through-time heatmap:
    stamp (t+1)/2 at each step's cell center (later steps brighter),
    blur/rescale/colormap like :func:`grid_prob_heatmap`, and label the
    path at its first step's center (reference:
    SimAug/code/visualize.py:114-146 draw_grid_class_pred_through_t)."""
    cv2 = _cv2()
    from scipy.ndimage import gaussian_filter

    imgh, imgw = frame.shape[:2]
    centers = np.asarray(grid_centers).reshape(-1, 2)
    layer = np.zeros((imgh, imgw), np.float64)
    label_xy = (0, 0)
    for t, cell in enumerate(np.asarray(cell_ids).reshape(-1)):
        cx, cy = centers[int(cell)]
        cx = min(int(cx), imgw - 1)
        cy = min(int(cy), imgh - 1)
        if t == 0:
            label_xy = (cx, cy)
        layer[cy, cx] = (t + 1) / 2.0
    frame = cv2.putText(frame, label, label_xy,
                        cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                        color=(255, 0, 0))
    blurred = gaussian_filter(layer, sigma=sigma)
    span = blurred.max() - blurred.min()
    if span > 0:
        blurred = (blurred - blurred.min()) / span
    blurred = np.uint8(blurred * 255)
    _, mask = cv2.threshold(blurred, 1, 255, cv2.THRESH_BINARY)
    cmap = cv2.COLORMAP_JET if colormap is None else colormap
    heat = cv2.applyColorMap(blurred, cmap)
    heat = cv2.bitwise_and(heat, heat, mask=mask)
    return cv2.addWeighted(frame, 1.0, heat, alpha, 0)


def render_output_frame(
    frame: np.ndarray,
    obs_traj: np.ndarray,
    gt_pred: Optional[np.ndarray],
    pred_trajs: Sequence[Tuple[np.ndarray, Tuple[int, int, int]]],
    use_heatmap: bool = False,
) -> np.ndarray:
    """Single-future eval-output overlay: obs yellow, GT green, each
    run's prediction in its own color (reference:
    SimAug/code/visualize_output.py)."""
    frame = plot_traj(frame, obs_traj, OBS_COLOR, thickness=4)
    if gt_pred is not None:
        frame = plot_traj(frame, gt_pred, GT_COLOR, thickness=4)
    if use_heatmap:
        frame = heatmap_overlay(frame, [p for p, _ in pred_trajs])
    else:
        for pred, color in pred_trajs:
            frame = plot_traj(frame, pred, color, thickness=4)
    return frame
