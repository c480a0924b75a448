"""mvt-torch-vis-real-data: side-by-side pixel + world ground-plane
trajectory visualization for real data.

The port's copy of ``multiverse_tpu/cli/vis_real_data.py``: the same
arguments, file and printed line as ``mvt-vis-real-data``. Drawing
needs ``cv2``; without it the command stops as it starts, with an
``ImportError`` naming it.

reference: forking_paths_dataset/code/visualize_real_data.py — for one
start frame, draw every person's obs (yellow) + full (green) arrows on
the video frame, and the same trajectories on a normalized world-plane
canvas (recomputed through the homography when --h_file is given);
optional vehicle overlays; the two views are concatenated side by side.
"""

from __future__ import annotations

import argparse
import math
import os

from multiverse_torch.cli.prepare_data import require_package


def select_trajs(traj_data, frame_ids, arrow_len=None):
    """Per-person polylines restricted to frame_ids."""
    import numpy as np

    out = []
    for pid in np.unique(traj_data[:, 1]):
        rows = traj_data[traj_data[:, 1] == pid]
        rows = rows[np.isin(rows[:, 0], frame_ids)]
        if len(rows) >= 2:
            out.append((pid, rows[:, 2:4]))
    return out


def plot_arrow_trajs(img, trajs, color, show_person_id=False):
    """Arrowed polylines (reference: visualize_real_data.py:47-62)."""
    import cv2

    for pid, traj in trajs:
        pts = [(int(x), int(y)) for x, y in traj]
        for p1, p2 in zip(pts[:-1], pts[1:]):
            img = cv2.arrowedLine(img, p1, p2, color=color, thickness=2,
                                  line_type=cv2.LINE_AA, tipLength=0.3)
        if show_person_id:
            img = cv2.putText(img, "#%d" % int(pid), pts[0],
                              cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                              (255, 255, 255), lineType=cv2.LINE_AA)
    return img


def world_canvas(trajs, h, w, margin=40, extent=None):
    """Normalize world trajectories onto an [h, w] canvas.

    `extent` = (min, span) reuses another call's normalization, so a
    subset overlay (the obs segments) lands on the same canvas points
    as the full trajectories (the reference normalizes the whole world
    file once, reference: visualize_real_data.py:151-161)."""
    import numpy as np

    if extent is None:
        all_pts = np.concatenate([t for _, t in trajs]) if trajs else \
            np.zeros((1, 2))
        mn, mx = all_pts.min(0), all_pts.max(0)
        span = np.maximum(mx - mn, 1e-6)
    else:
        mn, span = extent
    scaled = []
    for pid, t in trajs:
        xy = (t - mn) / span * [w - 2 * margin, h - 2 * margin] + margin
        scaled.append((pid, xy))
    return scaled, (mn, span)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="mvt-torch-vis-real-data",
                                     description=__doc__)
    parser.add_argument("video_frame_path")
    parser.add_argument("start_frame_idx", type=int)
    parser.add_argument("traj_pixel_file")
    parser.add_argument("traj_world_file")
    parser.add_argument("vis_file")
    parser.add_argument("--h_file", default=None)
    parser.add_argument("--world_rotate", default=0.0, type=float)
    parser.add_argument("--obs_length", type=int, default=8)
    parser.add_argument("--pred_length", type=int, default=12)
    args = parser.parse_args(argv)
    require_package("cv2", "mvt-torch-vis-real-data")

    import cv2
    import numpy as np

    from multiverse_torch.forking_paths.moments import (
        get_scene,
        pixel_to_world_ground,
        rotate_xy,
    )

    def load(path):
        rows = [line.strip().split("\t") for line in open(path)]
        return np.asarray(rows, np.float32)

    pixel = load(args.traj_pixel_file)
    videoname = os.path.splitext(
        os.path.basename(args.traj_pixel_file))[0]
    frame_ids = sorted(np.unique(pixel[:, 0]))
    start_pos = frame_ids.index(float(args.start_frame_idx))
    seq = frame_ids[start_pos:start_pos + args.obs_length
                    + args.pred_length]
    obs = seq[:args.obs_length]

    frame_file = os.path.join(
        args.video_frame_path, videoname,
        "%s_F_%08d.jpg" % (videoname, args.start_frame_idx))
    frame = cv2.imread(frame_file, cv2.IMREAD_COLOR)
    h, w = frame.shape[:2]

    vis_pixel = plot_arrow_trajs(
        frame, select_trajs(pixel, seq), (0, 255, 0),
        show_person_id=True)
    vis_pixel = plot_arrow_trajs(
        vis_pixel, select_trajs(pixel, obs), (0, 255, 255))
    vis_pixel = cv2.putText(
        vis_pixel, "#%d" % args.start_frame_idx, (0, h - 10),
        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 255),
        lineType=cv2.LINE_AA)

    if args.h_file:
        hom = np.asarray(
            [line.strip().split(",") for line in open(args.h_file)],
            np.float64)
        world = pixel.copy()
        world[:, 2:4] = pixel_to_world_ground(
            pixel[:, 2:4], hom, get_scene(videoname))
    else:
        world = load(args.traj_world_file)
    if args.world_rotate:
        world = rotate_xy(world, (0, 0),
                          math.radians(args.world_rotate))

    canvas = np.full((h, w, 3), 255, np.uint8)
    full_w, extent = world_canvas(select_trajs(world, seq), h, w)
    obs_w, _ = world_canvas(select_trajs(world, obs), h, w,
                            extent=extent)
    vis_world = plot_arrow_trajs(canvas, full_w, (0, 255, 0),
                                 show_person_id=True)
    vis_world = plot_arrow_trajs(vis_world, obs_w, (0, 255, 255))

    vis = np.concatenate([vis_pixel, vis_world], axis=1)
    os.makedirs(os.path.dirname(os.path.abspath(args.vis_file)),
                exist_ok=True)
    cv2.imwrite(args.vis_file, vis)
    print("wrote %s" % args.vis_file)


if __name__ == "__main__":
    main()
