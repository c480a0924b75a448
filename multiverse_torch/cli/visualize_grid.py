"""mvt-torch-vis-grid: grid-classification visualization over video
frames.

The port's copy of ``multiverse_tpu/cli/visualize_grid.py``: the same
arguments, files and printed lines as ``mvt-vis-grid``, from the pickle
of ``mvt-torch-test --save_output`` (or ``mvt-test``'s). Drawing needs
``cv2`` and ``scipy``; without one the command stops as it starts, with
an ``ImportError`` naming it.

reference: SimAug/code/visualize.py — group an eval output pickle's
sequences per (video, frame), then render ONE composite jpg per frame:
grid lines, full-GT/observed/predicted trajectories, GT-class circles,
and the class head's predictions as gaussian heatmaps — either the
first + last three timesteps (greedy mode) or three labelled beams'
cell paths through time (--use_beam_search).  One randomly-chosen
person per frame (heatmaps of several people overlap unreadably,
reference :252), with the reference's --only_video /
--only_after_frameid / --only_trackid / --no_first_step filters.

Intentional divergence: the reference adds small hardcoded "bubble"
probabilities to five fixed cells of every heatmap
(SimAug/code/visualize.py:82-89 "for fig 1") — a paper-figure hack
that distorts all renders; not reproduced.
"""

from __future__ import annotations

import argparse
import os
import pickle
import random

from multiverse_torch.cli.prepare_data import require_package


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mvt-torch-vis-grid",
                                     description=__doc__)
    parser.add_argument("outp", help="eval output pickle (mvt-torch-test "
                                     "--save_output)")
    parser.add_argument("vis_path")
    parser.add_argument("video_frame_path",
                        help="videoname/videoname_F_%%08d.jpg frames")
    parser.add_argument("--vis_start", type=int, default=0)
    parser.add_argument("--vis_end", type=int, default=-1)
    parser.add_argument("--use_beam_search", action="store_true",
                        help="render beam cell paths (pickle from "
                             "mvt-torch-test --use_beam_search) instead of "
                             "per-timestep class heatmaps")
    parser.add_argument("--show_scene_scale", type=int, default=0)
    parser.add_argument("--beam_size", type=int, default=5)
    parser.add_argument("--only_video", default=None)
    parser.add_argument("--only_after_frameid", default=None, type=int)
    parser.add_argument("--only_trackid", default=None, type=int)
    parser.add_argument("--no_first_step", action="store_true")
    parser.add_argument("--no_pred_traj", action="store_true")
    parser.add_argument("--no_gt_pred", action="store_true")
    # geometry the reference hardcodes in its main (:152-165)
    parser.add_argument("--obs_len", type=int, default=8)
    parser.add_argument("--frame_gap", type=int, default=12)
    parser.add_argument("--video_h", type=int, default=1080)
    parser.add_argument("--video_w", type=int, default=1920)
    parser.add_argument("--scene_h", type=int, default=36)
    parser.add_argument("--scene_w", type=int, default=64)
    parser.add_argument("--scene_grid_strides", default="2,4")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    require_package("cv2", "mvt-torch-vis-grid")
    require_package("scipy", "mvt-torch-vis-grid")

    import cv2
    import numpy as np
    from scipy.special import softmax

    from multiverse_torch.train.evaluate import get_scene
    from multiverse_torch.vis.trajs import (
        GT_COLOR,
        OBS_COLOR,
        draw_grid,
        grid_class_path_heatmap,
        grid_prob_heatmap,
        plot_traj,
    )

    with open(args.outp, "rb") as f:
        data = pickle.load(f)

    strides = [int(s) for s in args.scene_grid_strides.split(",")]
    scene_grids = [(int(round(args.scene_h / s)),
                    int(round(args.scene_w / s))) for s in strides]
    scale = args.show_scene_scale
    centers = np.asarray(
        data["grid_center_%d" % scale]).reshape(-1, 2)

    # pass 1: per-frame grouping (reference :170-221) — one entry per
    # (video, frame, person), skipping the reference's excluded scenes
    num_data = len(data["seq_ids"])
    end = num_data if args.vis_end < 0 else min(args.vis_end, num_data)
    new_data: dict = {}
    for i in range(args.vis_start, end):
        seq_id = str(data["seq_ids"][i])
        videoname, frame_id, person_id = seq_id.rsplit("_", 2)
        scene = get_scene(videoname)
        if scene in ("0002", "0400"):
            continue
        frame_id, person_id = int(frame_id), int(person_id)
        if args.only_video is not None and videoname != args.only_video:
            continue
        if (args.only_after_frameid is not None
                and frame_id < args.only_after_frameid):
            continue
        this_data = {
            "obs_traj": data["obs_list"][i],
            "pred_gt_traj": data["pred_gt_list"][i],
            "pred_traj": data["grid%d_pred_traj" % scale][i],
            "class": data["grid%d_class" % scale][i],
            "gt_class": data["grid%d_gt_class" % scale][i],
        }
        if args.use_beam_search:
            this_data["beam_grid_ids"] = data["beam_grid_ids"][i]
            this_data["beam_logprobs"] = data["beam_logprobs"][i]
        new_data.setdefault(videoname, {}).setdefault(
            frame_id, {})[person_id] = this_data

    print("total %s videos." % len(new_data))

    # pass 2: one composite jpg per frame (reference :224-329)
    written = 0
    for videoname in new_data:
        target_path = os.path.join(args.vis_path, videoname)
        os.makedirs(target_path, exist_ok=True)
        random.seed(1)
        for frame_id in sorted(new_data[videoname]):
            last_obs_frame_id = (
                frame_id + (args.obs_len - 1) * args.frame_gap)
            frame_file = os.path.join(
                args.video_frame_path, videoname,
                "%s_F_%08d.jpg" % (videoname, last_obs_frame_id))
            frame_img = cv2.imread(frame_file, cv2.IMREAD_COLOR)
            if frame_img is None:
                continue
            if frame_img.shape[1] != args.video_w:  # 0002 is 1280x720
                frame_img = cv2.resize(
                    frame_img, (args.video_w, args.video_h))

            frame_img = draw_grid(frame_img, scene_grids[scale])

            # one person per frame, randomly chosen (reference :251-255)
            person_ids = list(new_data[videoname][frame_id])
            random.shuffle(person_ids)
            if args.only_trackid is not None:
                if args.only_trackid not in new_data[videoname][frame_id]:
                    continue
                person_ids = [args.only_trackid]
            for person_id in person_ids[:1]:
                d = new_data[videoname][frame_id][person_id]
                obs = np.asarray(d["obs_traj"], np.float32)
                gt_pred = np.asarray(d["pred_gt_traj"], np.float32)

                full_gt = np.concatenate([obs, gt_pred], axis=0)
                frame_img = plot_traj(frame_img, full_gt, GT_COLOR, 4)
                frame_img = plot_traj(frame_img, obs, OBS_COLOR, 4)

                if not args.no_pred_traj:
                    pred = np.concatenate(
                        [obs[-1:].reshape(1, 2),
                         np.asarray(d["pred_traj"], np.float32)], axis=0)
                    frame_img = plot_traj(
                        frame_img, pred, (255, 255, 0), 4)

                if not args.no_gt_pred:
                    for cell in np.asarray(d["gt_class"]).reshape(-1):
                        x, y = centers[int(cell)]
                        frame_img = cv2.circle(
                            frame_img, (int(x), int(y)), radius=30,
                            color=(255, 0, 0))

                if args.use_beam_search:
                    # best / middle / worst beam, each in its own
                    # colormap with a "#k" label (reference :289-305)
                    beam2cmap = {
                        0: cv2.COLORMAP_AUTUMN,
                        int(args.beam_size / 2.0): cv2.COLORMAP_SPRING,
                        args.beam_size - 1: cv2.COLORMAP_WINTER,
                    }
                    ids = np.asarray(d["beam_grid_ids"])
                    for beam, cmap in beam2cmap.items():
                        frame_img = grid_class_path_heatmap(
                            frame_img, ids[beam], centers,
                            "#%d" % beam, colormap=cmap)
                else:
                    logits = np.asarray(d["class"])   # [T, H*W]
                    shown = []
                    if not args.no_first_step:
                        shown.append((0, cv2.COLORMAP_WINTER))
                    shown += [(t, cv2.COLORMAP_AUTUMN)
                              for t in range(max(logits.shape[0] - 3, 0),
                                             logits.shape[0])]
                    for t, cmap in shown:
                        frame_img = grid_prob_heatmap(
                            frame_img, softmax(logits[t]), centers,
                            colormap=cmap)

            target_file = os.path.join(
                target_path, "%s_F_%08d.jpg" % (videoname, frame_id))
            cv2.imwrite(target_file, frame_img)
            written += 1
    print("wrote %d frames" % written)


if __name__ == "__main__":
    main()
