"""mvt-torch-vis-dataset: render the multi-future GT (all futures of
each obs) over the benchmark videos.

The port's copy of ``vis_dataset_main`` of
``multiverse_tpu/cli/vis_dataset.py`` (reference:
forking_paths_dataset/code/visualize_multifuture_dataset.py): the same
arguments, files and printed line as ``mvt-vis-dataset``. Drawing needs
``cv2``; without it the command stops as it starts, with an
``ImportError`` naming it.
"""

from __future__ import annotations

import argparse
import os
import pickle
from glob import glob

from multiverse_torch.cli.prepare_data import require_package


def vis_dataset_main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="mvt-torch-vis-dataset")
    parser.add_argument("video_path")
    parser.add_argument("gt_path", help="multifuture GT pickles")
    parser.add_argument("out_video_path")
    parser.add_argument("--drop_frame", type=int, default=1)
    args = parser.parse_args(argv)
    require_package("cv2", "mvt-torch-vis-dataset")

    import cv2

    from multiverse_torch.vis.trajs import GT_COLOR, OBS_COLOR, plot_traj

    os.makedirs(args.out_video_path, exist_ok=True)

    gt_files = sorted(glob(os.path.join(args.gt_path, "*.p")))
    for gt_file in gt_files:
        obs_key = os.path.splitext(os.path.basename(gt_file))[0]
        with open(gt_file, "rb") as f:
            gt = pickle.load(f)
        video_file = os.path.join(
            args.video_path, "%s.mp4" % obs_key)
        if not os.path.exists(video_file):
            continue
        vcap = cv2.VideoCapture(video_file)
        target = os.path.join(args.out_video_path, obs_key)
        os.makedirs(target, exist_ok=True)
        printed = cur = 0
        while True:
            ok, frame = vcap.read()
            if not ok:
                break
            if cur % args.drop_frame == 0:
                for future_id in gt:
                    pts = [p[2:] for p in gt[future_id]["x_agent_traj"]]
                    frame = plot_traj(frame, pts, GT_COLOR)
                    if "obs_traj" in gt[future_id]:
                        frame = plot_traj(
                            frame,
                            [p[2:] for p in gt[future_id]["obs_traj"]],
                            OBS_COLOR)
                cv2.imwrite(os.path.join(
                    target, "%08d.jpg" % printed), frame)
                printed += 1
            cur += 1
        vcap.release()
    print("visualized %d obs groups" % len(gt_files))


if __name__ == "__main__":
    vis_dataset_main()
