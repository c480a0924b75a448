"""mvt-torch-vis-multifuture: render multifuture predictions over the
benchmark videos.

The port's copy of ``multiverse_tpu/cli/vis_multifuture_trajs_video.py``:
the same arguments and files as ``mvt-vis-multifuture``, from the
``.traj.p`` of ``mvt-torch-multifuture-inference`` (or
``mvt-multifuture-inference``'s). Drawing needs ``cv2`` (and ``scipy``
for ``--use_heatmap``); without it the command stops as it starts,
with an ``ImportError`` naming it.

reference: code/vis_multifuture_trajs_video.py — same flags including
the --job/--curJob manual sharding for parallel rendering.
"""

from __future__ import annotations

import argparse
import os
import pickle

from multiverse_torch.cli.prepare_data import require_package
from multiverse_torch.vis.trajs import render_multifuture_frame


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mvt-torch-vis-multifuture",
                                     description=__doc__)
    parser.add_argument("gt_path")
    parser.add_argument("prediction_file")
    parser.add_argument("multivideo_path")
    parser.add_argument("vis_path")
    parser.add_argument("--show_obs", action="store_true")
    parser.add_argument("--plot_points", action="store_true")
    parser.add_argument("--use_heatmap", action="store_true")
    parser.add_argument("--show_less_gt", action="store_true")
    parser.add_argument("--drop_frame", type=int, default=1)
    parser.add_argument("--job", type=int, default=1)
    parser.add_argument("--curJob", type=int, default=1)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    require_package("cv2", "mvt-torch-vis-multifuture")
    if args.use_heatmap:
        require_package("scipy", "mvt-torch-vis-multifuture")

    import cv2

    with open(args.prediction_file, "rb") as f:
        prediction = pickle.load(f)
    os.makedirs(args.vis_path, exist_ok=True)

    for count, traj_id in enumerate(prediction, 1):
        if (count % args.job) != (args.curJob - 1) % args.job:
            continue
        with open(os.path.join(args.gt_path, "%s.p" % traj_id), "rb") as f:
            gt = pickle.load(f)

        video_file = os.path.join(
            args.multivideo_path, "%s.mp4" % traj_id)
        target_path = os.path.join(args.vis_path, traj_id)
        os.makedirs(target_path, exist_ok=True)

        vcap = cv2.VideoCapture(video_file)
        if not vcap.isOpened():
            raise RuntimeError("cannot open %s" % video_file)
        frame_count = int(vcap.get(cv2.CAP_PROP_FRAME_COUNT))
        printed = 0
        for cur in range(frame_count):
            ok, frame = vcap.read()
            if not ok or cur % args.drop_frame != 0:
                continue
            frame = render_multifuture_frame(
                frame, gt, prediction[traj_id],
                show_obs=args.show_obs,
                use_heatmap=args.use_heatmap,
                plot_points=args.plot_points,
                show_less_gt=args.show_less_gt,
            )
            cv2.imwrite(
                os.path.join(target_path, "%08d.jpg" % printed), frame)
            printed += 1
        vcap.release()


if __name__ == "__main__":
    main()
