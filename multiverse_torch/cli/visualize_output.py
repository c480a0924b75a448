"""mvt-torch-vis-output: single-future eval outputs over video frames.

The port's copy of ``multiverse_tpu/cli/visualize_output.py``: the same
arguments, files and printed line as ``mvt-vis-output``. It reads the
pickles of ``mvt-torch-test --save_output`` (or ``mvt-test``'s).
Drawing needs ``cv2`` (and ``scipy`` for ``--use_heatmap``); without
it the command stops as it starts, with an ``ImportError`` naming it.

reference: SimAug/code/visualize_output.py — takes a list of eval
output pickles (one per run, each with a BGR color), draws obs
(yellow) / GT (green) / per-run predictions on the frame of each
sequence, optionally as heatmaps.
"""

from __future__ import annotations

import argparse
import os
import pickle
import random

from multiverse_torch.cli.prepare_data import require_package


def parse_seq_id(key):
    """`videoname_frameidx_trackid` split from the right
    (reference: SimAug/code/visualize_output.py:33-38)."""
    if isinstance(key, bytes):
        key = key.decode()
    parts = str(key).rsplit("_", 2)
    return parts[0], parts[1], parts[2]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="mvt-torch-vis-output",
                                     description=__doc__)
    parser.add_argument("outlist",
                        help="lines of `pickle_path,B_G_R`")
    parser.add_argument("framepath",
                        help="videoname/videoname_F_%%08d.jpg frames")
    parser.add_argument("outpath")
    parser.add_argument("--vis_num", type=int, default=500)
    parser.add_argument("--use_heatmap", action="store_true")
    parser.add_argument("--ordered", action="store_true")
    parser.add_argument("--only_scene", default=None)
    args = parser.parse_args(argv)
    require_package("cv2", "mvt-torch-vis-output")
    if args.use_heatmap:
        require_package("scipy", "mvt-torch-vis-output")

    import cv2
    import numpy as np

    from multiverse_torch.vis.trajs import render_output_frame

    runs = []
    for line in open(args.outlist):
        path, color = line.strip().split(",")
        bgr = tuple(int(v) for v in color.split("_"))
        with open(path, "rb") as f:
            runs.append((os.path.basename(path), pickle.load(f), bgr))

    base = runs[0][1]
    seq_ids = list(range(len(base["seq_ids"])))
    if not args.ordered:
        random.Random(0).shuffle(seq_ids)
    os.makedirs(args.outpath, exist_ok=True)

    written = 0
    for j in seq_ids:
        if written >= args.vis_num:
            break
        seq_id = base["seq_ids"][j]
        videoname, frame_idx, track_id = parse_seq_id(seq_id)
        if args.only_scene and args.only_scene not in videoname:
            continue
        frame_file = os.path.join(
            args.framepath, videoname,
            "%s_F_%08d.jpg" % (videoname, int(frame_idx)))
        if not os.path.exists(frame_file):
            continue
        frame = cv2.imread(frame_file)
        preds = []
        for _, data, bgr in runs:
            ids = list(data["seq_ids"])
            # runs may order sequences differently; align by seq_id
            k = j if j < len(ids) and ids[j] == seq_id \
                else ids.index(seq_id)
            preds.append((np.asarray(data["grid0_pred_traj"][k]), bgr))
        frame = render_output_frame(
            frame,
            np.asarray(base["obs_list"][j]),
            np.asarray(base["pred_gt_list"][j]),
            preds,
            use_heatmap=args.use_heatmap,
        )
        cv2.imwrite(os.path.join(
            args.outpath, "%s.jpg" % str(seq_id)), frame)
        written += 1
    print("wrote %d visualizations" % written)


if __name__ == "__main__":
    main()
