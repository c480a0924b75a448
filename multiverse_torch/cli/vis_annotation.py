"""mvt-torch-extract-frames-seg: the Forking Paths frames and scene-seg
step of the port.

The port's copy of ``extract_frames_seg_main`` of
``multiverse_tpu/cli/vis_annotation.py`` (reference:
forking_paths_dataset/code/get_frames_and_scene_seg.py): decode the
rgb frames and the seg npys of the rendered benchmark videos at the
frames the obs TSVs name, and write ``bad_video.lst`` where their
counts disagree. Video decoding needs ``cv2``; without it the command
stops as it starts, with an ``ImportError`` naming it. The drawing
commands of that module stay in the JAX package.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

from multiverse_torch.cli.prepare_data import require_package


def extract_frames_seg_main(argv=None) -> None:
    from multiverse_torch.forking_paths.prepared_data import (
        extract_frames_and_seg,
    )

    parser = argparse.ArgumentParser(prog="mvt-torch-extract-frames-seg")
    parser.add_argument("traj_path", help="split dirs of obs TSVs")
    parser.add_argument("video_path", help="rendered <name>.mp4 + "
                                           "<name>_seg or videos_seg")
    parser.add_argument("out_frame_path")
    parser.add_argument("out_seg_path")
    parser.add_argument("bad_video_lst")
    parser.add_argument("--scene_h", type=int, default=36)
    parser.add_argument("--scene_w", type=int, default=64)
    parser.add_argument("--is_multifuture", action="store_true")
    args = parser.parse_args(argv)
    require_package("cv2", "mvt-torch-extract-frames-seg")

    from multiverse_torch.forking_paths.prepared_data import scene_timing

    bad = []
    for traj_file in glob(os.path.join(args.traj_path, "*", "*.txt")):
        split = os.path.basename(os.path.dirname(traj_file))
        videoname = os.path.splitext(os.path.basename(traj_file))[0]
        start = 0
        if args.is_multifuture:
            scene = videoname.split("_")[0]
            _, (start, _) = scene_timing(scene)
        frame_idxs = sorted({
            int(line.split("\t")[0]) + start
            for line in open(traj_file) if line.strip()})
        if args.is_multifuture:
            # obs names have 4 fields (scene_moment_pid_camera) while
            # rendered videos have 6 (…_destidx_annotator_camera) —
            # join by glob like the reference
            # (get_frames_and_scene_seg.py:134-137, 170-173)
            s, m, pid, cam = videoname.split("_")
            pattern = "%s_%s_%s_*_%s.mp4" % (s, m, pid, cam)
            rgb_hits = sorted(glob(
                os.path.join(args.video_path, pattern)))
            rgb = rgb_hits[0] if rgb_hits else \
                os.path.join(args.video_path, "%s.mp4" % videoname)
            seg_hits = sorted(glob(os.path.join(
                args.video_path,
                "%s_%s_%s_*_%s_seg.mp4" % (s, m, pid, cam))))
            if not seg_hits:
                seg_hits = sorted(glob(os.path.join(
                    os.path.dirname(args.video_path), "videos_seg",
                    pattern)))
            seg = seg_hits[0] if seg_hits else \
                os.path.join(args.video_path, "%s_seg.mp4" % videoname)
        else:
            rgb = os.path.join(args.video_path, "%s.mp4" % videoname)
            seg = os.path.join(
                args.video_path, "%s_seg.mp4" % videoname)
            if not os.path.exists(seg):
                seg = os.path.join(
                    os.path.dirname(args.video_path), "videos_seg",
                    "%s.mp4" % videoname)
        ok = extract_frames_and_seg(
            rgb, seg, frame_idxs,
            os.path.join(args.out_frame_path, videoname),
            os.path.join(args.out_seg_path, videoname),
            videoname, start=start,
            scene_h=args.scene_h, scene_w=args.scene_w)
        if not ok:
            bad.append("%s/%s" % (split, videoname))
    with open(args.bad_video_lst, "w") as f:
        f.write("\n".join(bad) + ("\n" if bad else ""))
    print("%d bad videos -> %s" % (len(bad), args.bad_video_lst))
