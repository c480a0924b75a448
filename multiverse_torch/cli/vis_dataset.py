"""Ground-truth dataset visualizers.

    mvt-torch-vis-dataset     render the multi-future GT (all futures of
                              each obs) over the benchmark videos
                              (reference: forking_paths_dataset/code/
                              visualize_multifuture_dataset.py)
    mvt-torch-record-moments  render final moments in CARLA (reference:
                              record_annotation.py; needs carla + a
                              server, or the tests' fake)

The port's copy of ``multiverse_tpu/cli/vis_dataset.py``: the same
arguments, files and printed lines as ``mvt-vis-dataset`` and
``mvt-record-moments``. Both need ``cv2`` (drawing, video encoding);
without it a command stops as it starts, with an ``ImportError`` naming
it.
"""

from __future__ import annotations

import argparse
import json
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


def record_moments_main(argv=None) -> None:
    """Render final moments in CARLA: per camera an RGB and a
    palette-segmentation mp4 and a bbox JSON (reference:
    record_annotation.py)."""
    parser = argparse.ArgumentParser(prog="mvt-torch-record-moments")
    parser.add_argument("moment_json", help="final moments from "
                                            "mvt-torch-gen-moments")
    parser.add_argument("out_path")
    parser.add_argument("--scene_registry", default=None,
                        help="scene/camera JSON (default: the packaged "
                             "published Forking Paths calibration)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=2000, type=int)
    parser.add_argument("--camera_group", default="recording")
    parser.add_argument("--only", default=None,
                        help="only record scene==only (reference: "
                             "record_annotation.py:54)")
    parser.add_argument("--start_offset", type=int, default=0,
                        help="simulate but skip recording the first N "
                             "frames, rebasing recorded frame ids "
                             "(reference default 10 — the published "
                             "dataset's warm-up lead-in; mvt-gen-moments "
                             "output has no lead-in, so 0 here)")
    parser.add_argument("--cam_num_offset", type=int, default=0,
                        help="offset the 1-based camera index in "
                             "output names (reference: "
                             "record_annotation.py:66)")
    parser.add_argument("--use_alter_weather", action="store_true",
                        help="record under the published 'realism' "
                             "weather instead of each scene's own "
                             "(reference: record_annotation.py:68, "
                             "utils.py:70-77)")
    # anchor-moment recording (reference: record_annotation.py:59-65,
    # 176-196,234-239,284-286): fixed-length obs+pred recordings of the
    # auto-generated anchor moments, with a configurable view set
    parser.add_argument("--is_anchor_moment", action="store_true",
                        help="record auto-generated anchor moments "
                             "(fixed obs+pred length, anchor-view "
                             "camera set, no x-agent)")
    parser.add_argument("--no_ori_view", action="store_true",
                        help="anchor mode: drop the anchor view itself")
    parser.add_argument("--add_3view_to_anchor", action="store_true",
                        help="anchor mode: add recording views 2-4")
    parser.add_argument("--add_dashboard_view_to_anchor",
                        action="store_true",
                        help="anchor mode: add the 5th (dashboard) "
                             "recording view where the registry has one")
    parser.add_argument("--video_fps", type=float, default=30.0)
    parser.add_argument("--annotation_fps", type=float, default=2.5)
    parser.add_argument("--obs_length", type=int, default=12)
    parser.add_argument("--pred_length", type=int, default=26)
    args = parser.parse_args(argv)
    require_package("cv2", parser.prog)

    import carla  # requires a CARLA 0.9.6 server

    from multiverse_torch.forking_paths.recorder import record_moment
    from multiverse_torch.forking_paths.scenes import (
        REALISM_WEATHER,
        default_registry_path,
        load_scene_registry,
    )

    registry = load_scene_registry(
        args.scene_registry or default_registry_path())
    with open(args.moment_json) as f:
        moments = json.load(f)

    client = carla.Client(args.host, args.port)
    client.set_timeout(10.0)
    for moment in moments:
        scenename = moment["scenename"]
        if args.only is not None and scenename != args.only:
            continue
        scene = registry.scenes[scenename]
        client.load_world(scene.map)
        if args.is_anchor_moment:
            # anchor view (+optional extra views) and a fixed-length
            # recording window; anchor moments carry no x-agent
            # (reference: record_annotation.py:176-196,234-239)
            recording = registry.cameras.get(
                "recording", {}).get(scenename, [])
            rigs = [] if args.no_ori_view else list(
                registry.cameras["anchor"][scenename])
            if args.add_3view_to_anchor:
                rigs += recording[1:4]
            if args.add_dashboard_view_to_anchor and len(recording) >= 5:
                rigs.append(recording[4])
            frame_skip = int(args.video_fps / args.annotation_fps)
            total = (args.obs_length + args.pred_length - 1) * frame_skip
            moment_id = "%s_F_%s_obs%d_pred%d" % (
                moment["filename"], moment["original_start_frame_id"],
                args.obs_length, args.pred_length)
            x_agent_pid = None
        else:
            rigs = registry.cameras[args.camera_group][scenename]
            total = max(int(float(k))
                        for k in moment["ped_controls"]) + 1
            # the recorded moment is one (pid, destination, annotator)
            # instance: its x-agent pid is encoded in the moment_id
            # ("scene_momentidx_pid_destidx_annotator", reference:
            # record_annotation.py:241-242), NOT the x_agents dict,
            # which lists every annotated pid of the source moment
            moment_id = moment["moment_id"]
            parts = moment_id.split("_")
            if len(parts) >= 5:
                x_agent_pid = float(parts[2])
            else:
                x_agents = list(moment.get("x_agents", {}))
                x_agent_pid = float(x_agents[0]) if x_agents else None
        outputs = record_moment(
            client, scene, rigs,
            moment["ped_controls"], moment["vehicle_controls"],
            total, args.out_path, moment_id,
            x_agent_pid=x_agent_pid,
            start_offset=args.start_offset,
            cam_num_offset=args.cam_num_offset,
            weather_override=(
                REALISM_WEATHER if args.use_alter_weather else None))
        print("recorded %s -> %s" % (moment_id, sorted(outputs)))


if __name__ == "__main__":
    vis_dataset_main()
