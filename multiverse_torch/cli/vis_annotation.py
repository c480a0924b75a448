"""The port's annotation drawing and trajectory-conversion commands.

The port's copy of ``multiverse_tpu/cli/vis_annotation.py``: each
``mvt-torch-*`` command takes the arguments of the ``mvt-*`` command of
the same name, prints what it prints and writes the same files.

    mvt-torch-vis-sdd-annotation   draw converted SDD/Argoverse boxes +
                                   trajectory points on a few frames per
                                   video (reference:
                                   SimAug/code/visualize_sdd_annotation.py)
    mvt-torch-extract-frames-seg   decode rgb frames + seg npys from the
                                   rendered benchmark videos, emitting
                                   bad_video.lst on count mismatches
                                   (reference: forking_paths_dataset/code/
                                   get_frames_and_scene_seg.py)
    mvt-torch-plot-traj-carla      convert one world trajectory file to
                                   CARLA map coordinates
                                   (``--save_carla_traj_file``), or draw
                                   it as debug arrows on a CARLA map,
                                   which needs the ``carla`` module and a
                                   server (reference: plot_traj_carla.py)
    mvt-torch-batch-plot-traj-carla
                                   convert whole directories of world
                                   trajectories to CARLA map coordinates
                                   using the per-scene ground
                                   calibrations, with --job/--curJob
                                   sharding (reference:
                                   batch_plot_traj_carla.py:1-132; no
                                   server needed)

Every command stops as it starts, with an ``ImportError`` naming the
package and the command, where ``cv2`` cannot be imported.
"""

from __future__ import annotations

import argparse
import os
import pickle
from glob import glob

from multiverse_torch.cli.prepare_data import require_package
from multiverse_torch.data.sdd import SDD_CLASS2CLASSID


def vis_sdd_annotation_main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="mvt-torch-vis-sdd-annotation")
    parser.add_argument("preparepath")
    parser.add_argument("framepath")
    parser.add_argument("targetpath")
    parser.add_argument("--vis_num_frame_per_video", default=3, type=int)
    args = parser.parse_args(argv)
    require_package("cv2", "mvt-torch-vis-sdd-annotation")

    import cv2

    classid2class = {v: k for k, v in SDD_CLASS2CLASSID.items()}
    traj_path = os.path.join(args.preparepath, "traj_2.5fps")
    person_path = os.path.join(args.preparepath, "anno_person_box")
    other_path = os.path.join(args.preparepath, "anno_other_box")

    written = 0
    for split in ("train", "val", "test"):
        for traj_file in glob(os.path.join(traj_path, split, "*.txt")):
            video_id = os.path.splitext(os.path.basename(traj_file))[0]
            with open(os.path.join(
                    person_path, split, "%s.p" % video_id), "rb") as f:
                person_boxes = pickle.load(f)
            with open(os.path.join(
                    other_path, split, "%s.p" % video_id), "rb") as f:
                other_boxes = pickle.load(f)
            target = os.path.join(args.targetpath, video_id)
            os.makedirs(target, exist_ok=True)

            seen = set()
            for line in open(traj_file):
                fi, tid, x, y = line.strip().split("\t")
                frame_idx, track_id = int(fi), float(tid)
                if frame_idx in seen:
                    continue
                seen.add(frame_idx)
                if len(seen) > args.vis_num_frame_per_video:
                    break
                key = "%s_%d_%d" % (video_id, frame_idx, track_id)
                frame_file = os.path.join(
                    args.framepath, video_id,
                    "%s_F_%08d.jpg" % (video_id, frame_idx))
                if key not in person_boxes \
                        or not os.path.exists(frame_file):
                    continue
                img = cv2.imread(frame_file)
                x1, y1, x2, y2 = (int(v) for v in person_boxes[key])
                img = cv2.rectangle(img, (x1, y1), (x2, y2),
                                    (0, 255, 0), 2)
                img = cv2.circle(img, (int(float(x)), int(float(y))),
                                 5, (0, 255, 255), -1)
                boxes, classids = other_boxes.get(key, ([], []))
                for bb, cid in zip(boxes, classids):
                    bx1, by1, bx2, by2 = (int(v) for v in bb)
                    img = cv2.rectangle(
                        img, (bx1, by1), (bx2, by2), (255, 0, 0), 1)
                    img = cv2.putText(
                        img, classid2class.get(cid, str(cid)),
                        (bx1, max(by1 - 3, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255))
                cv2.imwrite(os.path.join(
                    target, "%08d.jpg" % frame_idx), img)
                written += 1
    print("wrote %d annotated frames" % written)


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


def plot_traj_carla_main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="mvt-torch-plot-traj-carla")
    parser.add_argument("traj_world_file")
    parser.add_argument("origin_x", type=float)
    parser.add_argument("origin_y", type=float)
    parser.add_argument("origin_z", type=float)
    parser.add_argument("carla_rotation", type=float)
    parser.add_argument("--world_rotate", type=float, default=0.0)
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=2000, type=int)
    parser.add_argument("--line_time", type=float, default=30.0)
    parser.add_argument("--save_carla_traj_file", default=None)
    parser.add_argument("--is_actev", action="store_true",
                        help="normalize against the calibrated ActEV "
                             "world extents; without it (ETH/UCY) the "
                             "trajectory's own minimum is the origin "
                             "(reference: plot_traj_carla.py --is_actev)")
    args = parser.parse_args(argv)
    require_package("cv2", "mvt-torch-plot-traj-carla")

    import numpy as np

    from multiverse_torch.forking_paths.moments import (
        get_scene,
        world_to_carla,
    )

    rows = np.asarray(
        [line.strip().split("\t")
         for line in open(args.traj_world_file)], np.float64)
    videoname = os.path.splitext(
        os.path.basename(args.traj_world_file))[0]
    placed = world_to_carla(
        rows, get_scene(videoname) if args.is_actev else None,
        (args.origin_x, args.origin_y, args.origin_z),
        args.carla_rotation, scale=args.scale,
        world_rotate_deg=args.world_rotate)

    if args.save_carla_traj_file:
        _write_carla_traj(args.save_carla_traj_file, placed, args.origin_z)
        print("saved %s" % args.save_carla_traj_file)
        return

    import carla  # drawing needs a CARLA server

    client = carla.Client(args.host, args.port)
    client.set_timeout(10.0)
    world = client.get_world()
    for pid in np.unique(placed[:, 1]):
        traj = placed[placed[:, 1] == pid]
        for p1, p2 in zip(traj[:-1], traj[1:]):
            world.debug.draw_arrow(
                carla.Location(p1[2], p1[3], args.origin_z),
                carla.Location(p2[2], p2[3], args.origin_z),
                thickness=0.1, arrow_size=0.1,
                color=carla.Color(r=255),
                life_time=args.line_time)
    print("drew %d trajectories" % len(np.unique(placed[:, 1])))


def _write_carla_traj(path: str, placed, z: float) -> None:
    with open(path, "w") as f:
        for r in placed:
            f.write("%.1f\t%.1f\t%.3f\t%.3f\t%.3f\n" % (
                r[0], r[1], r[2], r[3], z))


def batch_plot_traj_carla_main(argv=None) -> None:
    """Batch world→CARLA trajectory conversion (reference:
    batch_plot_traj_carla.py:1-132).  ActEV mode (vehicle path given)
    uses the per-scene GROUND_CALIBRATIONS and skips scene 0002;
    otherwise the ETH/UCY calibration applies to every file.  Unlike
    the reference (one python subprocess per file), conversion runs
    in-process, and --job/--curJob shards the file list the way the
    reference's other batch tools do
    (reference: vis_multifuture_trajs_video.py:22-24)."""
    parser = argparse.ArgumentParser(prog="mvt-torch-batch-plot-traj-carla")
    parser.add_argument("traj_world_path", help="dir of *.txt "
                                                "(frame pid x y [z])")
    parser.add_argument("save_carla_traj_path")
    parser.add_argument("--traj_vehicle_world_path", default=None)
    parser.add_argument("--save_carla_vehicle_path", default=None)
    parser.add_argument("--job", type=int, default=1)
    parser.add_argument("--curJob", type=int, default=1)
    args = parser.parse_args(argv)
    require_package("cv2", "mvt-torch-batch-plot-traj-carla")

    import numpy as np

    from multiverse_torch.forking_paths.moments import (
        ETHUCY_GROUND_CALIBRATION,
        GROUND_CALIBRATIONS,
        get_scene,
        world_to_carla,
    )

    files = sorted(glob(os.path.join(args.traj_world_path, "*.txt")))
    files = files[args.curJob - 1::args.job]
    os.makedirs(args.save_carla_traj_path, exist_ok=True)
    is_actev = args.traj_vehicle_world_path is not None
    if is_actev:
        assert args.save_carla_vehicle_path is not None
        os.makedirs(args.save_carla_vehicle_path, exist_ok=True)

    done = skipped = 0
    for ped_file in files:
        name = os.path.splitext(os.path.basename(ped_file))[0]
        if is_actev:
            scene = get_scene(name)
            if scene == "0002":  # no CARLA recreation of this scene
                skipped += 1
                continue
            calib = GROUND_CALIBRATIONS[scene]
        else:
            scene, calib = None, ETHUCY_GROUND_CALIBRATION

        def convert(path):
            rows = np.asarray(
                [line.strip().split("\t") for line in open(path)],
                np.float64)
            return world_to_carla(
                rows, scene, calib["origin"], calib["carla_rotate"],
                scale=calib["scale"],
                world_rotate_deg=calib["world_rotate"])

        _write_carla_traj(
            os.path.join(args.save_carla_traj_path, "%s.txt" % name),
            convert(ped_file), calib["origin"][2])
        if is_actev:
            veh_file = os.path.join(
                args.traj_vehicle_world_path, "%s.txt" % name)
            if os.path.exists(veh_file):
                _write_carla_traj(
                    os.path.join(args.save_carla_vehicle_path,
                                 "%s.txt" % name),
                    convert(veh_file), calib["origin"][2])
        done += 1
    print("converted %d files (%d skipped) -> %s"
          % (done, skipped, args.save_carla_traj_path))
