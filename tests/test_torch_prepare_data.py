"""The port's data-preparation commands against the JAX package's on
the CPU: the same generated inputs (the bbox JSONs of the Forking Paths
recorder, SDD annotations with a rotated video, Argoverse labels and
calibration, VIRAT YAMLs, palette seg MP4s written with cv2) go through
each ``mvt-*`` command's ``main`` and its ``mvt-torch-*`` twin, into two
directories. Tolerance 0: every text, JSON, ``.lst`` and image file
byte-equal, every pickle equal after loading with equal types at every
level, every ``.npy`` equal with its dtype, and stdout equal. Also: the
module functions that hold the arithmetic equal their JAX twins, and a
command that needs a missing optional package stops with an ImportError
naming it and the command, having written nothing."""

import json
import os
import pickle
import sys
import types

import numpy as np
import pytest

from multiverse_tpu.cli import prepare_data as jax_cli
from multiverse_tpu.cli import vis_annotation as jax_vis
from multiverse_tpu.data import argoverse as jax_argoverse
from multiverse_tpu.data import sdd as jax_sdd
from multiverse_tpu.forking_paths import controls as jax_controls
from multiverse_tpu.forking_paths import moments as jax_moments
from multiverse_tpu.forking_paths import prepared_data as jax_prepared
from multiverse_torch.cli import prepare_data as cli
from multiverse_torch.cli import vis_annotation as vis
from multiverse_torch.data import argoverse, sdd
from multiverse_torch.forking_paths import controls, moments, prepared_data

JAX = types.SimpleNamespace(
    controls=jax_controls, moments=jax_moments, prepared=jax_prepared,
    sdd=jax_sdd, argoverse=jax_argoverse)
PORT = types.SimpleNamespace(
    controls=controls, moments=moments, prepared=prepared_data, sdd=sdd,
    argoverse=argoverse)


def _same(a, b, where: str = "") -> None:
    """Equal type at every level, equal dict key order, and equal
    values (NaN equal to NaN; arrays by dtype, shape and element)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], "%s[%r]" % (where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, "%s[%d]" % (where, i))
    elif isinstance(a, float) and a != a:
        assert b != b, where
    else:
        assert a == b, (where, a, b)


def _files(root: str) -> list:
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def _assert_same_tree(got: str, want: str) -> int:
    """Every file of ``want`` in ``got`` and no other, each equal as
    the module docstring says. Returns the number of files."""
    names = _files(want)
    assert _files(got) == names
    for name in names:
        a, b = os.path.join(got, name), os.path.join(want, name)
        if name.endswith(".p"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                _same(pickle.load(fa), pickle.load(fb), name)
        elif name.endswith(".npy"):
            _same(np.load(a), np.load(b), name)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
    return len(names)


# ------------------------------------------------------------- inputs


def write_bbox_json(path, n_frames, tracks, x_agent=0):
    """The recorder's bbox JSON (``tests/test_prepared_data.py``'s
    format). tracks: {track_id: (x0, y0, vx, vy)}, linear motion; ids
    below 10 are persons, the rest vehicles; a box that leaves the
    image to the left is dropped by the readers."""
    boxes = []
    for f in range(n_frames):
        for tid, (x0, y0, vx, vy) in tracks.items():
            boxes.append({
                "frame_id": f,
                "track_id": tid,
                "class_name": "Person" if tid < 10 else "Vehicle",
                "is_x_agent": 1 if tid == x_agent else 0,
                "bbox": [x0 + vx * f, y0 + vy * f, 20.5, 40.25],
            })
    with open(path, "w") as fh:
        json.dump(boxes, fh)


# multi-future videos: (name, frames, x_agent); ethucy (zara: start 32,
# drop 10) and virat (0000: start 40, drop 12) timing; 0400 is too short
# for 8 obs steps and 0401's x-agent is a vehicle: both skipped
MULTIFUTURE = [
    ("zara01_5_0_0_a_cam1", 150, 0), ("zara01_5_0_1_b_cam1", 150, 0),
    ("0000_3_1_0_a_cam2", 280, 1), ("0000_3_1_1_b_cam2", 280, 1),
    ("0000_3_1_2_c_cam2", 262, 1),
    ("0400_7_2_0_a_cam1", 100, 2), ("0401_1_3_0_a_cam1", 280, 12),
]
# anchor videos: <virat source>_F_<...>; the last is too short (a
# warning), and one has a source in no split list
ANCHOR = [
    ("VIRAT_S_040000_00_F_0_1", 300), ("VIRAT_S_040100_01_F_2_0", 260),
    ("VIRAT_S_000000_02_F_1_1", 300), ("VIRAT_S_999999_99_F_0_0", 250),
    ("VIRAT_S_000000_02_F_3_1", 100),
]


def _tracks(k: int) -> dict:
    return {0: (100.0 + 3 * k, 100.0, 2.0 + 0.37 * k, 1.25),
            1: (300.0, 200.0 + k, 1.5, 0.5 - 0.1 * k),
            2: (40.0, 500.0, -0.75, 0.0),    # leaves the image
            12: (500.0, 300.0, 0.0, 0.0)}


def make_forking_paths(root: str) -> dict:
    """Bbox JSONs of MULTIFUTURE and ANCHOR, empty rendered mp4s named
    as the recorder names them, and the original VIRAT split lists."""
    bbox = os.path.join(root, "ds", "bbox")
    os.makedirs(bbox)
    for videos in ("videos_mf", "videos_anchor", "ori"):
        os.makedirs(os.path.join(root, videos))
    for k, (name, n, x_agent) in enumerate(MULTIFUTURE):
        write_bbox_json(os.path.join(bbox, name + ".json"), n,
                        _tracks(k), x_agent=x_agent)
        open(os.path.join(root, "videos_mf", name + ".mp4"), "w").close()
    for k, (name, n) in enumerate(ANCHOR):
        write_bbox_json(os.path.join(bbox, name + ".json"), n, _tracks(k))
        open(os.path.join(root, "videos_anchor", name + ".mp4"),
             "w").close()
    for split, line in (("train", "path/VIRAT_S_040000_00.mp4"),
                        ("val", "VIRAT_S_040100_01"),
                        ("test", "VIRAT_S_000000_02")):
        with open(os.path.join(root, "ori", split + ".lst"), "w") as f:
            f.write(line + "\n")
    jax_cli.split_path_main([os.path.join(root, "videos_mf"),
                             os.path.join(root, "split_mf")])
    jax_cli.split_path_main([
        os.path.join(root, "videos_anchor"),
        os.path.join(root, "split_anchor"), "--is_anchor",
        "--ori_split_path", os.path.join(root, "ori")])
    return {"ds": os.path.join(root, "ds"),
            "split_mf": os.path.join(root, "split_mf"),
            "split_anchor": os.path.join(root, "split_anchor"),
            "videos_mf": os.path.join(root, "videos_mf"),
            "videos_anchor": os.path.join(root, "videos_anchor"),
            "ori": os.path.join(root, "ori")}


SDD_CLASSES = ["Pedestrian", "Biker", "Car", "Bus", "Skater", "Cart"]


def make_sdd(root: str) -> dict:
    """annotations.txt of three SDD videos: a landscape one, a portrait
    one rotated by the change list, and one too short; every class,
    lost and occluded boxes, boxes whose center leaves the 1920x1080
    frame, and short lines the reader skips."""
    rng = np.random.RandomState(3)
    videos = [("deathCircle", "video0", 400, (1424, 1088)),
              ("bookstore", "video1", 380, (1088, 1424)),
              ("hyang", "video2", 120, (1920, 1080))]
    for scene, video, frames, (w, h) in videos:
        d = os.path.join(root, "annotations", scene, video)
        os.makedirs(d)
        lines = []
        for tid in range(6):
            x, y = rng.uniform(0, 0.9 * w), rng.uniform(0, 0.9 * h)
            vx, vy = rng.uniform(-1.5, 1.5, 2)
            for f in range(0, frames):
                x1, y1 = int(x + vx * f), int(y + vy * f)
                lost = int(rng.rand() < 0.05)
                lines.append('%d %d %d %d %d %d %d %d 0 "%s"' % (
                    tid, x1, y1, x1 + 30 + tid, y1 + 60, f, lost,
                    int(rng.rand() < 0.1), SDD_CLASSES[tid]))
        lines.insert(5, "7 1 2 3")
        rng.shuffle(lines)
        with open(os.path.join(d, "annotations.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "changes.lst"), "w") as f:
        f.write("deathCircle_video0,1424x1088,False\n"
                "bookstore_video1,1088x1424,True\n"
                "hyang_video2,1920x1080,False\n")
    split = os.path.join(root, "sdd_split")
    os.makedirs(split)
    for name, ids in (("train", ["deathCircle_video0", "hyang_video2"]),
                      ("test", ["bookstore_video1"])):
        with open(os.path.join(split, name + ".lst"), "w") as f:
            f.write("".join("/x/%s.mp4\n" % i for i in ids))
    with open(os.path.join(root, "sdd_videos.lst"), "w") as f:
        f.write("".join("/data/sdd/v%d.mp4\n" % i for i in range(11)))
    return {"anno": os.path.join(root, "annotations"), "split": split,
            "changes": os.path.join(root, "changes.lst"),
            "videos": os.path.join(root, "sdd_videos.lst")}


ARGO_CAL = {"camera_data_": [
    {"key": "image_raw_ring_rear_left", "value": {}},
    {"key": "image_raw_ring_front_center", "value": {
        "vehicle_SE3_camera_": {
            "translation": [1.6, 0.02, 1.4],
            "rotation": {"coefficients": [0.5, -0.5, 0.5, -0.5]}},
        "focal_length_x_px_": 1392.1, "skew_": 0.35,
        "focal_center_x_px_": 980.2,
        "focal_length_y_px_": 1392.6,
        "focal_center_y_px_": 604.5}}]}


def argo_label(rng, cls, uuid, x, y, occlusion=0):
    yaw = rng.uniform(-np.pi, np.pi)
    return {"label_class": cls, "track_label_uuid": uuid,
            "occlusion": occlusion,
            "center": {"x": x, "y": y, "z": rng.uniform(-0.2, 0.4)},
            "rotation": {"w": float(np.cos(yaw / 2)), "x": 0.0, "y": 0.0,
                         "z": float(np.sin(yaw / 2))},
            "length": rng.uniform(0.4, 4.5), "width": rng.uniform(0.4, 2.0),
            "height": rng.uniform(1.2, 2.0)}


def make_argoverse(root: str) -> str:
    """Two logs of per-sweep label JSONs (pedestrians, vehicles, a
    bicycle, a class the reference leaves out, a fully occluded label,
    one behind the camera) plus each log's calibration; the second log
    has too few pedestrian frames; a stray file and a log without a
    calibration are passed over."""
    rng = np.random.RandomState(5)
    data = os.path.join(root, "argoverse")
    for log, frames in (("log_a", 12 * 21 + 5), ("log_b", 12 * 6)):
        labels = os.path.join(data, log, "per_sweep_annotations_amodal")
        os.makedirs(labels)
        with open(os.path.join(data, log, "vehicle_calibration_info.json"),
                  "w") as f:
            json.dump(ARGO_CAL, f)
        for f in range(frames):
            items = [
                argo_label(rng, "VEHICLE", "car-1", 18.0 - 0.05 * f, 3.0),
                argo_label(rng, "PEDESTRIAN", "ped-b", 12.0, 1.0 + 0.01 * f),
                argo_label(rng, "PEDESTRIAN", "ped-a", 25.0, -2.0),
                argo_label(rng, "PEDESTRIAN", "ped-occ", 15.0, 0.0, 100),
                argo_label(rng, "BICYCLE", "bike", 30.0, -4.0 + 0.02 * f),
                argo_label(rng, "ANIMAL", "dog", 14.0, 2.0),
                argo_label(rng, "PEDESTRIAN", "ped-behind", -10.0, 0.0),
            ]
            if f % 7 == 3:
                items.append(argo_label(rng, "PEDESTRIAN", "ped-late-%d" % f,
                                        9.0, -1.0))
            with open(os.path.join(labels, "%d.json" % (315969904000 + f)),
                      "w") as fh:
                json.dump(items, fh)
    os.makedirs(os.path.join(data, "log_c", "per_sweep_annotations_amodal"))
    open(os.path.join(data, "README"), "w").close()
    return data


# six videos of three scenes, so that a split directory's glob order
# (which sets the frame file's key order) is unlikely to be sorted
COMBINE_VIDEOS = ["VIRAT_S_040000_00_000000_000100",
                  "VIRAT_S_000201_00_000018_000380",
                  "VIRAT_S_000007_01_000100_000200",
                  "VIRAT_S_040005_02_000300_000400",
                  "VIRAT_S_000205_03_000010_000090",
                  "VIRAT_S_000003_04_000500_000600"]


def make_combine(root: str) -> dict:
    """Per-split trajectory TSVs of ActEV videos (one in two splits,
    rows of one frame in both), and per-scene homographies."""
    rng = np.random.RandomState(7)
    split_path = os.path.join(root, "combine_split")
    for split, videos in (("train", COMBINE_VIDEOS), ("val", []),
                          ("test", COMBINE_VIDEOS[:1])):
        os.makedirs(os.path.join(split_path, split))
        for v, name in enumerate(videos):
            rows = []
            for f in range(0, 120, 12):
                for pid in range(3):
                    rows.append("%d\t%d\t%.3f\t%.3f" % (
                        f, pid + 4 * v + 10 * (split == "test"),
                        rng.uniform(0, 1920), rng.uniform(0, 1080)))
            with open(os.path.join(split_path, split, name + ".txt"),
                      "w") as f:
                f.write("\n".join(rows) + "\n")
    h_path = os.path.join(root, "homography")
    os.makedirs(h_path)
    for scene in ("0400", "0002", "0000"):
        h = np.eye(3) + rng.uniform(-0.01, 0.01, (3, 3))
        with open(os.path.join(h_path, scene + ".txt"), "w") as f:
            f.write("\n".join(",".join("%.9f" % v for v in row)
                              for row in h) + "\n")
    return {"split": split_path, "h": h_path}


def make_moments(root: str) -> dict:
    """Two moments' JSON (controls from ``traj_to_controls``, as the
    moment tools write them) over two files, and two annotators'
    annotation JSONs."""
    moments_out = []
    for m in range(2):
        rows = []
        for f in range(0, 61, 10):
            rows.append((f, 1.0, 0.1 * f + m, 0.05 * f, 0.5))
            rows.append((f, 2.0, 5.0 - 0.02 * f, 5.0, 0.5))
            rows.append((f, 3.0, 8.0, 1.0, 0.5))
        ped, _ = controls.traj_to_controls(np.asarray(rows), -1, -1, 30.0)
        veh_rows = [(f, 9.0, 20.0 + 0.3 * f, 0.1 * m, 0.0)
                    for f in range(0, 61, 15)]
        veh, _ = controls.traj_to_controls(np.asarray(veh_rows), -1, -1,
                                           30.0, z_to=0.0)
        moments_out.append({"scenename": "0400", "ped_controls": ped,
                            "vehicle_controls": veh, "x_agents": [1]})
    moment_files = []
    for m, moment in enumerate(moments_out):
        path = os.path.join(root, "moment_%d.json" % m)
        with open(path, "w") as f:
            json.dump([moment], f)
        moment_files.append(path)
    with open(os.path.join(root, "moments.lst"), "w") as f:
        f.write("\n".join(moment_files) + "\n")
    anno_lines = []
    for annotator, (moment_idx, dest) in (("a7", (1, 0)), ("b2", (0, 1))):
        anno = {"0400_%d_1_%d" % (moment_idx, dest): [
            [f, [0.0, 1.0, 0.0], 1.5 + 0.01 * f,
             [1.0 + 0.01 * f, 0.02 * f, 0.5]] for f in range(20, 45, 3)]}
        path = os.path.join(root, "anno_%s.json" % annotator)
        with open(path, "w") as f:
            json.dump(anno, f)
        anno_lines.append("%s %s" % (path, annotator))
    with open(os.path.join(root, "annotations.lst"), "w") as f:
        f.write("\n".join(anno_lines) + "\n")
    return {"moments": os.path.join(root, "moments.lst"),
            "annos": os.path.join(root, "annotations.lst")}


VEHICLE_VIDEOS = {"VIRAT_S_040000_00_000000_000100": "0400",
                  "VIRAT_S_000201_00_000018_000380": "0002"}


def make_vehicle_yaml(root: str) -> dict:
    """VIRAT YAMLs (a meta prefix, vehicle and person tracks, swapped
    corners the reader repairs, boxes off the pedestrian frames), the
    pedestrian TSVs whose frames select the boxes, and homographies."""
    rng = np.random.RandomState(11)
    traj = os.path.join(root, "ped_traj")
    anno = os.path.join(root, "yaml")
    h_path = os.path.join(root, "vehicle_h")
    for d in (traj, anno, h_path):
        os.makedirs(d)
    for name, scene in VEHICLE_VIDEOS.items():
        w, h = moments.ACTEV_SCENE2IMGSIZE[scene]
        with open(os.path.join(traj, name + ".txt"), "w") as f:
            f.write("".join("%d\t1\t%.1f\t5.0\n" % (fr, fr * 0.5)
                            for fr in range(0, 96, 12)))
        types_lines = ["- {meta: x}", "- {meta: y}"]
        geom_lines = ["- {meta: x}"]
        for tid, obj in ((3, "Vehicle"), (5, "Person"), (8, "Vehicle")):
            types_lines.append(
                "- {types: {id1: %d, cset3: {%s: 1.0}}}" % (tid, obj))
            for fr in range(0, 100, 6):
                x1, y1 = rng.uniform(0, w - 100), rng.uniform(0, h - 60)
                x2, y2 = x1 + rng.uniform(20, 90), y1 + rng.uniform(10, 50)
                if fr % 24 == 0:
                    x1, x2 = x2, x1
                geom_lines.append(
                    "- {geom: {id1: %d, ts0: %d, g0: %.2f %.2f %.2f %.2f, "
                    "src: truth}}" % (tid, fr, x1, y1, x2, y2))
        with open(os.path.join(anno, name + ".types.yml"), "w") as f:
            f.write("\n".join(types_lines) + "\n")
        with open(os.path.join(anno, name + ".geom.yml"), "w") as f:
            f.write("\n".join(geom_lines) + "\n")
    for scene in ("0400", "0002"):
        hm = np.eye(3) + rng.uniform(-0.02, 0.02, (3, 3))
        with open(os.path.join(h_path, scene + ".txt"), "w") as f:
            f.write("\n".join(",".join("%.8f" % v for v in row)
                              for row in hm) + "\n")
    return {"traj": traj, "anno": anno, "h": h_path}


def write_video(cv2, path, frames, size, color):
    w, h = size
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    for i in range(frames):
        vw.write(np.full((h, w, 3), color(i), np.uint8))
    vw.release()


def make_sdd_videos(cv2, root: str) -> dict:
    """A raw portrait and a landscape SDD video (``<scene>/<video>/``),
    and the frame-extraction inputs: trajectory TSVs naming frames of
    two videos, and a video list with one video no TSV names."""
    raw = os.path.join(root, "raw")
    listed = []
    for scene, video, size in (("bookstore", "video0", (48, 64)),
                               ("gates", "video3", (64, 40))):
        d = os.path.join(raw, scene, video)
        os.makedirs(d)
        write_video(cv2, os.path.join(d, "video.mov"), 3, size,
                    lambda i: i * 40)
        listed.append(os.path.join(d, "video.mov"))
    with open(os.path.join(root, "raw_videos.lst"), "w") as f:
        f.write("\n".join(listed) + "\n\n")
    vids = os.path.join(root, "videos", "bookstore")
    os.makedirs(vids)
    for name, n in (("video0", 8), ("video1", 10), ("video5", 4)):
        write_video(cv2, os.path.join(vids, name + ".mp4"), n, (64, 48),
                    lambda i: (i * 30, 255 - i * 20, 90))
    trajs = os.path.join(root, "trajs")
    os.makedirs(os.path.join(trajs, "train"))
    os.makedirs(os.path.join(trajs, "test"))
    for split, name, text in (
            ("train", "bookstore__video0", "2\t1\t5.0\t5.0\n5\t1\t6.0\t6.0\n"),
            ("test", "bookstore__video1", "0\t3\t1.0\t1.0\n9\t3\t2.0\t2.0\n"),
            ("train", "video0", "1\t1\t5.0\t5.0\n7\t1\t6.0\t6.0\n"),
            ("test", "video1", "3\t2\t5.0\t5.0\n")):
        with open(os.path.join(trajs, split, name + ".txt"), "w") as f:
            f.write(text)
    with open(os.path.join(root, "videos.lst"), "w") as f:
        f.write("".join(os.path.join(vids, n + ".mp4\n")
                        for n in ("video0", "video1", "video5")))
    return {"raw": os.path.join(root, "raw_videos.lst"),
            "videos": os.path.join(root, "videos.lst"), "trajs": trajs}


def palette_frame(i: int, h: int, w: int) -> np.ndarray:
    """A BGR frame of CARLA palette blocks that shift with the frame."""
    ids = (np.arange(h)[:, None] // 6 + np.arange(w)[None, :] // 8
           + i) % len(prepared_data.CARLA_PALETTE)
    return prepared_data.CARLA_PALETTE[ids][:, :, ::-1].astype(np.uint8)


def make_rendered(cv2, root: str, fp: dict) -> dict:
    """The recorder's rendered videos for the prepared obs: rgb mp4s
    and palette seg mp4s, the seg beside the rgb (``<name>_seg.mp4``)
    for some and under ``../videos_seg/`` for others, one seg video
    too short (a bad video)."""
    obs = os.path.join(root, "rendered_obs")
    jax_cli.prepare_multifuture_main(
        [fp["ds"], fp["split_mf"], obs, os.path.join(root, "rendered_mf")])
    anchor = os.path.join(root, "rendered_anchor")
    jax_cli.prepare_anchor_main([fp["ds"], fp["split_anchor"], anchor,
                                 "--drop_frame", "30", "--min_frames", "5"])
    videos = os.path.join(root, "render", "videos")
    segs = os.path.join(root, "render", "videos_seg")
    os.makedirs(videos)
    os.makedirs(segs)
    h, w = 72, 128

    def write(path, n):
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (w, h))
        for i in range(n):
            vw.write(palette_frame(i, h, w))
        vw.release()
    for k, (name, n, _) in enumerate(MULTIFUTURE[:3]):
        write(os.path.join(videos, name + ".mp4"), n)
        seg = (os.path.join(videos, name + "_seg.mp4") if k == 0
               else os.path.join(segs, name + ".mp4"))
        write(seg, n)
    for k, (name, n) in enumerate(ANCHOR[:3]):
        write(os.path.join(videos, name + ".mp4"), n)
        seg = (os.path.join(videos, name + "_seg.mp4") if k == 0
               else os.path.join(segs, name + ".mp4"))
        write(seg, n if k < 2 else 200)
    return {"obs": os.path.join(obs, "traj_2.5fps"),
            "anchor": os.path.join(anchor, "traj_2.5fps"),
            "videos": videos}


# ------------------------------------------------------------- commands


def _cases():
    """(case id, jax main, port main, inputs(cv2, root) -> dict,
    argv(inputs, out) -> list, optional package)."""
    fp = make_forking_paths
    return [
        ("split-path", jax_cli.split_path_main, cli.split_path_main, fp,
         lambda i, o: [i["videos_mf"], o], None),
        ("split-path-anchor", jax_cli.split_path_main, cli.split_path_main,
         fp, lambda i, o: [i["videos_anchor"], o, "--is_anchor",
                           "--ori_split_path", i["ori"]], None),
        ("prepare-multifuture", jax_cli.prepare_multifuture_main,
         cli.prepare_multifuture_main, fp,
         lambda i, o: [i["ds"], i["split_mf"], o + "/obs", o + "/mf"], None),
        ("prepare-multifuture-obs4", jax_cli.prepare_multifuture_main,
         cli.prepare_multifuture_main, fp,
         lambda i, o: [i["ds"], i["split_mf"], o + "/obs", o + "/mf",
                       "--obs_length", "4"], None),
        ("prepare-anchor", jax_cli.prepare_anchor_main,
         cli.prepare_anchor_main, fp,
         lambda i, o: [i["ds"], i["split_anchor"], o], None),
        ("prepare-anchor-drop10", jax_cli.prepare_anchor_main,
         cli.prepare_anchor_main, fp,
         lambda i, o: [i["ds"], i["split_anchor"], o, "--drop_frame", "10",
                       "--min_frames", "5"], None),
        ("prepare-sdd", jax_cli.prepare_sdd_main, cli.prepare_sdd_main,
         make_sdd, lambda i, o: [i["anno"], i["split"], i["changes"], o],
         None),
        ("sdd-splits", jax_cli.sdd_splits_main, cli.sdd_splits_main,
         make_sdd, lambda i, o: [i["videos"], o], None),
        ("sdd-splits-3fold", jax_cli.sdd_splits_main, cli.sdd_splits_main,
         make_sdd, lambda i, o: [i["videos"], o, "--n_fold", "3",
                                 "--seed", "7"], None),
        ("prepare-argoverse", jax_cli.prepare_argoverse_main,
         cli.prepare_argoverse_main, make_argoverse,
         lambda i, o: [i, o, "--split", "val"], None),
        ("combine-traj", jax_cli.combine_traj_main, cli.combine_traj_main,
         make_combine, lambda i, o: [i["split"], o + "/px",
                                     o + "/frames.json"], None),
        ("combine-traj-actev", jax_cli.combine_traj_main,
         cli.combine_traj_main, make_combine,
         lambda i, o: [i["split"], o + "/px", o + "/frames.json",
                       "--reverse_xy", "--is_actev", "--h_path", i["h"],
                       "--target_w_path", o + "/world"], None),
        ("gen-moments", jax_cli.gen_moments_main, cli.gen_moments_main,
         make_moments, lambda i, o: [i["moments"], i["annos"],
                                     o + "/final.json"], None),
        ("get-vehicle-traj", jax_cli.get_vehicle_traj_main,
         cli.get_vehicle_traj_main, make_vehicle_yaml,
         lambda i, o: [i["traj"], i["anno"], i["h"], o], "yaml"),
        ("get-vehicle-traj-job2", jax_cli.get_vehicle_traj_main,
         cli.get_vehicle_traj_main, make_vehicle_yaml,
         lambda i, o: [i["traj"], i["anno"], i["h"], o, "--job", "2",
                       "--curJob", "2"], "yaml"),
        ("sdd-frames", jax_cli.sdd_frames_main, cli.sdd_frames_main,
         "sdd_videos", lambda i, o: [i["videos"], i["trajs"], o + "/frames"],
         "cv2"),
        ("sdd-frames-resize", jax_cli.sdd_frames_main, cli.sdd_frames_main,
         "sdd_videos", lambda i, o: [
             i["videos"], i["trajs"], o + "/frames", "--use_2level",
             "--name_level", "1", "--resize", "--size", "24",
             "--maxsize", "1333", "--statspath", o + "/stats"], "cv2"),
        ("resize-rotate-sdd", jax_cli.resize_rotate_sdd_main,
         cli.resize_rotate_sdd_main, "sdd_videos",
         lambda i, o: [i["raw"], o + "/videos", o + "/changes.lst"], "cv2"),
        ("extract-frames-seg", jax_vis.extract_frames_seg_main,
         vis.extract_frames_seg_main, "rendered",
         lambda i, o: [i["obs"], i["videos"], o + "/frames", o + "/seg",
                       o + "/bad_video.lst", "--is_multifuture",
                       "--scene_h", "9", "--scene_w", "16"], "cv2"),
        ("extract-frames-seg-anchor", jax_vis.extract_frames_seg_main,
         vis.extract_frames_seg_main, "rendered",
         lambda i, o: [i["anchor"], i["videos"], o + "/frames", o + "/seg",
                       o + "/bad_video.lst"], "cv2"),
    ]


CASES = {c[0]: c[1:] for c in _cases()}


@pytest.mark.parametrize("case", list(CASES))
def test_command_writes_the_jax_commands_files(case, tmp_path, capsys):
    jax_main, port_main, make, argv, package = CASES[case]
    cv2 = pytest.importorskip(package) if package == "cv2" else None
    if package == "yaml":
        pytest.importorskip("yaml")
    root = str(tmp_path / "in")
    os.makedirs(root)
    if make == "sdd_videos":
        inputs = make_sdd_videos(cv2, root)
    elif make == "rendered":
        inputs = make_rendered(cv2, root, make_forking_paths(root))
    else:
        inputs = make(root)
    capsys.readouterr()
    printed = {}
    for who, main in (("jax", jax_main), ("port", port_main)):
        out = str(tmp_path / who)
        os.makedirs(out)
        main(argv(inputs, out))
        printed[who] = capsys.readouterr().out.replace(out, "<out>")
    n = _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert n > 0
    assert printed["port"] == printed["jax"]


def test_the_prepared_forking_paths_files(tmp_path):
    """What the parity cases compare is not empty: the port's
    multi-future prep of the generated set keeps 2 of its 4 obs (one is
    too short, one's x-agent is a vehicle), with 8 obs steps of the
    x-agent and futures of up to 12 steps, typed as the JAX package
    types them."""
    fp = make_forking_paths(str(tmp_path))
    names = [n for n, _, _ in MULTIFUTURE]
    stats = prepared_data.prepare_multifuture_split(
        fp["ds"], names, str(tmp_path / "obs"), str(tmp_path / "mf"),
        "test")
    assert stats["num_obs"] == 4 and stats["skipped"] == 2
    assert stats["future_len_max"] == 12.0
    with open(tmp_path / "mf" / "test" / "0000_3_1_cam2.p", "rb") as f:
        gt = pickle.load(f)
    assert sorted(gt) == sorted(names[2:5])
    fut = gt["0000_3_1_0_a_cam2"]
    assert len(fut["x_agent_traj"]) == 12 and len(fut["obs_traj"]) == 8
    new_idx, track, x, y = fut["obs_traj"][0]
    assert (type(new_idx), type(track), type(x)) == (int, float, float)
    assert type(fut["x_agent_traj"][0][1]) is int
    assert type(fut["all_boxes"][0][2]) is int


# ------------------------------------------------------------ functions


def _controls_case(m):
    rng = np.random.RandomState(1)
    rows = []
    for pid in (1.0, 2.0, 7.0):
        x, y = rng.uniform(-5, 5, 2)
        for f in range(0, 121, 10):
            still = pid == 7.0 and f > 40
            rows.append([f, pid, x + (0 if still else 0.04 * f * pid),
                         y + (0 if still else 0.01 * f), 0.3 * pid])
    rows = np.asarray(rows)
    out = []
    for kw in ({}, {"interpolate": True}, {"z_to": 0.0},
               {"no_offset": True}):
        out.append(m.controls.traj_to_controls(rows, 20.0, 100.0, 25.0,
                                               **kw))
    ctl, _ = m.controls.traj_to_controls(rows, -1, -1, 25.0)
    out.append(m.controls.interpolate_controls(ctl, 30.0))
    out.append(m.controls.controls_to_traj(ctl))
    return out


def _pixel_to_world_case(m):
    rng = np.random.RandomState(2)
    xy = rng.uniform(0, 1920, (50, 2))
    hm = np.eye(3) + rng.uniform(-0.05, 0.05, (3, 3))
    return [m.moments.pixel_to_world_ground(xy, hm, scene, mirror_x=mirror)
            for scene in ("0000", "0002") for mirror in (True, False)]


def _vehicle_case(m):
    rng = np.random.RandomState(3)
    rows = [(int(rng.randint(1, 5)), int(rng.randint(0, 50)),
             [float(v) for v in rng.uniform(0, 1280, 4)])
            for _ in range(60)]
    hm = np.eye(3) + rng.uniform(-0.05, 0.05, (3, 3))
    return [m.moments.vehicle_trajectories(rows, [1, 3], hm, scene,
                                           frame_ids=frames)
            for scene in ("0000", "0002")
            for frames in (None, range(0, 50, 4))]


def _cuboid_case(m):
    rng = np.random.RandomState(4)
    camera = m.argoverse.ArgoverseCamera.from_calibration(ARGO_CAL)
    labels = [argo_label(rng, "PEDESTRIAN", "p", x, y)
              for x, y in rng.uniform(-30, 60, (40, 2))]
    return [m.argoverse.cuboid_to_2d_box(label, camera) for label in labels]


def _seg_case(m):
    rng = np.random.RandomState(5)
    palette = m.prepared.CARLA_PALETTE
    ids = rng.randint(0, len(palette), (24, 40))
    noisy = np.clip(palette[ids] + rng.randint(-5, 6, (24, 40, 3)), 0, 255)
    carla = m.prepared.seg_rgb_to_carla_ids(noisy.astype(np.uint8))
    ade = m.prepared.carla_ids_to_ade20k(carla)
    return [carla, ade, m.prepared.resize_nearest(ade, 9, 16)]


def _sdd_bbox_case(m):
    rng = np.random.RandomState(6)
    boxes = rng.randint(0, 1400, (30, 4))
    return [m.sdd.convert_sdd_bbox(b, change) for b in boxes
            for change in ((1424, 1088, False), (1424, 1088, True))]


FUNCTIONS = {
    "traj_to_controls+interpolate_controls": _controls_case,
    "pixel_to_world_ground": _pixel_to_world_case,
    "vehicle_trajectories": _vehicle_case,
    "cuboid_to_2d_box": _cuboid_case,
    "seg_rgb_to_carla_ids": _seg_case,
    "convert_sdd_bbox": _sdd_bbox_case,
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_function_equals_jax(name):
    want = FUNCTIONS[name](JAX)
    got = FUNCTIONS[name](PORT)
    _same(got, want, name)


# -------------------------------------------------------- missing packages


GATED = [
    ("sdd-frames", cli.sdd_frames_main, "cv2", 3),
    ("resize-rotate-sdd", cli.resize_rotate_sdd_main, "cv2", 3),
    ("extract-frames-seg", vis.extract_frames_seg_main, "cv2", 5),
    ("get-vehicle-traj", cli.get_vehicle_traj_main, "yaml", 4),
]


@pytest.mark.parametrize("command,main,package,nargs", GATED,
                         ids=[g[0] for g in GATED])
def test_command_without_its_package_raises(command, main, package, nargs,
                                            tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, package, None)
    argv = [str(tmp_path / ("arg%d" % i)) for i in range(nargs)]
    with pytest.raises(ImportError) as err:
        main(argv)
    assert package in str(err.value)
    assert "mvt-torch-" + command in str(err.value)
    assert err.value.name == package
    assert os.listdir(tmp_path) == []
