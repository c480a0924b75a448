"""Dataset preparation: rendered bbox JSONs → model-ready inputs.

The port's copy of ``multiverse_tpu/forking_paths/prepared_data.py``:
the same TSVs, pickles (Python builtins, not numpy scalars) and npys.
``cv2`` is imported inside the two video readers only, as there.

Rebuilds of reference: forking_paths_dataset/code/
get_prepared_data_multifuture.py (bbox JSONs → obs trajectory TSVs +
per-obs multi-future GT pickles), get_frames_and_scene_seg.py (seg MP4
→ per-frame ADE20k class-map npys with the compression-tolerant
CityScapes palette match), get_split_path.py (split lists).

The palette match is vectorized: instead of enumerating a ±4 RGB cube
per palette color into a 93-million-entry dict (reference:
get_frames_and_scene_seg.py:104-114), each pixel is matched to the
palette color within L∞ ≤ 4 in one broadcast compare — identical
labels, O(pixels × 13) instead of O(pixels) dict probes after an
O(9³ × 13) table build.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Iterable, List, Tuple

import numpy as np

OBS_LENGTH = 8
# 2.5 fps sampling windows (reference:
# get_prepared_data_multifuture.py:74-82): multi-future pred starts at
# frame 124 (virat 30fps) / 102 (ethucy 25fps); obs is 3.2 s long.
DROP_FRAME = {"virat": 12, "ethucy": 10}
FRAME_RANGE = {"virat": (40, 125), "ethucy": (32, 103)}
CLASS2CLASSID = {"Person": 0, "Vehicle": 1}

# CARLA 0.9.6 semantic-segmentation CityScapes palette (RGB) → class id
# (reference: get_frames_and_scene_seg.py:58-73; carla.readthedocs.io
# cameras_and_sensors).
CARLA_PALETTE = np.asarray([
    (0, 0, 0), (70, 70, 70), (190, 153, 153), (250, 170, 160),
    (220, 20, 60), (153, 153, 153), (157, 234, 50), (128, 64, 128),
    (244, 35, 232), (107, 142, 35), (0, 0, 142), (102, 102, 156),
    (220, 220, 0),
], np.int16)

# CARLA class id → ADE20k id (reference:
# get_frames_and_scene_seg.py:42-56; class 4 = person → ADE20k 13).
CARLA_TO_ADE20K = np.asarray(
    [0, 2, 33, 0, 13, 94, 7, 7, 12, 10, 21, 1, 137], np.uint8)


def is_virat_scene(scene: str) -> bool:
    """VIRAT scene tokens are zero-padded numbers ("0000"…); ETH/UCY
    use names (reference: get_prepared_data_multifuture.py:138-143)."""
    return scene.startswith("0")


def scene_timing(scene: str) -> Tuple[int, Tuple[int, int]]:
    key = "virat" if is_virat_scene(scene) else "ethucy"
    return DROP_FRAME[key], FRAME_RANGE[key]


# -------------------------------------------------------- bbox → data


def convert_bbox(bbox) -> List[float]:
    x, y, w, h = bbox
    return [x, y, x + w, y + h]


def get_feet(bbox_xyxy) -> Tuple[float, float]:
    """Bottom-center of the box = ground-plane point
    (reference: get_prepared_data_multifuture.py:27-29)."""
    x1, y1, x2, y2 = bbox_xyxy
    return (x1 + x2) / 2.0, y2


def load_frame_data(bbox_json: str) -> Dict[int, list]:
    """bbox JSON → frame_id → [box dicts], negative boxes dropped
    (reference: get_prepared_data_multifuture.py:45-68)."""
    with open(bbox_json) as f:
        boxes = json.load(f)
    frame_data: Dict[int, list] = {}
    for box in boxes:
        x, y, w, h = box["bbox"]
        if min(x, y, x + w, y + h) < 0:
            continue
        frame_data.setdefault(box["frame_id"], []).append(box)
    return frame_data


def group_by_obs(videonames: Iterable[str]) -> Dict[tuple, List[str]]:
    """`scene_moment_pid_dest_annotator_camera` names → grouped by the
    shared observation (scene, moment, pid, camera)
    (reference: get_prepared_data_multifuture.py:32-41)."""
    groups: Dict[tuple, List[str]] = {}
    for name in videonames:
        scene, moment_idx, pid, _, _, camera = name.split("_")
        groups.setdefault((scene, moment_idx, pid, camera), []).append(name)
    return groups


def prepare_multifuture_split(
    dataset_path: str,
    videonames: List[str],
    outpath_obs: str,
    outpath_multifuture: str,
    split: str,
    obs_length: int = OBS_LENGTH,
) -> Dict[str, float]:
    """One split: write traj TSVs, person/other box pickles, and the
    multifuture GT pickles (reference:
    get_prepared_data_multifuture.py:108-251; formats at :244-251).

    Returns stats (skipped count, future-length min/max/mean).
    """
    traj_path = os.path.join(outpath_obs, "traj_2.5fps", split)
    person_box_path = os.path.join(outpath_obs, "anno_person_box", split)
    other_box_path = os.path.join(outpath_obs, "anno_other_box", split)
    mf_path = os.path.join(outpath_multifuture, split)
    for p in (traj_path, person_box_path, other_box_path, mf_path):
        os.makedirs(p, exist_ok=True)

    groups = group_by_obs(videonames)
    skipped = 0
    future_lengths: List[int] = []

    for obs_key, names in groups.items():
        scene, moment_idx, pid, camera = obs_key
        obs_key_name = "_".join(obs_key)
        drop_frame, (start_frame, _) = scene_timing(scene)

        frame_data = load_frame_data(
            os.path.join(dataset_path, "bbox", "%s.json" % names[0]))
        frame_idxs = sorted(frame_data)
        needed = frame_idxs[start_frame::drop_frame]
        if len(needed) <= obs_length:
            skipped += 1
            continue
        obs_frames = needed[:obs_length]

        traj_rows, x_agent_rows = [], []
        person_boxes: Dict[str, list] = {}
        other_boxes: Dict[str, tuple] = {}
        for frame_idx in obs_frames:
            box_list = sorted(
                frame_data[frame_idx], key=lambda b: b["track_id"])
            for i, box in enumerate(box_list):
                if box["class_name"] != "Person":
                    continue
                new_idx = frame_idx - start_frame
                bbox = convert_bbox(box["bbox"])
                x, y = get_feet(bbox)
                row = (new_idx, float(box["track_id"]), x, y)
                traj_rows.append(row)
                if int(box["is_x_agent"]) == 1:
                    x_agent_rows.append(row)
                key = "%d_%d" % (new_idx, box["track_id"])
                person_boxes[key] = bbox
                other_boxes[key] = (
                    [convert_bbox(b["bbox"])
                     for j, b in enumerate(box_list) if j != i],
                    [CLASS2CLASSID[b["class_name"]]
                     for j, b in enumerate(box_list) if j != i],
                )

        if len(x_agent_rows) != obs_length:
            skipped += 1
            continue

        with open(os.path.join(
                traj_path, "%s.txt" % obs_key_name), "w") as f:
            for fi, p, x, y in traj_rows:
                f.write("%d\t%.1f\t%.6f\t%.6f\n" % (fi, p, x, y))
        with open(os.path.join(
                person_box_path, "%s.p" % obs_key_name), "wb") as f:
            pickle.dump(person_boxes, f)
        with open(os.path.join(
                other_box_path, "%s.p" % obs_key_name), "wb") as f:
            pickle.dump(other_boxes, f)

        multifuture: Dict[str, dict] = {}
        for name in names:
            fd = load_frame_data(
                os.path.join(dataset_path, "bbox", "%s.json" % name))
            needed = sorted(fd)[start_frame::drop_frame]
            pred_frames = needed[obs_length:]
            future_lengths.append(len(pred_frames))
            x_agent_traj, all_boxes = [], []
            for frame_idx in pred_frames:
                for box in sorted(fd[frame_idx],
                                  key=lambda b: b["track_id"]):
                    new_idx = frame_idx - start_frame
                    bbox = convert_bbox(box["bbox"])
                    if int(box["is_x_agent"]) == 1:
                        x, y = get_feet(bbox)
                        x_agent_traj.append(
                            (new_idx, box["track_id"], x, y))
                    all_boxes.append((new_idx, box["class_name"],
                                      box["is_x_agent"],
                                      box["track_id"], bbox))
            multifuture[name] = {
                "x_agent_traj": x_agent_traj,
                "all_boxes": all_boxes,
                "obs_traj": x_agent_rows,
            }
        with open(os.path.join(
                mf_path, "%s.p" % obs_key_name), "wb") as f:
            pickle.dump(multifuture, f)

    return {
        "num_obs": len(groups),
        "skipped": skipped,
        "future_len_min": float(min(future_lengths, default=0)),
        "future_len_max": float(max(future_lengths, default=0)),
        "future_len_mean": float(np.mean(future_lengths))
        if future_lengths else 0.0,
    }


# ------------------------------------------------------- seg decoding


def seg_rgb_to_carla_ids(frame_rgb: np.ndarray,
                         tolerance: int = 4) -> np.ndarray:
    """Compression-tolerant palette match: [H, W, 3] RGB → CARLA class
    ids; pixels matching no palette color within L∞ ≤ tolerance → 0
    (reference: get_frames_and_scene_seg.py:104-114 ±4 cube table).
    """
    img = frame_rgb.astype(np.int16)
    # [H, W, P] max channel distance per palette color
    dist = np.abs(
        img[:, :, None, :] - CARLA_PALETTE[None, None, :, :]).max(-1)
    best = dist.argmin(-1)
    out = np.where(
        np.take_along_axis(dist, best[..., None], -1)[..., 0] <= tolerance,
        best, 0)
    return out.astype(np.uint8)


def carla_ids_to_ade20k(carla_ids: np.ndarray) -> np.ndarray:
    """reference: get_frames_and_scene_seg.py:42-56."""
    return CARLA_TO_ADE20K[carla_ids]


def resize_nearest(class_map: np.ndarray, out_h: int,
                   out_w: int) -> np.ndarray:
    """Nearest-neighbor downsample of an integer class map."""
    h, w = class_map.shape
    ys = (np.arange(out_h) * (h / out_h)).astype(np.int64)
    xs = (np.arange(out_w) * (w / out_w)).astype(np.int64)
    return class_map[ys[:, None], xs[None, :]]


def decode_seg_video(
    seg_video: str,
    frame_idxs: List[int],
    out_h: int = 36,
    out_w: int = 64,
) -> Dict[int, np.ndarray]:
    """Seg MP4 → {frame_idx: [out_h, out_w] ADE20k class map}.

    Matches the reference's order of operations — nearest-neighbor
    resize to the grid size *first*, then palette match, then the
    CARLA→ADE20k remap (reference:
    get_frames_and_scene_seg.py:195-222)."""
    import cv2

    wanted = set(frame_idxs)
    out: Dict[int, np.ndarray] = {}
    vcap = cv2.VideoCapture(seg_video)
    if not vcap.isOpened():
        raise RuntimeError("cannot open %s" % seg_video)
    idx = 0
    while True:
        ok, frame = vcap.read()
        if not ok:
            break
        if idx in wanted:
            small = cv2.resize(frame, (out_w, out_h),
                               interpolation=cv2.INTER_NEAREST)
            rgb = cv2.cvtColor(small, cv2.COLOR_BGR2RGB)
            out[idx] = carla_ids_to_ade20k(seg_rgb_to_carla_ids(rgb))
        idx += 1
    vcap.release()
    return out


def extract_frames_and_seg(
    rgb_video: str,
    seg_video: str,
    frame_idxs: List[int],
    out_frame_path: str,
    out_seg_path: str,
    videoname: str,
    start: int = 0,
    scene_h: int = 36,
    scene_w: int = 64,
) -> bool:
    """Extract the needed RGB frames + decoded seg npys for one video;
    returns False when the rgb/seg/trajectory frame counts disagree —
    callers collect those into `bad_video.lst`, which the workflow
    deletes (reference: get_frames_and_scene_seg.py:130-241)."""
    import cv2

    os.makedirs(out_frame_path, exist_ok=True)
    os.makedirs(out_seg_path, exist_ok=True)
    wanted = set(frame_idxs)

    got_rgb = 0
    vcap = cv2.VideoCapture(rgb_video)
    idx = 0
    while True:
        ok, frame = vcap.read()
        if not ok:
            break
        if idx in wanted:
            cv2.imwrite(os.path.join(
                out_frame_path,
                "%s_F_%08d.jpg" % (videoname, idx - start)), frame)
            got_rgb += 1
        idx += 1
    vcap.release()

    segs = decode_seg_video(seg_video, sorted(wanted),
                            out_h=scene_h, out_w=scene_w)
    for fidx, seg in segs.items():
        np.save(os.path.join(
            out_seg_path,
            "%s_F_%08d.npy" % (videoname, fidx - start)), seg)

    return got_rgb == len(segs) == len(wanted)


def prepare_anchor_split(
    dataset_path: str,
    videonames: List[str],
    outpath: str,
    split: str,
    drop_frame: int = DROP_FRAME["virat"],
    min_frames: int = 20,
) -> List[int]:
    """Anchor (single-future) videos → TSVs + box pickles over ALL
    sampled frames — no obs/pred split, no rebasing
    (reference: forking_paths_dataset/code/get_prepared_data.py).
    Returns per-video needed-frame counts."""
    traj_path = os.path.join(outpath, "traj_2.5fps", split)
    person_box_path = os.path.join(outpath, "anno_person_box", split)
    other_box_path = os.path.join(outpath, "anno_other_box", split)
    for p in (traj_path, person_box_path, other_box_path):
        os.makedirs(p, exist_ok=True)

    counts = []
    for videoname in videonames:
        frame_data = load_frame_data(
            os.path.join(dataset_path, "bbox", "%s.json" % videoname))
        needed = sorted(frame_data)[::drop_frame]
        if len(needed) < min_frames:
            print("warning: %s too short, skipped" % videoname)
            continue

        traj_rows: list = []
        person_boxes: dict = {}
        other_boxes: dict = {}
        for frame_idx in needed:
            box_list = sorted(frame_data[frame_idx],
                              key=lambda b: b["track_id"])
            for i, box in enumerate(box_list):
                if box["class_name"] != "Person":
                    continue
                bbox = convert_bbox(box["bbox"])
                x, y = get_feet(bbox)
                traj_rows.append(
                    (frame_idx, float(box["track_id"]), x, y))
                key = "%d_%d" % (frame_idx, box["track_id"])
                person_boxes[key] = bbox
                other_boxes[key] = (
                    [convert_bbox(b["bbox"])
                     for j, b in enumerate(box_list) if j != i],
                    [CLASS2CLASSID[b["class_name"]]
                     for j, b in enumerate(box_list) if j != i],
                )
        counts.append(len(needed))
        with open(os.path.join(
                traj_path, "%s.txt" % videoname), "w") as f:
            for fi, p, x, y in traj_rows:
                f.write("%d\t%.1f\t%.6f\t%.6f\n" % (fi, p, x, y))
        with open(os.path.join(
                person_box_path, "%s.p" % videoname), "wb") as f:
            pickle.dump(person_boxes, f)
        with open(os.path.join(
                other_box_path, "%s.p" % videoname), "wb") as f:
            pickle.dump(other_boxes, f)
    return counts


# ------------------------------------------------------------- splits


def reference_split_lists(
    videonames: List[str],
    out_path: str,
    is_anchor: bool = False,
    ori_split_path: str = None,
) -> Dict[str, List[str]]:
    """The reference's split semantics (get_split_path.py:30-63):
    the multi-future dataset is a TEST-only benchmark (every video →
    test.lst); anchor videos follow the original VIRAT splits — each
    `<viratname>_F_...` video goes to the split its VIRAT source video
    is in, read from `ori_split_path/{train,val,test}.lst`.  Videos
    whose source is in no list are dropped with a warning, like the
    reference.  Writes the three .lst files and returns the splits."""
    os.makedirs(out_path, exist_ok=True)
    splits: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    if not is_anchor:
        splits["test"] = list(videonames)
    else:
        if ori_split_path is None:
            raise ValueError("anchor splits need ori_split_path "
                             "(the original VIRAT split lists)")
        source_split = {}
        for split in ("train", "val", "test"):
            with open(os.path.join(ori_split_path,
                                   "%s.lst" % split)) as f:
                for line in f:
                    name = os.path.splitext(
                        os.path.basename(line.strip()))[0]
                    if name:
                        source_split[name] = split
        for videoname in videonames:
            virat_videoname = videoname.split("_F_")[0]
            split = source_split.get(virat_videoname)
            if split is None:
                print("%s not in all lst" % videoname)
                continue
            splits[split].append(videoname)
    for split, names in splits.items():
        with open(os.path.join(out_path, "%s.lst" % split), "w") as f:
            for one in names:
                f.write("%s\n" % one)
    print("original %s videos, split into train %s, val %s, test %s"
          % (len(videonames), len(splits["train"]), len(splits["val"]),
             len(splits["test"])))
    return splits


def write_split_lists(
    videonames: List[str],
    out_path: str,
    val_frac: float = 0.1,
    test_frac: float = 0.2,
    seed: int = 2020,
) -> Dict[str, List[str]]:
    """Framework extra (NOT the reference semantics — see
    reference_split_lists for those): a deterministic fraction-based
    train/val/test split grouped by observation so all futures of one
    obs land in one split.  Useful for training on self-recorded
    moment datasets where no original VIRAT split exists."""
    os.makedirs(out_path, exist_ok=True)
    groups = group_by_obs(videonames)
    keys = sorted(groups)
    rnd = np.random.RandomState(seed)
    order = rnd.permutation(len(keys))
    n_test = int(len(keys) * test_frac)
    n_val = int(len(keys) * val_frac)
    split_of = {}
    for rank, ki in enumerate(order):
        split_of[keys[ki]] = (
            "test" if rank < n_test
            else "val" if rank < n_test + n_val else "train")
    splits = {"train": [], "val": [], "test": []}
    for key, names in groups.items():
        splits[split_of[key]].extend(sorted(names))
    for split, names in splits.items():
        with open(os.path.join(out_path, "%s.lst" % split), "w") as f:
            f.write("\n".join(sorted(names)) + "\n")
    return splits
