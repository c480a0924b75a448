"""Stanford Drone Dataset preparation.

The port's copy of ``multiverse_tpu/data/sdd.py`` (which its package's
``data/__init__.py`` makes unimportable without jax). ``cv2`` is
imported inside the two video functions only, as there.

reference: SimAug/code/resize_rotate_sdd.py (portrait videos rotated
90° clockwise then everything rescaled to 1920×1080, with a change
list recording original resolutions), get_prepared_data_sdd.py
(annotations.txt → trajectory TSVs + box pickles in the rescaled
frame), get_sdd_splits.py, get_frames_sdd.py.

Video IO uses cv2 (the bare image has no ffmpeg); the box/trajectory
math is pure numpy and fully tested.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

TARGET_RESOLUTION = (1920.0, 1080.0)

# merged SDD classes (reference: get_prepared_data_sdd.py:37-45)
SDD_CLASS2CLASSID = {
    "Pedestrian": 0,
    "Car": 1,
    "Bus": 1,
    "Cart": 1,
    "Biker": 8,
    "Skater": 8,
}
SDD_DROP_FRAME = 12


def parse_changelst(changelst_path: str) -> Dict[str, Tuple[int, int, bool]]:
    """video_id → (w, h, rotated) with w/h swapped when rotated
    (reference: get_prepared_data_sdd.py:77-88)."""
    out = {}
    for line in open(changelst_path):
        video_id, reso, rotated = line.strip().split(",")
        rotated = rotated == "True"
        w, h = (int(v) for v in reso.split("x"))
        if rotated:
            w, h = h, w
        out[video_id] = (w, h, rotated)
    return out


def convert_sdd_bbox(bbox, video_change: Tuple[int, int, bool]
                     ) -> List[float]:
    """Original-frame [x1, y1, x2, y2] → 1920×1080 frame, applying the
    90°-clockwise rotation for portrait videos first
    (reference: get_prepared_data_sdd.py:89-103)."""
    w, h, rotated = video_change
    x1, y1, x2, y2 = (float(v) for v in bbox)
    if rotated:
        x1, y1, x2, y2 = y1, x1, y2, x2
        x1 = w - x1
        x2 = w - x2
    sx = TARGET_RESOLUTION[0] / w
    sy = TARGET_RESOLUTION[1] / h
    return [x1 * sx, y1 * sy, x2 * sx, y2 * sy]


def bbox_center(bbox) -> Tuple[float, float]:
    x1, y1, x2, y2 = bbox
    return (x1 + x2) / 2.0, (y1 + y2) / 2.0


def load_sdd_annotations(annotation_file: str) -> List[dict]:
    """annotations.txt rows: track x1 y1 x2 y2 frame lost occluded
    generated "label"."""
    out = []
    for line in open(annotation_file):
        parts = line.strip().split()
        if len(parts) < 10:
            continue
        out.append({
            "track_id": int(parts[0]),
            "bbox": [int(v) for v in parts[1:5]],
            "frame_idx": int(parts[5]),
            "lost": parts[6] == "1",
            "class_name": parts[9].strip('"'),
        })
    return out


def prepare_sdd_video(
    annotation_file: str,
    video_id: str,
    changelst: Dict[str, Tuple[int, int, bool]],
    min_frames: int = 20,
    drop_frame: int = SDD_DROP_FRAME,
) -> Optional[Tuple[list, dict, dict, List[int]]]:
    """One video's annotations → (traj rows, person boxes, other
    boxes, needed frame idxs); None when too short
    (reference: get_prepared_data_sdd.py:116-188)."""
    anno = load_sdd_annotations(annotation_file)
    frame_idxs = sorted({
        a["frame_idx"] for a in anno
        if a["class_name"] == "Pedestrian" and not a["lost"]})
    needed = frame_idxs[::drop_frame]
    if len(needed) < min_frames:
        return None
    needed_set = set(needed)

    frame_data: Dict[int, list] = {}
    for a in anno:
        if a["frame_idx"] not in needed_set or a["lost"]:
            continue
        frame_data.setdefault(a["frame_idx"], []).append(dict(
            a, bbox=convert_sdd_bbox(a["bbox"], changelst[video_id])))

    traj_rows: list = []
    person_boxes: dict = {}
    other_boxes: dict = {}
    for frame_idx in needed:
        box_list = sorted(frame_data.get(frame_idx, []),
                          key=lambda b: b["track_id"])
        for i, box in enumerate(box_list):
            if box["class_name"] != "Pedestrian":
                continue
            x, y = bbox_center(box["bbox"])
            if x > TARGET_RESOLUTION[0] or y > TARGET_RESOLUTION[1]:
                continue
            key = "%s_%d_%d" % (video_id, frame_idx, box["track_id"])
            traj_rows.append((frame_idx, float(box["track_id"]), x, y))
            person_boxes[key] = box["bbox"]
            other_boxes[key] = (
                [b["bbox"] for j, b in enumerate(box_list) if j != i],
                [SDD_CLASS2CLASSID[b["class_name"]]
                 for j, b in enumerate(box_list) if j != i],
            )
    return traj_rows, person_boxes, other_boxes, needed


def prepare_sdd_split(
    annotation_path: str,
    video_ids: List[str],
    changelst: Dict[str, Tuple[int, int, bool]],
    out_path: str,
    split: str,
) -> List[int]:
    """Write one split's TSVs + box pickles
    (reference: get_prepared_data_sdd.py:108-210).  Returns per-video
    needed-frame counts."""
    traj_path = os.path.join(out_path, "traj_2.5fps", split)
    person_path = os.path.join(out_path, "anno_person_box", split)
    other_path = os.path.join(out_path, "anno_other_box", split)
    for p in (traj_path, person_path, other_path):
        os.makedirs(p, exist_ok=True)

    counts = []
    for video_id in video_ids:
        scene, videoname = video_id.split("_")
        res = prepare_sdd_video(
            os.path.join(annotation_path, scene, videoname,
                         "annotations.txt"),
            video_id, changelst)
        if res is None:
            print("warning: %s too short, skipped" % video_id)
            continue
        traj_rows, person_boxes, other_boxes, needed = res
        counts.append(len(needed))
        with open(os.path.join(
                traj_path, "%s.txt" % video_id), "w") as f:
            for fi, p, x, y in traj_rows:
                f.write("%d\t%.1f\t%.6f\t%.6f\n" % (fi, p, x, y))
        with open(os.path.join(
                person_path, "%s.p" % video_id), "wb") as f:
            pickle.dump(person_boxes, f)
        with open(os.path.join(
                other_path, "%s.p" % video_id), "wb") as f:
            pickle.dump(other_boxes, f)
    return counts


def resize_rotate_video(
    video_file: str,
    out_file: str,
) -> Tuple[str, bool]:
    """Rotate portrait videos 90° clockwise and rescale to 1920×1080
    (reference: resize_rotate_sdd.py — ffmpeg there, cv2 here).
    Returns ("WxH" original resolution, rotated)."""
    import cv2

    vcap = cv2.VideoCapture(video_file)
    if not vcap.isOpened():
        raise RuntimeError("cannot open %s" % video_file)
    w = int(vcap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(vcap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps = vcap.get(cv2.CAP_PROP_FPS) or 30.0
    rotated = h > w
    tw, th = (int(v) for v in TARGET_RESOLUTION)
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    writer = cv2.VideoWriter(
        out_file, cv2.VideoWriter_fourcc(*"mp4v"), fps, (tw, th))
    while True:
        ok, frame = vcap.read()
        if not ok:
            break
        if rotated:
            frame = cv2.rotate(frame, cv2.ROTATE_90_CLOCKWISE)
        writer.write(cv2.resize(frame, (tw, th)))
    writer.release()
    vcap.release()
    return "%dx%d" % (w, h), rotated


def write_sdd_fold_splits(
    video_ids: List[str],
    split_path: str,
    n_fold: int = 5,
    seed: Optional[int] = 2020,
) -> None:
    """n-fold cross-validation split lists: per fold, one fold tests,
    one validates, the rest train (reference:
    SimAug/code/get_sdd_splits.py — seeded here for reproducibility
    where the reference shuffles unseeded)."""
    videos = list(video_ids)
    rng = np.random.RandomState(seed)
    rng.shuffle(videos)
    folds = [videos[i::n_fold] for i in range(n_fold)]

    for i, test_fold in enumerate(folds):
        target = os.path.join(split_path, "fold_%d" % (i + 1))
        os.makedirs(target, exist_ok=True)
        val_fold: List[str] = []
        train_fold: List[str] = []
        for j in range(n_fold):
            if j == i:
                continue
            if not val_fold:
                val_fold = folds[j]
            else:
                train_fold += folds[j]
        for name, fold in (("test", test_fold), ("val", val_fold),
                           ("train", train_fold)):
            with open(os.path.join(target, "%s.lst" % name), "w") as f:
                f.write("\n".join(fold) + ("\n" if fold else ""))


def get_new_hw(h: float, w: float, size: int,
               max_size: int) -> Tuple[int, int]:
    """Detection-style resize: min side to `size`, capped so the max
    side stays under `max_size` (reference:
    SimAug/code/get_frames_sdd.py:32-45; returns (new_w, new_h))."""
    scale = size * 1.0 / min(h, w)
    if h < w:
        newh, neww = size, scale * w
    else:
        newh, neww = scale * h, size
    if max(newh, neww) > max_size:
        scale = max_size * 1.0 / max(newh, neww)
        newh *= scale
        neww *= scale
    return int(neww + 0.5), int(newh + 0.5)


def extract_needed_frames(
    video_file: str,
    frame_idxs: List[int],
    out_path: str,
    videoname: str,
    resize: bool = False,
    size: int = 800,
    maxsize: int = 1333,
) -> Tuple[int, dict]:
    """Dump the sampled frames as jpgs, optionally min/max-side
    resized; returns (frames written, the per-video stats record the
    reference's --statspath pickles)
    (reference: get_frames_sdd.py:100-168)."""
    import cv2

    os.makedirs(out_path, exist_ok=True)
    wanted = set(frame_idxs)
    vcap = cv2.VideoCapture(video_file)
    stats = {
        "h": vcap.get(cv2.CAP_PROP_FRAME_HEIGHT),
        "w": vcap.get(cv2.CAP_PROP_FRAME_WIDTH),
        "fps": vcap.get(cv2.CAP_PROP_FPS),
        "frame_count": vcap.get(cv2.CAP_PROP_FRAME_COUNT),
        "actual_frame_count": None,
    }
    idx = saved = 0
    # bounded by the metadata frame count, warn-and-continue on failed
    # reads — one corrupt frame must not drop every later needed frame
    # (reference: get_frames_sdd.py:131-140)
    total = int(stats["frame_count"])
    while idx < total:
        ok, frame = vcap.read()
        if not ok:
            print("warning, %s frame of %s failed" % (idx, videoname))
            idx += 1
            continue
        if idx in wanted:
            if resize:
                # reference: get_new_hw takes (shape[0], shape[1]) —
                # reproduced as-is
                neww, newh = get_new_hw(
                    frame.shape[0], frame.shape[1], size, maxsize)
                frame = cv2.resize(frame, (neww, newh),
                                   interpolation=cv2.INTER_LINEAR)
            cv2.imwrite(os.path.join(
                out_path, "%s_F_%08d.jpg" % (videoname, idx)), frame)
            saved += 1
        idx += 1
    vcap.release()
    stats["actual_frame_count"] = saved
    return saved, stats
