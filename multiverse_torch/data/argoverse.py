"""Argoverse tracking-dataset preparation: 3D cuboid labels → 2D
person boxes in the ring-front-center camera.

The port's copy of ``multiverse_tpu/data/argoverse.py``: the same
geometry (scipy's quaternion rotation) and the same files.

reference: SimAug/code/get_prepared_data_argoverse.py — quaternion
cuboid pose → 8 corners in the egovehicle frame → camera frame via the
SE3 extrinsic → pinhole projection (skew included for u, depth sign
preserved) → clipped 2D box, with the 1920×1200 frame cropped to
1920×1080 and 30 fps dropped to 2.5 fps.

The projection math is vectorized (the reference loops per corner);
the dataset walker accepts any directory layout that provides
`vehicle_calibration_info.json` + per-frame cuboid label jsons, so the
argoverse-api package is not required.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
from scipy.spatial.transform import Rotation

IMG_WIDTH = 1920.0
IMG_HEIGHT = 1200.0
CLIP_HEIGHT = 120.0   # 1920×1200 → 1920×1080 crop
DROP_FRAME = 12


def quat_wxyz_to_rotmat(q) -> np.ndarray:
    """(w, x, y, z) unit quaternion → 3×3 rotation
    (reference: get_prepared_data_argoverse.py:153-157)."""
    q = np.asarray(q, np.float64)
    if not np.isclose(np.linalg.norm(q), 1.0, atol=1e-9):
        raise ValueError("quaternion must be unit-norm")
    w, x, y, z = q
    return Rotation.from_quat([x, y, z, w]).as_matrix()


def se3(rotation: np.ndarray, translation: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = rotation
    m[:3, 3] = translation
    return m


@dataclasses.dataclass(frozen=True)
class ArgoverseCamera:
    """ring_front_center calibration
    (reference: get_prepared_data_argoverse.py:189-224)."""

    extrinsic: np.ndarray    # [4, 4] egovehicle → camera
    intrinsic: np.ndarray    # [3, 4]
    img_width: float = IMG_WIDTH
    img_height: float = IMG_HEIGHT

    @classmethod
    def from_calibration(cls, camera_config: dict,
                         camera_key: str = "image_raw_ring_front_center",
                         ) -> "ArgoverseCamera":
        value = None
        for cam in camera_config["camera_data_"]:
            if camera_key in cam["key"]:
                value = cam["value"]
                break
        if value is None:
            raise KeyError(camera_key)
        se3_cfg = value["vehicle_SE3_camera_"]
        t = np.asarray(se3_cfg["translation"], np.float64)
        rot = quat_wxyz_to_rotmat(se3_cfg["rotation"]["coefficients"])
        extrinsic = se3(rot.T, rot.T @ (-t))
        k = np.zeros((3, 4))
        k[0, 0] = value["focal_length_x_px_"]
        k[0, 1] = value["skew_"]
        k[0, 2] = value["focal_center_x_px_"]
        k[1, 1] = value["focal_length_y_px_"]
        k[1, 2] = value["focal_center_y_px_"]
        k[2, 2] = 1.0
        return cls(extrinsic=extrinsic, intrinsic=k)


def cuboid_corners(label: dict) -> np.ndarray:
    """Label {center, rotation, length, width, height} → [8, 3]
    egovehicle-frame corners
    (reference: get_prepared_data_argoverse.py:68-93)."""
    c = label["center"]
    t = np.array([c["x"], c["y"], c["z"]])
    r = label["rotation"]
    rot = quat_wxyz_to_rotmat([r["w"], r["x"], r["y"], r["z"]])
    sx = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float64)
    sy = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64)
    sz = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64)
    local = np.stack([
        label["length"] / 2 * sx,
        label["width"] / 2 * sy,
        label["height"] / 2 * sz,
    ], axis=1)
    return local @ rot.T + t


def project_to_image(points_cam: np.ndarray,
                     camera: ArgoverseCamera) -> np.ndarray:
    """Camera-frame [N, 3] → [N, 3] (u, v, depth); depth keeps its
    sign (reference: :119-151, vectorized)."""
    z = points_cam[:, 2]
    z_fixed = np.where(np.abs(z) <= 1e-4,
                       np.where(z < 0, -1e-4, 1e-4), z)
    px = points_cam[:, 0] / z_fixed
    py = points_cam[:, 1] / z_fixed
    k = camera.intrinsic
    u = k[0, 0] * px + k[0, 1] * py + k[0, 2]
    v = k[1, 1] * py + k[1, 2]
    return np.stack([u, v, z], axis=1)


def clip_2d_bbox(uvh: np.ndarray, max_w: float,
                 max_h: float) -> Optional[List[float]]:
    """[8, 3] → clipped [x1, y1, x2, y2] or None
    (reference: :165-187 — unlike the Forking Paths variant this also
    rejects boxes entirely left/above the frame)."""
    if not np.all(uvh[:, 2] > 0):
        return None
    x1 = round(float(uvh[:, 0].min()), 3)
    y1 = round(float(uvh[:, 1].min()), 3)
    x2 = round(float(uvh[:, 0].max()), 3)
    y2 = round(float(uvh[:, 1].max()), 3)
    if x1 > max_w or y1 > max_h or x2 < 0 or y2 < 0:
        return None
    return [max(x1, 0.0), max(y1, 0.0), min(x2, max_w), min(y2, max_h)]


def cuboid_to_2d_box(label: dict,
                     camera: ArgoverseCamera) -> Optional[List[float]]:
    """Full label → clipped 2D box (reference: :60-118)."""
    corners = cuboid_corners(label)
    hom = np.concatenate([corners, np.ones((8, 1))], axis=1)
    cam = (hom @ camera.extrinsic.T)[:, :3]
    return clip_2d_bbox(project_to_image(cam, camera),
                        camera.img_width, camera.img_height)


# CARLA/ADE-style class ids for the "other box" features
# (reference: get_prepared_data_argoverse.py:19-38; classes the
# reference comments out are likewise excluded)
CLASS2CLASSID = {
    "VEHICLE": 1,
    "PEDESTRIAN": 0,
    "ON_ROAD_OBSTACLE": 3,
    "LARGE_VEHICLE": 1,
    "BICYCLE": 8,
    "BICYCLIST": 8,
    "BUS": 1,
    "OTHER_MOVER": 3,
    "TRAILER": 1,
    "MOTORCYCLIST": 8,
    "MOPED": 8,
    "MOTORCYCLE": 8,
    "EMERGENCY_VEHICLE": 1,
    "SCHOOL_BUS": 1,
}


def crop_box_to_1080(bbox: List[float],
                     clip_height: float = CLIP_HEIGHT) -> List[float]:
    """Box shifted for the 1920×1200 frame losing its TOP `clip_height`
    rows (the reference crops `im[120:, :]`): y -= 120 with negatives
    clamped to 0, no other rejection
    (reference: get_prepared_data_argoverse.py:233-239 `clip_box`)."""
    x1, y1, x2, y2 = bbox
    y1 = max(y1 - clip_height, 0.0)
    y2 = max(y2 - clip_height, 0.0)
    return [x1, y1, x2, y2]


def prepare_argoverse_log(
    label_files: List[str],
    calibration_file: str,
    video_id: str,
    out_path: str,
    split: str = "test",
    drop_frame: int = DROP_FRAME,
    min_frames: int = 8 + 12,
) -> int:
    """One log → trajectory TSV + person/other-box pickles.

    Faithful to the reference main loop
    (reference: get_prepared_data_argoverse.py:243-389): fully-occluded
    labels are skipped (occlusion == 100), track uuids map to ids in
    FIRST-SEEN order (deterministic across runs), frames are the sorted
    pedestrian-bearing label frames subsampled by ``drop_frame`` (logs
    with fewer than ``min_frames`` such frames are skipped entirely),
    the trajectory point is the CENTER of the top-cropped box with
    points outside the 1920×1080 target resolution dropped, and the
    box pickles use the reference's ``video_frame_track`` keys (other
    boxes carry :data:`CLASS2CLASSID` class ids).
    Returns the number of trajectory rows written (0 = skipped).
    """
    import pickle

    with open(calibration_file) as f:
        camera = ArgoverseCamera.from_calibration(json.load(f))

    # pass 1: all labels -> (track_id, cropped box, frame, class)
    trackid_mapping: dict = {}
    anno_data = []
    for frame_idx, label_file in enumerate(sorted(label_files)):
        with open(label_file) as f:
            labels = json.load(f)
        for label in labels:
            classname = label.get("label_class")
            uuid = label.get("track_label_uuid", "0")
            if uuid not in trackid_mapping:
                trackid_mapping[uuid] = len(trackid_mapping)
            if label.get("occlusion", 0) == 100:
                continue
            bbox = cuboid_to_2d_box(label, camera)
            if bbox is None:  # behind the camera
                continue
            anno_data.append((trackid_mapping[uuid],
                              crop_box_to_1080(bbox),
                              frame_idx, classname))

    # pass 2: every drop_frame-th pedestrian-bearing frame
    ped_frames = sorted({f for _, _, f, c in anno_data
                         if c == "PEDESTRIAN"})
    needed = ped_frames[::drop_frame]
    if len(needed) < min_frames:  # not enough for one obs+pred window
        return 0
    frame_data: dict = {}
    for tid, bbox, frame_idx, classname in anno_data:
        if frame_idx not in needed or classname not in CLASS2CLASSID:
            continue
        frame_data.setdefault(frame_idx, []).append(
            (tid, bbox, classname))

    rows, person_boxes, other_boxes = [], {}, {}
    for frame_idx in needed:
        box_list = sorted(frame_data.get(frame_idx, []))
        for i, (tid, bbox, classname) in enumerate(box_list):
            if classname != "PEDESTRIAN":
                continue
            x = (bbox[0] + bbox[2]) / 2.0
            y = (bbox[1] + bbox[3]) / 2.0
            if x > IMG_WIDTH or y > IMG_HEIGHT - CLIP_HEIGHT:
                continue
            key = "%s_%d_%d" % (video_id, frame_idx, tid)
            rows.append((frame_idx, float(tid), x, y))
            person_boxes[key] = bbox
            other_boxes[key] = (
                [b for j, (_, b, _) in enumerate(box_list) if j != i],
                [CLASS2CLASSID[c]
                 for j, (_, _, c) in enumerate(box_list) if j != i])

    traj_path = os.path.join(out_path, "traj_2.5fps", split)
    person_path = os.path.join(out_path, "anno_person_box", split)
    other_path = os.path.join(out_path, "anno_other_box", split)
    for d in (traj_path, person_path, other_path):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(traj_path, "%s.txt" % video_id), "w") as f:
        for fi, p, x, y in rows:
            f.write("%d\t%.1f\t%.6f\t%.6f\n" % (fi, p, x, y))
    with open(os.path.join(
            person_path, "%s.p" % video_id), "wb") as f:
        pickle.dump(person_boxes, f)
    with open(os.path.join(
            other_path, "%s.p" % video_id), "wb") as f:
        pickle.dump(other_boxes, f)
    return len(rows)
