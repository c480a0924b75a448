"""Moment records: real-world trajectories → simulation scenarios, and
annotation merging.

The port's copy of ``multiverse_tpu/forking_paths/moments.py`` (host
numpy; ``yaml`` is imported inside ``load_virat_yaml`` only, as
there, so the module imports where PyYAML is missing).

reference: forking_paths_dataset/code/combine_traj.py (pixel → world
ground plane via per-scene homographies, with the 0002 resolution fix
and the x-mirror), gen_moment_from_annotation.py (merge per-annotator
control JSONs into final recordable moments), get_vehicle_traj.py
(VIRAT YAML box annotations → vehicle trajectories).

A *moment* JSON record is
    {"scenename", "original_start_frame_id", "ped_controls",
     "vehicle_controls", "x_agents", ...}
with controls in the schema of
:mod:`multiverse_torch.forking_paths.controls`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from multiverse_torch.forking_paths.controls import interpolate_controls

ACTEV_SCENE2IMGSIZE = {
    "0002": (1280.0, 720.0),
    "0000": (1920.0, 1080.0),
    "0400": (1920.0, 1080.0),
    "0401": (1920.0, 1080.0),
    "0500": (1920.0, 1080.0),
}


def get_scene(videoname: str) -> str:
    """ActEV scene token (reference: combine_traj.py:34-39)."""
    return videoname.split("_S_")[-1].split("_")[0][:4]


def make_moment_id(scene: str, moment_idx: int, x_agent_pid: int,
                   dest_idx: int, annotator_id: str) -> str:
    """`scene_momentIdx_pid_destIdx_annotator` naming used throughout
    the dataset (reference: utils.py `make_moment_id`)."""
    return "%s_%s_%s_%s_%s" % (
        scene, moment_idx, x_agent_pid, dest_idx, annotator_id)


def pixel_to_world_ground(
    xy: np.ndarray, homography: np.ndarray, scene: str,
    mirror_x: bool = True,
) -> np.ndarray:
    """Image points [N, 2] → ground-plane world [N, 2].

    Includes the 0002 resolution rescale (trajectories are stored in
    1920×1080 but scene 0002's homography was calibrated at 1280×720)
    and the ActEV x-mirror (reference: combine_traj.py:104-113).
    """
    xy = np.asarray(xy, np.float64).copy()
    if scene == "0002":
        w, h = ACTEV_SCENE2IMGSIZE[scene]
        xy[:, 0] *= w / 1920.0
        xy[:, 1] *= h / 1080.0
    hom = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    world = (homography @ hom.T).T                      # [N, 3]
    out = world[:, :2] / world[:, 2:3]
    if mirror_x:
        out[:, 0] = -out[:, 0]
    return out


def load_homographies(h_path: str) -> Dict[str, np.ndarray]:
    """Per-scene comma-separated 3×3 matrices
    (reference: combine_traj.py:64-75)."""
    import glob

    out = {}
    for h_file in glob.glob(os.path.join(h_path, "*.txt")):
        scene = os.path.splitext(os.path.basename(h_file))[0]
        rows = [line.strip().split(",") for line in open(h_file)]
        out[scene] = np.asarray(rows, np.float64)
    return out


def combine_split_trajectories(
    split_path: str,
    reverse_xy: bool = False,
    homographies: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[Dict[str, list], Dict[str, list], Dict[str, list]]:
    """Merge per-split trajectory TSVs back per video; optionally also
    produce world-plane trajectories (reference: combine_traj.py main).

    Returns (per-video pixel rows, per-video world rows, per-video
    sorted frame ids)."""
    import glob

    all_trajs: Dict[str, list] = {}
    all_world: Dict[str, list] = {}
    all_frames: Dict[str, dict] = {}
    for split in ("train", "val", "test"):
        for traj_file in glob.glob(
                os.path.join(split_path, split, "*.txt")):
            videoname = os.path.splitext(os.path.basename(traj_file))[0]
            rows = []
            for line in open(traj_file):
                parts = line.strip().split("\t")
                if reverse_xy:
                    fi, pid, y, x = parts
                else:
                    fi, pid, x, y = parts
                rows.append([float(fi), float(pid), float(x), float(y)])
            all_trajs.setdefault(videoname, []).extend(rows)
            all_frames.setdefault(videoname, {}).update(
                {r[0]: 1 for r in rows})
            if homographies is not None:
                scene = get_scene(videoname)
                world = pixel_to_world_ground(
                    np.asarray(rows, np.float64)[:, 2:],
                    homographies[scene], scene)
                all_world.setdefault(videoname, []).extend(
                    [[r[0], r[1], w[0], w[1]]
                     for r, w in zip(rows, world)])
    for videoname in all_trajs:
        all_trajs[videoname].sort(key=lambda r: r[0])
    for videoname in all_world:
        all_world[videoname].sort(key=lambda r: r[0])
    frames = {v: sorted(d) for v, d in all_frames.items()}
    return all_trajs, all_world, frames


# ------------------------------------------------- annotation merging


def merge_annotation_into_moment(
    moment: dict,
    annotation: List[list],
    x_agent_pid: int,
    video_fps: float,
) -> dict:
    """Replace the x-agent's future controls with a human annotation.

    reference: gen_moment_from_annotation.py:70-155 — controls before
    the annotation's first frame are kept verbatim; from there on the
    x-agent's records are replaced by the annotated
    (direction, speed, location) samples while other agents' records
    are preserved; everything past the annotation's last frame is
    dropped; vehicle controls are interpolated to video fps and
    truncated to the same horizon.

    Args:
        annotation: [[frame_id, direction_xyz, speed, location_xyz]].
    Returns a new moment dict (the input is not mutated).
    """
    anno_by_frame = {
        int(frame_id): (direction, speed, location)
        for frame_id, direction, speed, location in annotation
    }
    first_f = int(annotation[0][0])
    last_f = int(annotation[-1][0])

    ped_controls = {
        int(float(k)): v for k, v in moment["ped_controls"].items()}
    new_ped: Dict[int, list] = {}
    for frame_id in range(0, last_f + 1):
        if frame_id < first_f:
            if frame_id in ped_controls:
                new_ped[frame_id] = ped_controls[frame_id]
            continue
        records = [rec for rec in ped_controls.get(frame_id, [])
                   if rec[0] != x_agent_pid]
        if frame_id in anno_by_frame:
            direction, speed, location = anno_by_frame[frame_id]
            records.append([x_agent_pid, -1, location, direction, speed,
                            1.0 / video_fps, False])
        if records:
            new_ped[frame_id] = records

    vehicle = interpolate_controls(
        moment.get("vehicle_controls", {}), video_fps)
    new_vehicle = {
        int(k): v for k, v in vehicle.items() if int(k) <= last_f}

    out = dict(moment)
    out["ped_controls"] = {str(k): v for k, v in new_ped.items()}
    out["vehicle_controls"] = {str(k): v for k, v in new_vehicle.items()}
    return out


def build_final_moments(
    moment_data: List[dict],
    annotations: Dict[Tuple[str, str], list],
    video_fps: float = 30.0,
) -> List[dict]:
    """All (traj_key, annotator) annotations → final recordable moments
    (reference: gen_moment_from_annotation.py main loop).

    traj_key format: `scene_momentIdx_xAgentPid_destIdx`."""
    keyed = sorted(
        annotations.items(),
        key=lambda kv: int(kv[0][0].split("_")[1]))
    out = []
    for (traj_key, annotator_id), annotation in keyed:
        _, moment_idx, x_agent_pid, dest_idx = traj_key.split("_")
        moment = moment_data[int(moment_idx)]
        scene = moment["scenename"]
        merged = merge_annotation_into_moment(
            moment, annotation, int(x_agent_pid), video_fps)
        merged["moment_id"] = make_moment_id(
            scene, int(moment_idx), int(x_agent_pid), int(dest_idx),
            annotator_id)
        out.append(merged)
    return out


# ------------------------------------------------- VIRAT vehicle trajs


def load_virat_yaml(yml_file: str) -> list:
    """ActEV YAML minus the meta prefix
    (reference: get_vehicle_traj.py:37-49)."""
    import yaml

    with open(yml_file) as f:
        data = yaml.load(f, Loader=yaml.FullLoader)
    for i, item in enumerate(data):
        if "meta" not in item:
            return data[i:]
    raise ValueError("no non-meta entries in %s" % yml_file)


def load_virat_types(track_file: str,
                     only: Optional[str] = None) -> Dict[int, str]:
    """Track id → object type (reference: get_vehicle_traj.py:52-67)."""
    out: Dict[int, str] = {}
    for item in load_virat_yaml(track_file):
        t = item["types"]
        obj = t.get("obj_type") or list(t["cset3"].keys())[0]
        if only is not None and obj != only:
            continue
        out[int(t["id1"])] = obj
    return out


def _box_valid(bbox: list, imgsize: Tuple[float, float]) -> bool:
    """Positive area, inside the frame from above (the reference never
    rejects negative coordinates — reference:
    get_vehicle_traj.py:111-119 `valid_box`)."""
    w, h = imgsize
    x1, y1, x2, y2 = bbox
    if (x2 - x1) * (y2 - y1) <= 0:
        return False
    return not (x1 > w or x2 > w or y1 > h or y2 > h)


def _box_repair(bbox: list, imgsize: Tuple[float, float]) -> list:
    """Reorder swapped corners and clip to the frame from above
    (reference: get_vehicle_traj.py:102-109 `modify_box` — "actev boxes
    may contain some errors")."""
    w, h = imgsize
    x1, y1, x2, y2 = bbox
    return [min(w, min(x1, x2)), min(h, min(y1, y2)),
            min(w, max(x1, x2)), min(h, max(y1, y2))]


def load_virat_boxes(box_file: str,
                     imgsize: Tuple[float, float]) -> list:
    """(track_id, frame_idx, [x1, y1, x2, y2]) truth rows; invalid
    boxes repaired like the reference
    (reference: get_vehicle_traj.py:70-93)."""
    out = []
    for item in load_virat_yaml(box_file):
        g = item["geom"]
        assert g["src"] == "truth", (g["src"], g)
        bbox = [float(a) for a in g["g0"].split()]
        if not _box_valid(bbox, imgsize):
            bbox = _box_repair(bbox, imgsize)
            assert _box_valid(bbox, imgsize), (bbox, imgsize)
        out.append((int(g["id1"]), int(g["ts0"]), bbox))
    return out


def vehicle_trajectories(
    box_rows: list,
    vehicle_ids: Iterable[int],
    homography: np.ndarray,
    scene: str,
    frame_ids: Optional[Iterable[int]] = None,
) -> Tuple[list, list]:
    """Vehicle boxes → (pixel_rows, world_rows), each
    `[frame_idx, track_id, x, y]` sorted by frame.

    Reference semantics (get_vehicle_traj.py:195-222): the point is the
    box CENTER; the world point is that center through the scene
    homography in the box file's own resolution (no rescale — the 0002
    homography was calibrated at the YAML's native 1280×720) with the
    ActEV x-mirror; the PIXEL point for scene 0002 is upscaled ×1.5 on
    both axes to the 1920×1080 space the released videos use.
    """
    wanted = set(vehicle_ids)
    frames = None if frame_ids is None else set(frame_ids)
    pixel_rows: list = []
    world_rows: list = []
    for tid, frame_idx, (x1, y1, x2, y2) in box_rows:
        if tid not in wanted:
            continue
        if frames is not None and frame_idx not in frames:
            continue
        cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        wvec = homography @ np.asarray([cx, cy, 1.0])
        wx, wy = wvec[0] / wvec[2], wvec[1] / wvec[2]
        if scene == "0002":
            # the reference scales BOTH axes by 1920/1280 (== 1.5 ==
            # 1080/720, so the quirk is benign)
            cx, cy = cx * (1920 / 1280.0), cy * (1920 / 1280.0)
        pixel_rows.append([frame_idx, tid, float(cx), float(cy)])
        world_rows.append([frame_idx, tid, float(-wx), float(wy)])
    pixel_rows.sort(key=lambda r: r[0])
    world_rows.sort(key=lambda r: r[0])
    return pixel_rows, world_rows


# ---------------------------------------------- world → CARLA placing

# per-scene world-coordinate extents, computed from the ActEV ground
# planes (reference: plot_traj_carla.py:79-96 `actev_norm`, produced by
# compute_actev_world_norm.py — dataset constants)
ACTEV_WORLD_NORM = {
    "0400": {"x": (-113.339996, 15.906000), "y": (-51.101002, 82.049004)},
    "0401": {"x": (-76.031998, 28.722000), "y": (-3.993000, 90.141998)},
    "0000": {"x": (-7.510000, 48.320000), "y": (-7.984000, 14.305000)},
    "0002": {"x": (-38.488998, 67.762001), "y": (-29.208000, 128.421005)},
    "0500": {"x": (-25.212000, -0.499000), "y": (-25.396999, 35.426998)},
}


# hand-calibrated ground-plane placements of each real scene into its
# CARLA map (dataset constants; reference:
# batch_plot_traj_carla.py:22-55 `calibrations` / `calibration`)
GROUND_CALIBRATIONS = {
    "0000": {"world_rotate": 320.0, "carla_rotate": 130.0,
             "scale": 1.0, "origin": (3.5, -48.0, 0.3)},
    "0400": {"world_rotate": 100.0, "carla_rotate": 153.0,
             "scale": 1.0, "origin": (-10.0, 58.0, 0.5)},
    "0401": {"world_rotate": 120.0, "carla_rotate": 135.0,
             "scale": 1.0, "origin": (-48.0, 24.0, 0.5)},
    "0500": {"world_rotate": 90.0, "carla_rotate": 179.0,
             "scale": 1.0, "origin": (-65.5, -75.5, 0.1)},
}
ETHUCY_GROUND_CALIBRATION = {
    "world_rotate": 270.0, "carla_rotate": -3.04, "scale": 1.2,
    "origin": (-44.0511921243, -79.6225002047, 0.0),
}


def rotate_xy(rows: np.ndarray, origin: Tuple[float, float],
              radians: float) -> np.ndarray:
    """Rotate trajectory rows' (x, y) columns about an origin
    (reference: plot_traj_carla.py `rotate`)."""
    out = np.asarray(rows, np.float64).copy()
    ox, oy = origin
    x, y = out[:, 2] - ox, out[:, 3] - oy
    c, s = np.cos(radians), np.sin(radians)
    out[:, 2] = ox + c * x - s * y
    out[:, 3] = oy + s * x + c * y
    return out


def world_to_carla(
    rows: np.ndarray,
    scene: str,
    origin_xyz: Tuple[float, float, float],
    carla_rotation_deg: float,
    scale: float = 1.0,
    world_rotate_deg: float = 0.0,
) -> np.ndarray:
    """Ground-plane world trajectories → CARLA map coordinates.

    The placement recipe of reference: plot_traj_carla.py:100-130 —
    optional pre-rotation, translate the scene's world extent to the
    origin, metric rescale, rotate into the CARLA map frame, then
    translate to the calibrated map anchor.  Returns rows with (x, y)
    replaced and a z column set to origin z."""
    out = np.asarray(rows, np.float64).copy()
    if world_rotate_deg:
        out = rotate_xy(out, (0.0, 0.0), np.radians(world_rotate_deg))
    if scene is None:
        # ETH/UCY path: no precomputed extent table — normalize by the
        # (rotated) trajectory's own minimum
        # (reference: plot_traj_carla.py non-actev branch)
        min_x = float(out[:, 2].min())
        min_y = float(out[:, 3].min())
    else:
        # named scenes must be in the table: a typo'd ActEV key would
        # otherwise silently produce wrongly placed coordinates
        (min_x, _), (min_y, _) = (ACTEV_WORLD_NORM[scene]["x"],
                                  ACTEV_WORLD_NORM[scene]["y"])
    out[:, 2] = (out[:, 2] - min_x) * scale
    out[:, 3] = (out[:, 3] - min_y) * scale
    out = rotate_xy(out, (0.0, 0.0), np.radians(carla_rotation_deg))
    out[:, 2] += origin_xyz[0]
    out[:, 3] += origin_xyz[1]
    if out.shape[1] > 4:
        out[:, 4] = origin_xyz[2]
    return out


def save_moment_json(moments: List[dict], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(moments, f)
