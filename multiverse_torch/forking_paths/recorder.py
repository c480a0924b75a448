"""Dataset renderer: replay moments in CARLA, record 4 camera views
(RGB + semantic segmentation) with per-frame 2D boxes.

The port's copy of ``multiverse_tpu/forking_paths/recorder.py``
(``cv2`` and ``carla`` are imported inside the functions that need
them, as there; the same bbox JSONs and video frames).

reference: forking_paths_dataset/code/record_annotation.py — the
synchronous-mode loop (fixed_delta_seconds = 1/fps, :218-221), the
camera sensor setup (gamma 1.6, motion blur off, :114-152), per-frame
2D boxes from 8-corner projection (:313-339), and the
frames → MP4 + bbox JSON outputs (:354-381).  Differences: video
encoding uses cv2.VideoWriter instead of an ffmpeg subprocess (the
bare image has no ffmpeg), and box projection reuses the pure-numpy
camera module instead of per-actor matrix code.

Requires the `carla` package + a running CARLA 0.9.6 server.
"""

from __future__ import annotations

import json
import os
import queue
from typing import Dict, List, Optional

import numpy as np

from multiverse_torch.forking_paths.camera import (
    CameraRig,
    Transform,
    project_3d_box,
    to_2d_bbox,
)
from multiverse_torch.forking_paths.scenes import (
    SceneConfig,
    apply_weather,
    spawn_static_cars,
)
from multiverse_torch.forking_paths.sim import (
    CarlaAdapter,
    SimState,
    plan_frame,
)


def _camera_blueprint(world, kind: str, rig: CameraRig):
    """RGB / seg sensor blueprint (reference:
    record_annotation.py:114-152): gamma 1.6, no motion blur."""
    bp_name = ("sensor.camera.rgb" if kind == "rgb"
               else "sensor.camera.semantic_segmentation")
    bp = world.get_blueprint_library().find(bp_name)
    bp.set_attribute("image_size_x", str(rig.width))
    bp.set_attribute("image_size_y", str(rig.height))
    bp.set_attribute("fov", str(rig.fov))
    if kind == "rgb":
        bp.set_attribute("gamma", "1.6")
        bp.set_attribute("motion_blur_intensity", "0.0")
    return bp


class SensorQueue:
    """Collects sensor frames in tick order (the reference serializes
    callbacks through synchronous mode, record_annotation.py:103-112).
    """

    def __init__(self, sensor):
        self.q: "queue.Queue" = queue.Queue()
        sensor.listen(self.q.put)

    def get(self, frame: int, timeout: float = 10.0):
        while True:
            data = self.q.get(timeout=timeout)
            if data.frame >= frame:
                return data


def image_to_rgb(image) -> np.ndarray:
    arr = np.frombuffer(image.raw_data, np.uint8).reshape(
        image.height, image.width, 4)
    return arr[:, :, 2::-1]  # BGRA -> RGB


def seg_to_cityscapes(raw_rgb: np.ndarray) -> np.ndarray:
    """Raw semantic-seg sensor frame → CityScapes palette colors.

    CARLA's raw seg image stores the class id in the RED channel; the
    reference saves seg videos through
    carla.ColorConverter.CityScapesPalette
    (reference: record_annotation.py:148-151), and the downstream
    decoder (prepared_data.seg_rgb_to_carla_ids) matches palette
    colors — raw frames would decode to all-background.  Ids outside
    the 0.9.6 palette map to 0 (unlabeled)."""
    from multiverse_torch.forking_paths.prepared_data import CARLA_PALETTE

    ids = raw_rgb[:, :, 0].astype(np.int32)
    ids = np.where(ids < len(CARLA_PALETTE), ids, 0)
    return CARLA_PALETTE[ids].astype(np.uint8)


def actor_2d_boxes(adapter: CarlaAdapter,
                   rig: CameraRig) -> List[dict]:
    """All live actors' clipped 2D boxes in one camera
    (reference: record_annotation.py:313-339)."""
    boxes = []
    for actor_id, actor in adapter.actors.items():
        kind, track_id = adapter.actorid2info[actor.id]
        ext = actor.bounding_box.extent
        loc = actor.bounding_box.location
        corners = project_3d_box(
            (ext.x, ext.y, ext.z),
            Transform.from_carla(actor.get_transform()),
            rig,
            center_offset=(loc.x, loc.y, loc.z))
        bb = to_2d_bbox(corners, rig.width, rig.height)
        if bb is None:
            continue
        boxes.append({
            "class_name": kind,
            "track_id": track_id,
            "bbox": bb,
            "is_x_agent": 0,
        })
    return boxes


def encode_video(frames: List[np.ndarray], out_file: str,
                 fps: float) -> None:
    """MP4 encode (replaces the reference's ffmpeg subprocess,
    record_annotation.py:354-371)."""
    import cv2

    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(
        out_file, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def record_moment(
    client,
    scene: SceneConfig,
    rigs: List[CameraRig],
    ped_controls: Dict[str, list],
    vehicle_controls: Dict[str, list],
    total_frames: int,
    out_path: str,
    moment_name: str,
    x_agent_pid: Optional[float] = None,
    max_yaw_change: float = 60.0,
    start_offset: int = 0,
    cam_num_offset: int = 0,
    weather_override=None,
) -> Dict[str, str]:
    """Render one moment from every camera; writes
    `<out>/videos/<moment>_cam<k>.mp4`, matching `_seg.mp4`, and
    `<out>/bbox/<moment>_cam<k>.json`
    (reference: record_annotation.py:203-381).

    start_offset: simulate but do not record the first N frames — the
        recorded frame ids are rebased by -N so downstream contracts
        are unchanged (reference: record_annotation.py:57,308-333;
        the published dataset was recorded with its default 10-frame
        warm-up lead-in).
    cam_num_offset: added to the 1-based camera index in output names
        (reference: record_annotation.py:66,358-380 — used to merge
        recordings from different view sets into one dataset).
    weather_override: a Weather to use instead of the scene's own
        (reference --use_alter_weather / utils.py:71 realism_weather).
    """
    import carla

    if start_offset >= total_frames:
        # fail before the simulation, not in encode_video afterwards:
        # a warm-up longer than the moment records zero frames
        raise ValueError(
            "start_offset %d >= total_frames %d for moment %r: the "
            "warm-up lead-in would skip every frame"
            % (start_offset, total_frames, moment_name))

    world = client.get_world()
    settings = world.get_settings()
    settings.synchronous_mode = True
    settings.fixed_delta_seconds = 1.0 / scene.fps
    world.apply_settings(settings)
    apply_weather(world, weather_override or scene.weather)

    actor_list: list = []
    spawn_static_cars(world, client, scene, actor_list)

    bp_lib = world.get_blueprint_library()
    walker_bps = (bp_lib.filter("walker.pedestrian.*"), [0])
    vehicle_bps = (bp_lib.filter("vehicle.*"), [0])
    adapter = CarlaAdapter(world, client, walker_bps, vehicle_bps)
    state = SimState()

    cam_actors, seg_actors, cam_queues, seg_queues = [], [], [], []
    for rig in rigs:
        transform = carla.Transform(
            location=carla.Location(
                rig.transform.x, rig.transform.y, rig.transform.z),
            rotation=carla.Rotation(
                pitch=rig.transform.pitch, yaw=rig.transform.yaw,
                roll=rig.transform.roll))
        cam = world.spawn_actor(
            _camera_blueprint(world, "rgb", rig), transform)
        seg = world.spawn_actor(
            _camera_blueprint(world, "seg", rig), transform)
        cam_actors.append(cam)
        seg_actors.append(seg)
        cam_queues.append(SensorQueue(cam))
        seg_queues.append(SensorQueue(seg))
        adapter.global_actor_list += [cam, seg]

    frames_rgb: List[List[np.ndarray]] = [[] for _ in rigs]
    frames_seg: List[List[np.ndarray]] = [[] for _ in rigs]
    boxes: List[List[dict]] = [[] for _ in rigs]

    try:
        for frame_id in range(total_frames):
            cmds = plan_frame(frame_id, ped_controls, vehicle_controls,
                              state, max_yaw_change=max_yaw_change)
            adapter.execute(cmds, state)
            tick_frame = world.tick()
            if frame_id < start_offset:
                # warm-up lead-in: simulated, never recorded
                # (reference: record_annotation.py:308-310)
                continue
            for k, rig in enumerate(rigs):
                frames_rgb[k].append(
                    image_to_rgb(cam_queues[k].get(tick_frame)))
                frames_seg[k].append(seg_to_cityscapes(
                    image_to_rgb(seg_queues[k].get(tick_frame))))
                for box in actor_2d_boxes(adapter, rig):
                    box = dict(box, frame_id=frame_id - start_offset)
                    if x_agent_pid is not None \
                            and box["track_id"] == x_agent_pid:
                        box["is_x_agent"] = 1
                    boxes[k].append(box)
    finally:
        adapter.cleanup()
        settings.synchronous_mode = False
        settings.fixed_delta_seconds = None
        world.apply_settings(settings)

    outputs = {}
    for k in range(len(rigs)):
        name = "%s_cam%d" % (moment_name, k + 1 + cam_num_offset)
        video = os.path.join(out_path, "videos", "%s.mp4" % name)
        seg_video = os.path.join(
            out_path, "videos_seg", "%s.mp4" % name)
        bbox_file = os.path.join(out_path, "bbox", "%s.json" % name)
        encode_video(frames_rgb[k], video, scene.fps)
        encode_video(frames_seg[k], seg_video, scene.fps)
        os.makedirs(os.path.dirname(bbox_file), exist_ok=True)
        with open(bbox_file, "w") as f:
            json.dump(boxes[k], f)
        outputs[name] = video
    return outputs
