"""Moment candidate extraction + simulation validation.

The port's copy of ``multiverse_tpu/forking_paths/candidates.py``
(the same windows, records and replay loop).

reference: forking_paths_dataset/code/auto_moment_candidates.py —
slide a `moment_length`-second window over each video's control
records, replay each window in the simulator, and keep windows with no
walker spawn failure and no pedestrian collision.  The window slicing
and the success-record schema are pure (tested); the replay loop is
carla-gated and reuses the sim planner + adapter.

Also covers build_moment.py (replay one moment for debugging — the
same replay loop with a single pre-sliced moment).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

from multiverse_torch.forking_paths.sim import SimState, plan_frame

# per-scene vehicle ground heights for replayed vehicle trajectories
# (dataset constants; reference: utils.py:19-24 `vehicle_z`)
VEHICLE_Z = {"0000": 0.2, "0401": 0.0, "0400": 0.0, "0500": 0.0}


def moment_windows(
    ped_controls: Dict[str, list],
    moment_length_frames: float,
    test_skip: int = 1,
) -> Iterator[Tuple[int, int]]:
    """Yield (start_frame_id, total_frame_num) candidate windows
    (reference: auto_moment_candidates.py:133-147)."""
    frame_ids = sorted(int(float(k)) for k in ped_controls)
    for i in range(0, len(frame_ids), test_skip):
        start = frame_ids[i]
        end_idx = -1
        for j in range(i + 1, len(frame_ids)):
            if frame_ids[j] >= start + moment_length_frames:
                end_idx = j
                break
        total = int(frame_ids[end_idx] - start)
        if total <= 0:
            continue
        yield start, total


def slice_controls(
    controls: Dict[str, list],
    start_frame: int,
    total_frames: int,
) -> Dict[int, list]:
    """Window's controls rebased to frame 0
    (reference: auto_moment_candidates.py:211-221)."""
    by_frame = {int(float(k)): v for k, v in controls.items()}
    out: Dict[int, list] = {}
    for frame_id in range(total_frames):
        ori = frame_id + start_frame
        if ori in by_frame:
            out[frame_id] = by_frame[ori]
    return out


def make_moment_record(
    filename: str,
    scene: str,
    static_scene: dict,
    start_frame_id: int,
    ped_controls: Dict[int, list],
    vehicle_controls: Dict[int, list],
    vehicle_spawn_failed: bool = False,
) -> dict:
    """The moment JSON schema consumed downstream
    (reference: auto_moment_candidates.py:231-244)."""
    return {
        "filename": filename,
        "scenename": scene,
        "static_scene": static_scene,
        "original_start_frame_id": start_frame_id,
        "vehicle_spawn_failed": vehicle_spawn_failed,
        "ped_controls": ped_controls,
        "vehicle_controls": vehicle_controls,
        "x_agents": {},  # person_id -> destinations, filled by editor
    }


def replay_moment(
    client,
    world,
    walker_bps,
    vehicle_bps,
    ped_controls: Dict[str, list],
    vehicle_controls: Dict[str, list],
    start_frame: int,
    total_frames: int,
    max_yaw_change: float = 90.0,
) -> Tuple[bool, str, bool]:
    """Replay one window in CARLA; returns
    (success, fail_reason, vehicle_spawn_failed)
    (reference: auto_moment_candidates.py:149-206 / build_moment.py).
    """
    from multiverse_torch.forking_paths.sim import CarlaAdapter

    adapter = CarlaAdapter(
        world, client, walker_bps, vehicle_bps,
        exit_if_spawn_fail=True)
    state = SimState()
    try:
        for count in range(total_frames):
            if adapter.collision_history:
                return False, "Ped collision detected.", \
                    adapter.stats["vehicle_spawn_failed"]
            cmds = plan_frame(
                count + start_frame, ped_controls, vehicle_controls,
                state, max_yaw_change=max_yaw_change)
            if adapter.execute(cmds, state) is None:
                return False, "Ped spawn fails.", \
                    adapter.stats["vehicle_spawn_failed"]
            world.tick()
    finally:
        adapter.cleanup()
    return True, "", adapter.stats["vehicle_spawn_failed"]


def find_candidate_moments(
    client,
    traj_files: List[str],
    scene_registry,
    get_scene_fn,
    moment_length: float = 15.2,
    test_skip: int = 1,
    vehicle_traj_path: Optional[str] = None,
    vehicle_z: Optional[float] = None,
) -> Tuple[Dict[str, list], list]:
    """The full candidate sweep (carla-gated driver;
    reference: auto_moment_candidates.py main).  Returns
    (scene → success moment records, failure log).

    `vehicle_z=None` uses the reference's per-scene ground heights
    (`VEHICLE_Z`, reference: utils.py:19-24 `vehicle_z`); a float
    forces that value for every scene."""
    import dataclasses

    from multiverse_torch.forking_paths.controls import (
        load_traj_file,
        traj_to_controls,
    )
    from multiverse_torch.forking_paths.scenes import (
        apply_weather,
        spawn_static_cars,
    )

    success: Dict[str, list] = {}
    fails: list = []
    for traj_file in sorted(traj_files):
        filename = os.path.splitext(os.path.basename(traj_file))[0]
        scene = get_scene_fn(filename)
        static_scene = scene_registry.scenes[scene]
        world = client.load_world(static_scene.map)
        settings = world.get_settings()
        settings.synchronous_mode = True
        settings.fixed_delta_seconds = 1.0 / static_scene.fps
        world.apply_settings(settings)
        actor_list: list = []
        apply_weather(world, static_scene.weather)
        spawn_static_cars(world, client, static_scene, actor_list)
        world.tick()

        bp_lib = world.get_blueprint_library()
        walker_bps = (bp_lib.filter("walker.pedestrian.*"), [0])
        vehicle_bps = (bp_lib.filter("vehicle.*"), [0])

        ped_controls, _ = traj_to_controls(
            load_traj_file(traj_file), -1, -1, static_scene.fps,
            no_offset=True)
        vehicle_controls: Dict[str, list] = {}
        if vehicle_traj_path is not None:
            vf = os.path.join(vehicle_traj_path, "%s.txt" % filename)
            if os.path.exists(vf):
                z_to = (VEHICLE_Z.get(scene, 0.0)
                        if vehicle_z is None else vehicle_z)
                vehicle_controls, _ = traj_to_controls(
                    load_traj_file(vf), -1, -1, static_scene.fps,
                    z_to=z_to, no_offset=True)

        frames_per_moment = moment_length * static_scene.fps
        for start, total in moment_windows(
                ped_controls, frames_per_moment, test_skip):
            ok, reason, veh_fail = replay_moment(
                client, world, walker_bps, vehicle_bps,
                ped_controls, vehicle_controls, start, total)
            if not ok:
                fails.append((filename, start, reason))
                continue
            peds = slice_controls(ped_controls, start, total)
            vehs = slice_controls(vehicle_controls, start, total)
            if not peds and not vehs:
                fails.append((filename, start, "empty controls"))
                continue
            success.setdefault(scene, []).append(make_moment_record(
                filename, scene, dataclasses.asdict(static_scene),
                start, peds, vehs, veh_fail))
    return success, fails


def save_candidates(success: Dict[str, list], moment_path: str) -> None:
    os.makedirs(moment_path, exist_ok=True)
    for scene, moments in success.items():
        with open(os.path.join(
                moment_path, "%s.json" % scene), "w") as f:
            json.dump(moments, f)
