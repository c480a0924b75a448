"""Interactive CARLA tools: annotation game, free-fly spectator, and
the moment editor GUI.

The port's copy of ``multiverse_tpu/forking_paths/interactive.py``:
``mvt-torch-annotate``, ``mvt-torch-spectator`` and
``mvt-torch-moment-editor`` take the ``mvt-*`` commands' arguments and
write the same files. ``pygame``, ``carla`` and ``cv2`` are imported
inside functions only; each command stops as it starts, with an
``ImportError`` naming ``pygame``, where pygame does not import.

Thin pygame drivers over tested cores: the annotation session state
machine (annotation.py), the sim planner/adapter (sim.py), camera math
(camera.py), and the full moment-editor state machine (editor.py —
its module docstring carries the keybinding parity table vs reference
moment_editor.py:138-172).  A real CARLA 0.9.6 server is needed for
actual use, but every loop runs headlessly in CI against the in-memory
fake backend + SDL dummy videodriver (tests/test_torch_interactive.py),
bounded by `max_ticks`/`throttle` test hooks.

reference: forking_paths_dataset/code/annotate_carla.py (the
annotation game: replay the obs phase, hand the x-agent to the
annotator with WASD, restart on collision/timeout, save per-frame
controls), spectator.py (free-fly camera, click → 3D via the depth
sensor, Info HUD :404+, recording), moment_editor.py (scenario
editor/QA).

Keys (annotation): W/S forward/stop, A/D turn, ESC quit.
Keys (spectator): WASD+QE move, arrow keys rotate, click prints the
3D point under the cursor, P screenshot, R record, F1/H HUD, ESC quit.
Keys (editor): see editor.py's parity table.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional

import numpy as np

from multiverse_torch.cli.prepare_data import require_package
from multiverse_torch.forking_paths.annotation import (
    AnnotationSession,
    check_collision_with_actor,
    save_annotation,
)
from multiverse_torch.forking_paths.camera import (
    CameraRig,
    Transform,
    parse_carla_depth,
    pixel_to_world,
)
from multiverse_torch.forking_paths.sim import (
    CarlaAdapter,
    SimState,
    plan_frame,
)

WALK_SPEED = 1.4      # m/s handed to WalkerControl while annotating
TURN_DEG_PER_TICK = 4.0


def _advance(world) -> None:
    """One simulation step: drive sync worlds with tick(), otherwise
    wait for the server's own tick (reference spectator runs async)."""
    if world.get_settings().synchronous_mode:
        world.tick()
    elif hasattr(world, "wait_for_tick"):
        world.wait_for_tick()


def _pygame_surface(pygame, image) -> "pygame.Surface":
    arr = np.frombuffer(image.raw_data, np.uint8).reshape(
        image.height, image.width, 4)[:, :, 2::-1]
    return pygame.surfarray.make_surface(arr.swapaxes(0, 1))


def run_annotation_game(
    client,
    moment_data: List[dict],
    out_file: str,
    video_fps: float = 30.0,
    obs_length: int = 12,
    pred_length: int = 26,
    annotation_fps: float = 2.5,
    camera_rig: Optional[CameraRig] = None,
    throttle: bool = True,
    max_attempts: Optional[int] = None,
    start_idx: int = 0,
    job: int = 1,
    cur_job: int = 1,
) -> dict:
    """One annotator pass; writes the saved-annotation JSON and
    returns it (reference: annotate_carla.py main loop).

    start_idx / job / cur_job shard the task list across several
    annotator processes (reference: annotate_carla.py:74-77,330-332).
    """
    import carla
    import pygame

    frame_skip = int(video_fps / annotation_fps)
    obs_last = (obs_length - 1) * frame_skip
    max_frame = (obs_length + pred_length) * frame_skip

    session = AnnotationSession(
        moment_data, obs_last_frame=obs_last, max_frame=max_frame,
        start_idx=start_idx, job=job, cur_job=cur_job)

    pygame.init()
    rig = camera_rig or CameraRig(
        Transform(z=25.0, pitch=-60.0), 1280, 720, 110.0)
    display = pygame.display.set_mode((rig.width, rig.height))
    clock = pygame.time.Clock()

    world = client.get_world()
    settings = world.get_settings()
    settings.synchronous_mode = True
    settings.fixed_delta_seconds = 1.0 / video_fps
    world.apply_settings(settings)

    bp_lib = world.get_blueprint_library()
    cam_bp = bp_lib.find("sensor.camera.rgb")
    cam_bp.set_attribute("image_size_x", str(rig.width))
    cam_bp.set_attribute("image_size_y", str(rig.height))
    cam_bp.set_attribute("fov", str(rig.fov))

    try:
        while not session.done:
            moment_idx, x_pid, _ = session.current_task
            moment = moment_data[moment_idx]
            ped = moment["ped_controls"]
            veh = moment.get("vehicle_controls", {})
            adapter = CarlaAdapter(
                world, client,
                (bp_lib.filter("walker.pedestrian.*"), [0]),
                (bp_lib.filter("vehicle.*"), [0]))
            state = SimState()
            camera = world.spawn_actor(cam_bp, carla.Transform(
                location=carla.Location(
                    rig.transform.x, rig.transform.y, rig.transform.z),
                rotation=carla.Rotation(
                    pitch=rig.transform.pitch,
                    yaw=rig.transform.yaw,
                    roll=rig.transform.roll)))
            frames: list = []
            camera.listen(frames.append)
            yaw = 0.0
            frame_id = 0
            restart = False

            while not restart:
                if throttle:  # real-time pacing; off in headless tests
                    clock.tick_busy_loop(video_fps)
                for event in pygame.event.get():
                    if event.type == pygame.QUIT:
                        raise KeyboardInterrupt
                keys = pygame.key.get_pressed()
                if keys[pygame.K_ESCAPE]:
                    raise KeyboardInterrupt

                if session.in_obs_phase(frame_id):
                    cmds = plan_frame(frame_id, ped, veh, state)
                    adapter.execute(cmds, state)
                else:
                    # other agents keep replaying; annotator drives the
                    # x-agent (reference: annotate_carla.py:636-680)
                    cmds = plan_frame(frame_id, ped, veh, state,
                                      excepts=(float(x_pid), x_pid))
                    adapter.execute(cmds, state)
                    actor = adapter.actors.get(float(x_pid)) \
                        or adapter.actors.get(x_pid)
                    if actor is not None:
                        if keys[pygame.K_a]:
                            yaw -= TURN_DEG_PER_TICK
                        if keys[pygame.K_d]:
                            yaw += TURN_DEG_PER_TICK
                        speed = WALK_SPEED if keys[pygame.K_w] else 0.0
                        direction = [math.cos(math.radians(yaw)),
                                     math.sin(math.radians(yaw)), 0.0]
                        control = carla.WalkerControl()
                        control.direction = carla.Vector3D(*direction)
                        control.speed = speed
                        actor.apply_control(control)
                        loc = actor.get_location()
                        session.record(frame_id, direction, speed,
                                       [loc.x, loc.y, loc.z])
                        # scenery (static.*) grazes don't fail the
                        # attempt (reference: annotate_carla.py:361-367)
                        collided = check_collision_with_actor([
                            rec for rec in adapter.collision_history
                            if rec[1] in (float(x_pid), x_pid)])
                        result = session.step(
                            frame_id, [loc.x, loc.y, loc.z], collided)
                        if result != "continue":
                            restart = True

                world.tick()
                if frames:
                    display.blit(
                        _pygame_surface(pygame, frames[-1]), (0, 0))
                    pygame.display.flip()
                    del frames[:]
                frame_id += 1
                if not restart and frame_id > max_frame:
                    # timeout only if the attempt is still running —
                    # a reach/collision at exactly max_frame already
                    # resolved this attempt (and possibly advanced to
                    # the next task)
                    session.step(frame_id, [1e9, 1e9, 1e9])
                    restart = True
                if restart and max_attempts is not None \
                        and not session.done \
                        and session.fails >= max_attempts:
                    session.skip_task()

            camera.stop()
            camera.destroy()
            adapter.cleanup()
    except KeyboardInterrupt:
        pass
    finally:
        settings.synchronous_mode = False
        settings.fixed_delta_seconds = None
        world.apply_settings(settings)
        pygame.quit()
    save_annotation(session, out_file)
    return session.saved


def _save_seg_frame(image, save_seg_path: str, index: int,
                    seg_as_img: bool) -> None:
    """Save one semantic-segmentation sensor frame: CityScapes-palette
    png when seg_as_img (the reference's ColorConverter, for eyeballs),
    raw class-id png otherwise (what scene-feature extraction consumes;
    reference: spectator.py:46-47,345-350)."""
    import cv2

    from multiverse_torch.forking_paths.recorder import (
        image_to_rgb,
        seg_to_cityscapes,
    )

    rgb = image_to_rgb(image)
    out = seg_to_cityscapes(rgb) if seg_as_img else rgb
    cv2.imwrite(os.path.join(save_seg_path, "%06d.png" % index),
                out[:, :, ::-1])  # RGB -> BGR for cv2


def run_spectator(
    client,
    width: int = 1280,
    height: int = 720,
    fov: float = 90.0,
    screenshot_path: str = "spectator_shots",
    max_ticks: Optional[int] = None,
    start_pose: Optional[Transform] = None,
    save_seg_path: Optional[str] = None,
    save_bbox_json: Optional[str] = None,
    seg_as_img: bool = False,
) -> None:
    """Free-fly camera with click → 3D world point, Info HUD, and
    frame recording (reference: spectator.py:135-200 movement/click,
    :404+ Info HUD; recording = the reference's screenshot machinery
    extended to a toggle).

    Keys: WASD+QE move, arrows rotate, click prints the 3D point under
    the cursor, P screenshot, R toggle recording (frames saved under
    screenshot_path/rec_NNNN/), F1 or H toggle the HUD, ESC quit.
    `max_ticks` bounds the loop for headless tests.  `start_pose`
    starts the fly-camera at a preset (the reference's go_to_* camera
    presets, spectator.py:503-538).

    save_seg_path spawns a semantic-segmentation camera alongside and
    saves its frames while recording — CityScapes-palette pngs when
    seg_as_img, raw class-id pngs otherwise (reference:
    spectator.py:44-47,345-350; how the static scene-seg features of
    new camera views are captured).  save_bbox_json collects every
    recorded frame's projected walker/vehicle 2D boxes and writes one
    json at exit (reference: spectator.py:624-675,708-711).
    """
    import carla
    import pygame

    pygame.init()
    display = pygame.display.set_mode((width, height))
    clock = pygame.time.Clock()
    font = pygame.font.Font(None, 22)
    world = client.get_world()
    bp_lib = world.get_blueprint_library()

    pose = start_pose or Transform(z=30.0, pitch=-45.0)

    def spawn_cams(pose):
        t = carla.Transform(
            location=carla.Location(pose.x, pose.y, pose.z),
            rotation=carla.Rotation(
                pitch=pose.pitch, yaw=pose.yaw, roll=pose.roll))
        rgb_bp = bp_lib.find("sensor.camera.rgb")
        depth_bp = bp_lib.find("sensor.camera.depth")
        bps = [rgb_bp, depth_bp]
        if save_seg_path is not None:
            bps.append(bp_lib.find(
                "sensor.camera.semantic_segmentation"))
        for bp in bps:
            bp.set_attribute("image_size_x", str(width))
            bp.set_attribute("image_size_y", str(height))
            bp.set_attribute("fov", str(fov))
        return [world.spawn_actor(bp, t) for bp in bps]

    cams = spawn_cams(pose)
    rgb_cam, depth_cam = cams[0], cams[1]
    last = {"rgb": None, "depth": None, "seg": None}
    rgb_cam.listen(lambda im: last.__setitem__("rgb", im))
    depth_cam.listen(lambda im: last.__setitem__("depth", im))
    if save_seg_path is not None:
        cams[2].listen(lambda im: last.__setitem__("seg", im))
        os.makedirs(save_seg_path, exist_ok=True)
    bbox_data: dict = {}  # frame index -> [{bbox, class_name, track_id}]
    shot = 0
    show_hud = True
    recording = None  # None or (dir, next_frame_index)

    def world_actor_boxes():
        """Projected 2D boxes of every walker/vehicle in the world
        from the current pose (reference: spectator.py:648-661)."""
        from multiverse_torch.forking_paths.camera import (
            project_3d_box,
            to_2d_bbox,
        )

        rig = CameraRig(pose, width, height, fov)
        boxes = []
        for actor in world.get_actors():
            if actor.type_id.startswith("walker."):
                class_name = "Person"
            elif actor.type_id.startswith("vehicle."):
                class_name = "Vehicle"
            else:
                continue
            ext = actor.bounding_box.extent
            loc = actor.bounding_box.location
            corners = project_3d_box(
                (ext.x, ext.y, ext.z),
                Transform.from_carla(actor.get_transform()), rig,
                center_offset=(loc.x, loc.y, loc.z))
            bb = to_2d_bbox(corners, width, height)
            if bb is not None:
                boxes.append({"bbox": bb, "class_name": class_name,
                              "track_id": actor.id})
        return boxes

    def draw_hud():
        lines = [
            "pos (%.1f, %.1f, %.1f)  pitch %.1f  yaw %.1f  fov %.0f"
            % (pose.x, pose.y, pose.z, pose.pitch, pose.yaw, fov),
            "fps %.1f%s" % (clock.get_fps(),
                            "   REC " + recording[0] if recording
                            else ""),
            "WASD+QE move | arrows rotate | click->3D | P shot | "
            "R record | H hud | ESC quit",
        ]
        for i, text in enumerate(lines):
            display.blit(font.render(text, True, (255, 255, 255),
                                     (0, 0, 0)), (8, 8 + 20 * i))

    ticks = 0
    try:
        while max_ticks is None or ticks < max_ticks:
            ticks += 1
            clock.tick(30)
            moved = False
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    return
                if event.type == pygame.KEYDOWN:
                    if event.key in (pygame.K_F1, pygame.K_h):
                        show_hud = not show_hud
                    if event.key == pygame.K_r:
                        if recording is None:
                            rec_dir = os.path.join(
                                screenshot_path,
                                "rec_%04d" % int(shot))
                            os.makedirs(rec_dir, exist_ok=True)
                            recording = [rec_dir, 0]
                            shot += 1
                        else:
                            recording = None
                if event.type == pygame.MOUSEBUTTONDOWN \
                        and last["depth"] is not None:
                    u, v = event.pos
                    depth_img = np.frombuffer(
                        last["depth"].raw_data, np.uint8).reshape(
                        height, width, 4)[:, :, 2::-1]
                    d = parse_carla_depth(depth_img)[v, u]
                    rig = CameraRig(pose, width, height, fov)
                    xyz = pixel_to_world(u, v, d, rig)
                    print("click (%d, %d) depth %.2fm -> world %s"
                          % (u, v, d, np.round(xyz, 3).tolist()))
            keys = pygame.key.get_pressed()
            if keys[pygame.K_ESCAPE]:
                return
            step, turn = 1.0, 2.0
            dx = dy = dz = dyaw = dpitch = 0.0
            rad = math.radians(pose.yaw)
            if keys[pygame.K_w]:
                dx, dy = step * math.cos(rad), step * math.sin(rad)
            if keys[pygame.K_s]:
                dx, dy = -step * math.cos(rad), -step * math.sin(rad)
            if keys[pygame.K_a]:
                dx, dy = step * math.sin(rad), -step * math.cos(rad)
            if keys[pygame.K_d]:
                dx, dy = -step * math.sin(rad), step * math.cos(rad)
            if keys[pygame.K_q]:
                dz = step
            if keys[pygame.K_e]:
                dz = -step
            if keys[pygame.K_LEFT]:
                dyaw = -turn
            if keys[pygame.K_RIGHT]:
                dyaw = turn
            if keys[pygame.K_UP]:
                dpitch = turn
            if keys[pygame.K_DOWN]:
                dpitch = -turn
            if keys[pygame.K_p] and last["rgb"] is not None:
                os.makedirs(screenshot_path, exist_ok=True)
                last["rgb"].save_to_disk(os.path.join(
                    screenshot_path, "shot_%04d.png" % shot))
                shot += 1
            if any((dx, dy, dz, dyaw, dpitch)):
                pose = Transform(
                    x=pose.x + dx, y=pose.y + dy, z=pose.z + dz,
                    pitch=pose.pitch + dpitch, yaw=pose.yaw + dyaw)
                t = carla.Transform(
                    location=carla.Location(pose.x, pose.y, pose.z),
                    rotation=carla.Rotation(
                        pitch=pose.pitch, yaw=pose.yaw))
                for cam in cams:
                    cam.set_transform(t)
                moved = True
            del moved
            _advance(world)
            if last["rgb"] is not None:
                display.blit(
                    _pygame_surface(pygame, last["rgb"]), (0, 0))
                if recording is not None:
                    pygame.image.save(display, os.path.join(
                        recording[0], "%06d.png" % recording[1]))
                    if save_seg_path is not None \
                            and last["seg"] is not None:
                        _save_seg_frame(
                            last["seg"], save_seg_path,
                            recording[1], seg_as_img)
                    if save_bbox_json is not None:
                        boxes = world_actor_boxes()
                        if boxes:
                            bbox_data[recording[1]] = boxes
                    recording[1] += 1
                if show_hud:
                    draw_hud()
                pygame.display.flip()
    finally:
        for cam in cams:
            cam.stop()
            cam.destroy()
        if save_bbox_json is not None:
            with open(save_bbox_json, "w") as f:
                json.dump(bbox_data, f)
        pygame.quit()


def run_moment_editor(
    client,
    moment_data: List[dict],
    out_file: str,
    width: int = 1280,
    height: int = 720,
    fov: float = 90.0,
    max_ticks: Optional[int] = None,
    scene_registry=None,
) -> List[dict]:
    """Scenario editor/QA GUI — a thin pygame dispatcher over the pure
    :class:`~multiverse_torch.forking_paths.editor.MomentEditor` state
    machine (the full reference keybinding table lives in editor.py's
    module docstring; reference: moment_editor.py:138-172).  Extra keys
    kept from the earlier build: `9` approve-moment metadata tag, ESC
    saves + quits.  `max_ticks` bounds the loop for headless tests.
    """
    import carla
    import pygame

    from multiverse_torch.forking_paths.annotation import approve_moment
    from multiverse_torch.forking_paths.editor import MomentEditor

    pygame.init()
    display = pygame.display.set_mode((width, height))
    clock = pygame.time.Clock()
    world = client.get_world()
    bp_lib = world.get_blueprint_library()

    ed = MomentEditor(moment_data, fov=fov)
    cams = {"rgb": None, "depth": None}
    last = {"rgb": None, "depth": None}

    def rebuild_cameras():
        """(Re)spawn the rgb+depth rig at the editor's pose/fov —
        sensor fov is immutable after spawn, so zooming replaces the
        actors (reference: moment_editor.py:104-136 set_camera_fov)."""
        for cam in cams.values():
            if cam is not None:
                cam.stop()
                cam.destroy()
        t = carla.Transform(
            location=carla.Location(ed.pose.x, ed.pose.y, ed.pose.z),
            rotation=carla.Rotation(
                pitch=ed.pose.pitch, yaw=ed.pose.yaw, roll=ed.pose.roll))
        for kind, bp_name in (("rgb", "sensor.camera.rgb"),
                              ("depth", "sensor.camera.depth")):
            bp = bp_lib.find(bp_name)
            bp.set_attribute("image_size_x", str(width))
            bp.set_attribute("image_size_y", str(height))
            bp.set_attribute("fov", str(ed.fov))
            cams[kind] = world.spawn_actor(bp, t)
            cams[kind].listen(
                lambda im, k=kind: last.__setitem__(k, im))

    def move_cameras():
        t = carla.Transform(
            location=carla.Location(ed.pose.x, ed.pose.y, ed.pose.z),
            rotation=carla.Rotation(
                pitch=ed.pose.pitch, yaw=ed.pose.yaw, roll=ed.pose.roll))
        for cam in cams.values():
            cam.set_transform(t)

    rebuild_cameras()

    def replay(moment):
        adapter = CarlaAdapter(
            world, client,
            (bp_lib.filter("walker.pedestrian.*"), [0]),
            (bp_lib.filter("vehicle.*"), [0]),
            use_collision_sensors=False)
        state = SimState()
        for frame_id in range(ed.total_frames()):
            adapter.execute(plan_frame(
                frame_id, moment["ped_controls"],
                moment.get("vehicle_controls", {}), state), state)
            _advance(world)
            if last["rgb"] is not None:
                display.blit(_pygame_surface(pygame, last["rgb"]), (0, 0))
                pygame.display.flip()
        adapter.cleanup()

    keydown = {
        pygame.K_RIGHTBRACKET: lambda: ed.cycle_moment(+1),
        pygame.K_LEFTBRACKET: lambda: ed.cycle_moment(-1),
        pygame.K_p: ed.toggle_save,
        pygame.K_o: ed.toggle_save_all,
        pygame.K_l: ed.duplicate_moment,
        pygame.K_v: lambda: (ed.anchor_view(scene_registry),
                             rebuild_cameras()),
        pygame.K_COMMA: lambda: ed.select_actor(-1),
        pygame.K_PERIOD: lambda: ed.select_actor(+1),
        pygame.K_BACKSPACE: ed.delete_selected_actor,
        pygame.K_SPACE: ed.toggle_static,
        pygame.K_RETURN: ed.toggle_traj,
        pygame.K_q: ed.delete_last_timestep,
        pygame.K_e: ed.toggle_new_actor_mode,
        pygame.K_1: ed.toggle_new_actor_type,
        pygame.K_f: lambda: ed.set_all_stationary("person"),
        pygame.K_c: lambda: ed.set_all_stationary("vehicle"),
        pygame.K_MINUS: lambda: ed.scrub(-1),
        pygame.K_EQUALS: lambda: ed.scrub(+1),
        pygame.K_x: ed.set_x_agent,
        pygame.K_z: ed.delete_last_destination,
        pygame.K_r: lambda: (ed.reset_camera(), move_cameras()),
        pygame.K_n: lambda: (ed.zoom(+5.0), rebuild_cameras()),
        pygame.K_m: lambda: (ed.zoom(-5.0), rebuild_cameras()),
        pygame.K_t: lambda: print(ed.camera_str()),
        pygame.K_g: lambda: replay(ed.moment),
        pygame.K_9: lambda: moment_data.__setitem__(
            ed.cur, approve_moment(ed.moment)),
    }
    move_keys = {
        pygame.K_w: dict(forward=1.0),
        pygame.K_s: dict(forward=-1.0),
        pygame.K_a: dict(strafe=-1.0),
        pygame.K_d: dict(strafe=1.0),
        pygame.K_u: dict(dz=-1.0),
        pygame.K_i: dict(dz=1.0),
        pygame.K_LEFT: dict(dyaw=-2.0),
        pygame.K_RIGHT: dict(dyaw=2.0),
        pygame.K_UP: dict(dpitch=2.0),
        pygame.K_DOWN: dict(dpitch=-2.0),
    }

    ticks = 0
    try:
        while max_ticks is None or ticks < max_ticks:
            ticks += 1
            clock.tick(30)
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    raise KeyboardInterrupt
                if event.type == pygame.KEYDOWN:
                    if event.key == pygame.K_ESCAPE:
                        raise KeyboardInterrupt
                    fn = keydown.get(event.key)
                    if fn is not None:
                        fn()
                if event.type == pygame.MOUSEBUTTONDOWN \
                        and last["depth"] is not None:
                    u, v = event.pos
                    depth_img = np.frombuffer(
                        last["depth"].raw_data, np.uint8).reshape(
                        height, width, 4)[:, :, 2::-1]
                    d = parse_carla_depth(depth_img)[v, u]
                    rig = CameraRig(ed.pose, width, height, ed.fov)
                    xyz = pixel_to_world(u, v, d, rig)
                    target = ed.add_control_point(
                        [float(xyz[0]), float(xyz[1]), float(xyz[2])])
                    print("moment %d: %s control point %s" % (
                        ed.cur, target, np.round(xyz, 2).tolist()))
            pressed = pygame.key.get_pressed()
            moved = False
            for key, kw in move_keys.items():
                if pressed[key]:
                    ed.move_camera(**kw)
                    moved = True
            if moved:
                move_cameras()
            _advance(world)
            if last["rgb"] is not None:
                display.blit(_pygame_surface(pygame, last["rgb"]), (0, 0))
                pygame.display.flip()
    except KeyboardInterrupt:
        pass
    finally:
        for cam in cams.values():
            if cam is not None:
                cam.stop()
                cam.destroy()
        pygame.quit()
    saved = ed.saved_moments()
    with open(out_file, "w") as f:
        json.dump(saved, f)
    return saved


def moment_editor_main(argv=None) -> None:
    """mvt-torch-moment-editor CLI (reference: moment_editor.py)."""
    import argparse

    import carla

    parser = argparse.ArgumentParser(prog="mvt-torch-moment-editor")
    parser.add_argument("moment_json")
    parser.add_argument("out_file")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=2000, type=int)
    args = parser.parse_args(argv)
    require_package("pygame", parser.prog)
    with open(args.moment_json) as f:
        moment_data = json.load(f)
    client = carla.Client(args.host, args.port)
    client.set_timeout(10.0)
    run_moment_editor(client, moment_data, args.out_file)


def annotate_main(argv=None) -> None:
    """mvt-torch-annotate CLI (reference: annotate_carla.py)."""
    import argparse

    import carla

    parser = argparse.ArgumentParser(prog="mvt-torch-annotate")
    parser.add_argument("moment_json")
    parser.add_argument("out_file")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=2000, type=int)
    parser.add_argument("--video_fps", type=float, default=30.0)
    parser.add_argument("--obs_length", type=int, default=12)
    parser.add_argument("--pred_length", type=int, default=26)
    parser.add_argument("--max_attempts", type=int, default=None,
                        help="skip a task after N failed tries "
                             "(default: retry forever, as the "
                             "reference does)")
    parser.add_argument("--start_idx", type=int, default=0,
                        help="start from this moment index "
                             "(reference: annotate_carla.py:74)")
    parser.add_argument("--job", type=int, default=1,
                        help="total annotator shards")
    parser.add_argument("--curJob", type=int, default=1,
                        help="1-based shard id — this process takes "
                             "every job-th task (reference: "
                             "annotate_carla.py:76-77,330-332)")
    args = parser.parse_args(argv)
    require_package("pygame", parser.prog)
    with open(args.moment_json) as f:
        moment_data = json.load(f)
    client = carla.Client(args.host, args.port)
    client.set_timeout(10.0)
    saved = run_annotation_game(
        client, moment_data, args.out_file,
        video_fps=args.video_fps, obs_length=args.obs_length,
        pred_length=args.pred_length, max_attempts=args.max_attempts,
        start_idx=args.start_idx, job=args.job, cur_job=args.curJob)
    print("saved %d annotations -> %s" % (len(saved), args.out_file))


def spectator_main(argv=None) -> None:
    """mvt-torch-spectator CLI (reference: spectator.py)."""
    import argparse

    import carla

    parser = argparse.ArgumentParser(prog="mvt-torch-spectator")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=2000, type=int)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--fov", type=float, default=90.0)
    parser.add_argument("--save_screenshot_path",
                        default="spectator_shots")
    parser.add_argument("--change_map", default=None,
                        help="load this map first (reference: "
                             "spectator.py:54,446-448)")
    parser.add_argument("--go_to_anchor", default=None, metavar="SCENE",
                        help="start at SCENE's anchor camera from the "
                             "packaged calibration — the reference's "
                             "go_to_{zara,eth,hotel,0000,0400,0401,"
                             "0500}_anchor family as one flag "
                             "(reference: spectator.py:57-72,503-532)")
    parser.add_argument("--go_to_scene", default=None,
                        help="start at SCENE's recording camera "
                             "--go_to_camera_num (reference: "
                             "spectator.py:74-76,535-538)")
    parser.add_argument("--go_to_camera_num", type=int, default=0)
    parser.add_argument("--scene_registry", default=None,
                        help="camera-preset registry JSON (default: "
                             "the packaged calibration)")
    parser.add_argument("--set_weather", default=None, metavar="SCENE",
                        help="apply SCENE's registry weather "
                             "(reference: spectator.py:49,463-480 — "
                             "which hardcodes scene 0000's)")
    parser.add_argument("--weather_night", action="store_true",
                        help="ClearSunset preset (reference: "
                             "spectator.py:472-473)")
    parser.add_argument("--weather_rain", action="store_true",
                        help="HardRainNoon preset (reference: "
                             "spectator.py:474-476)")
    parser.add_argument("--save_seg_path", default=None,
                        help="also capture a semantic-seg camera while "
                             "recording, frames saved here (reference: "
                             "spectator.py:44,345-350)")
    parser.add_argument("--save_bbox_json", default=None,
                        help="write recorded frames' projected 2D "
                             "walker/vehicle boxes to this json at "
                             "exit (reference: spectator.py:45,708-711)")
    parser.add_argument("--save_seg_as_img", action="store_true",
                        help="save seg frames CityScapes-palette "
                             "colored instead of raw class ids")
    parser.add_argument("--max_ticks", type=int, default=None,
                        help=argparse.SUPPRESS)  # headless test bound
    args = parser.parse_args(argv)
    require_package("pygame", parser.prog)
    client = carla.Client(args.host, args.port)
    client.set_timeout(10.0)
    if args.change_map is not None:
        client.load_world(args.change_map)
    world = client.get_world()

    from multiverse_torch.forking_paths.scenes import (
        apply_weather,
        default_registry_path,
        load_scene_registry,
    )

    registry = load_scene_registry(
        args.scene_registry or default_registry_path())
    if args.weather_night:
        world.set_weather(carla.WeatherParameters.ClearSunset)
    elif args.weather_rain:
        world.set_weather(carla.WeatherParameters.HardRainNoon)
    elif args.set_weather is not None:
        apply_weather(world, registry.scenes[args.set_weather].weather)

    start_pose, fov = None, args.fov
    if args.go_to_anchor is not None:
        rig = registry.cameras["anchor"][args.go_to_anchor][0]
        start_pose, fov = rig.transform, rig.fov
    elif args.go_to_scene is not None:
        rig = registry.cameras["recording"][
            args.go_to_scene][args.go_to_camera_num]
        start_pose, fov = rig.transform, rig.fov

    run_spectator(client, width=args.width, height=args.height,
                  fov=fov, screenshot_path=args.save_screenshot_path,
                  start_pose=start_pose, max_ticks=args.max_ticks,
                  save_seg_path=args.save_seg_path,
                  save_bbox_json=args.save_bbox_json,
                  seg_as_img=args.save_seg_as_img)


if __name__ == "__main__":
    annotate_main()
