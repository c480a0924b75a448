"""Simulation moment tooling CLIs.

The port's copy of ``multiverse_tpu/cli/moment_tools.py``:
``mvt-torch-build-moment`` and ``mvt-torch-auto-moment-candidates``
take the ``mvt-*`` commands' arguments, print the same lines and write
the same files.

    mvt-torch-build-moment            reference: forking_paths_dataset/code/
                                      build_moment.py — replay one
                                      trajectory window in CARLA
                                      (debug/QA)
    mvt-torch-auto-moment-candidates  reference: forking_paths_dataset/code/
                                      auto_moment_candidates.py —
                                      sweep trajectory files for
                                      simulatable moment windows,
                                      validating each by replay

Both need a CARLA 0.9.6 server; CI drives the full loops against the
in-memory fake backend (tests/test_torch_carla_gated.py).
"""

from __future__ import annotations

import argparse
import glob
import os


def _connect(host: str, port: int, timeout: float = 2.0):
    import carla  # requires a CARLA 0.9.6 server (or the test fake)

    client = carla.Client(host, port)
    client.set_timeout(timeout)
    return client


def _resolve_scene(filename: str, registry, is_actev: bool):
    """ActEV videos map to their 4-digit scene; ETH/UCY trajectory
    files are named after the scene itself
    (reference: build_moment.py:44-51)."""
    from multiverse_torch.forking_paths.moments import get_scene

    scene = get_scene(filename) if is_actev else filename
    if scene not in registry.scenes:
        raise SystemExit("scene %r not in the registry (%s)"
                         % (scene, sorted(registry.scenes)))
    return scene, registry.scenes[scene]


def build_moment_main(argv=None) -> None:
    """Replay [start_frame_idx, end_frame_idx] of one trajectory file
    in the simulator (reference: build_moment.py)."""
    parser = argparse.ArgumentParser(prog="mvt-torch-build-moment")
    parser.add_argument("traj_file")
    parser.add_argument("start_frame_idx", type=int, help="inclusive")
    parser.add_argument("end_frame_idx", type=int, help="inclusive")
    parser.add_argument("--vehicle_traj", default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=2000, type=int)
    parser.add_argument("--show_traj", action="store_true",
                        help="draw the pedestrian trajectories as "
                             "debug lines before replaying")
    parser.add_argument("--vehicle_z", type=float, default=0.0,
                        help="set all vehicle z to this value")
    parser.add_argument("--scene_registry", default=None,
                        help="scene/camera JSON (default: the packaged "
                             "published Forking Paths calibration)")
    args = parser.parse_args(argv)

    from multiverse_torch.forking_paths.candidates import replay_moment
    from multiverse_torch.forking_paths.controls import (
        load_traj_file,
        traj_to_controls,
    )
    from multiverse_torch.forking_paths.scenes import (
        apply_weather,
        default_registry_path,
        load_scene_registry,
        spawn_static_cars,
    )

    registry = load_scene_registry(
        args.scene_registry or default_registry_path())
    filename = os.path.splitext(os.path.basename(args.traj_file))[0]
    scene, static_scene = _resolve_scene(
        filename, registry, is_actev=filename.startswith("VIRAT"))
    fps = static_scene.fps

    rows = load_traj_file(args.traj_file)
    ped_controls, total_frames = traj_to_controls(
        rows, args.start_frame_idx, args.end_frame_idx, fps)
    if not ped_controls:
        raise SystemExit("start frame %d not in %s"
                         % (args.start_frame_idx, args.traj_file))
    print("Control data prepared.")
    vehicle_controls: dict = {}
    if args.vehicle_traj is not None:
        vehicle_controls, _ = traj_to_controls(
            load_traj_file(args.vehicle_traj), args.start_frame_idx,
            args.end_frame_idx, fps, interpolate=True,
            z_to=args.vehicle_z)

    client = _connect(args.host, args.port)
    # like the reference, replay into the CURRENTLY loaded world
    # (build_moment.py:72-84 uses get_world, not load_world)
    world = client.get_world()
    settings = world.get_settings()
    settings.synchronous_mode = True
    settings.fixed_delta_seconds = 1.0 / fps
    world.apply_settings(settings)
    actor_list: list = []
    try:
        apply_weather(world, static_scene.weather)
        spawn_static_cars(world, client, static_scene, actor_list)
        world.tick()

        if args.show_traj:
            _draw_debug_traj(world, rows, fps)

        bp_lib = world.get_blueprint_library()
        ok, reason, _ = replay_moment(
            client, world,
            (bp_lib.filter("walker.pedestrian.*"), [0]),
            (bp_lib.filter("vehicle.*"), [0]),
            ped_controls, vehicle_controls,
            start_frame=0, total_frames=total_frames)
        print("replay %s%s" % ("OK" if ok else "FAILED",
                               "" if ok else (": " + reason)))
    finally:
        settings = world.get_settings()
        settings.synchronous_mode = False
        world.apply_settings(settings)
        for actor in actor_list:
            actor.destroy()


def _draw_debug_traj(world, rows, fps) -> None:
    """Per-person debug polylines (reference: utils.py show_traj
    drawing inside run_sim_for_one_frame); no-op when the backend
    has no debug helper (the test fake)."""
    debug = getattr(world, "debug", None)
    if debug is None:
        print("(no world.debug on this backend; --show_traj skipped)")
        return
    import carla

    import numpy as np

    for pid in np.unique(rows[:, 1]):
        pts = rows[rows[:, 1] == pid]
        for a, b in zip(pts[:-1], pts[1:]):
            debug.draw_line(
                carla.Location(x=a[2], y=a[3], z=a[4] + 0.2),
                carla.Location(x=b[2], y=b[3], z=b[4] + 0.2),
                thickness=0.1, life_time=30.0)


def auto_candidates_main(argv=None) -> None:
    """Sweep trajectory files for moment windows that replay cleanly
    (reference: auto_moment_candidates.py)."""
    parser = argparse.ArgumentParser(
        prog="mvt-torch-auto-moment-candidates")
    parser.add_argument("traj_path")
    parser.add_argument("moment_path",
                        help="save the candidates into json files")
    parser.add_argument("--vehicle_traj_path", default=None)
    parser.add_argument("--is_actev", action="store_true")
    parser.add_argument("--only_scene", default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=2000, type=int)
    parser.add_argument("--moment_length", default=15.2, type=float,
                        help="seconds per moment window")
    parser.add_argument("--test_skip", default=1, type=int,
                        help="stride between candidate start frames")
    parser.add_argument("--log_file", default=None,
                        help="write the (filename, start, reason) "
                             "failure log here")
    parser.add_argument("--scene_registry", default=None,
                        help="scene/camera JSON (default: the packaged "
                             "published Forking Paths calibration)")
    args = parser.parse_args(argv)

    from multiverse_torch.forking_paths.candidates import (
        find_candidate_moments,
        save_candidates,
    )
    from multiverse_torch.forking_paths.moments import get_scene
    from multiverse_torch.forking_paths.scenes import (
        default_registry_path,
        load_scene_registry,
    )

    registry = load_scene_registry(
        args.scene_registry or default_registry_path())
    get_scene_fn = (
        get_scene if args.is_actev
        else lambda name: name)

    traj_files = sorted(glob.glob(os.path.join(args.traj_path, "*.txt")))
    if args.only_scene is not None:
        # the reference gates only_scene on is_actev
        # (auto_moment_candidates.py:97-100); scene == filename
        # otherwise, so the filter is meaningful for both
        traj_files = [
            f for f in traj_files
            if get_scene_fn(
                os.path.splitext(os.path.basename(f))[0]
            ) == args.only_scene]
    if not traj_files:
        raise SystemExit("no trajectory files to sweep")
    # validate every file's scene against the registry BEFORE the
    # sweep: a KeyError mid-sweep would discard hours of accumulated
    # replay results (the reference asserts scene membership up front)
    for f in traj_files:
        _resolve_scene(os.path.splitext(os.path.basename(f))[0],
                       registry, is_actev=args.is_actev)

    client = _connect(args.host, args.port)
    success, fails = find_candidate_moments(
        client, traj_files, registry, get_scene_fn,
        moment_length=args.moment_length, test_skip=args.test_skip,
        vehicle_traj_path=args.vehicle_traj_path)
    save_candidates(success, args.moment_path)
    n_ok = sum(len(v) for v in success.values())
    print("%d candidate moments over %d scenes; %d failures"
          % (n_ok, len(success), len(fails)))
    if args.log_file is not None:
        with open(args.log_file, "w") as f:
            for filename, start, reason in fails:
                f.write("%s\t%s\t%s\n" % (filename, start, reason))
