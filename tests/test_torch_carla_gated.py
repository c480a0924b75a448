"""The port's carla-gated toolkit (adapter, replay, scene setup,
recorder, candidate sweep and the ``mvt-torch-record-moments``,
``-build-moment`` and ``-auto-moment-candidates`` commands) against the
JAX package's, on the in-memory fakes of ``carla``: the cases of
``tests/test_carla_gated.py``, each run with the JAX package over
``tests/fake_carla.py`` and with the port over
``tests/torch_fake_carla.py``, the fakes' actor ids reset before each
side. Tolerance 0: the actors each world holds, the values returned and
the lines printed equal; bbox and moment JSONs byte-equal; recorded
``.mp4`` videos compared by their decoded frames (array-equal), as the
container bytes are cv2's business (they were found equal too, and the
recorder test checks that)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from tests.toolkit_parity import both, same_tree


def _walker_bps(world):
    return (world.get_blueprint_library().filter("walker.pedestrian.*"), [0])


def _vehicle_bps(world):
    return (world.get_blueprint_library().filter("vehicle.*"), [0])


def _controls(p, rows, fps=25.0, **kw):
    return p.controls.traj_to_controls(np.asarray(rows, np.float64), -1, -1,
                                       fps, **kw)[0]


def _actors(world):
    """What a fake world holds, as plain values."""
    out = []
    for a in world.actors:
        loc = a.get_transform().location
        out.append((a.id, a.type_id, a.is_alive, a.physics,
                    (loc.x, loc.y, loc.z),
                    [(getattr(c, "speed", None),
                      None if not hasattr(c, "direction") else
                      (c.direction.x, c.direction.y, c.direction.z))
                     for c in a.controls]))
    return out


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _adapter_spawn_control_destroy(p):
    client = p.fake.Client()
    world = client.get_world()
    adapter = p.sim.CarlaAdapter(world, client, _walker_bps(world),
                                 _vehicle_bps(world))
    state = p.sim.SimState()
    ped = _controls(p, [[0, 1, 0, 0, 0.5], [1, 1, 1, 0, 0.5],
                        [2, 1, 2, 0, 0.5]])
    veh = _controls(p, [[0, 9, 5, 5, 0], [1, 9, 6, 6, 0], [2, 9, 7, 7, 0]],
                    z_to=0.0)
    out = [adapter.execute(p.sim.plan_frame(0, ped, veh, state), state)]
    assert sorted(a.type_id for a in world.actors) == [
        "sensor.other.collision", "vehicle.fake", "walker.pedestrian"]
    veh_actor = [a for a in world.actors if a.type_id == "vehicle.fake"][0]
    assert veh_actor.physics is False
    out.append(adapter.execute(p.sim.plan_frame(1, ped, veh, state), state))
    walker = [a for a in world.actors
              if a.type_id == "walker.pedestrian"][0]
    assert walker.controls and walker.controls[-1].speed > 0
    assert veh_actor.get_transform().location.x == pytest.approx(6.0)
    out.append(adapter.execute(p.sim.plan_frame(2, ped, veh, state), state))
    assert not walker.is_alive
    adapter.cleanup()
    assert all(not a.is_alive for a in world.actors
               if a.type_id.startswith("sensor"))
    return _actors(world), [len(b) for b in client.applied], \
        sorted(state.peds), sorted(state.vehicles)


def _adapter_walker_spawn_failure_policies(p):
    ped = _controls(p, [[0, 1, 0, 0, 0.5], [1, 1, 1, 0, 0.5],
                        [2, 1, 2, 0, 0.5]])
    client = p.fake.Client()
    world = client.get_world()
    world.fail_walker_spawns = 1
    adapter = p.sim.CarlaAdapter(world, client, _walker_bps(world),
                                 _vehicle_bps(world))
    state = p.sim.SimState()
    out = adapter.execute(p.sim.plan_frame(0, ped, {}, state), state)
    assert out is not None and 1.0 not in state.peds
    client2 = p.fake.Client()
    world2 = client2.get_world()
    world2.fail_walker_spawns = 1
    adapter2 = p.sim.CarlaAdapter(world2, client2, _walker_bps(world2),
                                  _vehicle_bps(world2),
                                  exit_if_spawn_fail=True)
    state2 = p.sim.SimState()
    assert adapter2.execute(p.sim.plan_frame(0, ped, {}, state2),
                            state2) is None
    return _actors(world), _actors(world2), sorted(state.peds)


def _replay_moment_success_and_spawn_fail(p):
    ped = _controls(p, [[0, 1, 0, 0, 0.5], [5, 1, 1, 0, 0.5],
                        [10, 1, 2, 0, 0.5]])
    client = p.fake.Client()
    world = client.get_world()
    ok = p.candidates.replay_moment(
        client, world, _walker_bps(world), _vehicle_bps(world),
        ped, {}, start_frame=0, total_frames=10)
    assert ok == (True, "", False) and world.frame == 10
    world2 = p.fake.Client().get_world()
    world2.fail_walker_spawns = 99
    client2 = p.fake.Client(world2)
    fail = p.candidates.replay_moment(
        client2, world2, _walker_bps(world2), _vehicle_bps(world2),
        ped, {}, start_frame=0, total_frames=10)
    assert not fail[0] and fail[1] == "Ped spawn fails."
    return ok, fail, _actors(world), _actors(world2)


def _scene_setup(p):
    s = p.scenes
    client = p.fake.Client()
    world = client.get_world()
    scene = s.SceneConfig(
        name="0400", map="Town05", fps=30.0,
        weather=s.Weather(cloudyness=20.0, sun_altitude_angle=65.0),
        static_cars=(s.StaticCar("vehicle.tesla.model3",
                                 (1.0, 2.0, 0.3), (0.0, 90.0, 0.0)),))
    s.apply_weather(world, scene.weather)
    assert world.weather.params["cloudyness"] == 20.0
    actors: list = []
    s.spawn_static_cars(world, client, scene, actors)
    assert len(actors) == 1
    return world.weather.params, _actors(world)


def _record_moment_end_to_end(p, tmp):
    import cv2

    client = p.fake.Client()
    scene = p.scenes.SceneConfig(name="0400", map="Town05", fps=25.0,
                                 weather=p.scenes.Weather())
    rigs = [p.camera.CameraRig(p.camera.Transform(x=-15.0, z=3.0), 64, 48,
                               90.0)]
    ped = _controls(p, [[0, 1, 0, 0, 0.5], [5, 1, 1, 0, 0.5],
                        [10, 1, 2, 0, 0.5]])
    out = p.recorder.record_moment(
        client, scene, rigs, ped, {}, total_frames=10, out_path=tmp,
        moment_name="0400_0_1_0_a", x_agent_pid=1.0)
    name = "0400_0_1_0_a_cam1"
    vcap = cv2.VideoCapture(out[name])
    assert int(vcap.get(cv2.CAP_PROP_FRAME_COUNT)) == 10
    vcap.release()
    scap = cv2.VideoCapture(os.path.join(tmp, "videos_seg", name + ".mp4"))
    ok, frame = scap.read()
    scap.release()
    assert ok
    ids = p.prepared_data.seg_rgb_to_carla_ids(frame[:, :, ::-1])
    assert (ids == 4).mean() > 0.99
    with open(os.path.join(tmp, "bbox", name + ".json")) as f:
        boxes = json.load(f)
    assert boxes and all(b["class_name"] == "Person" for b in boxes)
    assert any(b["is_x_agent"] == 1 for b in boxes)
    assert client.get_world().settings.synchronous_mode is False
    return {k: os.path.relpath(v, tmp) for k, v in out.items()}, \
        _actors(client.get_world())


def _find_candidate_moments_sweep(p, tmp):
    rows = ["%d\t1\t%.2f\t%.2f\t0.5" % (f, 0.2 * f, 0.0)
            for f in range(0, 100, 5)]
    traj_file = os.path.join(tmp, "VIRAT_S_040000_00.txt")
    with open(traj_file, "w") as f:
        f.write("\n".join(rows) + "\n")
    registry = p.scenes.SceneRegistry(
        scenes={"0400": p.scenes.SceneConfig("0400", "Town05", 25.0,
                                             p.scenes.Weather())},
        cameras={})
    success, fails = p.candidates.find_candidate_moments(
        p.fake.Client(), [traj_file], registry,
        lambda name: name.split("_S_")[-1][:4], moment_length=2.0,
        test_skip=5)
    rec = success["0400"][0]
    assert rec["scenename"] == "0400" and 0 in rec["ped_controls"]
    assert rec["x_agents"] == {}
    p.candidates.save_candidates(success, os.path.join(tmp, "moments"))
    with open(os.path.join(tmp, "moments", "0400.json")) as f:
        assert json.load(f)[0]["original_start_frame_id"] == rec[
            "original_start_frame_id"]
    for r in success["0400"]:
        r["filename"] = os.path.basename(r["filename"])
    return success, fails


def _record_moments_cli_published_calibration(p, tmp):
    ped = _controls(p, [[0, 1, 0, 0, 0.5], [1, 1, 1, 0, 0.5],
                        [2, 1, 2, 0, 0.5]])
    moment = {"scenename": "0400", "moment_id": "0400_0_1_0",
              "ped_controls": ped, "vehicle_controls": {},
              "x_agents": {"1": []}}
    moment_json = os.path.join(tmp, "moments.json")
    with open(moment_json, "w") as f:
        json.dump([moment], f, default=float)
    out = os.path.join(tmp, "out")
    printed = _stdout(p.mod("cli.vis_dataset").record_moments_main,
                      [moment_json, out])
    videos = sorted(os.listdir(os.path.join(out, "videos")))
    assert videos == ["0400_0_1_0_cam%d.mp4" % i for i in range(1, 5)]
    assert sorted(os.listdir(os.path.join(out, "videos_seg"))) == videos
    return printed.replace(tmp, "<tmp>")


def _record_moment_start_offset(p, tmp):
    import cv2

    client = p.fake.Client()
    scene = p.scenes.SceneConfig(name="0400", map="Town05", fps=25.0,
                                 weather=p.scenes.Weather())
    rigs = [p.camera.CameraRig(p.camera.Transform(x=-15.0, z=3.0), 64, 48,
                               90.0)]
    ped = _controls(p, [[0, 1, 0, 0, 0.5], [5, 1, 1, 0, 0.5],
                        [10, 1, 2, 0, 0.5]])
    out = p.recorder.record_moment(
        client, scene, rigs, ped, {}, total_frames=10, out_path=tmp,
        moment_name="m", x_agent_pid=1.0, start_offset=4, cam_num_offset=2)
    assert list(out) == ["m_cam3"]
    vcap = cv2.VideoCapture(out["m_cam3"])
    assert int(vcap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    vcap.release()
    with open(os.path.join(tmp, "bbox", "m_cam3.json")) as f:
        fids = sorted({b["frame_id"] for b in json.load(f)})
    assert fids[0] == 0 and fids[-1] == 5
    return list(out), _actors(client.get_world())


def _record_moments_cli_anchor_mode(p, tmp):
    rig = {"fov": 90.0, "location_xyz": [-15.0, 0.0, 3.0],
           "rotation_pyr": [0.0, 0.0, 0.0], "width": 64, "height": 48}
    registry = {
        "scenes": {"0400": {"map": "Town05_actev", "fps": 30.0,
                            "static_cars": [], "weather": {}}},
        "cameras": {"anchor": {"0400": [rig]},
                    "recording": {"0400": [rig, rig, rig, rig]}},
    }
    reg_path = os.path.join(tmp, "registry.json")
    with open(reg_path, "w") as f:
        json.dump(registry, f)
    ped = _controls(p, [[0, 1, 0, 0, 0.5], [8, 1, 1, 0, 0.5],
                        [16, 1, 2, 0, 0.5]], fps=30.0)
    moment = {"scenename": "0400", "filename": "VIRAT_S_040000_00",
              "original_start_frame_id": 1234, "ped_controls": ped,
              "vehicle_controls": {}}
    moment_json = os.path.join(tmp, "moments.json")
    with open(moment_json, "w") as f:
        json.dump([moment], f, default=float)
    out = os.path.join(tmp, "out")
    printed = _stdout(p.mod("cli.vis_dataset").record_moments_main, [
        moment_json, out, "--scene_registry", reg_path,
        "--is_anchor_moment", "--add_3view_to_anchor", "--use_alter_weather",
        "--video_fps", "10", "--annotation_fps", "2.5",
        "--obs_length", "3", "--pred_length", "2"])
    name = "VIRAT_S_040000_00_F_1234_obs3_pred2"
    assert sorted(os.listdir(os.path.join(out, "videos"))) == [
        "%s_cam%d.mp4" % (name, i) for i in range(1, 5)]
    with open(os.path.join(out, "bbox", name + "_cam1.json")) as f:
        assert not any(b.get("is_x_agent") for b in json.load(f))
    client = p.fake.Client()
    p.recorder.record_moment(
        client, p.scenes.SceneConfig(name="0400", map="Town05", fps=25.0,
                                     weather=p.scenes.Weather()),
        [p.camera.CameraRig(p.camera.Transform(x=-15.0, z=3.0), 64, 48,
                            90.0)],
        ped, {}, total_frames=2, out_path=os.path.join(tmp, "w"),
        moment_name="w", weather_override=p.scenes.REALISM_WEATHER)
    weather = client.get_world().weather.params
    assert weather["cloudyness"] == p.scenes.REALISM_WEATHER.cloudyness
    return printed.replace(tmp, "<tmp>"), weather


def _actev_registry_json(tmp):
    registry = {"scenes": {"0400": {"map": "Town05", "fps": 25.0,
                                    "static_cars": [], "weather": {}}},
                "cameras": {}}
    path = os.path.join(tmp, "registry.json")
    with open(path, "w") as f:
        json.dump(registry, f)
    return path


def _build_moment_cli(p, tmp):
    traj_file = os.path.join(tmp, "VIRAT_S_040000_00.txt")
    with open(traj_file, "w") as f:
        f.write("\n".join("%d\t1\t%.2f\t%.2f\t0.5" % (f_, 0.2 * f_, 0.0)
                          for f_ in range(0, 100, 5)) + "\n")
    veh_file = os.path.join(tmp, "veh.txt")
    with open(veh_file, "w") as f:
        f.write("\n".join("%d\t9\t%.2f\t%.2f\t0.0" % (f_, 30.0 - 0.1 * f_, 5.0)
                          for f_ in range(0, 100, 5)) + "\n")
    printed = _stdout(p.mod("cli.moment_tools").build_moment_main, [
        traj_file, "0", "95", "--vehicle_traj", veh_file,
        "--vehicle_z", "0.2", "--show_traj",
        "--scene_registry", _actev_registry_json(tmp)])
    assert "replay OK" in printed
    assert p.fake.Client().get_world().settings.synchronous_mode is False
    return printed


def _auto_moment_candidates_cli(p, tmp):
    traj_dir = os.path.join(tmp, "traj")
    os.makedirs(traj_dir)
    with open(os.path.join(traj_dir, "VIRAT_S_040000_00.txt"), "w") as f:
        f.write("\n".join("%d\t1\t%.2f\t%.2f\t0.5" % (f_, 0.2 * f_, 0.0)
                          for f_ in range(0, 100, 5)) + "\n")
    moments = os.path.join(tmp, "moments")
    main = p.mod("cli.moment_tools").auto_candidates_main
    printed = _stdout(main, [
        traj_dir, moments, "--is_actev", "--only_scene", "0400",
        "--moment_length", "2.0", "--test_skip", "5",
        "--log_file", os.path.join(tmp, "fails.log"),
        "--scene_registry", _actev_registry_json(tmp)])
    with open(os.path.join(moments, "0400.json")) as f:
        recs = json.load(f)
    assert recs and recs[0]["scenename"] == "0400" and recs[0]["ped_controls"]
    with pytest.raises(SystemExit) as err:
        main([traj_dir, moments, "--is_actev", "--only_scene", "0000",
              "--scene_registry", _actev_registry_json(tmp)])
    return printed, str(err.value)


def _rejects_unregistered_scene(p, tmp):
    traj_dir = os.path.join(tmp, "traj")
    os.makedirs(traj_dir)
    for scene in ("0400", "0500"):
        with open(os.path.join(traj_dir, "VIRAT_S_%s00_00.txt" % scene),
                  "w") as f:
            f.write("0\t1\t0\t0\t0.5\n")
    with pytest.raises(SystemExit, match="0500") as err:
        p.mod("cli.moment_tools").auto_candidates_main([
            traj_dir, os.path.join(tmp, "moments"), "--is_actev",
            "--scene_registry", _actev_registry_json(tmp)])
    return str(err.value)


def _rejects_start_offset_past_end(p, tmp):
    with pytest.raises(ValueError, match="start_offset") as err:
        p.recorder.record_moment(
            p.fake.Client(), p.scenes.SceneConfig(
                name="0400", map="Town05", fps=25.0,
                weather=p.scenes.Weather()),
            rigs=[], ped_controls={}, vehicle_controls={}, total_frames=5,
            out_path=tmp, moment_name="m", start_offset=10)
    return str(err.value)


NO_FILES = [_adapter_spawn_control_destroy,
            _adapter_walker_spawn_failure_policies,
            _replay_moment_success_and_spawn_fail, _scene_setup]
WITH_FILES = [_record_moment_end_to_end, _find_candidate_moments_sweep,
              _record_moments_cli_published_calibration,
              _record_moment_start_offset, _record_moments_cli_anchor_mode,
              _build_moment_cli, _auto_moment_candidates_cli,
              _rejects_unregistered_scene, _rejects_start_offset_past_end]


@pytest.mark.parametrize("case", NO_FILES,
                         ids=[c.__name__[1:] for c in NO_FILES])
def test_world_equals_jax(case):
    both(case, carla=True)


@pytest.mark.parametrize("case", WITH_FILES,
                         ids=[c.__name__[1:] for c in WITH_FILES])
def test_files_equal_jax(case, tmp_path):
    both(case, carla=True, tmp=tmp_path)
    same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_recorded_videos_are_byte_equal(tmp_path):
    """The recorder's mp4 containers themselves, not only their frames,
    come out byte-equal (one cv2 encodes both)."""
    both(_record_moment_end_to_end, carla=True, tmp=tmp_path)
    for sub in ("videos", "videos_seg"):
        name = os.path.join(sub, "0400_0_1_0_a_cam1.mp4")
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
