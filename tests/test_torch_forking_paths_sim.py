"""The port's CARLA-free toolkit modules against the JAX package's on
the CPU: camera geometry and control conversion (the cases of
``tests/test_forking_paths.py``), the simulation planner and the scene
registry (``tests/test_sim.py``), the moment editor
(``tests/test_editor.py``) and the annotation session
(``tests/test_annotation.py``). Each case runs with the JAX package's
modules and with the port's on the same inputs and makes the JAX test's
checks on both; what it returns (commands, records, states, edited
moments) must be equal at tolerance 0."""

import copy
import json
import types

import numpy as np
import pytest

from tests.toolkit_parity import both

# ------------------------------------------- camera + controls (test_forking_paths)


def _intrinsic(p):
    k = p.fp.compute_intrinsic(1920, 1080, 90.0)
    assert k[0, 2] == 960.0 and k[1, 2] == 540.0
    assert k[0, 0] == pytest.approx(960.0)
    return k


def _depth_decode(p):
    img = np.zeros((2, 2, 3), np.uint8)
    img[0, 0] = (255, 255, 255)
    d = p.fp.parse_carla_depth(img)
    assert d[0, 0] == pytest.approx(1000.0)
    assert d[1, 1] == pytest.approx(0.0)
    return d


def _project_roundtrip(p):
    rig = p.fp.CameraRig(
        p.fp.Transform(x=10.0, y=-5.0, z=20.0, pitch=-45.0, yaw=30.0),
        width=1920, height=1080, fov=90.0)
    world = np.array([[25.0, 3.0, 1.0]])
    uvd = p.fp.project_points(world, rig)
    assert uvd[0, 2] > 0
    back = p.fp.pixel_to_world(uvd[0, 0], uvd[0, 1], uvd[0, 2], rig)
    np.testing.assert_allclose(back, world[0], atol=1e-6)
    return uvd, back, rig.intrinsic, p.camera.compute_extrinsic(
        rig.transform)


def _center_projects_to_principal_point(p):
    rig = p.fp.CameraRig(p.fp.Transform(z=10.0, pitch=-90.0),
                         width=800, height=600, fov=90.0)
    uvd = p.fp.project_points(np.array([[0.0, 0.0, 0.0]]), rig)
    assert uvd[0, 0] == pytest.approx(400.0, abs=1e-6)
    assert uvd[0, 1] == pytest.approx(300.0, abs=1e-6)
    assert uvd[0, 2] == pytest.approx(10.0, abs=1e-6)
    return uvd


def _box_projection_and_clip(p):
    rig = p.fp.CameraRig(p.fp.Transform(x=-10.0, z=2.0),
                         width=800, height=600, fov=90.0)
    box = p.fp.project_3d_box((1.0, 0.5, 1.0), p.fp.Transform(z=1.0), rig)
    assert box.shape == (8, 3)
    bb = p.fp.to_2d_bbox(box, 800, 600)
    x, y, w, h = bb
    assert 0 <= x <= 800 and w > 0 and h > 0
    rig2 = p.fp.CameraRig(p.fp.Transform(x=10.0, yaw=0.0, z=2.0),
                          width=800, height=600, fov=90.0)
    box2 = p.fp.project_3d_box((1.0, 0.5, 1.0), p.fp.Transform(z=1.0),
                               rig2)
    assert p.fp.to_2d_bbox(box2, 800, 600) is None
    return box, bb, box2


def _direction_and_speed(p):
    src = np.array([0.0, 1.0, 0.0, 0.0, 0.0])
    dst = np.array([25.0, 1.0, 3.0, 4.0, 0.0])
    direction, speed, dt = p.fp.direction_and_speed(dst, src, 25.0)
    np.testing.assert_allclose(direction, [0.6, 0.8, 0.0], atol=1e-9)
    assert dt == pytest.approx(1.0)
    assert speed == pytest.approx(5.0 * p.fp.SPEED_CALIBRATION)
    return direction, speed, dt


def _interpolate_segment(p):
    p1 = np.array([0.0, 7.0, 0.0, 0.0, 0.0])
    p2 = np.array([4.0, 7.0, 4.0, 8.0, 0.0])
    mid = p.fp.interpolate_segment(p1, p2)
    assert len(mid) == 3
    np.testing.assert_allclose(mid[0], [1.0, 7.0, 1.0, 2.0, 0.0])
    np.testing.assert_allclose(mid[2], [3.0, 7.0, 3.0, 6.0, 0.0])
    return mid


def _walking_rows(pid=1.0, n=12, step=0.2):
    return np.asarray([[float(i), pid, step * i, 0.0, 0.5]
                       for i in range(n)])


def _traj_to_controls_moving(p):
    controls, total = p.fp.traj_to_controls(_walking_rows(), -1, -1,
                                            fps=25.0)
    assert total == 11
    rec = controls["0"][0]
    assert rec[0] == 1.0
    np.testing.assert_allclose(rec[3], [1.0, 0.0, 0.0], atol=1e-9)
    assert rec[4] == pytest.approx(0.2 * 25 * p.fp.SPEED_CALIBRATION)
    assert rec[6] is False
    assert controls[str(11)][-1][3] is None
    return controls, total


def _traj_to_controls_stationary(p):
    controls, _ = p.fp.traj_to_controls(_walking_rows(step=0.0005, n=80),
                                        -1, -1, fps=25.0)
    assert controls["0"][0][6] is True
    return controls


def _controls_roundtrip(p):
    data = _walking_rows(n=6)
    controls, _ = p.fp.traj_to_controls(data, -1, -1, fps=25.0)
    traj, frames = p.fp.controls_to_traj(controls)
    assert frames == list(range(6))
    xs = [r["xyz"][0] for r in traj[1.0]]
    np.testing.assert_allclose(xs, data[:, 2], atol=1e-9)
    return traj, frames


def _interpolate_controls_densifies(p):
    rows = np.asarray([[0.0, 1.0, 0.0, 0.0, 0.0],
                       [5.0, 1.0, 1.0, 0.0, 0.0],
                       [10.0, 1.0, 2.0, 0.0, 0.0]])
    controls, _ = p.fp.traj_to_controls(rows, -1, -1, fps=25.0)
    dense = p.fp.interpolate_controls(controls, fps=25.0)
    assert set(map(int, dense.keys())) == set(range(11))
    assert dense["2"][0][2][0] == pytest.approx(0.4)
    return dense


CAMERA_CONTROLS = [_intrinsic, _depth_decode, _project_roundtrip,
                   _center_projects_to_principal_point,
                   _box_projection_and_clip, _direction_and_speed,
                   _interpolate_segment, _traj_to_controls_moving,
                   _traj_to_controls_stationary, _controls_roundtrip,
                   _interpolate_controls_densifies]


@pytest.mark.parametrize("case", CAMERA_CONTROLS,
                         ids=[c.__name__[1:] for c in CAMERA_CONTROLS])
def test_camera_and_controls_equal_jax(case):
    both(case)


def _exports(package) -> list:
    """The package's own names: no submodule (which ones are attributes
    depends on what the process imported before)."""
    return sorted(n for n, v in vars(package).items()
                  if not n.startswith("_")
                  and not isinstance(v, types.ModuleType))


def test_package_exports_the_jax_packages_names():
    import multiverse_torch.forking_paths as port
    import multiverse_torch.forking_paths.editor  # noqa: F401
    import multiverse_tpu.forking_paths as jax_fp

    assert _exports(port) == _exports(jax_fp)
    assert "CameraRig" in _exports(port) and "editor" not in _exports(port)


# ------------------------------------------------ planner + registry (test_sim)


def _sim_controls(p):
    rows = np.asarray([[0.0, 1.0, 0.0, 0.0, 0.5],
                       [1.0, 1.0, 1.0, 0.0, 0.5],
                       [2.0, 1.0, 2.0, 0.0, 0.5]])
    return p.controls.traj_to_controls(rows, -1, -1, fps=25.0)[0]


def _plan_spawn_control_destroy(p):
    controls = _sim_controls(p)
    state = p.sim.SimState()
    cmds0 = p.sim.plan_frame(0, controls, {}, state)
    assert [c.kind for c in cmds0] == ["spawn_walker", "walker_control"]
    assert cmds0[1].speed > 0 and 1.0 in state.peds
    cmds1 = p.sim.plan_frame(1, controls, {}, state)
    assert [c.kind for c in cmds1] == ["walker_control"]
    cmds2 = p.sim.plan_frame(2, controls, {}, state)
    assert [c.kind for c in cmds2] == ["destroy_walker"]
    assert 1.0 not in state.peds
    return cmds0, cmds1, cmds2, state


def _stationary_walker_gets_zero_control(p):
    rows = np.asarray([[0.0, 1.0, 0.0, 0.0, 0.5],
                       [1.0, 1.0, 0.001, 0.0, 0.5],
                       [60.0, 1.0, 0.002, 0.0, 0.5]])
    controls, _ = p.controls.traj_to_controls(rows, -1, -1, fps=25.0)
    cmds = p.sim.plan_frame(0, controls, {}, p.sim.SimState())
    ctrl = [c for c in cmds if c.kind == "walker_control"][0]
    assert ctrl.speed == 0.0 and ctrl.direction == (0.0, 0.0, 0.0)
    return cmds


def _excepts_skips_actor(p):
    cmds = p.sim.plan_frame(0, _sim_controls(p), {}, p.sim.SimState(),
                            excepts=(1.0,))
    assert cmds == []
    return cmds


def _vehicle_yaw_smoothing(p):
    state = p.sim.SimState()
    state.note_vehicle(7.0, (1.0, 0.0))
    y0 = p.sim.smoothed_yaw(state, 7.0, (1.0, 0.0, 0.0), max_yaw_change=60)
    assert y0 == pytest.approx(0.0)
    y1 = p.sim.smoothed_yaw(
        state, 7.0, (np.cos(np.radians(30)), np.sin(np.radians(30)), 0.0),
        max_yaw_change=60)
    assert y1 == pytest.approx(30.0)
    y2 = p.sim.smoothed_yaw(state, 7.0, (-1.0, 0.02, 0.0),
                            max_yaw_change=60)
    assert y2 == pytest.approx(y1)
    return y0, y1, y2, state


def _vehicle_plan_teleports(p):
    rows = np.asarray([[0.0, 9.0, 0.0, 0.0, 0.0],
                       [1.0, 9.0, 1.0, 1.0, 0.0],
                       [2.0, 9.0, 2.0, 2.0, 0.0]])
    controls, _ = p.controls.traj_to_controls(rows, -1, -1, fps=25.0,
                                              z_to=0.0)
    state = p.sim.SimState()
    cmds = p.sim.plan_frame(0, {}, controls, state)
    assert [c.kind for c in cmds] == ["spawn_vehicle", "vehicle_teleport"]
    assert cmds[1].yaw is None and cmds[1].direction is not None
    state.note_vehicle(9.0, (1.0, 0.0))
    yaw = p.sim.smoothed_yaw(state, 9.0, cmds[1].direction,
                             cmds[1].max_yaw_change)
    assert yaw == pytest.approx(45.0)
    cmds1 = p.sim.plan_frame(1, {}, controls, state)
    tele = [c for c in cmds1 if c.kind == "vehicle_teleport"]
    assert tele and tele[0].yaw == pytest.approx(45.0)
    return cmds, yaw, cmds1, state


def _scene_registry_roundtrip(p, tmp):
    path = tmp + "/registry.json"
    schema = p.scenes.scene_registry_schema()
    with open(path, "w") as f:
        json.dump(schema, f)
    reg = p.scenes.load_scene_registry(path)
    sc = reg.scenes["zara01"]
    assert sc.fps == 25.0 and sc.map == "Town03_ethucy"
    rigs = reg.recording_cameras("zara01")
    assert len(rigs) == 1 and rigs[0].intrinsic.shape == (3, 3)
    return schema, reg, [r.intrinsic for r in rigs]


def _published_calibration_registry(p):
    assert p.scenes.default_registry_path().endswith("forking_paths.json")
    assert p.name in p.scenes.default_registry_path()
    reg = p.scenes.load_default_registry()
    scenes = {"zara01", "zara02", "eth", "hotel",
              "0000", "0400", "0401", "0500"}
    assert set(reg.scenes) == scenes
    intrinsics = {}
    for name in sorted(scenes):
        rigs = reg.recording_cameras(name)
        assert len(rigs) == 4, name
        assert reg.cameras["annotation"][name][0].fov == 90.0
        for rig in rigs:
            fx = 1920.0 / (2.0 * np.tan(np.deg2rad(rig.fov) / 2.0))
            assert rig.intrinsic[0, 0] == pytest.approx(fx)
        intrinsics[name] = [r.intrinsic for r in rigs]
    assert reg.recording_cameras("zara01") == reg.recording_cameras(
        "zara02")
    assert reg.scenes["0400"].weather.sun_azimuth_angle == -20.0
    assert reg.cameras["anchor"]["zara01"][0].transform.x == \
        pytest.approx(-33.863022)
    return reg, intrinsics


SIM = [_plan_spawn_control_destroy, _stationary_walker_gets_zero_control,
       _excepts_skips_actor, _vehicle_yaw_smoothing,
       _vehicle_plan_teleports, _published_calibration_registry]


@pytest.mark.parametrize("case", SIM, ids=[c.__name__[1:] for c in SIM])
def test_planner_and_registry_equal_jax(case):
    both(case)


def test_scene_registry_roundtrip_equals_jax(tmp_path):
    both(_scene_registry_roundtrip, tmp=tmp_path)
    with open(tmp_path / "jax" / "registry.json", "rb") as a, \
            open(tmp_path / "port" / "registry.json", "rb") as b:
        assert a.read() == b.read()


def test_packaged_calibration_is_a_copy():
    from multiverse_torch.forking_paths import scenes as port
    from multiverse_tpu.forking_paths import scenes as jax_scenes

    with open(port.default_registry_path(), "rb") as a, \
            open(jax_scenes.default_registry_path(), "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------- editor (test_editor)


def _rec(pid, frame, xyz, stationary=False):
    return [float(pid), float(frame), list(xyz),
            [1.0, 0.0, 0.0], 1.0, 0.4, stationary]


def _moment(scene="0400"):
    return {
        "scenename": scene,
        "original_start_frame_id": 0,
        "ped_controls": {
            "0": [_rec(1, 0, [0, 0, 0.5]), _rec(2, 0, [5, 5, 0.5])],
            "12": [_rec(1, 12, [1, 0, 0.5]), _rec(2, 12, [5, 6, 0.5])],
            "24": [_rec(1, 24, [2, 0, 0.5], True)],
        },
        "vehicle_controls": {
            "0": [_rec(9, 0, [10, 10, 0])],
            "12": [_rec(9, 12, [11, 10, 0])],
        },
        "x_agents": {"1": [[2.0, 0.0, 0.5]]},
    }


def _editor(p):
    return p.editor.MomentEditor([_moment(), _moment("zara01")], fps=30.0)


def _cycle_toggle_save_duplicate(p):
    ed = _editor(p)
    out = [ed.cycle_moment(+1), ed.cycle_moment(+1), ed.cycle_moment(-1),
           ed.toggle_save(), set(ed.saved), ed.toggle_save(),
           ed.toggle_save_all(), set(ed.saved), ed.toggle_save_all()]
    assert out == [1, 0, 1, True, {1}, False, True, {0, 1}, False]
    ed.cur = 0
    ed.saved = {1}
    ed.duplicate_moment()
    assert len(ed.moments) == 3 and ed.saved == {2}
    assert ed.moments[1] == ed.moments[0]
    assert ed.moments[1] is not ed.moments[0]
    ed.saved = {0}
    assert ed.saved_moments() == [ed.moments[0]]
    ed.saved = set()
    assert len(ed.saved_moments()) == 3
    return out, ed


def _actor_selection_and_delete(p):
    ed = _editor(p)
    out = [ed.actor_ids(), ed.selected, ed.select_actor(+1),
           ed.select_actor(+1), ed.select_actor(+1), ed.select_actor(-1)]
    assert out[0] == [("person", 1.0), ("person", 2.0), ("vehicle", 9.0)]
    assert out[2:] == [("person", 2.0), ("vehicle", 9.0), ("person", 1.0),
                       ("vehicle", 9.0)]
    ed.selected = ("person", 1.0)
    ed.delete_selected_actor()
    assert ("person", 1.0) not in ed.actor_ids()
    assert "24" not in ed.moment["ped_controls"]
    assert "1" not in ed.moment["x_agents"]
    assert ed.selected in ed.actor_ids()
    return out, ed


def _display_toggles_and_scrub(p):
    ed = _editor(p)
    out = [ed.toggle_static(), ed.toggle_static(), ed.toggle_traj(),
           ed.total_frames(), ed.scrub(+10), ed.scrub(+100),
           ed.scrub(-100)]
    assert out == [False, True, False, 25, 10, 24, 0]
    ed.cycle_moment(+1)
    assert ed.scrub_frame == 0
    return out, ed


def _delete_last_timestep_and_add_control_point(p):
    ed = _editor(p)
    ed.selected = ("person", 1.0)
    out = [ed.last_record()]
    assert out[0][0] == 24 and out[0][1][2] == [2, 0, 0.5]
    out.append(ed.delete_last_timestep())
    assert out[-1] == 24 and "24" not in ed.moment["ped_controls"]
    out.append(ed.last_record())
    assert out[-1][0] == 12
    ed.add_control_point([4.0, 0.0, 0.5])
    f, rec = ed.last_record()
    assert f == 24 and rec[2] == [4.0, 0.0, 0.5] and rec[6] is True
    prev = [r for r in ed.moment["ped_controls"]["12"] if r[0] == 1.0][0]
    assert prev[6] is False
    np.testing.assert_allclose(prev[3], [1.0, 0.0, 0.0])
    assert prev[4] == pytest.approx(3.0 / (12 / 30.0))
    return out, ed


def _new_actor_mode_and_type(p):
    ed = _editor(p)
    out = [ed.toggle_new_actor_mode(), ed.toggle_new_actor_type()]
    assert out == [True, "vehicle"]
    ed.add_control_point([20.0, 20.0, 0.0])
    assert ed.selected == ("vehicle", 10.0) and ed.new_actor_mode is True
    assert any(r[0] == 10.0 and r[2] == [20.0, 20.0, 0.0]
               for r in ed.moment["vehicle_controls"]["0"])
    out += [ed.toggle_new_actor_type(), ed.toggle_new_actor_mode()]
    assert out[2:] == ["person", False]
    return out, ed


def _set_all_stationary(p):
    ed = _editor(p)
    n = ed.set_all_stationary("person")
    assert n == 5
    assert all(r[6] for recs in ed.moment["ped_controls"].values()
               for r in recs)
    assert not all(r[6] for recs in ed.moment["vehicle_controls"].values()
                   for r in recs)
    n2 = ed.set_all_stationary("vehicle")
    assert all(r[6] for recs in ed.moment["vehicle_controls"].values()
               for r in recs)
    return n, n2, ed


def _x_agent_ops(p):
    ed = _editor(p)
    ed.selected = ("person", 2.0)
    out = [ed.set_x_agent()]
    assert out[0] == "2" and ed.moment["x_agents"]["2"] == []
    ed.selected = ("vehicle", 9.0)
    out.append(ed.set_x_agent())
    assert out[-1] is None
    ed.selected = ("person", 1.0)
    out += [ed.delete_last_destination(), ed.delete_last_destination()]
    assert out[2:] == [[2.0, 0.0, 0.5], None]
    return out, ed


def _camera_ops(p):
    ed = _editor(p)
    p0 = ed.pose
    ed.move_camera(forward=2.0)
    assert ed.pose.x == pytest.approx(p0.x + 2.0)
    ed.move_camera(dyaw=90.0)
    ed.move_camera(forward=2.0)
    assert ed.pose.y == pytest.approx(p0.y + 2.0)
    ed.move_camera(dz=-5.0, dpitch=200.0)
    assert ed.pose.pitch == 89.9
    out = [ed.pose, ed.zoom(+5.0), ed.zoom(-300.0)]
    assert out[1:] == [95.0, 10.0]
    ed.reset_camera()
    assert ed.pose == p.camera.Transform(z=30.0, pitch=-50.0)
    assert "fov=10.0" in ed.camera_str()
    return out, ed.camera_str(), ed


def _anchor_view_uses_published_calibration(p):
    ed = _editor(p)
    ed.anchor_view()
    assert ed.pose.x == pytest.approx(-160.418839) and ed.fov == 60.0
    out = [ed.pose, ed.fov]
    ed.cycle_moment(+1)
    ed.anchor_view()
    assert ed.pose.pitch == pytest.approx(-62.999184) and ed.fov == 30.0
    return out + [ed.pose, ed.fov]


def _ops_keep_schema_replayable(p):
    ed = _editor(p)
    ed.selected = ("person", 1.0)
    ed.delete_last_timestep()
    ed.add_control_point([4.0, 0.0, 0.5])
    ed.toggle_new_actor_mode()
    ed.add_control_point([30.0, 30.0, 0.5])
    moment = copy.deepcopy(ed.moment)
    state = p.sim.SimState()
    cmds = []
    for frame in range(ed.total_frames()):
        cmds += p.sim.plan_frame(frame, moment["ped_controls"],
                                 moment["vehicle_controls"], state)
    assert cmds
    return moment, cmds


def _mixed_frame_key_spellings_delete_correct_record(p):
    m = _moment()
    m["ped_controls"]["24.0"] = m["ped_controls"].pop("24")
    m["ped_controls"]["24"] = [_rec(2, 24, [5, 7, 0.5])]
    ed = p.editor.MomentEditor([m], fps=30.0)
    ed.selected = ("person", 1.0)
    assert ed.delete_last_timestep() == 24
    assert all(float(r[0]) != 1.0
               for r in m["ped_controls"].get("24.0", []))
    assert [float(r[0]) for r in m["ped_controls"]["24"]] == [2.0]
    return m


def _fractional_pid_x_agent_keys_do_not_collide(p):
    m = _moment()
    m["ped_controls"]["0"].append(_rec(1.5, 0, [7, 7, 0.5]))
    ed = p.editor.MomentEditor([m], fps=30.0)
    ed.selected = ("person", 1.5)
    out = [ed.set_x_agent()]
    assert out[0] == "1.5"
    assert "1.5" in m["x_agents"] and m["x_agents"]["1"] == [[2.0, 0.0, 0.5]]
    ed.delete_selected_actor()
    assert "1.5" not in m["x_agents"]
    ed.selected = ("person", 1.0)
    out.append(ed.set_x_agent())
    assert out[-1] == "1"
    return out, m


EDITOR = [_cycle_toggle_save_duplicate, _actor_selection_and_delete,
          _display_toggles_and_scrub,
          _delete_last_timestep_and_add_control_point,
          _new_actor_mode_and_type, _set_all_stationary, _x_agent_ops,
          _camera_ops, _anchor_view_uses_published_calibration,
          _ops_keep_schema_replayable,
          _mixed_frame_key_spellings_delete_correct_record,
          _fractional_pid_x_agent_keys_do_not_collide]


@pytest.mark.parametrize("case", EDITOR, ids=[c.__name__[1:] for c in EDITOR])
def test_editor_equals_jax(case):
    both(case)


# -------------------------------------------------- annotation (test_annotation)


def _ann_moments():
    return [
        {"scenename": "0400",
         "x_agents": {"1": [[5.0, 0.0, 0.5], [0.0, 5.0, 0.5]],
                      "2": [[9.0, 9.0, 0.5]]}},
        {"scenename": "zara01", "x_agents": {"3": [[1.0, 1.0, 0.5]]}},
    ]


def _task_schedule(p):
    tasks = list(p.annotation.iter_annotation_tasks(_ann_moments()))
    assert tasks == [(0, 1, 0), (0, 1, 1), (0, 2, 0), (1, 3, 0)]
    return tasks


def _task_sharding(p):
    a = p.annotation
    all_tasks = list(a.iter_annotation_tasks(_ann_moments()))
    s1 = a.AnnotationSession(_ann_moments(), obs_last_frame=1, max_frame=9,
                             job=2, cur_job=1)
    s2 = a.AnnotationSession(_ann_moments(), obs_last_frame=1, max_frame=9,
                             job=2, cur_job=2)
    assert s1._tasks == all_tasks[0::2] and s2._tasks == all_tasks[1::2]
    s3 = a.AnnotationSession(_ann_moments(), obs_last_frame=1, max_frame=9,
                             start_idx=1)
    assert s3._tasks == [(1, 3, 0)]
    return s1._tasks, s2._tasks, s3._tasks


def _session_reach_and_fail(p, tmp):
    s = p.annotation.AnnotationSession(_ann_moments(), obs_last_frame=132,
                                       max_frame=456)
    out = [s.current_traj_key(), s.in_obs_phase(100), s.in_obs_phase(200)]
    assert out == ["0400_0_1_0", True, False]
    s.record(140, [1.0, 0.0, 0.0], 2.0, [2.5, 0.0, 0.5])
    out.append(s.step(140, [2.5, 0.0, 0.5]))
    s.record(150, [1.0, 0.0, 0.0], 2.0, [4.5, 0.0, 0.5])
    out.append(s.step(150, [4.5, 0.0, 0.5]))
    assert out[-2:] == ["continue", "reached"]
    assert len(s.saved["0400_0_1_0"]) == 2
    assert s.failure_counts["0400_0_1_0"] == 0
    s.record(140, [0.0, 1.0, 0.0], 2.0, [0.0, 1.0, 0.5])
    out += [s.step(140, [0.0, 1.0, 0.5], collided=True),
            s.step(999, [0.0, 1.0, 0.5]), s.step(150, [0.0, 4.0, 0.5])]
    assert out[-3:] == ["failed", "failed", "reached"]
    assert s.failure_counts["0400_0_1_1"] == 2
    out += [s.step(150, [9.0, 8.0, 0.5]), s.step(150, [1.0, 2.0, 0.5])]
    assert s.done and set(s.saved) == {
        "0400_0_1_0", "0400_0_1_1", "0400_0_2_0", "zara01_1_3_0"}
    p.annotation.save_annotation(s, tmp + "/annotation.json")
    return out, s.saved, s.failure_counts


def _editor_ops(p):
    a = p.annotation
    m = {"scenename": "0400", "x_agents": {}}
    m2 = a.add_x_agent_destination(m, 5, [1.0, 2.0, 0.5])
    m2 = a.add_x_agent_destination(m2, 5, [3.0, 4.0, 0.5])
    key = 5 if 5 in m2["x_agents"] else "5"
    assert len(m2["x_agents"][key]) == 2 and m["x_agents"] == {}
    m3 = a.remove_x_agent(m2, 5)
    assert not m3["x_agents"]
    approved = a.approve_moment(m)
    assert approved["approved"] is True
    return m2, m3, approved


def _moment_windows_and_slicing(p):
    rows = np.asarray([[float(f), 1.0, 0.1 * f, 0.0, 0.5]
                       for f in range(0, 100, 5)])
    controls, _ = p.controls.traj_to_controls(rows, -1, -1, fps=25.0,
                                              no_offset=True)
    windows = list(p.candidates.moment_windows(
        controls, moment_length_frames=50, test_skip=2))
    assert windows[0][0] == 0 and windows[0][1] >= 50
    sliced = p.candidates.slice_controls(controls, windows[1][0],
                                         windows[1][1])
    assert 0 in sliced
    rec = p.candidates.make_moment_record("vid", "0400", {}, windows[1][0],
                                          sliced, {})
    assert rec["original_start_frame_id"] == windows[1][0]
    assert rec["x_agents"] == {}
    return windows, sliced, rec


ANNOTATION = [_task_schedule, _task_sharding, _editor_ops,
              _moment_windows_and_slicing]


@pytest.mark.parametrize("case", ANNOTATION,
                         ids=[c.__name__[1:] for c in ANNOTATION])
def test_annotation_equals_jax(case):
    both(case)


def test_session_reach_and_fail_equals_jax(tmp_path):
    both(_session_reach_and_fail, tmp=tmp_path)
    with open(tmp_path / "jax" / "annotation.json", "rb") as a, \
            open(tmp_path / "port" / "annotation.json", "rb") as b:
        assert a.read() == b.read()
