"""The port's pygame tools (``mvt-torch-moment-editor``,
``-spectator``, ``-annotate``'s game) against the JAX package's: the
cases of ``tests/test_interactive.py`` under SDL's dummy video driver,
each run with the JAX package over ``tests/fake_carla.py`` and with the
port over ``tests/torch_fake_carla.py`` (ids reset before each side),
the same key sequences posted before each run. Tolerance 0: the values
returned, the actors each world holds and every file written (JSON,
png screenshots and seg frames) byte-equal. Also: the three commands
stop with an ImportError naming pygame where it does not import."""

import json
import os
import sys

import numpy as np
import pytest

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
os.environ.setdefault("SDL_AUDIODRIVER", "dummy")

pygame = pytest.importorskip("pygame")

from tests.test_torch_carla_gated import _actors, _controls  # noqa: E402
from tests.toolkit_parity import both, same_tree  # noqa: E402


def _rec(pid, frame, xyz, stationary=False):
    return [float(pid), float(frame), list(xyz),
            [1.0, 0.0, 0.0], 1.0, 0.4, stationary]


def _moment(scene="0400"):
    return {
        "scenename": scene,
        "original_start_frame_id": 0,
        "ped_controls": {"0": [_rec(1, 0, [0, 0, 0.5])],
                         "4": [_rec(1, 4, [1, 0, 0.5])]},
        "vehicle_controls": {},
        "x_agents": {"1": [[500.0, 500.0, 0.5]]},
    }


def _post_keys(*keys):
    pygame.init()
    pygame.display.set_mode((64, 48))
    for k in keys:
        pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=k))


def _moment_editor(p, tmp):
    client = p.fake.Client()
    world = client.get_world()
    out = os.path.join(tmp, "edited.json")
    _post_keys(pygame.K_RIGHTBRACKET, pygame.K_n, pygame.K_o, pygame.K_g,
               pygame.K_t)
    saved = p.interactive.run_moment_editor(
        client, [_moment(), _moment("zara01")], out, width=64, height=48,
        max_ticks=3)
    assert len(saved) == 2
    with open(out) as f:
        assert json.load(f)
    dead_cams = [a for a in world.actors
                 if a.type_id.startswith("sensor.camera") and not a.is_alive]
    assert len(dead_cams) >= 2
    return saved, _actors(world)


def _moment_editor_edits_persist(p, tmp):
    client = p.fake.Client()
    _post_keys(pygame.K_f, pygame.K_x, pygame.K_z)
    saved = p.interactive.run_moment_editor(
        client, [_moment()], os.path.join(tmp, "edited.json"), width=64,
        height=48, max_ticks=2)
    m = saved[0]
    assert all(r[6] for recs in m["ped_controls"].values() for r in recs)
    assert m["x_agents"]["1"] == []
    return saved, _actors(client.get_world())


def _spectator(p, tmp):
    client = p.fake.Client()
    world = client.get_world()
    world.settings.synchronous_mode = True
    shots = os.path.join(tmp, "shots")
    _post_keys(pygame.K_r, pygame.K_F1)
    p.interactive.run_spectator(client, width=64, height=48,
                                screenshot_path=shots, max_ticks=4)
    frames = sorted(os.listdir(os.path.join(shots, "rec_0000")))
    assert frames and frames[0] == "000000.png"
    assert all(not a.is_alive for a in world.actors
               if a.type_id.startswith("sensor.camera"))
    return frames, _actors(world)


def _annotation_game(p, tmp):
    client = p.fake.Client()
    out = os.path.join(tmp, "annotation.json")
    saved = p.interactive.run_annotation_game(
        client, [_moment()], out, video_fps=10.0, obs_length=1,
        pred_length=1, annotation_fps=2.5, throttle=False, max_attempts=2)
    assert saved == {}
    with open(out) as f:
        assert json.load(f) == {}
    world = client.get_world()
    assert world.settings.synchronous_mode is False
    return saved, _actors(world), world.frame


def _spectator_cli_presets(p, tmp):
    p.interactive.spectator_main([
        "--width", "64", "--height", "48", "--go_to_anchor", "0400",
        "--weather_night", "--save_screenshot_path",
        os.path.join(tmp, "shots"), "--max_ticks", "2"])
    import carla

    assert carla.WeatherParameters.ClearSunset.params[
        "preset"] == "ClearSunset"


def _spectator_cli_go_to_scene(p, tmp):
    p.interactive.spectator_main([
        "--width", "64", "--height", "48", "--go_to_scene", "0401",
        "--go_to_camera_num", "2", "--save_screenshot_path",
        os.path.join(tmp, "shots"), "--max_ticks", "2"])
    rig = p.scenes.load_default_registry().cameras["recording"]["0401"][2]
    assert rig.fov > 0
    return rig


def _spectator_seg_and_bbox_capture(p, tmp):
    import cv2

    client = p.fake.Client()
    world = client.get_world()
    world.settings.synchronous_mode = True
    adapter = p.sim.CarlaAdapter(
        world, client,
        (world.get_blueprint_library().filter("walker.pedestrian.*"), [0]),
        (world.get_blueprint_library().filter("vehicle.*"), [0]))
    ped = _controls(p, [[0, 1, 10, 0, 0.5], [5, 1, 11, 0, 0.5]])
    adapter.execute(p.sim.plan_frame(0, ped, {}, p.sim.SimState()),
                    p.sim.SimState())
    seg_dir = os.path.join(tmp, "seg")
    bbox_json = os.path.join(tmp, "boxes.json")
    _post_keys(pygame.K_r)
    p.interactive.run_spectator(
        client, width=64, height=48, screenshot_path=os.path.join(
            tmp, "shots"), max_ticks=3, save_seg_path=seg_dir,
        save_bbox_json=bbox_json, seg_as_img=True)
    segs = sorted(os.listdir(seg_dir))
    assert segs and segs[0] == "000000.png"
    assert cv2.imread(os.path.join(seg_dir, segs[0])).shape == (48, 64, 3)
    with open(bbox_json) as f:
        boxes = json.load(f)
    assert any(b["class_name"] == "Person"
               for frame_boxes in boxes.values() for b in frame_boxes)
    return boxes, _actors(world)


CASES = [_moment_editor, _moment_editor_edits_persist, _spectator,
         _annotation_game, _spectator_cli_presets,
         _spectator_cli_go_to_scene, _spectator_seg_and_bbox_capture]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[1:] for c in CASES])
def test_interactive_equals_jax(case, tmp_path):
    both(case, carla=True, tmp=tmp_path)
    same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


COMMANDS = ["annotate_main", "spectator_main", "moment_editor_main"]


@pytest.mark.parametrize("main", COMMANDS)
def test_command_without_pygame_raises(main, tmp_path, monkeypatch):
    from multiverse_torch.forking_paths import interactive
    from tests.toolkit_parity import install_fake

    install_fake("multiverse_torch")
    monkeypatch.setitem(sys.modules, "pygame", None)
    argv = [] if main == "spectator_main" else [
        str(tmp_path / "moments.json"), str(tmp_path / "out.json")]
    try:
        with pytest.raises(ImportError) as err:
            getattr(interactive, main)(argv)
    finally:
        sys.modules.pop("carla", None)
    command = "mvt-torch-" + main[:-5].replace("_", "-")
    assert err.value.name == "pygame" and command in str(err.value)
    assert os.listdir(tmp_path) == []


def test_loop_frames_are_images():
    """The dummy driver's surfaces carry the fake sensor's pixels."""
    from multiverse_torch.forking_paths.interactive import _pygame_surface
    from tests import torch_fake_carla

    pygame.init()
    try:
        surf = _pygame_surface(pygame, torch_fake_carla.Image(0, 8, 4, 7))
        arr = pygame.surfarray.array3d(surf)
    finally:
        pygame.quit()
    assert arr.shape == (8, 4, 3) and np.all(arr == 7)
