"""Scene & camera calibration registry.

The port's copy of ``multiverse_tpu/forking_paths/scenes.py``, with its
own copy of the packaged calibration (``calibration/forking_paths.json``
beside this module); ``carla`` is imported inside the two functions
that talk to a world, as there.

The reference hard-codes per-scene static configuration (weather, map,
simulation fps, parked cars) and hand-calibrated camera transforms as
Python dicts (reference: forking_paths_dataset/code/utils.py:80-332
`static_scenes` / `anchor_cameras` / `recording_cameras` /
`annotation_cameras`).  Those numbers are dataset artifacts — they
define the released benchmark's viewpoints — so here they live in JSON
files with a typed loader instead of source constants.  The published
calibration for the 7 benchmark scenes (+ the zara02→zara01 alias)
ships with the package at ``calibration/forking_paths.json`` (values
extracted mechanically from the reference tables; they are dataset
constants, not code) and is the default registry; users may point the
tools at their own file in the same format.

Schema (one JSON object):
    {
      "scenes": {
        "<scene>": {
          "map": "Town05_actev",
          "fps": 30.0,
          "weather": {"cloudyness": 20.0, "precipitation": 0.0,
                      "precipitation_deposits": 0.0,
                      "sun_altitude_angle": 65.0,
                      "sun_azimuth_angle": 150.0,
                      "wind_intensity": 0.0},
          "static_cars": [{"bp": "vehicle.tesla.model3",
                           "location_xyz": [x, y, z],
                           "rotation_pyr": [pitch, yaw, roll]}, ...]
        }, ...
      },
      "cameras": {
        "recording": {"<scene>": [{"location_xyz": [...],
                                   "rotation_pyr": [...],
                                   "width": 1920, "height": 1080,
                                   "fov": 90.0}, ... 4 views]},
        "anchor": {...}, "annotation": {...}
      }
    }
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

from multiverse_torch.forking_paths.camera import CameraRig, Transform


@dataclasses.dataclass(frozen=True)
class Weather:
    cloudyness: float = 0.0
    precipitation: float = 0.0
    precipitation_deposits: float = 0.0
    sun_altitude_angle: float = 70.0
    sun_azimuth_angle: float = 150.0
    wind_intensity: float = 0.0


# "some puddle on the ground makes the scene look perceptually more
# real" — the published --use_alter_weather parameter set
# (reference: forking_paths_dataset/code/utils.py:70-77)
REALISM_WEATHER = Weather(
    cloudyness=20.0,
    precipitation=0.0,
    precipitation_deposits=60.0,
    sun_altitude_angle=65.0,
    sun_azimuth_angle=20.0,
    wind_intensity=80.0,
)


@dataclasses.dataclass(frozen=True)
class StaticCar:
    bp: str
    location_xyz: tuple
    rotation_pyr: tuple


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    name: str
    map: str
    fps: float
    weather: Weather
    static_cars: tuple = ()


@dataclasses.dataclass(frozen=True)
class SceneRegistry:
    scenes: Dict[str, SceneConfig]
    cameras: Dict[str, Dict[str, List[CameraRig]]]

    def recording_cameras(self, scene: str) -> List[CameraRig]:
        return self.cameras.get("recording", {}).get(scene, [])


def _rig_from_dict(d: dict) -> CameraRig:
    x, y, z = d["location_xyz"]
    pitch, yaw, roll = d["rotation_pyr"]
    return CameraRig(
        Transform(x=x, y=y, z=z, pitch=pitch, yaw=yaw, roll=roll),
        width=int(d.get("width", 1920)),
        height=int(d.get("height", 1080)),
        fov=float(d.get("fov", 90.0)),
    )


def default_registry_path() -> str:
    """The packaged Forking Paths calibration (reference:
    forking_paths_dataset/code/utils.py:80-332)."""
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "calibration", "forking_paths.json")


def load_default_registry() -> "SceneRegistry":
    return load_scene_registry(default_registry_path())


def load_scene_registry(path: str) -> SceneRegistry:
    with open(path) as f:
        raw = json.load(f)
    scenes = {}
    for name, sc in raw.get("scenes", {}).items():
        scenes[name] = SceneConfig(
            name=name,
            map=sc["map"],
            fps=float(sc.get("fps", 30.0)),
            weather=Weather(**sc.get("weather", {})),
            static_cars=tuple(
                StaticCar(c["bp"], tuple(c["location_xyz"]),
                          tuple(c["rotation_pyr"]))
                for c in sc.get("static_cars", [])),
        )
    cameras: Dict[str, Dict[str, List[CameraRig]]] = {}
    for group, per_scene in raw.get("cameras", {}).items():
        cameras[group] = {
            scene: [_rig_from_dict(c) for c in rigs]
            for scene, rigs in per_scene.items()
        }
    return SceneRegistry(scenes=scenes, cameras=cameras)


def scene_registry_schema() -> dict:
    """A minimal example registry documenting the expected format."""
    return {
        "scenes": {
            "zara01": {
                "map": "Town03_ethucy",
                "fps": 25.0,
                "weather": dataclasses.asdict(Weather()),
                "static_cars": [],
            }
        },
        "cameras": {
            "recording": {
                "zara01": [
                    {"location_xyz": [0.0, 0.0, 20.0],
                     "rotation_pyr": [-45.0, 0.0, 0.0],
                     "width": 1920, "height": 1080, "fov": 90.0}
                ]
            }
        },
    }


def apply_weather(world, weather: Weather) -> None:
    """Set CARLA weather (reference: utils.py:644-655 setup_static)."""
    import carla

    world.set_weather(carla.WeatherParameters(
        cloudyness=weather.cloudyness,
        precipitation=weather.precipitation,
        precipitation_deposits=weather.precipitation_deposits,
        sun_altitude_angle=weather.sun_altitude_angle,
        sun_azimuth_angle=weather.sun_azimuth_angle,
        wind_intensity=weather.wind_intensity))


def spawn_static_cars(world, client, scene: SceneConfig,
                      actor_list: list) -> None:
    """Physics-less parked cars (reference: utils.py:656-676)."""
    import carla

    cmds = []
    for car in scene.static_cars:
        bp = world.get_blueprint_library().find(car.bp)
        cmds.append(carla.command.SpawnActor(
            bp, carla.Transform(
                location=carla.Location(*car.location_xyz),
                rotation=carla.Rotation(
                    pitch=car.rotation_pyr[0], yaw=car.rotation_pyr[1],
                    roll=car.rotation_pyr[2]))
        ).then(carla.command.SetSimulatePhysics(
            carla.command.FutureActor, False)))
    if cmds:
        response = client.apply_batch_sync(cmds)
        actor_list += list(world.get_actors(
            [r.actor_id for r in response]))
