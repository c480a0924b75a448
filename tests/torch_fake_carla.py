"""A minimal in-memory fake of the `carla` 0.9.6 client API, covering
exactly what multiverse_torch.forking_paths uses — lets the CarlaAdapter,
replay validation, recording and static-scene setup run under pytest
and in chip_smoke.py without a simulator.

The port's copy of ``tests/fake_carla.py``: the same classes and
behaviour, with SPEED_CALIBRATION taken from the port's controls
module, so it imports where jax and ``multiverse_tpu`` do not.  Its
actor ids come from the module-global counter ``_ids``; reset it
(``torch_fake_carla._ids = itertools.count(1)``) to get the same ids in
two runs of one process."""

from __future__ import annotations

import dataclasses
import itertools
import sys
import types
from typing import List, Optional


@dataclasses.dataclass
class Location:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0

    def distance(self, other):
        return ((self.x - other.x) ** 2 + (self.y - other.y) ** 2
                + (self.z - other.z) ** 2) ** 0.5


@dataclasses.dataclass
class Rotation:
    pitch: float = 0.0
    yaw: float = 0.0
    roll: float = 0.0

    def get_forward_vector(self):
        import math

        return Vector3D(math.cos(math.radians(self.yaw)),
                        math.sin(math.radians(self.yaw)), 0.0)


@dataclasses.dataclass
class Vector3D:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


class Transform:
    def __init__(self, location=None, rotation=None):
        self.location = location or Location()
        self.rotation = rotation or Rotation()


class WalkerControl:
    def __init__(self):
        self.direction = Vector3D()
        self.speed = 0.0


class WeatherParameters:
    def __init__(self, **kw):
        self.params = kw


# the presets spectator.py uses (real carla exposes them as class
# attributes)
WeatherParameters.ClearSunset = WeatherParameters(preset="ClearSunset")
WeatherParameters.HardRainNoon = WeatherParameters(
    preset="HardRainNoon")


class _Extent:
    def __init__(self):
        self.x, self.y, self.z = 0.5, 0.4, 0.9


class _BoundingBox:
    def __init__(self):
        self.extent = _Extent()
        self.location = Location()


_ids = itertools.count(1)

# commanded-speed fraction a real walker covers per tick — by
# construction EXACTLY the ramp controls.SPEED_CALIBRATION offsets, so
# calibrated replays land back on the source trajectory; import the
# constant rather than duplicating it (controls.py imports no carla)
from multiverse_torch.forking_paths.controls import \
    SPEED_CALIBRATION as WALKER_SPEED_EFFICIENCY


class Image:
    """Fake sensor frame: solid-value BGRA buffer.

    `bgra` overrides the per-channel bytes — semantic-seg sensors use
    it to model CARLA's raw seg format (class id in the RED channel,
    zeros elsewhere)."""

    def __init__(self, frame, width, height, value=7, bgra=None):
        self.frame = frame
        self.width = width
        self.height = height
        px = bytes(bgra) if bgra is not None else bytes([value]) * 4
        self.raw_data = px * (width * height)


class Actor:
    def __init__(self, type_id, transform, bp=None):
        self.id = next(_ids)
        self.type_id = type_id
        self._transform = transform
        self.is_alive = True
        self.bounding_box = _BoundingBox()
        self.physics = True
        self.controls: List = []
        self._listener = None
        self.bp = bp
        self.current_control = None

    def get_transform(self):
        return self._transform

    def get_location(self):
        return self._transform.location

    def set_simulate_physics(self, flag):
        self.physics = flag

    def set_transform(self, t):
        self._transform = t

    def apply_control(self, control):
        self.controls.append(control)
        if isinstance(control, WalkerControl):
            self.current_control = control

    def listen(self, fn):
        self._listener = fn

    def stop(self):
        self.is_alive = False

    def destroy(self):
        self.is_alive = False


class Blueprint:
    def __init__(self, name):
        self.name = name
        self.attrs = {}

    def set_attribute(self, k, v):
        self.attrs[k] = v


class BlueprintLibrary:
    def filter(self, pattern):
        base = pattern.replace("*", "x")
        return [Blueprint(base + str(i)) for i in range(3)]

    def find(self, name):
        return Blueprint(name)


class World:
    def __init__(self):
        self.actors: List[Actor] = []
        self.weather = None
        self.settings = types.SimpleNamespace(
            synchronous_mode=False, fixed_delta_seconds=None)
        self.frame = 0
        self.fail_walker_spawns = 0  # test hook

    def get_blueprint_library(self):
        return BlueprintLibrary()

    def get_settings(self):
        return self.settings

    def apply_settings(self, s):
        self.settings = s

    def set_weather(self, w):
        self.weather = w

    def try_spawn_actor(self, bp, transform):
        if "walker" in bp.name and self.fail_walker_spawns > 0:
            self.fail_walker_spawns -= 1
            return None
        if "sensor.camera" in bp.name:
            type_id = bp.name
        elif "sensor" in bp.name:
            type_id = "sensor.other.collision"
        elif "walker" in bp.name:
            type_id = "walker.pedestrian"
        else:
            type_id = "vehicle.fake"
        actor = Actor(type_id, transform, bp=bp)
        self.actors.append(actor)
        return actor

    def spawn_actor(self, bp, transform, attach_to=None):
        actor = self.try_spawn_actor(bp, transform)
        assert actor is not None
        return actor

    def get_actors(self, ids=None):
        if ids is None:
            return list(self.actors)
        return [a for a in self.actors if a.id in ids]

    def tick(self):
        self.frame += 1
        # Walker kinematics in synchronous mode: integrate the active
        # WalkerControl over the fixed timestep.  The real 0.9.6 engine's
        # acceleration ramp makes walkers cover ~1/1.22 of the commanded
        # speed per tick — the behavior controls.SPEED_CALIBRATION was
        # measured to compensate — so the fake models that efficiency
        # and calibrated replays land back on the source trajectory.
        dt = self.settings.fixed_delta_seconds
        if self.settings.synchronous_mode and dt:
            for actor in self.actors:
                c = actor.current_control
                if (actor.is_alive and c is not None
                        and actor.type_id.startswith("walker")
                        and c.speed > 0.0):
                    step = c.speed / WALKER_SPEED_EFFICIENCY * dt
                    loc = actor._transform.location
                    loc.x += c.direction.x * step
                    loc.y += c.direction.y * step
                    loc.z += c.direction.z * step
        for actor in self.actors:
            if (actor.is_alive and actor._listener is not None
                    and actor.type_id.startswith("sensor.camera")):
                w = int(actor.bp.attrs.get("image_size_x", 64))
                h = int(actor.bp.attrs.get("image_size_y", 48))
                if "semantic" in actor.type_id:
                    # raw CARLA seg: class id in the RED channel
                    # (4 = pedestrian)
                    actor._listener(Image(self.frame, w, h,
                                          bgra=(0, 0, 4, 255)))
                else:
                    actor._listener(Image(self.frame, w, h, 7))
        return self.frame


class _Cmd:
    pass


class DestroyActor(_Cmd):
    def __init__(self, actor):
        self.actor = actor


class ApplyWalkerControl(_Cmd):
    def __init__(self, actor, control):
        self.actor = actor
        self.control = control


class ApplyTransform(_Cmd):
    def __init__(self, actor, transform):
        self.actor = actor
        self.transform = transform


class SpawnActor(_Cmd):
    def __init__(self, bp, transform):
        self.bp = bp
        self.transform = transform

    def then(self, other):
        self.chained = other
        return self


class SetSimulatePhysics(_Cmd):
    def __init__(self, actor, flag):
        self.actor = actor
        self.flag = flag


class FutureActor:
    pass


class _Response:
    def __init__(self, actor_id):
        self.actor_id = actor_id


class Client:
    def __init__(self, world: Optional[World] = None, port=None):
        # accept the real API's (host, port) signature too
        if isinstance(world, str):
            world = None
        self.world = world or World()
        self.applied: List[list] = []

    def get_world(self):
        return self.world

    def load_world(self, map_name):
        self.world = World()
        self.world.map_name = map_name
        return self.world

    def set_timeout(self, t):
        pass

    def apply_batch_sync(self, batch):
        self.applied.append(batch)
        responses = []
        for cmd in batch:
            if isinstance(cmd, DestroyActor):
                cmd.actor.destroy()
            elif isinstance(cmd, ApplyWalkerControl):
                cmd.actor.apply_control(cmd.control)
            elif isinstance(cmd, ApplyTransform):
                cmd.actor.set_transform(cmd.transform)
            elif isinstance(cmd, SpawnActor):
                actor = self.world.spawn_actor(cmd.bp, cmd.transform)
                responses.append(_Response(actor.id))
        return responses

    def apply_batch(self, batch):
        self.apply_batch_sync(batch)


def install() -> types.ModuleType:
    """Install this fake as the importable `carla` module; returns it.
    Callers must uninstall (tests use the fixture in
    test_torch_carla_gated).
    """
    mod = types.ModuleType("carla")
    mod.Location = Location
    mod.Rotation = Rotation
    mod.Vector3D = Vector3D
    mod.Transform = Transform
    mod.WalkerControl = WalkerControl
    mod.WeatherParameters = WeatherParameters
    command = types.ModuleType("carla.command")
    command.DestroyActor = DestroyActor
    command.ApplyWalkerControl = ApplyWalkerControl
    command.ApplyTransform = ApplyTransform
    command.SpawnActor = SpawnActor
    command.SetSimulatePhysics = SetSimulatePhysics
    command.FutureActor = FutureActor
    mod.command = command
    mod.Client = Client
    sys.modules["carla"] = mod
    return mod
