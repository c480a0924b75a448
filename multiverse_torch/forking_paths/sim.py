"""Per-frame simulation stepping: control records → actor commands.

The port's copy of ``multiverse_tpu/forking_paths/sim.py`` (host
Python; ``carla`` is imported inside the adapter only).

The reference interleaves decision logic and CARLA RPC calls in one
200-line function (reference:
forking_paths_dataset/code/utils.py:680-896 `run_sim_for_one_frame`).
Here the two are split:

* :func:`plan_frame` is **pure**: given the frame's control records and
  the current :class:`SimState` it returns abstract
  :class:`SimCommand`s (spawn / destroy / walker-control / vehicle
  teleport with yaw smoothing) and mutates only the state dataclass —
  fully unit-testable without a CARLA server;
* :class:`CarlaAdapter` translates commands to `carla.command` batches,
  handles spawn failures, attaches collision sensors, and keeps the
  actor registry (imports `carla` lazily).

Faithfully reproduced behaviors: stationary actors get a zero
WalkerControl (reference: :777-782); vehicles are teleported via
ApplyTransform with physics off and the yaw change per frame clamped to
`max_yaw_change` degrees against the previous yaw (reference:
:845-895); vehicle spawn failures are tolerated and reported, walker
spawn failures optionally abort (reference: :732-739, :814-824).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np


# ------------------------------------------------------------ commands


@dataclasses.dataclass(frozen=True)
class SimCommand:
    kind: str                       # spawn_walker | destroy_walker |
    # walker_control | spawn_vehicle | destroy_vehicle | vehicle_teleport
    actor_id: float
    xyz: Optional[Tuple[float, float, float]] = None
    direction: Optional[Tuple[float, float, float]] = None
    speed: float = 0.0
    # yaw=None on a vehicle's spawn-frame teleport: the real forward
    # vector only exists after the adapter spawns the actor, so the
    # executor computes the smoothed yaw then (reference computes spawn
    # yaw post-spawn, utils.py:840-880)
    yaw: Optional[float] = 0.0
    max_yaw_change: float = 60.0


@dataclasses.dataclass
class SimState:
    """Live actors + per-vehicle orientation bookkeeping."""

    peds: Dict[float, object] = dataclasses.field(default_factory=dict)
    vehicles: Dict[float, object] = dataclasses.field(default_factory=dict)
    veh_init_forward: Dict[float, Tuple[float, float]] = \
        dataclasses.field(default_factory=dict)
    veh_prev_yaw: Dict[float, float] = dataclasses.field(
        default_factory=dict)

    def note_vehicle(self, vid: float,
                     forward_xy: Tuple[float, float]) -> None:
        self.veh_init_forward[vid] = forward_xy


def smoothed_yaw(state: SimState, vid: float, direction,
                 max_yaw_change: float) -> float:
    """Yaw of `direction` against the vehicle's initial forward vector,
    clamped to the previous yaw when the jump exceeds the limit
    (reference: utils.py:868-895)."""
    v0 = np.asarray(state.veh_init_forward[vid], np.float64)
    v1 = np.asarray(direction[:2], np.float64)
    yaw = math.degrees(math.atan2(
        v0[0] * v1[1] - v0[1] * v1[0], float(np.dot(v0, v1))))
    if vid not in state.veh_prev_yaw:
        state.veh_prev_yaw[vid] = yaw
        return yaw
    prev = state.veh_prev_yaw[vid]
    if abs(prev - yaw) > max_yaw_change:
        return prev
    state.veh_prev_yaw[vid] = yaw
    return yaw


def plan_frame(
    frame_id: int,
    ped_controls: Dict[str, list],
    vehicle_controls: Dict[str, list],
    state: SimState,
    max_yaw_change: float = 60.0,
    excepts: Tuple[float, ...] = (),
) -> List[SimCommand]:
    """Pure command planning for one frame (see module docstring)."""
    cmds: List[SimCommand] = []
    key = str(frame_id)

    for rec in ped_controls.get(key, ped_controls.get(frame_id, [])):
        pid, _, xyz, direction, speed, _, is_static = rec
        if pid in excepts:
            continue
        if direction is None:
            if pid in state.peds:
                cmds.append(SimCommand("destroy_walker", pid))
                del state.peds[pid]
            continue
        if pid not in state.peds:
            cmds.append(SimCommand("spawn_walker", pid, xyz=tuple(xyz)))
            state.peds[pid] = True
        if is_static:
            # freeze in place (reference: utils.py:777-782)
            cmds.append(SimCommand(
                "walker_control", pid, direction=(0.0, 0.0, 0.0),
                speed=0.0))
        else:
            cmds.append(SimCommand(
                "walker_control", pid, direction=tuple(direction),
                speed=float(speed)))

    for rec in vehicle_controls.get(
            key, vehicle_controls.get(frame_id, [])):
        vid, _, xyz, direction, speed, _, is_static = rec
        if direction is None:
            if vid in state.vehicles:
                cmds.append(SimCommand("destroy_vehicle", vid))
                del state.vehicles[vid]
            continue
        if vid not in state.vehicles:
            cmds.append(SimCommand("spawn_vehicle", vid, xyz=tuple(xyz)))
            state.vehicles[vid] = True
        if is_static:
            continue
        if vid not in state.veh_init_forward:
            # spawn frame: defer the yaw — the executor computes it
            # against the actor's REAL forward vector after spawning
            # (a placeholder here would poison veh_prev_yaw and the
            # clamp would keep the wrong heading for the whole moment)
            cmds.append(SimCommand(
                "vehicle_teleport", vid, xyz=tuple(xyz), yaw=None,
                direction=tuple(direction),
                max_yaw_change=max_yaw_change))
        else:
            yaw = smoothed_yaw(state, vid, direction, max_yaw_change)
            cmds.append(SimCommand(
                "vehicle_teleport", vid, xyz=tuple(xyz), yaw=yaw))
    return cmds


# ------------------------------------------------------------- adapter


class CarlaAdapter:
    """Executes :class:`SimCommand`s against a CARLA world.

    reference: utils.py:680-896 (the RPC half), :608-641
    CollisionSensor.  Requires the `carla` package at construction.
    """

    def __init__(self, world, client, walker_bps, vehicle_bps,
                 use_collision_sensors: bool = True,
                 exit_if_spawn_fail: bool = False,
                 verbose: bool = False):
        import carla  # noqa: F401  (fail fast when missing)

        self._carla = carla
        self.world = world
        self.client = client
        self.walker_bps = walker_bps
        self.vehicle_bps = vehicle_bps
        self.use_collision_sensors = use_collision_sensors
        self.exit_if_spawn_fail = exit_if_spawn_fail
        self.verbose = verbose
        self.actors: Dict[float, object] = {}
        self.collision_sensors: Dict[float, object] = {}
        self.actorid2info: Dict[int, tuple] = {}
        self.global_actor_list: List[object] = []
        self.collision_history: List[tuple] = []
        self.stats = {"vehicle_spawn_failed": False}

    # -- helpers
    def _next_bp(self, bps):
        """Round-robin blueprint pick (reference: utils.py get_bp)."""
        bp_list, idx = bps
        bp = bp_list[idx[0] % len(bp_list)]
        idx[0] += 1
        return bp

    def _on_collision(self, event, pid):
        other = event.other_actor.id
        self.collision_history.append((
            event.frame, pid, other,
            self.actorid2info.get(other, event.other_actor.type_id)))

    def execute(self, cmds: List[SimCommand],
                state: SimState) -> Optional[list]:
        """Run one frame's commands; returns the batch list applied, or
        None when a walker spawn failed and exit_if_spawn_fail is set."""
        carla = self._carla
        batch = []
        for cmd in cmds:
            if cmd.kind == "spawn_walker":
                actor = self.world.try_spawn_actor(
                    self._next_bp(self.walker_bps),
                    carla.Transform(location=carla.Location(*cmd.xyz)))
                if actor is None:
                    if self.verbose:
                        print("walker %s failed to spawn" % cmd.actor_id)
                    state.peds.pop(cmd.actor_id, None)
                    if self.exit_if_spawn_fail:
                        return None
                    continue
                self.actors[cmd.actor_id] = actor
                self.actorid2info[actor.id] = ("Person", cmd.actor_id)
                self.global_actor_list.append(actor)
                if self.use_collision_sensors:
                    bp = self.world.get_blueprint_library().find(
                        "sensor.other.collision")
                    sensor = self.world.spawn_actor(
                        bp, carla.Transform(), attach_to=actor)
                    pid = cmd.actor_id
                    sensor.listen(
                        lambda e, pid=pid: self._on_collision(e, pid))
                    self.collision_sensors[pid] = sensor
                    self.global_actor_list.append(sensor)
            elif cmd.kind == "destroy_walker":
                if cmd.actor_id in self.collision_sensors:
                    sensor = self.collision_sensors.pop(cmd.actor_id)
                    sensor.stop()
                    batch.append(carla.command.DestroyActor(sensor))
                if cmd.actor_id in self.actors:
                    batch.append(carla.command.DestroyActor(
                        self.actors.pop(cmd.actor_id)))
            elif cmd.kind == "walker_control":
                if cmd.actor_id not in self.actors:
                    continue
                control = carla.WalkerControl()
                control.direction = carla.Vector3D(*cmd.direction)
                control.speed = cmd.speed
                batch.append(carla.command.ApplyWalkerControl(
                    self.actors[cmd.actor_id], control))
            elif cmd.kind == "spawn_vehicle":
                actor = self.world.try_spawn_actor(
                    self._next_bp(self.vehicle_bps),
                    carla.Transform(location=carla.Location(*cmd.xyz)))
                if actor is None:
                    # tolerated (reference: utils.py:814-824)
                    self.stats["vehicle_spawn_failed"] = True
                    state.vehicles.pop(cmd.actor_id, None)
                    continue
                actor.set_simulate_physics(False)
                self.actors[cmd.actor_id] = actor
                self.actorid2info[actor.id] = ("Vehicle", cmd.actor_id)
                self.global_actor_list.append(actor)
                fwd = actor.get_transform().rotation.get_forward_vector()
                state.note_vehicle(cmd.actor_id, (fwd.x, fwd.y))
            elif cmd.kind == "destroy_vehicle":
                if cmd.actor_id in self.actors:
                    batch.append(carla.command.DestroyActor(
                        self.actors.pop(cmd.actor_id)))
            elif cmd.kind == "vehicle_teleport":
                if cmd.actor_id not in self.actors:
                    continue
                yaw = cmd.yaw
                if yaw is None:
                    # spawn-frame teleport: the planner deferred the
                    # yaw until the real forward vector existed
                    yaw = smoothed_yaw(state, cmd.actor_id,
                                       cmd.direction,
                                       cmd.max_yaw_change)
                batch.append(carla.command.ApplyTransform(
                    self.actors[cmd.actor_id],
                    carla.Transform(
                        location=carla.Location(*cmd.xyz),
                        rotation=carla.Rotation(
                            roll=0, pitch=0, yaw=yaw))))
        if batch:
            self.client.apply_batch_sync(batch)
        return batch

    def cleanup(self) -> None:
        """Stop sensors + destroy all spawned actors
        (reference: utils.py:553-560 cleanup_actors)."""
        carla = self._carla
        for actor in self.global_actor_list:
            if actor.type_id.startswith("sensor") and actor.is_alive:
                actor.stop()
        if self.global_actor_list:
            self.client.apply_batch(
                [carla.command.DestroyActor(a)
                 for a in self.global_actor_list])
        self.global_actor_list = []
