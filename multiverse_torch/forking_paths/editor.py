"""Moment-editor core: every edit operation as a pure state machine.

The port's copy of ``multiverse_tpu/forking_paths/editor.py`` (pure
Python, the same edits).

The reference's scenario editor/QA GUI (reference:
forking_paths_dataset/code/moment_editor.py, keybinding doc :138-172)
mixes edit logic into a 1285-line pygame/carla loop.  Here each
keybinding's effect lives on :class:`MomentEditor` — pure Python over
the moment-record schema (see moments.py) and a camera state — so the
whole surface is unit-testable headlessly; the pygame driver in
interactive.py is a thin dispatcher.

Keybinding parity table (reference moment_editor.py:138-172 → method):

    Camera control
      r        reset camera transform            reset_camera
      n / m    zoom out / in (fov ±5, the GUI
               rebuilds the camera actors like
               reference set_camera_fov :104-136) zoom
      w/a/s/d  camera move (ground plane)        move_camera
      u / i    camera down / up                  move_camera(dz=∓)
      arrows   camera yaw / pitch                move_camera(dyaw/dpitch)
      t        show current camera transform     camera_str

    Moment high-level
      [ / ]    cycle moments                     cycle_moment
      p        toggle saving this moment         toggle_save
      o        save all / unsave all             toggle_save_all
      l        duplicate current moment          duplicate_moment
      v        go to anchor view                 anchor_view

    Moment editing
      , / .    cycle selected actor              select_actor
      backspace delete selected actor            delete_selected_actor
      space    toggle showing static actors      toggle_static
      enter    toggle showing trajectories       toggle_traj

    Actor trajectory editing
      q        delete the current last timestep  delete_last_timestep
      click    add control point @ clicked 3D    add_control_point
      e        toggle new-actor-on-click mode    toggle_new_actor_mode
      1        toggle car/person for new actors  toggle_new_actor_type
      f / c    set all person / vehicle control
               points stationary                 set_all_stationary
      - / =    scrub replay frame back / forward scrub

    Play
      g        replay the moment                 (GUI: replay())

    Annotation related
      x        set selected actor as x-agent     set_x_agent
      z        delete the last destination       delete_last_destination
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import List, Optional, Tuple

from multiverse_torch.forking_paths.camera import Transform

DEFAULT_POSE = Transform(z=30.0, pitch=-50.0)
FOV_STEP = 5.0
FOV_MIN, FOV_MAX = 10.0, 170.0


def _controls(moment: dict, kind: str) -> dict:
    key = "ped_controls" if kind == "person" else "vehicle_controls"
    return moment.setdefault(key, {})


def _pid_keys(pid: float) -> Tuple[str, ...]:
    """Candidate x_agents keys for a pid.  JSON keys are strings and
    the reference resets them to int spellings
    (reference: annotate_carla.py:392-400), so an integral pid maps to
    "1" (with "1.0" tolerated from hand-edited files); a fractional
    pid keeps its own spelling and never collides with an integral
    pid's key."""
    if float(pid) == int(pid):
        return (str(int(pid)), str(float(pid)))
    return (str(pid),)


def _actor_frames(controls: dict, pid: float) -> List[int]:
    """Sorted frame ids at which `pid` has a control record."""
    return sorted(
        int(float(f)) for f, recs in controls.items()
        if any(float(r[0]) == float(pid) for r in recs))


@dataclasses.dataclass
class MomentEditor:
    """Editor state over a list of moment records."""

    moments: List[dict]
    fps: float = 30.0
    cur: int = 0
    saved: set = dataclasses.field(default_factory=set)
    selected: Optional[Tuple[str, float]] = None   # (kind, pid)
    show_static: bool = True
    show_traj: bool = True
    new_actor_mode: bool = False
    new_actor_type: str = "person"                 # or "vehicle"
    scrub_frame: int = 0
    pose: Transform = DEFAULT_POSE
    fov: float = 90.0

    def __post_init__(self):
        if self.moments and self.selected is None:
            ids = self.actor_ids()
            if ids:
                self.selected = ids[0]

    # ------------------------------------------------------ moments
    @property
    def moment(self) -> dict:
        return self.moments[self.cur]

    def cycle_moment(self, delta: int) -> int:
        """`[` / `]` — select the previous/next moment."""
        self.cur = (self.cur + delta) % len(self.moments)
        self.scrub_frame = 0
        ids = self.actor_ids()
        self.selected = ids[0] if ids else None
        return self.cur

    def toggle_save(self) -> bool:
        """`p` — toggle whether the current moment is kept on save."""
        if self.cur in self.saved:
            self.saved.discard(self.cur)
            return False
        self.saved.add(self.cur)
        return True

    def toggle_save_all(self) -> bool:
        """`o` — save all moments, or unsave all if all are saved."""
        if len(self.saved) == len(self.moments):
            self.saved.clear()
            return False
        self.saved = set(range(len(self.moments)))
        return True

    def duplicate_moment(self) -> int:
        """`l` — deep-copy the current moment after itself."""
        self.moments.insert(self.cur + 1, copy.deepcopy(self.moment))
        # saved indices after the insertion point shift by one
        self.saved = {i if i <= self.cur else i + 1 for i in self.saved}
        return self.cur + 1

    def saved_moments(self) -> List[dict]:
        """The moments marked for saving (all if none marked)."""
        if not self.saved:
            return list(self.moments)
        return [m for i, m in enumerate(self.moments) if i in self.saved]

    # ------------------------------------------------------- actors
    def actor_ids(self) -> List[Tuple[str, float]]:
        out = []
        for kind in ("person", "vehicle"):
            controls = _controls(self.moment, kind)
            pids = {float(r[0]) for recs in controls.values()
                    for r in recs}
            out.extend((kind, pid) for pid in sorted(pids))
        return out

    def select_actor(self, delta: int) -> Optional[Tuple[str, float]]:
        """`,` / `.` — cycle the selected actor."""
        ids = self.actor_ids()
        if not ids:
            self.selected = None
            return None
        if self.selected not in ids:
            self.selected = ids[0]
            return self.selected
        i = ids.index(self.selected)
        self.selected = ids[(i + delta) % len(ids)]
        return self.selected

    def delete_selected_actor(self) -> Optional[Tuple[str, float]]:
        """backspace — remove every record of the selected actor."""
        if self.selected is None:
            return None
        kind, pid = self.selected
        controls = _controls(self.moment, kind)
        for f in list(controls):
            controls[f] = [r for r in controls[f]
                           if float(r[0]) != pid]
            if not controls[f]:
                del controls[f]
        if kind == "person":
            for key in _pid_keys(pid):
                self.moment.get("x_agents", {}).pop(key, None)
        removed = self.selected
        self.select_actor(0)
        return removed

    def toggle_static(self) -> bool:
        """space — toggle display of stationary actors."""
        self.show_static = not self.show_static
        return self.show_static

    def toggle_traj(self) -> bool:
        """enter — toggle trajectory overlay."""
        self.show_traj = not self.show_traj
        return self.show_traj

    # -------------------------------------------- trajectory editing
    def last_record(self) -> Optional[Tuple[int, list]]:
        """(frame, record) of the selected actor's last control."""
        if self.selected is None:
            return None
        kind, pid = self.selected
        controls = _controls(self.moment, kind)
        frames = _actor_frames(controls, pid)
        if not frames:
            return None
        f = frames[-1]
        for key in (str(f), str(float(f)), f):
            if key in controls:
                recs = [r for r in controls[key]
                        if float(r[0]) == pid]
                if recs:
                    return f, recs[-1]
        return None

    def _key_for_frame(self, controls: dict, frame: int):
        for key in (str(frame), str(float(frame)), frame):
            if key in controls:
                return key
        return str(frame)

    def delete_last_timestep(self) -> Optional[int]:
        """`q` — drop the selected actor's last control point."""
        last = self.last_record()
        if last is None:
            return None
        f, rec = last
        kind, pid = self.selected
        controls = _controls(self.moment, kind)
        # delete from the key the record actually lives under — with
        # mixed key spellings ("30" and "30.0" both present)
        # _key_for_frame alone could pick the other list
        for key in (str(f), str(float(f)), f):
            if key in controls and any(r is rec for r in controls[key]):
                controls[key] = [r for r in controls[key] if r is not rec]
                if not controls[key]:
                    del controls[key]
                return f
        return None

    def add_control_point(self, xyz: List[float]) -> Tuple[str, float]:
        """click — extend the selected actor's trajectory to `xyz`
        (or spawn a new actor there when new_actor_mode is on).

        The appended record matches the moment schema
        ([pid, ori_frame, xyz, direction, speed, time_elapsed,
        is_stationary], controls.py) with direction/speed derived from
        the previous point at the native frame gap.
        """
        if self.new_actor_mode or self.selected is None:
            return self.spawn_actor(xyz)
        kind, pid = self.selected
        controls = _controls(self.moment, kind)
        last = self.last_record()
        if last is None:
            return self.spawn_actor(xyz, pid=pid, kind=kind)
        f, rec = last
        prev_xyz = [float(v) for v in rec[2]]
        frames = _actor_frames(controls, pid)
        gap = (frames[-1] - frames[-2]) if len(frames) > 1 else \
            max(1, int(round(self.fps / 2.5)))
        dt = gap / self.fps
        delta = [xyz[i] - prev_xyz[i] for i in range(3)]
        dist = math.sqrt(sum(d * d for d in delta[:2]))
        speed = dist / dt if dt > 0 else 0.0
        direction = ([d / dist for d in delta[:2]] + [0.0]) \
            if dist > 1e-9 else [0.0, 0.0, 0.0]
        # the previous last point now moves toward the new one
        rec[3] = direction
        rec[4] = speed
        rec[5] = dt
        rec[6] = False
        new_frame = f + gap
        key = self._key_for_frame(controls, new_frame)
        controls.setdefault(key, []).append([
            float(pid), float(rec[1]) + gap, [float(v) for v in xyz],
            [0.0, 0.0, 0.0], 0.0, dt, True,
        ])
        return (kind, pid)

    def spawn_actor(self, xyz: List[float], pid: Optional[float] = None,
                    kind: Optional[str] = None) -> Tuple[str, float]:
        """`e` + click — create a new actor at the clicked point."""
        kind = kind or self.new_actor_type
        if pid is None:
            existing = [p for _, p in self.actor_ids()]
            pid = (max(existing) + 1.0) if existing else 1.0
        controls = _controls(self.moment, kind)
        controls.setdefault("0", []).append([
            float(pid), 0.0, [float(v) for v in xyz],
            [0.0, 0.0, 0.0], 0.0, 1.0 / self.fps, True,
        ])
        self.selected = (kind, float(pid))
        return self.selected

    def toggle_new_actor_mode(self) -> bool:
        """`e` — next click spawns an actor instead of a waypoint."""
        self.new_actor_mode = not self.new_actor_mode
        return self.new_actor_mode

    def toggle_new_actor_type(self) -> str:
        """`1` — new actors are cars or persons."""
        self.new_actor_type = (
            "vehicle" if self.new_actor_type == "person" else "person")
        return self.new_actor_type

    def set_all_stationary(self, kind: str) -> int:
        """`f` (person) / `c` (vehicle) — mark every control point of
        that kind stationary."""
        controls = _controls(self.moment, kind)
        n = 0
        for recs in controls.values():
            for r in recs:
                r[6] = True
                n += 1
        return n

    def scrub(self, delta: int, total_frames: Optional[int] = None
              ) -> int:
        """`-` / `=` — step the displayed replay frame."""
        hi = total_frames if total_frames is not None else \
            self.total_frames()
        self.scrub_frame = max(0, min(self.scrub_frame + delta,
                                      max(0, hi - 1)))
        return self.scrub_frame

    def total_frames(self) -> int:
        frames = [int(float(f))
                  for f in _controls(self.moment, "person")] + \
                 [int(float(f))
                  for f in _controls(self.moment, "vehicle")]
        return (max(frames) + 1) if frames else 0

    # ---------------------------------------------------- annotation
    def set_x_agent(self) -> Optional[str]:
        """`x` — mark the selected person as an x-agent."""
        if self.selected is None or self.selected[0] != "person":
            return None
        keys = _pid_keys(self.selected[1])
        x_agents = self.moment.setdefault("x_agents", {})
        for key in keys:  # reuse an existing spelling before creating
            if key in x_agents:
                return key
        x_agents[keys[0]] = []
        return keys[0]

    def delete_last_destination(self) -> Optional[List[float]]:
        """`z` — pop the selected x-agent's last destination."""
        if self.selected is None or self.selected[0] != "person":
            # pids are per-kind: a selected vehicle sharing a person's
            # pid must not touch that person's x-agent entry
            return None
        x_agents = self.moment.get("x_agents", {})
        for key in _pid_keys(self.selected[1]):
            if key in x_agents and x_agents[key]:
                return x_agents[key].pop()
        return None

    # -------------------------------------------------------- camera
    def reset_camera(self) -> Transform:
        """`r` — reset the camera transform."""
        self.pose = DEFAULT_POSE
        return self.pose

    def move_camera(self, dx=0.0, dy=0.0, dz=0.0, dyaw=0.0,
                    dpitch=0.0, forward=0.0, strafe=0.0) -> Transform:
        """w/a/s/d/u/i/arrows — move/rotate; forward/strafe are in the
        camera's yaw frame (reference moment_editor camera movement)."""
        rad = math.radians(self.pose.yaw)
        dx += forward * math.cos(rad) - strafe * math.sin(rad)
        dy += forward * math.sin(rad) + strafe * math.cos(rad)
        self.pose = Transform(
            x=self.pose.x + dx, y=self.pose.y + dy, z=self.pose.z + dz,
            pitch=max(-89.9, min(89.9, self.pose.pitch + dpitch)),
            yaw=self.pose.yaw + dyaw, roll=self.pose.roll)
        return self.pose

    def zoom(self, delta_fov: float) -> float:
        """`n` / `m` — change fov; the GUI must rebuild the camera
        actors with the new fov (reference set_camera_fov :104-136,
        sensor fov is immutable after spawn)."""
        self.fov = max(FOV_MIN, min(FOV_MAX, self.fov + delta_fov))
        return self.fov

    def anchor_view(self, registry=None) -> Transform:
        """`v` — jump to the scene's published anchor viewpoint."""
        scene = self.moment.get("scenename")
        if registry is None:
            from multiverse_torch.forking_paths.scenes import (
                load_default_registry,
            )
            registry = load_default_registry()
        rigs = registry.cameras.get("anchor", {}).get(scene, [])
        if rigs:
            self.pose = rigs[0].transform
            self.fov = rigs[0].fov
        return self.pose

    def camera_str(self) -> str:
        """`t` — printable current camera transform."""
        p = self.pose
        return ("Transform(x=%.3f, y=%.3f, z=%.3f, pitch=%.3f, "
                "yaw=%.3f, roll=%.3f) fov=%.1f"
                % (p.x, p.y, p.z, p.pitch, p.yaw, p.roll, self.fov))
