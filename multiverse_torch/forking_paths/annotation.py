"""Human multi-future annotation: session state machine + formats.

The port's copy of ``multiverse_tpu/forking_paths/annotation.py``
(the same schedule, state machine and saved files).

reference: forking_paths_dataset/code/annotate_carla.py — the
annotation "game" replays a moment's observation phase, hands control
of the x-agent to the annotator, and records per-frame
(direction, speed, location) controls until the agent reaches its
destination (within 2 m), restarting on collision or timeout
(:510-640).  moment_editor.py manages the moment records themselves
(approve, assign x-agent destinations via depth-backprojected clicks).

This module holds everything *behavioral* — the task schedule, the
success/failure state machine, the saved-annotation format, and the
editor's record operations — as pure, tested code.  The pygame/CARLA
interactive drivers wrap these (they require a CARLA server + display
and import lazily).

Saved annotation format (what `mvt-gen-moments` consumes):
    {traj_key: [[frame_id, direction_xyz, speed, location_xyz], ...]}
with traj_key = `scene_momentIdx_xAgentPid_destIdx`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Iterator, List, Optional, Tuple

DIST_TO_REACH = 2.0  # meters (reference: annotate_carla.py:527)


def iter_annotation_tasks(
    moment_data: List[dict],
) -> Iterator[Tuple[int, int, int]]:
    """All (moment_idx, x_agent_pid, dest_idx) tasks in schedule order
    (reference: annotate_carla.py `next_traj`)."""
    for moment_idx, moment in enumerate(moment_data):
        x_agents = moment.get("x_agents", {})
        for pid_key in sorted(x_agents, key=lambda k: float(k)):
            for dest_idx in range(len(x_agents[pid_key])):
                yield moment_idx, int(float(pid_key)), dest_idx


def traj_key(scene: str, moment_idx: int, x_agent_pid: int,
             dest_idx: int) -> str:
    return "%s_%d_%d_%d" % (scene, moment_idx, x_agent_pid, dest_idx)


@dataclasses.dataclass
class AnnotationSession:
    """One annotator's pass over the task list."""

    moment_data: List[dict]
    obs_last_frame: int           # last obs-phase frame id
    max_frame: int                # timeout frame id
    # multi-annotator sharding: start at moment start_idx, then take
    # every job-th task (1-based cur_job), so several annotator
    # processes split one moment file (reference:
    # annotate_carla.py:74-77,330-332,413,497)
    start_idx: int = 0
    job: int = 1
    cur_job: int = 1
    saved: Dict[str, list] = dataclasses.field(default_factory=dict)
    failure_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    _samples: list = dataclasses.field(default_factory=list)
    _fails: int = 0
    _tasks: Optional[list] = None
    _task_idx: int = 0

    def __post_init__(self):
        tasks = [t for t in iter_annotation_tasks(self.moment_data)
                 if t[0] >= self.start_idx]
        self._tasks = [t for i, t in enumerate(tasks)
                       if i % self.job == self.cur_job - 1]

    # -------------------------------------------------------- schedule
    @property
    def done(self) -> bool:
        return self._task_idx >= len(self._tasks)

    @property
    def current_task(self) -> Tuple[int, int, int]:
        return self._tasks[self._task_idx]

    def current_traj_key(self) -> str:
        moment_idx, pid, dest_idx = self.current_task
        scene = self.moment_data[moment_idx]["scenename"]
        return traj_key(scene, moment_idx, pid, dest_idx)

    def destination(self) -> List[float]:
        moment_idx, pid, dest_idx = self.current_task
        x_agents = self.moment_data[moment_idx]["x_agents"]
        key = pid if pid in x_agents else str(pid)
        return x_agents[key][dest_idx]

    # --------------------------------------------------------- control
    def in_obs_phase(self, frame_id: int) -> bool:
        """Replay recorded controls through the observation phase
        before handing over (reference: annotate_carla.py:636-640)."""
        return frame_id <= self.obs_last_frame

    def record(self, frame_id: int, direction_xyz: List[float],
               speed: float, location_xyz: List[float]) -> None:
        self._samples.append(
            [frame_id, list(direction_xyz), float(speed),
             list(location_xyz)])

    def step(self, frame_id: int, agent_location: List[float],
             collided: bool = False) -> str:
        """Advance the state machine: returns "continue", "reached"
        (annotation saved, next task loaded) or "failed" (samples
        cleared, attempt counter bumped)
        (reference: annotate_carla.py:574-636)."""
        dest = self.destination()
        dist = math.dist(agent_location[:3], dest[:3])
        if dist <= DIST_TO_REACH:
            key = self.current_traj_key()
            if key in self.saved:
                raise ValueError("%s annotated twice" % key)
            self.saved[key] = self._samples[:]
            self.failure_counts[key] = self._fails
            self._samples = []
            self._fails = 0
            self._task_idx += 1
            return "reached"
        if collided or frame_id > self.max_frame:
            self._samples = []
            self._fails += 1
            return "failed"
        return "continue"

    @property
    def fails(self) -> int:
        """Failed attempts at the current task."""
        return self._fails

    def skip_task(self) -> None:
        """Abandon the current task without saving (the reference
        annotator keeps retrying until success; automated drivers and
        tests need a bounded escape)."""
        self._samples = []
        self._fails = 0
        self._task_idx += 1


def save_annotation(session: AnnotationSession, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(session.saved, f)


def check_collision_with_actor(history: list) -> bool:
    """Only collisions with non-static actors restart the attempt
    (reference: annotate_carla.py:361-367 — collisions against
    `static.*` scenery are ignored).  History entries carry either a
    ("Person"/"Vehicle", track_id) tuple for tracked actors or the raw
    CARLA type_id string."""
    for event in history:
        other = event[3] if len(event) > 3 else None
        if isinstance(other, tuple):
            return True
        if isinstance(other, str) and not other.startswith("static"):
            return True
    return False


# --------------------------------------------------- editor operations


def add_x_agent_destination(moment: dict, person_id: int,
                            dest_xyz: List[float]) -> dict:
    """Click-to-add destination for an agent (reference:
    moment_editor.py click handling + depth backprojection — the
    backprojection itself is camera.pixel_to_world)."""
    from multiverse_torch.forking_paths.editor import _pid_keys

    out = dict(moment)
    x_agents = {k: list(v) for k, v in out.get("x_agents", {}).items()}
    # same key-spelling tolerance as the editor ("1" vs "1.0"), plus
    # raw non-str keys from in-memory moments
    key = None
    for cand in (person_id,) + _pid_keys(float(person_id)):
        if cand in x_agents:
            key = cand
            break
    if key is None:
        key = _pid_keys(float(person_id))[0]
    x_agents[key] = x_agents.get(key, []) + [list(dest_xyz)]
    out["x_agents"] = x_agents
    return out


def remove_x_agent(moment: dict, person_id: int) -> dict:
    out = dict(moment)
    x_agents = dict(out.get("x_agents", {}))
    x_agents.pop(person_id, None)
    x_agents.pop(str(person_id), None)
    out["x_agents"] = x_agents
    return out


def approve_moment(moment: dict) -> dict:
    """Mark a moment QA-approved (reference: moment_editor.py `o`
    keybinding)."""
    out = dict(moment)
    out["approved"] = True
    return out
