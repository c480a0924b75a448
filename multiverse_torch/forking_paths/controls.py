"""Trajectory ↔ per-frame control records.

The port's copy of ``multiverse_tpu/forking_paths/controls.py``
(host numpy in both packages; the same records, to the bit).

The simulation replays recorded real-world trajectories by issuing a
(direction, speed) walker control per actor per frame.  This module
rebuilds the conversion machinery of reference:
forking_paths_dataset/code/utils.py:346-606 as vectorized numpy over
per-person arrays:

* **stationary detection**: an actor that moves < 0.08 m over the next
  2 s is flagged stationary (a parked car / standing person,
  reference: :485-525);
* **constant-velocity interpolation** densifies low-fps annotations to
  simulation fps (reference: :346-357, :360-437);
* **direction/speed** with the ×1.22 speed calibration that accounts
  for the walker acceleration ramp (reference: :583-606).

A control record is
    [person_id, ori_frame_id, xyz, direction(3), speed, dt, stationary]
and the per-moment dict maps str(frame_id) → [records] with a final
(direction=None) stop record per actor — the JSON schema the reference
toolchain reads and writes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

SPEED_CALIBRATION = 1.22     # acceleration-ramp compensation
STATIONARY_THRES = 0.08      # meters over the look-ahead window
STATIONARY_LOOKAHEAD_S = 2.0


def direction_and_speed(
    dst: np.ndarray, src: np.ndarray, fps: float
) -> Tuple[List[float], float, float]:
    """Unit xy-plane direction, calibrated speed (m/s), and Δt between
    two [frame, pid, x, y, z] rows (reference: utils.py:584-606)."""
    vec = np.array([dst[2] - src[2], dst[3] - src[3], 0.0], np.float64)
    length = float(np.sqrt((vec ** 2).sum())) + np.finfo(float).eps
    direction = [float(v / length) for v in vec]
    dt = float((dst[0] - src[0]) / fps)
    speed = length / dt * SPEED_CALIBRATION
    return direction, speed, dt


def interpolate_segment(p1: np.ndarray, p2: np.ndarray) -> List[List[float]]:
    """Constant-velocity fill of the integer frames strictly between
    two rows (reference: utils.py:346-357)."""
    out: List[List[float]] = []
    num = int(p2[0] - p1[0])
    for i in range(num - 1):
        row = [float(p1[0]) + i + 1, float(p1[1])]
        for c1, c2 in zip(p1[2:], p2[2:]):
            row.append(float(c1) + (float(c2) - float(c1)) / num * (i + 1))
        out.append(row)
    return out


def _person_rows(data: np.ndarray, pid: float) -> np.ndarray:
    return data[data[:, 1] == pid, :]


def traj_to_controls(
    data: np.ndarray,
    start_frame: float,
    end_frame: float,
    fps: float,
    interpolate: bool = False,
    z_to: Optional[float] = None,
    no_offset: bool = False,
) -> Tuple[Dict[str, list], int]:
    """[R, 5] (frame, pid, x, y, z) rows → control dict + frame count.

    reference: utils.py:454-550 `get_controls_from_traj_data` —
    frame ids are rebased to the moment start unless `no_offset`;
    `z_to` flattens vehicle z coordinates.
    """
    data = np.asarray(data, np.float64).copy()
    if z_to is not None:
        data[:, -1] = z_to

    frame_ids = sorted(np.unique(data[:, 0]).tolist())
    if start_frame == -1:
        targets = frame_ids
    else:
        if start_frame not in frame_ids:
            return {}, 0
        targets = frame_ids[
            frame_ids.index(start_frame):frame_ids.index(end_frame)]
    total_frames = int(targets[-1] - targets[0])
    data = data[np.isin(data[:, 0], targets), :]

    lookahead = fps * STATIONARY_LOOKAHEAD_S
    controls: Dict[int, list] = {}

    def emit(frame_id: int, record: list) -> None:
        controls.setdefault(frame_id, []).append(record)

    for pid in np.unique(data[:, 1]):
        rows = _person_rows(data, pid)
        if rows.shape[0] <= 1:
            continue
        if interpolate:
            dense: List[list] = []
            for i in range(rows.shape[0] - 1):
                dense.append(rows[i].tolist())
                dense.extend(interpolate_segment(rows[i], rows[i + 1]))
            dense.append(rows[-1].tolist())
            rows = np.asarray(dense, np.float64)

        # vectorized stationary flags: displacement to the first row
        # >= lookahead frames ahead
        n = rows.shape[0]
        frames = rows[:, 0]
        future = np.searchsorted(frames, frames + lookahead, side="left")
        stationary = np.zeros(n, bool)
        sticky = False
        for i in range(n - 1):
            fi = future[i]
            if fi < n:
                diff = float(np.linalg.norm(rows[fi, 2:] - rows[i, 2:]))
                stationary[i] = diff <= STATIONARY_THRES
                if stationary[i]:
                    sticky = True
            else:
                # near the end: carry the last observed state
                stationary[i] = sticky

        base = 0.0 if no_offset else targets[0]
        for i in range(n - 1):
            frame_id = int(rows[i, 0] - base)
            direction, speed, dt = direction_and_speed(
                rows[i + 1], rows[i], fps)
            emit(frame_id, [
                float(pid), float(rows[i, 0]), rows[i, 2:].tolist(),
                direction, speed, dt, bool(stationary[i]),
            ])
        emit(int(rows[-1, 0] - base), [
            float(pid), float(rows[-2, 0]), rows[-1, 2:].tolist(),
            None, None, None, None,
        ])

    return {str(k): v for k, v in controls.items()}, total_frames


def load_traj_file(traj_file: str) -> np.ndarray:
    rows = [line.strip().split("\t")
            for line in open(traj_file) if line.strip()]
    return np.asarray(rows, np.float64)


def interpolate_controls(controls: Dict[str, list],
                         fps: float) -> Dict[str, list]:
    """Densify low-fps control records to simulation fps
    (reference: utils.py:360-437): rebuild per-person trajectories,
    constant-velocity interpolate (skipped when the actor is already
    stationary at its second sample), re-emit control records."""
    rows, stat = [], []
    for frame_id in controls:
        for rec in controls[frame_id]:
            pid, _, (x, y, z) = rec[0], rec[1], rec[2]
            rows.append([int(float(frame_id)), int(pid), x, y, z])
            stat.append(rec[6])
    if not rows:
        return {}
    order = np.argsort([r[0] for r in rows], kind="stable")
    data = np.asarray(rows, np.float64)[order]
    stat = np.asarray(
        [1.0 if s else 0.0 for s in stat], np.float64)[order]

    out: Dict[int, list] = {}
    for pid in np.unique(data[:, 1]):
        sel = data[:, 1] == pid
        rows_p, stat_p = data[sel], stat[sel]
        if rows_p.shape[0] <= 1:
            continue
        if stat_p[1] != 1.0:
            dense, dense_stat = [], []
            for i in range(rows_p.shape[0] - 1):
                seg = [rows_p[i].tolist()]
                seg += interpolate_segment(rows_p[i], rows_p[i + 1])
                dense += seg
                dense_stat += [stat_p[i]] * len(seg)
            dense.append(rows_p[-1].tolist())
            dense_stat.append(stat_p[-1])
            rows_p = np.asarray(dense, np.float64)
            stat_p = np.asarray(dense_stat, np.float64)

        for i in range(rows_p.shape[0] - 1):
            frame_id = int(rows_p[i, 0])
            direction, speed, dt = direction_and_speed(
                rows_p[i + 1], rows_p[i], fps)
            out.setdefault(frame_id, []).append([
                float(pid), float(rows_p[i, 0]), rows_p[i, 2:].tolist(),
                direction, speed, dt, bool(stat_p[i]),
            ])
        out.setdefault(int(rows_p[-1, 0]), []).append([
            float(pid), float(rows_p[-2, 0]), rows_p[-1, 2:].tolist(),
            None, None, None, None,
        ])
    return {str(k): v for k, v in out.items()}


def controls_to_traj(
    controls: Dict[str, list],
) -> Tuple[Dict[float, list], List[int]]:
    """Controls → per-actor trajectory dicts + sorted frame ids
    (reference: utils.py:560-580)."""
    traj: Dict[float, list] = {}
    frames: Dict[int, int] = {}
    for frame_id in controls:
        for rec in controls[frame_id]:
            pid, _, xyz = rec[0], rec[1], rec[2]
            traj.setdefault(pid, []).append({
                "frame_id": int(float(frame_id)),
                "xyz": xyz,
                "is_stationary": rec[6],
                "speed": rec[4],
            })
            frames[int(float(frame_id))] = 1
    for pid in traj:
        traj[pid].sort(key=lambda r: r["frame_id"])
    return traj, sorted(frames)
