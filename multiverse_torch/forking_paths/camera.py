"""Camera geometry for the simulation toolkit — pure numpy.

The port's copy of ``multiverse_tpu/forking_paths/camera.py`` (pure
numpy in both packages; the same numbers, to the bit).

Rebuilds the math of reference:
forking_paths_dataset/code/utils.py:919-970 (intrinsic/extrinsic),
:1002-1074 (8-corner 3D→2D boxes), spectator.py:176-200
(click → 3D point via depth), with no dependency on the `carla`
package: transforms are plain dataclasses, and the batched projection
runs over [N, 3] point arrays instead of per-vertex matrix ops.

Coordinate conventions follow CARLA/UE4: x forward, y right, z up;
rotations in degrees (pitch about y, yaw about z, roll about x).  The
camera-space → image mapping permutes axes to (y, -z, x) before the
intrinsic — the UE4-to-standard-camera axis swap
(reference: utils.py:1055-1059).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Transform:
    """Location + rotation (degrees), mirroring carla.Transform."""

    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0
    roll: float = 0.0

    @classmethod
    def from_carla(cls, transform) -> "Transform":
        loc, rot = transform.location, transform.rotation
        return cls(loc.x, loc.y, loc.z, rot.pitch, rot.yaw, rot.roll)

    def matrix(self) -> np.ndarray:
        """4×4 actor-to-world matrix
        (reference: utils.py:940-970)."""
        c_y, s_y = np.cos(np.radians(self.yaw)), np.sin(np.radians(self.yaw))
        c_r, s_r = np.cos(np.radians(self.roll)), np.sin(np.radians(self.roll))
        c_p, s_p = np.cos(np.radians(self.pitch)), np.sin(
            np.radians(self.pitch))
        m = np.identity(4)
        m[:3, 3] = (self.x, self.y, self.z)
        m[0, 0] = c_p * c_y
        m[0, 1] = c_y * s_p * s_r - s_y * c_r
        m[0, 2] = -c_y * s_p * c_r - s_y * s_r
        m[1, 0] = s_y * c_p
        m[1, 1] = s_y * s_p * s_r + c_y * c_r
        m[1, 2] = -s_y * s_p * c_r + c_y * s_r
        m[2, 0] = s_p
        m[2, 1] = -c_p * s_r
        m[2, 2] = c_p * c_r
        return m


def compute_intrinsic(img_width: int, img_height: int,
                      fov: float) -> np.ndarray:
    """Pinhole intrinsic from image size + horizontal FOV (degrees)
    (reference: utils.py:930-937)."""
    k = np.identity(3)
    k[0, 2] = img_width / 2.0
    k[1, 2] = img_height / 2.0
    k[0, 0] = k[1, 1] = img_width / (2.0 * np.tan(fov * np.pi / 360.0))
    return k


def compute_extrinsic(transform: Transform) -> np.ndarray:
    """Camera-to-world 4×4 (reference: utils.py:940-970)."""
    return transform.matrix()


def parse_carla_depth(depth_image: np.ndarray) -> np.ndarray:
    """CARLA RGB-encoded depth → meters
    (reference: utils.py:919-927): R + G·256 + B·256² scaled to 1 km."""
    d = depth_image.astype(np.float32)
    normalized = (d[..., 0] + d[..., 1] * 256.0
                  + d[..., 2] * 256.0 * 256.0) / (256.0 ** 3 - 1.0)
    return 1000.0 * normalized


@dataclasses.dataclass(frozen=True)
class CameraRig:
    """A calibrated camera: pose + intrinsics."""

    transform: Transform
    width: int
    height: int
    fov: float

    @property
    def intrinsic(self) -> np.ndarray:
        return compute_intrinsic(self.width, self.height, self.fov)

    @property
    def extrinsic(self) -> np.ndarray:
        return compute_extrinsic(self.transform)


def project_points(points_world: np.ndarray, rig: CameraRig) -> np.ndarray:
    """World [N, 3] → image [N, 3] (u, v, depth).

    Batched version of the per-vertex pipeline at
    reference: utils.py:1046-1071: world → camera space via the
    inverse extrinsic, UE4 axis permute (y, −z, x), then intrinsic +
    perspective divide.  depth ≤ 0 means behind the camera.
    """
    pts = np.asarray(points_world, np.float64)
    hom = np.concatenate(
        [pts, np.ones((len(pts), 1))], axis=1)           # [N, 4]
    cam = (np.linalg.inv(rig.extrinsic) @ hom.T)[:3]      # [3, N]
    y_mz_x = np.stack([cam[1], -cam[2], cam[0]])          # [3, N]
    img = rig.intrinsic @ y_mz_x                          # [3, N]
    return np.stack(
        [img[0] / img[2], img[1] / img[2], img[2]], axis=1)


def box_vertices(extent: Sequence[float],
                 actor_transform: Transform,
                 center_offset: Sequence[float] = (0.0, 0.0, 0.0),
                 ) -> np.ndarray:
    """The 8 world-space corners of an actor's bounding box
    (reference: utils.py:1026-1052)."""
    ex, ey, ez = extent
    signs = np.array([
        (1, 1, -1), (-1, 1, -1), (-1, -1, -1), (1, -1, -1),
        (1, 1, 1), (-1, 1, 1), (-1, -1, 1), (1, -1, 1),
    ], np.float64)
    local = signs * np.array([ex, ey, ez])
    hom = np.concatenate([local, np.ones((8, 1))], axis=1)
    rt = actor_transform.matrix() @ Transform(*center_offset).matrix()
    return (rt @ hom.T)[:3].T                             # [8, 3]


def project_3d_box(extent, actor_transform: Transform,
                   rig: CameraRig,
                   center_offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    """[8, 3] projected (u, v, depth) corners
    (reference: utils.py:1026-1071 `get_3d_bbox`)."""
    return project_points(
        box_vertices(extent, actor_transform, center_offset), rig)


def to_2d_bbox(bbox_3d: np.ndarray, max_w: float,
               max_h: float) -> Optional[List[float]]:
    """[8, 3] corners → clipped [x, y, w, h], or None if any corner is
    behind the camera or the box is fully off-frame
    (reference: utils.py:1002-1023)."""
    if not np.all(bbox_3d[:, 2] > 0):
        return None
    x1 = round(float(bbox_3d[:, 0].min()), 3)
    y1 = round(float(bbox_3d[:, 1].min()), 3)
    x2 = round(float(bbox_3d[:, 0].max()), 3)
    y2 = round(float(bbox_3d[:, 1].max()), 3)
    if x1 > max_w or y1 > max_h:
        return None
    x1, y1 = max(x1, 0.0), max(y1, 0.0)
    x2, y2 = min(x2, max_w), min(y2, max_h)
    return [x1, y1, x2 - x1, y2 - y1]


def pixel_to_world(u: float, v: float, depth_m: float,
                   rig: CameraRig) -> np.ndarray:
    """Image (u, v) + metric depth → world xyz — the inverse of
    :func:`project_points` (reference: spectator.py:176-200 click→3D).
    """
    ray = np.linalg.inv(rig.intrinsic) @ np.array(
        [u, v, 1.0], np.float64)                          # (y, -z, x)/x
    y_mz_x = ray * depth_m
    cam = np.array([y_mz_x[2], y_mz_x[0], -y_mz_x[1], 1.0])
    world = rig.extrinsic @ cam
    return np.asarray(world[:3])
