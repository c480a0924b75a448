"""Forking Paths dataset toolkit of the port: simulation-side data
creation and preparation (host numpy, with no jax).

The port's copies of the JAX package's ``forking_paths`` modules, with
the same names, arguments and files:

    camera.py        pure-numpy camera geometry (intrinsics,
                     extrinsics, depth decoding, 8-corner 3D→2D boxes,
                     pixel→world backprojection)
    controls.py      trajectory ↔ per-frame control records
    scenes.py        static scene/camera calibration registry (JSON;
                     the packaged copy in ``calibration/``)
    sim.py           the per-frame simulation step + sensors
                     (``carla`` inside the adapter only)
    candidates.py    moment windows + their replay validation
    annotation.py    the annotation session state machine and format
    editor.py        the moment editor's edit operations
    recorder.py      the 4-camera dataset renderer (``carla``, ``cv2``)
    interactive.py   the pygame tools: annotation game, spectator,
                     moment editor (``pygame`` inside functions only)
    moments.py       pixel → world ground plane, annotation merging,
                     VIRAT vehicle trajectories (``yaml`` inside its
                     reader)
    prepared_data.py bbox JSONs → obs TSVs + multi-future GT pickles,
                     seg video → class-map npys (``cv2`` inside its
                     readers), split lists

Every module imports without ``carla``, ``pygame``, ``cv2`` or
``yaml``; the tools that talk to a world need a CARLA 0.9.6 server
(or the in-memory fake of the tests).
"""

from multiverse_torch.forking_paths.camera import (  # noqa: F401
    CameraRig,
    Transform,
    compute_extrinsic,
    compute_intrinsic,
    parse_carla_depth,
    pixel_to_world,
    project_3d_box,
    project_points,
    to_2d_bbox,
)
from multiverse_torch.forking_paths.controls import (  # noqa: F401
    SPEED_CALIBRATION,
    controls_to_traj,
    direction_and_speed,
    interpolate_controls,
    interpolate_segment,
    traj_to_controls,
)
