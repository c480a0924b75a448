"""Forking Paths dataset preparation of the port (host numpy).

The port's copies of the JAX package's ``forking_paths`` modules that
turn recorded annotations into model inputs, with no CARLA, pygame or
jax:

    controls.py      trajectory ↔ per-frame control records
    moments.py       pixel → world ground plane, annotation merging,
                     VIRAT vehicle trajectories (``yaml`` inside its
                     reader)
    prepared_data.py bbox JSONs → obs TSVs + multi-future GT pickles,
                     seg video → class-map npys (``cv2`` inside its
                     readers), split lists

The simulator, recorder and camera modules stay in the JAX package.
"""
