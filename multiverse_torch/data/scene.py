"""Scene semantic-segmentation inputs: ADE20k id remap and one-hot masks.

The port's copy of the three numpy helpers of
``multiverse_tpu/data/scene.py`` (that package imports jax at load
time), used by multi-future inference and by preprocessing.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np


def load_scene_id_map(scene_id2name_path: str) -> Tuple[Dict[int, int], int]:
    """Load the {"oldid2new", "id2name"} json and return (old id -> new
    id map incl. background 0, total class count)."""
    with open(scene_id2name_path, "r") as f:
        data = json.load(f)
    oldid2new = {int(k): int(v) for k, v in data["oldid2new"].items()}
    if 0 in oldid2new:
        raise ValueError("scene id map must not remap background id 0")
    oldid2new[0] = 0
    return oldid2new, len(oldid2new)


def remap_table(oldid2new: Dict[int, int], max_id: int = 256) -> np.ndarray:
    """Lookup table for the old -> new remap; unknown ids -> background 0."""
    table = np.zeros(max_id + 1, dtype=np.int32)
    for old, new in oldid2new.items():
        if old <= max_id:
            table[old] = new
    return table


def scene_class_map_to_onehot(
    class_map: np.ndarray,
    table: np.ndarray,
    num_classes: int,
) -> np.ndarray:
    """[..., H, W] int class map -> [..., H, W, C] uint8 one-hot masks."""
    clipped = np.clip(class_map.astype(np.int64), 0, len(table) - 1)
    new_ids = table[clipped]
    return (
        new_ids[..., None] == np.arange(num_classes, dtype=np.int64)
    ).astype(np.uint8)
