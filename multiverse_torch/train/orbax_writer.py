"""Checkpoint steps in the JAX package's orbax layout, written with no
orbax or tensorstore.

The inverse of :func:`.orbax_reader.read_params_tree`, and the port's
counterpart of the ``ocp.args.StandardSave({"params": params})`` that
``multiverse_tpu/train/checkpoints.py`` saves with: one directory per
step, ``<save|best>/<step>/``, holding

* ``_CHECKPOINT_METADATA``: the item handler orbax restores ``default``
  with, the init and commit times, and ``custom_metadata``, which
  orbax keeps and does not read; the port marks its own steps there
  (:data:`WRITTEN_BY`), so that it removes no step it did not write;
* ``default/_METADATA``: the saved tree, every key a dict key, every
  leaf a ``jax.Array`` of its shape, zarr v2 in OCDBT;
* ``default/array_metadatas/process_0``: each array's write and chunk
  shape, as orbax lists them;
* ``default/manifest.ocdbt`` and ``default/d/``: one OCDBT database
  (:func:`.ocdbt.write_database`) holding, for each leaf,
  ``params.<dotted path>/.zarray`` (uncompressed, C order, one chunk
  the array's shape) and that chunk (``params.<dotted path>/0.0...``).

A step is written under ``<step>.orbax-checkpoint-tmp-<n>`` and renamed
when whole, as orbax does, so no reader (the port's ``list_steps``,
orbax's ``CheckpointManager``) ever sees half a step. Leaves are the
port's parameters, float32; any other dtype is refused, never cast.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Mapping, Tuple

import numpy as np

from multiverse_torch.train.ocdbt import write_database

# what orbax's StandardSave names as the handler of the "default" item
STANDARD_HANDLER = ("orbax.checkpoint._src.handlers."
                    "standard_checkpoint_handler.StandardCheckpointHandler")
# the mark in custom_metadata of a step the port wrote
WRITTEN_BY = {"written_by": "multiverse_torch"}
TMP_SUFFIX = ".orbax-checkpoint-tmp-"
_DICT_KEY = 2
_F32 = np.dtype("<f4")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], np.ndarray]]:
    """(path, array) of every leaf, by path."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if not isinstance(key, str) or not key or "/" in key:
            raise ValueError("%s: a tree key must be a non-empty string "
                             "without '/', not %r"
                             % (".".join(prefix) or "tree", key))
        if isinstance(value, Mapping):
            out.extend(_leaves(value, prefix + (key,)))
            continue
        if not isinstance(value, np.ndarray) or value.dtype != _F32:
            raise ValueError(
                "%s: %s is not a float32 numpy array; the port writes its "
                "parameters as they are (float32)"
                % (".".join(prefix + (key,)),
                   getattr(value, "dtype", type(value).__name__)))
        out.append((prefix + (key,), value))
    return out


def _zarray(shape: Tuple[int, ...]) -> bytes:
    """A zarr v2 array's metadata as tensorstore writes it (sorted keys,
    no spaces), with no compressor and one chunk for the whole array
    (a dimension of 0 gets chunks of 1: no chunk is written)."""
    return json.dumps({
        "chunks": [max(s, 1) for s in shape], "compressor": None,
        "dimension_separator": ".", "dtype": "<f4", "fill_value": None,
        "filters": None, "order": "C", "shape": list(shape),
        "zarr_format": 2}, sort_keys=True, separators=(",", ":")).encode()


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def write_params_step(save_dir: str, step: int, params: Mapping) -> str:
    """Write ``params`` (a nested dict of float32 numpy arrays, named as
    ``bridge.params_to_numpy_tree`` names them) as step ``step`` of
    ``save_dir``, the orbax layout of the module docstring. Returns the
    step's directory. Raises ``ValueError`` on another dtype, an empty
    tree, or a step that is already there."""
    init_ns = time.time_ns()
    leaves = _leaves({"params": params})
    if not leaves:
        raise ValueError("%s: no parameters to save" % save_dir)
    names = {".".join(path) for path, _ in leaves}
    if len(names) != len(leaves):
        raise ValueError("%s: two tree paths join to one dotted name"
                         % save_dir)
    final = os.path.join(save_dir, str(int(step)))
    if os.path.exists(final):
        raise ValueError("%s: step %d is already there" % (final, step))
    tmp = "%s%s%d" % (final, TMP_SUFFIX, init_ns)
    default = os.path.join(tmp, "default")
    os.makedirs(os.path.join(default, "array_metadatas"))

    entries: Dict[bytes, bytes] = {}
    tree_metadata, array_metadatas = {}, []
    for path, value in leaves:
        name = ".".join(path)
        shape = tuple(int(s) for s in value.shape)
        entries[(name + "/.zarray").encode()] = _zarray(shape)
        if value.size:
            chunk = ".".join("0" * len(shape)) if shape else "0"
            entries[("%s/%s" % (name, chunk)).encode()] = \
                np.ascontiguousarray(value).tobytes()
        tree_metadata[str(path)] = {
            "key_metadata": [{"key": k, "key_type": _DICT_KEY}
                             for k in path],
            "value_metadata": {"value_type": "jax.Array",
                               "skip_deserialize": False,
                               "write_shape": list(shape)}}
        array_metadatas.append({"array_metadata": {
            "param_name": name, "write_shape": list(shape),
            "chunk_shape": list(shape), "ext_metadata": None}})
    write_database(default, entries)
    _write_json(os.path.join(default, "_METADATA"), {
        "tree_metadata": tree_metadata, "use_ocdbt": True,
        "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None})
    _write_json(os.path.join(default, "array_metadatas", "process_0"),
                {"array_metadatas": array_metadatas})
    _write_json(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
        "item_handlers": {"default": STANDARD_HANDLER}, "metrics": {},
        "performance_metrics": {}, "init_timestamp_nsecs": init_ns,
        "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": dict(WRITTEN_BY)})
    os.rename(tmp, final)   # a reader never sees half a step
    return final


def written_by_port(step_dir: str) -> bool:
    """Whether the orbax step ``step_dir`` carries the port's mark (a
    step of the JAX package, or one whose metadata cannot be read, does
    not)."""
    try:
        with open(os.path.join(step_dir, "_CHECKPOINT_METADATA")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    custom = meta.get("custom_metadata") if isinstance(meta, dict) else None
    return isinstance(custom, dict) and all(
        custom.get(k) == v for k, v in WRITTEN_BY.items())
