"""The JAX package's orbax checkpoints, read with no orbax or tensorstore.

``mvt-train``, ``mvt-train-simaug`` and ``mvt-convert-tf`` save with
``multiverse_tpu/train/checkpoints.py``'s ``CheckpointManager``: one
directory per step, ``<save|best>/<step>/``, holding
``_CHECKPOINT_METADATA`` and ``default/``. ``default/_METADATA`` lists
the saved tree; ``default/`` is an OCDBT database (:mod:`.ocdbt`) whose
keys are ``params.<dotted path>/.zarray`` (a zarr v2 array's metadata)
and ``params.<dotted path>/<chunk index>`` (one zstd-compressed chunk
each). :func:`read_params_tree` returns the ``params`` subtree as the
nested dict of numpy arrays that ``bridge.load_params_tree`` returns for
an npz, name for name (``scales/0/dec_class/kernel``), so
``bridge.prune_to_template`` takes either.
"""

from __future__ import annotations

import ast
import itertools
import json
import os
import re
from typing import List, Tuple

import numpy as np

from multiverse_torch.native import zstd
from multiverse_torch.train.ocdbt import OcdbtReader

_DIGITS = re.compile(r"^\d+$")
# orbax's saved tree: every key a dict key (jax.tree_util.DictKey)
_DICT_KEY = 2
_DTYPES = {"<f2", "<f4", "<f8", "|i1", "<i2", "<i4", "<i8", "|u1", "<u2",
           "<u4", "<u8", "bfloat16"}


def is_orbax_step(path: str) -> bool:
    """A finished orbax step: a directory named by its step number that
    holds ``_CHECKPOINT_METADATA`` and ``default/manifest.ocdbt``.
    orbax writes a step under ``<step>.orbax-checkpoint-tmp-*`` and
    renames it when done, so a step in flight is never one."""
    return (bool(_DIGITS.match(os.path.basename(os.path.normpath(path))))
            and os.path.isfile(os.path.join(path, "_CHECKPOINT_METADATA"))
            and os.path.isfile(os.path.join(path, "default",
                                            "manifest.ocdbt")))


def orbax_steps(directory: str) -> List[Tuple[int, str]]:
    """(step, path) of every finished orbax step in ``directory``, by
    step."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if is_orbax_step(path):
            found.append((int(name), path))
    return sorted(found)


def _tree_paths(step_dir: str) -> List[Tuple[str, ...]]:
    """The saved tree's leaf paths, from ``default/_METADATA``."""
    path = os.path.join(step_dir, "default", "_METADATA")
    try:
        with open(path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError("%s: cannot read the tree metadata: %s"
                         % (path, e)) from e
    if meta.get("use_zarr3", False):
        raise ValueError("%s: a zarr3 checkpoint; the port reads the zarr "
                         "v2 layout the JAX package writes" % path)
    if not meta.get("use_ocdbt", False):
        raise ValueError("%s: a checkpoint without OCDBT; the port reads "
                         "the OCDBT layout the JAX package writes" % path)
    if not isinstance(meta.get("tree_metadata"), dict):
        raise ValueError("%s: no tree_metadata" % path)
    paths = []
    for key, entry in meta["tree_metadata"].items():
        for k in entry.get("key_metadata", ()):
            if k.get("key_type") != _DICT_KEY:
                raise ValueError(
                    "%s: %s has a key of type %s; the port reads trees of "
                    "dict keys only" % (path, key, k.get("key_type")))
        names = ast.literal_eval(key)
        if not isinstance(names, tuple) or not all(
                isinstance(n, str) for n in names):
            raise ValueError("%s: unreadable tree key %r" % (path, key))
        paths.append(names)
    return paths


def _read_array(db: OcdbtReader, name: str, where: str) -> np.ndarray:
    """One zarr v2 array of the database, every chunk assembled."""
    try:
        meta = json.loads(db.read(name + "/.zarray"))
    except KeyError:
        raise ValueError("%s: no array %s" % (where, name)) from None
    if meta.get("zarr_format") != 2:
        raise ValueError("%s: %s is not a zarr v2 array" % (where, name))
    if meta.get("filters"):
        raise ValueError("%s: %s has filters %s; none are read"
                         % (where, name, meta["filters"]))
    if meta.get("order", "C") != "C":
        raise ValueError("%s: %s is in %s order; only C is read"
                         % (where, name, meta["order"]))
    try:
        dtype = meta["dtype"]
        shape = tuple(meta["shape"])
        chunks = tuple(meta["chunks"])
    except (KeyError, TypeError) as e:
        raise ValueError("%s: %s has malformed metadata: %r"
                         % (where, name, e)) from e
    if dtype not in _DTYPES:
        raise ValueError("%s: %s has dtype %s" % (where, name, dtype))
    store = np.dtype("<u2" if dtype == "bfloat16" else dtype)
    compressor = meta.get("compressor")
    cid = None if compressor is None else compressor.get("id")
    if cid not in (None, "zstd"):
        raise ValueError("%s: %s is compressed with %s; only zstd is read"
                         % (where, name, cid))
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError("%s: %s has chunks %s for shape %s"
                         % (where, name, chunks, shape))
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, store)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * store.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = "%s/%s" % (name, sep.join(map(str, idx)) if idx else "0")
        try:
            raw = db.read(key)
        except KeyError:
            raise ValueError("%s: chunk %s is missing" % (where, key)) \
                from None
        if cid == "zstd":
            try:
                raw = zstd.decompress(raw, chunk_bytes)
            except ValueError as e:
                raise ValueError("%s: chunk %s: %s" % (where, key, e)) from e
        elif len(raw) != chunk_bytes:
            raise ValueError("%s: chunk %s holds %d bytes, expected %d"
                             % (where, key, len(raw), chunk_bytes))
        chunk = np.frombuffer(raw, store).reshape(chunks)
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[sel] = chunk[tuple(slice(0, s.stop - s.start) for s in sel)]
    if dtype == "bfloat16":
        # bf16 is the high half of an f32
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


def read_params_tree(step_dir: str) -> dict:
    """The ``params`` subtree of an orbax step (``<save>/<step>``) as a
    nested dict of numpy arrays, named as ``bridge.load_params_tree``
    names an npz's. Raises ``ValueError`` naming the file or array at
    fault."""
    if not is_orbax_step(step_dir):
        raise ValueError("%s is not a finished orbax step" % step_dir)
    where = os.path.join(step_dir, "default")
    db = OcdbtReader(where)
    tree: dict = {}
    for names in _tree_paths(step_dir):
        if names[0] != "params":
            continue
        node = tree
        for n in names[1:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = _read_array(db, ".".join(names), where)
    if not tree:
        raise ValueError("%s: the checkpoint holds no params" % step_dir)
    return tree
