"""Checkpoints with the reference's {save, best} twin layout.

The port's counterpart of ``multiverse_tpu/train/checkpoints.py``
(reference: code/pred_utils.py:98-107 for outbase/model/runId/{save,
best}, code/train.py:170-171 for the twin savers keeping the latest 5).
A save holds the parameters only, as ``mvt-train`` saves them, in the
JAX package's own layout: one orbax step directory per step
(``<save>/300/``), written by :mod:`.orbax_writer` under a temporary
name and renamed, so a reader never sees half a step, and read by the
JAX package's ``CheckpointManager``, ``restore_params_from`` and
``poll_latest_step`` as its own. Every command of the port reads the
same way (:func:`load_checkpoint`): an orbax step directory (the port's
or the JAX package's, read by :mod:`.orbax_reader`), an npz file of the
port's earlier runs (``step_00000300.npz``, ``bridge.save_params_npz``'s
format), or the latest step of a ``save``/``best`` directory that holds
either, pruned to the configuration's parameters as the JAX package
restores a checkpoint that holds more grid scales than the model uses.
``mvt-torch-serve --reload_poll_s`` polls a ``save``/``best`` directory
for new steps (:func:`list_steps`). ``max_to_keep`` counts and removes
only the port's own steps: its npz files and the orbax steps that carry
its mark (``orbax_writer.written_by_port``); a step of the JAX package
is never removed.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional, Tuple

from multiverse_torch.bridge import (
    load_params_tree,
    params_to_numpy_tree,
    prune_to_template,
)
from multiverse_torch.models import Multiverse
from multiverse_torch.train.orbax_reader import (
    is_orbax_step,
    orbax_steps,
    read_params_tree,
)
from multiverse_torch.train.orbax_writer import (
    write_params_step,
    written_by_port,
)

_STEP = re.compile(r"^step_(\d+)\.npz$")


def _npz_steps(directory: str) -> List[Tuple[int, str]]:
    """(step, path) of the port's own npz steps in ``directory``. A save
    still under its temporary name (``step_X.npz.tmp.npz``) is not a
    step."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        m = _STEP.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(found)


def _own_steps(directory: str) -> List[Tuple[int, str]]:
    """(step, path) of the port's own steps in ``directory``, by step:
    its npz files and the orbax steps that carry its mark."""
    own = _npz_steps(directory) + [
        (s, p) for s, p in orbax_steps(directory) if written_by_port(p)]
    return sorted(own)


def _remove_step(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    else:
        os.remove(path)


def list_steps(directory: str) -> List[Tuple[int, str]]:
    """(step, path) of every checkpoint in ``directory``, by step, read
    afresh on every call: npz steps and finished orbax steps, the
    port's or the JAX package's (one in flight is not listed). Raises
    ``ValueError`` where one step number is held by both."""
    npz = dict(_npz_steps(directory))
    found = dict(orbax_steps(directory))
    both = sorted(set(npz) & set(found))
    if both:
        raise ValueError("step %d is held twice: %s and %s"
                         % (both[0], npz[both[0]], found[both[0]]))
    found.update(npz)
    return sorted(found.items())


def resolve_checkpoint(path: str) -> str:
    """An npz file, an orbax step directory, or the latest step of a
    ``save``/``best`` directory. Raises on a directory that holds no
    finished checkpoint."""
    if os.path.isfile(path) or is_orbax_step(path):
        return path
    steps = list_steps(path)
    if steps:
        return steps[-1][1]
    if os.path.isdir(path) and any(n.isdigit() for n in os.listdir(path)):
        raise ValueError(
            "%s holds step directories but no finished orbax step (each "
            "needs _CHECKPOINT_METADATA and default/manifest.ocdbt)" % path)
    raise FileNotFoundError("no checkpoint in %s" % path)


def read_checkpoint_tree(path: str) -> dict:
    """The parameters of ``path`` (see :func:`resolve_checkpoint`) as a
    nested dict of numpy arrays, from an npz or an orbax step alike."""
    path = resolve_checkpoint(path)
    if os.path.isdir(path):
        return read_params_tree(path)
    return load_params_tree(path)


def load_checkpoint(path: str, template: Multiverse) -> Multiverse:
    """The parameters of ``path`` (see :func:`resolve_checkpoint`) that
    ``template`` has (``Multiverse.init(cfg)``), as a module on the CPU:
    ``bridge.prune_to_template``'s names, errors and checks."""
    return prune_to_template(read_checkpoint_tree(path), template)


class CheckpointManager:
    """``outpath/save`` and ``outpath/best``, each keeping the latest
    ``max_to_keep`` steps. ``create=False`` (a data-parallel rank other
    than 0) reads the directories and makes nothing."""

    def __init__(self, outpath: str, max_to_keep: int = 5,
                 create: bool = True):
        self.save_dir = os.path.join(outpath, "save")
        self.best_dir = os.path.join(outpath, "best")
        self.max_to_keep = max_to_keep
        if create:
            os.makedirs(self.save_dir, exist_ok=True)
            os.makedirs(self.best_dir, exist_ok=True)

    def save(self, step: int, model, best: bool = False) -> str:
        """Write ``model``'s parameters as orbax step ``step`` of
        ``save`` (``best``), in place of a step of that number the port
        wrote before; then remove the port's own steps but the latest
        ``max_to_keep``. Returns the step's directory. Raises
        ``ValueError`` where a step of that number is the JAX
        package's."""
        directory = self.best_dir if best else self.save_dir
        held = dict(list_steps(directory)).get(step)
        if held is not None:
            if held not in dict(_own_steps(directory)).values():
                raise ValueError("step %d is already held by %s, which the "
                                 "port did not write" % (step, held))
            _remove_step(held)
        path = write_params_step(directory, step,
                                 params_to_numpy_tree(model))
        # only the port's own steps count and go: a JAX step stays
        for _, old in _own_steps(directory)[:-self.max_to_keep]:
            _remove_step(old)
        return path

    def latest_step(self, best: bool = False) -> Optional[int]:
        steps = list_steps(self.best_dir if best else self.save_dir)
        return steps[-1][0] if steps else None

    def restore_params(self, template: Multiverse, best: bool = False):
        """The latest saved parameters, pruned to ``template``, as a
        (frozen) Multiverse."""
        return load_checkpoint(self.best_dir if best else self.save_dir,
                               template)


def run_dir(outbasepath: str, modelname: str, run_id: int) -> str:
    """outbase/model/runId (reference: pred_utils.py:98-107)."""
    return os.path.join(outbasepath, modelname, str(run_id).zfill(2))


def process_out_dirs(outbasepath: str, modelname: str, run_id: int) -> str:
    """:func:`run_dir`, made if it is not there."""
    outpath = run_dir(outbasepath, modelname, run_id)
    os.makedirs(outpath, exist_ok=True)
    return outpath
