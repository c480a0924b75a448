"""Weights into and out of :class:`~multiverse_torch.models.Multiverse`.

* :func:`params_from_jax` takes the JAX package's ``init_params`` tree
  turned to numpy (``jax.tree_util.tree_map(np.asarray, params)``) and
  returns a module with the same names and values;
  :func:`params_to_numpy_tree` is its inverse (a trained module back to
  the JAX layout, as numpy);
* :func:`save_params_npz` / :func:`load_params_npz` keep a flat npz
  whose keys are the tree paths joined with "/"
  (``scales/0/dec_class/kernel``), which is how the CLI takes weights.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from multiverse_torch.models.multiverse import Multiverse


def _to_torch(tree: Mapping) -> dict:
    return {k: _to_torch(v) if isinstance(v, Mapping)
            else torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}


def params_from_jax(tree: Mapping) -> Multiverse:
    """Module (on the CPU) from a nested mapping of numpy arrays with the
    JAX parameter tree's layout (HWIO kernels), name for name."""
    return Multiverse(_to_torch(tree))


def params_to_numpy_tree(model: Multiverse) -> dict:
    """Nested dict of f32 numpy arrays with the JAX parameter tree's
    layout, name for name: the inverse of :func:`params_from_jax`."""
    tree: dict = {}
    for name, p in model.named_parameters():
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().float().cpu().numpy()
    return tree


def save_params_npz(model: Multiverse, path: str) -> None:
    np.savez(path, **{name.replace(".", "/"): p.detach().cpu().numpy()
                      for name, p in model.named_parameters()})


def load_params_npz(path: str) -> Multiverse:
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return params_from_jax(tree)


def check_params(model: Multiverse, expected: Multiverse) -> None:
    """Raise unless ``model`` has exactly ``expected``'s names and
    shapes (e.g. weights loaded from a file against a configuration)."""
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(p.shape) for n, p in expected.named_parameters()}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(n for n in set(got) & set(want) if got[n] != want[n])
        raise ValueError(
            "parameters do not match the configuration: missing %s, "
            "unexpected %s, wrong shape %s" % (missing, extra, wrong))
