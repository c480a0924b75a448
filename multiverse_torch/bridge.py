"""Weights into and out of :class:`~multiverse_torch.models.Multiverse`.

* :func:`params_from_jax` takes the JAX package's ``init_params`` tree
  turned to numpy (``jax.tree_util.tree_map(np.asarray, params)``) and
  returns a module with the same names and values;
  ``train/orbax_reader.read_params_tree`` returns that tree from the
  JAX package's checkpoint files (its orbax steps) with no JAX, so the
  same function takes weights from either; the names and the HWIO
  layout are the same, so no conversion is needed;
  :func:`params_to_numpy_tree` is its inverse (a trained module back to
  the JAX layout, as numpy);
* :func:`save_params_npz` / :func:`load_params_npz` keep a flat npz
  whose keys are the tree paths joined with "/"
  (``scales/0/dec_class/kernel``), the format of the port's earlier
  checkpoints, which every loader still takes (new ones are orbax
  steps, ``train/orbax_writer.py``);
* :func:`prune_to_template` keeps, of a checkpoint's parameters, the
  names a configuration needs, as the JAX package restores a checkpoint
  that holds more grid scales than the model uses;
  :func:`check_params` demands an exact match.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from multiverse_torch.models.multiverse import Multiverse


def _to_torch(tree: Mapping) -> dict:
    """Nested mapping of numpy arrays or tensors -> f32 tensors (a
    tensor keeps its device)."""
    return {k: _to_torch(v) if isinstance(v, Mapping)
            else v.detach().float() if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}


def _tensor_tree(model: torch.nn.Module) -> dict:
    """Nested dict of a module's parameters by name (no copies)."""
    tree: dict = {}
    for name, p in model.named_parameters():
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = p.detach()
    return tree


def params_from_jax(tree: Mapping) -> Multiverse:
    """Module (on the CPU) from a nested mapping of numpy arrays with the
    JAX parameter tree's layout (HWIO kernels), name for name."""
    return Multiverse(_to_torch(tree))


def params_to_numpy_tree(model: Multiverse) -> dict:
    """Nested dict of f32 numpy arrays with the JAX parameter tree's
    layout, name for name: the inverse of :func:`params_from_jax`."""
    return _numpy(_tensor_tree(model))


def _numpy(tree: dict) -> dict:
    return {k: _numpy(v) if isinstance(v, dict)
            else v.float().cpu().numpy() for k, v in tree.items()}


def save_params_npz(model: Multiverse, path: str) -> None:
    np.savez(path, **{name.replace(".", "/"): p.detach().cpu().numpy()
                      for name, p in model.named_parameters()})


def load_params_tree(path: str) -> dict:
    """The nested dict of numpy arrays that a flat npz holds."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return tree


def load_params_npz(path: str) -> Multiverse:
    """Every parameter of a flat npz, as a module."""
    return params_from_jax(load_params_tree(path))


def _prune(saved, template, path: str):
    """``multiverse_tpu/train/checkpoints.py:_prune_to_template`` on
    nested dicts: the template's names, the same errors."""
    if isinstance(template, Mapping):
        if not isinstance(saved, Mapping):
            raise ValueError(f"{path}: checkpoint leaf where the "
                             f"template has a subtree")
        out = {}
        for k, sub in template.items():
            if k not in saved:
                raise KeyError(
                    f"{path}.{k}: required by the model config but "
                    f"missing from the checkpoint")
            out[k] = _prune(saved[k], sub, f"{path}.{k}")
        return out
    shape = tuple(saved.shape) if hasattr(saved, "shape") else None
    if shape != tuple(template.shape):
        raise ValueError(f"{path}: checkpoint shape {shape} != model "
                         f"shape {tuple(template.shape)}")
    return saved


def prune_to_template(saved, template: Multiverse) -> Multiverse:
    """Of ``saved`` (a module, or a nested mapping of arrays as
    :func:`load_params_tree` returns), the parameters that ``template``
    has, as a module: the JAX package's restore of a checkpoint that
    holds a superset of the model's parameters (a model trained with
    ``--use_grids 1,1`` is tested and decoded at ``1,0``). Raises
    ``KeyError`` naming the dotted path of a name the template needs and
    ``saved`` lacks, and ``ValueError`` naming the path and both shapes
    where a shape differs. A tensor keeps its device."""
    if isinstance(saved, torch.nn.Module):
        saved = _tensor_tree(saved)
    return Multiverse(_to_torch(_prune(saved, _tensor_tree(template),
                                       "params")))


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
