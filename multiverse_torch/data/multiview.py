"""Multi-view data grouping for SimAug training.

The port's own copy of ``multiverse_tpu/data/multiview.py``. The
4-camera simulation data names each example
``<scene>_..._F_<frame>_obs12_pred16_<cam>_<agent>_<pid>``; the views of
one agent share everything but the camera token. Training attaches each
example's M other views (labels and scene-feature indices) so that the
multiview augmentation can attack toward them.

reference: SimAug/code/pred_utils.py:205-213 ``get_agent_id``, :304-361
the "extra" grouping. The reference's grouping loop indexes
``data[...][j]`` with the enumeration index instead of the agent's view
index (``extra_data_idxs[j]``), which attaches the first M examples'
data to every agent; this implements the intended grouping, as the JAX
package does.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from multiverse_torch import native
from multiverse_torch.data.dataset import synthesize_split
from multiverse_torch.models.simaug import MultiviewBatch


def get_agent_id(seq_key) -> str:
    """Strip the camera token (3rd from the end) from a seq_key
    (reference: SimAug/code/pred_utils.py:205-213)."""
    if isinstance(seq_key, bytes):
        seq_key = seq_key.decode()
    parts = str(seq_key).split("_")
    del parts[-3]
    return "_".join(parts)


class MultiviewExtras(NamedTuple):
    obs_grid_class_extra: np.ndarray   # [N, M, T_obs] int32
    pred_grid_class_extra: np.ndarray  # [N, M, T_pred] int32
    obs_scene_extra: np.ndarray        # [N, M, T_obs] int32
    num_views: int                     # M


def build_multiview_extras(
    seq_keys: List[str],
    obs_grid_class: np.ndarray,    # [N, T_obs] (active scale)
    pred_grid_class: np.ndarray,   # [N, T_pred]
    obs_scene: np.ndarray,         # [N, T_obs]
    max_views: int = 0,
) -> MultiviewExtras:
    """Group examples by agent and attach each one's other views. An
    agent with fewer than M other views is padded by repeating the
    example itself (reference: SimAug/code/pred_utils.py:344-348)."""
    N = len(seq_keys)
    agent_to_idx: Dict[str, List[int]] = {}
    agent_ids = []
    for i, key in enumerate(seq_keys):
        aid = get_agent_id(key)
        agent_ids.append(aid)
        agent_to_idx.setdefault(aid, []).append(i)

    M = max_views or max(
        (len(v) for v in agent_to_idx.values()), default=1) - 1
    M = max(M, 1)

    obs_extra = np.zeros(
        (N, M) + obs_grid_class.shape[1:], obs_grid_class.dtype)
    pred_extra = np.zeros(
        (N, M) + pred_grid_class.shape[1:], pred_grid_class.dtype)
    scene_extra = np.zeros((N, M) + obs_scene.shape[1:], obs_scene.dtype)

    for i in range(N):
        others = [j for j in agent_to_idx[agent_ids[i]] if j != i]
        if len(others) < M:
            others = others + [i] * (M - len(others))
        others = others[:M]
        obs_extra[i] = obs_grid_class[others]
        pred_extra[i] = pred_grid_class[others]
        scene_extra[i] = obs_scene[others]

    return MultiviewExtras(obs_extra, pred_extra, scene_extra, M)


class MultiviewDataset:
    """Wraps a :class:`~multiverse_torch.data.dataset.TrajectoryDataset`
    with per-agent view extras (reference:
    SimAug/code/pred_utils.py:304-361).

    It builds its own batches: the per-batch scene table must hold the
    rows that the extra views reference as well, so the remap covers
    obs_scene and obs_scene_extra together."""

    def __init__(self, dataset, cfg, max_views: int = 0):
        self.base = dataset
        self.cfg = cfg
        self.scale = cfg.active_scales[0]
        d = dataset.data
        keys = [str(k) for k in d.get("seq_key", d["traj_key"])]
        self._obs_scene = (
            d["obs_scene"][..., 0]
            if d["obs_scene"].ndim == 3 else d["obs_scene"]
        ).astype(np.int32)
        self.extras = build_multiview_extras(
            keys,
            d["obs_grid_class"][:, self.scale].astype(np.int32),
            d["pred_grid_class"][:, self.scale].astype(np.int32),
            self._obs_scene,
            max_views=max_views,
        )

    @property
    def num_examples(self) -> int:
        return self.base.num_examples

    @property
    def num_views(self) -> int:
        return self.extras.num_views

    def num_batches(self, batch_size: int) -> int:
        return self.base.num_batches(batch_size)

    def make_batch(self, idxs) -> Tuple[MultiviewBatch, dict]:
        """A numpy MultiviewBatch of the examples ``idxs`` and the
        extras the eval side reads. One first-seen remap of own and
        extra scene rows, through the native packer, into a table of a
        fixed size, n * T_obs * (M + 1) rows at most."""
        cfg = self.cfg
        d = self.base.data
        idxs = np.asarray(idxs)
        n = len(idxs)
        i = self.scale
        M = self.extras.num_views

        obs_scene = self._obs_scene[idxs]                    # [n, T]
        scene_extra = self.extras.obs_scene_extra[idxs]      # [n, M, T]
        rows = self.base.shared["scene_feat"]
        cap = min(n * cfg.obs_len * (M + 1), max(len(rows), 1))
        both = np.concatenate(
            [obs_scene.reshape(-1), scene_extra.reshape(-1)])
        remapped, old_rows, _ = native.remap_first_seen(
            both.astype(np.int32), cap, max_id=len(rows) - 1)
        local_obs = remapped[:obs_scene.size].reshape(obs_scene.shape)
        local_extra = remapped[obs_scene.size:].reshape(scene_extra.shape)
        table = native.gather_rows(rows, old_rows, cap)

        batch = MultiviewBatch(
            obs_grid_class=d["obs_grid_class"][idxs].astype(np.int32),
            obs_grid_target=d[
                "obs_grid_target_all_%d" % i][idxs].astype(np.float32),
            obs_scene=local_obs,
            # uint8: 4x fewer bytes to the device, cast there
            scene_feat=table,
            pred_grid_class=d["pred_grid_class"][idxs].astype(np.int32),
            pred_grid_target=d[
                "pred_grid_target_all_%d" % i][idxs].astype(np.float32),
            obs_grid_class_extra=self.extras.obs_grid_class_extra[idxs],
            pred_grid_class_extra=self.extras.pred_grid_class_extra[idxs],
            obs_scene_extra=local_extra,
        )
        extras = {
            "original_batch_size": n,
            "obs_traj": d["obs_traj"][idxs],
            "pred_traj": d["pred_traj"][idxs],
        }
        return batch, extras

    def get_batches(self, batch_size: int, num_steps: int = 0,
                    shuffle: bool = True, full: bool = False,
                    seed: int = 123):
        """Batches in the JAX package's order (``random.Random(seed)``
        shuffle); a short last batch repeats its last example."""
        n_per_epoch = self.num_batches(batch_size)
        if full:
            num_steps = n_per_epoch
        order = list(range(self.num_examples))
        if shuffle:
            random.Random(seed).shuffle(order)
        step = 0
        while step < num_steps:
            for b in range(n_per_epoch):
                if step >= num_steps:
                    return
                idxs = order[b * batch_size:(b + 1) * batch_size]
                if len(idxs) < batch_size:
                    idxs = idxs + [idxs[-1]] * (batch_size - len(idxs))
                yield self.make_batch(idxs)
                step += 1


# ------------------------------------------------------------ synthetic


def synthesize_multiview_split(cfg, num_agents: int, num_cams: int = 4,
                               seed: int = 0) -> Dict[str, np.ndarray]:
    """:func:`~multiverse_torch.data.dataset.synthesize_split`'s arrays
    for ``num_agents`` x ``num_cams`` examples with the 4-camera data's
    ``seq_key``s: example ``a * num_cams + k`` is camera ``k + 1``'s view
    of agent ``a`` (``..._F_<frame>_obs<T>_pred<T>_cam<k>_<agent>_<pid>``).
    Each view is its own synthetic walk over its own scene maps."""
    out = synthesize_split(cfg, num_agents * num_cams, seed)
    out["seq_key"] = np.asarray([
        "synthetic_S_0000_F_%d_obs%d_pred%d_cam%d_%d_%d" % (
            12 * a, cfg.obs_len, cfg.pred_len, k + 1, a, a)
        for a in range(num_agents) for k in range(num_cams)])
    return out


def synthesize_multiview_prepro(path: str, cfg, num_agents: int,
                                n_val: int, seed: int = 0,
                                num_cams: int = 4) -> str:
    """Write a multi-camera ``data_train.npz``
    (:func:`synthesize_multiview_split`) and a ``data_val.npz`` of
    ``n_val`` single-view examples under ``path``, so that SimAug can
    train where ``mvt-preprocess`` (which needs jax) and the 4-camera
    data are absent. Returns ``path``."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "data_train.npz"),
             **synthesize_multiview_split(cfg, num_agents, num_cams, seed))
    np.savez(os.path.join(path, "data_val.npz"),
             **synthesize_split(cfg, n_val, seed + 1))
    return path
