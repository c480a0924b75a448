"""In-memory dataset and batching for training and eval.

The port's own copy of ``multiverse_tpu/data/dataset.py`` (that module
imports the JAX package's model): ``read_data`` loads a
``data_{split}.npz`` written by ``mvt-preprocess`` (or by
:func:`synthesize_prepro`), ``TrajectoryDataset.get_batches`` yields the
same numpy batches in the same shuffle order (``random.Random(seed)``),
and :func:`batch_to_device` uploads one from pinned memory. The scene
table stays uint8 on the way and is cast on the device.
"""

from __future__ import annotations

import math
import os
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from multiverse_torch import native
from multiverse_torch.config import MultiverseConfig
from multiverse_torch.geometry import grid_centers, xy_to_cell_np
from multiverse_torch.models.multiverse import Batch

SHARED_KEYS = (
    "scene_feat", "video_wh", "scene_grid_strides", "vid2name",
    "person_boxkey2id", "person_boxid2key",
)
EXCLUDED_KEYS = (
    "seq_start_end", "obs_kp_rel", "obs_kp", "cur_activity", "obs_box",
    "future_activity", "pred_kp", "obs_other_box", "person_boxid2key",
    "obs_other_box_class", "pred_scene", "pred_frameidx",
)


class TrajectoryDataset:
    """Holds one split in memory; yields static-shape numpy batches."""

    def __init__(self, data: Dict[str, np.ndarray], shared: dict,
                 cfg: MultiverseConfig, split: str):
        self.data = data
        self.shared = shared
        self.cfg = cfg
        self.split = split
        self.num_examples = len(data["obs_traj"])
        # one permutation reused across epochs, keyed by its seed
        self._order: Optional[List[int]] = None
        self._order_seed: Optional[int] = None

    @property
    def grid_centers(self) -> List[np.ndarray]:
        return [self.shared["grid_center_%d" % i]
                for i in range(self.cfg.num_scales)]

    def num_batches(self, batch_size: int) -> int:
        return int(math.ceil(self.num_examples / batch_size))

    def _scene_cap(self, batch_size: int) -> int:
        # worst case: every (example, timestep) references a distinct frame
        return min(batch_size * self.cfg.obs_len,
                   max(len(self.shared.get("scene_feat", [1])), 1))

    def make_batch(self, idxs: List[int],
                   original_batch_size: Optional[int] = None
                   ) -> Tuple[Batch, dict]:
        """Assemble a numpy Batch from example indices. Returns (Batch,
        extras), extras holding the eval-side numpy data (ground-truth
        trajectories, keys) that never goes to the device."""
        cfg = self.cfg
        d = self.data
        n = len(idxs)
        idxs = np.asarray(idxs)
        obs_grid_class = d["obs_grid_class"][idxs].astype(np.int32)
        pred_grid_class = d["pred_grid_class"][idxs].astype(np.int32)
        obs_tgt = tuple(d["obs_grid_target_all_%d" % i][idxs]
                        .astype(np.float32) for i in cfg.active_scales)
        pred_tgt = tuple(d["pred_grid_target_all_%d" % i][idxs]
                         .astype(np.float32) for i in cfg.active_scales)

        # per-batch scene table: first-seen remap + fixed-size pad, in
        # the native packer
        cap = self._scene_cap(n)
        scene_rows = self.shared["scene_feat"]
        obs_scene_old = d["obs_scene"][idxs][..., 0]            # [n, T]
        new_idx, old_rows, _ = native.remap_first_seen(
            obs_scene_old.astype(np.int32), cap,
            max_id=len(scene_rows) - 1)
        table = native.gather_rows(scene_rows, old_rows, cap)

        batch = Batch(
            obs_grid_class=obs_grid_class,
            obs_grid_target_all=obs_tgt,
            obs_scene=new_idx,
            scene_feat=table,
            pred_grid_class=pred_grid_class,
            pred_grid_target_all=pred_tgt,
        )
        extras = {
            "original_batch_size": original_batch_size or n,
            "obs_traj": d["obs_traj"][idxs],
            "pred_traj": d["pred_traj"][idxs],
            "pred_grid_class": pred_grid_class,
            "traj_key": [d["traj_key"][j] for j in idxs],
        }
        return batch, extras

    def get_batches(self, batch_size: int, num_steps: int = 0,
                    shuffle: bool = True, full: bool = False,
                    seed: int = 123) -> Iterator[Tuple[Batch, dict]]:
        """Batch generator; ``full`` is exactly one epoch in order. The
        last short batch is padded by repeating its last example, with
        ``original_batch_size`` in the extras."""
        n_per_epoch = self.num_batches(batch_size)
        if full:
            num_steps = n_per_epoch
        if self.num_examples == 0 and num_steps > 0:
            raise ValueError(
                "dataset %r is empty — check the prepropath" % self.split)
        if shuffle:
            if self._order is None or self._order_seed != seed:
                rnd = random.Random(seed)
                self._order = list(range(self.num_examples))
                rnd.shuffle(self._order)
                self._order_seed = seed
            order = self._order
        else:
            order = list(range(self.num_examples))
        step = 0
        while step < num_steps:
            for b in range(n_per_epoch):
                if step >= num_steps:
                    return
                idxs = order[b * batch_size:(b + 1) * batch_size]
                original = len(idxs)
                if len(idxs) < batch_size:
                    idxs = idxs + [idxs[-1]] * (batch_size - len(idxs))
                yield self.make_batch(idxs, original)
                step += 1


def dataset_from_arrays(raw: Dict[str, np.ndarray], cfg: MultiverseConfig,
                        split: str) -> TrajectoryDataset:
    """A dataset from the arrays of one ``data_{split}.npz``."""
    raw = dict(raw)
    shared: dict = {}
    for key in list(SHARED_KEYS) + ["grid_center_%d" % i
                                    for i in range(cfg.num_scales)]:
        if key in raw:
            val = raw.pop(key)
            shared[key] = val.item() if np.shape(val) == () else val
    num_examples = len(raw["obs_traj"])
    data = {key: val for key, val in raw.items()
            if key not in EXCLUDED_KEYS and len(val) == num_examples}
    if "person_boxid2key" in shared and "obs_boxid" in data:
        boxid2key = shared["person_boxid2key"]
        data["traj_key"] = [boxid2key[int(data["obs_boxid"][i][0])]
                            for i in range(num_examples)]
    else:
        # videoname_frameidx_personid-style key from what there is
        vid2name = shared.get("vid2name", {})
        data["traj_key"] = [
            "%s_%d_%d" % (
                vid2name.get(int(raw["obs_vid"][i]), raw["obs_vid"][i])
                if "obs_vid" in raw else "video",
                raw["obs_frameidx"][i][0] if "obs_frameidx" in raw else i,
                i)
            for i in range(num_examples)]
    return TrajectoryDataset(data, shared, cfg, split)


def read_data(prepropath: str, split: str,
              cfg: MultiverseConfig) -> TrajectoryDataset:
    """Load ``data_{split}.npz`` (reference: code/pred_utils.py:208-300)."""
    path = os.path.join(prepropath, "data_%s.npz" % split)
    with np.load(path, allow_pickle=True) as f:
        raw = {k: f[k] for k in f.files}
    ds = dataset_from_arrays(raw, cfg, split)
    print("loaded %d examples for %s" % (ds.num_examples, split))
    return ds


def batch_to_device(batch, device: torch.device):
    """Copy a numpy Batch (or any NamedTuple of arrays, tuples of arrays
    and None, such as a SimAug ``MultiviewBatch``) to ``device`` (through
    pinned memory, without waiting, when it is a GPU); the scene table
    stays uint8."""
    device = torch.device(device)

    def put(a):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return type(batch)(*(tuple(put(a) for a in f) if isinstance(f, tuple)
                         else put(f) for f in batch))


# ------------------------------------------------------------ synthetic


def synthesize_split(cfg: MultiverseConfig, num_examples: int,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """The arrays ``mvt-preprocess --add_grid --add_all_reg --add_scene``
    writes for one split, for ``num_examples`` synthetic pedestrians:
    constant-velocity walks with noise (so a model can learn them) in
    the configuration's video frame, rasterised on every grid scale,
    and one random one-hot scene map per example, each example's
    observed steps reading consecutive maps. Made from ``seed`` with
    numpy. The walks start in the middle fifth of the frame at 5-25 px
    a step: the regression loss over every cell then varies little from
    batch to batch (std ~0.4 at the published widths, batch 20), so a
    falling loss shows within a few dozen steps."""
    rnd = np.random.RandomState(seed)
    n, T_obs, T = num_examples, cfg.obs_len, cfg.seq_len
    vw, vh = cfg.video_w, cfg.video_h
    start = rnd.uniform([vw * 0.4, vh * 0.4], [vw * 0.6, vh * 0.6],
                        size=(n, 1, 2))
    speed = rnd.uniform(5.0, 25.0, size=(n, 1, 1))
    angle = rnd.uniform(0.0, 2 * np.pi, size=(n, 1))
    vel = speed * np.stack([np.cos(angle), np.sin(angle)], axis=-1)
    t = np.arange(T, dtype=np.float64)[None, :, None]
    xy = start + vel * t + rnd.normal(0.0, 3.0, size=(n, T, 2))
    xy[..., 0] = np.clip(xy[..., 0], 1.0, vw - 1.0)
    xy[..., 1] = np.clip(xy[..., 1], 1.0, vh - 1.0)
    xy = xy.astype(np.float32)
    rel = np.zeros_like(xy)
    rel[:, 1:] = xy[:, 1:] - xy[:, :-1]

    S = cfg.num_scales
    cls = np.zeros((n, S, T), np.int32)
    tgt = np.zeros((n, S, T, 2), np.float32)
    out: Dict[str, np.ndarray] = {}
    for i, (h, w) in enumerate(cfg.scene_grids):
        centers = grid_centers(vh, vw, h, w)
        cls[:, i] = xy_to_cell_np(xy, vh, vw, h, w)
        allt = (xy[:, :, None, None, :] - centers[None, None]) \
            .astype(np.float32)                           # [n, T, h, w, 2]
        tgt[:, i] = np.take_along_axis(
            allt.reshape(n, T, h * w, 2), cls[:, i][..., None, None],
            axis=2)[:, :, 0]
        out["grid_center_%d" % i] = centers
        out["obs_grid_target_all_%d" % i] = allt[:, :T_obs]
        out["pred_grid_target_all_%d" % i] = allt[:, T_obs:]

    F = max(n, 1)
    labels = rnd.randint(0, cfg.scene_class, size=(F, cfg.scene_h,
                                                    cfg.scene_w))
    scene_feat = (labels[..., None] == np.arange(cfg.scene_class)) \
        .astype(np.uint8)
    scene_idx = ((np.arange(n)[:, None] + np.arange(T)[None]) % F) \
        .astype(np.int64)[..., None]                      # [n, T, 1]
    frameidx = np.tile(np.arange(T, dtype=np.int32) * 12, (n, 1))
    out.update({
        "obs_traj": xy[:, :T_obs], "pred_traj": xy[:, T_obs:],
        "obs_traj_rel": rel[:, :T_obs], "pred_traj_rel": rel[:, T_obs:],
        "seq_start_end": np.stack([np.arange(n), np.arange(n) + 1],
                                  axis=1).astype(np.int64),
        "obs_frameidx": frameidx[:, :T_obs],
        "obs_vid": np.zeros(n, np.int32),
        "vid2name": np.asarray({0: "synthetic_S_0000"}, dtype=object),
        "video_wh": np.asarray((vw, vh)),
        "scene_grid_strides": np.asarray(cfg.scene_grid_strides),
        "obs_grid_class": cls[:, :, :T_obs],
        "pred_grid_class": cls[:, :, T_obs:],
        "obs_grid_target": tgt[:, :, :T_obs],
        "pred_grid_target": tgt[:, :, T_obs:],
        "obs_scene": scene_idx[:, :T_obs], "pred_scene": scene_idx[:, T_obs:],
        "scene_feat": scene_feat,
    })
    return out


def synthesize_prepro(path: str, cfg: MultiverseConfig, n_train: int,
                      n_val: int, seed: int = 0) -> str:
    """Write ``data_train.npz`` and ``data_val.npz`` under ``path`` with
    the keys ``mvt-preprocess`` writes (see :func:`synthesize_split`;
    the two splits use seeds ``seed`` and ``seed + 1``): synthetic
    training data with no raw files. Data in the reference's on-disk
    format (trajectory TSVs, scene class maps) is preprocessed by the
    port's own ``mvt-torch-preprocess``. Returns ``path``."""
    os.makedirs(path, exist_ok=True)
    for split, n, s in (("train", n_train, seed), ("val", n_val, seed + 1)):
        np.savez(os.path.join(path, "data_%s.npz" % split),
                 **synthesize_split(cfg, n, s))
    return path
