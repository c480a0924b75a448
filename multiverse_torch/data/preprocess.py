"""Offline featurisation: trajectory TSVs -> one npz per split.

The port's copy of ``multiverse_tpu/data/preprocess.py`` (that module
imports the JAX package's geometry, which imports jax). It is host
numpy in both packages and writes the same npz: the same keys, dtypes,
ordering and values (reference: code/preprocess.py:670-864 for the
schema), so ``mvt-torch-train`` and ``mvt-train`` read either's output.

* windows are found on a dense [frames x persons] presence matrix per
  video, full coverage by one cumulative sum
  (reference: code/preprocess.py:316-420 re-concatenates frame rows);
* grid cells and the dense all-cell regression targets are batched
  numpy over the window's persons (``multiverse_torch.geometry``;
  reference: :438-475 loops per person per scale);
* the scene one-hot matrix is a table lookup and one comparison
  (``multiverse_torch.data.scene``; reference: :831-858);
* the optional features (keypoints, person and other boxes,
  activities) follow the reference's per-key pickle lookups
  (reference: :481-587).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from multiverse_torch import geometry
from multiverse_torch.data import scene as scene_lib
from multiverse_torch.data.vocab import MOVE_ACTIVITY_IDS


class PreprocessOptions:
    """Mirrors the reference preprocess CLI flags
    (reference: code/preprocess.py:22-78)."""

    def __init__(
        self,
        obs_len: int = 8,
        pred_len: int = 12,
        min_ped: int = 0,
        add_grid: bool = True,
        add_all_reg: bool = True,
        add_scene: bool = False,
        add_kp: bool = False,
        add_person_box: bool = False,
        add_other_box: bool = False,
        add_activity: bool = False,
        scene_feat_path: Optional[str] = None,
        scene_map_path: Optional[str] = None,
        scene_id2name: Optional[str] = None,
        direct_scene_feat: bool = False,
        kp_path: Optional[str] = None,
        person_box_path: Optional[str] = None,
        person_boxkey2id_p: Optional[str] = None,
        other_box_path: Optional[str] = None,
        activity_path: Optional[str] = None,
        scene_h: int = 36,
        scene_w: int = 64,
        video_h: int = 1080,
        video_w: int = 1920,
        grid_strides: str = "2,4",
        feature_no_split: bool = False,
        reverse_xy: bool = False,
        traj_pixel_lst: Optional[str] = None,
    ):
        self.obs_len = obs_len
        self.pred_len = pred_len
        self.seq_len = obs_len + pred_len
        self.min_ped = min_ped
        self.add_grid = add_grid
        self.add_all_reg = add_all_reg
        self.add_scene = add_scene
        self.add_kp = add_kp
        self.add_person_box = add_person_box
        self.add_other_box = add_other_box
        self.add_activity = add_activity
        self.scene_feat_path = scene_feat_path
        self.scene_map_path = scene_map_path
        self.scene_id2name = scene_id2name
        self.direct_scene_feat = direct_scene_feat
        self.kp_path = kp_path
        self.person_box_path = person_box_path
        self.person_boxkey2id_p = person_boxkey2id_p
        self.other_box_path = other_box_path
        self.activity_path = activity_path
        self.scene_h = scene_h
        self.scene_w = scene_w
        self.video_h = video_h
        self.video_w = video_w
        self.strides = tuple(int(s) for s in grid_strides.split(","))
        self.scene_grids = tuple(
            (int(round(scene_h / s)), int(round(scene_w / s)))
            for s in self.strides
        )
        self.feature_no_split = feature_no_split
        self.reverse_xy = reverse_xy
        self.traj_pixel_lst = traj_pixel_lst


def _load_traj_tsv(path: str, reverse_xy: bool) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) != 4:
                continue
            if reverse_xy:
                fidx, pid, y, x = parts
            else:
                fidx, pid, x, y = parts
            rows.append((float(fidx), float(pid), float(x), float(y)))
    return np.asarray(rows, dtype=np.float32).reshape(-1, 4)


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _feature_path(base: str, split: str, videoname: str,
                  no_split: bool) -> str:
    if no_split:
        return os.path.join(base, "%s.p" % videoname)
    return os.path.join(base, split, "%s.p" % videoname)


def _extract_windows(data: np.ndarray, seq_len: int):
    """Dense windowing: yields (start_pos, frame_ids[seq_len],
    pids[K], xy[K, seq_len, 2]) for windows with ≥1 fully-covered person.

    Window starts iterate positions in the sorted unique frame list,
    exactly like the reference's frame_data[idx:idx+seq_len] windows.
    """
    frames, frame_inv = np.unique(data[:, 0], return_inverse=True)
    pids, pid_inv = np.unique(data[:, 1], return_inverse=True)
    F, P = len(frames), len(pids)
    present = np.zeros((F, P), dtype=bool)
    xy = np.zeros((F, P, 2), dtype=np.float32)
    present[frame_inv, pid_inv] = True
    xy[frame_inv, pid_inv] = data[:, 2:4]

    # cumulative presence for O(1) full-coverage window checks
    cover = np.cumsum(present.astype(np.int32), axis=0)
    pad = np.zeros((1, P), np.int32)
    cover = np.concatenate([pad, cover], axis=0)  # [F+1, P]

    for s in range(F - seq_len + 1):
        full = (cover[s + seq_len] - cover[s]) == seq_len
        if not full.any():
            continue
        k_idx = np.nonzero(full)[0]
        yield (
            s,
            frames[s:s + seq_len],
            pids[k_idx],
            np.transpose(xy[s:s + seq_len][:, k_idx], (1, 0, 2)),
        )


def preprocess_split(
    traj_path: str,
    split: str,
    out_path: str,
    opts: PreprocessOptions,
) -> Optional[str]:
    """Process one split directory of per-video TSVs into data_{split}.npz.

    Returns the npz path, or None if the split has no videos
    (reference: code/preprocess.py:147-866 `prepro_each`).
    """
    videos = sorted(glob.glob(os.path.join(traj_path, split, "*.txt")))
    if not videos:
        print("warning: no videos for split %s, skipped" % split)
        return None

    obs_len, seq_len = opts.obs_len, opts.seq_len
    centers = [
        geometry.grid_centers(opts.video_h, opts.video_w, h, w)
        for (h, w) in opts.scene_grids
    ]

    # alternate pixel coordinates for ETH/UCY world-coordinate files
    # (reference: code/preprocess.py:108-125)
    traj_pixel = None
    if opts.traj_pixel_lst:
        traj_pixel = {}
        with open(opts.traj_pixel_lst) as lst:
            for pixel_file in lst:
                pixel_file = pixel_file.strip()
                name = os.path.splitext(os.path.basename(pixel_file))[0]
                traj_pixel[name] = {}
                with open(pixel_file) as f:
                    for line in f:
                        fid, pid, x, y = line.strip().split("\t")
                        traj_pixel[name]["%d_%d" % (
                            float(fid), float(pid))] = (float(x), float(y))

    if opts.add_scene:
        oldid2new, num_scene_class = scene_lib.load_scene_id_map(
            opts.scene_id2name)
        table = scene_lib.remap_table(oldid2new, max_id=512)

    prev_boxkey2id = None
    if opts.person_boxkey2id_p:
        prev_boxkey2id = _load_pickle(opts.person_boxkey2id_p)

    # accumulators
    acc: Dict[str, list] = {k: [] for k in [
        "seq", "seq_rel", "frameidx", "vid", "grid_class", "grid_target",
        "kp", "kp_rel", "person_box", "person_boxid", "scene_idx",
    ]}
    grid_target_all: List[list] = [[] for _ in opts.scene_grids]
    other_box_list, other_box_class_list = [], []
    cur_act_list, future_act_list = [], []
    num_person_per_window = []
    vid2name = {}
    person_boxkey2id: Dict[str, int] = {}
    person_boxid2key: Dict[int, str] = {}
    scene_key2feati: Dict[str, int] = {}
    scene_feat_rows: List[np.ndarray] = []

    for video in videos:
        videoname = os.path.splitext(os.path.basename(video))[0]
        vid = len(vid2name)
        vid2name[vid] = videoname

        data = _load_traj_tsv(video, opts.reverse_xy)
        if data.size == 0:
            print("warning: %s/%s empty, skipped" % (split, videoname))
            continue

        kp_feats = person_boxes = other_boxes = activities = None
        scene_frameid2file = {}
        if opts.add_kp:
            kp_feats = _load_pickle(
                _feature_path(opts.kp_path, split, videoname, False))
        if opts.add_person_box:
            person_boxes = _load_pickle(_feature_path(
                opts.person_box_path, split, videoname,
                opts.feature_no_split))
        if opts.add_other_box:
            other_boxes = _load_pickle(_feature_path(
                opts.other_box_path, split, videoname,
                opts.feature_no_split))
        if opts.add_activity:
            activities = _load_pickle(_feature_path(
                opts.activity_path, split, videoname, False))
        if opts.add_scene and not opts.direct_scene_feat:
            scene_frameid2file = _load_pickle(_feature_path(
                opts.scene_map_path, split, videoname,
                opts.feature_no_split))
            scene_frameid2file = {
                k: os.path.join(opts.scene_feat_path, v)
                for k, v in scene_frameid2file.items()
            }

        for s, frame_ids, pids, xy in _extract_windows(data, seq_len):
            K = len(pids)
            if K <= opts.min_ped:
                continue

            # pixel trajectories used for grid rasterization
            pix = xy
            if traj_pixel is not None:
                pix = np.zeros_like(xy)
                for k, pid in enumerate(pids):
                    for t, fid in enumerate(frame_ids):
                        pix[k, t] = traj_pixel[videoname][
                            "%d_%d" % (fid, pid)]

            rel = np.zeros_like(xy)
            rel[:, 1:] = xy[:, 1:] - xy[:, :-1]

            num_person_per_window.append(K)
            acc["seq"].append(xy)
            acc["seq_rel"].append(rel)
            acc["frameidx"].append(
                np.tile(frame_ids.astype(np.int32), (K, 1)))
            acc["vid"].append(np.full(K, vid, np.int32))

            if opts.add_grid:
                gcls = np.zeros((K, len(opts.scene_grids), seq_len),
                                np.int32)
                gtgt = np.zeros((K, len(opts.scene_grids), seq_len, 2),
                                np.float32)
                for i, (h, w) in enumerate(opts.scene_grids):
                    cells = geometry.xy_to_cell_np(
                        pix, opts.video_h, opts.video_w, h, w)  # [K, T]
                    gcls[:, i] = cells
                    # dense targets for all persons at once: [K,T,h,w,2]
                    allt = (pix[:, :, None, None, :]
                            - centers[i][None, None])
                    if opts.add_all_reg:
                        grid_target_all[i].append(
                            allt.astype(np.float32))
                    gtgt[:, i] = np.take_along_axis(
                        allt.reshape(K, seq_len, h * w, 2),
                        cells[..., None, None], axis=2
                    )[:, :, 0]
                acc["grid_class"].append(gcls)
                acc["grid_target"].append(gtgt)

            if opts.add_scene:
                featis = np.zeros((seq_len, 1), np.int64)
                for t, fid in enumerate(frame_ids):
                    if opts.direct_scene_feat:
                        key = os.path.join(
                            opts.scene_feat_path, videoname,
                            "%s_F_%08d.npy" % (videoname, int(fid)))
                    else:
                        key = scene_frameid2file[int(fid)]
                    if key not in scene_key2feati:
                        scene_key2feati[key] = len(scene_feat_rows)
                        scene_feat_rows.append(np.load(key))
                    featis[t, 0] = scene_key2feati[key]
                acc["scene_idx"].append(
                    np.tile(featis[None], (K, 1, 1)))

            if opts.add_kp:
                kp = np.zeros((K, seq_len, 17, 2), np.float32)
                for k, pid in enumerate(pids):
                    for t, fid in enumerate(frame_ids):
                        key = "%d_%d" % (fid, pid)
                        if key in kp_feats:
                            kp[k, t] = kp_feats[key][:, :2]
                        else:
                            # fall back to the most recent prior frame
                            # (reference: code/preprocess.py:486-502)
                            for back in range(int(fid) - 1,
                                              int(fid) - 31, -1):
                                nk = "%d_%d" % (back, pid)
                                if nk in kp_feats:
                                    kp[k, t] = kp_feats[nk][:, :2]
                                    break
                kp_rel = np.zeros_like(kp)
                kp_rel[:, 1:] = kp[:, 1:] - kp[:, :-1]
                acc["kp"].append(kp)
                acc["kp_rel"].append(kp_rel)

            if opts.add_person_box:
                boxes = np.zeros((K, seq_len, 4), np.float32)
                boxids = np.zeros((K, seq_len), np.int32)
                for k, pid in enumerate(pids):
                    for t, fid in enumerate(frame_ids):
                        boxes[k, t] = person_boxes["%d_%d" % (fid, pid)]
                        key = "%s_%d_%d" % (videoname, fid, pid)
                        if key not in person_boxkey2id:
                            if prev_boxkey2id is not None:
                                bid = _lookup_prev_boxid(
                                    prev_boxkey2id[split], key, videoname,
                                    int(fid), int(pid))
                            else:
                                bid = len(person_boxkey2id)
                            person_boxkey2id[key] = bid
                            person_boxid2key[bid] = key
                        boxids[k, t] = person_boxkey2id[key]
                acc["person_box"].append(boxes)
                acc["person_boxid"].append(boxids)

            if opts.add_other_box:
                for pid in pids:
                    ob, obc = [], []
                    for fid in frame_ids:
                        entry = other_boxes["%d_%d" % (fid, pid)]
                        ob.append(entry[0])
                        obc.append(entry[1])
                    other_box_list.append(ob)
                    other_box_class_list.append(obc)

            if opts.add_activity:
                for pid in pids:
                    cur_a, fut_a = [], []
                    for fid in frame_ids:
                        acts = activities["%d_%d" % (fid, pid)]
                        future_frame = int(opts.pred_len * 12)
                        cur_a.append(sorted(set(acts[0])))
                        fut_a.append(sorted(set(
                            _filter_future_act(acts, future_frame))))
                    cur_act_list.append(cur_a)
                    future_act_list.append(fut_a)

    if not acc["seq"]:
        print("warning: no sequences for split %s" % split)
        return None

    seq = np.concatenate(acc["seq"], axis=0)
    seq_rel = np.concatenate(acc["seq_rel"], axis=0)
    frameidx = np.concatenate(acc["frameidx"], axis=0)
    vid_arr = np.concatenate(acc["vid"], axis=0)

    cum = np.concatenate([[0], np.cumsum(num_person_per_window)])
    seq_start_end = np.stack([cum[:-1], cum[1:]], axis=1).astype(np.int64)

    data_out = {
        "obs_traj": seq[:, :obs_len],
        "pred_traj": seq[:, obs_len:],
        "obs_traj_rel": seq_rel[:, :obs_len],
        "pred_traj_rel": seq_rel[:, obs_len:],
        "seq_start_end": seq_start_end,
        "obs_frameidx": frameidx[:, :obs_len],
        "obs_vid": vid_arr,
        "vid2name": vid2name,
    }

    if opts.add_grid:
        gcls = np.concatenate(acc["grid_class"], axis=0)
        gtgt = np.concatenate(acc["grid_target"], axis=0)
        data_out.update({
            "video_wh": (opts.video_w, opts.video_h),
            "scene_grid_strides": np.asarray(opts.strides),
            "obs_grid_class": gcls[:, :, :obs_len],
            "pred_grid_class": gcls[:, :, obs_len:],
            "obs_grid_target": gtgt[:, :, :obs_len],
            "pred_grid_target": gtgt[:, :, obs_len:],
        })
        for i, c in enumerate(centers):
            data_out["grid_center_%d" % i] = c
            if opts.add_all_reg:
                allt = np.concatenate(grid_target_all[i], axis=0)
                data_out["obs_grid_target_all_%d" % i] = allt[:, :obs_len]
                data_out["pred_grid_target_all_%d" % i] = allt[:, obs_len:]

    if opts.add_scene:
        scene_idx = np.concatenate(acc["scene_idx"], axis=0)
        raw = np.stack(scene_feat_rows, axis=0)  # [F, H, W] class maps
        scene_feat = scene_lib.scene_class_map_to_onehot(
            raw, table, num_scene_class)
        data_out.update({
            "obs_scene": scene_idx[:, :obs_len],
            "pred_scene": scene_idx[:, obs_len:],
            "scene_feat": scene_feat,
        })

    if opts.add_kp:
        kp = np.concatenate(acc["kp"], axis=0)
        kp_rel = np.concatenate(acc["kp_rel"], axis=0)
        data_out.update({
            "obs_kp": kp[:, :obs_len],
            "obs_kp_rel": kp_rel[:, :obs_len],
            "pred_kp": kp[:, obs_len:],
        })

    if opts.add_person_box:
        boxes = np.concatenate(acc["person_box"], axis=0)
        boxids = np.concatenate(acc["person_boxid"], axis=0)
        data_out.update({
            "obs_box": boxes[:, :obs_len],
            "obs_boxid": boxids[:, :obs_len],
            "person_boxkey2id": person_boxkey2id,
            "person_boxid2key": person_boxid2key,
        })

    if opts.add_other_box:
        data_out.update({
            "obs_other_box": np.asarray(
                [b[:obs_len] for b in other_box_list], dtype=object),
            "obs_other_box_class": np.asarray(
                [b[:obs_len] for b in other_box_class_list], dtype=object),
        })

    if opts.add_activity:
        cur_at_last = [a[obs_len - 1] for a in cur_act_list]
        fut_at_last = [a[obs_len - 1] for a in future_act_list]
        traj_cat = np.asarray(
            [int(any(i in MOVE_ACTIVITY_IDS for i in acts))
             for acts in cur_at_last],
            dtype=np.uint8,
        )
        data_out.update({
            "cur_activity": np.asarray(cur_at_last, dtype=object),
            "future_activity": np.asarray(fut_at_last, dtype=object),
            "traj_cat": traj_cat,
        })

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **data_out)
    print("saved %d examples -> %s" % (len(seq), out_path))
    return out_path


def _lookup_prev_boxid(prev_map, key, videoname, fid, pid):
    """Reuse box ids from a previous run, with the reference's
    fall-back-to-earlier-frames behaviour
    (reference: code/preprocess.py:517-541)."""
    if key in prev_map:
        return prev_map[key]
    for back in range(fid - 1, fid - 31, -1):
        nk = "%s_%d_%d" % (videoname, back, pid)
        if nk in prev_map:
            return prev_map[nk]
    raise KeyError("no previous box id for %s" % key)


def _filter_future_act(acts, future_frame):
    """Keep activity ids active at `future_frame` steps ahead
    (reference: code/preprocess.py:869-906)."""
    cur_ids, cur_dists, fut_ids, fut_dists = acts
    out = []
    for act_id, dist_to_finish in zip(cur_ids, cur_dists):
        if act_id != 0 and future_frame <= dist_to_finish:
            out.append(act_id)
    for act_id, dist_to_start in zip(fut_ids, fut_dists):
        if act_id != 0 and future_frame >= dist_to_start:
            out.append(act_id)
    return out or [0]
