"""``mvt-torch-preprocess`` against ``mvt-preprocess`` on the CPU: the
same raw files (per-video trajectory TSVs, per-frame scene class maps,
the scene id json and the optional feature pickles) go through the JAX
package's ``preprocess_split`` and the port's, and every npz they write
is compared key for key, dtype for dtype and element for element
(tolerance 0: both are the same numpy arithmetic). Also: the numpy
helpers preprocessing calls equal their JAX twins, the port's
``read_data`` on the port's npz gives the JAX batches, and the command's
``main`` writes the three splits."""

import json
import os
import pickle

import jax
import numpy as np
import pytest

from multiverse_tpu import geometry as jax_geometry
from multiverse_tpu.cli import preprocess as jax_cli
from multiverse_tpu.data import preprocess as jax_pre
from multiverse_tpu.data import scene as jax_scene
from multiverse_tpu.data import vocab as jax_vocab
from multiverse_tpu.data.dataset import read_data as jax_read_data
from multiverse_torch import geometry
from multiverse_torch.cli import preprocess as cli
from multiverse_torch.data import preprocess as pre
from multiverse_torch.data import scene, vocab
from multiverse_torch.data.dataset import read_data
from synthetic import tiny_config, write_reference_format_dataset

SPLITS = ("train", "val", "test")
# the tiny dims of tests/test_data_pipeline.py
TINY = dict(obs_len=4, pred_len=5, scene_h=12, scene_w=16,
            grid_strides="2,4")


def _same(a, b, where: str) -> None:
    """Equal type, dtype, shape and every element; object arrays and
    the dicts and lists inside them compared element by element."""
    assert type(a) is type(b), where
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                _same(x, y, "%s[%d]" % (where, i))
        else:
            assert np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], "%s[%r]" % (where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, "%s[%d]" % (where, i))
    else:
        assert a == b, where


def _same_npz(want: str, got: str) -> None:
    with np.load(want, allow_pickle=True) as a, \
            np.load(got, allow_pickle=True) as b:
        assert a.files == b.files
        for k in a.files:
            _same(a[k], b[k], "%s:%s" % (os.path.basename(got), k))


def _run_both(traj_path: str, out: str, kw: dict) -> int:
    """Both packages' ``preprocess_split`` on every split; returns the
    number of npz files written (the same by each, and equal)."""
    written = 0
    for split in SPLITS:
        paths = []
        for name, mod in (("jax", jax_pre), ("torch", pre)):
            path = os.path.join(out, name, "data_%s.npz" % split)
            paths.append(mod.preprocess_split(
                traj_path, split, path, mod.PreprocessOptions(**kw)))
        assert (paths[0] is None) == (paths[1] is None), split
        if paths[0] is None:
            assert not os.path.exists(os.path.join(out, "torch",
                                                   "data_%s.npz" % split))
            continue
        _same_npz(*paths)
        written += 1
    return written


def _pickle(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _reference_files(root: str, **kw):
    return write_reference_format_dataset(
        root, tiny_config(), np.random.RandomState(0), **kw)


def _training_flags(root):
    """TRAINING.md section 1's flags at the tiny dims."""
    traj, scene_path, id2name = _reference_files(root)
    return traj, dict(TINY, add_grid=True, add_all_reg=True, add_scene=True,
                      direct_scene_feat=True, scene_feat_path=scene_path,
                      scene_id2name=id2name), 3


def _features(root):
    """Keypoints, person and other boxes, activities, and box ids from a
    previous run (``person_boxkey2id_p``): the fixture of
    tests/test_preprocess_features.py, every split."""
    traj, scene_path, id2name = _reference_files(
        root, num_videos=1, frames_per_video=12)
    rng = np.random.RandomState(3)
    paths = {k: os.path.join(root, k)
             for k in ("kp", "person_box", "other_box", "activity")}
    prev = {}
    for split in SPLITS:
        prev[split] = {}
        for fn in sorted(os.listdir(os.path.join(traj, split))):
            video = os.path.splitext(fn)[0]
            rows = np.loadtxt(os.path.join(traj, split, fn), delimiter="\t")
            feats = {k: {} for k in paths}
            for fid, pid, x, y in rows:
                key = "%d_%d" % (fid, pid)
                kp = rng.randn(17, 3).astype(np.float32)
                # every third frame after the first lacks its keypoints
                # and its box id: both fall back to an earlier frame's
                first = fid == rows[0, 0]
                if first or int(fid) % 36:
                    feats["kp"][key] = kp
                    prev[split]["%s_%d_%d" % (video, fid, pid)] = \
                        1000 + len(prev[split])
                feats["person_box"][key] = np.array(
                    [x - 5, y - 20, x + 5, y], np.float32)
                feats["other_box"][key] = ([[0.0, 0.0, 9.0, 9.0]], [1])
                feats["activity"][key] = ([1, 0], [500, 0], [21], [10])
            for k, d in feats.items():
                _pickle(os.path.join(paths[k], split, "%s.p" % video), d)
    prev_p = os.path.join(root, "boxkey2id.p")
    _pickle(prev_p, prev)
    return traj, dict(
        TINY, add_grid=True, add_all_reg=True, add_scene=True, add_kp=True,
        add_person_box=True, add_other_box=True, add_activity=True,
        kp_path=paths["kp"], person_box_path=paths["person_box"],
        other_box_path=paths["other_box"], activity_path=paths["activity"],
        person_boxkey2id_p=prev_p, scene_feat_path=scene_path,
        scene_id2name=id2name, direct_scene_feat=True), 3


def _scene_map(root):
    """Scene features through per-video frame -> file maps (no
    --direct_scene_feat) with --feature_no_split, boxes from unsplit
    pickles, a scene remap of ids above 255 (``remap_table(max_id=512)``)
    and class maps holding ids past the table."""
    traj, scene_path, _ = _reference_files(root, frames_per_video=10)
    id2name = os.path.join(root, "wide_id2name.json")
    with open(id2name, "w") as f:
        json.dump({"oldid2new": {str(300 + i): i for i in range(1, 5)},
                   "id2name": {str(i): "c%d" % i for i in range(1, 5)}}, f)
    rng = np.random.RandomState(5)
    map_path = os.path.join(root, "scene_map")
    box_path = os.path.join(root, "box_unsplit")
    for split in SPLITS:
        for fn in sorted(os.listdir(os.path.join(traj, split))):
            video = os.path.splitext(fn)[0]
            rows = np.loadtxt(os.path.join(traj, split, fn), delimiter="\t")
            frames = {}
            for fid in np.unique(rows[:, 0]):
                name = os.path.join(video, "%s_F_%08d.npy" % (video, fid))
                np.save(os.path.join(scene_path, name), rng.choice(
                    [0, 7, 301, 302, 303, 304, 600], (12, 16)
                ).astype(np.int32))
                frames[int(fid)] = name
            _pickle(os.path.join(map_path, "%s.p" % video), frames)
            _pickle(os.path.join(box_path, "%s.p" % video), {
                "%d_%d" % (fid, pid): np.array([x, y, x + 1, y + 1],
                                               np.float32)
                for fid, pid, x, y in rows})
    return traj, dict(
        TINY, add_grid=True, add_all_reg=False, add_scene=True,
        add_person_box=True, person_box_path=box_path,
        scene_feat_path=scene_path, scene_map_path=map_path,
        scene_id2name=id2name, feature_no_split=True), 3


def _reverse_xy(root):
    """World-coordinate TSVs in (frame, pid, y, x) order rasterised from
    a separate pixel lookup (--reverse_xy --traj_pixel_lst), as in
    tests/test_preprocess_features.py:118; no grid targets for all
    cells."""
    rng = np.random.RandomState(0)
    lst = []
    for split in SPLITS:
        os.makedirs(os.path.join(root, "traj", split))
        for v in range(2):
            name = "seq%s%d" % (split, v)
            world = rng.randn(2, 11, 2) * 3
            pixels = rng.uniform([10, 10], [950, 530], (2, 11, 2))
            pixel_file = os.path.join(root, "pixels", "%s.txt" % name)
            os.makedirs(os.path.dirname(pixel_file), exist_ok=True)
            with open(os.path.join(root, "traj", split, name + ".txt"),
                      "w") as f, open(pixel_file, "w") as g:
                for t in range(11):
                    for p in range(2):
                        f.write("%d\t%d\t%.4f\t%.4f\n" % (
                            t * 10, p + 1, world[p, t, 1], world[p, t, 0]))
                        g.write("%d\t%d\t%.3f\t%.3f\n" % (
                            t * 10, p + 1, pixels[p, t, 0], pixels[p, t, 1]))
            lst.append(pixel_file)
    lst_path = os.path.join(root, "pixel.lst")
    with open(lst_path, "w") as f:
        f.write("\n".join(lst) + "\n")
    return os.path.join(root, "traj"), dict(
        TINY, add_grid=True, add_all_reg=True, reverse_xy=True,
        traj_pixel_lst=lst_path, video_h=540, video_w=960), 3


def _min_ped_unsorted(root):
    """Persons entering and leaving, rows shuffled, person ids out of
    order and frames with gaps: the sorted unique frame and person order
    of the windows, with --min_ped 1 dropping single-person windows;
    the test split has one empty TSV (skipped) and writes nothing."""
    rng = np.random.RandomState(9)
    for split in SPLITS:
        os.makedirs(os.path.join(root, "traj", split))
    for split in ("train", "val"):
        for v in range(2):
            frames = np.cumsum(rng.choice([10, 20], 30))
            rows = []
            for pid, (lo, hi) in zip((17, 3, 40), ((0, 30), (4, 22), (9, 30))):
                for f in frames[lo:hi]:
                    rows.append((f, pid) + tuple(rng.uniform(0, 1000, 2)))
            rng.shuffle(rows)
            with open(os.path.join(root, "traj", split, "v%d.txt" % v),
                      "w") as f:
                f.writelines("%d\t%d\t%.3f\t%.3f\n" % r for r in rows)
                f.write("malformed line\n")
    open(os.path.join(root, "traj", "test", "empty.txt"), "w").close()
    return os.path.join(root, "traj"), dict(
        TINY, min_ped=1, add_grid=True, add_all_reg=False), 2


def _empty_split(root):
    """A split directory with no videos: no npz."""
    for split in SPLITS:
        os.makedirs(os.path.join(root, "traj", split))
    return os.path.join(root, "traj"), dict(TINY), 0


CASES = {"training_flags": _training_flags, "features": _features,
         "scene_map": _scene_map, "reverse_xy_traj_pixel": _reverse_xy,
         "min_ped_unsorted": _min_ped_unsorted, "empty_split": _empty_split}


@pytest.mark.parametrize("case", list(CASES))
def test_preprocess_split_equals_jax(case, tmp_path):
    traj, kw, n_files = CASES[case](str(tmp_path))
    assert _run_both(traj, str(tmp_path / "out"), kw) == n_files


def test_helpers_equal_jax():
    """The geometry and scene helpers preprocessing calls, and the
    activity vocabulary, equal their JAX twins on its inputs."""
    rng = np.random.RandomState(1)
    xy = np.concatenate([rng.uniform(-50, 2000, (3, 9, 2)),
                         [[[0.0, 0.0]] * 9]]).astype(np.float32)
    for grids in (((18, 32), (9, 16)), ((6, 8), (3, 4))):
        for h, w in grids:
            for a, b in ((jax_geometry.grid_centers(1080, 1920, h, w),
                          geometry.grid_centers(1080, 1920, h, w)),
                         (jax_geometry.xy_to_cell_np(xy, 1080, 1920, h, w),
                          geometry.xy_to_cell_np(xy, 1080, 1920, h, w))):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            c = geometry.grid_centers(1080, 1920, h, w)
            a = jax_geometry.dense_regression_targets_np(xy[0], c)
            b = geometry.dense_regression_targets_np(xy[0], c)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        ja, jt = jax_geometry.rasterize_traj_np(xy[1], 1080, 1920, grids)
        ta, tt = geometry.rasterize_traj_np(xy[1], 1080, 1920, grids)
        assert np.array_equal(ja, ta) and ja.dtype == ta.dtype
        for a, b in zip(jt, tt):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    oldid2new = {0: 0, 4: 1, 300: 2, 511: 3}
    for max_id in (256, 512):
        a = jax_scene.remap_table(oldid2new, max_id)
        b = scene.remap_table(oldid2new, max_id)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    maps = rng.choice([0, 4, 300, 511, 900], (5, 12, 16))
    table = scene.remap_table(oldid2new, 512)
    a = jax_scene.scene_class_map_to_onehot(maps, table, 4)
    b = scene.scene_class_map_to_onehot(maps, table, 4)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert vocab.activity2id == jax_vocab.activity2id
    assert vocab.object2id == jax_vocab.object2id
    assert vocab.MOVE_ACTIVITY_IDS == jax_vocab.MOVE_ACTIVITY_IDS


def test_read_data_on_port_npz_gives_the_jax_batches(tmp_path):
    traj, kw, _ = _training_flags(str(tmp_path))
    out = str(tmp_path / "out")
    _run_both(traj, out, kw)
    cfg = tiny_config(use_grids=(True, True))
    for split in ("train", "val"):
        j_ds = jax_read_data(os.path.join(out, "jax"), split, cfg)
        t_ds = read_data(os.path.join(out, "torch"), split, cfg)
        assert t_ds.num_examples == j_ds.num_examples > 4
        steps = 2 * t_ds.num_batches(4) + 1   # two shuffled epochs
        pairs = list(zip(j_ds.get_batches(4, num_steps=steps),
                         t_ds.get_batches(4, num_steps=steps)))
        assert len(pairs) == steps
        for (jb, jx), (tb, tx) in pairs:
            for a, b in zip(jax.tree_util.tree_leaves(jb),
                            jax.tree_util.tree_leaves(tb)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert jx["traj_key"] == tx["traj_key"]
            np.testing.assert_array_equal(jx["pred_traj"], tx["pred_traj"])


def test_cli_main_writes_the_three_splits(tmp_path):
    """``mvt-torch-preprocess``'s main with TRAINING.md section 1's
    flags writes data_{train,val,test}.npz, each equal to
    ``mvt-preprocess``'s; its flags are the JAX command's."""
    traj, scene_path, id2name = _reference_files(str(tmp_path))
    flags = ["--add_grid", "--add_all_reg", "--add_scene",
             "--scene_feat_path", scene_path, "--scene_id2name", id2name,
             "--direct_scene_feat", "--grid_strides", "2,4",
             "--obs_len", "4", "--pred_len", "5", "--scene_h", "12",
             "--scene_w", "16"]
    jax_cli.main([traj, str(tmp_path / "jax"), *flags])
    cli.main([traj, str(tmp_path / "torch"), *flags])
    for split in SPLITS:
        _same_npz(str(tmp_path / "jax" / ("data_%s.npz" % split)),
                  str(tmp_path / "torch" / ("data_%s.npz" % split)))
    argv = ["t", "o", "--min_ped", "2", "--reverse_xy"]
    assert vars(cli.build_parser().parse_args(argv)) == \
        vars(jax_cli.build_parser().parse_args(argv))
