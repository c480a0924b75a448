"""The Forking Paths workflow from bbox JSONs to scores, in the port
alone, on the CPU at ``tests/test_full_chain.py``'s tiny widths (the
L1b → L6 part of that test, with no recorder: the bbox JSONs and the
scene class maps are generated):

bbox JSONs → mvt-torch-split-path → mvt-torch-prepare-multifuture and
mvt-torch-prepare-anchor → mvt-torch-preprocess → mvt-torch-train
(2 epochs) → mvt-torch-multifuture-inference → mvt-torch-eval-trajs and
mvt-torch-eval-prob, every number printed finite.

Also the seam to the JAX package: ``mvt-torch-preprocess`` on the port's
prepared TSVs writes the npz that ``mvt-preprocess`` writes on the JAX
package's prepared TSVs, at tolerance 0."""

import json
import os
import pickle

import numpy as np
import pytest

from multiverse_tpu.cli import prepare_data as jax_prepare
from multiverse_tpu.cli import preprocess as jax_preprocess
from multiverse_torch.cli import multifuture_eval_trajs as eval_trajs
from multiverse_torch.cli import multifuture_eval_trajs_prob as eval_prob
from multiverse_torch.cli import multifuture_inference as inference_cli
from multiverse_torch.cli import prepare_data
from multiverse_torch.cli import preprocess as preprocess_cli
from multiverse_torch.cli import train as train_cli

VIDEO_W, VIDEO_H = 192, 108
SCENE_CLASS = 5
# ethucy timing (zara: start 32, drop 10): 150 frames give 12 sampled
# frames, 4 obs + 8 future steps
MF_FRAMES, OBS = 150, 4
# moments x cameras (cam4 is the top-down view the evaluators group
# apart) x annotated futures
MOMENTS, CAMERAS, FUTURES = 2, ("cam1", "cam4"), 3
# anchor videos by the split of their VIRAT source, sampled every 10th
# frame: 15 frames, 7 windows of obs 4 + pred 5 a person
ANCHORS = {"train": 3, "val": 1, "test": 1}
ANCHOR_FRAMES, PERSONS = 150, 3
SIZE_FLAGS = ["--scene_h", "12", "--scene_w", "16",
              "--video_h", str(VIDEO_H), "--video_w", str(VIDEO_W)]
MODEL_FLAGS = ["--emb_size", "8", "--enc_hidden_size", "16",
               "--dec_hidden_size", "16", "--scene_conv_dim", "8",
               "--use_grids", "1,0", "--use_gnn", "--use_scene_enc",
               "--scene_class", str(SCENE_CLASS), *SIZE_FLAGS]


def walkers(rng, n_frames: int, n_persons: int, x_agent: int = -1,
            turn: float = 0.0) -> list:
    """Bbox JSON records of persons walking inside the frame; the
    x-agent turns by ``turn`` pixels a frame after frame 70 (its
    future), the others do not."""
    start = rng.uniform([40, 52], [150, 78], (n_persons, 2))
    vel = rng.uniform(-0.15, 0.15, (n_persons, 2))
    boxes = []
    for f in range(n_frames):
        for p in range(n_persons):
            x, y = start[p] + vel[p] * f
            if p == x_agent and f > 70:
                y += turn * (f - 70)
            boxes.append({"frame_id": f, "track_id": p,
                          "class_name": "Person",
                          "is_x_agent": int(p == x_agent),
                          "bbox": [float(x) - 4.0, float(y) - 16.0, 8.0,
                                   16.0]})
    return boxes


def write_inputs(root: str) -> dict:
    """Bbox JSONs, the rendered-video names split-path globs, the
    original VIRAT split lists, per-frame scene class maps and the
    scene id json."""
    rng = np.random.RandomState(0)
    paths = {k: os.path.join(root, k) for k in (
        "ds", "videos_mf", "videos_anchor", "ori", "scene_anchor",
        "scene_mf")}
    for p in paths.values():
        os.makedirs(p)
    os.makedirs(os.path.join(paths["ds"], "bbox"))

    def write(name: str, boxes: list, videos: str) -> None:
        with open(os.path.join(paths["ds"], "bbox", name + ".json"),
                  "w") as f:
            json.dump(boxes, f)
        open(os.path.join(paths[videos], name + ".mp4"), "w").close()

    def scene_maps(root_dir: str, name: str, frames) -> None:
        os.makedirs(os.path.join(root_dir, name))
        for fr in frames:
            np.save(os.path.join(root_dir, name, "%s_F_%08d.npy"
                                 % (name, fr)),
                    rng.randint(0, SCENE_CLASS, (12, 16)).astype(np.uint8))

    for m in range(MOMENTS):
        for cam in CAMERAS:
            seed = rng.randint(1 << 30)
            for d in range(FUTURES):
                boxes = walkers(np.random.RandomState(seed), MF_FRAMES, 3,
                                x_agent=1, turn=0.1 * (d - 1))
                write("zara01_%d_1_%d_a%d_%s" % (m, d, d, cam), boxes,
                      "videos_mf")
            scene_maps(paths["scene_mf"], "zara01_%d_1_%s" % (m, cam),
                       range(0, OBS * 10, 10))
    sources = {}
    for split, n in ANCHORS.items():
        for v in range(n):
            source = "VIRAT_S_%s%02d_00" % ({"train": "0400", "val": "0401",
                                             "test": "0000"}[split], v)
            sources.setdefault(split, []).append(source)
            name = source + "_F_%d_1" % v
            write(name, walkers(rng, ANCHOR_FRAMES, PERSONS), "videos_anchor")
            scene_maps(paths["scene_anchor"], name,
                       range(0, ANCHOR_FRAMES, 10))
    for split, names in sources.items():
        with open(os.path.join(paths["ori"], split + ".lst"), "w") as f:
            f.write("".join("videos/%s.mp4\n" % s for s in names))
    paths["id2name"] = os.path.join(root, "scene_id2name.json")
    with open(paths["id2name"], "w") as f:
        json.dump({"oldid2new": {str(i): i for i in range(1, SCENE_CLASS)},
                   "id2name": {str(i): "class%d" % i
                               for i in range(1, SCENE_CLASS)}}, f)
    return paths


def prepare(commands, inputs: dict, out: str) -> dict:
    """split-path, prepare-multifuture and prepare-anchor of one
    package (``commands``: its ``cli/prepare_data.py``) into ``out``."""
    split_mf, split_anchor = out + "/split_mf", out + "/split_anchor"
    commands.split_path_main([inputs["videos_mf"], split_mf])
    commands.split_path_main([inputs["videos_anchor"], split_anchor,
                              "--is_anchor", "--ori_split_path",
                              inputs["ori"]])
    commands.prepare_multifuture_main([inputs["ds"], split_mf, out + "/obs",
                                       out + "/mf", "--obs_length",
                                       str(OBS)])
    commands.prepare_anchor_main([inputs["ds"], split_anchor, out + "/anchor",
                                  "--drop_frame", "10", "--min_frames", "5"])
    return {"obs": out + "/obs/traj_2.5fps/test", "mf": out + "/mf/test",
            "anchor": out + "/anchor/traj_2.5fps"}


def preprocess_flags(inputs: dict) -> list:
    return ["--obs_len", str(OBS), "--pred_len", "5", "--add_grid",
            "--add_all_reg", "--add_scene", "--scene_feat_path",
            inputs["scene_anchor"], "--scene_id2name", inputs["id2name"],
            "--direct_scene_feat", "--grid_strides", "2,4", *SIZE_FLAGS]


def _same(a, b, where: str) -> None:
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


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prepare_chain"))
    inputs = write_inputs(root)
    port = prepare(prepare_data, inputs, root + "/port")
    prepro = root + "/port/prepro"
    preprocess_cli.main([port["anchor"], prepro, *preprocess_flags(inputs)])
    return root, inputs, port, prepro


def test_port_preprocess_of_port_prep_equals_jax_of_jax_prep(chain):
    root, inputs, port, prepro = chain
    jax = prepare(jax_prepare, inputs, root + "/jax")
    jax_prepro = root + "/jax/prepro"
    jax_preprocess.main([jax["anchor"], jax_prepro,
                         *preprocess_flags(inputs)])
    for split in ANCHORS:
        name = "data_%s.npz" % split
        with np.load(os.path.join(prepro, name), allow_pickle=True) as got, \
                np.load(os.path.join(jax_prepro, name),
                        allow_pickle=True) as want:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                _same(got[key], want[key], "%s:%s" % (name, key))
        with np.load(os.path.join(prepro, name), allow_pickle=True) as d:
            assert len(d["obs_traj"]) == ANCHORS[split] * PERSONS * 7


def test_bbox_jsons_to_scores(chain, capsys):
    root, inputs, port, prepro = chain
    assert len(os.listdir(port["obs"])) == MOMENTS * len(CAMERAS)
    for name in os.listdir(port["mf"]):
        with open(os.path.join(port["mf"], name), "rb") as f:
            gt = pickle.load(f)
        assert len(gt) == FUTURES
        assert all(len(g["x_agent_traj"]) == 8 for g in gt.values())

    models = root + "/models"
    train_cli.main([prepro, models, "chain", "--runId", "1", "--device",
                    "cpu", "--batch_size", "4", "--num_epochs", "2",
                    "--save_period", "10", "--init_lr", "0.3",
                    "--use_soft_grid_class", "--obs_len", str(OBS),
                    "--pred_len", "5", "--scene_grid_strides", "2,4",
                    *MODEL_FLAGS])
    best = os.path.join(models, "chain", "01", "best")
    assert os.listdir(best)

    traj_p, prob_p = root + "/chain.traj.p", root + "/chain.prob.p"
    inference_cli.main([best, port["obs"], port["mf"], traj_p,
                        "--save_prob_file", prob_p, "--device", "cpu",
                        "--compute_dtype", "float32",
                        "--obs_length", str(OBS), "--num_out", "3",
                        "--diverse_beam", "--diverse_gamma", "0.01",
                        "--fix_num_timestep", "1", "--grid_strides", "2,4",
                        "--scene_feat_path", inputs["scene_mf"],
                        "--scene_id2name", inputs["id2name"], *MODEL_FLAGS])
    with open(traj_p, "rb") as f:
        preds = pickle.load(f)
    assert len(preds) == MOMENTS * len(CAMERAS)
    assert all(np.asarray(p).shape == (3, 8, 2) for p in preds.values())

    capsys.readouterr()
    eval_trajs.main([port["mf"], traj_p])
    ade_fde = [float(x) for x in
               capsys.readouterr().out.strip().splitlines()[-1].split()]
    assert len(ade_fde) == 6 and np.isfinite(ade_fde).all()
    # errors in the image's pixel scale
    assert max(ade_fde) < VIDEO_W
    eval_prob.main([port["mf"], prob_p, "--scene_h", "6", "--scene_w", "8",
                    "--video_h", str(VIDEO_H), "--video_w", str(VIDEO_W)])
    nll = [float(x) for x in
           capsys.readouterr().out.strip().splitlines()[-1].split()]
    assert len(nll) == 5 and np.isfinite(nll).all()
