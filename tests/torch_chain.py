"""The Forking Paths workflow L0 -> L6 at ``tests/test_full_chain.py``'s
toy scale, for ``tests/test_torch_full_chain.py``: importable without
jax, so the same steps run beside the JAX package and, in a subprocess,
with jax blocked.

``record_and_prepare(m, root)`` records two moments through a fake
``carla`` (straight-down 192x108 rig), extracts frames and scene class
maps, prepares the multi-future and anchor splits and preprocesses; ``m``
names one package's pieces (:func:`port_steps`, or the JAX package's in
the test). ``train_decode_score(root, paths)`` then trains the port
2 epochs on the CPU, decodes K = 3 beams and scores them."""

from __future__ import annotations

import json
import os
import pickle
import types

import numpy as np

OBS = 4
VIDEONAMES = ["zara01_0_1_0_a_cam1", "zara01_0_1_1_b_cam1"]
SIZE_FLAGS = ["--scene_h", "12", "--scene_w", "16",
              "--video_h", "108", "--video_w", "192"]
MODEL_FLAGS = ["--emb_size", "8", "--enc_hidden_size", "16",
               "--dec_hidden_size", "16", "--scene_conv_dim", "8",
               "--use_grids", "1,0", "--use_gnn", "--use_scene_enc"]


def port_steps():
    from multiverse_torch.cli import preprocess
    from multiverse_torch.cli.vis_dataset import record_moments_main
    from multiverse_torch.forking_paths import controls, prepared_data

    return types.SimpleNamespace(
        controls=controls, prepared=prepared_data,
        record_moments_main=record_moments_main,
        preprocess_main=preprocess.main)


def walk_rows(diverge_dy):
    """Shared obs through frame 70, then a future that diverges with
    slope ``diverge_dy``; plus a second pedestrian (pid 2)."""
    rows = []
    for f in range(0, 141, 10):
        x = -4.0 + 0.05 * f
        y = 0.0 if f <= 70 else diverge_dy * (f - 70) / 70.0
        rows.append((f, 1, x, y, 0.5))
        rows.append((f, 2, x - 1.0, y + 1.5, 0.5))
    return rows


def record_and_prepare(m, root: str) -> dict:
    """L0 -> L2 with package ``m``'s pieces, under ``root``; the fake
    ``carla`` must be installed. Returns the paths the later stages
    read."""
    registry = {
        "scenes": {"zara01": {"map": "Town03_ethucy", "fps": 25.0,
                              "static_cars": [], "weather": {}}},
        "cameras": {"recording": {"zara01": [
            {"fov": 90.0, "location_xyz": [0.0, 0.0, 18.0],
             "rotation_pyr": [-90.0, 0.0, 0.0],
             "width": 192, "height": 108}]}},
    }
    reg_path = os.path.join(root, "registry.json")
    with open(reg_path, "w") as f:
        json.dump(registry, f)
    moments = []
    for dest, annot, dy in ((0, "a", 2.0), (1, "b", -2.0)):
        controls, _ = m.controls.traj_to_controls(
            np.asarray(walk_rows(dy), np.float64), -1, -1, 25.0)
        moments.append({"scenename": "zara01",
                        "moment_id": "zara01_0_1_%d_%s" % (dest, annot),
                        "ped_controls": controls, "vehicle_controls": {},
                        "x_agents": {"1": []}})
    moment_json = os.path.join(root, "moments.json")
    with open(moment_json, "w") as f:
        json.dump(moments, f, default=float)
    ds = os.path.join(root, "dataset")
    m.record_moments_main([moment_json, ds, "--scene_registry", reg_path])

    frame_data = m.prepared.load_frame_data(
        os.path.join(ds, "bbox", VIDEONAMES[0] + ".json"))
    needed = sorted(frame_data)[32::10]
    assert len(needed) == 11
    obs_ids, train_ids = needed[:OBS], sorted(frame_data)[::10]

    mf_scene = os.path.join(root, "mf_scene_seg")
    train_scene = os.path.join(root, "train_scene_seg")
    frames = os.path.join(root, "frames")
    assert m.prepared.extract_frames_and_seg(
        os.path.join(ds, "videos", VIDEONAMES[0] + ".mp4"),
        os.path.join(ds, "videos_seg", VIDEONAMES[0] + ".mp4"),
        obs_ids, frames, os.path.join(mf_scene, "zara01_0_1_cam1"),
        "zara01_0_1_cam1", start=32, scene_h=12, scene_w=16)
    for v in VIDEONAMES:
        assert m.prepared.extract_frames_and_seg(
            os.path.join(ds, "videos", v + ".mp4"),
            os.path.join(ds, "videos_seg", v + ".mp4"),
            train_ids, frames, os.path.join(train_scene, v), v, start=0,
            scene_h=12, scene_w=16)
    seg = np.load(os.path.join(mf_scene, "zara01_0_1_cam1",
                               "zara01_0_1_cam1_F_00000000.npy"))
    assert seg.shape == (12, 16) and (seg == 13).all()

    classes = sorted(int(c) for c in np.unique(seg))
    oldid2new = {str(c): i + 1 for i, c in enumerate(classes)}
    id2name = os.path.join(root, "scene_id2name.json")
    with open(id2name, "w") as f:
        json.dump({"oldid2new": oldid2new,
                   "id2name": {str(v): "class%s" % k
                               for k, v in oldid2new.items()}}, f)

    obs_out = os.path.join(root, "prepared_obs")
    mf_out = os.path.join(root, "multifuture")
    stats = m.prepared.prepare_multifuture_split(
        ds, VIDEONAMES, obs_out, mf_out, "test", obs_length=OBS)
    assert stats["skipped"] == 0 and stats["num_obs"] == 1
    with open(os.path.join(mf_out, "test", "zara01_0_1_cam1.p"), "rb") as f:
        gt = pickle.load(f)
    assert set(gt) == set(VIDEONAMES)
    assert all(len(g["x_agent_traj"]) == 7 for g in gt.values())
    anchor_out = os.path.join(root, "anchor")
    for split in ("train", "val", "test"):
        counts = m.prepared.prepare_anchor_split(
            ds, VIDEONAMES, anchor_out, split, drop_frame=10, min_frames=5)
        assert counts == [len(train_ids)] * 2

    prepro = os.path.join(root, "prepro")
    m.preprocess_main([
        os.path.join(anchor_out, "traj_2.5fps"), prepro,
        "--obs_len", str(OBS), "--pred_len", "5", "--add_grid",
        "--add_all_reg", "--add_scene", "--scene_feat_path", train_scene,
        "--scene_id2name", id2name, "--direct_scene_feat",
        "--grid_strides", "2,4", *SIZE_FLAGS])
    assert os.path.exists(os.path.join(prepro, "data_train.npz"))
    return {"ds": ds, "obs": os.path.join(obs_out, "traj_2.5fps", "test"),
            "mf": os.path.join(mf_out, "test"), "mf_scene": mf_scene,
            "id2name": id2name, "prepro": prepro,
            "scene_class": str(len(oldid2new) + 1)}


def inference_flags(paths: dict) -> list:
    return ["--obs_length", str(OBS), "--num_out", "3", "--diverse_beam",
            "--diverse_gamma", "0.01", "--fix_num_timestep", "1",
            "--grid_strides", "2,4", "--scene_feat_path", paths["mf_scene"],
            "--scene_id2name", paths["id2name"], "--scene_class",
            paths["scene_class"], "--batch_size", "1", "--compute_dtype",
            "float32", *MODEL_FLAGS, *SIZE_FLAGS]


def train_decode_score(root: str, paths: dict) -> dict:
    """L4 -> L6 in the port on the CPU; returns the best checkpoint's
    directory, the decoded trajectories and the printed scores."""
    import contextlib
    import io

    from multiverse_torch.cli import multifuture_eval_trajs as eval_trajs
    from multiverse_torch.cli import multifuture_eval_trajs_prob as eval_prob
    from multiverse_torch.cli import multifuture_inference, train

    models = os.path.join(root, "models")
    train.main([paths["prepro"], models, "chain", "--runId", "1",
                "--device", "cpu", "--batch_size", "4", "--num_epochs", "2",
                "--save_period", "5", "--init_lr", "0.3", "--obs_len",
                str(OBS), "--pred_len", "5", "--scene_grid_strides", "2,4",
                "--scene_class", paths["scene_class"], *MODEL_FLAGS,
                *SIZE_FLAGS])
    best = os.path.join(models, "chain", "01", "best")
    assert os.listdir(best)
    traj_p = os.path.join(root, "chain.traj.p")
    prob_p = os.path.join(root, "chain.prob.p")
    multifuture_inference.main([best, paths["obs"], paths["mf"], traj_p,
                                "--save_prob_file", prob_p, "--device",
                                "cpu", *inference_flags(paths)])
    with open(traj_p, "rb") as f:
        preds = pickle.load(f)
    assert set(preds) == {"zara01_0_1_cam1"}
    assert np.asarray(preds["zara01_0_1_cam1"]).shape == (3, 7, 2)

    def last_line(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        return [float(x) for x in buf.getvalue().strip().splitlines()[-1]
                .split()]

    ade_fde = last_line(eval_trajs.main, [paths["mf"], traj_p])
    assert len(ade_fde) == 6
    assert all(np.isfinite(ade_fde[i]) for i in (0, 2, 3, 5))
    assert ade_fde[2] < 192
    nll = last_line(eval_prob.main, [
        paths["mf"], prob_p, "--scene_h", "6", "--scene_w", "8",
        "--video_h", "108", "--video_w", "192"])
    assert len(nll) == 5 and all(np.isfinite(nll)) and min(nll) > 0
    return {"best": best, "preds": preds, "ade_fde": ade_fde, "nll": nll}
