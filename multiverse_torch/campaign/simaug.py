"""The SimAug convergence campaign of the port: that the SimAug flagship
objective (multi-view mixup training, ``--multiview_exp 3``: one-step
FGSM toward each agent's other camera views, Beta-mixup of the hardest
view's adversarial features with a selected view's clean features,
mixed one-hot labels; reference: SimAug/code/train.py + pred_models.py
multiview tower) trains to convergence on the card.

The port's counterpart of the JAX package's ``campaign_simaug.py``, with
its stages, flags and defaults. SimAug groups examples by agent across
the 4 simulation cameras (``data/multiview.get_agent_id`` strips the
seq_key's camera token), so the data stage records every moment through
the fake CARLA backend (``tests/torch_fake_carla.py``) from FOUR rigs
(the recorder records every rig in the registry list: each view's bbox
JSON is a pinhole projection of the same world trajectories from a
different pose), then extracts frames and scene class maps, prepares the
anchor TSVs and preprocesses; ``mvt-torch-train-simaug`` runs the
published SimAug recipe on it (TRAINING.md section 2; reference:
SimAug/TRAINING.md) with a val eval every epoch.

Stages (workdir --work, default ``_campaign_simaug_torch/`` at the
repository root):

    python -m multiverse_torch.campaign.simaug data      # host
    python -m multiverse_torch.campaign.simaug train     # card
    python -m multiverse_torch.campaign.simaug artifact  # the curve
    python -m multiverse_torch.campaign.simaug all

``train`` runs on ``--device`` (default cuda, with no fallback to the
CPU; ``--device cpu --smoke --dtype float32`` for a small run on the
plain PyTorch versions). ``artifact`` writes ``TORCH_SIMAUG_CURVE.json``
(or ``--out``) from the training log and the stages' records.

Dataset dims are the flagship campaign's (camera 192x108, model scene
36x64, obs 8 / pred 12: the published SimAug sim data uses obs 12 /
pred 16; the schedule here is what differs, not the algorithm).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import time

import numpy as np

from multiverse_torch.campaign.flagship import (
    REPO,
    _run,
    check_device,
    moment,
    preprocess_main,
    python_module,
    read_stages,
    record,
    record_stage,
    stage_devices,
    write_id2name,
)
from multiverse_torch.campaign.walks import (
    CAM_H,
    CAM_W,
    DROP,
    OBS_LEN,
    PRED_LEN,
    rows_from_xy,
    walk_init,
    walk_steps,
)

# four rigs over the same ±7 m walking area: one straight-down anchor
# view plus three oblique views at 40° pitch from different sides —
# every rig sees every walker (verified by the data-stage assertions),
# but each projects a genuinely different pixel trajectory
CAMERA_RIGS = [
    {"fov": 90.0, "location_xyz": [0.0, 0.0, 18.0],
     "rotation_pyr": [-90.0, 0.0, 0.0], "width": CAM_W, "height": CAM_H},
    {"fov": 90.0, "location_xyz": [-13.0, 0.0, 11.0],
     "rotation_pyr": [-40.0, 0.0, 0.0], "width": CAM_W, "height": CAM_H},
    {"fov": 90.0, "location_xyz": [13.0, 0.0, 11.0],
     "rotation_pyr": [-40.0, 180.0, 0.0], "width": CAM_W, "height": CAM_H},
    {"fov": 90.0, "location_xyz": [0.0, -13.0, 11.0],
     "rotation_pyr": [-40.0, 90.0, 0.0], "width": CAM_W, "height": CAM_H},
]

# the published SimAug recipe (TRAINING.md §2; reference:
# SimAug/TRAINING.md "experiment 3") at the flagship campaign's dims
SIMAUG_MODEL = [
    "--obs_len", str(OBS_LEN), "--pred_len", str(PRED_LEN),
    "--emb_size", "32",
    "--enc_hidden_size", "256", "--dec_hidden_size", "256",
    "--activation_func", "tanh", "--scene_h", "36", "--scene_w", "64",
    "--scene_conv_kernel", "3", "--scene_conv_dim", "64",
    "--scene_grid_strides", "2,4", "--use_grids", "1,0",
    "--video_h", str(CAM_H), "--video_w", str(CAM_W),
    "--use_gnn", "--use_scene_enc", "--train_w_onehot",
    "--scene_class", "11",
]
SIMAUG_TRAIN = [
    "--batch_size", "12", "--init_lr", "0.3",
    "--wd", "0.001", "--learning_rate_decay", "0.95",
    "--num_epoch_per_decay", "2.0", "--grid_loss_weight", "1.0",
    "--grid_reg_loss_weight", "0.2", "--val_grid_num", "0",
    "--multiview_train", "--multiview_exp", "3", "--adv_use_fgsm",
    "--use_mixup", "--mixup_alpha", "1.0", "--adv_epsilon", "0.1",
    "--double_weighting", "--fl_gamma", "1.0",
]
# --smoke: plumbing-validation dims (CPU smoke), the same graph
# structure, small enough to run off the card in seconds
SMOKE_WIDTHS = {"--enc_hidden_size": "32", "--dec_hidden_size": "32",
                "--scene_conv_dim": "16", "--emb_size": "8"}
DEVICE_STAGES = ("train",)


# ----------------------------------------------------------- data stage


def example_keys(prepro, split):
    """Each example's ``traj_key`` in ``data_<split>.npz``, as the
    trainers' ``read_data`` makes it."""
    from multiverse_torch.config import MultiverseConfig
    from multiverse_torch.data.dataset import read_data

    return [str(k) for k in
            read_data(prepro, split, MultiverseConfig()).data["traj_key"]]


def stage_data(work, args):
    from multiverse_torch.data.multiview import get_agent_id
    from multiverse_torch.forking_paths.prepared_data import (
        extract_frames_and_seg,
        load_frame_data,
        prepare_anchor_split,
    )

    t_stage = time.time()
    rnd = np.random.RandomState(args.data_seed)
    registry = {
        "scenes": {"zara01": {"map": "Town03_ethucy", "fps": 25.0,
                              "static_cars": [], "weather": {}}},
        "cameras": {"recording": {"zara01": CAMERA_RIGS}},
    }
    os.makedirs(work, exist_ok=True)

    n_cams = len(CAMERA_RIGS)
    moments, split_names = [], {"train": [], "val": []}
    n_moments = {"train": args.train_moments, "val": args.val_moments}
    midx = 500
    for split in ("train", "val"):
        for _ in range(n_moments[split]):
            rows = []
            for pid in range(1, args.peds + 1):
                st = walk_init(rnd)
                rows += rows_from_xy(
                    walk_steps(rnd, st, args.samples), pid)
            mid = "zara01_%d_1_0_a" % midx
            midx += 1
            moments.append(moment(mid, rows))
            split_names[split] += [
                "%s_cam%d" % (mid, c + 1) for c in range(n_cams)]

    t0 = time.time()
    ds = record(work, registry, moments, args.fake_carla)
    print("recorded %d moments x %d cams in %.0fs" % (
        len(moments), n_cams, time.time() - t0))

    # sanity: every rig sees the walkers, and the views genuinely
    # differ (per-frame box centers of cam1 vs each oblique rig)
    mid0 = split_names["train"][0][:-5]
    centers = {}
    for c in range(n_cams):
        v = "%s_cam%d" % (mid0, c + 1)
        fd = load_frame_data(os.path.join(ds, "bbox", "%s.json" % v))
        assert len(fd) > args.samples * DROP - 2 * DROP, (v, len(fd))
        per_frame = {fid: {b["track_id"]: np.asarray(b["bbox"][:2])
                           for b in boxes} for fid, boxes in fd.items()}
        n_boxes = sum(len(b) for b in per_frame.values())
        assert n_boxes >= 0.9 * len(per_frame) * args.peds, (
            "rig %d loses walkers: %d boxes over %d frames x %d peds"
            % (c + 1, n_boxes, len(per_frame), args.peds))
        centers[c] = per_frame
    fid0 = sorted(centers[0])[len(centers[0]) // 2]
    for c in range(1, n_cams):
        shared = set(centers[0][fid0]) & set(centers[c][fid0])
        assert shared, "no shared walkers between rig 1 and %d" % (c + 1)
        d = np.mean([np.abs(centers[0][fid0][t]
                            - centers[c][fid0][t]).max()
                     for t in shared])
        assert d > 5.0, ("rig %d projects like rig 1 (mean |d|=%.1f px) "
                         "— camera pose ignored?" % (c + 1, d))

    # frames + scene seg per view video
    scene_dir = os.path.join(work, "anchor_scene_seg")
    frames_dir = os.path.join(work, "frames")
    for v in sum(split_names.values(), []):
        fd = load_frame_data(os.path.join(ds, "bbox", "%s.json" % v))
        ids = sorted(fd)[::DROP]
        ok = extract_frames_and_seg(
            os.path.join(ds, "videos", "%s.mp4" % v),
            os.path.join(ds, "videos_seg", "%s.mp4" % v),
            ids, frames_dir, os.path.join(scene_dir, v), v,
            start=0, scene_h=36, scene_w=64)
        assert ok, v

    id2name = write_id2name(work)

    anchor_out = os.path.join(work, "anchor")
    for split in ("train", "val"):
        counts = prepare_anchor_split(
            ds, split_names[split], anchor_out, split,
            drop_frame=DROP, min_frames=OBS_LEN + PRED_LEN)
        assert len(counts) == len(split_names[split]), (split, counts)

    # with the person boxes, each example's key is video_frame_person
    # (person_boxid2key), which get_agent_id groups across cameras; the
    # npz holds no traj_key (the JAX script reads one, and stops there)
    prepro = os.path.join(work, "prepro")
    preprocess_main(os.path.join(anchor_out, "traj_2.5fps"), prepro,
                    scene_dir, id2name, extra=(
                        "--add_person_box", "--person_box_path",
                        os.path.join(anchor_out, "anno_person_box")))

    # the multiview grouping must see real cross-camera views: assert
    # a 4-view agent group exists in the training split, by the keys the
    # trainer groups
    keys = example_keys(prepro, "train")
    n_train = len(keys)
    n_val = len(example_keys(prepro, "val"))
    group_sizes = {}
    for k in keys:
        aid = get_agent_id(k)
        group_sizes[aid] = group_sizes.get(aid, 0) + 1
    sizes = np.asarray(sorted(group_sizes.values()))
    frac4 = float((sizes == n_cams).mean())
    assert frac4 > 0.5, (
        "only %.0f%% of agent groups have all %d views" % (
            100 * frac4, n_cams))
    meta = {
        "prepro": prepro, "id2name": id2name,
        "n_train": n_train, "n_val": n_val, "n_cams": n_cams,
        "agent_groups": len(group_sizes), "frac_full_groups": frac4,
        "data_seed": args.data_seed,
        "steps_per_epoch": int(math.ceil(n_train / 12)),
    }
    with open(os.path.join(work, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    record_stage(work, "data", time.time() - t_stage)
    print("data stage done:", json.dumps(meta, indent=1))


# ---------------------------------------------------------- train stage


def _meta(work):
    with open(os.path.join(work, "meta.json")) as f:
        return json.load(f)


def model_flags(smoke):
    """SIMAUG_MODEL, at SMOKE_WIDTHS with ``smoke``."""
    flags = list(SIMAUG_MODEL)
    if smoke:
        for i, tok in enumerate(flags):
            if tok in SMOKE_WIDTHS:
                flags[i + 1] = SMOKE_WIDTHS[tok]
    return flags


def stage_train(work, args):
    meta = _meta(work)
    cmd = [
        *python_module("multiverse_torch.cli.train_simaug"),
        meta["prepro"], os.path.join(work, "runs"), "simaugA",
        "--runId", "0", "--seed", str(args.seed),
        "--num_epochs", str(args.epochs),
        "--save_period", str(meta["steps_per_epoch"]),
        "--compute_dtype", args.dtype, "--device", args.device,
        *model_flags(args.smoke), *SIMAUG_TRAIN,
    ]
    log = os.path.join(work, "train.log")
    t0 = time.time()
    r = _run(cmd, log)
    assert r.returncode == 0, "simaug train failed, see %s" % log
    record_stage(work, "train", time.time() - t0, args.device)
    print("simaug train done in %.0fs" % (time.time() - t0))


# -------------------------------------------------------- artifact stage

# mvt-torch-train-simaug's eval line (the JAX command's format)
_LINE = re.compile(
    r"^step (\d+): loss\(ma\)=([\d.eE+-]+) ([\d.eE+-]+) steps/s \| "
    r"val (\S+)=([\d.eE+-]+)")


def _parse_curve(log_path):
    curve, best = [], float("inf")
    metric = None
    with open(log_path) as f:
        for line in f:
            m = _LINE.match(line.strip())
            if not m:
                continue
            step, loss_ma, sps, metric, val = m.groups()
            val = float(val)
            is_best = val < best
            best = min(best, val)
            curve.append({"step": int(step), "loss_ma": float(loss_ma),
                          "steps_per_sec": float(sps), metric: val,
                          "is_best": is_best})
    return metric, curve


def stage_artifact(work, args):
    meta = _meta(work)
    metric, curve = _parse_curve(os.path.join(work, "train.log"))
    assert curve, "no eval lines parsed from train.log"
    run_dir = os.path.join(work, "runs", "simaugA", "00")
    with open(os.path.join(run_dir, "val_perf.json")) as f:
        best = json.load(f)["best"]
    stages = read_stages(work)
    device = stage_devices(stages)
    first, last = curve[0], curve[-1]
    artifact = {
        "experiment": "SimAug convergence campaign of multiverse_torch: "
                      "the published multiview-mixup recipe "
                      "(--multiview_exp 3 --adv_use_fgsm --use_mixup "
                      "--double_weighting) on a generated 4-camera "
                      "fake-CARLA dataset, %s on %s"
                      % (args.dtype, device if isinstance(device, str)
                         else "the cards of 'device'"),
        "device": device,
        "stage_seconds": {s: r["seconds"] for s, r in stages.items()},
        "dataset": {k: meta[k] for k in
                    ("n_train", "n_val", "n_cams", "agent_groups",
                     "frac_full_groups", "steps_per_epoch")},
        "epochs": args.epochs,
        "command_flags": model_flags(args.smoke) + SIMAUG_TRAIN,
        "curve": curve,
        "best": best,
        "convergence": {
            "metric": metric,
            "first_eval": first[metric], "final_eval": last[metric],
            "improvement_x": first[metric] / max(last[metric], 1e-9),
            "loss_first": first["loss_ma"], "loss_final": last["loss_ma"],
            "best_flips": sum(1 for c in curve if c["is_best"]),
            "steps_per_sec_median": float(np.median(
                [c["steps_per_sec"] for c in curve])),
        },
    }
    out = args.out or os.path.join(REPO, "TORCH_SIMAUG_CURVE.json")
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps({"out": out,
                      "convergence": artifact["convergence"]}, indent=1))


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m multiverse_torch.campaign.simaug",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("stage", choices=["data", "train", "artifact", "all"])
    ap.add_argument("--work",
                    default=os.path.join(REPO, "_campaign_simaug_torch"))
    ap.add_argument("--data_seed", type=int, default=23)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16",
                    help="compute dtype; CPU smoke runs need float32")
    ap.add_argument("--device", default="cuda",
                    help="device of the training command (cuda, or cpu "
                         "for the plain PyTorch versions)")
    ap.add_argument("--train_moments", type=int, default=6)
    ap.add_argument("--val_moments", type=int, default=1)
    ap.add_argument("--peds", type=int, default=10)
    ap.add_argument("--samples", type=int, default=40,
                    help="2.5 fps world samples per walker")
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the model dims for a CPU plumbing "
                         "check (the artifact run uses the flagship "
                         "dims)")
    ap.add_argument("--fake_carla", default=None,
                    help="the port's fake carla module (default: "
                         "tests/torch_fake_carla.py of this checkout)")
    ap.add_argument("--out", default=None,
                    help="the artifact's path (default: "
                         "TORCH_SIMAUG_CURVE.json at the repository root)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.work = os.path.abspath(args.work)
    stages = (["data", "train", "artifact"]
              if args.stage == "all" else [args.stage])
    if any(s in DEVICE_STAGES for s in stages):
        check_device(args.device)
    for stage in stages:
        globals()["stage_" + stage](args.work, args)


if __name__ == "__main__":
    main()
