"""The flagship convergence campaign of the port: that training learns,
end to end, on the card.

The port's counterpart of the JAX package's ``campaign.py``, with its
stages, flags and defaults. A structured dataset is generated through
the fake CARLA backend (``tests/torch_fake_carla.py``): walkers with
kinematics (straight walks, gentle curves, futures diverging after the
observation), recorded, extracted, prepared and preprocessed through the
port's own dataset commands. ``mvt-torch-train`` then runs the published
flagship command (TRAINING.md Step 2: batch 20, adadelta lr 0.3, wd
0.001, grids 2,4 both active) for a multi-epoch schedule with a val
eval every epoch; a second run is SIGKILLed mid-flight and resumed with
``--load``; the best checkpoint of the first drives
``mvt-torch-multifuture-inference`` (f32, and bf16 with the int8a
decode) and both evaluators.

Stages (each writes under --work, default ``_campaign_torch/`` at the
repository root):

    python -m multiverse_torch.campaign.flagship data      # host
    python -m multiverse_torch.campaign.flagship train     # card: run A
    python -m multiverse_torch.campaign.flagship resume    # card: run B
    python -m multiverse_torch.campaign.flagship infer     # card: decode
    python -m multiverse_torch.campaign.flagship artifact  # the curve
    python -m multiverse_torch.campaign.flagship all

Every training and inference command is a subprocess on ``--device``
(default cuda; with no GPU the stages that run them stop, and only
``--device cpu`` runs them on the plain PyTorch versions). Each stage
adds its wall seconds (and, on cuda, the card's name and power limit)
to ``stages.json``; ``artifact`` writes ``TORCH_TRAIN_CURVE.json`` (or
``--out``) from the run directories and those records, so it runs
anywhere.

The dataset/video dims are the recorded camera's (192x108); the model
dims are the published flagship ones (scene 36x64, grids 18x32 + 9x16,
D=256, obs 8 / pred 12).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np

from multiverse_torch.campaign.walks import (
    CAM_H,
    CAM_W,
    DROP,
    FLAGSHIP_MODEL,
    FLAGSHIP_TRAIN,
    MF_START,
    OBS_LEN,
    PRED_LEN,
    rows_from_xy,
    walk_init,
    walk_steps,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FAKE_CARLA = os.path.join(REPO, "tests", "torch_fake_carla.py")
# seconds between the kill poller's looks at run B's save directory
POLL_S = 2.0
# stages that run commands on --device
DEVICE_STAGES = ("train", "resume", "infer")
# the decode's widths: FLAGSHIP_MODEL's (scene_conv_dim is the
# inference command's default)
INFER_WIDTHS = ["--emb_size", "32", "--enc_hidden_size", "256",
                "--dec_hidden_size", "256", "--scene_conv_dim", "64"]


# ------------------------------------------------------- shared helpers


def install_fake_carla(path=None):
    """Load the port's fake ``carla`` (``tests/torch_fake_carla.py`` of
    this checkout, or ``path``) afresh, so its actor ids start at 1, and
    install it as ``carla``. There is no fallback: a missing file
    raises."""
    path = path or FAKE_CARLA
    if not os.path.isfile(path):
        raise FileNotFoundError(
            "the fake CARLA backend is not at %s: run from a checkout "
            "that holds tests/torch_fake_carla.py, or pass --fake_carla"
            % path)
    spec = importlib.util.spec_from_file_location("torch_fake_carla", path)
    fake = importlib.util.module_from_spec(spec)
    # dataclasses look their module up while the class is made
    sys.modules["torch_fake_carla"] = fake
    spec.loader.exec_module(fake)
    fake.install()
    return fake


def check_device(device: str) -> None:
    """Refuse a cuda device where CUDA is not available: no stage runs
    on the CPU unless asked to with ``--device cpu``."""
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(
            "--device %s: CUDA is not available; the campaign runs on the "
            "card, or on the CPU with --device cpu (and small widths)"
            % device)


def device_reading(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``cpu``."""
    if not device.startswith("cuda"):
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return smi.stdout.strip().splitlines()[0]


def record_stage(work, stage, seconds, device=None):
    """Add a stage's wall seconds (and the device it ran on) to
    ``work/stages.json``."""
    path = os.path.join(work, "stages.json")
    stages = {}
    if os.path.exists(path):
        with open(path) as f:
            stages = json.load(f)
    stages[stage] = {"seconds": seconds}
    if device is not None:
        stages[stage]["device"] = device_reading(device)
    with open(path, "w") as f:
        json.dump(stages, f, indent=1)


def read_stages(work):
    path = os.path.join(work, "stages.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def python_module(module):
    """The command that runs ``python -m module``."""
    return [sys.executable, "-m", module]


def _run(cmd, log_path, **kw):
    print("+ %s" % " ".join(cmd), flush=True)
    with open(log_path, "a") as log:
        log.write("+ %s\n" % " ".join(cmd))
        log.flush()
        return subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                              cwd=REPO, **kw)


def write_id2name(work):
    """The scene_class table padded to the flagship 11 (unused ids
    inert)."""
    id2name = os.path.join(work, "scene_id2name.json")
    oldid2new = {"13": 1}
    for i, filler in enumerate((1, 2, 3, 4, 5, 6, 7, 8, 9)):
        oldid2new[str(filler)] = i + 2
    with open(id2name, "w") as f:
        json.dump({"oldid2new": oldid2new,
                   "id2name": {str(v): "class%s" % k
                               for k, v in oldid2new.items()}}, f)
    return id2name


def preprocess_main(traj_dir, prepro, scene_dir, id2name, extra=()):
    from multiverse_torch.cli import preprocess as preprocess_cli

    preprocess_cli.main([
        traj_dir, prepro,
        "--obs_len", str(OBS_LEN), "--pred_len", str(PRED_LEN),
        "--add_grid", "--add_all_reg", "--add_scene",
        "--scene_feat_path", scene_dir,
        "--scene_id2name", id2name, "--direct_scene_feat",
        "--scene_h", "36", "--scene_w", "64",
        "--video_h", str(CAM_H), "--video_w", str(CAM_W),
        "--grid_strides", "2,4", *extra,
    ])


def moment(mid, rows_all):
    from multiverse_torch.forking_paths.controls import traj_to_controls

    controls, _ = traj_to_controls(
        np.asarray(rows_all, np.float64), -1, -1, 25.0)
    return {"scenename": "zara01", "moment_id": mid,
            "ped_controls": controls, "vehicle_controls": {},
            "x_agents": {"1": []}}


def record(work, registry, moments, fake_carla=None):
    """Write the registry and the moments, record them all through the
    fake backend in this process; returns the dataset directory."""
    from multiverse_torch.cli.vis_dataset import record_moments_main

    reg_path = os.path.join(work, "registry.json")
    with open(reg_path, "w") as f:
        json.dump(registry, f)
    moment_json = os.path.join(work, "moments.json")
    with open(moment_json, "w") as f:
        json.dump(moments, f, default=float)
    ds = os.path.join(work, "dataset")
    install_fake_carla(fake_carla)
    try:
        record_moments_main([moment_json, ds, "--scene_registry",
                             reg_path])
    finally:
        sys.modules.pop("carla", None)
    return ds


# ----------------------------------------------------------- data stage


def stage_data(work, args):
    from multiverse_torch.forking_paths.prepared_data import (
        extract_frames_and_seg,
        load_frame_data,
        prepare_anchor_split,
        prepare_multifuture_split,
    )

    t_stage = time.time()
    rnd = np.random.RandomState(args.data_seed)
    registry = {
        "scenes": {"zara01": {"map": "Town03_ethucy", "fps": 25.0,
                              "static_cars": [], "weather": {}}},
        "cameras": {"recording": {"zara01": [
            {"fov": 90.0, "location_xyz": [0.0, 0.0, 18.0],
             "rotation_pyr": [-90.0, 0.0, 0.0],
             "width": CAM_W, "height": CAM_H}]}},
    }
    os.makedirs(work, exist_ok=True)

    moments, split_names = [], {"train": [], "val": [], "test": []}
    n_anchor = {"train": args.train_moments, "val": args.val_moments,
                "test": args.test_moments}
    midx = 100
    for split in ("train", "val", "test"):
        for _ in range(n_anchor[split]):
            rows = []
            for pid in range(1, args.peds + 1):
                st = walk_init(rnd)
                rows += rows_from_xy(
                    walk_steps(rnd, st, args.anchor_samples), pid)
            mid = "zara01_%d_1_0_a" % midx
            midx += 1
            moments.append(moment(mid, rows))
            split_names[split].append(mid + "_cam1")

    # multi-future groups: shared obs (x-agent pid 1 + context peds),
    # three futures diverging in heading AFTER the observation window
    mf_names, diverge_idx = [], (MF_START + (OBS_LEN + 1) * DROP) // DROP
    for g in range(args.mf_groups):
        ctx_rows = []
        for pid in range(2, 2 + args.mf_other_peds):
            st = walk_init(rnd)
            ctx_rows += rows_from_xy(
                walk_steps(rnd, st, args.mf_samples), pid)
        st0 = walk_init(rnd, center_r=3.0)
        st0["v"] = float(rnd.uniform(0.3, 0.5))
        prefix = walk_steps(rnd, st0, diverge_idx + 1)
        for d, (annot, dth) in enumerate(
                (("a", -40.0), ("b", 0.0), ("c", 40.0))):
            st = dict(st0)
            st["th"] += math.radians(dth)
            branch_rnd = np.random.RandomState(
                args.data_seed + 7919 * g + d)
            tail = walk_steps(branch_rnd, st,
                              args.mf_samples - diverge_idx - 1)
            xy = np.concatenate([prefix, tail], axis=0)
            mid = "zara01_%d_1_%d_%s" % (g, d, annot)
            moments.append(moment(mid, rows_from_xy(xy, 1) + ctx_rows))
            mf_names.append(mid + "_cam1")

    t0 = time.time()
    ds = record(work, registry, moments, args.fake_carla)
    print("recorded %d moments in %.0fs" % (len(moments), time.time() - t0))

    # sanity: boxes move and stay in-frame
    fd = load_frame_data(os.path.join(
        ds, "bbox", "%s.json" % split_names["train"][0]))
    pts = np.asarray([b["bbox"][:2] for fr in fd.values() for b in fr])
    assert len(fd) > args.anchor_samples * DROP - 2 * DROP, len(fd)
    assert pts.std(0).min() > 2.0, "walkers did not move: %s" % pts.std(0)

    # ---- frames + scene seg
    anchor_scene = os.path.join(work, "anchor_scene_seg")
    frames_dir = os.path.join(work, "frames")
    for v in sum(split_names.values(), []):
        fd = load_frame_data(os.path.join(ds, "bbox", "%s.json" % v))
        ids = sorted(fd)[::DROP]
        ok = extract_frames_and_seg(
            os.path.join(ds, "videos", "%s.mp4" % v),
            os.path.join(ds, "videos_seg", "%s.mp4" % v),
            ids, frames_dir, os.path.join(anchor_scene, v), v,
            start=0, scene_h=36, scene_w=64)
        assert ok, v
    mf_scene = os.path.join(work, "mf_scene_seg")
    obs_keys = sorted({"_".join(n.split("_")[:3]) + "_cam1"
                       for n in mf_names})
    for obs_key in obs_keys:
        scene, g, pid, cam = obs_key.split("_")
        src = "%s_%s_%s_0_a_%s" % (scene, g, pid, cam)
        fd = load_frame_data(os.path.join(ds, "bbox", "%s.json" % src))
        ids = sorted(fd)[MF_START::DROP][:OBS_LEN]
        ok = extract_frames_and_seg(
            os.path.join(ds, "videos", "%s.mp4" % src),
            os.path.join(ds, "videos_seg", "%s.mp4" % src),
            ids, frames_dir, os.path.join(mf_scene, obs_key), obs_key,
            start=MF_START, scene_h=36, scene_w=64)
        assert ok, obs_key

    id2name = write_id2name(work)

    # ---- anchor prep (train/val/test TSVs) + multifuture prep (test)
    anchor_out = os.path.join(work, "anchor")
    for split in ("train", "val", "test"):
        counts = prepare_anchor_split(
            ds, split_names[split], anchor_out, split,
            drop_frame=DROP, min_frames=OBS_LEN + PRED_LEN)
        assert len(counts) == len(split_names[split]), (split, counts)
    obs_out = os.path.join(work, "prepared_obs")
    mf_out = os.path.join(work, "multifuture")
    stats = prepare_multifuture_split(
        ds, mf_names, obs_out, mf_out, "test", obs_length=OBS_LEN)
    assert stats["skipped"] == 0, stats
    assert stats["future_len_min"] >= PRED_LEN, stats
    print("multifuture prep:", stats)

    # ---- preprocess at the flagship dims
    prepro = os.path.join(work, "prepro")
    preprocess_main(os.path.join(anchor_out, "traj_2.5fps"), prepro,
                    anchor_scene, id2name)
    with np.load(os.path.join(prepro, "data_train.npz"),
                 allow_pickle=True) as z:
        n_train = len(z["obs_traj"])
    with np.load(os.path.join(prepro, "data_val.npz"),
                 allow_pickle=True) as z:
        n_val = len(z["obs_traj"])
    meta = {
        "prepro": prepro, "anchor_scene": anchor_scene,
        "mf_scene": mf_scene, "obs_out": obs_out, "mf_out": mf_out,
        "id2name": id2name, "n_train": n_train, "n_val": n_val,
        "n_mf_obs": len(obs_keys), "data_seed": args.data_seed,
        "steps_per_epoch": int(math.ceil(n_train / 20)),
    }
    with open(os.path.join(work, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    record_stage(work, "data", time.time() - t_stage)
    print("data stage done:", json.dumps(meta, indent=1))


# ---------------------------------------------------------- train stage


def _meta(work):
    with open(os.path.join(work, "meta.json")) as f:
        return json.load(f)


def _train_cmd(work, meta, name, epochs, seed, dtype, extra=(),
               device="cuda"):
    return [
        *python_module("multiverse_torch.cli.train"),
        meta["prepro"], os.path.join(work, "runs"), name,
        "--runId", "0", "--seed", str(seed),
        "--num_epochs", str(epochs),
        "--save_period", str(meta["steps_per_epoch"]),
        "--compute_dtype", dtype, "--device", device,
        *FLAGSHIP_MODEL, *FLAGSHIP_TRAIN, *extra,
    ]


def stage_train(work, args):
    meta = _meta(work)
    log = os.path.join(work, "train_A.log")
    t0 = time.time()
    r = _run(_train_cmd(work, meta, "campA", args.epochs, args.seed,
                        args.dtype, device=args.device), log)
    assert r.returncode == 0, "train A failed, see %s" % log
    record_stage(work, "train", time.time() - t0, args.device)
    print("run A done in %.0fs" % (time.time() - t0))


def saved_steps(save_dir):
    """The finished steps of a run's ``save`` directory: the names that
    are step numbers. A step in flight is still under its temporary name
    (``<step>.orbax-checkpoint-tmp-<n>``), so it is not one."""
    if not os.path.isdir(save_dir):
        return []
    return sorted(int(d) for d in os.listdir(save_dir) if d.isdigit())


def stage_resume(work, args):
    """Run B: same config/seed, SIGKILLed after ~half the epochs'
    checkpoints exist, then resumed with --load for the remaining
    epochs (reference capability: TRAINING.md notes training is
    resumable from `save`). --load restores the parameters only: the
    learning-rate schedule restarts, as in the reference, and the new
    saves continue above the latest step."""
    meta = _meta(work)
    spe = meta["steps_per_epoch"]
    half_epochs = args.epochs // 2
    kill_after_step = half_epochs * spe
    run_dir = os.path.join(work, "runs", "campB", "00")
    save = os.path.join(run_dir, "save")
    log = os.path.join(work, "train_B.log")

    t0 = time.time()
    cmd = _train_cmd(work, meta, "campB", args.epochs, args.seed,
                     args.dtype, device=args.device)
    print("+ %s" % " ".join(cmd), flush=True)
    logf = open(log, "a")
    proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                            cwd=REPO)
    killed_at = None
    try:
        while proc.poll() is None:
            time.sleep(POLL_S)
            steps = saved_steps(save)
            if steps and max(steps) >= kill_after_step:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                # a save that finished between the look and the kill
                killed_at = max(saved_steps(save))
                break
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()
    assert killed_at is not None, \
        "run B finished before the kill point — raise --epochs"
    print("run B SIGKILLed with latest checkpoint at step %d" % killed_at)

    remaining = args.epochs - killed_at // spe
    r = _run(_train_cmd(work, meta, "campB", remaining, args.seed,
                        args.dtype, extra=("--load",), device=args.device),
             log)
    assert r.returncode == 0, "run B resume failed, see %s" % log
    new = [s for s in saved_steps(save) if s > killed_at]
    assert new, "run B saved nothing above step %d" % killed_at
    with open(os.path.join(work, "resume.json"), "w") as f:
        json.dump({"killed_at_step": killed_at,
                   "resumed_epochs": remaining}, f)
    record_stage(work, "resume", time.time() - t0, args.device)


# ---------------------------------------------------------- infer stage


def _last_floats(stdout):
    return [float(x) for x in stdout.strip().splitlines()[-1].split()]


def stage_infer(work, args):
    meta = _meta(work)
    t0 = time.time()
    best = os.path.join(work, "runs", "campA", "00", "best")
    results = {}
    tiers = [("f32", ["--compute_dtype", "float32"])]
    if args.dtype == "bfloat16":
        tiers.append(("serving", ["--compute_dtype", "bfloat16",
                                  "--decode_quant", "int8a"]))
    for tier, tier_flags in tiers:
        out_file = os.path.join(work, "camp_%s.traj.p" % tier)
        prob_file = os.path.join(work, "camp_%s.prob.p" % tier)
        cmd = [
            *python_module("multiverse_torch.cli.multifuture_inference"),
            best, os.path.join(meta["obs_out"], "traj_2.5fps", "test"),
            os.path.join(meta["mf_out"], "test"), out_file,
            "--save_prob_file", prob_file,
            "--obs_length", str(OBS_LEN), "--num_out", "20",
            "--diverse_beam", "--diverse_gamma", "0.01",
            "--fix_num_timestep", "1",
            # the reference's published flow: trained with both grid
            # scales, decoded with scale 0 active (TESTING.md)
            "--grid_strides", "2,4", "--use_grids", "1,0",
            "--use_gnn", "--use_scene_enc",
            "--scene_feat_path", meta["mf_scene"],
            "--scene_id2name", meta["id2name"],
            "--scene_h", "36", "--scene_w", "64", "--scene_class", "11",
            "--video_h", str(CAM_H), "--video_w", str(CAM_W),
            *INFER_WIDTHS,
            "--batch_size", "16", "--device", args.device, *tier_flags,
        ]
        log = os.path.join(work, "infer_%s.log" % tier)
        r = _run(cmd, log)
        assert r.returncode == 0, "inference failed, see %s" % log

        # the port's evaluator
        ours = subprocess.run(
            [*python_module("multiverse_torch.cli.multifuture_eval_trajs"),
             os.path.join(meta["mf_out"], "test"), out_file],
            capture_output=True, text=True, cwd=REPO)
        assert ours.returncode == 0, ours.stderr
        our_vals = _last_floats(ours.stdout)
        # the reference evaluator, verbatim, where its checkout is here
        ref_vals = None
        if args.reference_eval and os.path.exists(args.reference_eval):
            ref = subprocess.run(
                [sys.executable, args.reference_eval,
                 os.path.join(meta["mf_out"], "test"), out_file],
                capture_output=True, text=True)
            assert ref.returncode == 0, ref.stderr
            ref_vals = _last_floats(ref.stdout)
            np.testing.assert_allclose(our_vals, ref_vals, rtol=1e-6,
                                       equal_nan=True)
        nll = subprocess.run(
            [*python_module(
                "multiverse_torch.cli.multifuture_eval_trajs_prob"),
             os.path.join(meta["mf_out"], "test"), prob_file,
             "--scene_h", "18", "--scene_w", "32",
             "--video_h", str(CAM_H), "--video_w", str(CAM_W)],
            capture_output=True, text=True, cwd=REPO)
        assert nll.returncode == 0, nll.stderr
        nll_vals = _last_floats(nll.stdout)
        results[tier] = {
            "cols": ["ade_45", "ade_td", "ade_all",
                     "fde_45", "fde_td", "fde_all"],
            "ours": our_vals, "reference_evaluator": ref_vals,
            "nll": nll_vals,
        }
        print(tier, json.dumps(results[tier]))
    with open(os.path.join(work, "infer.json"), "w") as f:
        json.dump(results, f, indent=1)
    record_stage(work, "infer", time.time() - t0, args.device)


# -------------------------------------------------------- artifact stage


def _curve(run_dir):
    with open(os.path.join(run_dir, "val_perf.json")) as f:
        perf = json.load(f)
    curve = [{"step": e[2], "loss_ma": e[0], "is_best": e[3],
              **{k: v for k, v in e[1].items() if "@T" not in k}}
             for e in perf["val_perf"]]
    return perf["best"], curve


def stage_devices(stages):
    """The card readings of the stages that ran on a device: one string
    where they agree, else each stage's."""
    readings = {s: r["device"] for s, r in stages.items() if "device" in r}
    if len(set(readings.values())) == 1:
        return next(iter(readings.values()))
    return readings


def stage_artifact(work, args):
    meta = _meta(work)
    best_a, curve_a = _curve(os.path.join(work, "runs", "campA", "00"))
    best_b, curve_b = _curve(os.path.join(work, "runs", "campB", "00"))
    with open(os.path.join(work, "resume.json")) as f:
        resume = json.load(f)
    with open(os.path.join(work, "infer.json")) as f:
        infer = json.load(f)
    stages = read_stages(work)
    device = stage_devices(stages)

    metric = "grid0_traj_ade"
    first = next(c for c in curve_a if c["loss_ma"] is not None)
    last = curve_a[-1]
    flips = sum(1 for c in curve_a if c["is_best"])
    # "within noise": compare A's final val metric with B's, against
    # the spread of A's own last few evals (converged-plateau noise)
    tail = [c[metric] for c in curve_a[-4:]]
    spread = float(np.std(tail))
    delta = abs(curve_b[-1][metric] - last[metric])
    artifact = {
        "experiment": "convergence campaign of multiverse_torch "
                      "(fake-CARLA structured dataset, published "
                      "flagship training command, %s on %s)"
                      % (args.dtype, device if isinstance(device, str)
                         else "the cards of 'device'"),
        "device": device,
        "stage_seconds": {s: r["seconds"] for s, r in stages.items()},
        "dataset": {k: meta[k] for k in
                    ("n_train", "n_val", "n_mf_obs", "steps_per_epoch")},
        "epochs": args.epochs,
        "run_A": {"best": best_a, "curve": curve_a},
        "run_B_resume": {"best": best_b, "curve": curve_b, **resume},
        "convergence": {
            "metric": metric,
            "first_eval": first[metric], "final_eval": last[metric],
            "improvement_x": first[metric] / max(last[metric], 1e-9),
            "loss_first": first["loss_ma"], "loss_final": last["loss_ma"],
            "best_flips": flips,
        },
        "resume_check": {
            "final_A": last[metric], "final_B": curve_b[-1][metric],
            "abs_delta": delta, "plateau_std_A_last4": spread,
            "within_noise": bool(delta <= max(3 * spread,
                                              0.05 * last[metric])),
        },
        "final_inference": infer,
    }
    out = args.out or os.path.join(REPO, "TORCH_TRAIN_CURVE.json")
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps({
        "out": out,
        "convergence": artifact["convergence"],
        "resume_check": artifact["resume_check"],
    }, indent=1))


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m multiverse_torch.campaign.flagship",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("stage", choices=["data", "train", "resume",
                                      "infer", "artifact", "all"])
    ap.add_argument("--work", default=os.path.join(REPO, "_campaign_torch"))
    ap.add_argument("--data_seed", type=int, default=17)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--dtype", default="bfloat16",
                    help="train/serve compute dtype; CPU smoke runs need float32")
    ap.add_argument("--device", default="cuda",
                    help="device of every training and inference command "
                         "(cuda, or cpu for the plain PyTorch versions)")
    ap.add_argument("--train_moments", type=int, default=16)
    ap.add_argument("--val_moments", type=int, default=3)
    ap.add_argument("--test_moments", type=int, default=2)
    ap.add_argument("--mf_groups", type=int, default=48)
    ap.add_argument("--peds", type=int, default=12)
    ap.add_argument("--mf_other_peds", type=int, default=5)
    ap.add_argument("--anchor_samples", type=int, default=40)
    ap.add_argument("--mf_samples", type=int, default=25)
    ap.add_argument("--fake_carla", default=None,
                    help="the port's fake carla module (default: "
                         "tests/torch_fake_carla.py of this checkout)")
    ap.add_argument("--reference_eval", default=None,
                    help="the reference's multifuture_eval_trajs.py; where "
                         "it exists, its scores must equal the port's")
    ap.add_argument("--out", default=None,
                    help="the artifact's path (default: "
                         "TORCH_TRAIN_CURVE.json at the repository root)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.work = os.path.abspath(args.work)
    stages = (["data", "train", "resume", "infer", "artifact"]
              if args.stage == "all" else [args.stage])
    if any(s in DEVICE_STAGES for s in stages):
        check_device(args.device)
    for stage in stages:
        globals()["stage_" + stage](args.work, args)


if __name__ == "__main__":
    main()
