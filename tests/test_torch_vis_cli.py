"""The port's plotting and trajectory-conversion commands against the
JAX package's on the CPU: the same generated inputs (128x72 frames and
mp4v videos written with cv2, eval and multi-future pickles, world
TSVs) go through each ``mvt-*`` command's ``main`` and its
``mvt-torch-*`` twin, into two directories. Tolerance 0: the same file
names, every file byte-equal (both encode their jpgs with the same cv2
in this process), and stdout equal. The drawing path of
``mvt-torch-plot-traj-carla`` makes the same calls on a stub ``carla``
module. Without cv2 every command stops with an ImportError naming it
and the command, having written nothing. Last, the chain: the port's
``mvt-torch-test --save_output`` pickles (greedy and beam) of a run
trained on the CPU draw the same jpgs through ``mvt-vis-grid`` and
``mvt-torch-vis-grid``, and the port's multi-future decode the same
frames through both ``vis-multifuture`` commands."""

import os
import pickle
import sys
import types

import numpy as np
import pytest

from multiverse_tpu.cli import vis_annotation as jax_annotation
from multiverse_tpu.cli import vis_dataset as jax_dataset
from multiverse_tpu.cli import vis_multifuture_trajs_video as jax_mf
from multiverse_tpu.cli import vis_real_data as jax_real
from multiverse_tpu.cli import visualize_grid as jax_grid
from multiverse_tpu.cli import visualize_output as jax_output
from multiverse_torch.cli import multifuture_inference as tinf_cli
from multiverse_torch.cli import test as ttest
from multiverse_torch.cli import vis_annotation
from multiverse_torch.cli import vis_dataset
from multiverse_torch.cli import vis_multifuture_trajs_video as vis_mf
from multiverse_torch.cli import vis_real_data
from multiverse_torch.cli import visualize_grid
from multiverse_torch.cli import visualize_output
from multiverse_torch.data.sdd import SDD_CLASS2CLASSID
from multiverse_torch.train.checkpoints import resolve_checkpoint
from synthetic import tiny_config, write_multifuture_dataset
from test_torch_train_cli import (  # noqa: F401
    MODEL_FLAGS,
    one_torch_thread,
    prepro,
    trained,
)

H, W = 72, 128


def _files(root: str) -> list:
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def _assert_same_tree(got: str, want: str) -> int:
    """The same file names under both roots, each byte-equal. Returns
    the number of files."""
    names = _files(want)
    assert _files(got) == names
    for name in names:
        with open(os.path.join(got, name), "rb") as a, \
                open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name
    return len(names)


def _image(seed: int, h: int = H, w: int = W) -> np.ndarray:
    """A smooth BGR frame that changes with ``seed``."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 2 + seed * 17) % 256, (yy * 3 + seed * 5) % 256,
                    ((xx + yy) + seed * 40) % 256], -1)
    return img.astype(np.uint8)


def _write_video(cv2, path: str, n: int, seed: int, h: int = H,
                 w: int = W) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    for i in range(n):
        vw.write(_image(seed + i, h, w))
    vw.release()


def _write_jpg(cv2, path: str, seed: int, h: int = H, w: int = W) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, _image(seed, h, w))


# ------------------------------------------------------------- inputs

# multi-future obs keys, in the order of the prediction pickle (not
# sorted); the last has a GT pickle but no video
MF_KEYS = ["zara01_3_1_cam1", "0000_0_3_cam4", "0400_2_5_cam2",
           "eth_1_2_cam1"]


def make_multifuture(cv2, root: str) -> dict:
    """GT pickles (futures of several lengths, obs on some), a
    ``.traj.p`` of K = 4 predictions a key, and a video a key (the
    first of 4 frames, the others of 3)."""
    rng = np.random.RandomState(11)
    gt_path, videos = os.path.join(root, "gt"), os.path.join(root, "videos")
    os.makedirs(gt_path)
    pred = {}
    for k, key in enumerate(MF_KEYS):
        gt = {}
        for f in range(3):
            n = 6 + 3 * f
            xy = rng.uniform((4.0, 4.0), (W - 4.0, H - 4.0), (n, 2))
            gt["%s_%d_a%d" % (key, f, f)] = {"x_agent_traj": [
                (40 + 12 * t, 3, float(x), float(y))
                for t, (x, y) in enumerate(xy)]}
            if f != 1:
                obs = rng.uniform((4.0, 4.0), (W - 4.0, H - 4.0), (8, 2))
                gt["%s_%d_a%d" % (key, f, f)]["obs_traj"] = [
                    (12 * t, 3.0, float(x), float(y))
                    for t, (x, y) in enumerate(obs)]
        with open(os.path.join(gt_path, key + ".p"), "wb") as f:
            pickle.dump(gt, f)
        pred[key] = rng.uniform((0.0, 0.0), (W, H), (4, 12, 2)).astype(
            np.float32)
        if k < len(MF_KEYS) - 1:
            _write_video(cv2, os.path.join(videos, key + ".mp4"),
                         4 if k == 0 else 3, 10 * k)
    traj_p = os.path.join(root, "pred.traj.p")
    with open(traj_p, "wb") as f:
        pickle.dump({k: pred[k] for k in MF_KEYS[:-1]}, f)
    return {"gt": gt_path, "pred": traj_p, "videos": videos}


OUT_VIDEOS = ["VIRAT_S_000000_00", "VIRAT_S_040100_01"]


def make_output(cv2, root: str) -> dict:
    """Two runs' ``--save_output`` pickles over the same seq_ids in
    different orders, their colours in an outlist, and a frame per
    seq_id but one."""
    rng = np.random.RandomState(12)
    frames = os.path.join(root, "frames")
    seq_ids = ["%s_%d_%d" % (v, fr, pid) for v in OUT_VIDEOS
               for fr in (0, 12, 24) for pid in (1, 4)]
    obs = [rng.uniform((5.0, 5.0), (W - 5.0, H - 5.0), (4, 2))
           for _ in seq_ids]
    gt = [rng.uniform((5.0, 5.0), (W - 5.0, H - 5.0), (5, 2))
          for _ in seq_ids]
    for j, seq_id in enumerate(seq_ids):
        video, fr, _ = seq_id.rsplit("_", 2)
        if j != 3:
            _write_jpg(cv2, os.path.join(frames, video, "%s_F_%08d.jpg"
                                         % (video, int(fr))), j)
    lines = []
    for run, (order, color) in enumerate((
            (list(range(len(seq_ids))), "0_0_255"),
            (list(rng.permutation(len(seq_ids))), "255_128_0"))):
        data = {"seq_ids": np.asarray([seq_ids[i] for i in order]),
                "obs_list": [obs[i] for i in order],
                "pred_gt_list": [gt[i] for i in order],
                "grid0_pred_traj": [
                    rng.uniform((5.0, 5.0), (W - 5.0, H - 5.0), (5, 2))
                    for _ in order]}
        path = os.path.join(root, "run%d.p" % run)
        with open(path, "wb") as f:
            pickle.dump(data, f)
        lines.append("%s,%s" % (path, color))
    outlist = os.path.join(root, "outlist.txt")
    with open(outlist, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"outlist": outlist, "frames": frames}


GRID_VIDEOS = ["VIRAT_S_000001_00_000000_000100",
               "VIRAT_S_050000_01_000000_000100",
               "VIRAT_S_040000_00_000000_000100"]   # 0400: excluded


def make_grid(cv2, root: str) -> dict:
    """An ``mvt-test --save_output --use_beam_search`` pickle of three
    videos (the last of excluded scene 0400), three frames of three
    persons each, T = 5 on a 6x8 grid; last-obs frames at 128x72 but
    one at 64x36 (resized as scene 0002's are)."""
    rng = np.random.RandomState(13)
    gh, gw, obs_len, frame_gap, T = 6, 8, 4, 2, 5
    ys = (np.arange(gh) + 0.5) * H / gh
    xs = (np.arange(gw) + 0.5) * W / gw
    centers = np.stack(np.meshgrid(xs, ys), -1).astype(np.float32)
    data = {k: [] for k in (
        "seq_ids", "obs_list", "pred_gt_list", "grid0_pred_traj",
        "grid0_class", "grid0_gt_class", "beam_grid_ids", "beam_logprobs")}
    data["grid_center_0"] = centers
    frames = os.path.join(root, "frames")
    for v, vid in enumerate(GRID_VIDEOS):
        for fr in (0, 6, 12):
            for pid in (1, 2, 3):
                data["seq_ids"].append("%s_%d_%d" % (vid, fr, pid))
                for key, shape in (("obs_list", (obs_len, 2)),
                                   ("pred_gt_list", (T, 2)),
                                   ("grid0_pred_traj", (T, 2))):
                    data[key].append(rng.uniform(
                        (5.0, 5.0), (W - 5.0, H - 5.0), shape))
                data["grid0_class"].append(
                    rng.randn(T, gh * gw).astype(np.float32))
                data["grid0_gt_class"].append(rng.randint(0, gh * gw, T))
                data["beam_grid_ids"].append(
                    rng.randint(0, gh * gw, (3, T)))
                data["beam_logprobs"].append(rng.randn(3))
            last = fr + (obs_len - 1) * frame_gap
            small = v == 1 and fr == 6
            _write_jpg(cv2, os.path.join(
                frames, vid, "%s_F_%08d.jpg" % (vid, last)), 3 * v + fr,
                *((36, 64) if small else (H, W)))
    data["seq_ids"] = np.asarray(data["seq_ids"])
    outp = os.path.join(root, "out.p")
    with open(outp, "wb") as f:
        pickle.dump(data, f)
    return {"pickle": outp, "frames": frames}


GRID_FLAGS = ["--obs_len", "4", "--frame_gap", "2", "--video_h", str(H),
              "--video_w", str(W), "--scene_h", "12", "--scene_w", "16"]


REAL_VIDEO = "VIRAT_S_000000_00"


def make_real(cv2, root: str) -> dict:
    """Pixel and world TSVs of one video (five persons, some seen in
    only part of the frames), the video frame at the start, and a
    homography file."""
    rng = np.random.RandomState(14)
    pixel, world = [], []
    for pid in range(5):
        x, y = rng.uniform((10.0, 10.0), (W - 10.0, H - 10.0))
        vx, vy = rng.uniform(-0.2, 0.2, 2)
        for fr in range(0, 12 * (25 - 3 * pid), 12):
            pixel.append((fr, pid, x + vx * fr, y + vy * fr))
            world.append((fr, pid, 0.05 * (x + vx * fr) - 3.0,
                          0.07 * (y + vy * fr) + 1.5))
    pixel.sort()
    world.sort()
    paths = {k: os.path.join(root, k, REAL_VIDEO + ".txt")
             for k in ("pixel", "world")}
    for k, rows in (("pixel", pixel), ("world", world)):
        os.makedirs(os.path.dirname(paths[k]))
        with open(paths[k], "w") as f:
            f.write("".join("%d\t%.1f\t%.3f\t%.3f\n" % r for r in rows))
    for fr in (12, 36):
        _write_jpg(cv2, os.path.join(root, "frames", REAL_VIDEO,
                                     "%s_F_%08d.jpg" % (REAL_VIDEO, fr)), fr)
    hm = np.eye(3) * 0.05 + rng.uniform(-1e-3, 1e-3, (3, 3))
    hm[2, 2] = 1.0
    paths["h"] = os.path.join(root, "0000.txt")
    with open(paths["h"], "w") as f:
        f.write("\n".join(",".join("%.9f" % v for v in row)
                          for row in hm) + "\n")
    paths["frames"] = os.path.join(root, "frames")
    return paths


SDD_PREPARED = [("train", "bookstore_video0"), ("train", "hyang_video2"),
                ("test", "gates_video1")]


def make_sdd_prepared(cv2, root: str) -> dict:
    """``mvt-prepare-sdd``'s layout (trajectory TSVs, person-box and
    other-box pickles per video) at 128x72, and a frame per annotated
    frame but one; one key has no person box, and one other box a
    class id no name has."""
    rng = np.random.RandomState(15)
    prep = os.path.join(root, "prepared")
    frames = os.path.join(root, "frames")
    cids = sorted(SDD_CLASS2CLASSID.values())
    for v, (split, vid) in enumerate(SDD_PREPARED):
        lines, person, other = [], {}, {}
        for fr in range(0, 60, 12):
            for tid in (1, 2):
                x, y = rng.uniform((10.0, 10.0), (W - 10.0, H - 10.0))
                lines.append("%d\t%.1f\t%.2f\t%.2f" % (fr, tid, x, y))
                key = "%s_%d_%d" % (vid, fr, tid)
                if not (v == 1 and fr == 12):
                    person[key] = [x - 4, y - 9, x + 4, y + 1]
                n = int(rng.randint(0, 3))
                other[key] = (
                    [list(rng.uniform(0, (W, H, W, H))) for _ in range(n)],
                    [cids[int(rng.randint(len(cids)))] if k else 99
                     for k in range(n)])
            if not (v == 0 and fr == 24):
                _write_jpg(cv2, os.path.join(frames, vid, "%s_F_%08d.jpg"
                                             % (vid, fr)), v * 7 + fr)
        for sub, obj in (("traj_2.5fps", None), ("anno_person_box", person),
                         ("anno_other_box", other)):
            d = os.path.join(prep, sub, split)
            os.makedirs(d, exist_ok=True)
            if obj is None:
                with open(os.path.join(d, vid + ".txt"), "w") as f:
                    f.write("\n".join(lines) + "\n")
            else:
                with open(os.path.join(d, vid + ".p"), "wb") as f:
                    pickle.dump(obj, f)
    return {"prep": prep, "frames": frames}


# world TSVs: ActEV videos of scenes 0000, 0400, 0002 (skipped in ActEV
# mode) and 0500; the 0400 one has a z column; vehicles of two of them
CARLA_VIDEOS = ["VIRAT_S_000000_00", "VIRAT_S_040000_01",
                "VIRAT_S_000200_02", "VIRAT_S_050000_03"]


def make_carla(root: str) -> dict:
    rng = np.random.RandomState(16)
    ped, veh = os.path.join(root, "ped"), os.path.join(root, "veh")
    os.makedirs(ped)
    os.makedirs(veh)
    for v, name in enumerate(CARLA_VIDEOS):
        for where, n in ((ped, 3), (veh, 2)):
            if where == veh and v % 2:
                continue
            rows = []
            for pid in range(n):
                x, y = rng.uniform(-10, 30, 2)
                for fr in range(0, 120, 12):
                    row = "%d\t%d\t%.4f\t%.4f" % (fr, pid, x + 0.05 * fr,
                                                  y - 0.03 * fr)
                    rows.append(row + ("\t0.25" if v == 1 else ""))
            with open(os.path.join(where, name + ".txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
    return {"ped": ped, "veh": veh,
            "file": os.path.join(ped, CARLA_VIDEOS[1] + ".txt")}


# ------------------------------------------------------------- commands


def _cases():
    """(case id, jax main, port main, inputs(cv2, root) -> dict,
    argv(inputs, out) -> list)."""
    mf = (jax_mf.main, vis_mf.main, make_multifuture)
    out = (jax_output.main, visualize_output.main, make_output)
    grid = (jax_grid.main, visualize_grid.main, make_grid)
    real = (jax_real.main, vis_real_data.main, make_real)
    carla_one = (jax_annotation.plot_traj_carla_main,
                 vis_annotation.plot_traj_carla_main,
                 lambda cv2, root: make_carla(root))
    carla_batch = (jax_annotation.batch_plot_traj_carla_main,
                   vis_annotation.batch_plot_traj_carla_main,
                   lambda cv2, root: make_carla(root))

    def mf_argv(*flags):
        return lambda i, o: [i["gt"], i["pred"], i["videos"], o, *flags]

    def out_argv(*flags):
        return lambda i, o: [i["outlist"], i["frames"], o, *flags]

    def grid_argv(*flags):
        return lambda i, o: [i["pickle"], o, i["frames"], *GRID_FLAGS,
                             *flags]

    def real_argv(start, *flags):
        return lambda i, o: [i["frames"], str(start), i["pixel"],
                             i["world"], o + "/vis/real.jpg",
                             *[i["h"] if f == "<h>" else f for f in flags]]

    def carla_argv(*flags):
        return lambda i, o: [i["file"], "-10.0", "58.0", "0.5", "153.0",
                             "--save_carla_traj_file", o + "/traj.txt",
                             *flags]

    return [
        ("vis-multifuture", *mf, mf_argv()),
        ("vis-multifuture-all-flags", *mf, mf_argv(
            "--use_heatmap", "--plot_points", "--show_obs",
            "--show_less_gt")),
        ("vis-multifuture-drop2", *mf, mf_argv("--drop_frame", "2")),
        ("vis-multifuture-job2-cur1", *mf, mf_argv("--job", "2",
                                                   "--curJob", "1")),
        ("vis-multifuture-job2-cur2", *mf, mf_argv("--job", "2",
                                                   "--curJob", "2")),
        ("vis-output", *out, out_argv()),
        ("vis-output-ordered", *out, out_argv("--ordered")),
        ("vis-output-heatmap", *out, out_argv("--use_heatmap")),
        ("vis-output-only-scene", *out, out_argv("--only_scene", "0401")),
        ("vis-output-vis-num", *out, out_argv("--vis_num", "3")),
        ("vis-grid", *grid, grid_argv()),
        ("vis-grid-beam", *grid, grid_argv("--use_beam_search",
                                           "--beam_size", "3")),
        ("vis-grid-only-video", *grid, grid_argv(
            "--only_video", GRID_VIDEOS[1])),
        ("vis-grid-after-frame", *grid, grid_argv(
            "--only_after_frameid", "6")),
        ("vis-grid-only-track", *grid, grid_argv("--only_trackid", "2")),
        ("vis-grid-no-first-step", *grid, grid_argv(
            "--no_first_step", "--no_pred_traj", "--no_gt_pred")),
        ("vis-grid-range", *grid, grid_argv("--vis_start", "4",
                                            "--vis_end", "20")),
        ("vis-dataset", jax_dataset.vis_dataset_main,
         vis_dataset.vis_dataset_main, make_multifuture,
         lambda i, o: [i["videos"], i["gt"], o]),
        ("vis-dataset-drop2", jax_dataset.vis_dataset_main,
         vis_dataset.vis_dataset_main, make_multifuture,
         lambda i, o: [i["videos"], i["gt"], o, "--drop_frame", "2"]),
        ("vis-real-data", *real, real_argv(12)),
        ("vis-real-data-h-file", *real, real_argv(12, "--h_file", "<h>")),
        ("vis-real-data-rotate", *real, real_argv(
            36, "--world_rotate", "30", "--obs_length", "3",
            "--pred_length", "4")),
        ("vis-real-data-h-file-rotate", *real, real_argv(
            36, "--h_file", "<h>", "--world_rotate", "-75")),
        ("vis-sdd-annotation", jax_annotation.vis_sdd_annotation_main,
         vis_annotation.vis_sdd_annotation_main, make_sdd_prepared,
         lambda i, o: [i["prep"], i["frames"], o]),
        ("vis-sdd-annotation-one-frame",
         jax_annotation.vis_sdd_annotation_main,
         vis_annotation.vis_sdd_annotation_main, make_sdd_prepared,
         lambda i, o: [i["prep"], i["frames"], o,
                       "--vis_num_frame_per_video", "1"]),
        ("plot-traj-carla-ethucy", *carla_one, carla_argv()),
        ("plot-traj-carla-actev", *carla_one, carla_argv("--is_actev")),
        ("plot-traj-carla-rotate-scale", *carla_one, carla_argv(
            "--is_actev", "--world_rotate", "30", "--scale", "1.2")),
        ("batch-plot-traj-carla-actev", *carla_batch,
         lambda i, o: [i["ped"], o + "/ped", "--traj_vehicle_world_path",
                       i["veh"], "--save_carla_vehicle_path", o + "/veh"]),
        ("batch-plot-traj-carla-ethucy", *carla_batch,
         lambda i, o: [i["ped"], o + "/ped"]),
        ("batch-plot-traj-carla-job", *carla_batch,
         lambda i, o: [i["ped"], o + "/ped", "--traj_vehicle_world_path",
                       i["veh"], "--save_carla_vehicle_path", o + "/veh",
                       "--job", "2", "--curJob", "2"]),
    ]


CASES = {c[0]: c[1:] for c in _cases()}


def _run_both(jax_main, port_main, argv, inputs, tmp_path, capsys) -> dict:
    """Each main into its own directory; returns their stdout with the
    directory replaced."""
    capsys.readouterr()
    printed = {}
    for who, main in (("jax", jax_main), ("port", port_main)):
        out = str(tmp_path / who)
        os.makedirs(out)
        main(argv(inputs, out))
        printed[who] = capsys.readouterr().out.replace(out, "<out>")
    return printed


@pytest.mark.parametrize("case", list(CASES))
def test_command_writes_the_jax_commands_files(case, tmp_path, capsys):
    jax_main, port_main, make, argv = CASES[case]
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("scipy")
    root = str(tmp_path / "in")
    os.makedirs(root)
    printed = _run_both(jax_main, port_main, argv, make(cv2, root),
                        tmp_path, capsys)
    n = _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert n > 0
    assert printed["port"] == printed["jax"]


def test_vis_multifuture_jobs_split_the_keys(tmp_path):
    """``--job 2`` with ``--curJob`` 1 and 2 write, between them, the
    files of one unsharded run, each key once."""
    cv2 = pytest.importorskip("cv2")
    inputs = make_multifuture(cv2, str(tmp_path / "in"))
    whole = str(tmp_path / "whole")
    vis_mf.main([inputs["gt"], inputs["pred"], inputs["videos"], whole])
    parts = []
    for cur in ("1", "2"):
        out = str(tmp_path / ("job" + cur))
        vis_mf.main([inputs["gt"], inputs["pred"], inputs["videos"], out,
                     "--job", "2", "--curJob", cur])
        parts.append(_files(out))
    assert not set(parts[0]) & set(parts[1])
    assert sorted(parts[0] + parts[1]) == _files(whole)
    # 4 frames of the first key, 3 of the next two; the last key has no
    # video and is not in the prediction pickle
    assert len(_files(whole)) == 10


class _Carla(types.ModuleType):
    """A stub ``carla`` module: every call is recorded in ``calls``."""

    def __init__(self):
        super().__init__("carla")
        self.calls = []
        stub = self

        class Client:
            def __init__(self, host, port):
                stub.calls.append(("Client", host, port))

            def set_timeout(self, t):
                stub.calls.append(("set_timeout", t))

            def get_world(self):
                stub.calls.append(("get_world",))
                return types.SimpleNamespace(debug=types.SimpleNamespace(
                    draw_arrow=lambda *a, **kw: stub.calls.append(
                        ("draw_arrow", a, sorted(kw.items())))))
        self.Client = Client
        self.Location = lambda x, y, z: ("Location", float(x), float(y),
                                         float(z))
        self.Color = lambda **kw: ("Color", sorted(kw.items()))


@pytest.mark.parametrize("flags", [[], ["--is_actev", "--line_time", "5"]],
                         ids=["ethucy", "actev"])
def test_plot_traj_carla_draws_the_jax_commands_arrows(flags, tmp_path,
                                                       capsys, monkeypatch):
    inputs = make_carla(str(tmp_path))
    argv = [inputs["file"], "-10.0", "58.0", "0.5", "153.0", "--host",
            "10.1.2.3", "--port", "2345", *flags]
    calls, printed = [], []
    for main in (jax_annotation.plot_traj_carla_main,
                 vis_annotation.plot_traj_carla_main):
        carla = _Carla()
        monkeypatch.setitem(sys.modules, "carla", carla)
        main(argv)
        calls.append(carla.calls)
        printed.append(capsys.readouterr().out)
    assert calls[1] == calls[0]
    assert printed[1] == printed[0] == "drew 3 trajectories\n"
    # 3 persons of 10 points: 9 arrows each
    assert sum(c[0] == "draw_arrow" for c in calls[1]) == 27
    assert calls[1][:3] == [("Client", "10.1.2.3", 2345),
                            ("set_timeout", 10.0), ("get_world",)]


# -------------------------------------------------------- missing cv2

GATED = [
    ("vis-output", visualize_output.main, ["a", "b", "c"]),
    ("vis-grid", visualize_grid.main, ["a", "b", "c"]),
    ("vis-multifuture", vis_mf.main, ["a", "b", "c", "d"]),
    ("vis-dataset", vis_dataset.vis_dataset_main, ["a", "b", "c"]),
    ("vis-real-data", vis_real_data.main, ["a", "0", "b", "c", "d/e.jpg"]),
    ("vis-sdd-annotation", vis_annotation.vis_sdd_annotation_main,
     ["a", "b", "c"]),
    ("plot-traj-carla", vis_annotation.plot_traj_carla_main,
     ["a", "0", "0", "0", "0", "--save_carla_traj_file", "b"]),
    ("batch-plot-traj-carla", vis_annotation.batch_plot_traj_carla_main,
     ["a", "b"]),
]


@pytest.mark.parametrize("command,main,args", GATED,
                         ids=[g[0] for g in GATED])
def test_command_without_cv2_raises(command, main, args, tmp_path,
                                    monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    argv = [a if a.lstrip("-").isdigit() or a.startswith("--")
            else str(tmp_path / a) for a in args]
    with pytest.raises(ImportError) as err:
        main(argv)
    assert "cv2" in str(err.value) and err.value.name == "cv2"
    assert "mvt-torch-" + command in str(err.value)
    assert os.listdir(tmp_path) == []


def test_vis_grid_without_scipy_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "scipy", None)
    with pytest.raises(ImportError) as err:
        visualize_grid.main([str(tmp_path / a) for a in "abc"])
    assert err.value.name == "scipy" and "mvt-torch-vis-grid" in str(
        err.value)
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------------- the chain


def test_port_outputs_draw_as_jax_draws(  # noqa: F811
        prepro, trained, tmp_path, capsys):
    """The port's ``mvt-torch-test --save_output`` pickles, greedy and
    with ``--use_beam_search``, of the run trained on the CPU, drawn by
    ``mvt-vis-grid`` and ``mvt-torch-vis-grid`` on 1920x1080 frames of
    one video; then the port's multi-future decode of that run through
    both ``vis-multifuture`` commands."""
    cv2 = pytest.importorskip("cv2")
    root, path = prepro
    for beam in (False, True):
        outp = str(tmp_path / ("beam.p" if beam else "greedy.p"))
        ttest.main([path, os.path.join(root, "models"), "toy", "--runId",
                    "1", "--load_best", "--batch_size", "4", "--device",
                    "cpu", "--use_soft_grid_class", *MODEL_FLAGS,
                    "--save_output", outp]
                   + (["--use_beam_search", "--beam_size", "3"] if beam
                      else []))
        with open(outp, "rb") as f:
            data = pickle.load(f)
        assert ("beam_grid_ids" in data) == beam
        video = str(data["seq_ids"][0]).rsplit("_", 2)[0]
        firsts = sorted({int(str(s).rsplit("_", 2)[1])
                         for s in data["seq_ids"]
                         if str(s).startswith(video + "_")})[:2]
        frames = str(tmp_path / ("frames_%d" % beam))
        for k, fr in enumerate(firsts):
            _write_jpg(cv2, os.path.join(frames, video, "%s_F_%08d.jpg"
                                         % (video, fr + 3 * 12)), k,
                       1080, 1920)
        argv = [outp, None, frames, "--obs_len", "4", "--only_video", video,
                *(["--use_beam_search", "--beam_size", "3"] if beam else [])]
        vis = str(tmp_path / ("vis_%d" % beam))
        printed = _run_both(jax_grid.main, visualize_grid.main,
                            lambda i, o: [o if a is None else a
                                          for a in argv],
                            None, tmp_path / ("vis_%d" % beam), capsys)
        assert printed["port"] == printed["jax"]
        assert printed["port"].endswith("wrote 2 frames\n")
        assert _assert_same_tree(os.path.join(vis, "port"),
                                 os.path.join(vis, "jax")) == 2

    cfg = tiny_config(use_soft_grid_class=True)
    traj_p, mf_p, scene_p, id2name = write_multifuture_dataset(
        str(tmp_path / "mf"), cfg, np.random.RandomState(1), num_traj=3,
        max_pred_len=6)
    pred = str(tmp_path / "o.traj.p")
    tinf_cli.main([resolve_checkpoint(os.path.join(trained, "best")),
                   traj_p, mf_p, pred, "--device", "cpu",
                   "--scene_feat_path", scene_p, "--scene_id2name", id2name,
                   "--num_out", "3", "--use_gnn", "--use_scene_enc",
                   "--scene_h", "12", "--scene_w", "16", "--scene_class",
                   "5", "--emb_size", "8", "--enc_hidden_size", "16",
                   "--dec_hidden_size", "16", "--scene_conv_dim", "8",
                   "--obs_length", "4"])
    with open(pred, "rb") as f:
        keys = list(pickle.load(f))
    videos = str(tmp_path / "mf_videos")
    for k, key in enumerate(keys):
        _write_video(cv2, os.path.join(videos, key + ".mp4"), 2, k, 1080,
                     1920)
    vis = tmp_path / "vis_mf"
    _run_both(jax_mf.main, vis_mf.main,
              lambda i, o: [mf_p, pred, videos, o, "--show_obs"], None,
              vis, capsys)
    assert _assert_same_tree(str(vis / "port"), str(vis / "jax")) \
        == 2 * len(keys) == 6
