"""The port's convergence campaigns (``multiverse_torch/campaign``)
against the JAX package's ``campaign.py`` and ``campaign_simaug.py``, on
the CPU at small sizes.

* the walks equal the JAX ones at tolerance 0;
* both data stages, each package's with its own fake ``carla`` (actor
  ids from 1), write the same files: meta.json but for its paths, the
  TSVs and GT pickles byte for byte, the preprocessed npz arrays equal;
* the flagship training (run A, 2 epochs) and its resume (run B cut at
  epoch 1, resumed with ``--load``), f32 at tiny widths through each
  script's ``_train_cmd`` from one JAX-initialised step, give the same
  eval steps, best flags and best step, and metrics within TRAIN_RTOL;
* the JAX scripts' ``_curve`` and ``_parse_curve`` read the port's run
  directory and SimAug log as the port's do, at tolerance 0; the port's
  decode, scores and artifact follow;
* a half-written step in ``save/`` is skipped by the kill poller, by
  the step list and by ``--load``;
* with no GPU the campaigns' device stages stop with the default
  ``--device``, and the data stages stop without the fake backend.

The JAX scripts' ``stage_artifact`` is never called: it writes the
committed files at the repository root."""

import itertools
import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from multiverse_torch.campaign import flagship, simaug, walks
from multiverse_torch.train.checkpoints import list_steps
from multiverse_torch.train.orbax_writer import TMP_SUFFIX
from tests import fake_carla
from test_torch_train_cli import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import campaign as jax_campaign  # noqa: E402
import campaign_simaug as jax_simaug  # noqa: E402

FLAGSHIP_DATA = ["--train_moments", "1", "--val_moments", "1",
                 "--test_moments", "1", "--mf_groups", "2", "--peds", "2",
                 "--anchor_samples", "24", "--mf_samples", "25"]
SIMAUG_DATA = ["--train_moments", "1", "--val_moments", "1", "--peds", "3",
               "--samples", "22"]
# the widths a CPU run overrides in each script's command (argparse: the
# last flag wins), and a batch of 4 so that an epoch is 2 steps
TINY = ("--emb_size", "8", "--enc_hidden_size", "16",
        "--dec_hidden_size", "16", "--scene_conv_dim", "8",
        "--batch_size", "4")
# the port's f32 CPU training against the JAX package's, over 4 steps
# and 5 evals of each run
TRAIN_RTOL = 1e-4
SEED = 42


@pytest.fixture(scope="module", autouse=True)
def one_thread_subprocesses():
    """The campaigns' commands run in subprocesses: one intra-op thread
    each, as ``one_torch_thread`` gives this process."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if old is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = old


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _jax_data(stage, work, args):
    """A JAX data stage with its fake's actor ids from 1."""
    fake_carla._ids = itertools.count(1)
    try:
        stage(work, args)
    finally:
        sys.modules.pop("carla", None)


@pytest.fixture(scope="module")
def flagship_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("campaign"))
    args = flagship.build_parser().parse_args(["data", *FLAGSHIP_DATA])
    jax_work, port_work = (os.path.join(root, n) for n in ("jax", "port"))
    _jax_data(jax_campaign.stage_data, jax_work, args)
    flagship.stage_data(port_work, args)
    return jax_work, port_work


@pytest.fixture(scope="module")
def simaug_data(tmp_path_factory):
    """Both SimAug data stages. The JAX one stops at its grouping check:
    it reads ``traj_key`` from the npz, which holds none."""
    root = str(tmp_path_factory.mktemp("campaign_simaug"))
    args = simaug.build_parser().parse_args(["data", *SIMAUG_DATA])
    jax_work, port_work = (os.path.join(root, n) for n in ("jax", "port"))
    with pytest.raises(KeyError, match="traj_key"):
        _jax_data(jax_simaug.stage_data, jax_work, args)
    simaug.stage_data(port_work, args)
    return jax_work, port_work


@pytest.mark.parametrize("seed", [0, 17, 23, 2024])
def test_walks_equal_jax(seed):
    for center_r in (None, 3.0):
        got_rnd, want_rnd = (np.random.RandomState(seed) for _ in "ab")
        got = walks.walk_init(got_rnd, center_r)
        want = jax_campaign.walk_init(want_rnd, center_r)
        assert got == want
        xy = walks.walk_steps(got_rnd, got, 60)
        np.testing.assert_array_equal(
            xy, jax_campaign.walk_steps(want_rnd, want, 60))
        assert got == want
        assert walks.rows_from_xy(xy, 3, 40) == \
            jax_campaign.rows_from_xy(xy, 3, 40)
    for name in ("LIM", "CAM_W", "CAM_H", "DROP", "MF_START", "OBS_LEN",
                 "PRED_LEN", "FLAGSHIP_MODEL", "FLAGSHIP_TRAIN"):
        assert getattr(walks, name) == getattr(jax_campaign, name), name


# the arrays the SimAug data stage's person boxes add to the npz
PERSON_BOX_KEYS = {"obs_box", "obs_boxid", "person_boxkey2id",
                   "person_boxid2key"}


def _same_files(jax_work, port_work, extra_npz_keys=frozenset()):
    """Every file the JAX stage wrote is the port's: TSVs, pickles and
    lists byte for byte, the npz arrays equal (the port's npz may hold
    ``extra_npz_keys`` more). Returns the npz names and the count of
    files compared byte for byte."""
    files = _files(jax_work)
    # the port's stages also record their seconds (and the SimAug one
    # gets to its meta.json)
    assert set(_files(port_work)) - set(files) <= {"stages.json",
                                                   "meta.json"}
    assert set(files) <= set(_files(port_work))
    prepro = os.path.join("prepro", "")
    compared, npz = 0, set()
    for rel in files:
        a, b = (os.path.join(w, rel) for w in (jax_work, port_work))
        if rel.endswith((".txt", ".p", ".lst")):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
            compared += 1
        elif rel.startswith(prepro) and rel.endswith(".npz"):
            with np.load(a, allow_pickle=True) as za, \
                    np.load(b, allow_pickle=True) as zb:
                assert set(zb.files) - set(za.files) <= extra_npz_keys
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k],
                                                  err_msg=rel + ":" + k)
            npz.add(os.path.basename(rel))
    return npz, compared


def test_flagship_data_stage_equals_jax(flagship_data):
    jax_work, port_work = flagship_data
    with open(os.path.join(jax_work, "meta.json")) as f:
        want = json.load(f)
    with open(os.path.join(port_work, "meta.json")) as f:
        got = json.load(f)
    assert got == {k: (v.replace(jax_work, port_work)
                       if isinstance(v, str) else v)
                   for k, v in want.items()}
    npz, compared = _same_files(jax_work, port_work)
    assert npz == {"data_%s.npz" % s for s in ("train", "val", "test")}
    assert got["n_train"] > 0 and got["n_val"] > 0
    assert got["n_mf_obs"] == 2 and compared >= 6


def test_simaug_data_stage_groups_every_agents_four_views(simaug_data):
    """The recordings, TSVs, box pickles and npz arrays equal what the
    JAX stage wrote before it stopped; the port's npz adds the person
    boxes, whose keys the JAX package's own reader and get_agent_id
    group into the meta's agent groups, every one of all four views (the
    JAX stage's check, which it never reached)."""
    from multiverse_tpu.config import MultiverseConfig as JaxConfig
    from multiverse_tpu.data.dataset import read_data as jax_read_data
    from multiverse_tpu.data.multiview import get_agent_id

    jax_work, port_work = simaug_data
    npz, compared = _same_files(jax_work, port_work, PERSON_BOX_KEYS)
    assert npz == {"data_train.npz", "data_val.npz"} and compared >= 16
    with open(os.path.join(port_work, "meta.json")) as f:
        meta = json.load(f)
    prepro = os.path.join(port_work, "prepro")
    keys = jax_read_data(prepro, "train", JaxConfig()).data["traj_key"]
    assert simaug.example_keys(prepro, "train") == [str(k) for k in keys]
    groups = {}
    for k in keys:
        groups.setdefault(get_agent_id(k), []).append(k)
    sizes = np.asarray([len(g) for g in groups.values()])
    assert meta["agent_groups"] == len(groups) > 1
    assert meta["frac_full_groups"] == float((sizes == 4).mean()) == 1.0
    assert meta["n_train"] == len(keys) and meta["n_cams"] == 4
    # a group is one walker's window seen by the four rigs
    assert all(sorted(k.split("_")[5] for k in g) ==
               ["cam1", "cam2", "cam3", "cam4"] for g in groups.values())


# ------------------------------------------------------------- training


def _jax_init(root, work, meta):
    """One JAX-initialised step of the tiny configuration (the two
    packages draw different initial weights from a seed), as a save
    directory both trainers ``--load_from``."""
    import jax
    from multiverse_tpu.cli import train as jax_train
    from multiverse_tpu.cli.common import config_from_args
    from multiverse_tpu.models import init_params
    from multiverse_tpu.train.checkpoints import CheckpointManager

    cmd = jax_campaign._train_cmd(work, meta, "init", 1, SEED, "float32",
                                  TINY)
    cfg = config_from_args(jax_train.build_parser().parse_args(cmd[3:]))
    path = os.path.join(root, "init")
    CheckpointManager(path).save(0, init_params(jax.random.PRNGKey(0), cfg))
    return os.path.join(path, "save")


def _runs(pkg, work, init):
    """Run A for 2 epochs; run B cut at epoch 1 and resumed with --load
    for the other."""
    meta = pkg._meta(work)
    kw = {"device": "cpu"} if pkg is flagship else {}
    log = os.path.join(work, "train.log")
    start = TINY + ("--load_from", init)
    for name, epochs, extra in (("campA", 2, start), ("campB", 1, start),
                                ("campB", 1, TINY + ("--load",))):
        cmd = pkg._train_cmd(work, meta, name, epochs, SEED, "float32",
                             extra, **kw)
        r = pkg._run(cmd, log)
        with open(log) as f:
            assert r.returncode == 0, f.read()[-4000:]


@pytest.fixture(scope="module")
def flagship_runs(flagship_data):
    jax_work, port_work = flagship_data
    init = _jax_init(os.path.dirname(jax_work), jax_work,
                     jax_campaign._meta(jax_work))
    _runs(jax_campaign, jax_work, init)
    _runs(flagship, port_work, init)
    return jax_work, port_work


def _val_perf(work, run):
    with open(os.path.join(work, "runs", run, "00", "val_perf.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("run", ["campA", "campB"])
def test_training_and_resume_agree_with_jax(flagship_runs, run):
    jax_work, port_work = flagship_runs
    want, got = _val_perf(jax_work, run), _val_perf(port_work, run)
    assert [e[2] for e in got["val_perf"]] == \
        [e[2] for e in want["val_perf"]]
    assert [e[3] for e in got["val_perf"]] == \
        [e[3] for e in want["val_perf"]]
    assert got["best"]["step"] == want["best"]["step"]
    # the loaded baseline (loss None), then an eval every step (the
    # save period is an epoch at batch 20)
    spe = -(-flagship._meta(port_work)["n_train"] // 4)
    first = {"campA": 0, "campB": spe}[run]
    assert [e[2] for e in got["val_perf"]] == \
        list(range(first, 2 * spe + 1))
    assert got["val_perf"][0][0] is None
    for g, w in zip(got["val_perf"], want["val_perf"]):
        if w[0] is not None:
            np.testing.assert_allclose(g[0], w[0], rtol=TRAIN_RTOL)
        assert sorted(g[1]) == sorted(w[1])
        for k in w[1]:
            np.testing.assert_allclose(g[1][k], w[1][k], rtol=TRAIN_RTOL,
                                       err_msg="step %d %s" % (w[2], k))
    # the resumed run's saves continue above the cut
    if run == "campB":
        steps = flagship.saved_steps(os.path.join(
            port_work, "runs", run, "00", "save"))
        assert steps[-1] == 2 * spe and min(steps) <= spe


def test_curves_equal_jax_and_the_artifact(flagship_runs, monkeypatch,
                                           tmp_path):
    _, port_work = flagship_runs
    for run in ("campA", "campB"):
        run_dir = os.path.join(port_work, "runs", run, "00")
        assert flagship._curve(run_dir) == jax_campaign._curve(run_dir)
    # the f32 decode of run A's best at the tiny widths, both scores,
    # the resume record and the artifact
    monkeypatch.setattr(flagship, "INFER_WIDTHS", [
        "--emb_size", "8", "--enc_hidden_size", "16", "--dec_hidden_size",
        "16", "--scene_conv_dim", "8"])
    args = flagship.build_parser().parse_args([
        "artifact", "--device", "cpu", "--dtype", "float32", "--epochs",
        "2", "--out", str(tmp_path / "curve.json")])
    flagship.stage_infer(port_work, args)
    # run B's record: cut at epoch 1, one epoch resumed
    spe = flagship._meta(port_work)["steps_per_epoch"]
    with open(os.path.join(port_work, "resume.json"), "w") as f:
        json.dump({"killed_at_step": spe, "resumed_epochs": 1}, f)
    flagship.stage_artifact(port_work, args)
    with open(tmp_path / "curve.json") as f:
        art = json.load(f)
    with open(os.path.join(REPO, "TRAIN_CURVE_r05.json")) as f:
        jax_art = json.load(f)
    assert set(art) == set(jax_art) | {"device", "stage_seconds"}
    assert art["device"] == "cpu" and "v5e" not in art["experiment"]
    assert set(art["stage_seconds"]) == {"data", "infer"}
    for part in ("convergence", "resume_check", "run_B_resume"):
        assert set(art[part]) == set(jax_art[part]), part
    f32 = art["final_inference"]["f32"]
    assert set(art["final_inference"]) == {"f32"}
    assert len(f32["ours"]) == 6 and len(f32["nll"]) == 5
    assert np.isfinite([f32["ours"][i] for i in (0, 2, 3, 5)]).all()
    assert np.isfinite(f32["nll"]).all()
    want_a = jax_campaign._curve(os.path.join(port_work, "runs", "campA",
                                              "00"))[1]
    assert art["run_A"]["curve"] == want_a
    assert art["convergence"]["first_eval"] == want_a[1]["grid0_traj_ade"]


def test_simaug_curve_parsers_equal_jax(simaug_data, tmp_path):
    _, port_work = simaug_data
    args = simaug.build_parser().parse_args([
        "all", "--device", "cpu", "--dtype", "float32", "--epochs", "2",
        "--smoke", "--out", str(tmp_path / "curve.json")])
    simaug.stage_train(port_work, args)
    log = os.path.join(port_work, "train.log")
    metric, curve = simaug._parse_curve(log)
    assert (metric, curve) == jax_simaug._parse_curve(log)
    spe = simaug._meta(port_work)["steps_per_epoch"]
    assert metric == "grid0_traj_ade"
    assert [c["step"] for c in curve] == [spe, 2 * spe]
    simaug.stage_artifact(port_work, args)
    with open(tmp_path / "curve.json") as f:
        art = json.load(f)
    assert art["curve"] == curve and art["device"] == "cpu"
    assert set(art) >= {"experiment", "dataset", "epochs", "command_flags",
                        "curve", "best", "convergence", "device",
                        "stage_seconds"}
    assert "--enc_hidden_size" in art["command_flags"]


# ------------------------------------------------------ a half-written step


def test_a_half_written_step_is_skipped_by_the_poller_and_load(
        flagship_runs, tmp_path):
    """A run SIGKILLed while it writes a step leaves that step under its
    temporary name: the kill poller and the step list pass over it, and
    --load restores the finished step before it (its eval equals run
    A's at that step) and saves above it."""
    from multiverse_torch.cli import train as train_cli

    _, port_work = flagship_runs
    meta = flagship._meta(port_work)
    shutil.copytree(os.path.join(port_work, "runs", "campA"),
                    str(tmp_path / "runs" / "campA"))
    save = str(tmp_path / "runs" / "campA" / "00" / "save")
    latest = flagship.saved_steps(save)[-1]
    half = os.path.join(save, "%d%s%d" % (latest + 1, TMP_SUFFIX, 12345))
    os.makedirs(os.path.join(half, "default", "d"))
    with open(os.path.join(half, "default", "d", "partial"), "wb") as f:
        f.write(b"\0" * 100)
    assert flagship.saved_steps(save)[-1] == latest
    assert list_steps(save)[-1][0] == latest
    want = _val_perf(port_work, "campA")["val_perf"]
    cmd = flagship._train_cmd(str(tmp_path), meta, "campA", 1, SEED,
                              "float32", TINY + ("--load",), device="cpu")
    train_cli.main(cmd[3:])
    got = _val_perf(str(tmp_path), "campA")["val_perf"]
    assert got[0][2] == latest and got[0][0] is None
    assert got[0][1] == pytest.approx(
        next(e[1] for e in want if e[2] == latest), rel=1e-6)
    assert [e[2] for e in got[1:]] == [latest + 1, latest + 2]
    assert flagship.saved_steps(save)[-1] == latest + 2
    assert os.path.isdir(half)


# ------------------------------------------------------------- refusals


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is here")
@pytest.mark.parametrize("main,stage", [
    (flagship.main, "train"), (flagship.main, "resume"),
    (flagship.main, "infer"), (flagship.main, "all"),
    (simaug.main, "train"), (simaug.main, "all")])
def test_no_gpu_and_the_default_device_stops(main, stage, tmp_path):
    with pytest.raises(SystemExit, match="CUDA is not available"):
        main([stage, "--work", str(tmp_path / "work")])
    assert not os.path.exists(tmp_path / "work")


def test_the_data_stages_need_the_ports_fake(tmp_path):
    missing = str(tmp_path / "torch_fake_carla.py")
    with pytest.raises(FileNotFoundError, match="fake CARLA"):
        flagship.install_fake_carla(missing)
    for pkg in (flagship, simaug):
        args = pkg.build_parser().parse_args(
            ["data", "--fake_carla", missing, "--train_moments", "1"])
        with pytest.raises(FileNotFoundError, match="fake CARLA"):
            pkg.stage_data(str(tmp_path / pkg.__name__), args)
    fake = flagship.install_fake_carla()
    try:
        assert sys.modules["carla"] is not None
        assert fake.__file__ == flagship.FAKE_CARLA
        assert next(fake._ids) == 1
    finally:
        sys.modules.pop("carla", None)


def test_pickle_outputs_of_the_data_stage_load(flagship_data):
    _, port_work = flagship_data
    mf = os.path.join(port_work, "multifuture", "test")
    names = sorted(os.listdir(mf))
    assert len(names) == 2
    with open(os.path.join(mf, names[0]), "rb") as f:
        futures = pickle.load(f)
    assert len(futures) == 3
