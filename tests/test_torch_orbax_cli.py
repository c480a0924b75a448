"""Every loader of the port takes a run directory of the JAX package,
on the CPU: ``mvt-torch-test``, ``mvt-torch-multifuture-inference``,
``mvt-torch-serve``'s ``--load_from`` and ``ServingEngine.update_params``
given an orbax ``save`` directory do what they do with the same weights
as the port's npz; ``mvt-torch-serve`` loads a JAX run directory and its
hot reload follows a JAX trainer writing orbax steps (a step whose
manifest is damaged keeps the served weights); ``mvt-torch-train
--load`` on a JAX run continues above its steps and deletes none of
them; ``mvt-torch-train-simaug --load_from`` reads a JAX save
directory."""

import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.train.checkpoints import (
    CheckpointManager as JaxCheckpointManager,
)
from multiverse_torch.bridge import prune_to_template, save_params_npz
from multiverse_torch.cli import multifuture_inference as tinf_cli
from multiverse_torch.cli import serve as tserve
from multiverse_torch.cli import test as ttest
from multiverse_torch.cli import train as ttrain
from multiverse_torch.cli import train_simaug as tsimaug
from multiverse_torch.config import MultiverseConfig
from multiverse_torch.data.dataset import synthesize_prepro, synthesize_split
from multiverse_torch.data.multiview import synthesize_multiview_prepro
from multiverse_torch.models import Multiverse
from multiverse_torch.models.simaug import SimAugConfig
from multiverse_torch.serving.engine import ServingEngine
from multiverse_torch.train.checkpoints import list_steps, load_checkpoint
from multiverse_torch.train.orbax_writer import written_by_port
from synthetic import tiny_config, write_multifuture_dataset

WIDTHS = ["--scene_h", "12", "--scene_w", "16", "--scene_class", "5",
          "--emb_size", "8", "--enc_hidden_size", "16",
          "--dec_hidden_size", "16", "--scene_conv_dim", "8",
          "--use_gnn", "--use_scene_enc"]
TRAIN_FLAGS = ["--obs_len", "4", "--pred_len", "5",
               "--scene_grid_strides", "2,4", "--use_grids", "1,0",
               *WIDTHS]


def _cfg(**kw) -> MultiverseConfig:
    base = dict(obs_len=4, pred_len=5, scene_h=12, scene_w=16,
                scene_class=5, emb_size=8, enc_hidden_size=16,
                dec_hidden_size=16, scene_conv_dim=8,
                scene_grid_strides=(2, 4), use_grids=(True, False),
                use_gnn=True, use_scene_enc=True)
    base.update(kw)
    return MultiverseConfig(**base).validate()


def _jax_params(seed: int, use_grids=(True, True)):
    cfg = tiny_config(use_grids=use_grids, use_gnn=True, use_scene_enc=True)
    return jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(seed), cfg))


def _pruned(params) -> Multiverse:
    """The port's (1,0) model of a JAX (1,1) tree."""
    return prune_to_template(params, Multiverse.init(_cfg()))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """outbase/m/00 written by the JAX package's CheckpointManager: the
    (1,1) model at steps 100 and 200 in ``save``, 150 in ``best``; and
    the npz of step 200's weights pruned to (1,0)."""
    outbase = str(tmp_path_factory.mktemp("jax_out"))
    run = os.path.join(outbase, "m", "00")
    mgr = JaxCheckpointManager(run)
    params = {s: _jax_params(s) for s in (100, 150, 200)}
    mgr.save(100, params[100])
    mgr.save(200, params[200])
    mgr.save(150, params[150], best=True)
    npz = os.path.join(outbase, "step200.npz")
    save_params_npz(_pruned(params[200]), npz)
    return outbase, run, params, npz


@pytest.fixture(scope="module")
def prepro(tmp_path_factory):
    """Synthetic train, val and test splits at the tiny dims."""
    path = str(tmp_path_factory.mktemp("prepro"))
    cfg = tiny_config()
    synthesize_prepro(path, cfg, n_train=8, n_val=4, seed=3)
    np.savez(os.path.join(path, "data_test.npz"),
             **synthesize_split(cfg, 6, 9))
    return path


def _test_cli(path, tmp_path, capsys, prepro):
    ttest.main([prepro, str(tmp_path / "models"), "m", "--load_from",
                path, "--batch_size", "4", "--device", "cpu",
                "--obs_len", "4", "--pred_len", "5", *WIDTHS])
    return {"table": capsys.readouterr().out.strip().splitlines()[-2:]}


def _multifuture_cli(path, tmp_path, capsys, prepro):
    files = write_multifuture_dataset(str(tmp_path / "mf"), tiny_config(),
                                      np.random.RandomState(1), num_traj=3,
                                      max_pred_len=6)
    out = str(tmp_path / ("%s.traj.p" % os.path.basename(path)))
    prob = out.replace(".traj.p", ".prob.p")
    tinf_cli.main([path, files[0], files[1], out, "--device", "cpu",
                   "--scene_feat_path", files[2], "--scene_id2name",
                   files[3], "--num_out", "3", "--obs_length", "4",
                   "--diverse_beam", "--save_prob_file", prob, *WIDTHS])
    with open(out, "rb") as f:
        trajs = pickle.load(f)
    with open(prob, "rb") as f:
        probs = pickle.load(f)
    got = {k: np.asarray(v) for k, v in trajs.items()}
    for k, (logits, logprobs) in probs.items():
        got[k + "/logits"], got[k + "/logprobs"] = logits, logprobs
    return got


def _serve_load_from(path, tmp_path, capsys, prepro):
    args = tserve.build_parser().parse_args(
        ["out", "m", "--device", "cpu", "--load_from", path, "--obs_len",
         "4", "--pred_len", "5", *WIDTHS])
    args.compute_dtype, args.decode_quant = tserve.resolve_serving_dtypes(
        "cpu", args.compute_dtype, args.decode_quant)
    model, step = tserve.load_model(args, tserve.config_from_args(args))
    assert step is None
    return {n: p.numpy() for n, p in model.named_parameters()}


def _engine(model, cfg):
    return ServingEngine(model, cfg, max_batch=2, T_pred=4, device="cpu")


OBS = np.random.RandomState(0).uniform(100, 500, (4, 2)).astype(np.float32)


def _update_params(path, tmp_path, capsys, prepro):
    cfg = _serving_cfg()
    eng = _engine(Multiverse.init(cfg, seed=7), cfg)
    try:
        eng.update_params(load_checkpoint(path, Multiverse.init(cfg)))
        res = eng.predict(OBS)
    finally:
        eng.close()
    return {"trajs": res.trajs, "logprobs": res.logprobs}


def _serving_cfg():
    return _cfg(use_beam_search=True, beam_size=3, diverse_beam=True)


LOADERS = {"mvt-torch-test": _test_cli,
           "mvt-torch-multifuture-inference": _multifuture_cli,
           "mvt-torch-serve --load_from": _serve_load_from,
           "update_params": _update_params}


@pytest.mark.parametrize("loader", list(LOADERS))
def test_loaders_take_a_jax_save_directory(loader, jax_run, prepro,
                                           tmp_path, capsys):
    """Each loader given the JAX ``save`` directory (its latest orbax
    step, the (1,1) model loaded at (1,0)) does exactly what it does
    with the port's npz of the same weights."""
    _, run, _, npz = jax_run
    call = LOADERS[loader]
    got = call(os.path.join(run, "save"), tmp_path, capsys, prepro)
    want = call(npz, tmp_path, capsys, prepro)
    assert sorted(got) == sorted(want) and got
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_mvt_torch_test_on_a_jax_run_directory(jax_run, prepro, tmp_path,
                                                capsys):
    """``mvt-torch-test`` with no --load_from evaluates the run
    directory's latest step (``best``'s with --load_best), as with the
    npz of the same weights."""
    outbase, run, params, npz = jax_run
    for extra, step in (((), 200), (("--load_best",), 150)):
        ttest.main([prepro, outbase, "m", "--batch_size", "4", "--device",
                    "cpu", "--obs_len", "4", "--pred_len", "5", *extra,
                    *WIDTHS])
        got = capsys.readouterr().out.strip().splitlines()[-2:]
        path = str(tmp_path / ("%d.npz" % step))
        save_params_npz(_pruned(params[step]), path)
        assert got == _test_cli(path, tmp_path, capsys, prepro)["table"]


def _serve_args(outbase, *extra):
    args = tserve.build_parser().parse_args(
        [outbase, "m", "--device", "cpu", "--obs_len", "4", "--pred_len",
         "5", "--use_beam_search", "--beam_size", "3", "--diverse_beam",
         *extra, *WIDTHS])
    args.compute_dtype, args.decode_quant = tserve.resolve_serving_dtypes(
        "cpu", args.compute_dtype, args.decode_quant)
    return args, tserve.config_from_args(args)


def test_serve_loads_a_jax_run_directory(jax_run):
    """mvt-torch-serve's run-directory path (no --load_from) on a JAX
    run: ``save``'s latest step, ``best``'s with --load_best, pruned."""
    outbase, run, params, _ = jax_run
    for extra, step in (((), 200), (("--load_best",), 150)):
        args, cfg = _serve_args(outbase, *extra)
        model, got_step = tserve.load_model(args, cfg)
        assert got_step == step
        want = dict(_pruned(params[step]).named_parameters())
        for n, p in model.named_parameters():
            assert torch.equal(p, want[n]), n


def test_hot_reload_follows_a_jax_trainer(jax_run, tmp_path, capsys):
    """The reload poll on a run directory that the JAX CheckpointManager
    writes: a new orbax step is swapped in and the engine then answers
    as one built on it; a later step whose manifest is damaged is
    refused, logged, and the served weights stay."""
    outbase = str(tmp_path)
    run = os.path.join(outbase, "m", "00")
    mgr = JaxCheckpointManager(run)
    first, second = _jax_params(5), _jax_params(6)
    mgr.save(10, first)
    args, cfg = _serve_args(outbase)
    model, step = tserve.load_model(args, cfg)
    assert step == 10
    save = tserve.checkpoint_dir(args)
    eng = _engine(model, cfg)
    try:
        before = eng.predict(OBS)
        assert tserve.reload_once(eng, save, 10) == 10
        mgr.save(20, second)
        assert tserve.reload_once(eng, save, 10) == 20
        after = eng.predict(OBS)
        mgr.save(30, _jax_params(7))
        manifest = os.path.join(save, "30", "default", "manifest.ocdbt")
        data = bytearray(open(manifest, "rb").read())
        data[20] ^= 0x40
        open(manifest, "wb").write(bytes(data))
        capsys.readouterr()
        assert tserve.reload_once(eng, save, 20) == 20
        log = capsys.readouterr().err
        kept = eng.predict(OBS)
    finally:
        eng.close()
    assert "reload failed" in log and "crc32c mismatch" in log, log
    assert "keeping current weights" in log
    direct = _engine(prune_to_template(second, Multiverse.init(cfg)), cfg)
    try:
        want = direct.predict(OBS)
    finally:
        direct.close()
    assert not np.array_equal(after.logprobs, before.logprobs)
    np.testing.assert_array_equal(after.logprobs, want.logprobs)
    np.testing.assert_array_equal(after.trajs, want.trajs)
    np.testing.assert_array_equal(kept.logprobs, after.logprobs)


def _spy(monkeypatch, module, loaded: list):
    real = module.load_checkpoint

    def spying(path, template):
        model = real(path, template)
        loaded.append({n: p.detach().clone()
                       for n, p in model.named_parameters()})
        return model
    monkeypatch.setattr(module, "load_checkpoint", spying)


def test_train_load_continues_above_a_jax_run(jax_run, prepro, tmp_path,
                                              monkeypatch):
    """``mvt-torch-train --load`` in a JAX run directory starts from its
    latest orbax step (pruned to the model), saves above it and, with
    more saves than max_to_keep, deletes only its own steps."""
    _, run, params, _ = jax_run
    outbase = str(tmp_path)
    os.makedirs(os.path.join(outbase, "m"))
    shutil.copytree(run, os.path.join(outbase, "m", "00"))
    loaded = []
    from multiverse_torch.train import checkpoints
    _spy(monkeypatch, checkpoints, loaded)
    ttrain.main([prepro, outbase, "m", "--load", "--batch_size", "4",
                 "--num_epochs", "4", "--save_period", "1", "--device",
                 "cpu", *TRAIN_FLAGS])
    want = dict(_pruned(params[200]).named_parameters())
    assert sorted(loaded[0]) == sorted(want)
    for n, p in want.items():
        assert torch.equal(loaded[0][n], p), n
    save = os.path.join(outbase, "m", "00", "save")
    steps = [s for s, _ in list_steps(save)]
    # 8 examples at batch 4: 2 steps an epoch, each saved; 5 of the
    # port's kept
    assert steps == [100, 200, 204, 205, 206, 207, 208]
    assert [s for s, p in list_steps(save) if not written_by_port(p)] == \
        [100, 200]


def test_train_simaug_load_from_a_jax_save_directory(jax_run, tmp_path,
                                                     monkeypatch):
    """``mvt-torch-train-simaug --load_from`` a JAX ``save`` directory
    starts from its latest step, pruned to the model."""
    _, run, params, _ = jax_run
    cfg = SimAugConfig(obs_len=4, pred_len=5, scene_h=12,
                       scene_w=16, scene_class=5).validate()
    prepro = synthesize_multiview_prepro(str(tmp_path / "prepro"), cfg,
                                         num_agents=2, n_val=4, seed=0)
    loaded = []
    _spy(monkeypatch, tsimaug, loaded)
    tsimaug.main([prepro, str(tmp_path / "out"), "s", "--device", "cpu",
                  "--batch_size", "4", "--num_epochs", "1",
                  "--save_period", "100", "--load_from",
                  os.path.join(run, "save"), *TRAIN_FLAGS])
    want = dict(_pruned(params[200]).named_parameters())
    assert sorted(loaded[0]) == sorted(want)
    for n, p in want.items():
        assert torch.equal(loaded[0][n], p), n
    assert list_steps(str(tmp_path / "out" / "s" / "00" / "save"))
