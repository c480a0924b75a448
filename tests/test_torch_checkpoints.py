"""The port's checkpoint flow on the CPU, against the JAX package: a
checkpoint that holds more grid scales than the model is pruned as
``multiverse_tpu.train.checkpoints._prune_to_template`` prunes it (the
same names and values kept, the same errors), and every loader of the
port accepts it; the run-directory paths of ``mvt-torch-serve``; its
hot reload over npz steps; and ``run_multifuture_inference``'s
``T_max`` and ``timings`` against the JAX function's."""

import os
import pickle
import shutil
import threading
import time

import jax
import numpy as np
import pytest
import torch

from multiverse_tpu import inference as jinf
from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.train.checkpoints import _prune_to_template
from multiverse_torch import inference as tinf
from multiverse_torch.bridge import (
    check_params,
    load_params_npz,
    load_params_tree,
    params_from_jax,
    prune_to_template,
    save_params_npz,
)
from multiverse_torch.cli import multifuture_inference as tinf_cli
from multiverse_torch.cli import preprocess as tpre_cli
from multiverse_torch.cli import serve as tserve
from multiverse_torch.cli import test as ttest
from multiverse_torch.config import MultiverseConfig
from multiverse_torch.models import Multiverse
from multiverse_torch.serving.engine import ServingEngine
from multiverse_torch.train.checkpoints import (
    CheckpointManager,
    list_steps,
    load_checkpoint,
    resolve_checkpoint,
)
from synthetic import (
    tiny_config,
    write_multifuture_dataset,
    write_reference_format_dataset,
)

WIDTHS = ["--scene_h", "12", "--scene_w", "16", "--scene_class", "5",
          "--emb_size", "8", "--enc_hidden_size", "16",
          "--dec_hidden_size", "16", "--scene_conv_dim", "8",
          "--use_gnn", "--use_scene_enc"]


def _cfg(**kw) -> MultiverseConfig:
    """The port's configuration at tests/synthetic.py's tiny dims, with
    the GNN and the scene encoder."""
    base = dict(obs_len=4, pred_len=5, scene_h=12, scene_w=16,
                scene_class=5, emb_size=8, enc_hidden_size=16,
                dec_hidden_size=16, scene_conv_dim=8,
                scene_grid_strides=(2, 4), use_grids=(True, False),
                use_gnn=True, use_scene_enc=True)
    base.update(kw)
    return MultiverseConfig(**base).validate()


def _jax_tree(use_grids=(True, False), seed=2, **kw):
    """The JAX ``init_params`` tree as numpy, at the tiny dims."""
    cfg = tiny_config(use_grids=use_grids, use_gnn=True, use_scene_enc=True,
                      **kw)
    return jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def superset(tmp_path_factory):
    """An npz written from the JAX tree at --use_grids 1,1, and the
    (1,0) configuration that reads it."""
    path = str(tmp_path_factory.mktemp("ckpt") / "grids11.npz")
    save_params_npz(params_from_jax(_jax_tree((True, True))), path)
    return path, _cfg()


def _pruned_jax(saved_tree, template_tree) -> dict:
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(
                _prune_to_template(saved_tree, template_tree))}


def _leaf_for_subtree(tree):
    tree["scales"]["0"]["dec_class"] = np.zeros(3, np.float32)
    return tree


def _wrong_shape(tree):
    return _jax_tree((True, True), emb_size=4)


PRUNE_CASES = {
    # saved tree maker, template's use_grids
    "superset": (lambda t: t, (True, False)),
    "exact": (lambda t: _jax_tree((True, False)), (True, False)),
    "module": (lambda t: t, (True, False)),
    "missing_scale": (lambda t: _jax_tree((True, False)), (True, True)),
    "wrong_shape": (_wrong_shape, (True, False)),
    "leaf_for_subtree": (_leaf_for_subtree, (True, False)),
}


@pytest.mark.parametrize("case", list(PRUNE_CASES))
def test_prune_to_template_matches_jax(case, tmp_path):
    """The npz of the JAX (1,1) tree, loaded at (1,0): the names and
    values the JAX prune keeps, or its KeyError / ValueError, message
    for message."""
    make, grids = PRUNE_CASES[case]
    saved = make(_jax_tree((True, True)))
    template = _jax_tree(grids, seed=5)
    try:
        want = _pruned_jax(saved, template)
    except (KeyError, ValueError) as exc:
        want = exc
    if case == "leaf_for_subtree":
        got_saved = saved        # an npz cannot hold this tree
    else:
        path = str(tmp_path / "saved.npz")
        save_params_npz(params_from_jax(saved), path)
        got_saved = load_params_npz(path) if case == "module" \
            else load_params_tree(path)
    if isinstance(want, Exception):
        with pytest.raises(type(want)) as info:
            prune_to_template(got_saved, params_from_jax(template))
        assert str(info.value) == str(want)
        return
    got = dict(prune_to_template(got_saved, params_from_jax(template))
               .named_parameters())
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_array_equal(got[name].numpy(), v, err_msg=name)
    # pruned against the configuration's own template: the same
    check_params(prune_to_template(got_saved, Multiverse.init(
        _cfg(use_grids=grids))), params_from_jax(template))


def test_check_params_still_demands_an_exact_match(superset):
    """``check_params`` (the bridge's exact comparison) refuses what
    the loaders now prune: the fault the loaders had."""
    path, cfg = superset
    with pytest.raises(ValueError, match=r"unexpected \['scales\.1\."):
        check_params(load_params_npz(path), Multiverse.init(cfg))
    pruned = load_checkpoint(path, Multiverse.init(cfg))
    check_params(pruned, Multiverse.init(cfg))


def _exact_twin(superset, tmp_path) -> str:
    """The superset checkpoint pruned by hand to the (1,0) names."""
    path, cfg = superset
    tree = load_params_tree(path)
    tree["scales"] = {"0": tree["scales"]["0"]}
    exact = str(tmp_path / "exact.npz")
    save_params_npz(params_from_jax(tree), exact)
    return exact


@pytest.fixture(scope="module")
def prepro(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prepro"))
    traj, scene_path, id2name = write_reference_format_dataset(
        root, tiny_config(), np.random.RandomState(4), num_videos=1,
        frames_per_video=14)
    out = os.path.join(root, "prepro")
    tpre_cli.main([traj, out, "--obs_len", "4", "--pred_len", "5",
                   "--add_grid", "--add_all_reg", "--add_scene",
                   "--scene_feat_path", scene_path, "--scene_id2name",
                   id2name, "--direct_scene_feat", "--scene_h", "12",
                   "--scene_w", "16", "--grid_strides", "2,4"])
    return out


def _test_cli(prepro, path, tmp_path):
    return ttest.main([prepro, str(tmp_path / "models"), "m", "--load_from",
                       path, "--batch_size", "4", "--device", "cpu",
                       "--obs_len", "4", "--pred_len", "5", *WIDTHS])


def _multifuture_cli(path, tmp_path):
    cfg = tiny_config()
    files = write_multifuture_dataset(str(tmp_path / "mf"), cfg,
                                      np.random.RandomState(1), num_traj=3,
                                      max_pred_len=6)
    out = str(tmp_path / ("%s.traj.p" % os.path.basename(path)))
    tinf_cli.main([path, files[0], files[1], out, "--device", "cpu",
                   "--scene_feat_path", files[2], "--scene_id2name",
                   files[3], "--num_out", "3", "--obs_length", "4",
                   "--diverse_beam", *WIDTHS])
    with open(out, "rb") as f:
        return {k: np.asarray(v) for k, v in pickle.load(f).items()}


def _serve_load_model(path, tmp_path):
    args = tserve.build_parser().parse_args(
        ["out", "m", "--device", "cpu", "--load_from", path, "--obs_len",
         "4", "--pred_len", "5", *WIDTHS])
    args.compute_dtype, args.decode_quant = tserve.resolve_serving_dtypes(
        "cpu", args.compute_dtype, args.decode_quant)
    model, step = tserve.load_model(args, tserve.config_from_args(args))
    assert step is None
    return {n: p.numpy() for n, p in model.named_parameters()}


def _update_params(path, tmp_path):
    cfg = _cfg(use_beam_search=True, beam_size=3)
    obs = np.random.RandomState(0).uniform(100, 500, (4, 2)).astype(
        np.float32)
    eng = ServingEngine(Multiverse.init(cfg, seed=7), cfg, max_batch=2,
                        T_pred=4, device="cpu")
    try:
        eng.update_params(load_params_npz(path))
        res = eng.predict(obs)
    finally:
        eng.close()
    return {"trajs": res.trajs, "logprobs": res.logprobs}


LOADERS = {"mvt-torch-test": _test_cli,
           "mvt-torch-multifuture-inference": _multifuture_cli,
           "mvt-torch-serve": _serve_load_model,
           "update_params": _update_params}


@pytest.mark.parametrize("loader", list(LOADERS))
def test_loaders_accept_a_superset_checkpoint(loader, superset, prepro,
                                              tmp_path):
    """Each loader given the (1,1) checkpoint at (1,0) does what it does
    with the same weights pruned by hand (the parent refused it in
    ``check_params``)."""
    path, _ = superset
    args = (prepro,) if loader == "mvt-torch-test" else ()
    got = LOADERS[loader](*args, path, tmp_path)
    want = LOADERS[loader](*args, _exact_twin(superset, tmp_path), tmp_path)
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_resolve_checkpoint_and_the_run_directory(tmp_path):
    """An npz file, an orbax step, the latest step of a directory (a
    save under its temporary name, orbax or npz, is not a step), a
    directory whose step directory is not a finished orbax step
    refused; and
    ``mvt-torch-serve``'s run-directory path: ``save``'s latest step,
    ``best``'s with --load_best, the step it loaded, and an error where
    the run holds none."""
    cfg = _cfg()
    run = tmp_path / "out" / "m" / "03"
    mgr = CheckpointManager(str(run))
    models = {s: Multiverse.init(cfg, seed=s) for s in (1, 2, 3)}
    mgr.save(10, models[1])
    mgr.save(20, models[2])
    mgr.save(15, models[3], best=True)
    (run / "save" / "step_00000030.npz.tmp.npz").write_bytes(b"partial")
    shutil.copytree(str(run / "save" / "20"),
                    str(run / "save" / "30.orbax-checkpoint-tmp-1"))
    npz = str(run / "save" / "step_00000005.npz")
    save_params_npz(models[1], npz)
    assert [s for s, _ in list_steps(str(run / "save"))] == [5, 10, 20]
    latest = resolve_checkpoint(str(run / "save"))
    assert latest == str(run / "save" / "20")
    assert resolve_checkpoint(latest) == latest
    assert resolve_checkpoint(npz) == npz
    (tmp_path / "orbax" / "300").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        resolve_checkpoint(str(tmp_path / "orbax"))
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint(str(tmp_path / "orbax" / "300"))

    def serve_args(*extra):
        args = tserve.build_parser().parse_args(
            [str(tmp_path / "out"), "m", "--runId", "3", "--device", "cpu",
             *extra, *WIDTHS])
        args.compute_dtype, args.decode_quant = \
            tserve.resolve_serving_dtypes("cpu", None, None)
        return args, tserve.config_from_args(args)

    for extra, step, seed in (((), 20, 2), (("--load_best",), 15, 3)):
        args, scfg = serve_args(*extra)
        assert tserve.checkpoint_dir(args) == str(
            run / ("best" if extra else "save"))
        model, got_step = tserve.load_model(args, scfg)
        assert got_step == step
        for (n, a), (_, b) in zip(model.named_parameters(),
                                  models[seed].named_parameters()):
            assert torch.equal(a, b), n
    args, scfg = serve_args("--runId", "4")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tserve.load_model(args, scfg)
    assert not (tmp_path / "out" / "m" / "04").exists()


def test_a_save_in_flight_is_never_listed(tmp_path, monkeypatch):
    """``CheckpointManager.save`` writes under a temporary name and
    renames: while it writes, the directory lists only finished steps."""
    from multiverse_torch.train import orbax_writer

    cfg = _cfg()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(20, Multiverse.init(cfg))
    seen = []
    write = orbax_writer.write_database

    def spying(root, entries):
        write(root, entries)
        seen.append((os.path.basename(os.path.dirname(root)),
                     [s for s, _ in list_steps(mgr.save_dir)]))

    monkeypatch.setattr(orbax_writer, "write_database", spying)
    mgr.save(40, Multiverse.init(cfg, seed=1))
    assert len(seen) == 1 and seen[0][1] == [20]
    assert seen[0][0].startswith("40.orbax-checkpoint-tmp-")
    assert [s for s, _ in list_steps(mgr.save_dir)] == [20, 40]


def _engine_on(path, cfg):
    return ServingEngine(load_checkpoint(path, Multiverse.init(cfg)), cfg,
                         max_batch=2, T_pred=4, device="cpu")


def _serving_cfg():
    return _cfg(use_beam_search=True, beam_size=3, diverse_beam=True)


def test_reload_loop_swaps_in_a_newer_step(tmp_path):
    """Step 20 served; step 40 written while requests keep arriving is
    picked up within a few polls, no request fails, and a response then
    equals a direct forward on step 40's weights."""
    cfg = _serving_cfg()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(20, Multiverse.init(cfg, seed=1))
    obs = np.random.RandomState(0).uniform(100, 500, (4, 2)).astype(
        np.float32)
    eng = _engine_on(mgr.save_dir, cfg)
    stop, traffic_stop = threading.Event(), threading.Event()
    errors, answers = [], []

    def traffic():
        # a request every 10 ms or so, not a busy loop
        while not traffic_stop.wait(0.01):
            try:
                answers.append(eng.predict(obs, timeout=30))
            except Exception as exc:   # re-raised below
                errors.append(exc)

    loop = threading.Thread(target=tserve.reload_loop,
                            args=(eng, mgr.save_dir, 20, 0.05, stop))
    client = threading.Thread(target=traffic)
    try:
        before = eng.predict(obs)
        loop.start()
        client.start()
        path = mgr.save(40, Multiverse.init(cfg, seed=2))
        deadline = time.monotonic() + 20
        after = before
        while np.array_equal(after.logprobs, before.logprobs):
            assert time.monotonic() < deadline, "step 40 was not served"
            time.sleep(0.05)
            after = eng.predict(obs)
    finally:
        traffic_stop.set()
        client.join(30)
        stop.set()
        loop.join(30)
        eng.close()
    assert not client.is_alive() and not loop.is_alive()
    assert not errors and answers
    direct = _engine_on(path, cfg)
    try:
        want = direct.predict(obs)
    finally:
        direct.close()
    np.testing.assert_allclose(after.logprobs, want.logprobs, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(after.trajs, want.trajs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fault", ["wrong_shape", "tmp_left_behind",
                                   "truncated"])
def test_reload_keeps_the_served_step(fault, tmp_path, capsys):
    """A newer step with the wrong shapes or a truncated file, or a save
    left under its temporary name, keeps step 20 served; a failed
    restore is logged and retried at the next poll."""
    cfg = _serving_cfg()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(20, Multiverse.init(cfg, seed=1))
    obs = np.random.RandomState(0).uniform(100, 500, (4, 2)).astype(
        np.float32)
    eng = _engine_on(mgr.save_dir, cfg)
    try:
        before = eng.predict(obs)
        bad = os.path.join(mgr.save_dir, "step_00000040.npz")
        if fault == "wrong_shape":
            save_params_npz(Multiverse.init(_cfg(emb_size=4)), bad)
        elif fault == "truncated":
            save_params_npz(Multiverse.init(cfg, seed=2), bad)
            with open(bad, "r+b") as f:
                f.truncate(os.path.getsize(bad) // 2)
        else:
            save_params_npz(Multiverse.init(cfg, seed=2), bad + ".tmp.npz")
        capsys.readouterr()
        for _ in range(2):
            assert tserve.reload_once(eng, mgr.save_dir, 20) == 20
        log = capsys.readouterr().err
        after = eng.predict(obs)
    finally:
        eng.close()
    np.testing.assert_array_equal(after.logprobs, before.logprobs)
    if fault == "tmp_left_behind":
        assert log == ""
    else:
        assert log.count("reload failed") == 2, log
        assert "keeping current weights" in log


@pytest.mark.parametrize("mode", ["beam", "beam_no_prob", "greedy"])
def test_run_multifuture_inference_T_max_and_timings_match_jax(mode):
    """``T_max`` below the longest future truncates the outputs as the
    JAX function does, the pickles agree at the tolerances of
    tests/test_torch_inference.py, and ``timings`` has the JAX keys and
    counts the same batches and fetched bytes."""
    cfg = tiny_config(use_gnn=True, use_scene_enc=True, use_beam_search=True,
                      beam_size=3, diverse_beam=True, diverse_gamma=0.01,
                      fix_num_timestep=1, video_h=540, video_w=960,
                      obs_len=8, pred_len=4)
    jparams = jax_init_params(jax.random.PRNGKey(1), cfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    inputs = jinf.synthesize_multifuture_inputs(cfg, 5, seed=0,
                                                max_pred_len=6)
    T_max = int(inputs.pred_lengths.max()) - 2
    assert (inputs.pred_lengths > T_max).any()
    kw = dict(batch_size=2, T_max=T_max, greedy=mode == "greedy",
              need_prob=mode == "beam")
    j_t, t_t = {}, {}
    j_out, j_prob = jinf.run_multifuture_inference(jparams, inputs, cfg,
                                                   timings=j_t, **kw)
    t_out, t_prob = tinf.run_multifuture_inference(model, inputs, cfg,
                                                   device="cpu", timings=t_t,
                                                   **kw)
    assert set(t_t) == set(j_t) == {"build_s", "fetch_s", "fetch_bytes",
                                    "pack_s", "batches"}
    assert t_t["batches"] == j_t["batches"] == 3
    assert t_t["fetch_bytes"] == j_t["fetch_bytes"] > 0
    assert all(t_t[k] >= 0 for k in ("build_s", "fetch_s", "pack_s"))
    assert set(t_out) == set(j_out) and set(t_prob) == set(j_prob)
    assert bool(t_prob) == (mode == "beam")
    for n, tid in enumerate(inputs.traj_ids):
        a, b = np.asarray(t_out[tid]), np.asarray(j_out[tid])
        assert a.shape == b.shape == (
            3, min(int(inputs.pred_lengths[n]), T_max), 2)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        for x, y in zip(t_prob.get(tid, ()), j_prob.get(tid, ())):
            assert x.shape == y.shape and x.dtype == y.dtype
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4)
