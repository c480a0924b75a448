"""The port's training data path and its commands on the CPU, against
the JAX package: ``read_data``/``get_batches`` on a prepro dir written
by the JAX ``mvt-preprocess`` yield the JAX batches, batch for batch in
the same shuffle order; the JAX ``read_data`` reads what
``synthesize_prepro`` writes; ``mvt-torch-train --device cpu`` writes
config.json, the {save,best} checkpoints and val_perf.json; its best
checkpoint decodes through ``mvt-torch-multifuture-inference``
(its ``model_path``), evaluates through ``mvt-torch-test`` and round-trips
into the JAX model."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.data.dataset import read_data as jax_read_data
from multiverse_tpu.models import model_forward as jax_model_forward
from multiverse_torch.bridge import params_from_jax, params_to_numpy_tree
from multiverse_torch.cli.common import config_from_args
from multiverse_torch.cli import multifuture_inference as tinf_cli
from multiverse_torch.cli import test as ttest
from multiverse_torch.cli import train as ttrain
from multiverse_torch.data.dataset import (
    batch_to_device,
    read_data,
    synthesize_prepro,
)
from multiverse_torch.models import Multiverse, model_forward
from multiverse_torch.train.checkpoints import (
    list_steps,
    load_checkpoint,
    read_checkpoint_tree,
    resolve_checkpoint,
)
from multiverse_torch.train.orbax_reader import is_orbax_step
from synthetic import (
    tiny_config,
    write_multifuture_dataset,
    write_reference_format_dataset,
)

MODEL_FLAGS = [
    "--obs_len", "4", "--pred_len", "5",
    "--scene_h", "12", "--scene_w", "16", "--scene_class", "5",
    "--emb_size", "8", "--enc_hidden_size", "16",
    "--dec_hidden_size", "16", "--scene_conv_dim", "8",
    "--scene_grid_strides", "2,4", "--use_grids", "1,0",
    "--use_gnn", "--use_scene_enc",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's tiny CPU trainings and decodes run on one intra-op
    thread: with a thread pool a process, the suite's parallel workers
    oversubscribe the cores and the small ops wait on each other (a
    2-epoch run took minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def prepro(tmp_path_factory):
    from multiverse_tpu.cli import preprocess

    root = str(tmp_path_factory.mktemp("torch_train"))
    traj_path, scene_path, id2name = write_reference_format_dataset(
        root, tiny_config(), np.random.RandomState(7), num_videos=2,
        frames_per_video=20)
    out = os.path.join(root, "prepro")
    preprocess.main([
        traj_path, out, "--obs_len", "4", "--pred_len", "5",
        "--add_grid", "--add_all_reg", "--add_scene",
        "--scene_feat_path", scene_path, "--scene_id2name", id2name,
        "--direct_scene_feat", "--scene_h", "12", "--scene_w", "16",
        "--grid_strides", "2,4"])
    return root, out


def _assert_same_batches(j_ds, t_ds, batch_size, num_steps):
    pairs = zip(j_ds.get_batches(batch_size, num_steps=num_steps),
                t_ds.get_batches(batch_size, num_steps=num_steps))
    n = 0
    for (jb, jx), (tb, tx) in pairs:
        for a, b in zip(jax.tree_util.tree_leaves(jb),
                        jax.tree_util.tree_leaves(tb)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert jx["traj_key"] == tx["traj_key"]
        assert jx["original_batch_size"] == tx["original_batch_size"]
        np.testing.assert_array_equal(jx["pred_traj"], tx["pred_traj"])
        n += 1
    assert n == num_steps


def test_read_data_and_batches_equal_jax(prepro):
    _, path = prepro
    cfg = tiny_config(use_grids=(True, True))
    for split in ("train", "val"):
        j_ds = jax_read_data(path, split, cfg)
        t_ds = read_data(path, split, cfg)
        assert t_ds.num_examples == j_ds.num_examples > 4
        for a, b in zip(j_ds.grid_centers, t_ds.grid_centers):
            np.testing.assert_array_equal(a, b)
        # two epochs, shuffled, the last batch padded
        _assert_same_batches(j_ds, t_ds, 4, 2 * t_ds.num_batches(4) + 1)


def test_jax_reads_synthesized_prepro(tmp_path):
    cfg = tiny_config(use_grids=(True, True))
    synthesize_prepro(str(tmp_path), cfg, n_train=10, n_val=6, seed=3)
    for split in ("train", "val"):
        j_ds = jax_read_data(str(tmp_path), split, cfg)
        t_ds = read_data(str(tmp_path), split, cfg)
        assert j_ds.num_examples == {"train": 10, "val": 6}[split]
        _assert_same_batches(j_ds, t_ds, 4, 3)
    # the walks stay inside the frame and match their grid cells
    with np.load(os.path.join(str(tmp_path), "data_train.npz"),
                 allow_pickle=True) as f:
        traj = np.concatenate([f["obs_traj"], f["pred_traj"]], axis=1)
        assert (traj >= 0).all() and (traj[..., 0] <= cfg.video_w).all()
        assert f["scene_feat"].dtype == np.uint8
        assert f["obs_grid_class"].shape == (10, 2, cfg.obs_len)


@pytest.fixture(scope="module")
def trained(prepro):
    root, path = prepro
    outbase = os.path.join(root, "models")
    ttrain.main([path, outbase, "toy", "--runId", "1", "--batch_size", "4",
                 "--num_epochs", "2", "--save_period", "5", "--init_lr",
                 "0.3", "--use_soft_grid_class", "--device", "cpu",
                 *MODEL_FLAGS])
    return os.path.join(outbase, "toy", "01")


def test_train_cli_writes_the_run(trained):
    with open(os.path.join(trained, "config.json")) as f:
        assert json.load(f)["use_soft_grid_class"] is True
    with open(os.path.join(trained, "val_perf.json")) as f:
        perf = json.load(f)
    assert perf["best"]["step"] > 0
    assert len(perf["val_perf"]) >= 2
    for sub in ("save", "best"):
        steps = list_steps(os.path.join(trained, sub))
        names = os.listdir(os.path.join(trained, sub))
        assert steps and sorted(names) == sorted(str(s) for s, _ in steps)
        assert all(is_orbax_step(path) for _, path in steps)


def test_best_checkpoint_decodes_and_round_trips(trained, tmp_path,
                                                 prepro):
    best = resolve_checkpoint(os.path.join(trained, "best"))
    cfg = tiny_config(use_soft_grid_class=True)
    traj_p, mf_p, scene_p, id2name = write_multifuture_dataset(
        str(tmp_path), cfg, np.random.RandomState(1), num_traj=3,
        max_pred_len=6)
    out = str(tmp_path / "o.traj.p")
    tinf_cli.main([best, traj_p, mf_p, out, "--device", "cpu",
                   "--scene_feat_path", scene_p, "--scene_id2name",
                   id2name, "--num_out", "3", "--use_gnn", "--use_scene_enc",
                   "--scene_h", "12", "--scene_w", "16", "--scene_class", "5",
                   "--emb_size", "8", "--enc_hidden_size", "16",
                   "--dec_hidden_size", "16", "--scene_conv_dim", "8",
                   "--obs_length", "4"])
    with open(out, "rb") as f:
        assert len(pickle.load(f)) == 3

    # the trained weights back in the JAX layout give the JAX model the
    # same eval forward
    model = params_from_jax(read_checkpoint_tree(best))
    tree = params_to_numpy_tree(model)
    ds = read_data(prepro[1], "val", cfg)
    batch, _ = ds.make_batch(list(range(4)))
    j_out = jax_model_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                              jax.tree_util.tree_map(jnp.asarray, batch),
                              cfg)
    with torch.inference_mode():
        t_out = model_forward(model, batch_to_device(batch, "cpu"), cfg)
    np.testing.assert_allclose(t_out.reg_out[0].numpy(),
                               np.asarray(j_out.reg_out[0]), rtol=1e-4,
                               atol=1e-3)


def test_test_cli_evaluates_the_best_checkpoint(trained, prepro, capsys):
    root, path = prepro
    perf = ttest.main([path, os.path.join(root, "models"), "toy", "--runId",
                       "1", "--load_best", "--batch_size", "4", "--device",
                       "cpu", "--use_soft_grid_class", *MODEL_FLAGS])
    names, numbers = capsys.readouterr().out.strip().splitlines()[-2:]
    assert "grid0_traj_ade" in names.split()
    assert perf["grid0_traj_ade"] > 0


def test_train_cli_resumes_and_refuses(trained, prepro):
    root, path = prepro
    outbase = os.path.join(root, "models")
    ttrain.main([path, outbase, "toy", "--runId", "1", "--load",
                 "--batch_size", "4", "--num_epochs", "1", "--save_period",
                 "100", "--use_soft_grid_class", "--device", "cpu",
                 *MODEL_FLAGS])
    # saves continue above the loaded run's steps
    steps = list_steps(os.path.join(trained, "save"))
    assert steps[-1][0] > 10
    # --model_parallel 2 on the CPU: two gloo ranks, each with half of
    # every weight; its one step is saved whole and loads at mp = 1,
    # equal to a one-process run's step within the step tolerance
    tp_prepro = synthesize_prepro(os.path.join(root, "tp_prepro"),
                                  tiny_config(), n_train=4, n_val=4, seed=5)
    flags = [tp_prepro, outbase, "tp", "--batch_size", "4", "--num_epochs",
             "1", "--save_period", "1", "--device", "cpu", *MODEL_FLAGS]
    two = ttrain.main(flags + ["--runId", "2", "--model_parallel", "2"])
    one = ttrain.main(flags + ["--runId", "1"])
    assert (two["steps"], two["world"], one["world"]) == (1, 2, 1)
    assert two["best"]["step"] == one["best"]["step"] == 1
    cfg = config_from_args(ttrain.build_parser().parse_args(flags))
    got, want = (load_checkpoint(
        os.path.join(outbase, "tp", run, "save"), Multiverse.init(cfg))
        for run in ("02", "01"))
    for (n, a), (_, b) in zip(sorted(got.named_parameters()),
                              sorted(want.named_parameters())):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=n)
    orbax_like = os.path.join(root, "orbax_run")
    os.makedirs(os.path.join(orbax_like, "300"))
    with pytest.raises(ValueError, match="orbax"):
        ttrain.main([path, outbase, "toy", "--load_from", orbax_like,
                     "--device", "cpu", *MODEL_FLAGS])


def test_loss_buffer_flushes_in_one_transfer_and_aborts_on_nan():
    from multiverse_torch.cli.common import LossBuffer
    from multiverse_torch.utils import MovingAverage

    loss_ma, wd_ma = MovingAverage(10), MovingAverage(10)
    buf = LossBuffer(loss_ma, period=3, aux_mas={"wd": wd_ma})
    for step, v in enumerate((1.0, 2.0), start=1):
        buf.put(step, torch.tensor(v), aux={"wd": torch.tensor(v / 10)})
    assert loss_ma.me() == 0.0            # still on the device
    buf.put(3, torch.tensor(3.0), aux={"wd": torch.tensor(0.3)})
    assert loss_ma.me() == pytest.approx(2.0)
    assert wd_ma.me() == pytest.approx(0.2)
    buf.put(4, torch.tensor(float("nan")), aux={"wd": torch.tensor(0.0)})
    with pytest.raises(SystemExit):
        buf.flush()


def test_train_cli_profile_writes_a_trace(prepro, tmp_path):
    _, path = prepro
    trace_dir = str(tmp_path / "trace")
    ttrain.main([path, str(tmp_path / "models"), "toy", "--batch_size", "4",
                 "--num_epochs", "1", "--save_period", "100", "--profile",
                 trace_dir, "--device", "cpu", *MODEL_FLAGS])
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0
