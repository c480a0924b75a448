"""``mvt-torch-train-simaug`` on the CPU: its parser is the JAX
``mvt-train-simaug``'s (same flags and defaults: keep_prob 0.7, the
scene encoder forced on) plus ``--device`` and ``--model_parallel``;
``main --device cpu`` on tiny 4-camera data (multiview exp 3, FGSM,
mixup, double weighting, dropout) writes config.json with the SimAug
fields, orbax ``{save,best}`` checkpoints that load back and
``val_perf.json``, and resumes with ``--load`` above its last step; its
periodic eval over two gloo ranks equals the one-process eval; it
refuses a ``--load_from`` whose step directory is not a finished orbax
step, ``--model_parallel`` other than 1 and the scene encoder off."""

import json
import os

import numpy as np
import pytest

from multiverse_tpu.cli import train_simaug as jax_cli
from multiverse_torch import parallel
from multiverse_torch.bridge import params_from_jax
from multiverse_torch.cli import train_simaug as cli
from multiverse_torch.data.dataset import batch_to_device, read_data
from multiverse_torch.data.multiview import synthesize_multiview_prepro
from multiverse_torch.models.simaug import SimAugConfig
from multiverse_torch.train.checkpoints import list_steps, read_checkpoint_tree
from multiverse_torch.train.evaluate import evaluate
from multiverse_torch.train.trainer import make_eval_step

MODEL_FLAGS = [
    "--obs_len", "4", "--pred_len", "5",
    "--scene_h", "12", "--scene_w", "16", "--scene_class", "5",
    "--emb_size", "8", "--enc_hidden_size", "16",
    "--dec_hidden_size", "16", "--scene_conv_dim", "8",
    "--scene_grid_strides", "2,4", "--use_grids", "1,0", "--use_gnn",
]
SIMAUG_FLAGS = ["--multiview_train", "--multiview_exp", "3",
                "--adv_use_fgsm", "--use_mixup", "--mixup_alpha", "1.0",
                "--adv_epsilon", "0.1", "--double_weighting",
                "--fl_gamma", "1.0"]


def _options(parser) -> dict:
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_parser_is_the_jax_parser_plus_device():
    port = _options(cli.build_parser())
    jax_opts = _options(jax_cli.build_parser())
    assert set(port) - set(jax_opts) == {"device", "model_parallel"}
    assert set(jax_opts) <= set(port)
    assert {k: port[k] for k in jax_opts} == jax_opts
    assert port["keep_prob"] == 0.7 and port["use_scene_enc"] is True
    assert set(cli.SIMAUG_FIELDS) == set(jax_cli.SIMAUG_FIELDS)


@pytest.fixture(scope="module")
def prepro(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("simaug_cli"))
    cfg = SimAugConfig(obs_len=4, pred_len=5, scene_h=12, scene_w=16,
                       scene_class=5).validate()
    return root, synthesize_multiview_prepro(
        os.path.join(root, "prepro"), cfg, num_agents=5, n_val=6, seed=0)


def test_main_on_cpu_writes_checkpoints_config_and_val_perf(prepro, capsys):
    root, path = prepro
    out = os.path.join(root, "out")
    argv = [path, out, "simaug", "--device", "cpu", "--batch_size", "4",
            "--num_epochs", "1", "--save_period", "3", "--init_lr", "0.3",
            *MODEL_FLAGS, *SIMAUG_FLAGS]
    cli.main(argv)
    run = os.path.join(out, "simaug", "00")
    with open(os.path.join(run, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["multiview_train"] is True and cfg["multiview_exp"] == 3
    assert cfg["adv_use_fgsm"] is True and cfg["double_weighting"] is True
    assert cfg["keep_prob"] == 0.7 and cfg["use_scene_enc"] is True
    assert cfg["multiview_max_num"] == 3
    assert set(cli.SIMAUG_FIELDS) <= set(cfg)
    SimAugConfig.from_json(json.dumps(cfg)).validate()
    with open(os.path.join(run, "val_perf.json")) as f:
        best = json.load(f)["best"]
    # 20 examples, batch 4: 5 steps, evals at 3 and 5
    assert best["step"] in (3, 5)
    assert np.isfinite(best["grid0_traj_ade"])
    saves = list_steps(os.path.join(run, "save"))
    assert [s for s, _ in saves] == [3, 5]
    assert list_steps(os.path.join(run, "best"))
    model = params_from_jax(read_checkpoint_tree(saves[-1][1]))
    assert all(np.isfinite(p.detach().numpy()).all()
               for p in model.parameters())
    printed = capsys.readouterr().out
    assert "SimAug training: 5 steps, views=3, mode=multiview" in printed
    assert "best val grid0_traj_ade" in printed

    # --load resumes above the last step
    cli.main(argv + ["--load", "--adv_train", "--adv_num_iter", "2",
                     "--num_epochs", "1"])
    assert [s for s, _ in list_steps(os.path.join(run, "save"))][-2:] == \
        [8, 10]


def test_eval_shards_over_two_ranks_as_one_device(prepro):
    """The periodic eval over two gloo ranks (rank 0 trains and sends
    the weights; each rank decodes its half of every val batch): each
    eval's metrics equal the one-process eval of the step rank 0 saved
    there."""
    root, path = prepro
    out = os.path.join(root, "out_sharded")
    args = cli.build_parser().parse_args([
        path, out, "simaug", "--device", "cpu", "--batch_size", "4",
        "--num_epochs", "1", "--save_period", "3", "--init_lr", "0.3",
        *MODEL_FLAGS, *SIMAUG_FLAGS])
    two = parallel.launch(cli.simaug_worker,
                          parallel.make_mesh(devices=["cpu", "cpu"]), args,
                          timeout=150)
    assert [r["world"] for r in two] == [2, 2]
    assert two[1]["evals"] == len(two[0]["evals"]) == 2
    cfg = cli.simaug_config_from_args(args)
    val = read_data(path, "val", cfg)
    step = make_eval_step(cfg)
    saves = list_steps(os.path.join(out, "simaug", "00", "save"))
    assert [s for s, _ in saves] == [3, 5]
    for (_, ckpt), got in zip(saves, two[0]["evals"]):
        model = params_from_jax(read_checkpoint_tree(ckpt))

        def eval_fn(batch):
            cl, rg = step(model, batch_to_device(batch, "cpu"))
            return ({i: v.numpy() for i, v in cl.items()},
                    {i: v.numpy() for i, v in rg.items()})

        want = evaluate(val, cfg, eval_fn)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_refusals(prepro, tmp_path):
    root, path = prepro
    orbax = tmp_path / "orbax_run"
    (orbax / "300").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        cli.main([path, str(tmp_path), "m", "--device", "cpu",
                  "--load_from", str(orbax), *MODEL_FLAGS])
    with pytest.raises(SystemExit, match="model_parallel"):
        cli.main([path, str(tmp_path), "m", "--device", "cpu",
                  "--model_parallel", "2", *MODEL_FLAGS])
    with pytest.raises(ValueError, match="use_scene_enc"):
        SimAugConfig(use_scene_enc=False).validate()
    with pytest.raises(ValueError, match="one active grid"):
        SimAugConfig(multiview_train=True,
                     use_grids=(True, True)).validate()
