"""The port's scoring modules and commands against the JAX package's on
the same pickles: ``eval.multifuture`` (minADE/minFDE by camera group,
grid NLL), ``eval.sdd`` (rescaled ADE/FDE) and ``mvt-torch-eval-trajs``,
``mvt-torch-eval-prob``, ``mvt-torch-evaluate-sdd``, whose printed
lines must equal the JAX commands' character for character."""

import os
import pickle

import numpy as np
import pytest

from multiverse_tpu.cli import evaluate_sdd as jax_sdd_cli
from multiverse_tpu.cli import multifuture_eval_trajs as jax_trajs_cli
from multiverse_tpu.cli import multifuture_eval_trajs_prob as jax_prob_cli
from multiverse_tpu.eval import multifuture as jax_mf
from multiverse_tpu.eval import sdd as jax_sdd
from multiverse_torch.cli import evaluate_sdd as sdd_cli
from multiverse_torch.cli import multifuture_eval_trajs as trajs_cli
from multiverse_torch.cli import multifuture_eval_trajs_prob as prob_cli
from multiverse_torch.eval import multifuture, sdd

K, T, H, W = 5, 12, 18, 32


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """GT futures (varied lengths, some shorter than T) for two 45-degree
    and one top-down trajectory, predictions, beam logits and an SDD
    output with its resize records."""
    root = tmp_path_factory.mktemp("scoring")
    rng = np.random.RandomState(0)
    gt_dir = root / "gt"
    gt_dir.mkdir()
    pred, prob = {}, {}
    for tid in ("0000_1_2_cam1", "0400_3_4_cam2", "0401_5_6_cam4"):
        futures = {}
        for f in range(3):
            n = int(rng.randint(3, T + 1))
            xy = rng.uniform([0, 0], [1920, 1080], size=(n, 2))
            futures[f] = {"x_agent_traj": [(i, 1, float(x), float(y))
                                           for i, (x, y) in enumerate(xy)]}
        with open(gt_dir / ("%s.p" % tid), "wb") as f:
            pickle.dump(futures, f)
        pred[tid] = rng.uniform([0, 0], [1920, 1080],
                                size=(K, T, 2)).tolist()
        prob[tid] = (rng.randn(1, K, T, H * W).astype(np.float32),
                     rng.randn(1, K).astype(np.float32))
    with open(root / "pred.traj.p", "wb") as f:
        pickle.dump(pred, f)
    with open(root / "pred.prob.p", "wb") as f:
        pickle.dump(prob, f)

    seq_ids = np.asarray(["bookstore_0_120_7", "coupa_1_48_3",
                          "bookstore_0_132_9"])
    out = {"seq_ids": seq_ids,
           "pred_gt_list": rng.uniform(0, 1000, (3, T, 2)),
           "grid0_pred_traj": rng.uniform(0, 1000, (3, T, 2))}
    with open(root / "sdd_out.p", "wb") as f:
        pickle.dump(out, f)
    with open(root / "resize.lst", "w") as f:
        f.write("bookstore_0,1424x1088,False\ncoupa_1,1980x1093,True\n")
    return {k: str(v) for k, v in dict(
        gt=gt_dir, trajs=root / "pred.traj.p", prob=root / "pred.prob.p",
        sdd=root / "sdd_out.p", lst=root / "resize.lst").items()}, pred, prob


def test_library_metrics_equal_jax(pickles):
    paths, pred, prob = pickles
    assert multifuture.evaluate_multifuture_trajs(pred, paths["gt"]) == \
        jax_mf.evaluate_multifuture_trajs(pred, paths["gt"])
    got = multifuture.evaluate_multifuture_nll(prob, paths["gt"])
    want = jax_mf.evaluate_multifuture_nll(prob, paths["gt"])
    assert got == want and np.isfinite(got["nll_T=1"])
    assert sdd.evaluate_sdd(paths["sdd"], paths["lst"]) == \
        jax_sdd.evaluate_sdd(paths["sdd"], paths["lst"])


@pytest.mark.parametrize("port,jax_cmd,args", [
    (trajs_cli, jax_trajs_cli, ("gt", "trajs")),
    (prob_cli, jax_prob_cli, ("gt", "prob")),
    (sdd_cli, jax_sdd_cli, ("lst", "sdd")),
])
def test_commands_print_what_the_jax_commands_print(pickles, capsys, port,
                                                    jax_cmd, args):
    paths, _, _ = pickles
    argv = [paths[a] for a in args]
    port.main(argv)
    got = capsys.readouterr().out
    jax_cmd.main(argv)
    want = capsys.readouterr().out
    assert got == want and len(got.splitlines()) >= 1
    assert "nan" not in got
