"""The port's data parallelism (``multiverse_torch.parallel``) on the
CPU, two ``gloo`` ranks in spawned processes, against the JAX package's
mesh on the 8 virtual CPU devices of ``tests/conftest.py`` and against
the port's single-process step: the mesh planning rules and errors; the
data-parallel train step (total rtol 2e-4, parameters rtol 1e-3 / atol
1e-5, the tolerances of ``tests/test_parallel.py``), masked with soft
labels and unmasked; dropout's per-rank masks; the sharded eval and
beam steps (beam ids equal); the serving engine over a mesh across an
``update_params``; and ``mvt-torch-train``'s rank worker at world 2.

The ranks run ``tests/torch_parallel_ranks.py``, which imports no jax:
this module computes the JAX references and hands the ranks numpy
arrays. Every launch has its own time limit (``LAUNCH_TIMEOUT_S``): a
rank that hangs fails its test, and the launcher stops every rank.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from multiverse_tpu import parallel as jpar
from multiverse_tpu.inference import beam_forward as jax_beam_forward
from multiverse_tpu.models import Batch as JBatch
from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.train import trainer as jtrainer
from multiverse_torch import inference as tinf
from multiverse_torch import parallel
from multiverse_torch.bridge import params_from_jax, params_to_numpy_tree
from multiverse_torch.config import MultiverseConfig
from multiverse_torch.data.dataset import batch_to_device, synthesize_prepro
from multiverse_torch.models import Batch
from multiverse_torch.serving.engine import ServingEngine
from multiverse_torch.train import trainer
from multiverse_torch.train.checkpoints import read_checkpoint_tree
from synthetic import make_batch, tiny_config

LAUNCH_TIMEOUT_S = 120.0
CPU2 = ["cpu", "cpu"]


def port_cfg(jcfg) -> MultiverseConfig:
    return MultiverseConfig(**dataclasses.asdict(jcfg)).validate()


def host_batch(jbatch) -> Batch:
    """The port's Batch type over numpy arrays (a rank must not unpickle
    the JAX package's)."""
    return Batch(*(None if f is None else
                   tuple(np.asarray(a) for a in f) if isinstance(f, tuple)
                   else np.asarray(f) for f in jbatch))


def numpy_params(jparams):
    return jax.tree_util.tree_map(np.asarray, jparams)


def flat_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def run2(fn, *args):
    return parallel.launch(fn, parallel.make_mesh(devices=CPU2), *args,
                           timeout=LAUNCH_TIMEOUT_S)


# ------------------------------------------------------------------ mesh


def test_mesh_shapes_and_errors():
    """JAX's test_mesh_shapes: {"data": 8, "model": 1}, then {"data": 4,
    "model": 2} with the model index varying fastest, and 7 devices at
    model_parallel 2 raising."""
    mesh = parallel.make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"data": 8, "model": 1}
    assert mesh.backend == "gloo" and mesh.world == 8 and mesh.is_main
    mesh = parallel.make_mesh(devices=["cpu"] * 8, model_parallel=2)
    assert mesh.shape == {"data": 4, "model": 2}
    jmesh = jpar.make_mesh(n_devices=8, model_parallel=2)
    assert mesh.shape == dict(jmesh.shape)
    order = [[d.id for d in row] for row in jmesh.devices]
    for rank in range(8):
        r = dataclasses.replace(mesh, rank=rank)
        assert order[r.data_index][r.model_index] == rank
    # JAX's errors: too few devices, a world model_parallel does not divide
    with pytest.raises(ValueError, match="expected 2 devices, found 1"):
        parallel.make_mesh(n_devices=2, device_type="cpu")
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        parallel.make_mesh(devices=["cpu"] * 7, model_parallel=2)
    # fewer devices than model_parallel (JAX's make_mesh_for_batch raises
    # ValueError there too)
    with pytest.raises(ValueError, match="needs 2 devices, found 1"):
        parallel.make_mesh_for_batch(20, model_parallel=2,
                                     devices=["cuda:0"])
    got = parallel.make_mesh_for_batch(6, model_parallel=2,
                                       devices=["cpu"] * 8)
    assert got.shape == {"data": 3, "model": 2}
    # the backend follows the devices: NCCL cannot put two ranks on one
    assert parallel.make_mesh(devices=["cuda:0", "cuda:0"]).backend == "gloo"
    assert parallel.make_mesh(devices=["cuda:0", "cuda:1"]).backend == "nccl"


@pytest.mark.parametrize("batch_size", [1, 2, 3, 5, 6, 7, 12, 20, 64])
def test_mesh_for_batch_takes_the_largest_divisor_as_jax(batch_size):
    want = jpar.make_mesh_for_batch(batch_size).shape["data"]
    got = parallel.make_mesh_for_batch(batch_size, devices=["cpu"] * 8)
    assert got.world == want


def test_shard_batch_blocks_and_keeps_the_scene_table():
    cfg = tiny_config()
    batch = host_batch(make_batch(np.random.RandomState(0), cfg, 4)[0])
    mesh = parallel.make_mesh(devices=CPU2)
    for rank in range(2):
        shard = parallel.shard_batch(dataclasses.replace(mesh, rank=rank),
                                     batch)
        np.testing.assert_array_equal(
            shard.obs_grid_class.numpy(),
            batch.obs_grid_class[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(
            shard.pred_grid_target_all[0].numpy(),
            batch.pred_grid_target_all[0][2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(shard.scene_feat.numpy(),
                                      batch.scene_feat)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.shard_batch(parallel.make_mesh(devices=["cpu"] * 3), batch)


def test_launch_fails_with_the_failing_rank_and_stops_the_rest():
    """No fallback: a rank's exception fails the launch, naming the rank
    and its error, while the other rank waits in a collective; a rank
    that never returns fails it at the time limit, and its process is
    gone afterwards."""
    mesh = parallel.make_mesh(devices=CPU2)
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*planted"):
        parallel.launch(ranks.fail_on_rank_1, mesh,
                        timeout=LAUNCH_TIMEOUT_S)


def test_launch_time_limit_stops_a_hung_rank(tmp_path):
    mesh = parallel.make_mesh(devices=CPU2)
    pid_file = str(tmp_path / "rank1.pid")
    with pytest.raises(TimeoutError, match="did not finish within"):
        parallel.launch(ranks.hang_on_rank_1, mesh, pid_file, timeout=20)
    pid = int(open(pid_file).read())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


# ------------------------------------------------------------- training


@pytest.mark.parametrize("masked", [False, True])
def test_dp_train_step_matches_jax_and_single_device(masked):
    """Two ranks' step equals JAX's 2-device sharded step and the port's
    single-device step (held to JAX's by test_torch_train_optim.py).
    Soft labels make the per-example mask counts differ: the first
    example's future sits in a corner cell, where its 3x3 label map
    keeps 4 cells, not 9. So a normaliser that is a mean of per-rank
    means would miss the single-device loss in the masked case."""
    jcfg = tiny_config(mask_grid_regression=masked,
                       use_soft_grid_class=masked, soft_grid=1,
                       use_gnn=True, use_scene_enc=True)
    n = jcfg.batch_size
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tree = numpy_params(jparams)      # before the steps donate jparams
    jbatch = make_batch(np.random.RandomState(3), jcfg, n)[0]
    jbatch.pred_grid_class[0] = 0           # rank 0's shard only
    tx = jtrainer.build_optimizer(jcfg, train_num_examples=n * 4)

    cfg = port_cfg(jcfg)
    model = params_from_jax(tree).requires_grad_(True)
    ptx = trainer.build_optimizer(cfg, n * 4)
    losses0 = trainer.make_train_step(cfg, ptx)(
        model, ptx.init(dict(model.named_parameters())),
        batch_to_device(host_batch(jbatch), "cpu"))
    single0 = params_to_numpy_tree(model)
    jmesh = jpar.make_mesh(n_devices=2)
    jstate = jpar.init_sharded_train_state(jparams, tx, jmesh)
    with jmesh:
        jnew, jlosses = jpar.make_sharded_train_step(jcfg, tx, jmesh)(
            jstate, jpar.shard_batch(jmesh, jbatch))

    out = run2(ranks.train_steps, cfg, tree, [host_batch(jbatch)], n * 4)
    (losses, tree, calls), (losses1, tree1, _) = out
    # the weights' broadcast, then the step's all-reduces: gradients,
    # loss parts, and the mask count if masked
    assert calls == 3 + int(masked)
    assert losses == losses1
    for a, b in zip(flat_leaves(tree), flat_leaves(tree1)):
        np.testing.assert_array_equal(a, b)     # replicated exactly
    for ref_total, ref_params in (
            (float(jlosses["total"]), jnew.params),
            (float(losses0["total"]), single0)):
        np.testing.assert_allclose(losses[0]["total"], ref_total,
                                   rtol=2e-4)
        want = flat_leaves(jax.device_get(ref_params))
        got = flat_leaves(tree)
        assert len(want) == len(got)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[0][k], float(v), rtol=2e-4,
                                   atol=1e-7, err_msg=k)


def test_dp_dropout_masks_differ_across_ranks():
    """keep_prob 0.7: on a batch whose two halves are the same examples,
    the ranks' local losses agree without dropout and differ with it
    (each rank draws its own masks, JAX's fold_in of the axis index);
    the averaged step runs and is finite."""
    jcfg = tiny_config(keep_prob=0.7)
    half = make_batch(np.random.RandomState(5), jcfg, 2)[0]
    both = host_batch(jax.tree_util.tree_map(
        lambda a: np.concatenate([a, a]), half))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    # the scene table is shared, not per example: keep it once
    both = both._replace(scene_feat=np.asarray(half.scene_feat))
    (d0, p0, t0), (d1, p1, t1) = run2(
        ranks.dropout_losses, port_cfg(jcfg), numpy_params(jparams), both,
        11)
    assert p0 == p1
    assert d0 != d1 and d0 != p0 and d1 != p1
    assert t0 == t1 and np.isfinite(t0)


def test_train_cli_rank_worker_at_world_2(tmp_path):
    """mvt-torch-train's rank worker at world 2: rank 0 alone writes the
    run directory (every other rank's writes there raise), and its
    checkpoints equal a one-process run's within the step tolerance."""
    from multiverse_torch.cli import train as ttrain

    cfg = port_cfg(tiny_config(use_grids=(True, False)))
    prepro = synthesize_prepro(str(tmp_path / "prepro"), cfg, n_train=8,
                               n_val=4, seed=2)
    outbase = str(tmp_path / "models")
    flags = [prepro, outbase, "toy", "--batch_size", "4", "--num_epochs",
             "2", "--save_period", "2", "--init_lr", "0.3",
             "--use_soft_grid_class", "--mask_grid_regression",
             "--device", "cpu",
             "--obs_len", "4", "--pred_len", "5", "--scene_h", "12",
             "--scene_w", "16", "--scene_class", "5", "--emb_size", "8",
             "--enc_hidden_size", "16", "--dec_hidden_size", "16",
             "--scene_conv_dim", "8", "--use_gnn", "--use_scene_enc"]
    one = ttrain.main(flags + ["--runId", "1"])
    two = run2(ranks.train_cli, flags + ["--runId", "2"], outbase)
    # one device runs with no group: no collective at all
    assert one["world"] == 1 and one["steps"] == 4
    assert one["collectives"] == 0
    assert [r["world"] for r in two] == [2, 2]
    assert two[0]["best"] == two[1]["best"]
    # the weights' broadcast; per step the gradient bucket, the loss
    # parts and the mask count; per eval batch (2 evals of 1 batch) the
    # class logits and the regression gathered
    assert two[0]["collectives"] == two[1]["collectives"] == 1 + 4 * 3 + 2 * 2
    run1, run2_ = (os.path.join(outbase, "toy", r) for r in ("01", "02"))
    assert sorted(os.listdir(os.path.join(run1, "save"))) \
        == sorted(os.listdir(os.path.join(run2_, "save")))
    for name in ("config.json", "val_perf.json"):
        assert os.path.isfile(os.path.join(run2_, name))
    for step in sorted(os.listdir(os.path.join(run1, "save"))):
        a = params_from_jax(read_checkpoint_tree(
            os.path.join(run2_, "save", step)))
        b = params_from_jax(read_checkpoint_tree(
            os.path.join(run1, "save", step)))
        for (na, ta), (nb, tb) in zip(sorted(a.named_parameters()),
                                      sorted(b.named_parameters())):
            assert na == nb
            np.testing.assert_allclose(ta.numpy(), tb.numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=f"{step} {na}")


# ------------------------------------------------------------- inference


def test_sharded_eval_and_beam_steps_match_single_process_and_jax():
    """f32, two ranks: the gathered eval outputs and beam decode equal
    the single-process ones (beam ids exactly), and the beam ids equal
    JAX's make_sharded_beam_step on a 2-device mesh."""
    jcfg = tiny_config(use_beam_search=True, beam_size=4, diverse_beam=True,
                       diverse_gamma=0.01, fix_num_timestep=1, use_gnn=True,
                       use_scene_enc=True)
    cfg = port_cfg(jcfg)
    inputs = tinf.synthesize_multifuture_inputs(cfg, 4, seed=1,
                                                max_pred_len=cfg.pred_len)
    batch = tinf.make_batch(inputs, np.arange(4), cfg)
    batch = batch._replace(pred_length=np.full(4, cfg.pred_len, np.int32))
    jparams = jax_init_params(jax.random.PRNGKey(2), jcfg)

    (cl, rg, beam, reg), _ = run2(ranks.infer, cfg, numpy_params(jparams),
                                  batch)
    model = params_from_jax(numpy_params(jparams))
    tb = batch_to_device(batch, "cpu")
    cl1, rg1 = trainer.make_eval_step(cfg)(model, tb)
    with torch.inference_mode():
        beam1, reg1 = tinf.beam_forward(model, tb, cfg)
    for i in cfg.active_scales:
        np.testing.assert_allclose(cl[i], cl1[i].numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(rg[i], rg1[i].numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(beam.ids, beam1.ids.numpy())
    np.testing.assert_allclose(beam.logprobs, beam1.logprobs.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(reg, reg1.numpy(), rtol=1e-5, atol=1e-5)

    jmesh = jpar.make_mesh(n_devices=2)
    jb = JBatch(*batch)
    with jmesh:
        jbeam, _ = jpar.make_sharded_beam_step(jcfg, jmesh)(
            jparams, jpar.shard_batch(jmesh, jb))
    np.testing.assert_array_equal(beam.ids, np.asarray(jbeam.ids))
    # and the JAX sharded step agrees with its single-device decode
    jb1, _ = jax_beam_forward(jparams, jax.tree_util.tree_map(
        jnp.asarray, jb), jcfg)
    np.testing.assert_array_equal(np.asarray(jbeam.ids),
                                  np.asarray(jb1.ids))


def test_serving_engine_over_a_2_rank_mesh_answers_as_one_device():
    """The int8a serving tier (K3's plain version on the CPU) over two
    ranks: the same answers as the one-device engine, before and after
    one update_params, with and without scene maps in a batch."""
    cfg = port_cfg(tiny_config(
        use_beam_search=True, beam_size=3, diverse_beam=True,
        diverse_gamma=0.01, fix_num_timestep=1, use_gnn=True,
        use_scene_enc=True, compute_dtype="bfloat16", decode_quant="int8a"))
    tree = numpy_params(jax_init_params(jax.random.PRNGKey(0), cfg))
    new_tree = numpy_params(jax_init_params(jax.random.PRNGKey(1), cfg))
    rng = np.random.RandomState(7)
    requests = []
    for a in range(6):
        obs = np.stack([rng.uniform(0, cfg.video_w, cfg.obs_len),
                        rng.uniform(0, cfg.video_h, cfg.obs_len)],
                       axis=1).astype(np.float32)
        scene = (rng.randint(0, cfg.scene_class, (cfg.scene_h, cfg.scene_w))
                 if a % 3 == 1 else None)
        requests.append((obs, scene, int(rng.randint(1, cfg.pred_len + 1))))

    before, after, stats = run2(ranks.serve, cfg, tree, new_tree, requests,
                                4)[0]
    # both before and after the update, a batch filled rows of rank 1's
    # block (rows 2 and 3), which only live requests' answers read
    for st in stats:
        assert st["errors"] == 0 and st["requests"] == len(requests)
        assert st["largest_batch"] > 2

    def one_device(weights):
        eng = ServingEngine(params_from_jax(weights), cfg, max_batch=4,
                            max_delay_ms=20.0, T_pred=cfg.pred_len,
                            device="cpu")
        try:
            out = []
            for obs, scene, pl in requests:
                res = eng.predict(obs, scene, pl, timeout=60)
                out.append((res.trajs, res.logprobs))
            return out
        finally:
            eng.close()

    for got_all, want_all in ((before, one_device(tree)),
                              (after, one_device(new_tree))):
        for (trajs, lp), (trajs1, lp1) in zip(got_all, want_all):
            np.testing.assert_allclose(trajs, trajs1, atol=1e-3)
            np.testing.assert_allclose(lp, lp1, atol=1e-3)
    # the update reached the worker rank too: the answers moved
    assert any(np.abs(a[1] - b[1]).max() > 1e-3
               for a, b in zip(before, after))
