"""The port's tensor parallelism (``multiverse_torch.parallel.tensor``)
on the CPU, in gloo ranks spawned by ``parallel.launch``, against the
JAX package's ``model_parallel`` mesh on the 8 virtual CPU devices of
``tests/conftest.py``:

* the shard rule: ``param_pspecs`` and every block's shape equal JAX's
  leaf by leaf, at the tiny and the published widths, and the blocks
  put back in place are the whole tree at tolerance 0 (no ranks);
* the column-, row-parallel and ConvLSTM boundaries against the
  unsharded layer: forward, input and weight gradients (two ranks);
* the train step at dp 1 x mp 2 (two ranks) and dp 2 x mp 2 (four)
  against JAX's ``make_sharded_train_step`` on ``make_mesh(n_devices=4,
  model_parallel=2)``, masked with soft labels and unmasked: total
  within rtol 2e-4, whole updated parameters within rtol 1e-3 / atol
  1e-5 (the tolerances of ``tests/test_parallel.py``); two steps with
  ``remat`` on, the second fed the first's state;
* dropout at keep_prob 0.7: the model ranks draw the same masks, so the
  loss equals the single process's with the same seed;
* a checkpoint saved from the gathered weights of an mp = 2 step is the
  whole tree and loads at mp = 1.

One launch of two ranks runs every two-rank case (``ranks.tp_suite``);
the ranks import no jax and get numpy arrays.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_parallel_ranks as ranks
from multiverse_tpu import parallel as jpar
from multiverse_tpu.config import MultiverseConfig
from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.train import trainer as jtrainer
from multiverse_torch import parallel
from multiverse_torch.bridge import params_from_jax, params_to_numpy_tree
from multiverse_torch.data.dataset import batch_to_device
from multiverse_torch.models import Multiverse, compute_loss, model_forward
from multiverse_torch.ops import ConvLSTMState, conv2d, convlstm_step
from multiverse_torch.parallel.tensor import leaf_shard
from multiverse_torch.train.checkpoints import load_checkpoint
from synthetic import make_batch, tiny_config
from test_torch_parallel import (
    flat_leaves,
    host_batch,
    numpy_params,
    port_cfg,
)

LAUNCH_TIMEOUT_S = 150.0
MP = 2
DROPOUT_SEED = 11


def tp_cfg(**kw):
    return tiny_config(use_gnn=True, use_scene_enc=True, **kw)


def masked_cfg(**kw):
    return tp_cfg(mask_grid_regression=True, use_soft_grid_class=True,
                  soft_grid=1, **kw)


def tp_batch(jcfg, seed=3):
    """A batch whose first example's future sits in a corner cell: its
    soft label map keeps 4 cells, not 9, so the per-example mask counts
    differ (a mean of per-rank normalisers would show)."""
    batch = make_batch(np.random.RandomState(seed), jcfg,
                       jcfg.batch_size)[0]
    batch.pred_grid_class[0] = 0
    return batch


def jax_tp_steps(jcfg, jparams, jbatches, n_examples):
    """JAX's sharded train step on a data 2 x model 2 mesh, from
    ``jparams``, one step a batch. Returns (losses, whole params as
    numpy)."""
    tx = jtrainer.build_optimizer(jcfg, train_num_examples=n_examples)
    mesh = jpar.make_mesh(n_devices=4, model_parallel=MP)
    state = jpar.init_sharded_train_state(jparams, tx, mesh)
    step = jpar.make_sharded_train_step(jcfg, tx, mesh)
    losses = []
    with mesh:
        for b in jbatches:
            state, parts = step(state, jpar.shard_batch(mesh, b))
            losses.append({k: float(v) for k, v in parts.items()})
    return losses, numpy_params(jax.device_get(state.params))


# ------------------------------------------------------------ the cases


def boundary_arrays(seed=0):
    rng = np.random.RandomState(seed)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    return {
        "column": {"x": r(2, 6, 8, 6), "w": r(3, 3, 6, 4), "b": r(4),
                   "cot": r(2, 6, 8, 4)},
        # h2g_class's layout: one output channel, the input axis split;
        # its bias stays whole and is added after the sum
        "row": {"x": r(2, 6, 8, 6), "w": r(3, 3, 6, 1), "b": r(1),
                "cot": r(2, 6, 8, 1)},
        "lstm": {"x": r(2, 6, 8, 3), "h": r(2, 6, 8, 4), "c": r(2, 6, 8, 4),
                 "kernel": r(3, 3, 7, 16) * 0.3, "bias": r(16),
                 "cot": r(2, 6, 8, 4), "cot_c": r(2, 6, 8, 4)},
    }


STEP_CASES = {
    # name: (config, steps)
    "unmasked": (lambda: tp_cfg(), 1),
    "masked": (lambda: masked_cfg(), 1),
    # a second step fed the first's state (weights and optimizer slots),
    # each ConvLSTM step checkpointed: its collectives run again in the
    # backward
    "remat_two_steps": (lambda: masked_cfg(remat=True), 2),
}


@pytest.fixture(scope="module")
def cases():
    """The inputs of every step case: (JAX config, JAX params, numpy
    weights, host batches)."""
    out = {}
    for name, (make_cfg, n_steps) in STEP_CASES.items():
        jcfg = make_cfg()
        jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
        jbatches = [tp_batch(jcfg, seed=3 + i) for i in range(n_steps)]
        out[name] = (jcfg, jparams, numpy_params(jparams), jbatches)
    return out


@pytest.fixture(scope="module")
def two_ranks(cases, tmp_path_factory):
    """Every two-rank case in one launch of dp 1 x mp 2."""
    save_dir = str(tmp_path_factory.mktemp("tp_ckpt"))
    steps = {name: (port_cfg(jcfg), tree, [host_batch(b) for b in jb],
                    jcfg.batch_size * 4)
             for name, (jcfg, _, tree, jb) in cases.items()}
    dcfg = port_cfg(tp_cfg(keep_prob=0.7))
    dtree = numpy_params(jax_init_params(jax.random.PRNGKey(1), dcfg))
    dbatch = host_batch(tp_batch(dcfg))
    mesh = parallel.make_mesh(devices=["cpu"] * MP, model_parallel=MP)
    out = parallel.launch(
        ranks.tp_suite, mesh, boundary_arrays(), steps,
        (dcfg, dtree, dbatch, DROPOUT_SEED), save_dir,
        timeout=LAUNCH_TIMEOUT_S)
    return out, save_dir, (dcfg, dtree, dbatch)


# ------------------------------------------------------------ shard rule


@pytest.mark.parametrize("published", [False, True])
@pytest.mark.parametrize("mp", [2, 4])
def test_shard_rule_and_block_shapes_match_jax(published, mp):
    """Leaf by leaf: the port's ``param_pspecs`` is JAX's, each block has
    JAX's shard shape on that mesh, and the mp blocks of every leaf put
    back in place are the whole leaf exactly."""
    kw = {} if published else dict(
        scene_h=12, scene_w=16, enc_hidden_size=32, dec_hidden_size=32,
        scene_conv_dim=16, emb_size=8, scene_grid_strides=(2, 4))
    jcfg = MultiverseConfig(use_gnn=True, use_scene_enc=True,
                            use_grids=(True, True), **kw).validate()
    shapes = jax.eval_shape(
        lambda: jax_init_params(jax.random.PRNGKey(0), jcfg))
    jmesh = jpar.make_mesh(n_devices=8, model_parallel=mp)
    jspecs = jpar.param_pspecs(shapes, jmesh)
    model = Multiverse.init(port_cfg(jcfg))
    plan = parallel.make_mesh(devices=["cpu"] * 8, model_parallel=mp)
    specs = parallel.param_pspecs(model, plan)

    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(shapes))
    sharded = 0
    for name, p in model.named_parameters():
        js, jshape, ps = jspecs, shapes, specs
        for k in name.split("."):
            js, jshape, ps = js[k], jshape[k], ps[k]
        assert tuple(ps) == tuple(js), name
        whole = p.detach()
        want = NamedSharding(jmesh, js).shard_shape(jshape.shape)
        put_back = torch.zeros_like(whole)
        for m in range(mp):
            shard = leaf_shard(dataclasses.replace(plan, rank=m), name,
                               whole.shape)
            if shard is None:
                assert want == tuple(whole.shape), name
                put_back = whole
                break
            block = shard.block(whole)
            assert tuple(block.shape) == want, name
            shard.place(put_back, block)
        else:
            sharded += 1
        assert torch.equal(put_back, whole), name
    # at these widths every leaf divides, as JAX shards them all
    assert sharded == len(names)


# ------------------------------------------------------------ boundaries


def whole_boundary(kind, a):
    """The unsharded layer's outputs and gradients (cf. ranks.boundary)."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    names = ("kernel", "bias") if kind == "lstm" else ("w", "b")
    params = {n: t[n].clone().requires_grad_(True) for n in names}
    x = t["x"].requires_grad_(True)
    if kind == "lstm":
        c = t["c"].requires_grad_(True)
        h = t["h"].requires_grad_(True)
        out, state = convlstm_step(params, x, ConvLSTMState(c=c, h=h))
        (torch.sum(out * t["cot"]) + torch.sum(state.c * t["cot_c"])) \
            .backward()
        outs = {"h": out, "c": state.c}
        grads = {"x": x.grad, "h": h.grad, "c": c.grad}
    else:
        out = conv2d(params, x, activation=torch.relu)
        torch.sum(out * t["cot"]).backward()
        outs, grads = {"out": out}, {"x": x.grad}
    grads.update({n: params[n].grad for n in names})
    return outs, grads


@pytest.mark.parametrize("kind", ["column", "row", "lstm"])
def test_boundaries_match_the_unsharded_layer(two_ranks, kind):
    """Each rank's forward is the whole layer's (its own c block for the
    ConvLSTM), its input gradients the whole ones (the copy's backward
    sums the ranks' partials; the scatter's gathers), its weight
    gradients the blocks of the whole ones."""
    out, _, _ = two_ranks
    arrays = boundary_arrays()[kind]
    want_out, want_grad = whole_boundary(kind, arrays)
    plan = parallel.make_mesh(devices=["cpu"] * MP, model_parallel=MP)
    for m, rank in enumerate(out):
        outs, grads, calls = rank["boundaries"][kind]
        assert calls >= 2, kind       # a forward and a backward collective
        mesh = dataclasses.replace(plan, rank=m)
        d = arrays["c"].shape[-1] // MP if kind == "lstm" else 0
        own = slice(m * d, (m + 1) * d)
        for k, v in want_out.items():
            ref = v.detach()[..., own] if k == "c" else v.detach()
            np.testing.assert_allclose(outs[k], ref.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{kind} {k}")
        for k, v in want_grad.items():
            if k == "c":
                ref = v[..., own]
            elif k in ("w", "b", "kernel", "bias"):
                shard = leaf_shard(mesh, k, v.shape)
                ref = v if shard is None else shard.block(v)
            else:
                ref = v
            np.testing.assert_allclose(grads[k], ref.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{kind} d{k}")


# ------------------------------------------------------------ train step


def check_step(got, want):
    """Every rank's losses and whole weights against JAX's, the ranks'
    losses equal."""
    want_losses, want_tree = want
    for losses, tree, _ in got:
        assert losses == got[0][0]
        for lo, wl in zip(losses, want_losses):
            np.testing.assert_allclose(lo["total"], wl["total"], rtol=2e-4)
            for k, v in wl.items():
                np.testing.assert_allclose(lo[k], v, rtol=2e-4, atol=1e-7,
                                           err_msg=k)
        w, g = flat_leaves(want_tree), flat_leaves(tree)
        assert len(w) == len(g)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_tp_train_step_matches_jax(two_ranks, cases, case):
    jcfg, jparams, _, jbatches = cases[case]
    want = jax_tp_steps(jcfg, jparams, jbatches, jcfg.batch_size * 4)
    got = [r["steps"][case] for r in two_ranks[0]]
    check_step(got, want)


def test_tp_train_step_on_a_data_2_by_model_2_grid(cases):
    """Four ranks: each data index's pair of model ranks trains on its
    half of the batch; the masked normaliser sums over the data group
    only."""
    jcfg, jparams, tree, jbatches = cases["masked"]
    want = jax_tp_steps(jcfg, jparams, jbatches, jcfg.batch_size * 4)
    mesh = parallel.make_mesh(devices=["cpu"] * 4, model_parallel=MP)
    got = parallel.launch(ranks.train_steps, mesh, port_cfg(jcfg), tree,
                          [host_batch(b) for b in jbatches],
                          jcfg.batch_size * 4, timeout=LAUNCH_TIMEOUT_S)
    check_step(got, want)


def test_tp_dropout_masks_are_the_model_groups(two_ranks):
    """keep_prob 0.7 at dp 1: both model ranks draw the step seed's
    masks, so their forward is the single process's with that seed
    (masks that differed across the ranks would mix two forwards)."""
    out, _, (cfg, tree, batch) = two_ranks
    model = params_from_jax(tree)
    tb = batch_to_device(batch, "cpu")
    with torch.no_grad():
        fwd = model_forward(model, tb, cfg, is_train=True, rng=DROPOUT_SEED)
        want = float(compute_loss(model, tb, fwd, cfg)[0])
        plain = model_forward(model, tb, cfg.replace(keep_prob=1.0),
                              is_train=True)
    for rank in out:
        (logits, reg), loss = rank["dropout"]
        np.testing.assert_allclose(loss, want, rtol=1e-5)
        for i in cfg.active_scales:
            np.testing.assert_allclose(logits[i], fwd.class_logits[i],
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(reg[i], fwd.reg_out[i], rtol=1e-4,
                                       atol=1e-5)
            # and the masks moved the outputs far beyond that tolerance
            moved = fwd.class_logits[i] - plain.class_logits[i]
            assert float(moved.abs().max()) > 1e-2


def test_tp_checkpoint_is_whole_and_loads_at_mp_1(two_ranks):
    """Rank 0 saved the gathered weights of an mp = 2 step: the step holds
    every leaf at its whole shape, equal to what both ranks gathered,
    and loads into the one-process model; each rank held half of them."""
    out, save_dir, _ = two_ranks
    cfg = port_cfg(tp_cfg())
    loaded = load_checkpoint(os.path.join(save_dir, "save"),
                             Multiverse.init(cfg))
    whole = sum(p.numel() * 4 for p in loaded.parameters())
    for rank in out:
        for a, b in zip(flat_leaves(params_to_numpy_tree(loaded)),
                        flat_leaves(rank["saved"])):
            np.testing.assert_array_equal(a, b)
        assert rank["block_bytes"] * MP == whole


def test_serving_engine_refuses_a_model_axis():
    """Serving is data-parallel, as in the JAX package: a mesh with a
    model axis is refused before any rank is waited for."""
    from multiverse_torch.serving.engine import ServingEngine

    cfg = port_cfg(tp_cfg(use_beam_search=True, beam_size=3))
    mesh = parallel.make_mesh(devices=["cpu"] * MP, model_parallel=MP)
    with pytest.raises(ValueError, match="model_parallel must be 1"):
        ServingEngine(Multiverse.init(cfg), cfg, max_batch=4, mesh=mesh)
