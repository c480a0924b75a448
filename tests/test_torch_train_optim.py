"""The port's optimizers, schedules and train step against the JAX
package's optax chains on the CPU: five updates of each optimizer
(clip-by-value first) on identical numpy gradients, some beyond +-10,
with a staircase decay boundary or the cosine schedule's end inside the
five steps, parameters within 1e-6 relative; then three full train
steps of ``make_train_step`` against JAX's at f32, parameters within
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.train import trainer as jax_trainer
from multiverse_torch.bridge import params_from_jax, params_to_numpy_tree
from multiverse_torch.train import trainer
from synthetic import make_batch, tiny_config
from test_torch_train_loss import to_torch_batch


@pytest.mark.parametrize("schedule", ["staircase", "cosine"])
@pytest.mark.parametrize("name", ["adadelta", "momentum", "adam",
                                  "rmsprop"])
def test_optimizer_matches_optax(name, schedule):
    # 8 examples at batch 4: the staircase decays at update 3
    # (1.5 epochs), the cosine schedule ends at update 4 (2 epochs)
    cfg = tiny_config(optimizer=name, init_lr=0.3, emb_lr=0.5,
                      learning_rate_decay=0.5, num_epoch_per_decay=1.5,
                      use_cosine_lr=schedule == "cosine", num_epochs=2,
                      clip_gradient_norm=10.0)
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 8).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    assert max(np.abs(g["a"]).max() for g in grads) > 10

    tx = jax_trainer.build_optimizer(cfg, 8)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = tx.init(j_params)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = trainer.build_optimizer(cfg, 8)
    t_state = opt.init(t_params)
    for g in grads:
        updates, j_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), j_state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params,
                                          updates)
        opt.update(t_params, {k: torch.from_numpy(v) for k, v in g.items()},
                   t_state)
        for k in params:
            np.testing.assert_allclose(t_params[k].numpy(),
                                       np.asarray(j_params[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert t_state["count"] == 5


def test_schedule_values_match_optax():
    for kw in ({}, {"use_cosine_lr": True}, {"learning_rate_decay": None}):
        cfg = tiny_config(init_lr=0.3, emb_lr=0.5, num_epoch_per_decay=1.5,
                          num_epochs=2, **kw)
        j = jax_trainer.build_schedule(cfg, 8)
        t = trainer.build_schedule(cfg, 8)
        for count in range(7):
            np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-6)


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer"):
        trainer.build_optimizer(tiny_config(optimizer="lamb"), 8)


def test_three_train_steps_match_jax():
    cfg = tiny_config(use_soft_grid_class=True, init_lr=0.3)
    rng = np.random.RandomState(1)
    batches = [make_batch(rng, cfg, 3)[0] for _ in range(3)]
    jparams = jax_init_params(jax.random.PRNGKey(2), cfg)
    model = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)).requires_grad_(True)

    j_state, tx = jax_trainer.init_train_state(jparams, cfg, 12)
    j_step = jax_trainer.make_train_step(cfg, tx)
    opt = trainer.build_optimizer(cfg, 12)
    t_state = opt.init(dict(model.named_parameters()))
    t_step = trainer.make_train_step(cfg, opt)
    for b in batches:
        j_state, j_parts = j_step(
            j_state, jax.tree_util.tree_map(jnp.asarray, b))
        t_parts = t_step(model, t_state, to_torch_batch(b))
        np.testing.assert_allclose(float(t_parts["total"]),
                                   float(j_parts["total"]), rtol=1e-5)
    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, j_state.params))
    got = jax.tree_util.tree_leaves(params_to_numpy_tree(model))
    assert len(want) == len(got)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
