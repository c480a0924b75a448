"""The port's SimAug loss and train step against the JAX package on the
CPU, in f32 at ``tests/test_simaug.py``'s dims, on weights bridged from
the JAX ``init_params`` tree and the JAX function's own draws (rebuilt
with ``jax.random`` from the key splits ``simaug_loss`` makes): in the
four modes (clean, adv, multiview exp 3 with double weighting,
standard_aug) the loss and its parts within 1e-5 relative and every
parameter's gradient within rtol 1e-4 / atol 1e-6 of
``jax.value_and_grad``; one ``make_simaug_train_step`` against the JAX
step's parameters; and the seeded public loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.models import simaug as J
from multiverse_tpu.train.trainer import build_optimizer as jax_optimizer
from multiverse_tpu.train.trainer import init_train_state
from multiverse_torch.bridge import params_from_jax
from multiverse_torch.models import simaug as T
from multiverse_torch.train.trainer import build_optimizer, gradients
from simaug_parity import (
    attack_draws_of,
    make_setup,
    multiview_draws_of,
    port_cfg,
    t,
    torch_batch,
)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6

MODES = {
    "clean": dict(),
    "adv": dict(adv_train=True, adv_use_fgsm=True),
    "multiview": dict(multiview_train=True, multiview_exp=3,
                      double_weighting=True, use_mixup=True),
    "standard": dict(standard_aug=True),
}


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def loss_draws_of(jcfg, key, batch) -> T.Draws:
    """The draws of the JAX simaug_loss(key): its split(key, 3)."""
    k_aug, k_jit, _ = jax.random.split(key, 3)
    N, T_obs = batch.obs_scene.shape
    shape = (N, T_obs) + batch.scene_feat.shape[1:]
    draws = T.Draws()
    if jcfg.adv_train:
        i = jcfg.active_scales[0]
        draws = attack_draws_of(jcfg, k_aug, shape,
                                batch.pred_grid_class[:, i].shape)
    elif jcfg.multiview_train:
        draws = multiview_draws_of(jcfg, k_aug, shape,
                                   batch.pred_grid_class_extra.shape[1])
    return draws._replace(jitter=t(jax.random.uniform(
        k_jit, shape, jnp.float32, -jcfg.adv_epsilon, jcfg.adv_epsilon)))


def flat_grads(grads) -> dict:
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_simaug_loss_and_grads_match_jax(setup, mode):
    jcfg, params, model, batch = setup
    jcfg = jcfg.replace(**MODES[mode])
    key = jax.random.PRNGKey(3)
    (j_total, j_parts), j_grads = jax.jit(jax.value_and_grad(
        lambda p, k: J.simaug_loss(p, batch, jcfg, k), has_aux=True))(
        params, key)
    model = model.requires_grad_(True)
    total, parts = T._simaug_loss(model, torch_batch(batch), port_cfg(jcfg),
                                  loss_draws_of(jcfg, key, batch))
    grads = gradients(model, total)
    for k, v in j_parts.items():
        np.testing.assert_allclose(float(parts[k].detach()), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    j_grads = flat_grads(j_grads)
    assert set(grads) == set(j_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), j_grads[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_simaug_train_step_matches_jax(setup, monkeypatch):
    """One multiview exp 3 step of each package's train step (adadelta,
    clip 10) from the same weights: the port's parameters after the
    step within 1e-6 of the JAX step's."""
    jcfg, params, _, batch = setup
    jcfg = jcfg.replace(multiview_train=True, multiview_exp=3,
                        adv_use_fgsm=True, double_weighting=True)
    cfg = port_cfg(jcfg)
    key = jax.random.PRNGKey(4)
    state, _ = init_train_state(jax.tree_util.tree_map(jnp.array, params),
                                jcfg, 40)
    j_state, j_parts = J.make_simaug_train_step(
        jcfg, jax_optimizer(jcfg, 40))(state, batch, key)

    # a fresh copy of the weights: the step updates them in place
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    model.requires_grad_(True)
    tx = build_optimizer(cfg, 40)
    opt_state = tx.init(dict(model.named_parameters()))
    draws = loss_draws_of(jcfg, key, batch)
    monkeypatch.setattr(T, "step_draws", lambda *args: draws)
    parts = T.make_simaug_train_step(cfg, tx)(model, opt_state,
                                              torch_batch(batch), 0)
    np.testing.assert_allclose(float(parts["total"]),
                               float(j_parts["total"]), rtol=LOSS_RTOL)
    assert opt_state["count"] == int(j_state.step) == 1
    j_new = flat_grads(j_state.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), j_new[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_simaug_loss_draws_from_its_seed(setup):
    """The seeded public loss: one seed one loss, another seed another;
    the step's draws live on the batch's device."""
    jcfg, _, model, batch = setup
    cfg = port_cfg(jcfg.replace(multiview_train=True, use_mixup=True,
                                keep_prob=0.7))
    tb = torch_batch(batch)
    a, _ = T.simaug_loss(model, tb, cfg, 7)
    b, _ = T.simaug_loss(model, tb, cfg, 7)
    c, _ = T.simaug_loss(model, tb, cfg, 8)
    assert float(a.detach()) == float(b.detach()) != float(c.detach())
    draws = T.step_draws(cfg, tb, 7)
    assert draws.noise.shape == (4 * 3,) + tuple(
        T.scene_input_of(tb, cfg).shape[1:])
    assert draws.dropout is not None and draws.attack_dropout is not None
    assert float(draws.noise.abs().max()) <= cfg.adv_epsilon
