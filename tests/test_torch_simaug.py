"""The port's SimAug tower and white-box attack against the JAX package
on the CPU, in f32 at ``tests/test_simaug.py``'s dims, on weights
bridged from the JAX ``init_params`` tree: ``tower_forward`` within
1e-5; the per-example CE and its gradient with respect to the scene
input within rtol 1e-4 / atol 1e-6; ``white_box_attack`` (FGSM, PGD-3,
mixup, mixup of two attacks) on the JAX function's own draws, rebuilt
with ``jax.random`` from its key splits, under the sign rule of
``simaug_parity.SIGN_FLIP_SHARE``; the seeded public attack; and the
clean tower against the port's ``model_forward``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.geometry import one_hot_grid as jax_one_hot_grid
from multiverse_tpu.models import simaug as J
from multiverse_torch.geometry import one_hot_grid
from multiverse_torch.models import Batch, model_forward
from multiverse_torch.models import simaug as T
from simaug_parity import (
    active,
    assert_stepped_close,
    attack_draws_of,
    make_setup,
    port_cfg,
    scene_input,
    t,
    torch_batch,
)


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def test_tower_forward_matches_jax(setup):
    jcfg, params, model, batch = setup
    i, (h, w) = active(jcfg)
    scene = scene_input(batch, jcfg)
    oh = jax_one_hot_grid(batch.obs_grid_class[:, i], h, w)
    j_logits, j_reg = jax.jit(
        lambda p: J.tower_forward(p, scene, oh, batch.obs_grid_target,
                                  jcfg))(params)
    logits, reg = T.tower_forward(
        model, t(scene), one_hot_grid(t(batch.obs_grid_class[:, i]), h, w),
        t(batch.obs_grid_target), port_cfg(jcfg))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(reg.detach().numpy(), np.asarray(j_reg),
                               rtol=1e-5, atol=1e-5)


def test_per_example_ce_and_input_grad_match_jax(setup):
    jcfg, params, model, batch = setup
    i, (h, w) = active(jcfg)
    scene = scene_input(batch, jcfg)
    oh = jax_one_hot_grid(batch.obs_grid_class[:, i], h, w)
    labels = batch.pred_grid_class[:, i]

    def ce_sum(s):
        ce = J._per_example_ce(params, s, oh, batch.obs_grid_target, labels,
                               jcfg)
        return ce.sum(), ce

    j_grad, j_ce = jax.jit(jax.grad(ce_sum, has_aux=True))(jnp.asarray(scene))
    grad, ce = T._input_grad(T._detached(model), t(scene), t(oh), t(labels),
                             port_cfg(jcfg))
    np.testing.assert_allclose(ce.numpy(), np.asarray(j_ce), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=1e-4,
                               atol=1e-6)
    # the model's own parameters are untouched: no gradient, still
    # trainable for the outer step
    assert all(p.grad is None for p in model.parameters())


ATTACKS = {
    "fgsm": dict(adv_use_fgsm=True),
    "pgd3": dict(adv_num_iter=3, adv_step_size=0.02),
    "pgd3_mixup": dict(adv_num_iter=3, adv_step_size=0.02, use_mixup=True),
    "fgsm_mix_adv": dict(adv_use_fgsm=True, use_mixup=True,
                         mixup_mix_adv=True, adv_start_from_clean_prob=0.5,
                         norm_feat=True),
}


@pytest.mark.parametrize("name", sorted(ATTACKS))
def test_white_box_attack_matches_jax(setup, name):
    jcfg, params, model, batch = setup
    jcfg = jcfg.replace(adv_train=True, **ATTACKS[name])
    i, (h, w) = active(jcfg)
    scene = scene_input(batch, jcfg)
    oh = jax_one_hot_grid(batch.obs_grid_class[:, i], h, w)
    labels = batch.pred_grid_class[:, i]
    key = jax.random.PRNGKey(1)
    j_adv, j_target = jax.jit(
        lambda p, k: J.white_box_attack(p, k, scene, labels, oh,
                                        batch.obs_grid_target, jcfg))(
        params, key)
    draws = attack_draws_of(jcfg, key, scene.shape, labels.shape)
    adv, target = T._white_box_attack(model, draws, t(scene), t(labels),
                                      t(oh), port_cfg(jcfg))
    np.testing.assert_array_equal(target.numpy(), np.asarray(j_target))
    assert not adv.requires_grad
    step = jcfg.adv_epsilon if jcfg.adv_use_fgsm else jcfg.adv_step_size
    if jcfg.use_mixup and not jcfg.mixup_mix_adv:
        step *= 1.0 - draws.beta
    assert_stepped_close(adv.numpy(), j_adv, step, name)


def test_white_box_attack_draws_from_its_seed(setup):
    """The public attack: inside the eps-ball around the clean feature
    and [-1, 1], every target another cell than the label, the CE toward
    the targets lowered, one seed one result."""
    jcfg, _, model, batch = setup
    cfg = port_cfg(jcfg.replace(adv_train=True, adv_use_fgsm=True))
    i, (h, w) = active(cfg)
    scene = t(scene_input(batch, cfg))
    oh = one_hot_grid(t(batch.obs_grid_class[:, i]), h, w)
    labels = t(batch.pred_grid_class[:, i])
    adv, target = T.white_box_attack(model, 5, scene, labels, oh, cfg)
    again, _ = T.white_box_attack(model, 5, scene, labels, oh, cfg)
    assert torch.equal(adv, again)
    assert float((adv - scene).abs().max()) <= cfg.adv_epsilon + 1e-6
    assert float(adv.min()) >= -1.0 and float(adv.max()) <= 1.0
    assert (target != labels.long()).all()
    params = T._detached(model)
    with torch.no_grad():
        ce_clean = T._per_example_ce(params, scene, oh, target, cfg)
        ce_adv = T._per_example_ce(params, adv, oh, target, cfg)
    assert float(ce_adv.mean()) < float(ce_clean.mean())


def test_clean_tower_equals_model_forward(setup):
    """With every augmentation off, the SimAug tower is the port's
    eval-mode model_forward on the same weights."""
    jcfg, _, model, batch = setup
    cfg = port_cfg(jcfg)
    i, (h, w) = active(cfg)
    tb = torch_batch(batch)
    with torch.no_grad():
        logits, reg = T.tower_forward(
            model, T.scene_input_of(tb, cfg),
            one_hot_grid(tb.obs_grid_class[:, i], h, w),
            tb.obs_grid_target, cfg)
        out = model_forward(model, Batch(
            obs_grid_class=tb.obs_grid_class,
            obs_grid_target_all=(tb.obs_grid_target,),
            obs_scene=tb.obs_scene, scene_feat=tb.scene_feat,
            pred_grid_class=tb.pred_grid_class,
            pred_grid_target_all=(tb.pred_grid_target,)), cfg,
            is_train=False)
    np.testing.assert_allclose(logits.numpy(), out.class_logits[i].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(reg.numpy(), out.reg_out[i].numpy(),
                               rtol=1e-5, atol=1e-5)
