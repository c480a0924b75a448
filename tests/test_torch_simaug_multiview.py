"""The port's SimAug multiview augmentation against the JAX package on
the CPU, in f32 at ``tests/test_simaug.py``'s dims, on weights bridged
from the JAX ``init_params`` tree and the JAX function's own draws
(rebuilt with ``jax.random`` from its key splits): for ``multiview_exp``
1-4 (and exp 3 with a random pick, the larger weight first, the ranking
loss after the attack, gamma 2 and norm_input) the Beta weight and the
selected views equal, the focal weight within 1e-5, the mixed features
under the sign rule of ``simaug_parity.SIGN_FLIP_SHARE``; and the stable
ranking of tied views.
"""

import jax
import numpy as np
import pytest

from multiverse_tpu.models import simaug as J
from multiverse_torch.models import simaug as T
from simaug_parity import (
    assert_stepped_close,
    make_setup,
    multiview_draws_of,
    port_cfg,
    scene_input,
    t,
    torch_batch,
)


@pytest.fixture(scope="module")
def setup():
    return make_setup()


MULTIVIEW = {
    "exp1": dict(multiview_exp=1),
    "exp2": dict(multiview_exp=2),
    "exp3": dict(multiview_exp=3),
    "exp3_random_maxw_advloss": dict(
        multiview_exp=3, multiview_random=True,
        multiview_max_weight_for_first=True,
        multiview_use_adv_for_loss=True, fl_gamma=2.0, norm_input=True),
    "exp4": dict(multiview_exp=4),
}


@pytest.mark.parametrize("name", sorted(MULTIVIEW))
def test_multiview_augmentation_matches_jax(setup, name):
    jcfg, params, model, batch = setup
    jcfg = jcfg.replace(multiview_train=True, **MULTIVIEW[name])
    M = jcfg.multiview_max_num
    scene = scene_input(batch, jcfg)
    if jcfg.norm_input:
        scene = scene * 2.0 - 1.0
    key = jax.random.PRNGKey(2)
    j_adv, j_mix = jax.jit(
        lambda p, k: J.multiview_augmentation(p, k, batch, scene, jcfg))(
        params, key)
    draws = multiview_draws_of(jcfg, key, scene.shape, M)
    adv, mix = T._multiview_augmentation(model, draws, torch_batch(batch),
                                         t(scene), port_cfg(jcfg))
    assert not adv.requires_grad
    assert float(mix.beta_weight) == float(j_mix.beta_weight)
    np.testing.assert_array_equal(mix.selected_idx.numpy(),
                                  np.asarray(j_mix.selected_idx))
    np.testing.assert_allclose(mix.focal_weight.numpy(),
                               np.asarray(j_mix.focal_weight), rtol=1e-5,
                               atol=1e-6)
    # exp 3 mixes one adversarial feature (weight w) with a clean one;
    # exp 1, 2 and 4 mix two adversarial ones (w + (1 - w) = 1)
    step = jcfg.adv_epsilon * (float(mix.beta_weight)
                               if jcfg.multiview_exp == 3 else 1.0)
    assert_stepped_close(adv.numpy(), j_adv, step, name)


def test_multiview_ranking_ties_keep_view_order(setup):
    """Padded views repeat the example itself; started from the clean
    input (adv_start_from_clean_prob 1) their losses tie exactly. The
    stable descending order keeps tied views in view order, as
    jnp.argsort does, so the first of them is selected."""
    jcfg, _, model, batch = setup
    cfg = port_cfg(jcfg.replace(multiview_train=True, multiview_exp=3,
                                adv_start_from_clean_prob=1.0))
    tb = torch_batch(batch)
    tb = tb._replace(pred_grid_class_extra=tb.pred_grid_class_extra[
        :, :1].expand_as(tb.pred_grid_class_extra).contiguous())
    _, mix = T.multiview_augmentation(model, 0, tb,
                                      T.scene_input_of(tb, cfg), cfg)
    assert mix.selected_idx.tolist() == [0, 0, 0, 0]
