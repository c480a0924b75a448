"""The port's train-mode forward and loss against the JAX package on the
CPU: ``model_forward(is_train=True)`` + ``compute_loss`` and their
gradients against ``jax.value_and_grad`` in f32 on weights bridged from
the JAX ``init_params`` (total loss within 1e-5 relative, every
parameter's gradient within rtol 1e-4 / atol 1e-6), across the
feedback modes and loss options; bf16 losses within 1e-2; the eval-mode
forward; and dropout's per-site streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.models import compute_loss as jax_compute_loss
from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.models import model_forward as jax_model_forward
from multiverse_torch.bridge import params_from_jax
from multiverse_torch.models import Batch, model_forward
from multiverse_torch.models.multiverse import _site_generator
from multiverse_torch.train.trainer import loss_and_grads
from synthetic import make_batch, tiny_config

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def to_torch_batch(batch) -> Batch:
    t = torch.from_numpy
    return Batch(
        obs_grid_class=t(batch.obs_grid_class),
        obs_grid_target_all=tuple(t(a) for a in batch.obs_grid_target_all),
        obs_scene=t(batch.obs_scene),
        scene_feat=t(batch.scene_feat),
        pred_grid_class=t(batch.pred_grid_class),
        pred_grid_target_all=tuple(t(a) for a in batch.pred_grid_target_all))


def setup(cfg, n=3, seed=0):
    batch, _ = make_batch(np.random.RandomState(seed), cfg, n)
    jparams = jax_init_params(jax.random.PRNGKey(1), cfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jparams, jax.tree_util.tree_map(jnp.asarray, batch), \
        model.requires_grad_(True), to_torch_batch(batch)


def jax_loss_and_grads(jparams, jbatch, cfg):
    def loss(params):
        out = jax_model_forward(params, jbatch, cfg, is_train=True)
        return jax_compute_loss(params, jbatch, out, cfg)

    (total, parts), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jparams)
    flat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(total), {k: float(v) for k, v in parts.items()}, flat


CONFIGS = {
    "onehot": {},
    "teacher": {"use_teacher_forcing": True},
    "raw": {"train_w_onehot": False},
    "soft1_masked": {"use_soft_grid_class": True, "soft_grid": 1,
                     "mask_grid_regression": True},
    "soft7": {"use_soft_grid_class": True, "soft_grid": 7},
    "int_labels_masked": {"mask_grid_regression": True},
    "single_decoder": {"use_single_decoder": True},
    "two_scales": {"use_grids": (True, True)},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_f32_loss_and_grads_match_jax(name):
    cfg = tiny_config(**CONFIGS[name])
    jparams, jb, model, tb = setup(cfg)
    j_total, j_parts, j_grads = jax_loss_and_grads(jparams, jb, cfg)
    grads, parts = loss_and_grads(model, tb, cfg)
    np.testing.assert_allclose(float(parts["total"]), j_total,
                               rtol=LOSS_RTOL)
    for k, v in j_parts.items():
        np.testing.assert_allclose(float(parts[k]), v, rtol=LOSS_RTOL,
                                   err_msg=k)
    assert set(grads) == set(j_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), j_grads[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_remat_gradients_equal_plain_and_jax():
    cfg = tiny_config(use_soft_grid_class=True)
    jparams, jb, model, tb = setup(cfg, seed=1)
    plain, _ = loss_and_grads(model, tb, cfg)
    remat, parts = loss_and_grads(model, tb, cfg.replace(remat=True))
    _, _, j_grads = jax_loss_and_grads(jparams, jb, cfg.replace(remat=True))
    for k in plain:
        np.testing.assert_allclose(remat[k].numpy(), plain[k].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=k)
        np.testing.assert_allclose(remat[k].numpy(), j_grads[k],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_bf16_loss_tracks_jax():
    """bf16 on the CPU: both packages take the 9-neighbour GNN off the
    accelerator. bf16 rounds at other places in the two frameworks'
    convolutions, so the losses agree to 1e-2 relative."""
    cfg = tiny_config(compute_dtype="bfloat16", use_soft_grid_class=True)
    jparams, jb, model, tb = setup(cfg, seed=2)
    j_total, j_parts, _ = jax_loss_and_grads(jparams, jb, cfg)
    grads, parts = loss_and_grads(model, tb, cfg)
    np.testing.assert_allclose(float(parts["total"]), j_total, rtol=1e-2)
    for k, v in j_parts.items():
        np.testing.assert_allclose(float(parts[k]), v, rtol=1e-2, err_msg=k)
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_eval_forward_matches_jax():
    cfg = tiny_config()
    jparams, jb, model, tb = setup(cfg, seed=3)
    j_out = jax_model_forward(jparams, jb, cfg, is_train=False)
    with torch.inference_mode():
        t_out = model_forward(model, tb, cfg, is_train=False)
    for i in cfg.active_scales:
        np.testing.assert_allclose(t_out.class_logits[i].numpy(),
                                   np.asarray(j_out.class_logits[i]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t_out.reg_out[i].numpy(),
                                   np.asarray(j_out.reg_out[i]),
                                   rtol=1e-4, atol=1e-4)


def test_dropout_streams():
    """JAX's random streams cannot be matched, so dropout is held by its
    behaviour: the same step seed gives the same loss, another seed
    another one; keep_prob 1 ignores the seed; keep_prob < 1 without a
    seed is refused; the eight (scale, site) streams differ."""
    cfg = tiny_config(keep_prob=0.7, use_grids=(True, True))
    _, _, model, tb = setup(cfg, seed=4)
    _, a = loss_and_grads(model, tb, cfg, rng=5)
    _, b = loss_and_grads(model, tb, cfg, rng=5)
    _, c = loss_and_grads(model, tb, cfg, rng=6)
    assert float(a["total"]) == float(b["total"])
    assert float(a["total"]) != float(c["total"])
    with pytest.raises(ValueError, match="rng"):
        loss_and_grads(model, tb, cfg)
    plain = cfg.replace(keep_prob=1.0)
    _, d = loss_and_grads(model, tb, plain, rng=5)
    _, e = loss_and_grads(model, tb, plain)
    assert float(d["total"]) == float(e["total"])
    masks = [torch.rand(64, generator=_site_generator(5, i, s, "cpu"))
             for i in range(2) for s in range(4)]
    masks.append(torch.rand(64, generator=_site_generator(6, 0, 0, "cpu")))
    for x in range(len(masks)):
        for y in range(x):
            assert not torch.equal(masks[x], masks[y])
