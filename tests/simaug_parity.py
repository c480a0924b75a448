"""Shared pieces of the SimAug parity tests (``test_torch_simaug*.py``):
the configuration, weights and batch of ``tests/test_simaug.py``'s dims,
the JAX functions' draws rebuilt with ``jax.random`` from the key splits
those functions make, and the sign rule for stepped features."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.models import simaug as J
from multiverse_torch.bridge import params_from_jax
from multiverse_torch.models import simaug as T
from test_simaug import make_mv_batch, tiny_cfg

# The attack steps by sign(gradient). Where a gradient entry lies near
# 0, f32 sum order (XLA's against PyTorch's) may flip its sign, which
# moves that element by one or two steps. So every stepped element must
# lie within 1e-6 of the JAX one, except at most this share of them,
# each within two steps (2 x step size x its mixing weight); the
# gradient itself is held to rtol 1e-4 / atol 1e-6 in
# test_torch_simaug.py. No element has flipped at these dims; the share
# leaves room for another BLAS's sum order.
SIGN_FLIP_SHARE = 1e-3


def port_cfg(jcfg) -> T.SimAugConfig:
    return T.SimAugConfig(**{f: getattr(jcfg, f)
                             for f in jcfg.__dataclass_fields__}).validate()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def make_setup():
    jcfg = tiny_cfg()
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    batch = make_mv_batch(jcfg, 4, jcfg.multiview_max_num,
                          np.random.RandomState(0))
    return jcfg, params, model, batch


def torch_batch(batch) -> T.MultiviewBatch:
    tb = T.MultiviewBatch(*(t(a) for a in batch))
    # the port's data path ships the one-hot scene table as uint8
    return tb._replace(scene_feat=tb.scene_feat.to(torch.uint8))


def scene_input(batch, cfg) -> np.ndarray:
    N = batch.obs_grid_class.shape[0]
    return batch.scene_feat[batch.obs_scene.reshape(-1)].reshape(
        (N, cfg.obs_len) + batch.scene_feat.shape[1:]).astype(np.float32)


def active(cfg):
    i = cfg.active_scales[0]
    return i, cfg.scene_grids[i]


def attack_draws_of(jcfg, key, scene_shape, labels_shape) -> T.Draws:
    """The draws of the JAX white_box_attack(key): its split(key, 5)."""
    _, (h, w) = active(jcfg)
    k_t, k_s, k_m, k_s2, _ = jax.random.split(key, 5)
    zeros = jnp.zeros(scene_shape, jnp.float32)
    return T.Draws(
        offset=t(jax.random.randint(k_t, labels_shape, 1, h * w)).long(),
        # _start_adv(k, 0) is the noise itself: 0 + noise
        noise=t(J._start_adv(k_s, zeros, jcfg)),
        noise2=t(J._start_adv(k_s2, zeros, jcfg)),
        beta=float(jax.random.beta(k_m, jcfg.mixup_alpha, jcfg.mixup_alpha)))


def multiview_draws_of(jcfg, key, scene_shape, M) -> T.Draws:
    """The draws of the JAX multiview_augmentation(key)."""
    N = scene_shape[0]
    k_a, k_a2, k_sel, k_m, _ = jax.random.split(key, 5)
    zeros = jnp.zeros((N * M,) + tuple(scene_shape[1:]), jnp.float32)
    return T.Draws(
        noise=t(J._start_adv(k_a, zeros, jcfg)),
        noise2=t(J._start_adv(k_a2, zeros, jcfg)),
        view=t(jax.random.randint(k_sel, (N,), 0, M)).long(),
        view_offset=t(jax.random.randint(k_a2, (N,), 1, M)).long(),
        beta=float(jax.random.beta(k_m, jcfg.mixup_alpha, jcfg.mixup_alpha)))


def assert_stepped_close(got, want, step: float, what: str):
    """The sign rule of SIGN_FLIP_SHARE."""
    got = np.asarray(got)
    want = np.asarray(want)
    d = np.abs(got - want)
    off = d > 1e-6
    assert off.mean() <= SIGN_FLIP_SHARE, \
        f"{what}: {off.mean():.3g} of elements differ"
    assert (d <= 2 * step + 1e-6).all(), f"{what}: max diff {d.max():.3g}"
