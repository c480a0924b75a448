"""The port's layer extras (``init_linear``, ``linear``, ``exp_mask``,
``softsel``, ``focal_attention``, ``group_norm``) against the JAX
package's on the CPU, on the inputs of ``tests/test_layer_extras.py``
and on seeded random ones, within rtol 1e-5 / atol 1e-6 (f32); the
properties the JAX tests check hold for the port's functions too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.ops import layers as jl
from multiverse_torch.ops import layers as tl

RTOL, ATOL = 1e-5, 1e-6


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("use_sigmoid", [False, True])
def test_softsel_matches_jax(use_sigmoid):
    target = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    logits = np.asarray([[0.0, 0.0, 100.0]], np.float32)
    got = tl.softsel(torch.from_numpy(target), torch.from_numpy(logits),
                     use_sigmoid)
    close(got, jl.softsel(jnp.asarray(target), jnp.asarray(logits),
                          use_sigmoid))
    if not use_sigmoid:     # the JAX test's property
        np.testing.assert_allclose(got.numpy()[0], target[0, 2], atol=1e-4)
    rng = np.random.RandomState(1)
    t, lg = rng.randn(2, 5, 6, 7).astype(np.float32), \
        rng.randn(2, 5, 6).astype(np.float32)
    close(tl.softsel(torch.from_numpy(t), torch.from_numpy(lg), use_sigmoid),
          jl.softsel(jnp.asarray(t), jnp.asarray(lg), use_sigmoid))


@pytest.mark.parametrize("use_sigmoid", [False, True])
def test_focal_attention_matches_jax(use_sigmoid):
    rng = np.random.RandomState(0)
    d = 8
    query = rng.randn(2, d).astype(np.float32)
    context = rng.randn(2, 3, 5, d).astype(np.float32)
    context[:, 1, 2, :] = query * 10.0      # the JAX test's planted match
    got = tl.focal_attention(torch.from_numpy(query),
                             torch.from_numpy(context), use_sigmoid)
    close(got, jl.focal_attention(jnp.asarray(query), jnp.asarray(context),
                                  use_sigmoid))
    if not use_sigmoid:
        out = got.numpy()
        cos = (out * query).sum(-1) / (np.linalg.norm(out, axis=-1)
                                       * np.linalg.norm(query, axis=-1))
        assert (cos > 0.5).all()


@pytest.mark.parametrize("groups", [4, 32])
def test_group_norm_matches_jax(groups):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 4, 4, 16) * 3 + 5).astype(np.float32)
    scale = rng.rand(16).astype(np.float32) + 0.5
    bias = rng.randn(16).astype(np.float32)
    got = tl.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias), num_groups=groups)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jl.group_norm(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
            num_groups=groups)), rtol=1e-4, atol=1e-5)
    unit = tl.group_norm(torch.from_numpy(x), torch.ones(16),
                         torch.zeros(16), num_groups=groups).numpy()
    assert abs(unit.mean()) < 0.1 and abs(unit.var() - 1.0) < 0.1


def test_linear_and_exp_mask_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 6).astype(np.float32)
    params = {"w": rng.randn(6, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    close(tl.linear(tp, torch.from_numpy(x), torch.tanh),
          jl.linear(jp, jnp.asarray(x), jnp.tanh))
    close(tl.linear({"w": tp["w"]}, torch.from_numpy(x)),
          jl.linear({"w": jp["w"]}, jnp.asarray(x)))
    val = rng.randn(3, 7).astype(np.float32)
    mask = rng.rand(3, 7) > 0.5
    got = tl.exp_mask(torch.from_numpy(val), torch.from_numpy(mask))
    close(got, jl.exp_mask(jnp.asarray(val), jnp.asarray(mask)))
    assert (got.numpy()[~mask] < -1e29).all()


def test_init_linear_has_the_jax_shapes_and_law():
    """Different generators, so the law: 0.1 x a unit normal truncated
    to [-2, 2] (std 0.1 x 0.8796), zero bias."""
    import jax

    jp = jl.init_linear(jax.random.PRNGKey(0), 64, 48, add_bias=True)
    tp = tl.init_linear(torch.Generator().manual_seed(0), 64, 48,
                        add_bias=True)
    assert {k: tuple(v.shape) for k, v in tp.items()} \
        == {k: tuple(v.shape) for k, v in jp.items()}
    assert set(tl.init_linear(torch.Generator(), 3, 2)) == {"w"}
    w = tp["w"].numpy()
    assert np.abs(w).max() <= 0.2 + 1e-7
    np.testing.assert_allclose(w.std(), 0.1 * 0.87962566, rtol=0.05)
    np.testing.assert_allclose(np.asarray(jp["w"]).std(), w.std(),
                               rtol=0.08)
    assert not tp["b"].any()
