"""The PyTorch port's ops against their JAX counterparts, in f32 on the
CPU: the same numpy inputs through both, rtol = atol = 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu import geometry as jgeo
from multiverse_tpu.config import MultiverseConfig
from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.ops import convlstm as jcl
from multiverse_tpu.ops import gnn as jgnn
from multiverse_tpu.ops import layers as jlayers
from multiverse_torch import geometry as tgeo
from multiverse_torch.bridge import (
    check_params,
    load_params_npz,
    params_from_jax,
    save_params_npz,
)
from multiverse_torch.models import Multiverse
from multiverse_torch.ops import convlstm as tcl
from multiverse_torch.ops import gnn as tgnn
from multiverse_torch.ops import layers as tlayers

TOL = dict(rtol=1e-4, atol=1e-4)


def _close(j, t, **tol):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.detach().float().numpy(), **(tol or TOL))


@pytest.mark.parametrize("hw,stride,act", [
    ((12, 16), 1, "tanh"), ((12, 16), 2, "relu"), ((36, 64), 2, "tanh"),
    ((7, 9), 2, "lrelu"), ((7, 9), 1, "identity")])
def test_conv2d_matches_jax(rng, hw, stride, act):
    x = rng.randn(2, *hw, 5).astype(np.float32)
    p = {"w": rng.randn(3, 3, 5, 6).astype(np.float32) * 0.3,
         "b": rng.randn(6).astype(np.float32)}
    j = jlayers.conv2d({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), stride=stride,
                       activation=jlayers.get_activation(act))
    t = tlayers.conv2d({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), stride=stride,
                       activation=tlayers.get_activation(act))
    assert tuple(t.shape) == j.shape
    _close(j, t)


def test_same_padding_is_asymmetric_like_xla():
    # 36x64 -> 18x32 at stride 2: XLA pads (0, 1), not (1, 1)
    assert tlayers.same_padding(36, 3, 2) == (0, 1)
    assert tlayers.same_padding(64, 3, 2) == (0, 1)
    assert tlayers.same_padding(9, 3, 2) == (1, 1)
    assert tlayers.same_padding(18, 3, 1) == (1, 1)


def test_conv2d_bf16_tracks_jax(rng):
    x = rng.randn(2, 12, 16, 4).astype(np.float32)
    p = {"w": rng.randn(3, 3, 4, 8).astype(np.float32) * 0.3,
         "b": rng.randn(8).astype(np.float32)}
    j = jlayers.conv2d({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), stride=2, activation=jnp.tanh,
                       compute_dtype=jnp.bfloat16)
    t = tlayers.conv2d({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), stride=2, activation=torch.tanh,
                       compute_dtype=torch.bfloat16)
    assert t.dtype == torch.float32
    _close(j, t, rtol=2e-2, atol=2e-2)


def _cell(rng, cin, d):
    return {"kernel": rng.randn(3, 3, cin + d, 4 * d).astype(np.float32) * 0.2,
            "bias": rng.randn(4 * d).astype(np.float32) * 0.1}


def test_convlstm_step_matches_jax(rng):
    p = _cell(rng, 3, 8)
    x = rng.randn(2, 6, 8, 3).astype(np.float32)
    c = rng.randn(2, 6, 8, 8).astype(np.float32)
    h = rng.randn(2, 6, 8, 8).astype(np.float32)
    jo, js = jcl.convlstm_step({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), jcl.ConvLSTMState(
                                   c=jnp.asarray(c), h=jnp.asarray(h)))
    to, ts = tcl.convlstm_step({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), tcl.ConvLSTMState(
                                   c=torch.from_numpy(c),
                                   h=torch.from_numpy(h)))
    _close(jo, to)
    _close(js.c, ts.c)
    _close(js.h, ts.h)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_convlstm_scan_matches_jax(rng, with_lengths):
    p = _cell(rng, 3, 8)
    xs = rng.randn(3, 5, 6, 8, 3).astype(np.float32)
    lengths = np.array([5, 2, 4], np.int32) if with_lengths else None
    jo, js = jcl.convlstm_scan(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xs),
        seq_lengths=None if lengths is None else jnp.asarray(lengths))
    to, ts = tcl.convlstm_scan(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(xs),
        seq_lengths=None if lengths is None else torch.from_numpy(lengths))
    _close(jo, to)
    _close(js.c, ts.c)
    _close(js.h, ts.h)


@pytest.mark.parametrize("with_scene", [False, True])
def test_gnn_steps_match_jax(rng, with_scene):
    hid = rng.randn(2, 6, 8, 16).astype(np.float32)
    scene = rng.randn(2, 6, 8, 4).astype(np.float32) if with_scene else None
    js = None if scene is None else jnp.asarray(scene)
    ts = None if scene is None else torch.from_numpy(scene)
    mask = jgnn.gnn_neighbor_mask(6, 8)
    np.testing.assert_array_equal(mask, tgnn.gnn_neighbor_mask(6, 8))
    j_dense = jgnn.gnn_step(jnp.asarray(hid), jnp.asarray(mask), js)
    t_dense = tgnn.gnn_step(torch.from_numpy(hid), torch.from_numpy(mask), ts)
    _close(j_dense, t_dense)
    j_nb = jgnn.gnn_step_neighbors(jnp.asarray(hid), js)
    t_nb = tgnn.gnn_step_neighbors(torch.from_numpy(hid), ts)
    _close(j_nb, t_nb)
    _close(j_dense, t_nb)


def test_geometry_matches_jax(rng):
    xy = rng.uniform([1, 1], [959, 539], size=(7, 2)).astype(np.float32)
    grids = ((6, 8), (3, 4))
    np.testing.assert_array_equal(jgeo.grid_centers(540, 960, 6, 8),
                                  tgeo.grid_centers(540, 960, 6, 8))
    jc, jt = jgeo.rasterize_traj_np(xy, 540, 960, grids)
    tc, tt = tgeo.rasterize_traj_np(xy, 540, 960, grids)
    np.testing.assert_array_equal(jc, tc)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a, b)
    ids = rng.randint(0, 48, (3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jgeo.one_hot_grid(jnp.asarray(ids), 6, 8)),
        tgeo.one_hot_grid(torch.from_numpy(ids), 6, 8).numpy())


def _tiny_cfg(**kw):
    base = dict(scene_h=12, scene_w=16, scene_class=5, emb_size=8,
                enc_hidden_size=16, dec_hidden_size=16, scene_conv_dim=8)
    base.update(kw)
    return MultiverseConfig(**base).validate()


@pytest.mark.parametrize("kw", [{}, {"use_scene_enc": False},
                                {"use_single_decoder": True}])
def test_init_params_tree_matches_jax(kw):
    cfg = _tiny_cfg(**kw)
    jtree = jax.tree_util.tree_map(np.asarray,
                                   jax_init_params(jax.random.PRNGKey(0), cfg))
    bridged = params_from_jax(jtree)
    seeded = Multiverse.init(cfg, seed=0)
    check_params(seeded, bridged)
    # same init family: comparable spreads per tensor
    seeded = dict(seeded.named_parameters())
    for name, a in bridged.named_parameters():
        b = seeded[name]
        if a.std() > 0:
            assert 0.5 < float(b.std() / a.std()) < 2.0, name


def test_bridge_names_and_npz_roundtrip(tmp_path):
    cfg = _tiny_cfg()
    jtree = jax.tree_util.tree_map(np.asarray,
                                   jax_init_params(jax.random.PRNGKey(0), cfg))
    model = params_from_jax(jtree)
    names = {n for n, _ in model.named_parameters()}
    assert "scales.0.dec_class.kernel" in names
    assert "scene_conv1.w" in names
    np.testing.assert_array_equal(
        model["scales"]["0"]["dec_class"]["kernel"].numpy(),
        jtree["scales"]["0"]["dec_class"]["kernel"])
    path = str(tmp_path / "params.npz")
    save_params_npz(model, path)
    assert "scales/0/dec_class/kernel" in np.load(path).files
    back = load_params_npz(path)
    back_params = dict(back.named_parameters())
    assert set(back_params) == names
    for n, a in model.named_parameters():
        torch.testing.assert_close(a, back_params[n], rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not match"):
        check_params(back, Multiverse.init(_tiny_cfg(emb_size=4)))
