"""The training attention (K4 forward, K5 backward) and the train-time
layers of the port against the JAX package on the CPU.

* ``gnn_step_fused`` (the plain versions of K4 and K5 under
  ``GnnDense``) against ``gnn_step_pallas(..., interpret=True)`` and
  ``jax.grad`` through its custom VJP: f32 within the JAX suite's own
  tolerances (forward 1e-5, ``tests/test_ops.py``; gradients 1e-4),
  bf16 within 2e-2; ``GnnDense`` passes ``gradcheck`` in f64;
* ``gnn_step_auto`` on CPU tensors is exactly ``gnn_step_neighbors``;
* input dropout's statistics and streams; ``l2_weight_decay``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.ops import gnn_step_neighbors as jax_gnn_neighbors
from multiverse_tpu.ops.layers import l2_weight_decay as jax_l2
from multiverse_tpu.ops.pallas_gnn import gnn_step_pallas
from multiverse_torch.ops import (
    GnnDense,
    gnn_dense_bwd,
    gnn_dense_fwd,
    gnn_step_auto,
    gnn_step_fused,
    gnn_step_neighbors,
    input_dropout,
    l2_weight_decay,
)

TOLS = {  # dtype: (forward rtol/atol, backward rtol/atol)
    "float32": (1e-5, 1e-4),
    "bfloat16": (2e-2, 2e-2),
}


def _inputs(seed, N=3, H=6, W=8, D=16, C=4):
    rng = np.random.RandomState(seed)
    h = rng.randn(N, H, W, D).astype(np.float32)
    s = rng.randn(N, H, W, C).astype(np.float32)
    cot = rng.randn(N, H, W, D).astype(np.float32)
    return h, s, cot


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("with_scene", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gnn_fused_matches_pallas_interpret(dtype, with_scene):
    h, s, cot = _inputs(1)
    fwd_tol, bwd_tol = TOLS[dtype]
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jh, js = jnp.asarray(h, jdt), jnp.asarray(s, jdt)
    jcot = jnp.asarray(cot)

    def jloss(hh, ss):
        out = gnn_step_pallas(hh, ss if with_scene else None, interpret=True)
        return jnp.sum(out * jcot)

    j_out = gnn_step_pallas(jh, js if with_scene else None, interpret=True)
    jgh, jgs = jax.grad(jloss, argnums=(0, 1))(jh, js)

    th = torch.from_numpy(h).to(tdt).requires_grad_()
    ts = torch.from_numpy(s).to(tdt).requires_grad_()
    before = (gnn_dense_fwd.launches, gnn_dense_bwd.launches)
    t_out = gnn_step_fused(th, ts if with_scene else None)
    assert t_out.dtype == torch.float32
    torch.sum(t_out * torch.from_numpy(cot)).backward()
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (gnn_dense_fwd.launches, gnn_dense_bwd.launches) == before

    np.testing.assert_allclose(t_out.detach().numpy(), _f32(j_out),
                               rtol=fwd_tol, atol=fwd_tol)
    np.testing.assert_allclose(th.grad.float().numpy(), _f32(jgh),
                               rtol=bwd_tol, atol=bwd_tol)
    if with_scene:
        np.testing.assert_allclose(ts.grad.float().numpy(), _f32(jgs),
                                   rtol=bwd_tol, atol=bwd_tol)
    else:
        assert ts.grad is None


def test_gnn_dense_gradcheck_f64():
    """K5's plain version is the derivative of K4's (f64, 4x5 grid,
    edge pixels with 4 and 6 neighbours included)."""
    g = torch.Generator().manual_seed(0)
    H, W = 4, 5
    node = torch.randn(2 * H * W, 6, generator=g, dtype=torch.float64)
    node = node / node.norm(dim=-1, keepdim=True)
    states = torch.randn(2 * H * W, 4, generator=g, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda n, s: GnnDense.apply(n, s, H, W),
        (node.requires_grad_(), states.requires_grad_()))


def test_gnn_dense_zero_node_row():
    """A zero hidden row normalises to zero (norm clamped at 1e-12):
    its edges are all 0, its attention uniform over its neighbours."""
    h, _, _ = _inputs(2, N=1, H=4, W=5, D=8)
    h[0, 0, 0] = 0.0
    out = gnn_step_fused(torch.from_numpy(h))
    ref = np.asarray(jax_gnn_neighbors(jnp.asarray(h)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    nb = h[0, :2, :2].reshape(4, 8)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), nb.mean(0), atol=1e-6)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_gnn_step_auto_on_cpu_is_gnn_step_neighbors(dtype):
    h, s, _ = _inputs(3)
    th, ts = torch.from_numpy(h), torch.from_numpy(s)
    if dtype is not None:
        th = th.to(dtype)
    auto = gnn_step_auto(th, ts, compute_dtype=dtype, allow_pallas=True)
    plain = gnn_step_neighbors(th, ts, compute_dtype=dtype)
    assert torch.equal(auto, plain)


def test_fused_normalise_rounds_differently_from_neighbors_at_bf16():
    """Why the dispatch matters: in bf16 K4 (as ``gnn_step_pallas``)
    normalises the node rows in f32 before one cast, while the 9-
    neighbour form normalises in bf16. The two agree within bf16
    rounding but not exactly, and the fused form is the one that
    matches the JAX kernel."""
    h, s, _ = _inputs(4)
    th = torch.from_numpy(h).to(torch.bfloat16)
    ts = torch.from_numpy(s).to(torch.bfloat16)
    fused = gnn_step_fused(th, ts).numpy()
    plain = gnn_step_neighbors(th, ts, compute_dtype=torch.bfloat16).numpy()
    jax_kernel = _f32(gnn_step_pallas(jnp.asarray(h, jnp.bfloat16),
                                      jnp.asarray(s, jnp.bfloat16),
                                      interpret=True))
    assert np.abs(fused - plain).max() > 0
    np.testing.assert_allclose(fused, plain, rtol=5e-2, atol=5e-2)
    assert np.abs(fused - jax_kernel).max() < np.abs(plain - jax_kernel).max()


def test_input_dropout_statistics_and_streams():
    keep_prob = 0.7
    x = torch.ones(64, 32, 32)
    g = torch.Generator().manual_seed(5)
    a = input_dropout(g, x, keep_prob)
    b = input_dropout(g, x, keep_prob)
    n = x.numel()
    rate = float((a != 0).float().mean())
    sigma = (keep_prob * (1 - keep_prob) / n) ** 0.5
    assert abs(rate - keep_prob) < 3 * sigma
    # inverted scaling: kept entries are 1 / keep_prob
    kept = a[a != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1.0 / keep_prob))
    # each call (one per step) draws a fresh mask
    assert not torch.equal(a != 0, b != 0)
    # the same seed gives the same mask
    c = input_dropout(torch.Generator().manual_seed(5), x, keep_prob)
    assert torch.equal(a, c)


def test_l2_weight_decay_matches_jax():
    rng = np.random.RandomState(6)
    tree = {"scene_conv1": {"w": rng.randn(3, 3, 5, 8), "b": rng.randn(8)},
            "scales": {"0": {"enc_class": {"kernel": rng.randn(3, 3, 4, 8),
                                           "bias": rng.randn(8)},
                             "h2g_class": {"w": rng.randn(3, 3, 2, 1)}}}}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    want = float(jax_l2(tree, 1e-4))
    got = float(l2_weight_decay(
        jax.tree_util.tree_map(torch.from_numpy, tree), 1e-4))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # ConvLSTM kernels and biases are excluded
    only_w = 0.5 * 1e-4 * sum(float(np.sum(tree[k]["w"] ** 2))
                              for k in ("scene_conv1",)) \
        + 0.5 * 1e-4 * float(np.sum(tree["scales"]["0"]["h2g_class"]["w"]
                                    ** 2))
    np.testing.assert_allclose(got, only_w, rtol=1e-5)
