"""The fused decode step (multiverse_torch/ops/fused_decode.py) against
the JAX package: the plain version in f32 against the composed JAX step
(rtol = atol = 1e-4), in bf16 against the Pallas kernel in interpret
mode (rtol = atol = 2e-2, the JAX suite's own tolerance for that
kernel); and the wrapper's dispatch. The CUDA kernel itself is tested
on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.ops import ConvLSTMState as JState
from multiverse_tpu.ops import conv2d as jconv2d
from multiverse_tpu.ops import convlstm_step as jconvlstm_step
from multiverse_tpu.ops import gnn_step_neighbors as jgnn_neighbors
from multiverse_tpu.ops.pallas_decode import decode_step_pallas_gathered
from multiverse_torch.ops import decode_step_gathered, decode_step_gathered_ref

H, W, D, E, C, NK = 6, 8, 16, 8, 4, 6
HW = H * W


def _operands(rng, with_scene=True):
    return dict(
        kernel=rng.randn(3, 3, E + D, 4 * D).astype(np.float32) * 0.2,
        bias=rng.randn(4 * D).astype(np.float32) * 0.5,
        w=rng.randn(3, 3, D, 1).astype(np.float32) * 0.3,
        emb=np.tanh(rng.randn(HW, H, W, E)).astype(np.float32),
        h=np.tanh(rng.randn(NK, H, W, D)).astype(np.float32),
        c=rng.randn(NK, H, W, D).astype(np.float32),
        scene=(rng.randn(NK, H, W, C).astype(np.float32)
               if with_scene else None),
        ids=rng.randint(0, HW, NK).astype(np.int32),
        par=rng.permutation(NK).astype(np.int32),
    )


def _torch_step(o, dtype, fn=decode_step_gathered):
    def t(a):
        return torch.from_numpy(a)
    return fn(
        t(o["kernel"]).reshape(9 * (E + D), 4 * D).to(dtype), t(o["bias"]),
        t(o["w"]).reshape(9, D).t().to(dtype), t(o["ids"]), t(o["par"]),
        t(o["emb"]).reshape(HW, HW, E).to(dtype),
        t(o["h"]).reshape(-1, D).to(dtype), t(o["c"]).reshape(-1, D).to(dtype),
        None if o["scene"] is None
        else t(o["scene"]).reshape(-1, C).to(dtype), H, W)


def _assert_close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32).reshape(-1),
                               t.float().numpy().reshape(-1),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("with_scene", [True, False])
def test_plain_step_f32_matches_composed_jax_step(rng, with_scene):
    o = _operands(rng, with_scene)
    par, ids = o["par"], o["ids"]
    # the composed JAX step on explicitly gathered rows
    h_g = jnp.asarray(o["h"][par])
    scene = None if o["scene"] is None else jnp.asarray(o["scene"])
    h2 = h_g + jgnn_neighbors(h_g, scene)
    out, st = jconvlstm_step(
        {"kernel": jnp.asarray(o["kernel"]), "bias": jnp.asarray(o["bias"])},
        jnp.asarray(o["emb"][ids]),
        JState(c=jnp.asarray(o["c"][par]), h=h2))
    logits = jconv2d({"w": jnp.asarray(o["w"])}, out)

    h_t, c_t, logits_t = _torch_step(o, torch.float32,
                                     decode_step_gathered_ref)
    assert h_t.dtype == torch.float32 and logits_t.shape == (NK * HW, 1)
    _assert_close(st.h, h_t, 1e-4)
    _assert_close(st.c, c_t, 1e-4)
    _assert_close(logits, logits_t, 1e-4)


def test_plain_step_bf16_matches_pallas_interpret(rng):
    o = _operands(rng)
    _, st, logits = decode_step_pallas_gathered(
        {"kernel": jnp.asarray(o["kernel"]), "bias": jnp.asarray(o["bias"])},
        {"w": jnp.asarray(o["w"])}, jnp.asarray(o["ids"]),
        jnp.asarray(o["par"]), jnp.asarray(o["emb"]),
        JState(c=jnp.asarray(o["c"]), h=jnp.asarray(o["h"])),
        jnp.asarray(o["scene"]), H, W, interpret=True)
    h_t, c_t, logits_t = _torch_step(o, torch.bfloat16,
                                     decode_step_gathered_ref)
    assert h_t.dtype == torch.bfloat16 and logits_t.dtype == torch.float32
    _assert_close(st.h, h_t, 2e-2)
    _assert_close(st.c, c_t, 2e-2)
    _assert_close(logits, logits_t, 2e-2)


def test_cpu_tensors_take_the_plain_version(rng, monkeypatch):
    """No fallback: on CPU tensors the wrapper runs the plain version
    because of where the tensors lie, builds nothing and counts no
    kernel launch."""
    from multiverse_torch.ops import _build

    def no_build():
        raise AssertionError("CPU tensors must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(decode_step_gathered, "launches", 0)
    o = _operands(rng)
    got = _torch_step(o, torch.bfloat16)
    want = _torch_step(o, torch.bfloat16, decode_step_gathered_ref)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert decode_step_gathered.launches == 0
