"""The fused ConvLSTM cell step K6 (multiverse_torch/ops/fused_cell.py)
on the CPU: its plain version against the JAX package's
``convlstm_step_pallas`` in interpret mode (rtol = atol = 2e-2), against
the port's composed bf16 ``convlstm_step`` (0.05, the JAX suite's
tolerance between its kernel and the composed step, which stores bf16
gates where the kernel keeps f32), and the wrapper's dispatch. The CUDA
kernel itself is tested on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.ops import ConvLSTMState as JState
from multiverse_tpu.ops.pallas_cell import convlstm_step_pallas
from multiverse_torch.ops import (
    ConvLSTMState,
    convlstm_step,
    convlstm_step_fused,
    convlstm_step_fused_ref,
)

N, H, W, D = 4, 6, 8, 16


def _operands(rng, Cx):
    return dict(
        kernel=rng.randn(3, 3, Cx + D, 4 * D).astype(np.float32) * 0.1,
        bias=rng.randn(4 * D).astype(np.float32) * 0.5,
        x=rng.randn(N, H, W, Cx).astype(np.float32),
        c=rng.randn(N, H, W, D).astype(np.float32),
        h=rng.randn(N, H, W, D).astype(np.float32),
    )


def _torch(o, fn=convlstm_step_fused):
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    return fn({"kernel": t["kernel"], "bias": t["bias"]}, t["x"],
              ConvLSTMState(c=t["c"], h=t["h"]))


@pytest.mark.parametrize("Cx", [8, 16])
def test_plain_cell_matches_pallas_interpret(rng, Cx):
    o = _operands(rng, Cx)
    jh, jst = convlstm_step_pallas(
        {"kernel": jnp.asarray(o["kernel"]), "bias": jnp.asarray(o["bias"])},
        jnp.asarray(o["x"]),
        JState(c=jnp.asarray(o["c"]), h=jnp.asarray(o["h"])),
        interpret=True)
    h, st = _torch(o, convlstm_step_fused_ref)
    assert h.dtype == st.c.dtype == torch.bfloat16
    assert h.shape == st.c.shape == (N, H, W, D)
    assert st.h is h
    for j, t in ((jh, h), (jst.c, st.c)):
        np.testing.assert_allclose(np.asarray(j, np.float32),
                                   t.float().numpy(), rtol=2e-2, atol=2e-2)


def test_plain_cell_tracks_the_composed_bf16_step(rng):
    o = _operands(rng, 8)
    h, st = _torch(o, convlstm_step_fused_ref)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    ref_h, ref_st = convlstm_step(
        {"kernel": t["kernel"], "bias": t["bias"]}, t["x"],
        ConvLSTMState(c=t["c"], h=t["h"]), compute_dtype=torch.bfloat16)
    torch.testing.assert_close(h.float(), ref_h.float(), rtol=0, atol=0.05)
    torch.testing.assert_close(st.c.float(), ref_st.c.float(), rtol=0,
                               atol=0.05)


def test_cpu_tensors_take_the_plain_cell_version(rng, monkeypatch):
    from multiverse_torch.ops import _build

    def no_build():
        raise AssertionError("CPU tensors must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(convlstm_step_fused, "launches", 0)
    o = _operands(rng, 8)
    got_h, got = _torch(o)
    want_h, want = _torch(o, convlstm_step_fused_ref)
    for a, b in ((got_h, want_h), (got.c, want.c)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert convlstm_step_fused.launches == 0
