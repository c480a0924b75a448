"""The fused decode step (multiverse_torch/ops/fused_decode.py) against
the JAX package: the plain version in f32 against the composed JAX step
(rtol = atol = 1e-4), in bf16 against the Pallas kernel in interpret
mode (rtol = atol = 2e-2, the JAX suite's own tolerance for that
kernel); the un-gathered step K8 and the table step K9 against
``decode_step_pallas`` and ``decode_step_pallas_v2`` in interpret mode
(2e-2), K9's tables against ``build_emb_gates_tables`` (bf16 rounding);
and the wrappers' dispatch. The CUDA kernels themselves are tested on
the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.ops import ConvLSTMState as JState
from multiverse_tpu.ops import conv2d as jconv2d
from multiverse_tpu.ops import convlstm_step as jconvlstm_step
from multiverse_tpu.ops import gnn_step_neighbors as jgnn_neighbors
from multiverse_tpu.ops import pallas_decode as jpd
from multiverse_tpu.ops.layers import get_activation as jget_activation
from multiverse_tpu.ops.pallas_decode import decode_step_pallas_gathered
from multiverse_torch.ops import (
    build_emb_gates_tables,
    decode_step,
    decode_step_gathered,
    decode_step_gathered_ref,
    decode_step_ref,
    decode_step_v2,
    decode_step_v2_ref,
    get_activation,
)

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


def test_launch_passes_the_stream_last_and_names_a_failed_launch(
        monkeypatch):
    """The one ctypes path under every wrapper: the entry point
    ``mv_<name>`` gets the arguments and the device's current stream
    last; a nonzero ``cudaError_t`` raises a RuntimeError naming the
    launch and the error's string (a stand-in library here)."""
    from multiverse_torch.ops import _build

    calls = []

    class Lib:
        def mv_gate_lstm(self, *args):
            calls.append(args)
            return 0

        def mv_patch_max(self, *args):
            return 700

        def mv_error_string(self, err):
            return b"an illegal memory access was encountered"

    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(_build, "load_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: Stream())
    _build.launch("gate_lstm", 5, None, 7, device="cuda:0")
    assert calls == [(5, None, 7, 1234)]
    with pytest.raises(RuntimeError, match="CUDA launch of patch_max "
                       "failed: an illegal memory access was "
                       r"encountered \(700\)"):
        _build.launch("patch_max", 1, device="cuda:0")


def _k8_operands(o, dtype=torch.bfloat16):
    """K8's operands: the rows of the gathered step, gathered."""
    par, ids = o["par"], o["ids"]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    return dict(
        cell_w=t(o["kernel"]).reshape(9 * (E + D), 4 * D).to(dtype),
        cell_b=t(o["bias"]), h2g_w=t(o["w"]).reshape(9, D).t().to(dtype),
        emb=t(o["emb"][ids]).reshape(-1, E).to(dtype),
        h=t(o["h"][par]).reshape(-1, D).to(dtype),
        c=t(o["c"][par]).reshape(-1, D).to(dtype),
        scene=(None if o["scene"] is None
               else t(o["scene"]).reshape(-1, C).to(dtype)))


@pytest.mark.parametrize("with_scene", [True, False])
def test_plain_k8_matches_pallas_interpret(rng, with_scene):
    """K8 (``decode_step_pallas``: each row brings its own embedding,
    parents are the identity) in bf16 against the interpret-mode Pallas
    kernel, within 2e-2."""
    o = _operands(rng, with_scene)
    par, ids = o["par"], o["ids"]
    _, st, logits = jpd.decode_step_pallas(
        {"kernel": jnp.asarray(o["kernel"]), "bias": jnp.asarray(o["bias"])},
        {"w": jnp.asarray(o["w"])}, jnp.asarray(o["emb"][ids]),
        JState(c=jnp.asarray(o["c"][par]), h=jnp.asarray(o["h"][par])),
        None if o["scene"] is None else jnp.asarray(o["scene"]), H, W,
        interpret=True)
    h_t, c_t, logits_t = decode_step_ref(**_k8_operands(o), H=H, W=W)
    assert h_t.dtype == torch.bfloat16 and logits_t.shape == (NK * HW, 1)
    _assert_close(st.h, h_t, 2e-2)
    _assert_close(st.c, c_t, 2e-2)
    _assert_close(logits, logits_t, 2e-2)


def test_plain_k1_equals_k8_after_the_gather(rng):
    """The gathered step (K1) is K8 on explicitly gathered rows: the two
    plain versions agree exactly."""
    o = _operands(rng)
    gathered = _torch_step(o, torch.bfloat16, decode_step_gathered_ref)
    for a, b in zip(gathered, decode_step_ref(**_k8_operands(o), H=H, W=W)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _emb_params(rng):
    return {"w": rng.randn(3, 3, 1, E).astype(np.float32) * 0.8,
            "b": rng.randn(E).astype(np.float32) * 0.3}


@pytest.mark.parametrize("chunk", [64, 7])
def test_emb_gates_tables_match_jax(rng, monkeypatch, chunk):
    """K9's tables (background [H, W, 4D], 5x5 deviation slabs
    [HW, 25, 4D], bf16) against the JAX package's, built in chunks of
    ids (7 does not divide HW = 48), within bf16 rounding."""
    o = _operands(rng)
    ep = _emb_params(rng)
    jbg, jdev = jpd.build_emb_gates_tables(
        {k: jnp.asarray(v) for k, v in ep.items()},
        {"kernel": jnp.asarray(o["kernel"])}, H, W, jget_activation("tanh"))
    from multiverse_torch.ops import fused_decode

    monkeypatch.setattr(fused_decode, "TABLE_CHUNK", chunk)
    bg, dev = build_emb_gates_tables(
        {k: torch.from_numpy(v) for k, v in ep.items()},
        {"kernel": torch.from_numpy(o["kernel"])}, H, W,
        get_activation("tanh"))
    assert bg.dtype == dev.dtype == torch.bfloat16
    assert bg.shape == (H, W, 4 * D) and dev.shape == (HW, 25, 4 * D)
    _assert_close(jbg, bg, 1e-2)
    _assert_close(jdev, dev, 1e-2)


def _k9_operands(o, bg, dev, dtype=torch.bfloat16):
    ops = _k8_operands(o, dtype)
    del ops["cell_w"], ops["emb"]
    k = torch.from_numpy(o["kernel"])
    return dict(ops, cell_wh=k[:, :, E:, :].reshape(9 * D, 4 * D).to(dtype),
                h2g_w=torch.from_numpy(o["w"]).reshape(9 * D, 1).to(dtype),
                ids=torch.from_numpy(o["ids"]), emb_bg=bg, emb_dev=dev)


@pytest.mark.parametrize("with_scene", [True, False])
def test_plain_k9_matches_pallas_interpret(rng, with_scene):
    """K9 (``decode_step_pallas_v2``: the h-only gate product plus the
    tables' embedding gates) against the interpret-mode Pallas kernel on
    the same tables, within 2e-2."""
    o = _operands(rng, with_scene)
    ep = _emb_params(rng)
    jbg, jdev = jpd.build_emb_gates_tables(
        {k: jnp.asarray(v) for k, v in ep.items()},
        {"kernel": jnp.asarray(o["kernel"])}, H, W, jget_activation("tanh"))
    par = o["par"]
    _, st, logits = jpd.decode_step_pallas_v2(
        {"kernel": jnp.asarray(o["kernel"]), "bias": jnp.asarray(o["bias"])},
        {"w": jnp.asarray(o["w"])}, jnp.asarray(o["ids"]), jbg, jdev,
        JState(c=jnp.asarray(o["c"][par]), h=jnp.asarray(o["h"][par])),
        None if o["scene"] is None else jnp.asarray(o["scene"]), H, W,
        interpret=True)
    bf = torch.bfloat16
    bg = torch.from_numpy(np.asarray(jbg, np.float32)).to(bf)
    dev = torch.from_numpy(np.asarray(jdev, np.float32)).to(bf)
    h_t, c_t, logits_t = decode_step_v2_ref(**_k9_operands(o, bg, dev), H=H,
                                            W=W)
    assert h_t.dtype == bf and logits_t.shape == (NK * HW, 1)
    _assert_close(st.h, h_t, 2e-2)
    _assert_close(st.c, c_t, 2e-2)
    _assert_close(logits, logits_t, 2e-2)


def test_plain_k9_tracks_k8(rng):
    """K9 on the port's own tables against K8 on the embedding rows of
    the same ids, within the JAX suite's 5e-2 for v2 against v1."""
    from multiverse_torch.geometry import one_hot_grid
    from multiverse_torch.ops import conv2d

    o = _operands(rng)
    ep = {k: torch.from_numpy(v) for k, v in _emb_params(rng).items()}
    act = get_activation("tanh")
    table = conv2d(ep, one_hot_grid(torch.arange(HW), H, W), activation=act,
                   compute_dtype=torch.bfloat16)
    o["emb"] = table.numpy()
    bg, dev = build_emb_gates_tables(
        ep, {"kernel": torch.from_numpy(o["kernel"])}, H, W, act)
    k8 = decode_step_ref(**_k8_operands(o), H=H, W=W)
    k9 = decode_step_v2_ref(**_k9_operands(o, bg, dev), H=H, W=W)
    for a, b in zip(k8, k9):
        torch.testing.assert_close(a.float(), b.float(), rtol=5e-2,
                                   atol=5e-2)


def test_cpu_tensors_take_the_plain_k8_and_k9_versions(rng, monkeypatch):
    from multiverse_torch.ops import _build

    def no_build():
        raise AssertionError("CPU tensors must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(decode_step, "launches", 0)
    monkeypatch.setattr(decode_step_v2, "launches", 0)
    o = _operands(rng)
    ops8 = _k8_operands(o)
    bf = torch.bfloat16
    bg = torch.from_numpy(rng.randn(H, W, 4 * D).astype(np.float32)).to(bf)
    dev = torch.from_numpy(rng.randn(HW, 25, 4 * D).astype(np.float32)).to(bf)
    ops9 = _k9_operands(o, bg, dev)
    for fn, ref, ops in ((decode_step, decode_step_ref, ops8),
                         (decode_step_v2, decode_step_v2_ref, ops9)):
        for a, b in zip(fn(**ops, H=H, W=W), ref(**ops, H=H, W=W)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert decode_step.launches == 0 and decode_step_v2.launches == 0
