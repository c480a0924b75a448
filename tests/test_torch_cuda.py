"""The CUDA kernels of the fused decode step on the card, against their
plain PyTorch versions on the same inputs: K1 (bf16), K2 and K3 (the
int8 and int8a tiers), max abs error 2e-2, the tolerance of the JAX
package's own kernel tests. A CUDA kernel has no CPU mode, so without a
GPU every test here skips.

This file imports neither jax nor tests/conftest.py's fixtures, so it
also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from multiverse_torch.config import MultiverseConfig
from multiverse_torch import inference
from multiverse_torch.models import Multiverse
from multiverse_torch.ops import (
    decode_step_gathered,
    decode_step_gathered_q8,
    decode_step_gathered_q8_ref,
    decode_step_gathered_ref,
    quantize_decode_weights,
)
from multiverse_torch.ops.fused_decode import gate_input_q8, gate_input_q8_ref

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(NK, H, W, D, E, C, seed=0):
    g = torch.Generator().manual_seed(seed)
    HW = H * W
    bf = torch.bfloat16
    return dict(
        cell_w=(torch.randn(9 * (E + D), 4 * D, generator=g)
                * (2.0 / (9 * (E + 5 * D))) ** 0.5).to(bf),
        cell_b=torch.randn(4 * D, generator=g) * 0.1,
        h2g_w=(torch.randn(D, 9, generator=g) * 0.1).to(bf),
        prev_ids=torch.randint(0, HW, (NK,), generator=g, dtype=torch.int32),
        parent_rows=torch.randperm(NK, generator=g).to(torch.int32),
        emb_table=torch.tanh(torch.randn(HW, HW, E, generator=g)).to(bf),
        h=torch.tanh(torch.randn(NK * HW, D, generator=g)).to(bf),
        c=torch.randn(NK * HW, D, generator=g).to(bf),
        scene=(torch.randn(NK * HW, C, generator=g).to(bf) if C else None),
    )


@pytest.mark.parametrize("NK,H,W,D,E,C", [
    (6, 6, 8, 64, 16, 4),        # M = 288: a ragged last tile
    (5, 7, 9, 32, 8, 0),         # odd grid, no scene features
    (40, 18, 32, 256, 32, 64),   # the beam decode's widths
])
def test_kernel_matches_plain_version(cuda, NK, H, W, D, E, C):
    ops = {k: None if v is None else v.to(cuda)
           for k, v in _operands(NK, H, W, D, E, C).items()}
    before = decode_step_gathered.launches
    out = decode_step_gathered(**ops, H=H, W=W)
    torch.cuda.synchronize()
    assert decode_step_gathered.launches == before + 1
    ref = decode_step_gathered_ref(**ops, H=H, W=W)
    for name, a, b in zip(("h", "c", "logits"), out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = float((a.float() - b.float()).abs().max())
        assert err <= TOL, (name, err)


def test_kernel_rejects_operands_it_does_not_take(cuda):
    ops = {k: None if v is None else v.to(cuda)
           for k, v in _operands(4, 6, 8, 32, 8, 4).items()}
    before = decode_step_gathered.launches
    for key, bad in (("h", ops["h"].float()),
                     ("prev_ids", ops["prev_ids"].long()),
                     ("cell_w", ops["cell_w"].t())):
        with pytest.raises(ValueError, match=key):
            decode_step_gathered(**dict(ops, **{key: bad}), H=6, W=8)
    assert decode_step_gathered.launches == before


def test_beam_slice_on_the_card_tracks_the_cpu(cuda):
    cfg = MultiverseConfig(
        scene_h=12, scene_w=16, scene_class=5, video_h=540, video_w=960,
        enc_hidden_size=32, dec_hidden_size=32, scene_conv_dim=8,
        emb_size=8, use_beam_search=True, beam_size=4, use_gnn=True,
        use_scene_enc=True, diverse_beam=True, diverse_gamma=0.01,
        fix_num_timestep=1, compute_dtype="bfloat16").validate()
    model = Multiverse.init(cfg, seed=0)
    inputs = inference.synthesize_multifuture_inputs(cfg, 5, seed=0,
                                                     max_pred_len=14)
    batch = inference.make_batch(inputs, np.arange(5), cfg)
    before = decode_step_gathered.launches
    with torch.inference_mode():
        on_card, _ = inference.beam_forward(
            model.to(cuda), inference.batch_to_device(batch, cuda), cfg,
            T_pred=14)
        torch.cuda.synchronize()
        assert decode_step_gathered.launches == before + 14
        on_cpu, _ = inference.beam_forward(
            model.to("cpu"), inference.batch_to_device(batch,
                                                        torch.device("cpu")),
            cfg, T_pred=14)
    err = float((on_card.logits[:, :, 0].cpu()
                 - on_cpu.logits[:, :, 0]).abs().max())
    assert err <= TOL


def _q8_operands(NK, H, W, D, E, C, device, seed=0):
    ops = {k: None if v is None else v.to(device)
           for k, v in _operands(NK, H, W, D, E, C, seed).items()}
    kernel = ops.pop("cell_w").float().reshape(3, 3, E + D, 4 * D)
    emb = ops.pop("emb_table").float().reshape(H * W, H, W, E)
    return quantize_decode_weights({"kernel": kernel}, emb), ops


@pytest.mark.parametrize("attn_q8", [False, True])
@pytest.mark.parametrize("NK,H,W,D,E,C", [
    (6, 6, 8, 64, 16, 4),        # M = 288: a ragged last tile
    (5, 7, 9, 32, 16, 0),        # odd grid, no scene features
    (40, 18, 32, 256, 32, 64),   # the beam decode's widths
])
def test_q8_kernel_matches_plain_version(cuda, NK, H, W, D, E, C, attn_q8):
    quant, ops = _q8_operands(NK, H, W, D, E, C, cuda)
    tier = "int8a" if attn_q8 else "int8"
    before = dict(decode_step_gathered_q8.launches)
    out = decode_step_gathered_q8(quant, **ops, H=H, W=W, attn_q8=attn_q8)
    torch.cuda.synchronize()
    assert decode_step_gathered_q8.launches[tier] == before[tier] + 1
    ref = decode_step_gathered_q8_ref(quant, **ops, H=H, W=W,
                                      attn_q8=attn_q8)
    for name, a, b in zip(("h", "c", "logits"), out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = float((a.float() - b.float()).abs().max())
        assert err <= TOL, (name, err)
    # the int8 gate inputs differ only where a rounding tie of the
    # attention flips one step
    args = (ops["parent_rows"], ops["h"], ops["scene"], H, W, attn_q8)
    diff = (gate_input_q8(*args).int() - gate_input_q8_ref(*args).int())
    assert int(diff.abs().max()) <= 1
    assert float((diff != 0).float().mean()) < 1e-3


def test_q8_kernel_rejects_operands_it_does_not_take(cuda):
    quant, ops = _q8_operands(4, 6, 8, 32, 16, 4, cuda)
    before = dict(decode_step_gathered_q8.launches)
    for key, bad in (("h", ops["h"].float()),
                     ("parent_rows", ops["parent_rows"].long())):
        with pytest.raises(ValueError, match=key):
            decode_step_gathered_q8(quant, **dict(ops, **{key: bad}),
                                    H=6, W=8)
    with pytest.raises(ValueError, match="w_qt"):
        decode_step_gathered_q8(quant._replace(w_qt=quant.w_q), **ops,
                                H=6, W=8)
    small, ops8 = _q8_operands(4, 6, 8, 32, 8, 4, cuda)
    with pytest.raises(ValueError, match="E=8"):
        decode_step_gathered_q8(small, **ops8, H=6, W=8)
    assert decode_step_gathered_q8.launches == before


@pytest.mark.parametrize("decode_quant", ["none", "int8", "int8a"])
def test_greedy_slice_on_the_card_tracks_the_cpu(cuda, decode_quant):
    cfg = MultiverseConfig(
        scene_h=12, scene_w=16, scene_class=5, video_h=540, video_w=960,
        enc_hidden_size=32, dec_hidden_size=32, scene_conv_dim=8,
        emb_size=16, use_gnn=True, use_scene_enc=True,
        compute_dtype="bfloat16", decode_quant=decode_quant).validate()
    model = Multiverse.init(cfg, seed=0)
    inputs = inference.synthesize_multifuture_inputs(cfg, 5, seed=0,
                                                     max_pred_len=14)
    batch = inference.make_batch(inputs, np.arange(5), cfg)
    before = (decode_step_gathered.launches,
              dict(decode_step_gathered_q8.launches))
    with torch.inference_mode():
        on_card, _ = inference.greedy_forward(
            model.to(cuda), inference.batch_to_device(batch, cuda), cfg,
            T_pred=10)
        torch.cuda.synchronize()
        if decode_quant == "none":
            assert decode_step_gathered.launches == before[0] + 10
        else:
            assert decode_step_gathered_q8.launches[decode_quant] \
                == before[1][decode_quant] + 10
        on_cpu, _ = inference.greedy_forward(
            model.to("cpu"), inference.batch_to_device(batch,
                                                        torch.device("cpu")),
            cfg, T_pred=10)
    err = float((on_card[:, 0].cpu() - on_cpu[:, 0]).abs().max())
    assert err <= TOL
