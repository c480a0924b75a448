"""The CUDA kernels on the card, against their plain PyTorch versions on
the same inputs: the fused decode step's K1 (bf16), K2 and K3 (the int8
and int8a tiers), max abs error 2e-2, the tolerance of the JAX
package's own kernel tests; the training attention's K4 (forward) and
K5 (backward), max abs error 2e-2 x max |plain| (K4 also 2e-2), and
the decodes that must run them. A CUDA kernel has no CPU mode, so without a
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
from multiverse_torch.data import dataset
from multiverse_torch.models import Multiverse
from multiverse_torch.ops import (
    decode_step_gathered,
    decode_step_gathered_q8,
    decode_step_gathered_q8_ref,
    decode_step_gathered_ref,
    quantize_decode_weights,
)
from multiverse_torch.ops.fused_decode import gate_input_q8, gate_input_q8_ref
from multiverse_torch.ops.fused_gnn import (
    gnn_dense_bwd,
    gnn_dense_bwd_ref,
    gnn_dense_fwd,
    gnn_dense_fwd_ref,
    gnn_step_fused,
)
from multiverse_torch.models import compute_loss, model_forward

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
            model.to(cuda), dataset.batch_to_device(batch, cuda), cfg,
            T_pred=14)
        torch.cuda.synchronize()
        assert decode_step_gathered.launches == before + 14
        on_cpu, _ = inference.beam_forward(
            model.to("cpu"), dataset.batch_to_device(batch,
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
            model.to(cuda), dataset.batch_to_device(batch, cuda), cfg,
            T_pred=10)
        torch.cuda.synchronize()
        if decode_quant == "none":
            assert decode_step_gathered.launches == before[0] + 10
        else:
            assert decode_step_gathered_q8.launches[decode_quant] \
                == before[1][decode_quant] + 10
        on_cpu, _ = inference.greedy_forward(
            model.to("cpu"), dataset.batch_to_device(batch,
                                                     torch.device("cpu")),
            cfg, T_pred=10)
    err = float((on_card[:, 0].cpu() - on_cpu[:, 0]).abs().max())
    assert err <= TOL


def _gnn_operands(N, H, W, D, C, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.tanh(torch.randn(N * H * W, D, generator=g))
    node = torch.cat([h, torch.rand(N * H * W, C, generator=g)], dim=-1)
    node = node / node.norm(dim=-1, keepdim=True)
    cot = torch.randn(N * H * W, D, generator=g)
    bf = torch.bfloat16
    return (node.to(bf).to(device), h.to(bf).to(device), cot.to(device))


@pytest.mark.parametrize("N,H,W,D,C", [
    (3, 6, 8, 16, 4),          # small
    (2, 7, 9, 32, 0),          # odd grid, no scene features
    (20, 18, 32, 256, 64),     # the training decode's widths
])
def test_gnn_kernels_match_plain_versions(cuda, N, H, W, D, C):
    node, states, g = _gnn_operands(N, H, W, D, C, cuda)
    before = (gnn_dense_fwd.launches, gnn_dense_bwd.launches)
    out = gnn_dense_fwd(node, states, H, W)
    dnode, dstates = gnn_dense_bwd(node, states, g, H, W)
    torch.cuda.synchronize()
    assert (gnn_dense_fwd.launches, gnn_dense_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = gnn_dense_fwd_ref(node, states, H, W)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    err = float((out - ref).abs().max())
    assert err <= TOL * min(1.0, float(ref.abs().max()))
    for got, want in zip((dnode, dstates),
                         gnn_dense_bwd_ref(node, states, g, H, W)):
        assert got.dtype == want.dtype and got.shape == want.shape
        err = float((got.float() - want.float()).abs().max())
        # relative with no floor: dnode is often far below 1
        assert err <= TOL * float(want.float().abs().max())


def test_gnn_kernels_reject_operands_they_do_not_take(cuda):
    node, states, g = _gnn_operands(2, 6, 8, 16, 4, cuda)
    before = (gnn_dense_fwd.launches, gnn_dense_bwd.launches)
    with pytest.raises(ValueError, match="node"):
        gnn_dense_fwd(node.float(), states, 6, 8)
    with pytest.raises(ValueError, match="states"):
        gnn_dense_fwd(node, states[::2], 6, 8)
    with pytest.raises(ValueError, match="g "):
        gnn_dense_bwd(node, states, g.to(torch.bfloat16), 6, 8)
    assert (gnn_dense_fwd.launches, gnn_dense_bwd.launches) == before


def test_gnn_step_fused_autograd_on_the_card_tracks_the_cpu(cuda):
    g = torch.Generator().manual_seed(3)
    h = torch.randn(4, 6, 8, 16, generator=g).to(torch.bfloat16)
    s = torch.randn(4, 6, 8, 4, generator=g).to(torch.bfloat16)
    cot = torch.randn(4, 6, 8, 16, generator=g)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        hh = h.to(dev).requires_grad_()
        ss = s.to(dev).requires_grad_()
        before = (gnn_dense_fwd.launches, gnn_dense_bwd.launches)
        out = gnn_step_fused(hh, ss)
        torch.sum(out * cot.to(dev)).backward()
        launched = (gnn_dense_fwd.launches - before[0],
                    gnn_dense_bwd.launches - before[1])
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
        grads.append([t.detach().float().cpu()
                      for t in (out, hh.grad, ss.grad)])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= TOL * max(1.0, float(
            b.abs().max()))


def _tiny_train_cfg(**kw):
    return MultiverseConfig(
        scene_h=12, scene_w=16, scene_class=5, video_h=540, video_w=960,
        enc_hidden_size=32, dec_hidden_size=32, scene_conv_dim=8,
        emb_size=8, obs_len=4, pred_len=6, use_gnn=True, use_scene_enc=True,
        use_soft_grid_class=True, compute_dtype="bfloat16", **kw).validate()


def _train_batch(cfg, n, device):
    ds = dataset.dataset_from_arrays(dataset.synthesize_split(cfg, n, seed=0),
                                     cfg, "train")
    return dataset.batch_to_device(ds.make_batch(list(range(n)))[0], device)


def test_training_decode_runs_k4_and_k5_per_step(cuda):
    """bf16 training on the card: the class decoder's GNN runs K4 once
    per decode step, and the backward K5 once per step."""
    cfg = _tiny_train_cfg()
    model = Multiverse.init(cfg, seed=0, device=cuda, trainable=True)
    batch = _train_batch(cfg, 3, cuda)
    before = (gnn_dense_fwd.launches, gnn_dense_bwd.launches)
    out = model_forward(model, batch, cfg, is_train=True)
    total, _ = compute_loss(model, batch, out, cfg)
    assert gnn_dense_fwd.launches == before[0] + cfg.pred_len
    total.backward()
    torch.cuda.synchronize()
    assert gnn_dense_bwd.launches == before[1] + cfg.pred_len
    assert torch.isfinite(total)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)


def test_composed_beam_decode_runs_k4(cuda):
    """The bf16 beam decode with save_states (use_single_decoder) takes
    the composed step, whose GNN is K4."""
    cfg = MultiverseConfig(
        scene_h=12, scene_w=16, scene_class=5, video_h=540, video_w=960,
        enc_hidden_size=32, dec_hidden_size=32, scene_conv_dim=8,
        emb_size=8, use_beam_search=True, beam_size=4, use_gnn=True,
        use_scene_enc=True, use_single_decoder=True,
        compute_dtype="bfloat16").validate()
    model = Multiverse.init(cfg, seed=0)
    inputs = inference.synthesize_multifuture_inputs(cfg, 3, seed=0,
                                                     max_pred_len=12)
    batch = inference.make_batch(inputs, np.arange(3), cfg)
    before = gnn_dense_fwd.launches
    with torch.inference_mode():
        beam, _ = inference.beam_forward(
            model.to(cuda), dataset.batch_to_device(batch, cuda), cfg,
            T_pred=12)
        torch.cuda.synchronize()
    assert gnn_dense_fwd.launches == before + 12
    assert torch.isfinite(beam.logprobs).all()
