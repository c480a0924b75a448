"""The CUDA kernels on the card, against their plain PyTorch versions on
the same inputs: the fused decode step's K1 (bf16), K2, K3 and K7 (the
int8, int8a and int8_dyn tiers), K8 (no gather) and K9 (embedding gates
from tables), and the ConvLSTM cell K6, max abs error 2e-2, the
tolerance of the JAX package's own kernel tests; K1's three launches
alone (attention, gate, readout), its gate launch on the plain h2
giving the plain gate's bf16 c' in at least 0.999 of entries, none more
than one bf16 step of max(|c'|, C_FLOOR) off, a gate shown to reject
three planted layout faults; K7's h2_f within 1e-5 of the plain one but
at pixels (at most 0.001 of them) whose difference is whole bf16 steps
of their attention weights, its r_p the exact patch max of that h2_f,
and its gate launch on the plain version's own inputs, bf16 c' equal in
at least 0.999 of entries and none more than one bf16 step off, a gate
shown to reject two planted faults; K2/K3's gate launch on the plain
h2_q held to the same gate, shown to reject three planted layout
faults; K1's gate launch also at its tiling's edges (tile counts off
the SM count, units in two beam rows, H = 11 and 1, a W that takes the
gathered path, D = 128 and 96), its epilogue's reciprocal giving
__frcp_rn's bits on every float it can meet, and one fused step's trace
holding K1's three launches and nothing else; the attention launch
giving the same bits on two calls in each of its three outputs, its
comparison with the plain h2 shown to reject a softmax that leaves out
one neighbour; the training attention's K4
(forward) and K5 (backward), max abs error 2e-2 x max |plain| (K4 also
2e-2), also at SimAug's shapes (N = 36 and 12) and with only the node
rows requiring grad, the decodes that must run them, and a SimAug
attack step's input gradient through them within 2e-2 relative L2 of
the plain versions'. The offline decode's CUDA graphs of the encoders
and the regression head: pickles byte-equal to the eager path's in
every tier and greedy at the published widths, one capture a shape and
then replays, replays that follow weights loaded in place or replaced,
and serving left eager. A CUDA kernel has no CPU mode, so without a GPU
every test here skips.

This file imports neither jax nor tests/conftest.py's fixtures, so it
also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

from unittest import mock

import numpy as np
import pytest
import torch

from multiverse_torch.config import MultiverseConfig
from multiverse_torch import inference
from multiverse_torch.data import dataset
from multiverse_torch.geometry import one_hot_grid
from multiverse_torch.models import Multiverse
from multiverse_torch.ops import (
    ConvLSTMState,
    build_emb_gates_tables,
    conv2d,
    convlstm_step_fused,
    convlstm_step_fused_ref,
    decode_step,
    decode_step_gathered,
    decode_step_gathered_q8,
    decode_step_gathered_q8_ref,
    decode_step_gathered_q8dyn,
    decode_step_gathered_q8dyn_ref,
    decode_step_gathered_ref,
    decode_step_ref,
    decode_step_v2,
    decode_step_v2_ref,
    get_activation,
    quantize_decode_weights,
    quantize_decode_weights_v2,
)
from multiverse_torch.ops.fused_decode import (
    class_readout,
    class_readout_ref,
    gate_input_bf16,
    gate_input_bf16_ref,
    gate_input_q8,
    gate_input_q8_ref,
    gate_inputs_q8dyn,
    gate_inputs_q8dyn_ref,
    gate_lstm_bf16,
    gate_lstm_bf16_ref,
    gate_lstm_q8,
    gate_lstm_q8_ref,
    gate_lstm_q8dyn,
    gate_lstm_q8dyn_ref,
    h2f_weight_flips,
    rcp_rn_mismatches,
    row_scales_q8dyn_ref,
)
from multiverse_torch.ops.gate_layout import prepare_gate_weights
from multiverse_torch.data.multiview import (
    MultiviewDataset,
    synthesize_multiview_split,
)
from multiverse_torch.models import simaug
from multiverse_torch.ops import fused_decode, fused_gnn
from multiverse_torch.ops.gnn import gnn_neighbor_mask
from multiverse_torch.ops.fused_gnn import (
    GnnDense,
    gnn_dense_bwd,
    gnn_dense_bwd_ref,
    gnn_dense_fwd,
    gnn_dense_fwd_ref,
    gnn_step_fused,
)
from multiverse_torch.models import compute_loss, model_forward

pytestmark = pytest.mark.cuda
TOL = 2e-2
# K1's c' steps at max(|c'|, C_FLOOR): its f32 gate sums run in another
# order than the plain product's, and where the two terms of c' cancel
# that noise flips the sign of a c' near 0
C_FLOOR = 2.0 ** -6
# K1's attention launch: its bf16 h2 equal to the plain h2 in at least this
# share of entries (chip_smoke.py's H2_SAME_MIN)
H2_SAME_MIN = 0.9999


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
    (320, 18, 32, 256, 32, 64),  # the beam decode's rows: 16 x K = 20
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


@pytest.mark.parametrize("NK,H,W,D,E,C", [
    (6, 6, 8, 64, 16, 4),        # image-row boxes taller than the grid
    (5, 7, 9, 32, 8, 0),         # gathered A, D = 32, no scene features
    (40, 18, 32, 256, 32, 64),   # the beam decode's widths
    (320, 18, 32, 256, 32, 64),  # the beam decode's rows: 16 x K = 20
    (60, 11, 32, 256, 32, 64),   # attention runs of rows that start and
                                 # end inside an image
    (133, 18, 32, 256, 32, 64),  # 2396 gate tiles: not a multiple of the
                                 # SM count
    (7, 18, 32, 256, 32, 64),    # NK odd: tiles whose two units lie in two
                                 # beam rows
    (9, 11, 32, 256, 32, 64),    # H = 11: an image's last unit half empty
    (7, 1, 32, 256, 32, 64),     # H = 1: one image row a unit
    (5, 18, 40, 256, 32, 64),    # W = 40 does not divide 64: gathered A
    (13, 18, 32, 128, 32, 64),   # D = 128: two column blocks a pixel tile
    (6, 18, 32, 96, 32, 64),     # D = 96: the 128-column instantiation
])
def test_k1_launches_alone_match_their_plain_versions(cuda, NK, H, W, D, E,
                                                      C):
    """K1's attention launch within TOL of the plain h2; its gate launch
    on the plain h2 giving the plain gate's c' in >= 0.999 of entries,
    none more than one bf16 step of max(|c'|, C_FLOOR) off; its readout
    within TOL."""
    ops = {k: None if v is None else v.to(cuda)
           for k, v in _operands(NK, H, W, D, E, C).items()}
    before = (gate_input_bf16.launches, gate_lstm_bf16.launches,
              class_readout.launches)
    args = (ops["parent_rows"], ops["h"], ops["scene"], H, W)
    h2 = gate_input_bf16(*args)
    ref_h2 = gate_input_bf16_ref(*args)
    assert h2.dtype == torch.bfloat16 and h2.shape == ref_h2.shape
    assert _err(h2, ref_h2) <= TOL
    gate = (ops["cell_b"], ops["prev_ids"], ops["parent_rows"],
            ops["emb_table"], ref_h2, ops["c"], H, W)
    h_k, c_k = gate_lstm_bf16(ops["cell_w"], *gate,
                              weights=prepare_gate_weights(ops["cell_w"], E))
    h_p, c_p = gate_lstm_bf16_ref(ops["cell_w"], *gate)
    same, worst = c_agreement(c_k, c_p, C_FLOOR)
    assert same >= 0.999 and worst <= 1, (same, worst)
    assert _err(h_k, h_p) <= TOL
    logits = class_readout(h_k, ops["h2g_w"], H, W)
    torch.cuda.synchronize()
    assert _err(logits, class_readout_ref(h_k, ops["h2g_w"], H, W)) <= TOL
    assert (gate_input_bf16.launches, gate_lstm_bf16.launches,
            class_readout.launches) == tuple(n + 1 for n in before)


def test_k1_gate_rejects_planted_faults(cuda):
    """K1's gate-launch gate (c' equal in >= 0.999 of entries, none more
    than one bf16 step of max(|c'|, C_FLOOR) off) rejects three layout
    faults of the gate
    launch: the last K tile of 64 dropped, gates i and g swapped in one
    8-channel chunk, tap s = 8 zeroed."""
    H, W, D = 18, 32, 256
    ops = {k: v.to(cuda) for k, v in _operands(40, H, W, D, 32, 64).items()}
    h2 = gate_input_bf16_ref(ops["parent_rows"], ops["h"], ops["scene"], H,
                             W)
    gate = (ops["cell_b"], ops["prev_ids"], ops["parent_rows"],
            ops["emb_table"], h2, ops["c"], H, W)
    w = ops["cell_w"]
    _, want = gate_lstm_bf16_ref(w, *gate)
    Kdim = w.shape[0]
    dropped, swapped, tap = w.clone(), w.clone(), w.clone()
    dropped[(Kdim - 1) // 64 * 64:] = 0
    swapped[:, 0:8], swapped[:, D:D + 8] = w[:, D:D + 8], w[:, 0:8]
    tap[8 * (Kdim // 9):] = 0
    for what, wf in (("last K tile", dropped), ("i/g chunk", swapped),
                     ("tap 8", tap)):
        _, got = gate_lstm_bf16_ref(wf, *gate)
        same, worst = c_agreement(got, want, C_FLOOR)
        assert same < 0.999 or worst > 1, (what, same, worst)


def test_gate_epilogue_reciprocal_rounds_as_frcp_rn(cuda):
    """The gate launch's sigmoids take 1 / (1 + exp(-x)) with a
    reciprocal of their own (no call, unlike __frcp_rn): it gives
    __frcp_rn's bits on every float it can meet, each of [1, +inf] and
    every positive NaN."""
    assert rcp_rn_mismatches(0x3F800000, 0x7FFFFFFF, cuda) == 0


# the names that mvbench/metrics/k1_roofline_pct.decode.py sums as K1
K1_KERNELS = ("gnn_attention_kernel", "gate_lstm_wgmma_kernel",
              "class_readout_kernel")


def test_fused_step_runs_only_k1s_three_kernels(cuda):
    """A torch.profiler trace of one fused bf16 step holds K1's three
    launches, one each, and no other device operation: a launch renamed
    or split off would leave the benchmark's K1 roofline share reading
    time it does not count, or counting time twice."""
    from torch.profiler import ProfilerActivity, profile

    H, W, E = 18, 32, 32
    ops = {k: None if v is None else v.to(cuda)
           for k, v in _operands(40, H, W, 256, E, 64).items()}
    weights = prepare_gate_weights(ops["cell_w"], E)
    decode_step_gathered(**ops, H=H, W=W, weights=weights)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_step_gathered(**ops, H=H, W=W, weights=weights)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if str(e.device_type()).endswith("CUDA")]
    assert sorted(k for n in names for k in K1_KERNELS if k in n) == \
        sorted(K1_KERNELS), names
    assert len(names) == len(K1_KERNELS), names


@pytest.mark.parametrize("NK,H,W,D,C", [
    (320, 18, 32, 256, 64),      # the beam decode's rows
    (60, 11, 32, 256, 64),       # runs that start and end inside an image
    (3, 18, 64, 256, 64),        # two tiles across a row
])
def test_attention_launch_is_deterministic(cuda, NK, H, W, D, C):
    """Two calls of the attention launch give the same bits in each of
    its outputs: K1's bf16 h2, K2's int8 h2_q, K7's f32 h2_f and r_p;
    the bf16 h2 within TOL of the plain one."""
    ops = {k: None if v is None else v.to(cuda)
           for k, v in _operands(NK, H, W, D, 8, C).items()}
    args = (ops["parent_rows"], ops["h"], ops["scene"], H, W)
    assert _err(gate_input_bf16(*args), gate_input_bf16_ref(*args)) <= TOL
    for launch in (lambda: (gate_input_bf16(*args),),
                   lambda: (gate_input_q8(*args, False),),
                   lambda: gate_inputs_q8dyn(*args)):
        first, second = launch(), launch()
        for a, b in zip(first, second):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_attention_comparison_rejects_a_neighbour_left_out(cuda):
    """The attention launch's comparison with its plain h2 (within TOL,
    bf16 h2 equal in at least H2_SAME_MIN of entries) rejects a plain
    version whose softmax leaves out each pixel's east neighbour."""
    NK, H, W, D, C = 320, 18, 32, 256, 64
    ops = {k: None if v is None else v.to(cuda)
           for k, v in _operands(NK, H, W, D, 32, C).items()}
    args = (ops["parent_rows"], ops["h"], ops["scene"], H, W)
    h2 = gate_input_bf16(*args)
    want = gate_input_bf16_ref(*args)
    assert _err(h2, want) <= TOL and _same(h2, want) >= H2_SAME_MIN

    def east_left_out(H, W, device):
        mask = torch.from_numpy(gnn_neighbor_mask(H, W)).to(device)
        q = torch.arange(H * W, device=device)
        east = q[(q % W) < W - 1]
        mask[east, east + 1] = 0
        return (1.0 - mask) * -1e30

    with mock.patch.object(fused_decode, "_neighbor_bias", east_left_out):
        fault = gate_input_bf16_ref(*args)
    assert _err(h2, fault) > TOL, _err(h2, fault)
    assert _same(h2, fault) < H2_SAME_MIN, _same(h2, fault)


def test_kernel_rejects_operands_it_does_not_take(cuda):
    ops = {k: None if v is None else v.to(cuda)
           for k, v in _operands(4, 6, 8, 32, 8, 4).items()}
    before = decode_step_gathered.launches
    for key, bad in (("h", ops["h"].float()),
                     ("prev_ids", ops["prev_ids"].long()),
                     ("cell_w", ops["cell_w"].t())):
        with pytest.raises(ValueError, match=key):
            decode_step_gathered(**dict(ops, **{key: bad}), H=6, W=8)
    # weights laid out for another embedding width
    with pytest.raises(ValueError, match="weights"):
        decode_step_gathered(**ops, H=6, W=8, weights=prepare_gate_weights(
            ops["cell_w"][72:], 0))
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
    (1, 18, 32, 256, 32, 64),    # M = 576: ragged last tile at full width
    (3, 18, 32, 256, 32, 64),    # M = 1728
    (4, 6, 8, 128, 16, 4),       # image-row boxes taller than the grid
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
    ref_h2q = gate_input_q8_ref(*args)
    diff = (gate_input_q8(*args).int() - ref_h2q.int())
    assert int(diff.abs().max()) <= 1
    assert float((diff != 0).float().mean()) < 1e-3
    # the gate launch alone, on the plain version's own h2_q
    gate = (quant, ops["cell_b"], ops["prev_ids"], ops["parent_rows"],
            ref_h2q, ops["c"], H, W)
    launched = gate_lstm_q8.launches
    _, c_k = gate_lstm_q8(*gate)
    assert gate_lstm_q8.launches == launched + 1
    same, worst = c_agreement(c_k, gate_lstm_q8_ref(*gate)[1])
    assert same >= 0.999 and worst <= 1, (same, worst)


def test_q8_gate_rejects_planted_faults(cuda):
    """The gate-launch gate (c' equal in >= 0.999 of entries, none more
    than one bf16 step off) rejects three layout faults of the gate
    launch: the last K tile of 128 dropped, gates i and g swapped in one
    8-column chunk, tap s = 8 zeroed."""
    H, W, D = 18, 32, 256
    quant, ops = _q8_operands(40, H, W, D, 32, 64, cuda)
    h2_q = gate_input_q8_ref(ops["parent_rows"], ops["h"], ops["scene"], H,
                             W, True)
    gate = (ops["cell_b"], ops["prev_ids"], ops["parent_rows"], h2_q,
            ops["c"], H, W)
    _, want = gate_lstm_q8_ref(quant, *gate)
    w = quant.w_q
    Kdim = w.shape[0]
    dropped, swapped, tap = w.clone(), w.clone(), w.clone()
    dropped[(Kdim - 1) // 128 * 128:] = 0
    swapped[:, 0:8], swapped[:, D:D + 8] = w[:, D:D + 8], w[:, 0:8]
    tap[8 * (Kdim // 9):] = 0
    for what, wq in (("last K tile", dropped), ("i/g chunk", swapped),
                     ("tap 8", tap)):
        _, got = gate_lstm_q8_ref(quant._replace(w_q=wq), *gate)
        same, worst = c_agreement(got, want)
        assert same < 0.999 or worst > 1, (what, same, worst)


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


@pytest.mark.parametrize("decode_quant", ["none", "int8", "int8a",
                                          "int8_dyn"])
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
              dict(decode_step_gathered_q8.launches),
              decode_step_gathered_q8dyn.launches)
    with torch.inference_mode():
        on_card, _ = inference.greedy_forward(
            model.to(cuda), dataset.batch_to_device(batch, cuda), cfg,
            T_pred=10)
        torch.cuda.synchronize()
        if decode_quant == "none":
            assert decode_step_gathered.launches == before[0] + 10
        elif decode_quant == "int8_dyn":
            assert decode_step_gathered_q8dyn.launches == before[2] + 10
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


# the shapes of tests/test_torch_gnn_band.py, which pins the band layout
# of these launches on the CPU: every edge of the band
GNN_SHAPES = [
    (3, 6, 8, 16, 4),          # small; Dn = 20, not a multiple of 8
    (2, 7, 9, 32, 0),          # odd grid, no scene features
    (20, 18, 32, 256, 64),     # the training decode's widths
    (2, 9, 16, 32, 8),         # the 9x16 grid of stride 4: W = 16
    (2, 5, 33, 32, 8),         # W = 33: a tile of one pixel
    (3, 1, 8, 16, 4),          # H = 1: both halo rows off the grid
    (2, 2, 9, 16, 4),          # H = 2
    (1, 6, 8, 32, 8),          # N = 1
    (2, 6, 8, 16, 4),          # Dn = 20
    (2, 5, 7, 18, 4),          # Ds = 18, Dn = 22
    (1, 3, 70, 16, 4),         # W = 70: two column bands
]


# SimAug's: the multiview attack at N*M = 12 x 3 samples, its outer step
# at N = 12
SIMAUG_GNN_SHAPES = [(36, 18, 32, 256, 64), (12, 18, 32, 256, 64)]


@pytest.mark.parametrize("N,H,W,D,C", GNN_SHAPES + SIMAUG_GNN_SHAPES)
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


@pytest.mark.parametrize("N,H,W,D,C", [(3, 6, 8, 16, 4),
                                       (20, 18, 32, 256, 64)])
def test_gnn_kernels_are_deterministic(cuda, N, H, W, D, C):
    """No atomics: two calls on the same inputs agree bit for bit."""
    node, states, g = _gnn_operands(N, H, W, D, C, cuda)
    first = (gnn_dense_fwd(node, states, H, W),
             *gnn_dense_bwd(node, states, g, H, W))
    second = (gnn_dense_fwd(node, states, H, W),
              *gnn_dense_bwd(node, states, g, H, W))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


def test_gnn_dense_backward_to_node_alone(cuda):
    """The attack's role: only the node rows require grad (the states
    are h, which the attack reaches through node as well, but here
    held constant); K5 runs once and node.grad is its dnode."""
    node, states, g = _gnn_operands(4, 6, 8, 16, 4, cuda)
    leaf = node.clone().requires_grad_()
    before = gnn_dense_bwd.launches
    out = GnnDense.apply(leaf, states, 6, 8)
    (dnode,) = torch.autograd.grad(out, leaf, g)
    torch.cuda.synchronize()
    assert gnn_dense_bwd.launches == before + 1
    want = gnn_dense_bwd_ref(node, states, g, 6, 8)[0].float()
    assert dnode.dtype == node.dtype
    assert float((dnode.float() - want).abs().max()) <= TOL * float(
        want.abs().max())


def test_simaug_attack_input_grad_kernel_tracks_plain(cuda):
    """One multiview attack step's input gradient (sum CE with respect
    to the scene features, parameters detached) through K4/K5 and
    through their plain versions on the same weights, batch and start:
    CE within 1e-2 relative, the gradient within 2e-2 relative L2, one
    K4 and one K5 launch per decode step."""
    cfg = simaug.SimAugConfig(
        scene_h=12, scene_w=16, scene_class=5, video_h=540, video_w=960,
        enc_hidden_size=32, dec_hidden_size=32, scene_conv_dim=8,
        emb_size=8, obs_len=4, pred_len=6, use_gnn=True,
        compute_dtype="bfloat16", multiview_train=True).validate()
    ds = MultiviewDataset(dataset.dataset_from_arrays(
        synthesize_multiview_split(cfg, 3), cfg, "train"), cfg, 3)
    batch = dataset.batch_to_device(ds.make_batch(list(range(4)))[0], cuda)
    params = simaug._detached(Multiverse.init(cfg, seed=0, device=cuda))
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    M = batch.pred_grid_class_extra.shape[1]
    scene = simaug.scene_input_of(batch, cfg)
    tiled = scene.repeat_interleave(M, dim=0)
    start = tiled + torch.empty_like(tiled).uniform_(-0.1, 0.1)
    onehot = one_hot_grid(batch.obs_grid_class[:, i], h, w) \
        .repeat_interleave(M, dim=0)
    target = batch.pred_grid_class_extra.reshape(4 * M, -1)
    before = (gnn_dense_fwd.launches, gnn_dense_bwd.launches)
    grad_k, ce_k = simaug._input_grad(params, start, onehot, target, cfg)
    torch.cuda.synchronize()
    assert (gnn_dense_fwd.launches - before[0],
            gnn_dense_bwd.launches - before[1]) == (cfg.pred_len,) * 2
    with mock.patch.object(fused_gnn, "gnn_dense_fwd", gnn_dense_fwd_ref), \
            mock.patch.object(fused_gnn, "gnn_dense_bwd", gnn_dense_bwd_ref):
        grad_p, ce_p = simaug._input_grad(params, start, onehot, target,
                                          cfg)
    assert float(((ce_k - ce_p).abs() / ce_p.abs()).max()) <= 1e-2
    rel = float((grad_k - grad_p).norm() / grad_p.norm())
    assert rel <= TOL, rel
    assert torch.isfinite(grad_k).all()


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


# ------------------------------------------------------- K7, K8, K9, K6

def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _same(a, b) -> float:
    return float((a == b).float().mean())


def _check_outputs(out, ref):
    for name, a, b in zip(("h", "c", "logits"), out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _err(a, b) <= TOL, (name, _err(a, b))


def bf16_ulps(a, b):
    """|a - b| in bf16 steps, elementwise, for two bf16 tensors."""
    def ordered(x):
        i = x.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def c_agreement(got, want, floor: float = 0.0):
    """(share of bf16 c' entries equal, max bf16 steps apart); with a
    ``floor``, the steps of max(|c'|, floor), so that noise flipping the
    sign of a c' near 0 counts as what it is."""
    ulps = bf16_ulps(got, want)
    if not floor:
        return float((ulps == 0).float().mean()), int(ulps.max())
    a, b = got.float(), want.float()
    _, e = torch.frexp(torch.clamp_min(torch.maximum(a.abs(), b.abs()),
                                       floor))
    steps = (a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)
    return float((ulps == 0).float().mean()), float(steps.max())



def _q8dyn_operands(NK, H, W, D, E, C, device, seed=0):
    ops = {k: None if v is None else v.to(device)
           for k, v in _operands(NK, H, W, D, E, C, seed).items()}
    kernel = ops.pop("cell_w").float().reshape(3, 3, E + D, 4 * D)
    emb = ops.pop("emb_table").float().reshape(H * W, H, W, E)
    return quantize_decode_weights_v2({"kernel": kernel}, emb), ops


@pytest.mark.parametrize("NK,H,W,D,E,C", [
    (6, 6, 8, 64, 16, 4),        # M = 288: a ragged last tile
    (5, 7, 9, 32, 16, 0),        # odd grid, no scene features
    (40, 18, 32, 256, 32, 64),   # the beam decode's widths: 9E = 288
    (1, 18, 32, 256, 32, 64),    # M = 576
    (3, 18, 32, 256, 32, 64),    # M = 1728
])
def test_q8dyn_kernel_matches_plain_version(cuda, NK, H, W, D, E, C):
    quant, ops = _q8dyn_operands(NK, H, W, D, E, C, cuda)
    before = decode_step_gathered_q8dyn.launches
    out = decode_step_gathered_q8dyn(quant, **ops, H=H, W=W)
    torch.cuda.synchronize()
    assert decode_step_gathered_q8dyn.launches == before + 1
    _check_outputs(out, decode_step_gathered_q8dyn_ref(quant, **ops, H=H,
                                                       W=W))
    args = (ops["parent_rows"], ops["h"], ops["scene"], H, W)
    h2_f, r_p = gate_inputs_q8dyn(*args)
    ref_h2f, ref_rp = gate_inputs_q8dyn_ref(*args)
    assert h2_f.dtype == r_p.dtype == torch.float32
    # summed in another order, an attention weight's bf16 rounding may
    # flip by one step: every pixel beyond 1e-5 must be explained so
    fl = h2f_weight_flips(*args, h2_f, ref_h2f, 1e-5)
    assert fl["rows"].numel() <= 1e-3 * h2_f.shape[0], fl["rows"].numel()
    assert bool((fl["flips"] >= 1).all()), fl
    assert bool((fl["residual"] <= 1e-5).all()), fl
    torch.testing.assert_close(r_p, row_scales_q8dyn_ref(h2_f, H, W),
                               rtol=0, atol=0)
    # the gate launch alone, on the plain version's own inputs
    gate = (quant, ops["cell_b"], ops["prev_ids"], ops["parent_rows"])
    h_k, c_k = gate_lstm_q8dyn(*gate, ref_h2f, ref_rp, ops["c"], H, W)
    h_p, c_p = gate_lstm_q8dyn_ref(*gate, ref_h2f, ref_rp, ops["c"], H, W)
    same, worst = c_agreement(c_k, c_p)
    assert same >= 0.999 and worst <= 1, (same, worst)


def test_q8dyn_gate_launch_on_image_row_boxes_taller_than_the_grid(cuda):
    """K7's gate launch where its recurrent A tiles are boxes of whole
    image rows, more rows than the grid has (6 x 8, D = 128): on the
    plain h2_f and r_p, c' equal but for rounding; the whole step within
    TOL."""
    H, W = 6, 8
    quant, ops = _q8dyn_operands(4, H, W, 128, 16, 4, cuda)
    h2_f, r_p = gate_inputs_q8dyn_ref(ops["parent_rows"], ops["h"],
                                      ops["scene"], H, W)
    gate = (quant, ops["cell_b"], ops["prev_ids"], ops["parent_rows"])
    _, c_k = gate_lstm_q8dyn(*gate, h2_f, r_p, ops["c"], H, W)
    _, c_p = gate_lstm_q8dyn_ref(*gate, h2_f, r_p, ops["c"], H, W)
    same, worst = c_agreement(c_k, c_p)
    assert same >= 0.999 and worst <= 1, (same, worst)
    _check_outputs(decode_step_gathered_q8dyn(quant, **ops, H=H, W=W),
                   decode_step_gathered_q8dyn_ref(quant, **ops, H=H, W=W))


def test_q8dyn_gate_rejects_planted_faults(cuda):
    """The gate-launch gate (c' equal in >= 0.999 of entries, none more
    than one bf16 step off) rejects a recurrent half quantised at K2's
    static 127/2 and h2_f rounded to bf16 before quantising."""
    H, W = 18, 32
    quant, ops = _q8dyn_operands(40, H, W, 256, 32, 64, cuda)
    h2_f, r_p = gate_inputs_q8dyn_ref(ops["parent_rows"], ops["h"],
                                      ops["scene"], H, W)
    gate = (quant, ops["cell_b"], ops["prev_ids"], ops["parent_rows"])
    _, want = gate_lstm_q8dyn_ref(*gate, h2_f, r_p, ops["c"], H, W)
    h2_b = h2_f.to(torch.bfloat16).float()
    for what, (hf, rp) in (
            ("static 127/2", (h2_f, torch.full_like(r_p, 2.0))),
            ("bf16 h2_f", (h2_b, row_scales_q8dyn_ref(h2_b, H, W)))):
        _, got = gate_lstm_q8dyn_ref(*gate, hf, rp, ops["c"], H, W)
        same, worst = c_agreement(got, want)
        assert same < 0.999 or worst > 1, (what, same, worst)


@pytest.mark.parametrize("NK,H,W,D,E,C", [
    (6, 6, 8, 64, 16, 4),
    (5, 7, 9, 32, 8, 0),
    (40, 18, 32, 256, 32, 64),
])
def test_k8_kernel_matches_plain_version_and_k1(cuda, NK, H, W, D, E, C):
    ops = {k: None if v is None else v.to(cuda)
           for k, v in _operands(NK, H, W, D, E, C).items()}
    HW = H * W
    par = ops["parent_rows"].long()
    k8 = dict(cell_w=ops["cell_w"], cell_b=ops["cell_b"],
              h2g_w=ops["h2g_w"], scene=ops["scene"],
              emb=ops["emb_table"][ops["prev_ids"].long()].reshape(-1, E)
              .contiguous(),
              h=ops["h"].reshape(NK, HW, D)[par].reshape(-1, D).contiguous(),
              c=ops["c"].reshape(NK, HW, D)[par].reshape(-1, D).contiguous())
    before = decode_step.launches
    out = decode_step(**k8, H=H, W=W)
    torch.cuda.synchronize()
    assert decode_step.launches == before + 1
    _check_outputs(out, decode_step_ref(**k8, H=H, W=W))
    _check_outputs(out, decode_step_gathered(**ops, H=H, W=W))


def _k9_case(NK, H, W, D, E, C, device):
    g = torch.Generator().manual_seed(5)
    ops = {k: None if v is None else v.to(device)
           for k, v in _operands(NK, H, W, D, E, C).items()}
    ep = {"w": (torch.randn(3, 3, 1, E, generator=g) * 0.8).to(device),
          "b": (torch.randn(E, generator=g) * 0.3).to(device)}
    act = get_activation("tanh")
    HW = H * W
    table = conv2d(ep, torch.eye(HW, device=device).reshape(HW, H, W, 1),
                   activation=act, compute_dtype=torch.bfloat16)
    kernel = ops["cell_w"].float().reshape(3, 3, E + D, 4 * D)
    bg, dev = build_emb_gates_tables(ep, {"kernel": kernel}, H, W, act)
    ids = ops["prev_ids"]
    k8 = dict(cell_w=ops["cell_w"], cell_b=ops["cell_b"],
              h2g_w=ops["h2g_w"], scene=ops["scene"], h=ops["h"],
              c=ops["c"], emb=table.to(torch.bfloat16)[ids.long()]
              .reshape(-1, E).contiguous())
    k9 = dict(cell_b=ops["cell_b"], scene=ops["scene"], h=ops["h"],
              c=ops["c"], ids=ids, emb_bg=bg, emb_dev=dev,
              cell_wh=kernel[:, :, E:].reshape(9 * D, 4 * D)
              .to(torch.bfloat16).contiguous(),
              h2g_w=ops["h2g_w"].t().reshape(9 * D, 1).contiguous())
    return k8, k9


@pytest.mark.parametrize("NK,H,W,D,E,C", [
    (6, 6, 8, 64, 16, 4),
    (40, 18, 32, 256, 32, 64),
])
def test_k9_kernel_matches_plain_version_and_tracks_k8(cuda, NK, H, W, D, E,
                                                        C):
    k8, k9 = _k9_case(NK, H, W, D, E, C, cuda)
    before = decode_step_v2.launches
    out = decode_step_v2(**k9, H=H, W=W)
    torch.cuda.synchronize()
    assert decode_step_v2.launches == before + 1
    _check_outputs(out, decode_step_v2_ref(**k9, H=H, W=W))
    for a, b in zip(out, decode_step(**k8, H=H, W=W)):
        assert _err(a, b) <= 5e-2


@pytest.mark.parametrize("N,H,W,Cx,D", [
    (3, 6, 8, 8, 32),            # small, Cx = 8
    (2, 7, 9, 16, 64),           # odd grid
    (20, 18, 32, 64, 256),       # the training encoder's step
])
def test_cell_kernel_matches_plain_version(cuda, N, H, W, Cx, D):
    g = torch.Generator().manual_seed(2)
    params = {"kernel": (torch.randn(3, 3, Cx + D, 4 * D, generator=g)
                         * (2.0 / (9 * (Cx + 5 * D))) ** 0.5).to(cuda),
              "bias": (torch.randn(4 * D, generator=g) * 0.1).to(cuda)}
    x = torch.randn(N, H, W, Cx, generator=g).to(cuda)
    st = ConvLSTMState(c=torch.randn(N, H, W, D, generator=g).to(cuda),
                       h=torch.tanh(torch.randn(N, H, W, D, generator=g))
                       .to(cuda))
    before = convlstm_step_fused.launches
    h, out = convlstm_step_fused(params, x, st)
    torch.cuda.synchronize()
    assert convlstm_step_fused.launches == before + 1
    ref_h, ref = convlstm_step_fused_ref(params, x, st)
    for a, b in ((h, ref_h), (out.c, ref.c)):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        assert _err(a, b) <= TOL
    with pytest.raises(ValueError, match="Cx=4"):
        convlstm_step_fused(
            {"kernel": params["kernel"][:, :, Cx - 4:], "bias":
             params["bias"]}, x[..., :4].contiguous(), st)
    assert convlstm_step_fused.launches == before + 1


def test_new_kernels_reject_operands_they_do_not_take(cuda):
    quant, ops = _q8dyn_operands(4, 6, 8, 32, 16, 4, cuda)
    before = decode_step_gathered_q8dyn.launches
    with pytest.raises(ValueError, match="w_hqt"):
        decode_step_gathered_q8dyn(quant._replace(w_hqt=quant.w_hq), **ops,
                                   H=6, W=8)
    with pytest.raises(ValueError, match="parent_rows"):
        decode_step_gathered_q8dyn(
            quant, **dict(ops, parent_rows=ops["parent_rows"].long()),
            H=6, W=8)
    assert decode_step_gathered_q8dyn.launches == before
    k8, k9 = _k9_case(4, 6, 8, 32, 8, 4, cuda)
    before = (decode_step.launches, decode_step_v2.launches)
    with pytest.raises(ValueError, match="emb"):
        decode_step(**dict(k8, emb=k8["emb"].float()), H=6, W=8)
    with pytest.raises(ValueError, match="emb_dev"):
        decode_step_v2(**dict(k9, emb_dev=k9["emb_dev"][:-1]), H=6, W=8)
    with pytest.raises(ValueError, match="ids"):
        decode_step_v2(**dict(k9, ids=k9["ids"].long()), H=6, W=8)
    assert (decode_step.launches, decode_step_v2.launches) == before


# ------------------------------------------- the offline decode's graphs


def _published(**kw):
    """The published widths, K = 20 diverse beams, bf16."""
    return MultiverseConfig(
        use_beam_search=True, beam_size=20, diverse_beam=True,
        diverse_gamma=0.01, fix_num_timestep=1, use_gnn=True,
        use_scene_enc=True, use_soft_grid_class=True,
        compute_dtype="bfloat16", **kw).validate()


def _offline(model, inputs, cfg, greedy=False, graphed=True):
    """Both pickle dicts of one offline decode at T = 25, batch 16; with
    ``graphed`` False the encoders and the regression head run eagerly."""
    def run():
        return inference.run_multifuture_inference(
            model, inputs, cfg, batch_size=16, T_max=25, greedy=greedy,
            device="cuda")
    if graphed:
        return run()
    with mock.patch.object(inference, "graph_cache", lambda params: None):
        return run()


def _counted(fn):
    """The program's counters while ``fn()`` runs under the profiler."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from multiverse_torch import utils

    utils.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    torch.cuda.synchronize()
    got = Counter()
    for c in utils.span_snapshot()["counters"]:
        got[c.name] += c.value
    return got


@pytest.mark.parametrize("seed", [11, 23])
@pytest.mark.parametrize("tier", ["none", "int8", "int8a", "int8_dyn",
                                  "greedy"])
def test_graphed_decode_pickles_equal_the_eager_ones(cuda, tier, seed):
    import pickle

    from multiverse_torch.decode_graphs import graph_cache

    greedy = tier == "greedy"
    cfg = _published(decode_quant="none" if greedy else tier)
    model = Multiverse.init(cfg, seed=seed).to(cuda)
    inputs = inference.synthesize_multifuture_inputs(cfg, 64, seed=seed,
                                                     max_pred_len=25)
    eager = _offline(model, inputs, cfg, greedy, graphed=False)
    assert len(graph_cache(model)) == 0
    graphed = _offline(model, inputs, cfg, greedy)
    assert len(graph_cache(model)) == 2
    assert len(eager[0]) == 64 and len(eager[1]) == (0 if greedy else 64)
    assert pickle.dumps(graphed) == pickle.dumps(eager)


def test_two_decodes_at_one_shape_capture_once_then_replay(cuda):
    cfg = _published()
    model = Multiverse.init(cfg, seed=3).to(cuda)
    inputs = inference.synthesize_multifuture_inputs(cfg, 40, seed=3,
                                                     max_pred_len=25)
    first = _counted(lambda: _offline(model, inputs, cfg))
    second = _counted(lambda: _offline(model, inputs, cfg))
    # three batches (the last padded), two parts each
    assert first["beam.steps"] == second["beam.steps"] == 3 * 25
    assert first["decode.graph_captures"] == 2
    assert first["decode.graph_replays"] == 6
    assert second["decode.graph_captures"] == 0
    assert second["decode.graph_replays"] == 6


def test_replay_follows_weights_loaded_in_place_or_replaced(cuda):
    import pickle

    from multiverse_torch.decode_graphs import graph_cache

    cfg = _published()
    model = Multiverse.init(cfg, seed=5).to(cuda)
    first = {k: v.clone() for k, v in model.state_dict().items()}
    other = Multiverse.init(cfg, seed=6).to(cuda)
    inputs = inference.synthesize_multifuture_inputs(cfg, 32, seed=5,
                                                     max_pred_len=25)
    before = pickle.dumps(_offline(model, inputs, cfg))
    ptrs = [p.data_ptr() for p in model.parameters()]
    model.load_state_dict(other.state_dict())
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    after = pickle.dumps(_offline(model, inputs, cfg))
    assert len(graph_cache(model)) == 2          # replayed, not captured
    assert after != before
    assert after == pickle.dumps(_offline(other, inputs, cfg,
                                          graphed=False))
    # new parameter tensors: captured anew, the old graphs never replayed
    model.load_state_dict(first, assign=True)
    assert [p.data_ptr() for p in model.parameters()] != ptrs
    assert pickle.dumps(_offline(model, inputs, cfg)) == before
    assert len(graph_cache(model)) == 4


def test_serving_runs_the_parts_eagerly(cuda):
    from multiverse_torch.decode_graphs import _CACHES
    from multiverse_torch.serving.engine import ServingEngine

    cfg = MultiverseConfig(
        obs_len=8, pred_len=5, scene_h=12, scene_w=16, scene_class=5,
        emb_size=8, enc_hidden_size=32, dec_hidden_size=32,
        scene_conv_dim=8, use_beam_search=True, beam_size=4,
        diverse_beam=True, diverse_gamma=0.01, fix_num_timestep=1,
        use_gnn=True, use_scene_enc=True,
        compute_dtype="bfloat16").validate()
    model = Multiverse.init(cfg, seed=0)
    eng = ServingEngine(model, cfg, max_batch=4, max_delay_ms=5.0,
                        T_pred=5, device="cuda")
    rnd = np.random.RandomState(0)
    try:
        def serve():
            eng.warmup()
            for _ in range(3):
                obs = np.stack([rnd.uniform(0, cfg.video_w, cfg.obs_len),
                                rnd.uniform(0, cfg.video_h, cfg.obs_len)],
                               axis=1).astype(np.float32)
                eng.predict(obs, pred_len=5)
        got = _counted(serve)
    finally:
        eng.close()
    assert got["beam.steps"] > 0
    assert got["decode.graph_captures"] == got["decode.graph_replays"] == 0
    assert model not in _CACHES
