"""The weight layout of the gate launch (``gate_lstm_wgmma_kernel`` in
csrc/gate_wgmma.cuh: K2/K3's and K7's int8 form, K1's bf16 form) and
the form of the readout launch, on the CPU.

The kernel reads its B operand as ``w_qt`` (``w_eqt``, ``w_hqt`` for K7):
K-major [4D, K] int8 whose rows are the gate columns in
``gate_row_order`` (and, for K2/K3, whose K columns are the contraction
rows in ``gate_k_order``: the embedding taps, then the recurrent ones).
A block of DT channels takes rows 4*d0 .. 4*(d0+DT); a consumer
warpgroup takes NW of them from n_off; its accumulator's 8-column chunk
j holds gate j % 4 of channels d0 + n_off/4 + 8*(j // 4) .. + 8. These
tests replay that mapping in PyTorch, one tile at a time, and hold it to
the plain gates exactly; they
also hold the plain gate launch (``gate_lstm_q8_ref``), composed with the
plain attention launch, to the plain step, and the K2/K3 plain step to
the JAX package's Pallas kernel in interpret mode. For the bf16 launch
the weights come from ``prepare_gate_weights`` ([4D, 9(E+D)] bf16, the
same row and K orders) and the replay runs stage by stage (64 values a
stage, the embedding half's last stage partly empty). The readout
launch's tap-partials form, replayed band by band, equals the plain
readout and gives the Pallas kernel's logits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.ops import ConvLSTMState as JState
from multiverse_tpu.ops import pallas_decode as jpd
from multiverse_torch.ops import _build
from multiverse_torch.ops.fused_decode import (
    _im2col9,
    class_readout_ref,
    decode_step_gathered_q8_ref,
    gate_input_bf16_ref,
    gate_lstm_bf16_ref,
    gate_input_q8_ref,
    gate_lstm_q8,
    gate_lstm_q8_ref,
    gate_lstm_q8dyn_ref,
    gate_inputs_q8dyn_ref,
)
from multiverse_torch.ops.gate_layout import prepare_gate_weights
from multiverse_torch.ops.quant import (
    gate_k_order,
    gate_row_order,
    quantize_decode_weights,
    quantize_decode_weights_v2,
)

# (K2/K3 column tile, wgmma width): (64, 256) and (32, 128), one consumer
# warpgroup along N each; K7: (64, 128) with two, (32, 128) with one
Q8_TILES = ((64, 256), (32, 128))
Q8DYN_TILES = ((64, 128), (32, 128))


def _operands(seed, NK=4, H=6, W=8, D=64, E=16, C=4):
    rng = np.random.RandomState(seed)
    HW = H * W
    bf = torch.bfloat16
    t = torch.from_numpy
    emb = np.tanh(rng.randn(HW, H, W, E)).astype(np.float32)
    o = dict(
        kernel=t(rng.randn(3, 3, E + D, 4 * D).astype(np.float32) * 0.1),
        emb=t(emb).to(bf).float(),
        cell_b=t(rng.randn(4 * D).astype(np.float32) * 0.3),
        h2g_w=t(rng.randn(D, 9).astype(np.float32) * 0.1).to(bf),
        prev_ids=t(rng.randint(0, HW, NK).astype(np.int32)),
        parent_rows=t(rng.permutation(NK).astype(np.int32)),
        h=t(np.tanh(rng.randn(NK * HW, D)).astype(np.float32)).to(bf),
        c=t(rng.randn(NK * HW, D).astype(np.float32)).to(bf),
        scene=t(rng.rand(NK * HW, C).astype(np.float32)).to(bf),
    )
    return o, H, W


def _tile_gates(a, w_kernel, D, DT, NW):
    """acc [M, 4D] in the plain column order u*D + d, computed tile by
    tile from the kernel's layout and put back where the kernel's
    epilogue reads each accumulator chunk."""
    out = torch.full((a.shape[0], 4 * D), float("nan"), dtype=torch.float64)
    for d0 in range(0, D, DT):
        rows = w_kernel[4 * d0:4 * (d0 + DT)].double()
        for n_off in range(0, 4 * DT, NW):
            acc = a @ rows[n_off:n_off + NW].t()
            for j in range(NW // 8):
                u, d = j % 4, d0 + n_off // 4 + 8 * (j // 4)
                out[:, u * D + d:u * D + d + 8] = acc[:, 8 * j:8 * j + 8]
    return out


@pytest.mark.parametrize("D", [32, 64, 96, 256])
def test_gate_row_order_is_a_permutation_of_chunked_gates(D):
    order = gate_row_order(D)
    assert sorted(order.tolist()) == list(range(4 * D))
    n = torch.arange(4 * D)
    # row n: gate (n // 8) % 4 of channel 8 * (n // 32) + n % 8
    assert torch.equal(order // D, (n // 8) % 4)
    assert torch.equal(order % D, n // 32 * 8 + n % 8)


@pytest.mark.parametrize("D,E", [(32, 16), (64, 16), (64, 32)])
def test_kernel_weights_map_back_to_the_plain_ones(D, E):
    o, H, W = _operands(0, D=D, E=E)
    q = quantize_decode_weights({"kernel": o["kernel"]}, o["emb"])
    qd = quantize_decode_weights_v2({"kernel": o["kernel"]}, o["emb"])
    inverse = torch.argsort(gate_row_order(D))
    k_order = gate_k_order(E, D)
    assert sorted(k_order.tolist()) == list(range(9 * (E + D)))
    # the embedding taps first, each tap's channels in order
    assert torch.equal(k_order[:9 * E] % (E + D),
                       torch.arange(E).repeat(9))
    for kern, plain in ((q.w_qt, q.w_q[k_order]), (qd.w_eqt, qd.w_eq),
                        (qd.w_hqt, qd.w_hq)):
        assert kern.dtype == torch.int8 and kern.is_contiguous()
        assert kern.shape == (4 * D, plain.shape[0])
        assert torch.equal(kern[inverse], plain.t())


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("attn_q8", [False, True])
def test_gates_through_the_kernel_layout_equal_the_plain_gate(D, attn_q8):
    """K2/K3: the integer gate sums through the kernel's layout and
    epilogue mapping equal the plain ones exactly, and so do h' and c'
    computed from them."""
    o, H, W = _operands(1, D=D)
    q = quantize_decode_weights({"kernel": o["kernel"]}, o["emb"])
    NK, HW = o["prev_ids"].shape[0], H * W
    h2_q = gate_input_q8_ref(o["parent_rows"], o["h"], o["scene"], H, W,
                             attn_q8)
    emb = q.emb_q.reshape(HW, HW, -1)[o["prev_ids"].long()].double()
    a = _im2col9(torch.cat([emb, h2_q.double().reshape(NK, HW, D)], dim=-1)
                 .reshape(NK, H, W, -1))
    plain = a @ q.w_q.double()
    want = gate_lstm_q8_ref(q, o["cell_b"], o["prev_ids"], o["parent_rows"],
                            h2_q, o["c"], H, W)
    for DT, NW in Q8_TILES:
        if D % DT:
            continue
        acc = _tile_gates(a[:, gate_k_order(q.emb_q.shape[-1], D)], q.w_qt,
                          D, DT, NW)
        assert torch.equal(acc, plain), (DT, NW)
        gates = acc.float() * q.t_c + o["cell_b"]
        i, g, f, oo = torch.chunk(gates, 4, dim=-1)
        cp = o["c"].reshape(-1, HW, D)[o["parent_rows"].long()] \
            .reshape(-1, D).float()
        new_c = torch.sigmoid(f + 1.0) * cp + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.tanh(new_c) * torch.sigmoid(oo)
        assert torch.equal(new_h.to(torch.bfloat16), want[0])
        assert torch.equal(new_c.to(torch.bfloat16), want[1])


@pytest.mark.parametrize("D", [32, 64])
def test_q8dyn_halves_through_the_kernel_layout_equal_the_plain_ones(D):
    """K7: both gate products (the embedding half, the recurrent half at
    per-row scales) through the kernel's layout and epilogue mapping
    equal the plain ones exactly, and the gates built from them give the
    plain gate launch's h' and c'."""
    o, H, W = _operands(2, D=D)
    q = quantize_decode_weights_v2({"kernel": o["kernel"]}, o["emb"])
    NK, HW = o["prev_ids"].shape[0], H * W
    h2_f, r_p = gate_inputs_q8dyn_ref(o["parent_rows"], o["h"], o["scene"],
                                      H, W)
    emb = q.emb_q.reshape(HW, HW, -1)[o["prev_ids"].long()].double()
    a_e = _im2col9(emb.reshape(NK, H, W, -1))
    rp = r_p.reshape(-1, 1)
    c127 = torch.full_like(rp, 127.0)
    a_h = torch.round(_im2col9(h2_f.reshape(NK, H, W, D)) * (c127 / rp))
    want = gate_lstm_q8dyn_ref(q, o["cell_b"], o["prev_ids"],
                               o["parent_rows"], h2_f, r_p, o["c"], H, W)
    for DT, NW in Q8DYN_TILES:
        if D % DT:
            continue
        acc_e = _tile_gates(a_e, q.w_eqt, D, DT, NW)
        acc_h = _tile_gates(a_h.double(), q.w_hqt, D, DT, NW)
        assert torch.equal(acc_e, a_e @ q.w_eq.double()), (DT, NW)
        assert torch.equal(acc_h, a_h.double() @ q.w_hq.double()), (DT, NW)
        gates = (acc_e.float() * q.t_e + acc_h.float() * (q.u_c * (rp / c127))
                 + o["cell_b"])
        i, g, f, oo = torch.chunk(gates, 4, dim=-1)
        cp = o["c"].reshape(-1, HW, D)[o["parent_rows"].long()] \
            .reshape(-1, D).float()
        new_c = torch.sigmoid(f + 1.0) * cp + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.tanh(new_c) * torch.sigmoid(oo)
        assert torch.equal(new_h.to(torch.bfloat16), want[0])
        assert torch.equal(new_c.to(torch.bfloat16), want[1])


@pytest.mark.parametrize("with_scene", [True, False])
@pytest.mark.parametrize("attn_q8", [False, True])
def test_gate_launch_after_attention_launch_is_the_plain_step(attn_q8,
                                                              with_scene):
    """``gate_lstm_q8_ref`` on ``gate_input_q8_ref``'s h2_q gives the
    plain step's h' and c' (the two launches of K2/K3 before the
    readout)."""
    o, H, W = _operands(3, D=32)
    scene = o["scene"] if with_scene else None
    q = quantize_decode_weights({"kernel": o["kernel"]}, o["emb"])
    h2_q = gate_input_q8_ref(o["parent_rows"], o["h"], scene, H, W, attn_q8)
    assert h2_q.dtype == torch.int8
    got = gate_lstm_q8_ref(q, o["cell_b"], o["prev_ids"], o["parent_rows"],
                           h2_q, o["c"], H, W)
    want = decode_step_gathered_q8_ref(
        q, o["cell_b"], o["h2g_w"], o["prev_ids"], o["parent_rows"], o["h"],
        o["c"], scene, H, W, attn_q8=attn_q8)
    for a, b in zip(got, want[:2]):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_gate_launch(monkeypatch):
    """No fallback: ``gate_lstm_q8`` on CPU tensors runs the plain
    version because of where they lie, builds nothing, counts nothing."""
    def no_build():
        raise AssertionError("CPU tensors must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(gate_lstm_q8, "launches", 0)
    o, H, W = _operands(4, D=32)
    q = quantize_decode_weights({"kernel": o["kernel"]}, o["emb"])
    h2_q = gate_input_q8_ref(o["parent_rows"], o["h"], o["scene"], H, W, True)
    args = (q, o["cell_b"], o["prev_ids"], o["parent_rows"], h2_q, o["c"],
            H, W)
    for a, b in zip(gate_lstm_q8(*args), gate_lstm_q8_ref(*args)):
        assert torch.equal(a, b)
    assert gate_lstm_q8.launches == 0


@pytest.mark.parametrize("attn_q8", [False, True])
def test_plain_gate_launch_tracks_the_pallas_step(attn_q8):
    """The plain attention and gate launches, composed, against the JAX
    package's ``decode_step_pallas_gathered_q8`` in interpret mode on the
    same inputs: h' and c' within 2e-2."""
    o, H, W = _operands(5, D=32)
    NK, D = o["prev_ids"].shape[0], 32
    jq = jpd.quantize_decode_weights({"kernel": jnp.asarray(o["kernel"])},
                                     jnp.asarray(o["emb"].numpy()))
    q = quantize_decode_weights({"kernel": o["kernel"]}, o["emb"])
    f32 = lambda t: np.asarray(t.float().numpy())  # noqa: E731
    _, st, _ = jpd.decode_step_pallas_gathered_q8(
        jq, jnp.asarray(f32(o["cell_b"])),
        {"w": jnp.asarray(f32(o["h2g_w"]).T.reshape(3, 3, D, 1))},
        jnp.asarray(o["prev_ids"].numpy()),
        jnp.asarray(o["parent_rows"].numpy()),
        JState(c=jnp.asarray(f32(o["c"]).reshape(NK, H, W, D)),
               h=jnp.asarray(f32(o["h"]).reshape(NK, H, W, D))),
        jnp.asarray(f32(o["scene"]).reshape(NK, H, W, -1)), H, W,
        interpret=True, attn_q8=attn_q8)
    h2_q = gate_input_q8_ref(o["parent_rows"], o["h"], o["scene"], H, W,
                             attn_q8)
    h_t, c_t = gate_lstm_q8_ref(q, o["cell_b"], o["prev_ids"],
                                o["parent_rows"], h2_q, o["c"], H, W)
    for j, t in ((st.h, h_t), (st.c, c_t)):
        np.testing.assert_allclose(np.asarray(j, np.float32).reshape(-1),
                                   t.float().numpy().reshape(-1),
                                   rtol=2e-2, atol=2e-2)


# ------------------------------------------- the bf16 gate launch (K1 ...)

def _bf16_operands(seed, NK=3, H=6, W=8, D=64, E=16, C=4):
    rng = np.random.RandomState(seed)
    HW = H * W
    bf = torch.bfloat16
    t = torch.from_numpy
    return dict(
        cell_w=t(rng.randn(9 * (E + D), 4 * D).astype(np.float32)
                 * 0.05).to(bf),
        cell_b=t(rng.randn(4 * D).astype(np.float32) * 0.3),
        h2g_w=t(rng.randn(D, 9).astype(np.float32) * 0.1).to(bf),
        prev_ids=t(rng.randint(0, HW, NK).astype(np.int32)),
        parent_rows=t(rng.permutation(NK).astype(np.int32)),
        emb_table=t(np.tanh(rng.randn(HW, HW, E)).astype(np.float32)).to(bf),
        h=t(np.tanh(rng.randn(NK * HW, D)).astype(np.float32)).to(bf),
        c=t(rng.randn(NK * HW, D).astype(np.float32)).to(bf),
        scene=t(rng.rand(NK * HW, C).astype(np.float32)).to(bf),
    ), H, W


@pytest.mark.parametrize("D,E", [(32, 8), (64, 16), (64, 32), (96, 8)])
def test_bf16_weight_layout_maps_back_to_cell_w(D, E):
    """K1's bf16 gate weights: K-major [4D, 9(E+D)], rows in
    gate_row_order, K columns in gate_k_order, the plain kernel's bits."""
    o, _, _ = _bf16_operands(0, D=D, E=E)
    w = prepare_gate_weights(o["cell_w"], E)
    assert w.E == E and w.w_t.dtype == torch.bfloat16
    assert w.w_t.shape == (4 * D, 9 * (E + D)) and w.w_t.is_contiguous()
    inverse = torch.argsort(gate_row_order(D))
    assert torch.equal(w.w_t[inverse], o["cell_w"][gate_k_order(E, D)].t())
    # K9's h-only kernel: no embedding half, the taps in order
    wh = prepare_gate_weights(o["cell_w"][9 * E:], 0)
    assert torch.equal(wh.w_t[inverse], o["cell_w"][9 * E:].t())


def _bf16_stage_gates(a_emb, a_rec, w_t, E, D, DT, NW):
    """The bf16 gate launch's sums, replayed in f64 stage by stage: the
    embedding half in stages of 64 values (its last stage partly empty,
    its weights box reading on into the recurrent columns against zero
    A), then the recurrent half from column 9E; each block's 4*DT
    kernel rows split into consumer warpgroups of NW; put back where the
    epilogue reads each accumulator chunk (the plain column order)."""
    M, K = a_emb.shape[0], w_t.shape[1]
    KE = 64
    wz = torch.cat([w_t.double(), torch.zeros(4 * D, KE, dtype=torch.float64)],
                   dim=1)
    acc = torch.zeros(M, 4 * D, dtype=torch.float64)
    for half, a, kb in ((0, a_emb, 0), (1, a_rec, 9 * E)):
        n = a.shape[1]
        az = torch.cat([a, torch.zeros(M, KE, dtype=torch.float64)], dim=1)
        for k0 in range(0, n, KE):
            a_st = az[:, k0:k0 + KE].clone()
            a_st[:, max(0, n - k0):] = 0
            b_st = wz[:, kb + k0:kb + k0 + KE]
            assert kb + k0 + KE <= K + KE
            acc += a_st @ b_st.t()
    out = torch.full((M, 4 * D), float("nan"), dtype=torch.float64)
    for d0 in range(0, D, DT):
        for n_off in range(0, 4 * DT, NW):
            for j in range(NW // 8):
                u, d = j % 4, d0 + n_off // 4 + 8 * (j // 4)
                col = 4 * d0 + n_off + 8 * j
                out[:, u * D + d:u * D + d + 8] = acc[:, col:col + 8]
    return out


@pytest.mark.parametrize("D,E", [(32, 8), (64, 16), (128, 32)])
def test_bf16_gates_through_the_kernel_layout_equal_the_plain_gate(D, E):
    """K1's gate sums through the kernel's layout, its two K halves, its
    64-value stages and its interleaved rows equal the plain product (in
    f64, where only the order of the sums differs), and the LSTM update
    on them gives the plain gate launch's h' and c' but for rounding."""
    o, H, W = _bf16_operands(1, D=D, E=E)
    NK, HW = o["prev_ids"].shape[0], H * W
    h2 = gate_input_bf16_ref(o["parent_rows"], o["h"], o["scene"], H, W)
    emb = o["emb_table"].reshape(HW, HW, E)[o["prev_ids"].long()].double()
    a_emb = _im2col9(emb.reshape(NK, H, W, E))
    a_rec = _im2col9(h2.double().reshape(NK, H, W, D))
    plain = _im2col9(torch.cat([emb, h2.double().reshape(NK, HW, D)], dim=-1)
                     .reshape(NK, H, W, -1)) @ o["cell_w"].double()
    w = prepare_gate_weights(o["cell_w"], E)
    want = gate_lstm_bf16_ref(o["cell_w"], o["cell_b"], o["prev_ids"],
                              o["parent_rows"], o["emb_table"], h2, o["c"],
                              H, W)
    cp = o["c"].reshape(-1, HW, D)[o["parent_rows"].long()] \
        .reshape(-1, D).float()
    for DT, NW in Q8_TILES:
        if D % DT:
            continue
        acc = _bf16_stage_gates(a_emb, a_rec, w.w_t, E, D, DT, NW)
        torch.testing.assert_close(acc, plain, rtol=1e-12, atol=1e-12)
        i, g, f, oo = torch.chunk(acc.float() + o["cell_b"], 4, dim=-1)
        new_c = torch.sigmoid(f + 1.0) * cp + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.tanh(new_c) * torch.sigmoid(oo)
        for got, ref in ((new_h, want[0]), (new_c, want[1])):
            torch.testing.assert_close(got.to(torch.bfloat16).float(),
                                       ref.float(), rtol=1e-2, atol=1e-2)


def _tap_partials(h_out, w, H, W, TR):
    """The readout launch replayed: per band of TR image rows, the tap
    partials P of the band and its one-row halo from each h' row once
    (f32 weights), then the nine shifted sums in tap order."""
    D = h_out.shape[-1]
    NK = h_out.shape[0] // (H * W)
    hr = h_out.float().reshape(NK, H, W, D)
    ws = w[:, :9].float()
    logits = torch.empty(NK, H, W)
    for y0 in range(0, H, TR):
        ya, yb = max(y0 - 1, 0), min(y0 + TR + 1, H)
        P = hr[:, ya:yb] @ ws                     # [NK, rows, W, 9]
        for y in range(y0, min(y0 + TR, H)):
            acc = torch.zeros(NK, W)
            for s in range(9):
                yy, dx = y + s // 3 - 1, s % 3 - 1
                if not 0 <= yy < H:
                    continue
                row = P[:, yy - ya, :, s]
                if dx < 0:
                    acc[:, 1:] += row[:, :-1]
                elif dx > 0:
                    acc[:, :-1] += row[:, 1:]
                else:
                    acc += row
            logits[:, y] = acc
    return logits.reshape(-1, 1)


@pytest.mark.parametrize("TR", [6, 2, 1])
def test_tap_partials_readout_equals_the_plain_readout(TR):
    """The readout launch's form (tap partials of each band and its halo
    rows, then the shifted sums) equals ``_readout`` in f32."""
    o, H, W = _bf16_operands(2)
    h_out = torch.tanh(o["h"].float() * 1.7).to(torch.bfloat16)
    torch.testing.assert_close(_tap_partials(h_out, o["h2g_w"], H, W, TR),
                               class_readout_ref(h_out, o["h2g_w"], H, W),
                               rtol=1e-6, atol=1e-6)


def test_tap_partials_readout_tracks_the_pallas_readout():
    """On the new h' of the JAX package's bf16 step in interpret mode,
    the plain readout (the launch's form) gives that kernel's logits."""
    o, H, W = _bf16_operands(3, D=32, E=8)
    NK, D, E = o["prev_ids"].shape[0], 32, 8
    f32 = lambda t: np.asarray(t.float().numpy())  # noqa: E731
    _, st, logits = jpd.decode_step_pallas_gathered(
        {"kernel": jnp.asarray(f32(o["cell_w"]).reshape(3, 3, E + D, 4 * D)),
         "bias": jnp.asarray(f32(o["cell_b"]))},
        {"w": jnp.asarray(f32(o["h2g_w"]).T.reshape(3, 3, D, 1))},
        jnp.asarray(o["prev_ids"].numpy()),
        jnp.asarray(o["parent_rows"].numpy()),
        jnp.asarray(f32(o["emb_table"]).reshape(H * W, H, W, E)),
        JState(c=jnp.asarray(f32(o["c"]).reshape(NK, H, W, D)),
               h=jnp.asarray(f32(o["h"]).reshape(NK, H, W, D))),
        jnp.asarray(f32(o["scene"]).reshape(NK, H, W, -1)), H, W,
        interpret=True)
    h_new = torch.from_numpy(np.asarray(st.h, np.float32)).reshape(-1, D) \
        .to(torch.bfloat16)
    np.testing.assert_allclose(
        np.asarray(logits, np.float32).reshape(-1),
        _tap_partials(h_new, o["h2g_w"], H, W, 2).numpy().reshape(-1),
        rtol=1e-3, atol=1e-3)
