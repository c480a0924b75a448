"""Fused beam decode step: GNN attention + ConvLSTM cell + class readout.

Counterparts of the TPU kernels of ``multiverse_tpu/ops/pallas_decode.py``:

* :func:`decode_step_gathered` (bf16) of ``decode_step_pallas_gathered``
  (K1), over ``csrc/fused_decode.cu``;
* :func:`decode_step_gathered_q8` of ``decode_step_pallas_gathered_q8``
  (K2, ``attn_q8=False``, the "int8" tier) and
  ``decode_step_pallas_gathered_q8a`` (K3, ``attn_q8=True``, "int8a"),
  over ``csrc/fused_decode_q8.cu``.

One call advances every beam row by one step, reading its parent's
state and its previous cell's embedding row through ``parent_rows``
and ``prev_ids``, so the beam reorder costs no separate gather.

Each wrapper dispatches on the device of its tensors: CPU tensors go to
the plain PyTorch version (``*_ref``), CUDA tensors to the hand-written
kernels (built at first use, see ``_build.py``). There is no fallback
between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from multiverse_torch.ops.gnn import gnn_neighbor_mask


def _im2col9(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N*H*W, 9*C] zero-padded 3x3 patches, shift-major
    (the row order of an HWIO kernel reshaped to [9*C, out])."""
    N, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + H, dx:dx + W, :].reshape(N * H * W, C)
                      for dy in range(3) for dx in range(3)], dim=-1)


def _neighbor_bias(H: int, W: int, device) -> torch.Tensor:
    mask = torch.from_numpy(gnn_neighbor_mask(H, W)).to(device)
    return (1.0 - mask) * -1e30


# the f32 dequant constant of the int8 attention products (the TPU
# kernel multiplies by it; it never divides by 127^2)
_Q8_SCALE = 1.0 / (127.0 * 127.0)


def _node(hp: torch.Tensor, scene: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 L2-normalised node rows [NK, HW, D(+C)] of h (+) scene."""
    node = hp if scene is None else torch.cat(
        [hp, scene.reshape(hp.shape[0], hp.shape[1], -1).to(hp.dtype)],
        dim=-1)
    node = node.float()
    sumsq = torch.sum(node * node, dim=-1, keepdim=True)
    return node * torch.rsqrt(torch.clamp_min(sumsq, 1e-12))


def _softmax(edges: torch.Tensor) -> torch.Tensor:
    m = torch.amax(edges, dim=-1, keepdim=True)
    e = torch.exp(edges - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def _attention(hp, scene, H, W) -> torch.Tensor:
    """K1's attention (``_gnn_attention``): h + agg in f32, rounding
    where the TPU kernel rounds (bf16 node and attention weights when h
    is bf16, f32 accumulation)."""
    dt = hp.dtype
    node = _node(hp, scene).to(dt).float()
    edges = node @ node.transpose(1, 2) + _neighbor_bias(H, W, hp.device)
    attn = _softmax(edges).to(dt)
    return hp.float() + attn.float() @ hp.float()


def _attention_q8(hp, scene, H, W) -> torch.Tensor:
    """K3's attention (``_gnn_attention_q8``): both products in int8
    with static scales, softmax in f32; h + agg in f32. The integer
    products are exact in f32 here: an edge is at most ~127^2 (the
    nodes are unit vectors) and agg sums nine products of at most
    127^2."""
    node_q = torch.round(_node(hp, scene) * 127.0)
    edges = (node_q @ node_q.transpose(1, 2)) * _Q8_SCALE \
        + _neighbor_bias(H, W, hp.device)
    attn_q = torch.round(_softmax(edges) * 127.0)
    h_q = torch.clamp(torch.round(hp.float() * 127.0), -127.0, 127.0)
    return hp.float() + (attn_q @ h_q) * _Q8_SCALE


def _lstm_update(gates, cp, forget_bias):
    """LSTM nonlinearity on f32 gates [M, 4D] (i, g, f, o); returns
    (new_c, new_h) in f32."""
    i, g, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = (torch.sigmoid(f + forget_bias) * cp.reshape(-1, i.shape[-1])
             .float() + torch.sigmoid(i) * torch.tanh(g))
    return new_c, torch.tanh(new_c) * torch.sigmoid(o)


def _readout(h_out, h2g_w, NK, H, W) -> torch.Tensor:
    """Channel-first readout: P[q, s] = h'[q] . w[:, s], then the 3x3
    conv is nine spatially shifted single-channel sums. [NK*HW, 1]."""
    P = (h_out.float() @ h2g_w[:, :9].float()).reshape(NK, H, W, 9)
    Pp = F.pad(P, (0, 0, 1, 1, 1, 1))
    logits = sum(Pp[:, dy:dy + H, dx:dx + W, 3 * dy + dx]
                 for dy in range(3) for dx in range(3))
    return logits.reshape(NK * H * W, 1)


def decode_step_gathered_ref(
    cell_w: torch.Tensor,        # [9*(E+D), 4*D]
    cell_b: torch.Tensor,        # [4*D]
    h2g_w: torch.Tensor,         # [D, >=9]: w[d, 3*dy+dx]
    prev_ids: torch.Tensor,      # [NK] previous cell per beam row
    parent_rows: torch.Tensor,   # [NK] parent row in the OLD order
    emb_table: torch.Tensor,     # [HW, HW, E] embedding of each cell
    h: torch.Tensor,             # [NK*HW, D] old beam order
    c: torch.Tensor,             # [NK*HW, D] old beam order
    scene: Optional[torch.Tensor],   # [NK*HW, C] new beam order, or None
    H: int,
    W: int,
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused step, rounding where the TPU
    kernel rounds: with bf16 ``h`` the normalised node, the attention
    weights, h + agg and the new state are bf16, and every product
    accumulates in f32; with f32 ``h`` it is the composed f32 step.
    Returns (h' [NK*HW, D], c' [NK*HW, D], logits [NK*HW, 1] f32) in
    the new beam order."""
    dt = h.dtype
    HW = H * W
    NK = prev_ids.shape[0]
    D = h.shape[-1]
    par = parent_rows.long()
    hp = h.reshape(-1, HW, D)[par]                       # [NK, HW, D]
    cp = c.reshape(-1, HW, D)[par]
    emb = emb_table.reshape(HW, HW, -1)[prev_ids.long()].to(dt)
    h2 = _attention(hp, scene, H, W).to(dt)

    patches = _im2col9(torch.cat([emb, h2], dim=-1).reshape(NK, H, W, -1))
    gates = patches.float() @ cell_w.float() + cell_b.float().reshape(1, -1)
    new_c, new_h = _lstm_update(gates, cp, forget_bias)
    h_out, c_out = new_h.to(dt), new_c.to(dt)
    return h_out, c_out, _readout(h_out, h2g_w, NK, H, W)


def decode_step_gathered_q8_ref(
    quant,                       # DecodeQuant from ops/quant.py
    cell_b: torch.Tensor,        # [4*D] f32
    h2g_w: torch.Tensor,         # [D, >=9]: w[d, 3*dy+dx]
    prev_ids: torch.Tensor,      # [NK]
    parent_rows: torch.Tensor,   # [NK]
    h: torch.Tensor,             # [NK*HW, D] bf16, old beam order
    c: torch.Tensor,             # [NK*HW, D] bf16, old beam order
    scene: Optional[torch.Tensor],   # [NK*HW, C], or None
    H: int,
    W: int,
    forget_bias: float = 1.0,
    attn_q8: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the int8 tiers' step
    (``_decode_kernel_gathered_q8``): the attention of K1
    (``attn_q8=False``, "int8") or its int8 form (``attn_q8=True``,
    "int8a"), the gate input h2_q = clip(rint((h + agg) * 127/2), +-127)
    quantised from the f32 sum, the gate product int8 x int8 with exact
    integer sums (in f64), dequantised as acc * t_c + b, then K1's LSTM
    update and readout. Returns (h', c' in ``h``'s type, logits
    [NK*HW, 1] f32) in the new beam order."""
    HW = H * W
    NK = prev_ids.shape[0]
    D = h.shape[-1]
    h2_q = gate_input_q8_ref(parent_rows, h, scene, H, W, attn_q8).float()
    emb = quant.emb_q.reshape(HW, HW, -1)[prev_ids.long()].float()
    patches = _im2col9(torch.cat([emb, h2_q.reshape(NK, HW, D)], dim=-1)
                       .reshape(NK, H, W, -1))
    acc = (patches.double() @ quant.w_q.double()).float()
    gates = acc * quant.t_c.reshape(1, -1) + cell_b.float().reshape(1, -1)
    cp = c.reshape(-1, HW, D)[parent_rows.long()]
    new_c, new_h = _lstm_update(gates, cp, forget_bias)
    h_out, c_out = new_h.to(h.dtype), new_c.to(h.dtype)
    return h_out, c_out, _readout(h_out, h2g_w, NK, H, W)


def gate_input_q8_ref(parent_rows, h, scene, H, W,
                      attn_q8: bool = False) -> torch.Tensor:
    """The int8 gate input h2_q [NK*HW, D] of the q8 step (plain)."""
    HW = H * W
    D = h.shape[-1]
    hp = h.reshape(-1, HW, D)[parent_rows.long()]
    h2_f = (_attention_q8 if attn_q8 else _attention)(hp, scene, H, W)
    h2_q = torch.clamp(torch.round(h2_f * (127.0 / 2.0)), -127.0, 127.0)
    return h2_q.to(torch.int8).reshape(-1, D)


def _require(cond: bool, fn: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def _check_cuda(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                shape: tuple, device: torch.device) -> None:
    _require(t.device == device, fn,
             f"{name} on {t.device}, expected {device}")
    _require(t.dtype == dtype, fn, f"{name} is {t.dtype}, expected {dtype}")
    _require(tuple(t.shape) == shape, fn,
             f"{name} has shape {tuple(t.shape)}, expected {shape}")
    _require(t.is_contiguous(), fn, f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, fn, f"{name} must be 16-byte aligned")


def _check_state(fn, prev_ids, parent_rows, h, c, scene, h2g_w, H, W):
    """Checks shared by the kernels' wrappers (``c`` and ``h2g_w`` may
    be None where a launch does not read them)."""
    dev = h.device
    _require(dev.type == "cuda", fn, f"unsupported device {dev}")
    HW = H * W
    NK = prev_ids.shape[0]
    D = h.shape[-1]
    C = 0 if scene is None else scene.shape[-1]
    bf, i32 = torch.bfloat16, torch.int32
    _require(D % 32 == 0 and D <= 1024, fn,
             f"D={D} must be a multiple of 32, at most 1024")
    _require(C % 2 == 0, fn, f"C={C} must be even")
    _require(h.shape[0] % HW == 0, fn, "h rows must be a multiple of H*W")
    _check_cuda(fn, "prev_ids", prev_ids, i32, (NK,), dev)
    _check_cuda(fn, "parent_rows", parent_rows, i32, (NK,), dev)
    _check_cuda(fn, "h", h, bf, (h.shape[0], D), dev)
    if c is not None:
        _check_cuda(fn, "c", c, bf, tuple(h.shape), dev)
    if h2g_w is not None:
        _require(h2g_w.dim() == 2 and h2g_w.shape[1] >= 9, fn,
                 f"h2g_w has shape {tuple(h2g_w.shape)}, expected [D, >=9]")
        _check_cuda(fn, "h2g_w", h2g_w, bf, (D, h2g_w.shape[1]), dev)
    if scene is not None:
        _check_cuda(fn, "scene", scene, bf, (NK * HW, C), dev)
    return dev, HW, NK, D, C


def _readout_launch(lib, check, h_out, h2g_w, NK, H, W, D, stream):
    logits = torch.empty((NK * H * W, 1), dtype=torch.float32,
                         device=h_out.device)
    check(lib, lib.mv_class_readout(
        h_out.data_ptr(), h2g_w.data_ptr(), h2g_w.shape[1],
        logits.data_ptr(), NK, H, W, D, stream), "class_readout")
    return logits


def decode_step_gathered(
    cell_w: torch.Tensor,
    cell_b: torch.Tensor,
    h2g_w: torch.Tensor,
    prev_ids: torch.Tensor,
    parent_rows: torch.Tensor,
    emb_table: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    scene: Optional[torch.Tensor],
    H: int,
    W: int,
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused decode step (see :func:`decode_step_gathered_ref` for
    the operands). CPU tensors run the plain version; CUDA tensors run
    the hand-written kernel, which takes bf16 state, table and weights,
    an f32 bias and int32 ids and parents, all contiguous, and raises on
    anything else. ``prev_ids`` and ``parent_rows`` must be in range:
    the kernel does not check them. ``decode_step_gathered.launches``
    counts kernel launches."""
    if h.device.type == "cpu":
        return decode_step_gathered_ref(
            cell_w, cell_b, h2g_w, prev_ids, parent_rows, emb_table, h, c,
            scene, H, W, forget_bias)
    fn = "decode_step_gathered"
    dev, HW, NK, D, C = _check_state(fn, prev_ids, parent_rows, h, c, scene,
                                     h2g_w, H, W)
    E = emb_table.shape[-1]
    bf = torch.bfloat16
    _require(E % 8 == 0, fn, f"E={E} must be a multiple of 8")
    _check_cuda(fn, "emb_table", emb_table, bf, (HW, HW, E), dev)
    _check_cuda(fn, "cell_w", cell_w, bf, (9 * (E + D), 4 * D), dev)
    _check_cuda(fn, "cell_b", cell_b, torch.float32, (4 * D,), dev)
    from multiverse_torch.ops._build import check, load_library

    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    h2 = torch.empty((NK * HW, D), dtype=bf, device=dev)
    h_out = torch.empty((NK * HW, D), dtype=bf, device=dev)
    c_out = torch.empty((NK * HW, D), dtype=bf, device=dev)
    check(lib, lib.mv_gnn_attention(
        parent_rows.data_ptr(), h.data_ptr(),
        None if scene is None else scene.data_ptr(), h2.data_ptr(),
        NK, H, W, D, C, stream), "gnn_attention")
    check(lib, lib.mv_gate_lstm(
        prev_ids.data_ptr(), parent_rows.data_ptr(), emb_table.data_ptr(),
        h2.data_ptr(), c.data_ptr(), cell_w.data_ptr(), cell_b.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(), NK, H, W, D, E,
        float(forget_bias), stream), "gate_lstm")
    logits = _readout_launch(lib, check, h_out, h2g_w, NK, H, W, D, stream)
    decode_step_gathered.launches += 1
    return h_out, c_out, logits


decode_step_gathered.launches = 0


def gate_input_q8(parent_rows, h, scene, H, W,
                  attn_q8: bool = False) -> torch.Tensor:
    """The attention launch of the q8 step alone: the int8 gate input
    h2_q [NK*HW, D]. CPU tensors run :func:`gate_input_q8_ref`."""
    if h.device.type == "cpu":
        return gate_input_q8_ref(parent_rows, h, scene, H, W, attn_q8)
    fn = "gate_input_q8"
    _, _, NK, D, C = _check_state(fn, parent_rows, parent_rows, h, None,
                                  scene, None, H, W)
    from multiverse_torch.ops._build import check, load_library

    return _attention_q8_launch(load_library(), check, parent_rows, h,
                                scene, NK, H, W, D, C, attn_q8)


def _attention_q8_launch(lib, check, parent_rows, h, scene, NK, H, W, D, C,
                         attn_q8):
    h2_q = torch.empty((NK * H * W, D), dtype=torch.int8, device=h.device)
    launch = lib.mv_gnn_attention_q8 if attn_q8 else lib.mv_gnn_attention_h2q
    check(lib, launch(
        parent_rows.data_ptr(), h.data_ptr(),
        None if scene is None else scene.data_ptr(), h2_q.data_ptr(),
        NK, H, W, D, C, torch.cuda.current_stream(h.device).cuda_stream),
        "gnn_attention_q8" if attn_q8 else "gnn_attention_h2q")
    return h2_q


def decode_step_gathered_q8(
    quant,
    cell_b: torch.Tensor,
    h2g_w: torch.Tensor,
    prev_ids: torch.Tensor,
    parent_rows: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    scene: Optional[torch.Tensor],
    H: int,
    W: int,
    forget_bias: float = 1.0,
    attn_q8: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused decode step of the int8 tiers (see
    :func:`decode_step_gathered_q8_ref`); ``quant`` comes from
    :func:`multiverse_torch.ops.quant.quantize_decode_weights`. CPU
    tensors run the plain version; CUDA tensors run the hand-written
    kernels (K2, or K3 with ``attn_q8``), which take bf16 state and
    readout weights, the int8 operands of ``quant``, f32 scales and
    bias and int32 ids and parents, all contiguous, and raise on
    anything else. ``decode_step_gathered_q8.launches["int8"]`` and
    ``["int8a"]`` count the kernel launches of each tier."""
    if h.device.type == "cpu":
        return decode_step_gathered_q8_ref(
            quant, cell_b, h2g_w, prev_ids, parent_rows, h, c, scene, H, W,
            forget_bias, attn_q8)
    fn = "decode_step_gathered_q8"
    dev, HW, NK, D, C = _check_state(fn, prev_ids, parent_rows, h, c, scene,
                                     h2g_w, H, W)
    E = quant.emb_q.shape[-1]
    Kdim = 9 * (E + D)
    i8 = torch.int8
    _require(E % 16 == 0, fn, f"E={E} must be a multiple of 16")
    _check_cuda(fn, "emb_q", quant.emb_q.reshape(HW, HW, E), i8,
                (HW, HW, E), dev)
    _check_cuda(fn, "w_qt", quant.w_qt, i8, (4 * D, Kdim), dev)
    _check_cuda(fn, "t_c", quant.t_c.reshape(-1), torch.float32, (4 * D,),
                dev)
    _check_cuda(fn, "cell_b", cell_b, torch.float32, (4 * D,), dev)
    from multiverse_torch.ops._build import check, load_library

    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    h2_q = _attention_q8_launch(lib, check, parent_rows, h, scene, NK, H, W,
                                D, C, attn_q8)
    h_out = torch.empty((NK * HW, D), dtype=torch.bfloat16, device=dev)
    c_out = torch.empty((NK * HW, D), dtype=torch.bfloat16, device=dev)
    check(lib, lib.mv_gate_lstm_q8(
        prev_ids.data_ptr(), parent_rows.data_ptr(), quant.emb_q.data_ptr(),
        h2_q.data_ptr(), c.data_ptr(), quant.w_qt.data_ptr(),
        quant.t_c.data_ptr(), cell_b.data_ptr(), h_out.data_ptr(),
        c_out.data_ptr(), NK, H, W, D, E, float(forget_bias), stream),
        "gate_lstm_q8")
    logits = _readout_launch(lib, check, h_out, h2g_w, NK, H, W, D, stream)
    decode_step_gathered_q8.launches["int8a" if attn_q8 else "int8"] += 1
    return h_out, c_out, logits


decode_step_gathered_q8.launches = {"int8": 0, "int8a": 0}
