"""Fused beam decode step: GNN attention + ConvLSTM cell + class readout.

Counterparts of the TPU kernels of ``multiverse_tpu/ops/pallas_decode.py``:

* :func:`decode_step_gathered` (bf16) of ``decode_step_pallas_gathered``
  (K1), over ``csrc/fused_decode.cu``;
* :func:`decode_step_gathered_q8` of ``decode_step_pallas_gathered_q8``
  (K2, ``attn_q8=False``, the "int8" tier) and
  ``decode_step_pallas_gathered_q8a`` (K3, ``attn_q8=True``, "int8a"),
  over ``csrc/fused_decode_q8.cu``;
* :func:`decode_step_gathered_q8dyn` of
  ``decode_step_pallas_gathered_q8v2`` (K7, the "int8_dyn" tier: two int8
  gate products, the recurrent one at per-row dynamic scales), over
  ``csrc/fused_decode_q8.cu`` and K1's attention with an f32 output;
* :func:`decode_step` of ``decode_step_pallas`` (K8: K1 with one
  embedding row per state row and identity parents) and
  :func:`decode_step_v2` of ``decode_step_pallas_v2`` (K9: K8 with the
  embedding's gate contribution from the tables of
  :func:`build_emb_gates_tables`), over K1's launches in
  ``csrc/fused_decode.cu``. Neither has a caller in the decoders, as in
  the JAX package, whose tests use them as oracles.

One call of the gathered steps advances every beam row by one step,
reading its parent's state and its previous cell's embedding row through
``parent_rows`` and ``prev_ids``, so the beam reorder costs no separate
gather. K1's three launches can also be called alone, each beside its
plain version: :func:`gate_input_bf16` (the attention),
:func:`gate_lstm_bf16` (the gate product and LSTM update) and
:func:`class_readout` (the readout), as :func:`gate_input_q8` and
:func:`gate_lstm_q8` are for K2/K3. The bf16 gate launch reads its
weights in the layout of
:func:`multiverse_torch.ops.gate_layout.prepare_gate_weights`, which the
decoders prepare once per decode; a wrapper given no ``weights``
prepares them itself.

Each wrapper dispatches on the device of its tensors: CPU tensors go to
the plain PyTorch version (``*_ref``), CUDA tensors to the hand-written
kernels (built at first use, see ``_build.py``). There is no fallback
between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from multiverse_torch.geometry import one_hot_grid
from multiverse_torch.ops._build import launch
from multiverse_torch.ops.gate_layout import GateWeights, prepare_gate_weights
from multiverse_torch.ops.gnn import gnn_neighbor_mask
from multiverse_torch.ops.layers import conv2d


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


def _attention_weights(hp, scene, H, W) -> torch.Tensor:
    """K1's attention weights [NK, HW, HW] in h's type (bf16 node rows,
    f32 edges and softmax, then one cast); 0 off the 3x3 band."""
    node = _node(hp, scene).to(hp.dtype).float()
    edges = node @ node.transpose(1, 2) + _neighbor_bias(H, W, hp.device)
    return _softmax(edges).to(hp.dtype)


def _attention(hp, scene, H, W) -> torch.Tensor:
    """K1's attention (``_gnn_attention``): h + agg in f32, rounding
    where the TPU kernel rounds (bf16 node and attention weights when h
    is bf16, f32 accumulation)."""
    return hp.float() + _attention_weights(hp, scene, H, W).float() \
        @ hp.float()


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


def class_readout_ref(h_out: torch.Tensor, h2g_w: torch.Tensor, H: int,
                      W: int) -> torch.Tensor:
    """The readout launch's plain version: logits [NK*HW, 1] f32 of h'
    [NK*HW, D] and the taps' weights h2g_w [D, >=9]."""
    return _readout(h_out, h2g_w, h_out.shape[0] // (H * W), H, W)


def _gate_rows(cell_w, cell_b, emb, h2, cp, H, W, forget_bias):
    """The gate product over [emb (+) h2] and the LSTM update of rows
    already in the output order: emb [NK, HW, E], h2 and cp
    [NK, HW, D]. Returns (h', c') in h2's type."""
    dt = h2.dtype
    NK = h2.shape[0]
    patches = _im2col9(torch.cat([emb.to(dt), h2], dim=-1)
                       .reshape(NK, H, W, -1))
    gates = patches.float() @ cell_w.float() + cell_b.float().reshape(1, -1)
    new_c, new_h = _lstm_update(gates, cp, forget_bias)
    return new_h.to(dt), new_c.to(dt)


def _decode_rows(cell_w, cell_b, h2g_w, emb, hp, cp, scene, H, W,
                 forget_bias):
    """``_decode_kernel`` on rows already in the output order: emb
    [NK, HW, E], hp and cp [NK, HW, D]."""
    h2 = _attention(hp, scene, H, W).to(hp.dtype)
    h_out, c_out = _gate_rows(cell_w, cell_b, emb, h2, cp, H, W,
                              forget_bias)
    return h_out, c_out, _readout(h_out, h2g_w, hp.shape[0], H, W)


def gate_input_bf16_ref(parent_rows, h, scene, H: int, W: int
                        ) -> torch.Tensor:
    """K1's attention launch (plain): h2 = h + agg in ``h``'s type,
    [NK*HW, D] in the new beam order."""
    HW = H * W
    D = h.shape[-1]
    hp = h.reshape(-1, HW, D)[parent_rows.long()]
    return _attention(hp, scene, H, W).to(h.dtype).reshape(-1, D)


def gate_lstm_bf16_ref(cell_w, cell_b, prev_ids, parent_rows, emb_table,
                       h2, c, H: int, W: int, forget_bias: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's gate launch (plain) on a given h2 [NK*HW, D]: the patches of
    [emb_table row of prev_ids[r] (+) h2] times cell_w with f32 sums,
    + b, then the LSTM update with c read through parent_rows. Returns
    (h', c') in h2's type."""
    HW = H * W
    NK = prev_ids.shape[0]
    D = h2.shape[-1]
    emb = emb_table.reshape(HW, HW, -1)[prev_ids.long()]
    return _gate_rows(cell_w, cell_b, emb, h2.reshape(NK, HW, D),
                      c.reshape(-1, HW, D)[parent_rows.long()], H, W,
                      forget_bias)


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
    HW = H * W
    D = h.shape[-1]
    par = parent_rows.long()
    emb = emb_table.reshape(HW, HW, -1)[prev_ids.long()]
    return _decode_rows(cell_w, cell_b, h2g_w, emb,
                        h.reshape(-1, HW, D)[par], c.reshape(-1, HW, D)[par],
                        scene, H, W, forget_bias)


def decode_step_ref(
    cell_w: torch.Tensor,        # [9*(E+D), 4*D]
    cell_b: torch.Tensor,        # [4*D]
    h2g_w: torch.Tensor,         # [D, >=9]: w[d, 3*dy+dx]
    emb: torch.Tensor,           # [N*HW, E] embedding of each state row
    h: torch.Tensor,             # [N*HW, D]
    c: torch.Tensor,             # [N*HW, D]
    scene: Optional[torch.Tensor],   # [N*HW, C], or None
    H: int,
    W: int,
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K8 (``decode_step_pallas``): K1's plain version
    with an identity gather, each row bringing its own embedding.
    Returns (h', c', logits [N*HW, 1] f32)."""
    HW = H * W
    D = h.shape[-1]
    return _decode_rows(cell_w, cell_b, h2g_w,
                        emb.reshape(-1, HW, emb.shape[-1]),
                        h.reshape(-1, HW, D), c.reshape(-1, HW, D), scene,
                        H, W, forget_bias)


# ids per step of build_emb_gates_tables: the whole [HW, H, W, 4D] f32
# stack of gate maps is 1.36 GB at 18x32, D = 256
TABLE_CHUNK = 64


def build_emb_gates_tables(emb_params, cell_params, H: int, W: int, act,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's tables (``build_emb_gates_tables`` of the JAX package): the
    embedding half's gate contribution of every possible previous cell
    as a background map [H, W, 4D] plus a 5x5 deviation slab per cell
    [HW, 25, 4D], both in ``dtype``.

    The embedding map of a one-hot cell is act(conv(onehot) + b): a
    constant background everywhere plus a 3x3 stamp, so its gate conv is
    a constant map plus a 5x5 deviation around the cell. The gate convs
    take ``dtype`` operands with f32 sums, ``TABLE_CHUNK`` ids at a
    time."""
    HW = H * W
    kern = cell_params["kernel"]
    E = emb_params["w"].shape[-1]
    D4 = kern.shape[-1]
    dev = kern.device
    # OIHW weights of the embedding half, rounded to dtype, in f32
    w = kern[:, :, :E, :].to(dtype).float().permute(3, 2, 0, 1)

    def conv_emb(x):                 # [n, H, W, E] -> [n, H, W, 4D] f32
        xt = x.to(dtype).float().permute(0, 3, 1, 2)
        return F.conv2d(xt, w, padding=1).permute(0, 2, 3, 1)

    background = conv_emb(conv2d(emb_params,
                                  torch.zeros(1, H, W, 1, device=dev),
                                  activation=act, compute_dtype=dtype))[0]
    windows = torch.empty(HW, 5, 5, D4, dtype=dtype, device=dev)
    ar5 = torch.arange(5, device=dev)
    for i0 in range(0, HW, TABLE_CHUNK):
        ids = torch.arange(i0, min(HW, i0 + TABLE_CHUNK), device=dev)
        maps = conv2d(emb_params, one_hot_grid(ids, H, W), activation=act,
                      compute_dtype=dtype)
        dev_p = F.pad(conv_emb(maps) - background[None], (0, 0, 2, 2, 2, 2))
        n = torch.arange(ids.numel(), device=dev)[:, None, None]
        ys = (ids // W)[:, None, None] + ar5[None, :, None]
        xs = (ids % W)[:, None, None] + ar5[None, None, :]
        windows[ids] = dev_p[n, ys, xs].to(dtype)
    return background.to(dtype), windows.reshape(HW, 25, D4)


def _place_deviations(ids, emb_dev, H, W) -> torch.Tensor:
    """[N, H, W, 4D] f32: the 5x5 slab of ids[n] centred on its cell,
    zero elsewhere (the TPU kernel's corner-seed and roll)."""
    N = ids.shape[0]
    D4 = emb_dev.shape[-1]
    buf = torch.zeros(N, H + 4, W + 4, D4, device=emb_dev.device)
    ar5 = torch.arange(5, device=emb_dev.device)
    n = torch.arange(N, device=emb_dev.device)[:, None, None]
    ys = (ids.long() // W)[:, None, None] + ar5[None, :, None]
    xs = (ids.long() % W)[:, None, None] + ar5[None, None, :]
    buf[n, ys, xs] = emb_dev[ids.long()].float().reshape(N, 5, 5, D4)
    return buf[:, 2:2 + H, 2:2 + W]


def decode_step_v2_ref(
    cell_wh: torch.Tensor,       # [9*D, 4*D]: the h rows of the gate kernel
    cell_b: torch.Tensor,        # [4*D]
    h2g_w: torch.Tensor,         # [9*D, >=1]: w[(3*dy+dx)*D + d]
    ids: torch.Tensor,           # [N] previous cell of each state row
    emb_bg: torch.Tensor,        # [H, W, 4*D]
    emb_dev: torch.Tensor,       # [HW, 25, 4*D]
    h: torch.Tensor,             # [N*HW, D]
    c: torch.Tensor,             # [N*HW, D]
    scene: Optional[torch.Tensor],   # [N*HW, C], or None
    H: int,
    W: int,
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K9 (``_decode_kernel_v2``): K8's attention, the
    gate product over h2 alone (K = 9D), then
    gates = ((gates_h + placed deviation) + background) + b, K1's LSTM
    update, and the readout as v2 writes it, im2col9(h') . h2g[9D].
    Returns (h', c', logits [N*HW, 1] f32)."""
    dt = h.dtype
    HW = H * W
    N = ids.shape[0]
    D = h.shape[-1]
    D4 = cell_wh.shape[-1]
    h2 = _attention(h.reshape(N, HW, D), scene, H, W).to(dt)
    gates_h = _im2col9(h2.reshape(N, H, W, D)).float() @ cell_wh.float()
    gates = (gates_h.reshape(N, H, W, D4)
             + _place_deviations(ids, emb_dev, H, W)
             + emb_bg.float()).reshape(-1, D4) + cell_b.float()
    new_c, new_h = _lstm_update(gates, c, forget_bias)
    h_out, c_out = new_h.to(dt), new_c.to(dt)
    logits = _im2col9(h_out.reshape(N, H, W, D)).float() \
        @ h2g_w[:, :1].float()
    return h_out, c_out, logits


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
    update and readout: :func:`gate_input_q8_ref`, then
    :func:`gate_lstm_q8_ref`. Returns (h', c' in ``h``'s type, logits
    [NK*HW, 1] f32) in the new beam order."""
    h2_q = gate_input_q8_ref(parent_rows, h, scene, H, W, attn_q8)
    h_out, c_out = gate_lstm_q8_ref(quant, cell_b, prev_ids, parent_rows,
                                    h2_q, c, H, W, forget_bias)
    return h_out, c_out, _readout(h_out, h2g_w, prev_ids.shape[0], H, W)


def gate_lstm_q8_ref(quant, cell_b, prev_ids, parent_rows, h2_q, c,
                     H: int, W: int, forget_bias: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2/K3's gate product and LSTM update (plain) on the int8 gate
    input h2_q [NK*HW, D]: the patches of [emb_q row of prev_ids[r]
    (+) h2_q] times w_q with exact integer sums (in f64), dequantised as
    acc * t_c + b, then K1's LSTM update with c read through
    parent_rows. Returns (h', c') in ``c``'s type."""
    HW = H * W
    NK = prev_ids.shape[0]
    D = h2_q.shape[-1]
    emb = quant.emb_q.reshape(HW, HW, -1)[prev_ids.long()].double()
    patches = _im2col9(torch.cat([emb, h2_q.double().reshape(NK, HW, D)],
                                 dim=-1).reshape(NK, H, W, -1))
    acc = (patches @ quant.w_q.double()).float()
    gates = acc * quant.t_c.reshape(1, -1) + cell_b.float().reshape(1, -1)
    cp = c.reshape(-1, HW, D)[parent_rows.long()]
    new_c, new_h = _lstm_update(gates, cp, forget_bias)
    return new_h.to(c.dtype), new_c.to(c.dtype)


def gate_input_q8_ref(parent_rows, h, scene, H, W,
                      attn_q8: bool = False) -> torch.Tensor:
    """The int8 gate input h2_q [NK*HW, D] of the q8 step (plain)."""
    HW = H * W
    D = h.shape[-1]
    hp = h.reshape(-1, HW, D)[parent_rows.long()]
    h2_f = (_attention_q8 if attn_q8 else _attention)(hp, scene, H, W)
    h2_q = torch.clamp(torch.round(h2_f * (127.0 / 2.0)), -127.0, 127.0)
    return h2_q.to(torch.int8).reshape(-1, D)


def gate_inputs_q8dyn_ref(parent_rows, h, scene, H: int, W: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's gate inputs (plain): h2_f = h + agg of K1's attention, left
    in f32 [NK*HW, D], and the row scales r_p [NK*HW] f32, each output
    pixel's max |.| over its zero-padded 3x3 patch of h2_f, at least
    1e-6."""
    HW = H * W
    D = h.shape[-1]
    hp = h.reshape(-1, HW, D)[parent_rows.long()]
    h2_f = _attention(hp, scene, H, W).reshape(-1, D)
    return h2_f, row_scales_q8dyn_ref(h2_f, H, W)


def row_scales_q8dyn_ref(h2_f: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """K7's row scales r_p [NK*HW] of h2_f [NK*HW, D]:
    max(max |im2col9(h2_f) row|, 1e-6)."""
    D = h2_f.shape[-1]
    return torch.clamp_min(torch.amax(
        _im2col9(h2_f.reshape(-1, H, W, D)).abs(), dim=-1), 1e-6)


def h2f_weight_flips(parent_rows, h, scene, H: int, W: int,
                     h2_f: torch.Tensor, ref_h2f: torch.Tensor,
                     atol: float) -> dict:
    """Explains where an h2_f [NK*HW, D] (K7's attention launch) differs
    from the plain version's ``ref_h2f`` by more than ``atol``. Summing
    an edge in another order may flip an attention weight's bf16
    rounding by one step, which moves every channel of that pixel by the
    step times the neighbour's h. At each such pixel the difference is
    solved (least squares over the channels) for changes of its nine
    plain bf16 weights, each snapped to 0 or to the next bf16 value up
    or down. Returns, per differing pixel: ``rows``, ``flips`` (weights
    changed), ``moved`` (channels that differ at all) and ``residual``
    (max abs difference the snapped changes leave)."""
    HW, D = H * W, h.shape[-1]
    diff = h2_f.float() - ref_h2f.float()
    rows = torch.nonzero((diff.abs() > atol).any(dim=-1)).flatten()
    out = dict(rows=rows.cpu(), flips=torch.zeros(0, dtype=torch.long),
               moved=torch.zeros(0, dtype=torch.long),
               residual=torch.zeros(0, dtype=torch.float64))
    if rows.numel() == 0:
        return out
    hp = h.reshape(-1, HW, D)[parent_rows.long()]
    b, p = rows // HW, rows % HW
    shift = torch.arange(9, device=rows.device)
    y = (p // W)[:, None] + shift // 3 - 1
    x = (p % W)[:, None] + shift % 3 - 1
    inside = (y >= 0) & (y < H) & (x >= 0) & (x < W)
    q = torch.where(inside, y * W + x, 0)
    w = _attention_weights(hp, scene, H, W)[b[:, None], p[:, None], q]
    bits = w.view(torch.int16)
    up = (bits + 1).view(w.dtype).double() - w.double()
    down = torch.where(w > 0, w.double() - (bits - 1).view(w.dtype).double(),
                       0.0)
    cand = torch.stack([torch.zeros_like(up), up, -down], dim=-1).cpu()
    nbr = (hp[b[:, None], q].double() * inside[..., None]).cpu()  # [n, 9, D]
    d = diff[rows].double().cpu()
    sol = torch.linalg.lstsq(nbr.transpose(1, 2), d[..., None],
                             driver="gelsd").solution
    pick = torch.where(inside.cpu(), (sol - cand).abs().argmin(dim=-1), 0)
    step = cand.gather(-1, pick[..., None])
    out.update(flips=(pick != 0).sum(dim=-1), moved=(d != 0).sum(dim=-1),
               residual=(d - (step * nbr).sum(dim=1)).abs().amax(dim=-1))
    return out


def gate_lstm_q8dyn_ref(quant, cell_b, prev_ids, parent_rows, h2_f, r_p, c,
                        H: int, W: int, forget_bias: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's gate product and LSTM update (plain), as
    ``_decode_kernel_gathered_q8v2``: the embedding half
    acc_e = im2col9(emb_q[id]) . w_eq; the recurrent half's patches
    quantised per row, ph_q = rint(patch * (127 / r_p)) with no clip,
    acc_h = ph_q . w_hq (integer sums exact in f64); then
    gates = acc_e * t_e + acc_h * (u_c * (r_p / 127)) + b. Returns (h', c')
    in ``c``'s type."""
    HW = H * W
    NK = prev_ids.shape[0]
    D = h2_f.shape[-1]
    emb = quant.emb_q.reshape(HW, HW, -1)[prev_ids.long()].double()
    acc_e = (_im2col9(emb.reshape(NK, H, W, -1))
             @ quant.w_eq.double()).float()
    # IEEE divisions by a tensor of 127s: ``rp / 127.0`` is a product by
    # 1/127 on the card and ``127.0 / rp`` is ``rp.reciprocal() * 127``,
    # either of which can move a rounding tie
    rp = r_p.reshape(-1, 1).float()
    c127 = torch.full_like(rp, 127.0)
    ph_q = torch.round(_im2col9(h2_f.reshape(NK, H, W, D).float())
                       * (c127 / rp))
    acc_h = (ph_q.double() @ quant.w_hq.double()).float()
    gates = (acc_e * quant.t_e.reshape(1, -1)
             + acc_h * (quant.u_c.reshape(1, -1) * (rp / c127))
             + cell_b.float().reshape(1, -1))
    cp = c.reshape(-1, HW, D)[parent_rows.long()]
    new_c, new_h = _lstm_update(gates, cp, forget_bias)
    return new_h.to(c.dtype), new_c.to(c.dtype)


def decode_step_gathered_q8dyn_ref(
    quant,                       # DecodeQuantDyn from ops/quant.py
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the "int8_dyn" step (K7,
    ``_decode_kernel_gathered_q8v2``): :func:`gate_inputs_q8dyn_ref`,
    :func:`gate_lstm_q8dyn_ref`, then K1's readout. Returns (h', c',
    logits [NK*HW, 1] f32) in the new beam order."""
    h2_f, r_p = gate_inputs_q8dyn_ref(parent_rows, h, scene, H, W)
    h_out, c_out = gate_lstm_q8dyn_ref(quant, cell_b, prev_ids, parent_rows,
                                       h2_f, r_p, c, H, W, forget_bias)
    return h_out, c_out, _readout(h_out, h2g_w, prev_ids.shape[0], H, W)


def _require(cond: bool, fn: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def _check_cuda(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                shape: tuple, device: torch.device) -> None:
    # every launch checks ten or so operands: the messages are formatted
    # only for one that fails
    if (t.device == device and t.dtype == dtype and tuple(t.shape) == shape
            and t.is_contiguous() and t.data_ptr() % 16 == 0):
        return
    _require(t.device == device, fn,
             f"{name} on {t.device}, expected {device}")
    _require(t.dtype == dtype, fn, f"{name} is {t.dtype}, expected {dtype}")
    _require(tuple(t.shape) == shape, fn,
             f"{name} has shape {tuple(t.shape)}, expected {shape}")
    _require(t.is_contiguous(), fn, f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, fn, f"{name} must be 16-byte aligned")


def _check_state(fn, h, c, scene, h2g_w, H, W, prev_ids=None,
                 parent_rows=None):
    """Checks shared by the kernels' wrappers (``c`` and ``h2g_w`` may
    be None where a launch does not read them; without ``parent_rows``
    the parents are the identity, so ``h`` holds exactly the output
    rows). Returns (device, HW, rows, D, C)."""
    dev = h.device
    _require(dev.type == "cuda", fn, f"unsupported device {dev}")
    HW = H * W
    ids = prev_ids if prev_ids is not None else parent_rows
    NK = h.shape[0] // HW if ids is None else ids.shape[0]
    D = h.shape[-1]
    C = 0 if scene is None else scene.shape[-1]
    bf, i32 = torch.bfloat16, torch.int32
    _require(D % 32 == 0 and D <= 1024, fn,
             f"D={D} must be a multiple of 32, at most 1024")
    _require(C % 2 == 0, fn, f"C={C} must be even")
    _require(h.shape[0] % HW == 0, fn, "h rows must be a multiple of H*W")
    if parent_rows is None:
        _require(h.shape[0] == NK * HW, fn,
                 f"h has {h.shape[0]} rows, expected {NK}*H*W (identity "
                 "parents)")
    for name, t in (("prev_ids", prev_ids), ("parent_rows", parent_rows)):
        if t is not None:
            _check_cuda(fn, name, t, i32, (NK,), dev)
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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _readout_launch(h_out, h2g_w, NK, H, W, D):
    logits = torch.empty((NK * H * W, 1), dtype=torch.float32,
                         device=h_out.device)
    launch("class_readout", h_out.data_ptr(), h2g_w.data_ptr(),
           h2g_w.shape[1], logits.data_ptr(), NK, H, W, D,
           device=h_out.device)
    return logits


def _attention_launch(parent_rows, h, scene, NK, H, W, D, C):
    """K1's attention launch: h2 = bf16(h + agg) [NK*HW, D]."""
    h2 = torch.empty((NK * H * W, D), dtype=torch.bfloat16, device=h.device)
    launch("gnn_attention", _ptr(parent_rows), h.data_ptr(), _ptr(scene),
           h2.data_ptr(), NK, H, W, D, C, device=h.device)
    return h2


def _gate_launch(weights, cell_b, prev_ids, parent_rows, emb, h2, c, NK, H,
                 W, D, forget_bias, emb_bg=None, emb_dev=None):
    """The bf16 gate launch (K1; K8 and K6 with null ids and parents; K9
    with the tables): (h', c') [NK*HW, D] bf16."""
    M = NK * H * W
    h_out = torch.empty((M, D), dtype=torch.bfloat16, device=h2.device)
    c_out = torch.empty((M, D), dtype=torch.bfloat16, device=h2.device)
    launch("gate_lstm", _ptr(prev_ids), _ptr(parent_rows), _ptr(emb),
           h2.data_ptr(), c.data_ptr(), weights.w_t.data_ptr(),
           cell_b.data_ptr(), _ptr(emb_bg), _ptr(emb_dev), h_out.data_ptr(),
           c_out.data_ptr(), NK, H, W, D, weights.E, float(forget_bias),
           device=h2.device)
    return h_out, c_out


def _gate_weights(fn, cell_w, cell_b, weights, E, D, dev, name="cell_w"):
    """Checks of the bf16 gate launch's weights and bias (the kernel's
    layout prepared from ``cell_w`` [9*(E+D), 4D] when ``weights`` is
    None); returns the kernel's weights."""
    bf = torch.bfloat16
    _require(E % 8 == 0, fn, f"E={E} must be a multiple of 8")
    _check_cuda(fn, "cell_b", cell_b, torch.float32, (4 * D,), dev)
    if weights is None:
        _check_cuda(fn, name, cell_w, bf, (9 * (E + D), 4 * D), dev)
        weights = prepare_gate_weights(cell_w, E)
    _require(weights.E == E, fn, f"weights are laid out for E={weights.E}, "
             f"expected E={E}")
    _check_cuda(fn, "w_t", weights.w_t, bf, (4 * D, 9 * (E + D)), dev)
    return weights


def _check_k1_gate(fn, cell_w, cell_b, emb_table, weights, H, W, D, dev):
    """Checks of K1's gate operands; returns the kernel's weights."""
    E = emb_table.shape[-1]
    HW = H * W
    _check_cuda(fn, "emb_table", emb_table, torch.bfloat16, (HW, HW, E), dev)
    return _gate_weights(fn, cell_w, cell_b, weights, E, D, dev)


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
    weights: Optional[GateWeights] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused decode step (see :func:`decode_step_gathered_ref` for
    the operands). CPU tensors run the plain version; CUDA tensors run
    the hand-written kernel, which takes bf16 state, table and weights,
    an f32 bias and int32 ids and parents, all contiguous, and raises on
    anything else. ``weights`` is ``prepare_gate_weights(cell_w, E)``,
    made once per decode; without it each call prepares it.
    ``prev_ids`` and ``parent_rows`` must be in range: the kernel does
    not check them. ``decode_step_gathered.launches`` counts kernel
    launches."""
    if h.device.type == "cpu":
        return decode_step_gathered_ref(
            cell_w, cell_b, h2g_w, prev_ids, parent_rows, emb_table, h, c,
            scene, H, W, forget_bias)
    fn = "decode_step_gathered"
    dev, _, NK, D, C = _check_state(fn, h, c, scene, h2g_w, H, W,
                                    prev_ids, parent_rows)
    weights = _check_k1_gate(fn, cell_w, cell_b, emb_table, weights, H, W, D,
                             dev)
    h2 = _attention_launch(parent_rows, h, scene, NK, H, W, D, C)
    h_out, c_out = _gate_launch(weights, cell_b, prev_ids, parent_rows,
                                emb_table, h2, c, NK, H, W, D, forget_bias)
    logits = _readout_launch(h_out, h2g_w, NK, H, W, D)
    decode_step_gathered.launches += 1
    return h_out, c_out, logits


decode_step_gathered.launches = 0


def gate_input_bf16(parent_rows, h, scene, H: int, W: int) -> torch.Tensor:
    """K1's attention launch alone: h2 = bf16(h + agg) [NK*HW, D] (see
    :func:`gate_input_bf16_ref`). CPU tensors run the plain version.
    ``gate_input_bf16.launches`` counts kernel launches."""
    if h.device.type == "cpu":
        return gate_input_bf16_ref(parent_rows, h, scene, H, W)
    fn = "gate_input_bf16"
    _, _, NK, D, C = _check_state(fn, h, None, scene, None, H, W,
                                  parent_rows=parent_rows)
    h2 = _attention_launch(parent_rows, h, scene, NK, H, W, D, C)
    gate_input_bf16.launches += 1
    return h2


gate_input_bf16.launches = 0


def gate_lstm_bf16(cell_w, cell_b, prev_ids, parent_rows, emb_table, h2, c,
                   H: int, W: int, forget_bias: float = 1.0,
                   weights: Optional[GateWeights] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's gate launch alone, on a given bf16 h2 [NK*HW, D] (see
    :func:`gate_lstm_bf16_ref`). CPU tensors run the plain version; CUDA
    tensors take what :func:`decode_step_gathered` takes and raise on
    anything else. ``gate_lstm_bf16.launches`` counts kernel launches."""
    if h2.device.type == "cpu":
        return gate_lstm_bf16_ref(cell_w, cell_b, prev_ids, parent_rows,
                                  emb_table, h2, c, H, W, forget_bias)
    fn = "gate_lstm_bf16"
    dev, _, NK, D, _ = _check_state(fn, c, c, None, None, H, W, prev_ids,
                                    parent_rows)
    _check_cuda(fn, "h2", h2, torch.bfloat16, (NK * H * W, D), dev)
    weights = _check_k1_gate(fn, cell_w, cell_b, emb_table, weights, H, W, D,
                             dev)
    out = _gate_launch(weights, cell_b, prev_ids, parent_rows, emb_table, h2,
                       c, NK, H, W, D, forget_bias)
    gate_lstm_bf16.launches += 1
    return out


gate_lstm_bf16.launches = 0


def rcp_rn_mismatches(lo: int, hi: int, device: torch.device) -> int:
    """The floats with bits ``lo`` .. ``hi`` on which the gate launch's
    epilogue reciprocal (its sigmoids' 1 / (1 + exp(-x))) and CUDA's
    ``__frcp_rn`` give different bits, counted on the card."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    launch("rcp_rn_mismatches", lo, hi, bad.data_ptr(), device=device)
    return int(bad.item())


def class_readout(h_out: torch.Tensor, h2g_w: torch.Tensor, H: int,
                  W: int) -> torch.Tensor:
    """The readout launch alone: logits [NK*HW, 1] f32 of bf16 h'
    [NK*HW, D] and h2g_w [D, >=9] (see :func:`class_readout_ref`). CPU
    tensors run the plain version. ``class_readout.launches`` counts
    kernel launches."""
    if h_out.device.type == "cpu":
        return class_readout_ref(h_out, h2g_w, H, W)
    fn = "class_readout"
    _, _, NK, D, _ = _check_state(fn, h_out, None, None, h2g_w, H, W)
    logits = _readout_launch(h_out, h2g_w, NK, H, W, D)
    class_readout.launches += 1
    return logits


class_readout.launches = 0


def gate_input_q8(parent_rows, h, scene, H, W,
                  attn_q8: bool = False) -> torch.Tensor:
    """The attention launch of the q8 step alone: the int8 gate input
    h2_q [NK*HW, D]. CPU tensors run :func:`gate_input_q8_ref`.
    ``gate_input_q8.launches`` counts kernel launches."""
    if h.device.type == "cpu":
        return gate_input_q8_ref(parent_rows, h, scene, H, W, attn_q8)
    fn = "gate_input_q8"
    _, _, NK, D, C = _check_state(fn, h, None, scene, None, H, W,
                                  parent_rows=parent_rows)
    h2_q = _attention_q8_launch(parent_rows, h, scene, NK, H, W, D, C,
                                attn_q8)
    gate_input_q8.launches += 1
    return h2_q


gate_input_q8.launches = 0


def _attention_q8_launch(parent_rows, h, scene, NK, H, W, D, C, attn_q8):
    h2_q = torch.empty((NK * H * W, D), dtype=torch.int8, device=h.device)
    launch("gnn_attention_q8" if attn_q8 else "gnn_attention_h2q",
           parent_rows.data_ptr(), h.data_ptr(), _ptr(scene),
           h2_q.data_ptr(), NK, H, W, D, C, device=h.device)
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
    dev, HW, NK, D, C = _check_state(fn, h, c, scene, h2g_w, H, W,
                                     prev_ids, parent_rows)
    _check_q8_operands(fn, quant, cell_b, H, W, D, dev)
    h2_q = _attention_q8_launch(parent_rows, h, scene, NK, H, W, D, C,
                                attn_q8)
    h_out, c_out = _gate_lstm_q8_launch(quant, cell_b, prev_ids, parent_rows,
                                        h2_q, c, NK, H, W, D, forget_bias)
    logits = _readout_launch(h_out, h2g_w, NK, H, W, D)
    decode_step_gathered_q8.launches["int8a" if attn_q8 else "int8"] += 1
    return h_out, c_out, logits


decode_step_gathered_q8.launches = {"int8": 0, "int8a": 0}


def _check_q8_operands(fn, quant, cell_b, H, W, D, dev):
    """Checks of the int8 operands of K2/K3's gate launch."""
    HW = H * W
    E = quant.emb_q.shape[-1]
    i8 = torch.int8
    _require(E % 16 == 0, fn, f"E={E} must be a multiple of 16")
    _check_cuda(fn, "emb_q", quant.emb_q.reshape(HW, HW, E), i8,
                (HW, HW, E), dev)
    _check_cuda(fn, "w_qt", quant.w_qt, i8, (4 * D, 9 * (E + D)), dev)
    _check_cuda(fn, "t_c", quant.t_c.reshape(-1), torch.float32, (4 * D,),
                dev)
    _check_cuda(fn, "cell_b", cell_b, torch.float32, (4 * D,), dev)


def _gate_lstm_q8_launch(quant, cell_b, prev_ids, parent_rows, h2_q, c, NK,
                         H, W, D, forget_bias):
    dev = c.device
    M = NK * H * W
    h_out = torch.empty((M, D), dtype=torch.bfloat16, device=dev)
    c_out = torch.empty((M, D), dtype=torch.bfloat16, device=dev)
    launch("gate_lstm_q8", prev_ids.data_ptr(), parent_rows.data_ptr(),
           quant.emb_q.data_ptr(), h2_q.data_ptr(), c.data_ptr(),
           quant.w_qt.data_ptr(), quant.t_c.data_ptr(), cell_b.data_ptr(),
           h_out.data_ptr(), c_out.data_ptr(), NK, H, W, D,
           quant.emb_q.shape[-1], float(forget_bias), device=dev)
    return h_out, c_out


def gate_lstm_q8(quant, cell_b, prev_ids, parent_rows, h2_q, c,
                 H: int, W: int, forget_bias: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2/K3's gate launch alone, on a given int8 gate input h2_q (see
    :func:`gate_lstm_q8_ref`). CPU tensors run the plain version; CUDA
    tensors take what :func:`decode_step_gathered_q8` takes, with h2_q
    int8 [NK*HW, D], and raise on anything else.
    ``gate_lstm_q8.launches`` counts kernel launches."""
    if h2_q.device.type == "cpu":
        return gate_lstm_q8_ref(quant, cell_b, prev_ids, parent_rows, h2_q,
                                c, H, W, forget_bias)
    fn = "gate_lstm_q8"
    dev, _, NK, D, _ = _check_state(fn, c, c, None, None, H, W, prev_ids,
                                    parent_rows)
    _check_cuda(fn, "h2_q", h2_q, torch.int8, (NK * H * W, D), dev)
    _check_q8_operands(fn, quant, cell_b, H, W, D, dev)
    out = _gate_lstm_q8_launch(quant, cell_b, prev_ids, parent_rows, h2_q, c,
                               NK, H, W, D, forget_bias)
    gate_lstm_q8.launches += 1
    return out


gate_lstm_q8.launches = 0


def decode_step(
    cell_w: torch.Tensor,
    cell_b: torch.Tensor,
    h2g_w: torch.Tensor,
    emb: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    scene: Optional[torch.Tensor],
    H: int,
    W: int,
    forget_bias: float = 1.0,
    weights: Optional[GateWeights] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8: the fused step without the beam gather (see
    :func:`decode_step_ref` for the operands). CPU tensors run the plain
    version; CUDA tensors run K1's launches with identity parents and
    one embedding row per state row (bf16 state, embeddings and
    weights, f32 bias, all contiguous; anything else raises).
    ``weights``: ``prepare_gate_weights(cell_w, E)``, or made per call.
    ``decode_step.launches`` counts kernel launches."""
    if h.device.type == "cpu":
        return decode_step_ref(cell_w, cell_b, h2g_w, emb, h, c, scene, H, W,
                               forget_bias)
    fn = "decode_step"
    dev, HW, N, D, C = _check_state(fn, h, c, scene, h2g_w, H, W)
    E = emb.shape[-1]
    _check_cuda(fn, "emb", emb, torch.bfloat16, (N * HW, E), dev)
    weights = _gate_weights(fn, cell_w, cell_b, weights, E, D, dev)
    h2 = _attention_launch(None, h, scene, N, H, W, D, C)
    h_out, c_out = _gate_launch(weights, cell_b, None, None, emb, h2, c, N, H,
                                W, D, forget_bias)
    logits = _readout_launch(h_out, h2g_w, N, H, W, D)
    decode_step.launches += 1
    return h_out, c_out, logits


decode_step.launches = 0


def decode_step_v2(
    cell_wh: torch.Tensor,
    cell_b: torch.Tensor,
    h2g_w: torch.Tensor,
    ids: torch.Tensor,
    emb_bg: torch.Tensor,
    emb_dev: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    scene: Optional[torch.Tensor],
    H: int,
    W: int,
    forget_bias: float = 1.0,
    weights: Optional[GateWeights] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9: K8 with the embedding's gate contribution from the tables of
    :func:`build_emb_gates_tables` (see :func:`decode_step_v2_ref`). CPU
    tensors run the plain version; CUDA tensors run K1's attention, the
    gate launch over h2 alone with the tables in its epilogue, and K1's
    readout with h2g laid out as [D, 9] (bf16 state, weights and tables,
    f32 bias, int32 ids, all contiguous; anything else raises). ``ids``
    must be in range: the kernel does not check them. ``weights``:
    ``prepare_gate_weights(cell_wh, 0)``, or made per call.
    ``decode_step_v2.launches`` counts kernel launches."""
    if h.device.type == "cpu":
        return decode_step_v2_ref(cell_wh, cell_b, h2g_w, ids, emb_bg,
                                  emb_dev, h, c, scene, H, W, forget_bias)
    fn = "decode_step_v2"
    dev, HW, N, D, C = _check_state(fn, h, c, scene, None, H, W,
                                    prev_ids=ids)
    bf = torch.bfloat16
    weights = _gate_weights(fn, cell_wh, cell_b, weights, 0, D, dev,
                            "cell_wh")
    _check_cuda(fn, "emb_bg", emb_bg, bf, (H, W, 4 * D), dev)
    _check_cuda(fn, "emb_dev", emb_dev, bf, (HW, 25, 4 * D), dev)
    _require(h2g_w.dim() == 2 and h2g_w.shape[0] == 9 * D, fn,
             f"h2g_w has shape {tuple(h2g_w.shape)}, expected [9*D, >=1]")
    h2g_cf = h2g_w[:, 0].reshape(9, D).t().contiguous()     # [D, 9]
    _check_cuda(fn, "h2g_w", h2g_cf, bf, (D, 9), dev)
    h2 = _attention_launch(None, h, scene, N, H, W, D, C)
    h_out, c_out = _gate_launch(weights, cell_b, ids, None, None, h2, c, N, H,
                                W, D, forget_bias, emb_bg, emb_dev)
    logits = _readout_launch(h_out, h2g_cf, N, H, W, D)
    decode_step_v2.launches += 1
    return h_out, c_out, logits


decode_step_v2.launches = 0


def gate_inputs_q8dyn(parent_rows, h, scene, H: int, W: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's first two launches alone: h2_f [NK*HW, D] f32 and the row
    scales r_p [NK*HW] f32. CPU tensors run
    :func:`gate_inputs_q8dyn_ref`. ``gate_inputs_q8dyn.launches`` counts
    kernel launches."""
    if h.device.type == "cpu":
        return gate_inputs_q8dyn_ref(parent_rows, h, scene, H, W)
    fn = "gate_inputs_q8dyn"
    _, _, NK, D, C = _check_state(fn, h, None, scene, None, H, W,
                                  parent_rows=parent_rows)
    out = _gate_inputs_q8dyn_launch(parent_rows, h, scene, NK, H, W, D, C)
    gate_inputs_q8dyn.launches += 1
    return out


gate_inputs_q8dyn.launches = 0


def _gate_inputs_q8dyn_launch(parent_rows, h, scene, NK, H, W, D, C):
    dev = h.device
    M = NK * H * W
    h2_f = torch.empty((M, D), dtype=torch.float32, device=dev)
    pix_max = torch.empty((M,), dtype=torch.float32, device=dev)
    r_p = torch.empty((M,), dtype=torch.float32, device=dev)
    launch("gnn_attention_f32", parent_rows.data_ptr(), h.data_ptr(),
           _ptr(scene), h2_f.data_ptr(), pix_max.data_ptr(), NK, H, W, D, C,
           device=dev)
    launch("patch_max", pix_max.data_ptr(), r_p.data_ptr(), NK, H, W,
           device=dev)
    return h2_f, r_p


def gate_lstm_q8dyn(quant, cell_b, prev_ids, parent_rows, h2_f, r_p, c,
                    H: int, W: int, forget_bias: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's gate launch alone, on given h2_f and r_p (see
    :func:`gate_lstm_q8dyn_ref`). CPU tensors run the plain version.
    ``gate_lstm_q8dyn.launches`` counts kernel launches."""
    if h2_f.device.type == "cpu":
        return gate_lstm_q8dyn_ref(quant, cell_b, prev_ids, parent_rows,
                                   h2_f, r_p, c, H, W, forget_bias)
    fn = "gate_lstm_q8dyn"
    dev, _, NK, D, _ = _check_state(fn, c, c, None, None, H, W, prev_ids,
                                    parent_rows)
    out = _gate_lstm_q8dyn_launch(fn, quant, cell_b, prev_ids, parent_rows,
                                  h2_f, r_p, c, NK, H, W, D, forget_bias)
    gate_lstm_q8dyn.launches += 1
    return out


gate_lstm_q8dyn.launches = 0


def _gate_lstm_q8dyn_launch(fn, quant, cell_b, prev_ids, parent_rows, h2_f,
                            r_p, c, NK, H, W, D, forget_bias):
    dev = c.device
    HW, M = H * W, NK * H * W
    E = quant.emb_q.shape[-1]
    i8, f32 = torch.int8, torch.float32
    _require(E % 16 == 0, fn, f"E={E} must be a multiple of 16")
    _check_cuda(fn, "h2_f", h2_f, f32, (M, D), dev)
    _check_cuda(fn, "r_p", r_p, f32, (M,), dev)
    _check_cuda(fn, "emb_q", quant.emb_q.reshape(HW, HW, E), i8,
                (HW, HW, E), dev)
    _check_cuda(fn, "w_eqt", quant.w_eqt, i8, (4 * D, 9 * E), dev)
    _check_cuda(fn, "w_hqt", quant.w_hqt, i8, (4 * D, 9 * D), dev)
    for name in ("t_e", "u_c"):
        _check_cuda(fn, name, getattr(quant, name).reshape(-1), f32,
                    (4 * D,), dev)
    _check_cuda(fn, "cell_b", cell_b, f32, (4 * D,), dev)
    h_out = torch.empty((M, D), dtype=torch.bfloat16, device=dev)
    c_out = torch.empty((M, D), dtype=torch.bfloat16, device=dev)
    launch("gate_lstm_q8dyn", prev_ids.data_ptr(), parent_rows.data_ptr(),
           quant.emb_q.data_ptr(), h2_f.data_ptr(), r_p.data_ptr(),
           c.data_ptr(), quant.w_eqt.data_ptr(), quant.t_e.data_ptr(),
           quant.w_hqt.data_ptr(), quant.u_c.data_ptr(), cell_b.data_ptr(),
           h_out.data_ptr(), c_out.data_ptr(), NK, H, W, D, E,
           float(forget_bias), device=dev)
    return h_out, c_out


def decode_step_gathered_q8dyn(
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused decode step of the "int8_dyn" tier (K7, see
    :func:`decode_step_gathered_q8dyn_ref`); ``quant`` comes from
    :func:`multiverse_torch.ops.quant.quantize_decode_weights_v2`. CPU
    tensors run the plain version; CUDA tensors run the hand-written
    kernels (K1's attention with an f32 output, the row scales, the
    split int8 gate launch, K1's readout), which take bf16 state and
    readout weights, the int8 operands of ``quant``, f32 scales and bias
    and int32 ids and parents, all contiguous, and raise on anything
    else. ``prev_ids`` and ``parent_rows`` must be in range: the kernels
    do not check them. ``decode_step_gathered_q8dyn.launches`` counts
    kernel launches."""
    if h.device.type == "cpu":
        return decode_step_gathered_q8dyn_ref(
            quant, cell_b, h2g_w, prev_ids, parent_rows, h, c, scene, H, W,
            forget_bias)
    fn = "decode_step_gathered_q8dyn"
    dev, HW, NK, D, C = _check_state(fn, h, c, scene, h2g_w, H, W,
                                     prev_ids, parent_rows)
    h2_f, r_p = _gate_inputs_q8dyn_launch(parent_rows, h, scene, NK, H, W, D,
                                          C)
    h_out, c_out = _gate_lstm_q8dyn_launch(fn, quant, cell_b, prev_ids,
                                           parent_rows, h2_f, r_p, c, NK, H,
                                           W, D, forget_bias)
    logits = _readout_launch(h_out, h2g_w, NK, H, W, D)
    decode_step_gathered_q8dyn.launches += 1
    return h_out, c_out, logits


decode_step_gathered_q8dyn.launches = 0
