"""Fused beam decode step: GNN attention + ConvLSTM cell + class readout.

Counterpart of the TPU kernel
``multiverse_tpu/ops/pallas_decode.py:decode_step_pallas_gathered``.
One call advances every beam row by one step, reading its parent's
state and its previous cell's embedding row through ``parent_rows``
and ``prev_ids``, so the beam reorder costs no separate gather.

:func:`decode_step_gathered` dispatches on the device of its tensors:
CPU tensors go to the plain PyTorch version
:func:`decode_step_gathered_ref`, CUDA tensors to the hand-written
kernels of ``multiverse_torch/csrc/fused_decode.cu`` (built at first
use, see ``_build.py``). There is no fallback between the two.
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

    node = hp if scene is None else torch.cat(
        [hp, scene.reshape(NK, HW, -1).to(dt)], dim=-1)
    node = node.float()
    sumsq = torch.sum(node * node, dim=-1, keepdim=True)
    node = (node * torch.rsqrt(torch.clamp_min(sumsq, 1e-12))).to(dt).float()
    edges = node @ node.transpose(1, 2) + _neighbor_bias(H, W, h.device)
    attn = torch.softmax(edges, dim=-1).to(dt)
    agg = attn.float() @ hp.float()
    h2 = (hp.float() + agg).to(dt)

    patches = _im2col9(torch.cat([emb, h2], dim=-1).reshape(NK, H, W, -1))
    gates = patches.float() @ cell_w.float() + cell_b.float().reshape(1, -1)
    i, g, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = (torch.sigmoid(f + forget_bias) * cp.reshape(-1, D).float()
             + torch.sigmoid(i) * torch.tanh(g))
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    h_out, c_out = new_h.to(dt), new_c.to(dt)

    # channel-first readout: P[q, s] = h'[q] . w[:, s], then the conv is
    # nine spatially shifted single-channel sums
    P = (h_out.float() @ h2g_w[:, :9].float()).reshape(NK, H, W, 9)
    Pp = F.pad(P, (0, 0, 1, 1, 1, 1))
    logits = sum(Pp[:, dy:dy + H, dx:dx + W, 3 * dy + dx]
                 for dy in range(3) for dx in range(3))
    return h_out, c_out, logits.reshape(NK * HW, 1)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError("decode_step_gathered: " + msg)


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                shape: tuple, device: torch.device) -> None:
    _require(t.device == device, f"{name} on {t.device}, expected {device}")
    _require(t.dtype == dtype, f"{name} is {t.dtype}, expected {dtype}")
    _require(tuple(t.shape) == shape,
             f"{name} has shape {tuple(t.shape)}, expected {shape}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


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
    _require(h.device.type == "cuda", f"unsupported device {h.device}")
    from multiverse_torch.ops._build import check, load_library

    dev = h.device
    HW = H * W
    NK = prev_ids.shape[0]
    D = h.shape[-1]
    E = emb_table.shape[-1]
    Cin = E + D
    C = 0 if scene is None else scene.shape[-1]
    bf, i32 = torch.bfloat16, torch.int32
    _require(D % 32 == 0 and D <= 1024,
             f"D={D} must be a multiple of 32, at most 1024")
    _require(E % 8 == 0, f"E={E} must be a multiple of 8")
    _require(C % 2 == 0, f"C={C} must be even")
    _require(h.shape[0] % HW == 0, "h rows must be a multiple of H*W")
    _check_cuda("prev_ids", prev_ids, i32, (NK,), dev)
    _check_cuda("parent_rows", parent_rows, i32, (NK,), dev)
    _check_cuda("h", h, bf, (h.shape[0], D), dev)
    _check_cuda("c", c, bf, tuple(h.shape), dev)
    _check_cuda("emb_table", emb_table, bf, (HW, HW, E), dev)
    _check_cuda("cell_w", cell_w, bf, (9 * Cin, 4 * D), dev)
    _check_cuda("cell_b", cell_b, torch.float32, (4 * D,), dev)
    _require(h2g_w.dim() == 2 and h2g_w.shape[1] >= 9,
             f"h2g_w has shape {tuple(h2g_w.shape)}, expected [D, >=9]")
    _check_cuda("h2g_w", h2g_w, bf, (D, h2g_w.shape[1]), dev)
    if scene is not None:
        _check_cuda("scene", scene, bf, (NK * HW, C), dev)

    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    h2 = torch.empty((NK * HW, D), dtype=bf, device=dev)
    h_out = torch.empty((NK * HW, D), dtype=bf, device=dev)
    c_out = torch.empty((NK * HW, D), dtype=bf, device=dev)
    logits = torch.empty((NK * HW, 1), dtype=torch.float32, device=dev)
    check(lib, lib.mv_gnn_attention(
        parent_rows.data_ptr(), h.data_ptr(),
        None if scene is None else scene.data_ptr(), h2.data_ptr(),
        NK, H, W, D, C, stream), "gnn_attention")
    check(lib, lib.mv_gate_lstm(
        prev_ids.data_ptr(), parent_rows.data_ptr(), emb_table.data_ptr(),
        h2.data_ptr(), c.data_ptr(), cell_w.data_ptr(), cell_b.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(), NK, H, W, D, E,
        float(forget_bias), stream), "gate_lstm")
    check(lib, lib.mv_class_readout(
        h_out.data_ptr(), h2g_w.data_ptr(), h2g_w.shape[1],
        logits.data_ptr(), NK, H, W, D, stream), "class_readout")
    decode_step_gathered.launches += 1
    return h_out, c_out, logits


decode_step_gathered.launches = 0
