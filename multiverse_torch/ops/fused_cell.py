"""Fused ConvLSTM cell step: the 3x3 SAME gate conv over [x (+) h] into
f32 gates, then the LSTM update, bf16 in and out.

Counterpart of ``multiverse_tpu/ops/pallas_cell.py``'s
``convlstm_step_pallas`` (K6). On the card it is K1's implicit-GEMM gate
launch (``csrc/gate_wgmma.cuh``, through ``mv_gate_lstm``) with x as the
per-row first operand, h unchanged (no attention) and c read from the
same row, so the gates stay in registers and never reach device
memory. Like the JAX package, nothing wires it into ``convlstm_scan``:
the composed :func:`~multiverse_torch.ops.convlstm.convlstm_step` stores
bf16 gates, this step keeps them in f32, and which the scans should run
is a later decision.

CPU tensors go to the plain PyTorch version, CUDA tensors to the kernel
(built at first use, see ``_build.py``); there is no fallback between the
two.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from multiverse_torch.ops.convlstm import ConvLSTMState
from multiverse_torch.ops.fused_decode import (
    _check_cuda,
    _gate_launch,
    _gate_weights,
    _im2col9,
    _lstm_update,
    _require,
)
from multiverse_torch.ops.gate_layout import GateWeights


def convlstm_step_fused_ref(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,             # [N, H, W, Cx]
    state: ConvLSTMState,        # c, h [N, H, W, D]
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, ConvLSTMState]:
    """Plain version of K6 (``_cell_kernel``): bf16 x, h, c and kernel,
    f32 gates (products summed in f32, then + bias), the LSTM update in
    f32, bf16 h' and c'. Returns (h', ConvLSTMState(c', h'))."""
    bf = torch.bfloat16
    N, H, W, _ = x.shape
    D = state.h.shape[-1]
    xin = torch.cat([x.to(bf), state.h.to(bf)], dim=-1)
    w = params["kernel"].to(bf).reshape(-1, 4 * D).float()
    gates = _im2col9(xin).float() @ w + params["bias"].float().reshape(1, -1)
    new_c, new_h = _lstm_update(gates, state.c.to(bf), forget_bias)
    h_out = new_h.to(bf).reshape(N, H, W, D)
    c_out = new_c.to(bf).reshape(N, H, W, D)
    return h_out, ConvLSTMState(c=c_out, h=h_out)


def convlstm_step_fused(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    state: ConvLSTMState,
    forget_bias: float = 1.0,
    weights: Optional[GateWeights] = None,
) -> Tuple[torch.Tensor, ConvLSTMState]:
    """K6: one fused ConvLSTM cell step (see :func:`convlstm_step_fused_ref`),
    bf16 in and out as the TPU kernel's wrapper casts. CPU tensors run
    the plain version; CUDA tensors run the kernel, which needs
    Cx % 8 == 0 and D % 32 == 0 and every operand on the same card, and
    raises otherwise. ``weights`` is ``prepare_gate_weights`` of the
    bf16 kernel [9*(Cx+D), 4D] with E = Cx, or made per call.
    ``convlstm_step_fused.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return convlstm_step_fused_ref(params, x, state, forget_bias)
    fn = "convlstm_step_fused"
    dev = x.device
    N, H, W, Cx = x.shape
    D = state.h.shape[-1]
    M = N * H * W
    bf = torch.bfloat16
    _require(dev.type == "cuda", fn, f"unsupported device {dev}")
    _require(Cx % 8 == 0, fn, f"Cx={Cx} must be a multiple of 8")
    _require(D % 32 == 0, fn, f"D={D} must be a multiple of 32")
    x_rows = x.to(bf).reshape(M, Cx).contiguous()
    h_rows = state.h.to(bf).reshape(M, D).contiguous()
    c_rows = state.c.to(bf).reshape(M, D).contiguous()
    b = params["bias"].float().reshape(-1).contiguous()
    _check_cuda(fn, "h", h_rows, bf, (M, D), dev)
    _check_cuda(fn, "c", c_rows, bf, (M, D), dev)
    w = None if weights is not None else \
        params["kernel"].to(bf).reshape(-1, 4 * D).contiguous()
    weights = _gate_weights(fn, w, b, weights, Cx, D, dev, "kernel")
    h_out, c_out = _gate_launch(weights, b, None, None, x_rows, h_rows, c_rows,
                                N, H, W, D, forget_bias)
    h_out, c_out = h_out.reshape(N, H, W, D), c_out.reshape(N, H, W, D)
    convlstm_step_fused.launches += 1
    return h_out, ConvLSTMState(c=c_out, h=h_out)


convlstm_step_fused.launches = 0
