"""ConvLSTM cell with tf.contrib.rnn.ConvLSTMCell gate semantics.

PyTorch port of ``multiverse_tpu/ops/convlstm.py``:

    gates = conv2d(concat([x, h], -1), kernel) + bias   # 3x3 SAME
    i, g, f, o = split(gates, 4, -1)
    c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(g)
    h' = tanh(c') * sigmoid(o)

On the reduced-precision path the gates and the carried state are
stored in the compute dtype, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from multiverse_torch.ops.layers import Params, same_padding


class ConvLSTMState(NamedTuple):
    c: torch.Tensor  # [N, H, W, D] cell memory
    h: torch.Tensor  # [N, H, W, D] hidden


def convlstm_init(generator: torch.Generator, in_ch: int, hidden_ch: int,
                  kernel: int = 3) -> dict:
    """``kernel`` [k, k, in+hidden, 4*hidden] (glorot uniform), zero
    ``bias``."""
    shape = (kernel, kernel, in_ch + hidden_ch, 4 * hidden_ch)
    fan_in = kernel * kernel * (in_ch + hidden_ch)
    fan_out = kernel * kernel * 4 * hidden_ch
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=torch.float32)
    w.uniform_(-limit, limit, generator=generator)
    return {"kernel": w,
            "bias": torch.zeros(4 * hidden_ch, dtype=torch.float32)}


def convlstm_step(
    params: Params,
    x: torch.Tensor,
    state: ConvLSTMState,
    forget_bias: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, ConvLSTMState]:
    """One cell step. x: [N, H, W, Cin]; state c/h: [N, H, W, D]."""
    c, h = state
    dtype = compute_dtype or torch.float32
    kernel = params["kernel"]
    xin = torch.cat([x, h], dim=-1).to(dtype).permute(0, 3, 1, 2)
    k = kernel.shape[0]
    pad = same_padding(xin.shape[2], k, 1) + same_padding(xin.shape[3], k, 1)
    xin = F.pad(xin, (pad[2], pad[3], pad[0], pad[1]))
    gates = F.conv2d(xin, kernel.to(dtype).permute(3, 2, 0, 1))
    gates = gates.permute(0, 2, 3, 1) + params["bias"].to(dtype)
    i, g, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = (torch.sigmoid(f + forget_bias) * c
             + torch.sigmoid(i) * torch.tanh(g))
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    if compute_dtype is not None:
        new_c = new_c.to(compute_dtype)
        new_h = new_h.to(compute_dtype)
    return new_h, ConvLSTMState(c=new_c, h=new_h)


def convlstm_scan(
    params: Params,
    xs: torch.Tensor,
    seq_lengths: Optional[torch.Tensor] = None,
    forget_bias: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, ConvLSTMState]:
    """Run the cell over time from a zero state. xs: [N, T, H, W, Cin].
    Past an example's ``seq_lengths`` entry its output is zero and its
    state frozen (tf.nn.dynamic_rnn semantics). Returns (outputs
    [N, T, H, W, D], final state)."""
    N, T, H, W = xs.shape[:4]
    D = params["kernel"].shape[-1] // 4
    zeros = torch.zeros((N, H, W, D), dtype=compute_dtype or torch.float32,
                        device=xs.device)
    state = ConvLSTMState(c=zeros, h=zeros)
    outs = []
    for t in range(T):
        out, new_state = convlstm_step(params, xs[:, t], state, forget_bias,
                                       compute_dtype)
        if seq_lengths is not None:
            active = (t < seq_lengths).reshape(N, 1, 1, 1)
            out = torch.where(active, out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))
            new_state = ConvLSTMState(
                c=torch.where(active, new_state.c, state.c),
                h=torch.where(active, new_state.h, state.h))
        state = new_state
        outs.append(out)
    return torch.stack(outs, dim=1), state
