"""ConvLSTM cell with tf.contrib.rnn.ConvLSTMCell gate semantics.

PyTorch port of ``multiverse_tpu/ops/convlstm.py``:

    gates = conv2d(concat([x, h], -1), kernel) + bias   # 3x3 SAME
    i, g, f, o = split(gates, 4, -1)
    c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(g)
    h' = tanh(c') * sigmoid(o)

On the reduced-precision path the gates and the carried state are
stored in the compute dtype, as in the JAX package. Train-time input
dropout (:func:`input_dropout`) draws from an explicit
``torch.Generator``; the two frameworks' random streams differ, so only
its statistics match the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from multiverse_torch.ops.layers import Params, conv_nhwc


def dropout_mask(generator: torch.Generator, shape, keep_prob: float,
                 device) -> torch.Tensor:
    """Bool keep-mask of ``shape``, each entry True with probability
    ``keep_prob``, drawn from ``generator`` (on ``device``)."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def apply_dropout(x: torch.Tensor, keep: torch.Tensor,
                  keep_prob: float) -> torch.Tensor:
    return torch.where(keep, x * (1.0 / keep_prob),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def input_dropout(generator: torch.Generator, x: torch.Tensor,
                  keep_prob: float) -> torch.Tensor:
    """Inverted dropout on a cell input (tf.nn.dropout semantics): each
    entry is kept with probability ``keep_prob`` and scaled by
    1/keep_prob. Every call draws a fresh mask from ``generator``, so one
    generator per site gives a fresh mask per step, as the reference's
    non-variational DropoutWrapper does."""
    return apply_dropout(
        x, dropout_mask(generator, x.shape, keep_prob, x.device), keep_prob)


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
    """One cell step. x: [N, H, W, Cin]; state c/h: [N, H, W, D].

    A kernel that is a tensor-parallel block (it carries a ``shard``,
    ``multiverse_torch.parallel.tensor``) holds D/mp hidden channels of
    each gate: the step computes those gates from the whole x and h,
    updates its block of c (which stays the rank's own, [N, H, W, D/mp])
    and gathers h' from the model ranks."""
    c, h = state
    dtype = compute_dtype or torch.float32
    shard = getattr(params["kernel"], "shard", None)
    xin = torch.cat([x, h], dim=-1)
    if shard is not None:
        xin = shard.copy(xin)
    gates = conv_nhwc(params["kernel"], xin, 1, dtype) \
        + params["bias"].to(dtype)
    i, g, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = (torch.sigmoid(f + forget_bias) * c
             + torch.sigmoid(i) * torch.tanh(g))
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    if compute_dtype is not None:
        new_c = new_c.to(compute_dtype)
        new_h = new_h.to(compute_dtype)
    if shard is not None:
        new_h = shard.gather(new_h)
    return new_h, ConvLSTMState(c=new_c, h=new_h)


def convlstm_scan(
    params: Params,
    xs: torch.Tensor,
    seq_lengths: Optional[torch.Tensor] = None,
    forget_bias: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    keep_prob: float = 1.0,
    dropout_rng: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, ConvLSTMState]:
    """Run the cell over time from a zero state. xs: [N, T, H, W, Cin].
    Past an example's ``seq_lengths`` entry its output is zero and its
    state frozen (tf.nn.dynamic_rnn semantics).

    ``remat`` checkpoints each step (``torch.utils.checkpoint``): the
    backward recomputes the gate conv instead of keeping every step's
    residuals. ``keep_prob`` < 1 with a ``dropout_rng`` applies
    :func:`input_dropout` to each step's input; the mask is drawn
    outside the checkpointed step, so the recomputation sees the same
    mask. Returns (outputs [N, T, H, W, D], final state)."""
    dropout = keep_prob < 1.0 and dropout_rng is not None
    N, T, H, W = xs.shape[:4]
    kernel = params["kernel"]
    dtype = compute_dtype or torch.float32
    # c is as wide as the kernel's gates (a tensor-parallel block's own
    # channels), h as its recurrent input
    c = torch.zeros((N, H, W, kernel.shape[-1] // 4), dtype=dtype,
                    device=xs.device)
    h = torch.zeros((N, H, W, kernel.shape[2] - xs.shape[-1]), dtype=dtype,
                    device=xs.device)

    def step(t, x_t, c, h):
        out, new_state = convlstm_step(params, x_t, ConvLSTMState(c=c, h=h),
                                       forget_bias, compute_dtype)
        if seq_lengths is not None:
            active = (t < seq_lengths).reshape(N, 1, 1, 1)
            out = torch.where(active, out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))
            new_state = ConvLSTMState(
                c=torch.where(active, new_state.c, c),
                h=torch.where(active, new_state.h, h))
        return out, new_state.c, new_state.h

    outs = []
    for t in range(T):
        x_t = xs[:, t]
        if dropout:
            x_t = input_dropout(dropout_rng, x_t, keep_prob)
        if remat:
            out, c, h = checkpoint(step, t, x_t, c, h, use_reentrant=False)
        else:
            out, c, h = step(t, x_t, c, h)
        outs.append(out)
    return torch.stack(outs, dim=1), ConvLSTMState(c=c, h=h)
