"""Conv layers with the JAX package's layouts and inits.

PyTorch port of ``multiverse_tpu/ops/layers.py`` (``get_activation``,
``init_conv``, ``conv2d``, ``l2_weight_decay``, and the layer extras
``init_linear``, ``linear``, ``exp_mask``, ``softsel``,
``focal_attention`` and ``group_norm``, which the model does not call:
they are the reference's layer inventory, dead code there too).
Activations are NHWC and kernels HWIO at every public function, as in
the JAX package; ``conv2d`` permutes to PyTorch's NCHW/OIHW inside.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]

# variance_scaling(2.0, "fan_in", "truncated_normal"): the stddev of a
# unit normal truncated to [-2, 2] is this constant
_TRUNC_STD = 0.87962566103423978


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """reference: code/pred_utils.py:86-94 (unknown names -> relu)."""
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, 0.01)
    if name == "tanh":
        return torch.tanh
    if name in ("identity", "linear", "none"):
        return lambda x: x
    return torch.relu


def init_conv(generator: torch.Generator, in_ch: int, out_ch: int,
              kernel: int = 3,
              add_bias: bool = True) -> Dict[str, torch.Tensor]:
    """Conv params: ``w`` [k, k, in, out] (HWIO), variance-scaling
    truncated normal (scale 2, fan in); ``b`` zeros."""
    std = math.sqrt(2.0 / (kernel * kernel * in_ch)) / _TRUNC_STD
    w = torch.empty((kernel, kernel, in_ch, out_ch), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                generator=generator)
    p = {"w": w}
    if add_bias:
        p["b"] = torch.zeros(out_ch, dtype=torch.float32)
    return p


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """XLA ``SAME`` padding of one spatial dim as (before, after): the
    total is split with the odd element AFTER, so a stride-2 3x3 conv
    over an even size pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(w: torch.Tensor, x: torch.Tensor, stride: int,
              dtype: torch.dtype) -> torch.Tensor:
    """The SAME-padded NHWC conv of ``x`` with the HWIO kernel ``w``,
    both cast to ``dtype``, no bias; the output in ``dtype``."""
    kh, kw = w.shape[0], w.shape[1]
    xt = x.to(dtype).permute(0, 3, 1, 2)
    pad_h = same_padding(xt.shape[2], kh, stride)
    pad_w = same_padding(xt.shape[3], kw, stride)
    xt = F.pad(xt, (*pad_w, *pad_h))
    out = F.conv2d(xt, w.to(dtype).permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1)


def conv2d(
    params: Params,
    x: torch.Tensor,
    stride: int = 1,
    activation: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """SAME-padded NHWC conv with an HWIO kernel; returns f32 after the
    activation. ``compute_dtype`` casts input and weights and keeps the
    conv output, bias add and activation in that type, like the JAX
    package's bf16 path. A kernel that is a tensor-parallel block (it
    carries a ``shard``, ``multiverse_torch.parallel.tensor``) computes
    its block with the model ranks' collectives."""
    shard = getattr(params["w"], "shard", None)
    if shard is not None:
        return shard.conv2d(params, x, stride, activation, compute_dtype)
    dtype = compute_dtype or torch.float32
    out = conv_nhwc(params["w"], x, stride, dtype)
    if "b" in params:
        out = out + params["b"].to(dtype)
    if activation is not None:
        out = activation(out)
    return out.float()


def init_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                add_bias: bool = False) -> Dict[str, torch.Tensor]:
    """Dense params: ``w`` [in, out] a unit normal truncated to [-2, 2]
    times 0.1; ``b`` zeros when ``add_bias``."""
    w = torch.empty((in_dim, out_dim), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    p = {"w": w * 0.1}
    if add_bias:
        p["b"] = torch.zeros(out_dim, dtype=torch.float32)
    return p


def linear(params: Params, x: torch.Tensor,
           activation: Optional[Callable] = None) -> torch.Tensor:
    """Fully connected over the last axis, f32 (reference:
    pred_models.py:1404-1447)."""
    out = torch.einsum("...i,io->...o", x, params["w"])
    if "b" in params:
        out = out + params["b"]
    if activation is not None:
        out = activation(out)
    return out


def exp_mask(val: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Additive -1e30 masking (reference: code/pred_models.py:1399-1401)."""
    return val + (1.0 - mask.to(val.dtype)) * -1e30


def softsel(target: torch.Tensor, logits: torch.Tensor,
            use_sigmoid: bool = False) -> torch.Tensor:
    """Soft selection: ``target``'s second-to-last axis weighted by the
    softmax (or sigmoid) of ``logits`` and summed out (reference:
    code/pred_models.py:1376-1396). target [..., M, d], logits [..., M]
    -> [..., d]."""
    weights = (torch.sigmoid(logits) if use_sigmoid
               else torch.softmax(logits, dim=-1))
    return torch.sum(target * weights[..., None], dim=-2)


def focal_attention(query: torch.Tensor, context: torch.Tensor,
                    use_sigmoid: bool = False) -> torch.Tensor:
    """Two-level focal attention, the JAX package's cosine-similarity
    form of reference: code/pred_models.py:1451-1497: attend over time
    within each channel by its similarity to the query, then over the
    channels by each channel's best similarity. query [N, d], context
    [N, K, T, d] -> [N, d]."""

    def l2n(x):
        s = torch.sum(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(torch.clamp_min(s, 1e-12))

    sim = torch.sum(l2n(query)[:, None, None, :] * l2n(context), dim=-1)
    per_channel = softsel(context, sim, use_sigmoid)          # [N, K, d]
    return softsel(per_channel, sim.amax(dim=2), use_sigmoid)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC (reference: code/pred_models.py:1511-1633, the
    ``--use_gn`` normalisation), the population variance per group."""
    n, h, w, c = x.shape
    g = min(num_groups, c)
    xg = x.reshape(n, h, w, g, c // g)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return xg.reshape(n, h, w, c) * scale + bias


def _named_leaves(params, prefix: str = ""):
    """(dotted name, tensor) of every leaf of a :class:`Multiverse`
    module or a nested mapping of tensors, in name order."""
    if hasattr(params, "named_parameters"):
        return sorted(params.named_parameters(), key=lambda kv: kv[0])
    out = []
    for k in sorted(params):
        v = params[k]
        name = prefix + k
        if isinstance(v, torch.Tensor):
            out.append((name, v))
        else:
            out.extend(_named_leaves(v, name + "."))
    return out


def l2_weight_decay(params, wd: float) -> torch.Tensor:
    """0.5 * wd * sum ||w||^2 over every leaf named ``w`` (tf.nn.l2_loss
    over the reference's ``.*/W`` selection); ConvLSTM kernels are named
    ``kernel`` and excluded, as in the reference. The squares of
    tensor-parallel blocks are summed over their model ranks."""
    leaves = _named_leaves(params)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0][1].device)
    blocks, shard = torch.zeros_like(total), None
    for name, leaf in leaves:
        if name.rsplit(".", 1)[-1] == "w":
            square = 0.5 * torch.sum(torch.square(leaf.float()))
            if getattr(leaf, "shard", None) is None:
                total = total + square
            else:
                blocks, shard = blocks + square, leaf.shard
    if shard is not None:
        total = total + shard.reduce(blocks)
    return total * wd
