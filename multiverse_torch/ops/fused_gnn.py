"""Grid graph attention with a hand-written backward, for training.

Counterpart of ``multiverse_tpu/ops/pallas_gnn.py``:

* :func:`gnn_step_fused` of ``gnn_step_pallas``: the f32 L2-normalise
  of h (+) scene, cast to h's type, then the attention core;
* :class:`GnnDense` of the ``_gnn_dense`` custom VJP: its forward is K4
  (``_gnn_dense_fwd``), its backward K5 (``_gnn_dense_bwd``), both in
  ``csrc/gnn_dense.cu``. The normalise and concat around it stay plain
  PyTorch under autograd, as they stay plain jnp under JAX's AD; the
  neighbourhood mask gets no gradient.

The wrappers :func:`gnn_dense_fwd` and :func:`gnn_dense_bwd` dispatch
on the device of their tensors: CPU tensors run the plain versions
(``*_ref``, the dense form with the TPU kernels' formulas and rounding
points), CUDA tensors the kernels (built at first use, see
``_build.py``), with no fallback between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multiverse_torch.ops._build import launch
from multiverse_torch.ops.fused_decode import (
    _check_cuda,
    _neighbor_bias,
    _require,
    _softmax,
)

def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    # f32 accumulation, as the TPU kernels; f64 stays f64 (gradcheck)
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _dense_attn(node: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """f32 softmax(node . node^T + mask) per sample: [N, HW, HW]."""
    acc = _acc_dtype(node)
    n = node.reshape(-1, H * W, node.shape[-1]).to(acc)
    edges = n @ n.transpose(1, 2) + _neighbor_bias(H, W, node.device).to(acc)
    return _softmax(edges)


def gnn_dense_fwd_ref(node: torch.Tensor, states: torch.Tensor, H: int,
                      W: int) -> torch.Tensor:
    """Plain version of K4 (``_gnn_kernel``): node [N*HW, Dn] (L2-
    normalised rows), states [N*HW, Ds] -> [N*HW, Ds] f32 (f64 for f64
    inputs). The weights are rounded to the states' type before the
    aggregation, which accumulates in f32."""
    acc = _acc_dtype(node)
    attn = _dense_attn(node, H, W).to(states.dtype).to(acc)
    s = states.reshape(-1, H * W, states.shape[-1]).to(acc)
    return (attn @ s).reshape(-1, states.shape[-1])


def gnn_dense_bwd_ref(node: torch.Tensor, states: torch.Tensor,
                      g: torch.Tensor, H: int,
                      W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5 (``_gnn_bwd_kernel``): recomputes attn, then
    dstates = attn^T g, dattn = g states^T, dedges = attn * (dattn -
    rowsum(dattn * attn)), dnode = (dedges + dedges^T) node. g and the
    weights are rounded to the states' type for the two products,
    dedges + dedges^T to the node's type; every product accumulates in
    f32. Returns (dnode, dstates) in the types of node and states."""
    acc = _acc_dtype(node)
    HW = H * W
    attn = _dense_attn(node, H, W)
    n = node.reshape(-1, HW, node.shape[-1]).to(acc)
    s = states.reshape(-1, HW, states.shape[-1]).to(acc)
    g_c = g.reshape(-1, HW, states.shape[-1]).to(states.dtype).to(acc)
    dstates = attn.to(states.dtype).to(acc).transpose(1, 2) @ g_c
    dattn = g_c @ s.transpose(1, 2)
    dedges = attn * (dattn - torch.sum(dattn * attn, dim=-1, keepdim=True))
    sym = (dedges + dedges.transpose(1, 2)).to(node.dtype).to(acc)
    dnode = sym @ n
    return (dnode.to(node.dtype).reshape(node.shape),
            dstates.to(states.dtype).reshape(states.shape))


def _check(fn: str, node, states, H, W):
    dev = node.device
    NHW, Dn = node.shape
    Ds = states.shape[-1]
    if dev.type != "cuda" or NHW % (H * W) or Dn % 2 or Ds % 2:
        # the messages are formatted only for a check that fails
        _require(dev.type == "cuda", fn, f"unsupported device {dev}")
        _require(NHW % (H * W) == 0, fn,
                 "node rows must be a multiple of H*W")
        _require(Dn % 2 == 0 and Ds % 2 == 0, fn,
                 f"widths Dn={Dn}, Ds={Ds} must be even")
    bf = torch.bfloat16
    _check_cuda(fn, "node", node, bf, (NHW, Dn), dev)
    _check_cuda(fn, "states", states, bf, (NHW, Ds), dev)
    return dev, NHW // (H * W), Dn, Ds


def gnn_dense_fwd(node: torch.Tensor, states: torch.Tensor, H: int,
                  W: int) -> torch.Tensor:
    """K4: softmax(node . node^T + mask) . states per sample, [N*HW, Ds]
    f32. CPU tensors run :func:`gnn_dense_fwd_ref`; CUDA tensors the
    kernel, which takes bf16 node and states, contiguous, and raises on
    anything else. ``gnn_dense_fwd.launches`` counts kernel launches."""
    if node.device.type == "cpu":
        return gnn_dense_fwd_ref(node, states, H, W)
    fn = "gnn_dense_fwd"
    dev, N, Dn, Ds = _check(fn, node, states, H, W)
    out = torch.empty((node.shape[0], Ds), dtype=torch.float32, device=dev)
    launch(fn, node.data_ptr(), states.data_ptr(), out.data_ptr(), N, H, W,
           Dn, Ds, device=dev)
    gnn_dense_fwd.launches += 1
    return out


gnn_dense_fwd.launches = 0


def gnn_dense_bwd(node: torch.Tensor, states: torch.Tensor, g: torch.Tensor,
                  H: int, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (dnode, dstates) of :func:`gnn_dense_fwd` for the f32
    cotangent ``g``. CPU tensors run :func:`gnn_dense_bwd_ref`; CUDA
    tensors the kernel's two launches (bf16 node and states, f32 g, all
    contiguous). ``gnn_dense_bwd.launches`` counts kernel launches."""
    if node.device.type == "cpu":
        return gnn_dense_bwd_ref(node, states, g, H, W)
    fn = "gnn_dense_bwd"
    dev, N, Dn, Ds = _check(fn, node, states, H, W)
    _check_cuda(fn, "g", g, torch.float32, tuple(states.shape), dev)
    NHW = node.shape[0]
    # between the two launches: attn and dedges, [N*HW, 9] f32 each, and
    # bf16(g)
    scratch = torch.empty((2, NHW, 9), dtype=torch.float32, device=dev)
    g_c = torch.empty_like(states)
    dnode = torch.empty_like(node)
    dstates = torch.empty_like(states)
    launch(fn, node.data_ptr(), states.data_ptr(), g.data_ptr(),
           scratch.data_ptr(), scratch.data_ptr() + NHW * 9 * 4,
           g_c.data_ptr(), dnode.data_ptr(), dstates.data_ptr(), N, H, W, Dn,
           Ds, device=dev)
    gnn_dense_bwd.launches += 1
    return dnode, dstates


gnn_dense_bwd.launches = 0


class GnnDense(torch.autograd.Function):
    """Dense masked attention on pre-normalised node rows:
    softmax(node . node^T + mask) . states, differentiable with respect
    to node and states through K5."""

    @staticmethod
    def forward(ctx, node, states, H, W):
        ctx.save_for_backward(node, states)
        ctx.grid = (H, W)
        return gnn_dense_fwd(node, states, H, W)

    @staticmethod
    def backward(ctx, g):
        node, states = ctx.saved_tensors
        # autograd hands the cotangent over in any layout
        g = g.to(_acc_dtype(node)).contiguous()
        dnode, dstates = gnn_dense_bwd(node, states, g, *ctx.grid)
        return dnode, dstates, None, None


def normalised_node(hidden: torch.Tensor,
                    scene_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attention core's node rows: h (+) scene, L2-normalised in f32
    (the squared norm clamped at 1e-12) and cast to h's type, as
    ``gnn_step_pallas`` builds them. [N, H, W, D (+ C)]."""
    node = hidden if scene_feat is None else torch.cat(
        [hidden, scene_feat.to(hidden.dtype)], dim=-1)
    node = node.to(_acc_dtype(hidden))
    sumsq = torch.sum(node * node, dim=-1, keepdim=True)
    return (node * torch.rsqrt(torch.clamp_min(sumsq, 1e-12))).to(hidden.dtype)


def gnn_step_fused(hidden: torch.Tensor,
                   scene_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, H, W, D] hidden (and [N, H, W, C] scene features) -> [N, H,
    W, D] f32 aggregated neighbour states (the caller adds them to h)
    over :func:`normalised_node`'s rows."""
    N, H, W, D = hidden.shape
    node = normalised_node(hidden, scene_feat)
    out = GnnDense.apply(node.reshape(N * H * W, -1).contiguous(),
                         hidden.reshape(N * H * W, D).contiguous(), H, W)
    return out.reshape(N, H, W, D)
