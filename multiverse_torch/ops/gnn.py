"""Graph attention over grid cells ("GNN" in the reference).

PyTorch port of ``multiverse_tpu/ops/gnn.py``. The parameter-free
graph step runs on the decoder hidden state every decode step:

1. node features = h, optionally (+) the time-averaged scene features;
2. edge weights = cosine similarity between cells (l2-normalise, dot);
3. mask to the 3x3 spatial neighbourhood with a -1e30 fill;
4. node update = softmax-weighted sum of neighbour states (the caller
   adds it residually).

Activations are NHWC, as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=16)
def gnn_neighbor_mask(h: int, w: int) -> np.ndarray:
    """[h*w, h*w] float32; mask[a, b] = 1 if cell b is within the 3x3
    neighbourhood of cell a (self included)."""
    ys, xs = np.divmod(np.arange(h * w), w)
    dy = np.abs(ys[:, None] - ys[None, :])
    dx = np.abs(xs[:, None] - xs[None, :])
    return ((dy <= 1) & (dx <= 1)).astype(np.float32)


def _l2_normalize(node: torch.Tensor) -> torch.Tensor:
    # tf.nn.l2_normalize: x / sqrt(max(sum(x^2), 1e-12))
    sumsq = torch.sum(node * node, dim=-1, keepdim=True)
    return node * torch.rsqrt(torch.clamp_min(sumsq, 1e-12))


def gnn_step(
    hidden: torch.Tensor,
    neighbor_mask: torch.Tensor,
    scene_feat: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Dense form: [N, H, W, D] hidden -> [N, H, W, D] aggregated
    neighbour states. ``neighbor_mask`` is :func:`gnn_neighbor_mask`
    as a tensor. Both matmuls accumulate in f32."""
    N, H, W, D = hidden.shape
    K = H * W
    states = hidden.reshape(N, K, D)
    node = states
    if scene_feat is not None:
        node = torch.cat([states, scene_feat.reshape(N, K, -1)], dim=-1)
    node = _l2_normalize(node)
    if compute_dtype is not None:
        node = node.to(compute_dtype)
        states = states.to(compute_dtype)
    node = node.float()
    edges = node @ node.transpose(1, 2)
    edges = edges + (1.0 - neighbor_mask.to(edges.device)) * -1e30
    attn = torch.softmax(edges, dim=-1)
    if compute_dtype is not None:
        attn = attn.to(compute_dtype)
    agg = attn.float() @ states.float()
    return agg.reshape(N, H, W, D)


def gnn_step_auto(
    hidden: torch.Tensor,
    scene_feat: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
    allow_pallas: bool = True,
) -> torch.Tensor:
    """Dispatch of ``multiverse_tpu/ops/gnn.py:gnn_step_auto``: on the
    bf16 path with CUDA tensors the attention runs K4 with its backward
    K5 (:func:`~multiverse_torch.ops.fused_gnn.gnn_step_fused`, which
    also normalises the node rows in f32); everywhere else the exact
    9-neighbour form, as the JAX package does off the TPU.
    ``allow_pallas`` is ``cfg.allow_pallas`` (the name is the JAX
    package's)."""
    if (allow_pallas and compute_dtype == torch.bfloat16
            and hidden.device.type == "cuda"):
        from multiverse_torch.ops.fused_gnn import gnn_step_fused

        return gnn_step_fused(
            hidden.to(compute_dtype),
            None if scene_feat is None else scene_feat.to(compute_dtype))
    return gnn_step_neighbors(hidden, scene_feat, compute_dtype=compute_dtype)


def gnn_step_neighbors(
    hidden: torch.Tensor,
    scene_feat: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Exact 3x3-neighbourhood form of :func:`gnn_step`: a masked
    softmax over all cells where at most 9 survive is a softmax over the
    9 spatial neighbours, so only those similarities are computed."""
    N, H, W, D = hidden.shape
    node = hidden
    if scene_feat is not None:
        node = torch.cat([hidden, scene_feat], dim=-1)
    node = _l2_normalize(node)
    states = hidden
    if compute_dtype is not None:
        node = node.to(compute_dtype)
        states = states.to(compute_dtype)

    node_p = F.pad(node, (0, 0, 1, 1, 1, 1))
    states_p = F.pad(states, (0, 0, 1, 1, 1, 1))
    sims, neigh, valid = [], [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = node_p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W, :]
            sims.append(torch.sum(node.float() * nb.float(), dim=-1))
            neigh.append(states_p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W, :])
            vy = np.zeros((H, W), np.float32)
            vy[max(0, -dy):H - max(0, dy), max(0, -dx):W - max(0, dx)] = 1
            valid.append(vy)
    sims = torch.stack(sims, dim=-1)                          # [N, H, W, 9]
    valid = torch.from_numpy(np.stack(valid, axis=-1)).to(sims.device)
    attn = torch.softmax(sims + (1.0 - valid) * -1e30, dim=-1)
    if compute_dtype is not None:
        attn = attn.to(compute_dtype)
    agg = sum(attn[..., i:i + 1] * neigh[i] for i in range(9))
    return agg.float() if compute_dtype is not None else agg
