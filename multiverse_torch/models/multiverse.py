"""The Multiverse model: scene CNN + ConvLSTM encoders + ConvLSTM decoders
over coarse spatial grids.

PyTorch port of ``multiverse_tpu/models/multiverse.py`` for inference:
``init_params``, ``scene_encode`` and ``greedy_decode`` (composed, or
for the class decode at inference through the fused decode step).
The parameters live in a :class:`Multiverse` module whose names follow
the JAX parameter tree (``scene_conv1.w``, ``scales.0.dec_class.kernel``,
...); the functions take any nested mapping of tensors with that layout,
so a :class:`Multiverse` or a plain dict of dicts both work.
"""

from __future__ import annotations

from typing import List, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from multiverse_torch.config import MultiverseConfig
from multiverse_torch.geometry import one_hot_grid
from multiverse_torch.ops import (
    ConvLSTMState,
    conv2d,
    convlstm_init,
    convlstm_step,
    gnn_step_neighbors,
    init_conv,
    make_decode_step,
)
from multiverse_torch.ops.layers import get_activation


class Batch(NamedTuple):
    """One device batch (see ``multiverse_tpu.models.Batch``)."""

    obs_grid_class: torch.Tensor       # [N, S, T_obs] int32 flat cell ids
    obs_grid_target_all: Tuple[torch.Tensor, ...]  # per scale [N,T_obs,h,w,2]
    obs_scene: torch.Tensor            # [N, T_obs] int32 -> scene_feat rows
    scene_feat: torch.Tensor           # [F, SH, SW, C] one-hot masks
    pred_length: Optional[torch.Tensor] = None   # [N] int32 (beam decode)


# --------------------------------------------------------------- params


def init_params(cfg: MultiverseConfig, generator: torch.Generator) -> dict:
    """The full parameter tree, drawn from ``generator``: the same names
    and shapes as the JAX ``init_params`` (different numbers: the two
    frameworks' generators differ)."""
    cfg.validate()
    k = cfg.convlstm_kernel
    D = cfg.enc_hidden_size
    params: dict = {}
    if cfg.use_scene_enc:
        in_ch = cfg.scene_class
        for i in range(cfg.num_scales):
            params[f"scene_conv{i + 1}"] = init_conv(
                generator, in_ch, cfg.scene_conv_dim, cfg.scene_conv_kernel)
            in_ch = cfg.scene_conv_dim

    scales: dict = {}
    for i in cfg.active_scales:
        enc_in = cfg.scene_conv_dim if cfg.use_scene_enc else cfg.emb_size
        s: dict = {
            "enc_class": convlstm_init(generator, enc_in, D, k),
            "enc_reg": convlstm_init(generator, 2, D, k),
            "dec_class": convlstm_init(generator, cfg.emb_size, D, k),
            "dec_class_emb": init_conv(generator, 1, cfg.emb_size, 3),
            "h2g_class": init_conv(generator, D, 1, 3, add_bias=False),
        }
        if not cfg.use_scene_enc:
            s["enc_grid_emb"] = init_conv(generator, 1, cfg.emb_size, 3)
        if cfg.use_single_decoder:
            s["h2g_single"] = init_conv(generator, D, 2, 3, add_bias=False)
        else:
            s["dec_reg"] = convlstm_init(generator, cfg.emb_size, D, k)
            s["dec_reg_emb"] = init_conv(generator, 2, cfg.emb_size, 3)
            s["h2g_reg"] = init_conv(generator, D, 2, 3, add_bias=False)
        scales[str(i)] = s
    params["scales"] = scales
    return params


def _wrap(tree: Mapping) -> nn.Module:
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})
    return nn.ModuleDict({k: _wrap(v) for k, v in tree.items()})


class Multiverse(nn.Module):
    """Holds a parameter tree; ``model["scales"]["0"]["dec_class"]`` is
    the same sub-tree as in the JAX package, and ``named_parameters``
    gives its '.'-joined names."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, sub in tree.items():
            self.add_module(name, _wrap(sub))

    def __getitem__(self, name: str):
        return self._modules[name]

    @classmethod
    def init(cls, cfg: MultiverseConfig, seed: int = 0,
             device=None) -> "Multiverse":
        """Seeded random weights (``torch.Generator`` with ``seed``)."""
        gen = torch.Generator().manual_seed(seed)
        return cls(init_params(cfg, gen)).to(device)


# --------------------------------------------------------------- scene CNN


def scene_encode(
    params,
    scene_feat: torch.Tensor,
    obs_scene: torch.Tensor,
    cfg: MultiverseConfig,
    compute_dtype: Optional[torch.dtype] = None,
) -> List[torch.Tensor]:
    """Strided conv pyramid over per-timestep one-hot semantic maps; one
    [N, T, h_i, w_i, scene_conv_dim] feature map per grid scale."""
    act = get_activation(cfg.activation)
    N, T = obs_scene.shape
    x = scene_feat[obs_scene.reshape(-1).long()]          # [N*T, SH, SW, C]
    x = x.to(compute_dtype or torch.float32)
    if cfg.norm_input:
        x = x * 2.0 - 1.0
    outs = []
    feats = x
    for i in range(cfg.num_scales):
        feats = conv2d(params[f"scene_conv{i + 1}"], feats, stride=2,
                       activation=act, compute_dtype=compute_dtype)
        h, w = cfg.scene_grids[i]
        if tuple(feats.shape[1:3]) != (h, w):
            raise ValueError(
                f"scene conv pyramid shape {tuple(feats.shape[1:3])} != grid "
                f"{(h, w)} at scale {i}; use strides like (2, 4)")
        outs.append(feats.reshape(N, T, h, w, cfg.scene_conv_dim))
    return outs


# --------------------------------------------------------------- decoder


def greedy_decode(
    scale_params,
    cfg: MultiverseConfig,
    first_input: torch.Tensor,       # [N, h, w, P]
    init_state: ConvLSTMState,       # from the encoder
    T_pred: int,
    emb_name: str,
    cell_name: str,
    h2g_name: str,
    use_gnn: bool,
    scene_mean: Optional[torch.Tensor] = None,   # [N, h, w, Cc]
    feedback: str = "onehot",        # onehot | raw
    compute_dtype: Optional[torch.dtype] = None,
    allow_fused: bool = False,       # the fused decode step (inference)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive ConvLSTM decode: per step an optional GNN residual
    on h, the 3x3 embedding of the input, a ConvLSTM step and the
    hidden-to-grid readout; the next input is the argmax one-hot
    ("onehot") or the readout itself ("raw"). Returns (readouts
    [N, T, h, w, P], hidden states [N, T, h, w, D]).

    With ``allow_fused`` the bf16 argmax class decode with the GNN on
    runs the fused decode step instead (K1, or K2/K3 under
    ``cfg.decode_quant``), as ``multiverse_tpu`` does: it carries the
    argmax cell id, looks its embedding up in a table of every cell's
    embedding, and passes identity parents."""
    if feedback not in ("onehot", "raw"):
        raise ValueError(f"feedback must be onehot|raw, got {feedback!r}")
    act = get_activation(cfg.activation)
    emb_p = scale_params[emb_name]
    cell_p = scale_params[cell_name]
    h2g_p = scale_params[h2g_name]
    if (allow_fused and cfg.allow_pallas and feedback == "onehot"
            and use_gnn and compute_dtype == torch.bfloat16
            and first_input.shape[-1] == 1 and h2g_p["w"].shape[-1] == 1):
        return _greedy_decode_fused(emb_p, cell_p, h2g_p, cfg, act,
                                    first_input, init_state, T_pred,
                                    scene_mean)
    state, x = init_state, first_input
    outs, readouts = [], []
    for _ in range(T_pred):
        if use_gnn:
            agg = gnn_step_neighbors(state.h, scene_mean,
                                     compute_dtype=compute_dtype)
            state = ConvLSTMState(c=state.c, h=state.h + agg)
        emb = conv2d(emb_p, x, activation=act, compute_dtype=compute_dtype)
        out, state = convlstm_step(cell_p, emb, state,
                                   compute_dtype=compute_dtype)
        logits = conv2d(h2g_p, out, compute_dtype=compute_dtype)
        if feedback == "onehot":
            N, h, w, _ = logits.shape
            x = one_hot_grid(torch.argmax(logits.reshape(N, h * w), dim=1),
                             h, w)
        else:
            x = logits
        outs.append(out)
        readouts.append(logits)
    return torch.stack(readouts, dim=1), torch.stack(outs, dim=1)


def _greedy_decode_fused(emb_p, cell_p, h2g_p, cfg, act, first_input,
                         init_state, T_pred, scene_mean):
    """The fused form of the argmax class decode
    (``multiverse_tpu/models/multiverse.py:240-278``)."""
    N, H, W, _ = first_input.shape
    HW = H * W
    D = init_state.h.shape[-1]
    dev = first_input.device
    bf = torch.bfloat16
    emb_table = conv2d(emb_p, one_hot_grid(torch.arange(HW, device=dev), H, W),
                       activation=act, compute_dtype=bf)
    ids = torch.argmax(first_input.reshape(N, HW), dim=1).int()
    identity = torch.arange(N, dtype=torch.int32, device=dev)
    h_rows = init_state.h.to(bf).reshape(N * HW, D).contiguous()
    c_rows = init_state.c.to(bf).reshape(N * HW, D).contiguous()
    scene_rows = None if scene_mean is None else \
        scene_mean.to(bf).reshape(N * HW, -1).contiguous()
    cell_b = cell_p["bias"].float().contiguous()
    h2g_w = h2g_p["w"].to(bf).reshape(9, D).t().contiguous()    # [D, 9]
    step = make_decode_step(cfg.decode_quant, cell_p, emb_table)
    outs, readouts = [], []
    for _ in range(T_pred):
        h_rows, c_rows, logits = step(cell_b, h2g_w, ids, identity, h_rows,
                                      c_rows, scene_rows, H, W)
        ids = torch.argmax(logits.reshape(N, HW), dim=1).int()
        outs.append(h_rows.reshape(N, H, W, D))
        readouts.append(logits.reshape(N, H, W, 1))
    return torch.stack(readouts, dim=1), torch.stack(outs, dim=1)
