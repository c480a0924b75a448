"""The Multiverse model: scene CNN + ConvLSTM encoders + ConvLSTM decoders
over coarse spatial grids.

PyTorch port of ``multiverse_tpu/models/multiverse.py``:
``init_params``, ``scene_encode``, ``greedy_decode`` (composed, or for
the class decode at inference through the fused decode step),
``model_forward`` (train and eval) and the losses (``soft_grid_labels``,
``compute_loss``). The parameters live in a :class:`Multiverse` module
whose names follow
the JAX parameter tree (``scene_conv1.w``, ``scales.0.dec_class.kernel``,
...); the functions take any nested mapping of tensors with that layout,
so a :class:`Multiverse` or a plain dict of dicts both work.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multiverse_torch.config import MultiverseConfig
from multiverse_torch.geometry import one_hot_grid
from multiverse_torch.ops import (
    ConvLSTMState,
    conv2d,
    convlstm_init,
    convlstm_scan,
    convlstm_step,
    gnn_step_auto,
    init_conv,
)
from multiverse_torch.ops.convlstm import apply_dropout, dropout_mask
from multiverse_torch.ops.layers import get_activation, l2_weight_decay
from multiverse_torch.ops.quant import fused_decode


class Batch(NamedTuple):
    """One device batch (see ``multiverse_tpu.models.Batch``)."""

    obs_grid_class: torch.Tensor       # [N, S, T_obs] int32 flat cell ids
    obs_grid_target_all: Tuple[torch.Tensor, ...]  # per scale [N,T_obs,h,w,2]
    obs_scene: torch.Tensor            # [N, T_obs] int32 -> scene_feat rows
    scene_feat: torch.Tensor           # [F, SH, SW, C] one-hot masks
    pred_grid_class: Optional[torch.Tensor] = None   # [N, S, T_pred] int32
    pred_grid_target_all: Optional[Tuple[torch.Tensor, ...]] = None
    pred_length: Optional[torch.Tensor] = None   # [N] int32 (beam decode)


class ForwardOutputs(NamedTuple):
    class_logits: Dict[int, torch.Tensor]   # scale -> [N, T_pred, h, w, 1]
    reg_out: Dict[int, torch.Tensor]        # scale -> [N, T_pred, h, w, 2]
    dec_states: Dict[int, torch.Tensor]     # scale -> [N, T_pred, h, w, D]
    scene_convs: List[torch.Tensor]         # per scale [N, T_obs, h, w, Cc]


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


def _wrap(tree: Mapping, trainable: bool) -> nn.Module:
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=trainable)
             for k, v in tree.items()})
    return nn.ModuleDict({k: _wrap(v, trainable) for k, v in tree.items()})


class Multiverse(nn.Module):
    """Holds a parameter tree; ``model["scales"]["0"]["dec_class"]`` is
    the same sub-tree as in the JAX package, and ``named_parameters``
    gives its '.'-joined names. The parameters are frozen unless
    ``trainable`` (inference runs under ``torch.inference_mode``; the
    trainer asks for trainable weights)."""

    def __init__(self, tree: Mapping, trainable: bool = False):
        super().__init__()
        for name, sub in tree.items():
            self.add_module(name, _wrap(sub, trainable))

    def __getitem__(self, name: str):
        return self._modules[name]

    @classmethod
    def init(cls, cfg: MultiverseConfig, seed: int = 0, device=None,
             trainable: bool = False) -> "Multiverse":
        """Seeded random weights (``torch.Generator`` with ``seed``)."""
        gen = torch.Generator().manual_seed(seed)
        return cls(init_params(cfg, gen), trainable).to(device)


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
    feedback: str = "onehot",        # onehot | raw | teacher
    pred_gt: Optional[torch.Tensor] = None,      # [N, T_pred, h, w, P]
    compute_dtype: Optional[torch.dtype] = None,
    allow_fused: bool = False,       # the fused decode step (inference)
    keep_prob: float = 1.0,          # train-time input dropout on the cell
    dropout_rng: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive ConvLSTM decode: per step an optional GNN residual
    on h (``gnn_step_auto``: K4 with its backward K5 on the card's bf16
    path), the 3x3 embedding of the input, a ConvLSTM step and the
    hidden-to-grid readout; the next input is the argmax one-hot
    ("onehot"), the readout itself ("raw") or the ground truth
    ("teacher": step t is fed ``pred_gt[:, min(t + 1, T_pred - 1)]``,
    the reference's indexing, reproduced verbatim). Returns (readouts
    [N, T, h, w, P], hidden states [N, T, h, w, D]).

    ``keep_prob`` < 1 with a ``dropout_rng`` drops the embedded cell
    input with a fresh mask per step (train time); ``cfg.remat``
    checkpoints each step, with the dropout masks drawn outside it.

    With ``allow_fused``, one-hot feedback and no dropout, the class
    decode runs the fused decode step where
    :func:`multiverse_torch.ops.quant.fused_decode` gives one (bf16, the
    GNN on; K1, or K2/K3/K7 under ``cfg.decode_quant``), as
    ``multiverse_tpu`` does: it carries the argmax cell id, looks its
    embedding up in a table of every cell's embedding, and passes
    identity parents."""
    if feedback not in ("onehot", "raw", "teacher"):
        raise ValueError(
            f"feedback must be onehot|raw|teacher, got {feedback!r}")
    act = get_activation(cfg.activation)
    dropout = keep_prob < 1.0 and dropout_rng is not None
    emb_p = scale_params[emb_name]
    cell_p = scale_params[cell_name]
    h2g_p = scale_params[h2g_name]
    N, h, w, _ = first_input.shape
    fused = None
    if allow_fused and not dropout and feedback == "onehot":
        fused = fused_decode(cfg, compute_dtype, use_gnn, emb_p, cell_p,
                             h2g_p, init_state.h, init_state.c, scene_mean)
    if fused is not None:
        ids = torch.argmax(first_input.reshape(N, h * w), dim=1).int()
        identity = torch.arange(N, dtype=torch.int32, device=ids.device)
        hh, c = fused.h, fused.c
        outs, readouts = [], []
        for _ in range(T_pred):
            hh, c, logits = fused.step(ids, identity, hh, c)
            ids = torch.argmax(logits.reshape(N, h * w), dim=1).int()
            outs.append(hh.reshape(N, h, w, -1))
            readouts.append(logits.reshape(N, h, w, 1))
        return torch.stack(readouts, dim=1), torch.stack(outs, dim=1)
    emb_shape = (N, h, w, cfg.emb_size)

    def step(t, x, c, hh, keep):
        state = ConvLSTMState(c=c, h=hh)
        if use_gnn:
            agg = gnn_step_auto(state.h, scene_mean,
                                compute_dtype=compute_dtype,
                                allow_pallas=cfg.allow_pallas)
            state = ConvLSTMState(c=state.c, h=state.h + agg)
        emb = conv2d(emb_p, x, activation=act, compute_dtype=compute_dtype)
        if keep is not None:
            emb = apply_dropout(emb, keep, keep_prob)
        out, state = convlstm_step(cell_p, emb, state,
                                   compute_dtype=compute_dtype)
        logits = conv2d(h2g_p, out, compute_dtype=compute_dtype)
        if feedback == "teacher":
            nxt = pred_gt[:, min(t + 1, T_pred - 1)]
        elif feedback == "onehot":
            nxt = one_hot_grid(torch.argmax(logits.reshape(N, h * w), dim=1),
                               h, w)
        else:
            nxt = logits
        return out, logits, nxt, state.c, state.h

    x, c, hh = first_input, init_state.c, init_state.h
    outs, readouts = [], []
    for t in range(T_pred):
        keep = (dropout_mask(dropout_rng, emb_shape, keep_prob, x.device)
                if dropout else None)
        if cfg.remat:
            out, logits, x, c, hh = checkpoint(step, t, x, c, hh, keep,
                                               use_reentrant=False)
        else:
            out, logits, x, c, hh = step(t, x, c, hh, keep)
        outs.append(out)
        readouts.append(logits)
    return torch.stack(readouts, dim=1), torch.stack(outs, dim=1)


# --------------------------------------------------------------- forward


def _site_generator(rng: int, scale: int, site: int,
                    device) -> torch.Generator:
    # one stream per (step seed, scale, site): scale * 4 + site < 8
    return torch.Generator(device=device).manual_seed(
        rng * 8 + scale * 4 + site)


def model_forward(
    params,
    batch: Batch,
    cfg: MultiverseConfig,
    is_train: bool = False,
    rng: Optional[int] = None,
) -> ForwardOutputs:
    """Full forward pass (greedy decode path), train or eval
    (``multiverse_tpu/models/multiverse.py:model_forward``).

    ``rng`` (an int, one per train step) drives train-time input dropout
    on the four ConvLSTM cells when ``cfg.keep_prob`` < 1: site s of
    scale i (0 class encoder, 1 regression encoder, 2 class decoder,
    3 regression decoder) draws from its own ``torch.Generator`` seeded
    ``rng * 8 + i * 4 + s``, the JAX package's ``fold_in(rng, i * 4 +
    s)`` streams. Required at train time then, unused otherwise.

    ``cfg.fuse_scan_pairs`` is accepted and runs the separate scans: the
    JAX package's paired scans (``ops/fused_scans.py``) are the same
    math, a TPU scheduling device that is not ported.
    """
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else None
    dropout = is_train and cfg.keep_prob < 1.0
    if dropout and rng is None:
        raise ValueError(
            "training with keep_prob < 1 needs an rng "
            "(model_forward(..., rng=...))")
    dev = batch.obs_grid_class.device

    def site_rng(scale: int, site: int) -> Optional[torch.Generator]:
        return _site_generator(rng, scale, site, dev) if dropout else None

    act = get_activation(cfg.activation)
    N = batch.obs_grid_class.shape[0]
    T_obs = batch.obs_grid_class.shape[2]
    T_pred = cfg.pred_len

    scene_convs: List[torch.Tensor] = []
    if cfg.use_scene_enc:
        scene_convs = scene_encode(params, batch.scene_feat, batch.obs_scene,
                                   cfg, compute_dtype)

    class_logits: Dict[int, torch.Tensor] = {}
    reg_out: Dict[int, torch.Tensor] = {}
    dec_states: Dict[int, torch.Tensor] = {}
    for idx, i in enumerate(cfg.active_scales):
        h, w = cfg.scene_grids[i]
        sp = params["scales"][str(i)]
        obs_onehot = one_hot_grid(batch.obs_grid_class[:, i], h, w)
        if cfg.use_scene_enc:
            enc_in = scene_convs[i] * obs_onehot
        else:
            flat = obs_onehot.reshape(N * T_obs, h, w, 1)
            emb = conv2d(sp["enc_grid_emb"], flat, activation=act,
                         compute_dtype=compute_dtype)
            enc_in = emb.reshape(N, T_obs, h, w, cfg.emb_size)
        _, enc_last = convlstm_scan(
            sp["enc_class"], enc_in, compute_dtype=compute_dtype,
            remat=cfg.remat, keep_prob=cfg.keep_prob,
            dropout_rng=site_rng(i, 0))
        if not cfg.use_single_decoder:
            _, enc_reg_last = convlstm_scan(
                sp["enc_reg"], batch.obs_grid_target_all[idx],
                compute_dtype=compute_dtype, remat=cfg.remat,
                keep_prob=cfg.keep_prob, dropout_rng=site_rng(i, 1))

        scene_mean = None
        if cfg.use_scene_enc and cfg.use_gnn:
            scene_mean = torch.mean(scene_convs[i], dim=1)

        if cfg.use_teacher_forcing and is_train:
            class_fb = "teacher"
            class_gt = one_hot_grid(batch.pred_grid_class[:, i], h, w)
        elif (not is_train) or cfg.train_w_onehot:
            class_fb, class_gt = "onehot", None
        else:
            class_fb, class_gt = "raw", None

        logits, states = greedy_decode(
            sp, cfg,
            first_input=obs_onehot[:, -1],
            init_state=enc_last,
            T_pred=T_pred,
            emb_name="dec_class_emb",
            cell_name="dec_class",
            h2g_name="h2g_class",
            use_gnn=cfg.use_gnn,
            scene_mean=scene_mean,
            feedback=class_fb,
            pred_gt=class_gt,
            compute_dtype=compute_dtype,
            allow_fused=not is_train,
            keep_prob=cfg.keep_prob,
            dropout_rng=site_rng(i, 2),
        )
        class_logits[i] = logits
        dec_states[i] = states

        if cfg.use_single_decoder:
            # regression read out of the class decoder's hidden states
            flat = states.reshape(N * T_pred, h, w, cfg.dec_hidden_size)
            reg = conv2d(sp["h2g_single"], flat, compute_dtype=compute_dtype)
            reg_out[i] = reg.reshape(N, T_pred, h, w, 2)
        else:
            teacher = cfg.use_teacher_forcing and is_train
            reg, _ = greedy_decode(
                sp, cfg,
                first_input=batch.obs_grid_target_all[idx][:, -1],
                init_state=enc_reg_last,
                T_pred=T_pred,
                emb_name="dec_reg_emb",
                cell_name="dec_reg",
                h2g_name="h2g_reg",
                use_gnn=False,
                feedback="teacher" if teacher else "raw",
                pred_gt=batch.pred_grid_target_all[idx] if teacher else None,
                compute_dtype=compute_dtype,
                keep_prob=cfg.keep_prob,
                dropout_rng=site_rng(i, 3),
            )
            reg_out[i] = reg
    return ForwardOutputs(class_logits, reg_out, dec_states, scene_convs)


# --------------------------------------------------------------- losses


# The 7 hand-tuned soft-grid spatial smoothing kernels
# (reference: code/pred_models.py:1088-1124).
SOFT_GRID_KERNELS = {
    1: [[0.1] * 3, [0.1, 1.0, 0.1], [0.1] * 3],
    2: [[0.01] * 3, [0.01, 1.0, 0.01], [0.01] * 3],
    3: [[0.05] * 3, [0.05, 1.0, 0.05], [0.05] * 3],
    4: [[0.0125] * 3, [0.0125, 0.9, 0.0125], [0.0125] * 3],
    5: [[0.05] * 3, [0.05, 0.6, 0.05], [0.05] * 3],
    6: [[0.1] * 3, [0.1, 0.2, 0.1], [0.1] * 3],
    7: [
        [0.0625, 0.0625, 0.0625, 0.0625, 0.0625],
        [0.0625, 0.0125, 0.0125, 0.0125, 0.0625],
        [0.0625, 0.0125, 0.8, 0.0125, 0.0625],
        [0.0625, 0.0125, 0.0125, 0.0125, 0.0625],
        [0.0625, 0.0625, 0.0625, 0.0625, 0.0625],
    ],
}


def soft_grid_labels(labels: torch.Tensor, h: int, w: int,
                     soft_grid: int = 1) -> torch.Tensor:
    """Spatially smoothed one-hot labels: [...] int cell ids -> [..., h,
    w, 1] f32 maps, a SAME-padded f32 cross-correlation of the one-hot
    map with ``SOFT_GRID_KERNELS[soft_grid]`` (on the card it needs
    ``torch.backends.cudnn.allow_tf32 = False``, as the trainer sets)."""
    k = torch.tensor(SOFT_GRID_KERNELS[soft_grid], dtype=torch.float32,
                     device=labels.device)
    onehot = one_hot_grid(labels, h, w)                  # [..., h, w, 1]
    lead = tuple(onehot.shape[:-3])
    out = F.conv2d(onehot.reshape(-1, 1, h, w), k[None, None],
                   padding=k.shape[0] // 2)
    return out.reshape(lead + (h, w, 1))


def huber_loss(pred: torch.Tensor, target: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber loss with optax.huber_loss's formula."""
    abs_err = torch.abs(pred - target)
    quadratic = torch.clamp_max(abs_err, delta)
    return 0.5 * quadratic * quadratic + delta * (abs_err - quadratic)


def compute_loss(
    params,
    batch: Batch,
    outputs: ForwardOutputs,
    cfg: MultiverseConfig,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Grid cross entropy + Huber offset regression + L2 weight decay
    (``multiverse_tpu/models/multiverse.py:compute_loss``). Returns
    (total loss, dict of per-head losses).

    ``mesh``: the ``multiverse_torch.parallel.Mesh`` of a data-parallel
    step (the JAX ``axis_name``) whose caller averages the losses and
    gradients over its data ranks' equal shards. Every plain mean is
    exact under that average, but the masked regression's normaliser,
    the shard's mask count, is not: in a mesh's data group the count is
    summed over the data ranks and the local term scaled by their number,
    so the average is
    ``sum_ranks(num) / (2 * global count)`` in value and in gradient
    (the count does not depend on the parameters). The model ranks of a
    tensor-parallel mesh hold the same examples and are not counted."""
    losses: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32,
                        device=batch.obs_grid_class.device)
    for idx, i in enumerate(cfg.active_scales):
        h, w = cfg.scene_grids[i]
        logits = outputs.class_logits[i].reshape(-1, h * w)  # [N*T, HW]
        labels_t = batch.pred_grid_class[:, i]               # [N, T]
        log_p = torch.log_softmax(logits, dim=-1)
        if cfg.use_soft_grid_class:
            # softmax cross entropy on the unnormalised label maps
            soft = soft_grid_labels(labels_t, h, w, cfg.soft_grid)
            soft = soft.reshape(-1, h * w)
            ce = -torch.sum(soft * log_p, dim=-1)
            label_mask = soft
        else:
            ce = -torch.gather(log_p, 1,
                               labels_t.reshape(-1, 1).long())[:, 0]
            label_mask = None
        ce = torch.mean(ce)

        reg = outputs.reg_out[i]                             # [N,T,h,w,2]
        hub = huber_loss(reg, batch.pred_grid_target_all[idx])
        if cfg.mask_grid_regression:
            # only cells whose (soft) label is > 0
            if label_mask is None:
                label_mask = F.one_hot(labels_t.reshape(-1).long(),
                                       h * w).float()
            m = (label_mask > 0).float().reshape(reg.shape[:-1])[..., None]
            num, den = torch.sum(hub * m), torch.sum(m).detach()
            scale = 1.0
            if mesh is not None and mesh.data_group is not None:
                den = mesh.all_reduce_sum(den.clone())
                scale = float(mesh.dp)
            reg_loss = scale * num / torch.clamp_min(den * 2.0, 1.0)
        else:
            reg_loss = torch.mean(hub)

        ce = ce * cfg.grid_loss_weight
        reg_loss = reg_loss * cfg.grid_reg_loss_weight
        losses[f"grid{i}_class"] = ce
        losses[f"grid{i}_reg"] = reg_loss
        total = total + ce + reg_loss

    wd = l2_weight_decay(params, cfg.wd)
    losses["wd"] = wd
    return total + wd, losses
