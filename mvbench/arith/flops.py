"""Analytic FLOP counts of the model, frozen for the benchmark.

A copy of ``multiverse_torch/flops.py`` as it stood when the benchmark
was defined, so that a later change to the program cannot move the
yardstick its ``mfu`` metrics are read against. The functions take any
object with the configuration's attribute names (the port's
``MultiverseConfig`` or ``SimAugConfig``).

Counts are matmul/conv multiply-adds only (2 FLOPs per MAC) of the
model's own mathematics; pointwise ops, softmaxes, losses and optimizer
updates are left out. The graph attention is counted in its dense form
(``[HW, D+Cs] x [D+Cs, HW]`` edges and ``[HW, HW] x [HW, D]``
aggregation), as the original counts it: the program computes only the
nine in-grid neighbours, so the dense count stands ~11% above what a
beam decode step needs (0.38 of 3.44 GFLOP a beam step at the published
widths) and ~13% of a training step.
"""

from __future__ import annotations


def convlstm_step_flops(h: int, w: int, cin: int, d: int) -> float:
    """One ConvLSTM cell step on one [h, w, cin] input: the fused 3x3
    gate conv over [x, h_prev] -> 4 d channels."""
    return 2.0 * h * w * 9 * (cin + d) * 4 * d


def gnn_step_flops(h: int, w: int, d: int, scene_dim: int) -> float:
    """One dense graph-attention step: edges node @ node.T (node = [h,
    scene_mean]) and the attention aggregate."""
    hw = h * w
    return 2.0 * hw * hw * (d + scene_dim) + 2.0 * hw * hw * d


def readout_step_flops(h: int, w: int, d: int) -> float:
    """The hidden-to-grid readout ([HW, D] x [D, 9])."""
    return 2.0 * h * w * d * 9


def _dims(cfg):
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    return h, w, cfg.dec_hidden_size, cfg.emb_size, cfg.scene_conv_dim


def beam_decode_flops(cfg, n_traj: int, t_pred: int) -> float:
    """One diverse-beam inference batch: encoders (per trajectory), the
    K-wide class decode (per beam) and the greedy offset decode (per
    trajectory)."""
    h, w, d, e, cs = _dims(cfg)
    n_beam = n_traj * cfg.beam_size
    enc_in = cs if cfg.use_scene_enc else e
    enc = cfg.obs_len * (convlstm_step_flops(h, w, enc_in, d)
                         + convlstm_step_flops(h, w, 2, d))
    dec_class = convlstm_step_flops(h, w, e, d) + readout_step_flops(h, w, d)
    if cfg.use_gnn:
        dec_class += gnn_step_flops(h, w, d, cs if cfg.use_scene_enc else 0)
    dec_reg = convlstm_step_flops(h, w, 2, d) + readout_step_flops(h, w, d)
    return (n_traj * enc + n_beam * t_pred * dec_class
            + n_traj * t_pred * dec_reg)


def train_fwd_flops(cfg, batch_size: int) -> float:
    """Forward FLOPs of one training step (class and offset decoders
    both per example)."""
    h, w, d, e, cs = _dims(cfg)
    enc_in = cs if cfg.use_scene_enc else e
    enc = cfg.obs_len * (convlstm_step_flops(h, w, enc_in, d)
                         + convlstm_step_flops(h, w, 2, d))
    dec_class = convlstm_step_flops(h, w, e, d) + readout_step_flops(h, w, d)
    if cfg.use_gnn:
        dec_class += gnn_step_flops(h, w, d, cs if cfg.use_scene_enc else 0)
    dec_reg = convlstm_step_flops(h, w, 2, d) + readout_step_flops(h, w, d)
    return batch_size * (enc + cfg.pred_len * (dec_class + dec_reg))


def train_step_flops(cfg, batch_size: int) -> float:
    """Forward + backward at 3x the forward."""
    return 3.0 * train_fwd_flops(cfg, batch_size)


def scene_cnn_flops(cfg, n_frames: int) -> float:
    """The strided scene conv pyramid over ``n_frames`` one-hot maps."""
    f = 0.0
    in_ch = cfg.scene_class
    k = cfg.scene_conv_kernel
    for i in range(cfg.num_scales):
        h, w = cfg.scene_grids[i]
        f += 2.0 * h * w * k * k * in_ch * cfg.scene_conv_dim
        in_ch = cfg.scene_conv_dim
    return n_frames * f


def emb_conv_flops(h: int, w: int, p: int, e: int) -> float:
    """The 3x3 decoder input embedding conv ([h,w,p] -> [h,w,e])."""
    return 2.0 * h * w * 9 * p * e


def train_segment_flops(cfg, batch_size: int) -> dict:
    """Forward FLOPs of one training step by stage, the scene CNN, the
    embedding convs and the soft-grid label conv included."""
    h, w, d, e, cs = _dims(cfg)
    n = batch_size
    enc_in = cs if cfg.use_scene_enc else e
    return {
        "scene_cnn": (scene_cnn_flops(cfg, n * cfg.obs_len)
                      if cfg.use_scene_enc else 0.0),
        "enc_class": n * cfg.obs_len * convlstm_step_flops(h, w, enc_in, d),
        "enc_reg": n * cfg.obs_len * convlstm_step_flops(h, w, 2, d),
        "dec_class": n * cfg.pred_len * (
            emb_conv_flops(h, w, 1, e) + convlstm_step_flops(h, w, e, d)
            + (gnn_step_flops(h, w, d, cs if cfg.use_scene_enc else 0)
               if cfg.use_gnn else 0.0)
            + readout_step_flops(h, w, d)),
        "dec_reg": 0.0 if cfg.use_single_decoder else (
            n * cfg.pred_len * (emb_conv_flops(h, w, 2, e)
                                + convlstm_step_flops(h, w, e, d)
                                + 2.0 * readout_step_flops(h, w, d))),
        "loss_softgrid": (n * cfg.pred_len * 2.0 * h * w * 9 * 7
                          if cfg.use_soft_grid_class else 0.0),
        "optimizer": 0.0,
    }


def tower_fwd_flops(cfg) -> float:
    """One SimAug tower forward, per example."""
    segs = train_segment_flops(cfg, 1)
    return (segs["scene_cnn"] + segs["enc_class"] + segs["enc_reg"]
            + segs["dec_class"] + segs["dec_reg"])


def simaug_step_flops(cfg, batch_size: int) -> float:
    """One SimAug training step: the attack passes (input gradient only,
    ~2x a forward each) and the final training pass (3x)."""
    tower = tower_fwd_flops(cfg)
    n = batch_size
    f = 3.0 * n * tower
    if getattr(cfg, "multiview_train", False):
        m = cfg.multiview_max_num
        f += 2.0 * n * m * tower
        if cfg.multiview_exp == 3 and cfg.multiview_use_adv_for_loss:
            f += 1.0 * n * m * tower
    elif getattr(cfg, "adv_train", False):
        iters = 1 if cfg.adv_use_fgsm else cfg.adv_num_iter
        f += 2.0 * n * iters * tower
        if cfg.use_mixup and cfg.mixup_mix_adv:
            f += 2.0 * n * tower
    return f
