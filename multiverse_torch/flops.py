"""Analytic FLOP accounting for MFU reporting.

The port's copy of ``multiverse_tpu/flops.py`` over the port's own
:class:`~multiverse_torch.config.MultiverseConfig`: the same counts
for the same configuration.

The reference publishes no throughput or utilization numbers at all
(SURVEY.md §6); this module exists so the benches can report achieved
TFLOP/s and fraction-of-roofline as artifacts instead of prose claims.

Counts are matmul/conv multiply-adds only (2 FLOPs per MAC) of the
model's OWN mathematics — pointwise ops, softmaxes, losses and
optimizer updates are excluded, so every achieved-TFLOP/s figure
derived from these counts is a floor.  Pallas kernels are opaque to
XLA's cost analysis, which is why the accounting is analytic rather
than read off the compiled executable.

Shapes audited against: ops/convlstm.py (fused [3,3,Cin+D,4D] gate
conv), ops/pallas_decode.py (im2col gate matmul [HW, 9(E+D)]x[9(E+D),
4D], channel-first readout [HW,D]x[D,9]), ops/gnn.py (dense edges
[HW,D+Cs]x[D+Cs,HW], aggregate [HW,HW]x[HW,D]).
"""

from __future__ import annotations

from multiverse_torch.config import MultiverseConfig


def convlstm_step_flops(h: int, w: int, cin: int, d: int) -> float:
    """One ConvLSTM cell step on one [h, w, cin] input: the fused 3x3
    gate conv over [x ⊕ h_prev] -> 4·d channels."""
    return 2.0 * h * w * 9 * (cin + d) * 4 * d


def gnn_step_flops(h: int, w: int, d: int, scene_dim: int) -> float:
    """One dense 9-neighbor graph-attention step: edge logits
    node@node.T (node = [h ⊕ scene_mean]) + attention aggregate."""
    hw = h * w
    return 2.0 * hw * hw * (d + scene_dim) + 2.0 * hw * hw * d


def readout_step_flops(h: int, w: int, d: int) -> float:
    """Channel-first h→grid-logit readout ([HW, D] x [D, 9])."""
    return 2.0 * h * w * d * 9


def _dims(cfg: MultiverseConfig):
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    return h, w, cfg.dec_hidden_size, cfg.emb_size, cfg.scene_conv_dim


def beam_decode_flops(cfg: MultiverseConfig, n_traj: int,
                      t_pred: int) -> float:
    """Total FLOPs of one diverse-beam inference batch: encoders (per
    trajectory), K-wide class decode (per beam — the folded N·K batch
    axis), greedy offset decode (per trajectory)."""
    h, w, d, e, cs = _dims(cfg)
    n_beam = n_traj * cfg.beam_size
    enc_in = cs if cfg.use_scene_enc else e
    enc = cfg.obs_len * (
        convlstm_step_flops(h, w, enc_in, d)       # class encoder
        + convlstm_step_flops(h, w, 2, d))         # offset encoder
    dec_class = convlstm_step_flops(h, w, e, d) + readout_step_flops(
        h, w, d)
    if cfg.use_gnn:
        dec_class += gnn_step_flops(h, w, d, cs if cfg.use_scene_enc
                                    else 0)
    dec_reg = convlstm_step_flops(h, w, 2, d) + readout_step_flops(
        h, w, d)
    return (n_traj * enc
            + n_beam * t_pred * dec_class
            + n_traj * t_pred * dec_reg)


def beam_decode_flops_split(cfg: MultiverseConfig, n_traj: int,
                            t_pred: int) -> dict:
    """beam_decode_flops partitioned by the MXU mode each matmul runs
    in under the int8a serving tier (STATUS.md §int8a decision):

      int8_gate   — the N·K class-decode gate matmul (int8 since the
                    round-2 "int8" tier)
      int8_attn   — the GNN edge-logit + aggregate matmuls (int8 since
                    the round-3 "int8a" kernel)
      bf16_rest   — everything that stays bf16: the class readout
                    ([HW,D]x[D,9] — 2.65 MFLOP/step vs the gate's
                    ~3 GFLOP, i.e. ~0.09% of the step: quantizing it is
                    value-free, the recorded negative for VERDICT r4
                    #4), the per-trajectory offset decode, and the
                    encoders.

    Sums exactly to beam_decode_flops.  Used by bench.py to state the
    int8a tier's analytic matmul ceiling against the MEASURED int8 and
    bf16 rooflines.
    """
    h, w, d, e, cs = _dims(cfg)
    n_beam = n_traj * cfg.beam_size
    enc_in = cs if cfg.use_scene_enc else e
    enc = n_traj * cfg.obs_len * (
        convlstm_step_flops(h, w, enc_in, d)
        + convlstm_step_flops(h, w, 2, d))
    gate = n_beam * t_pred * convlstm_step_flops(h, w, e, d)
    attn = 0.0
    if cfg.use_gnn:
        attn = n_beam * t_pred * gnn_step_flops(
            h, w, d, cs if cfg.use_scene_enc else 0)
    readout = n_beam * t_pred * readout_step_flops(h, w, d)
    reg = n_traj * t_pred * (convlstm_step_flops(h, w, 2, d)
                             + readout_step_flops(h, w, d))
    return {
        "int8_gate": gate,
        "int8_attn": attn,
        "bf16_rest": readout + reg + enc,
        "bf16_readout_class": readout,
    }


def train_fwd_flops(cfg: MultiverseConfig, batch_size: int) -> float:
    """Forward FLOPs of one training step (greedy decode path: class +
    offset decoders both per example)."""
    h, w, d, e, cs = _dims(cfg)
    enc_in = cs if cfg.use_scene_enc else e
    enc = cfg.obs_len * (convlstm_step_flops(h, w, enc_in, d)
                         + convlstm_step_flops(h, w, 2, d))
    dec_class = convlstm_step_flops(h, w, e, d) + readout_step_flops(
        h, w, d)
    if cfg.use_gnn:
        dec_class += gnn_step_flops(h, w, d, cs if cfg.use_scene_enc
                                    else 0)
    dec_reg = convlstm_step_flops(h, w, 2, d) + readout_step_flops(
        h, w, d)
    return batch_size * (enc + cfg.pred_len * (dec_class + dec_reg))


def train_step_flops(cfg: MultiverseConfig, batch_size: int) -> float:
    """Forward + backward, with the standard 3x-forward convention for
    matmul/conv backward passes (grad wrt inputs + grad wrt weights)."""
    return 3.0 * train_fwd_flops(cfg, batch_size)


# ------------------------------------------------- finer-grained counts


def scene_cnn_flops(cfg: MultiverseConfig, n_frames: int) -> float:
    """The strided scene conv pyramid over n_frames one-hot maps
    (models/multiverse.py scene_encode: stride-2 convs, scale i output
    = cfg.scene_grids[i])."""
    f = 0.0
    in_ch = cfg.scene_class
    k = cfg.scene_conv_kernel
    for i in range(cfg.num_scales):
        h, w = cfg.scene_grids[i]
        f += 2.0 * h * w * k * k * in_ch * cfg.scene_conv_dim
        in_ch = cfg.scene_conv_dim
    return n_frames * f


def emb_conv_flops(h: int, w: int, p: int, e: int) -> float:
    """3x3 decoder input embedding conv ([h,w,p] -> [h,w,e])."""
    return 2.0 * h * w * 9 * p * e


def train_segment_flops(cfg: MultiverseConfig,
                        batch_size: int) -> dict:
    """Per-segment FORWARD matmul/conv FLOPs of one training step, for
    the per-segment roofline decomposition (bench_segments.py).  Keys
    mirror model_forward's stages; the soft-grid label conv (fixed 7
    kernels, models/multiverse.py soft_grid_labels) is counted under
    'loss_softgrid'; the optimizer is elementwise (0 matmul FLOPs).

    Unlike train_fwd_flops (kept stable for cross-round artifact
    comparability), this ALSO counts the scene CNN, the decoder input
    embedding convs, and the 2-channel reg readout exactly.
    """
    h, w, d, e, cs = _dims(cfg)
    n = batch_size
    enc_in = cs if cfg.use_scene_enc else e
    segs = {
        "scene_cnn": (scene_cnn_flops(cfg, n * cfg.obs_len)
                      if cfg.use_scene_enc else 0.0),
        "enc_class": n * cfg.obs_len * convlstm_step_flops(
            h, w, enc_in, d),
        "enc_reg": n * cfg.obs_len * convlstm_step_flops(h, w, 2, d),
        "dec_class": n * cfg.pred_len * (
            emb_conv_flops(h, w, 1, e)
            + convlstm_step_flops(h, w, e, d)
            + (gnn_step_flops(h, w, d, cs if cfg.use_scene_enc else 0)
               if cfg.use_gnn else 0.0)
            + readout_step_flops(h, w, d)),
        "dec_reg": 0.0 if cfg.use_single_decoder else (
            n * cfg.pred_len * (
                emb_conv_flops(h, w, 2, e)
                + convlstm_step_flops(h, w, e, d)
                + 2.0 * readout_step_flops(h, w, d))),   # D->2 readout
        # soft-grid smoothing: 7 fixed 3x3 single-channel kernels over
        # the [N, T_pred, h, w] one-hot labels (only when enabled)
        "loss_softgrid": (
            n * cfg.pred_len * 2.0 * h * w * 9 * 7
            if cfg.use_soft_grid_class else 0.0),
        "optimizer": 0.0,
    }
    return segs


def tower_fwd_flops(cfg: MultiverseConfig) -> float:
    """One SimAug tower forward, per example (models/simaug.py
    tower_forward: full scene pyramid + both encoders + both decoders
    at the single active scale)."""
    segs = train_segment_flops(cfg, 1)
    return (segs["scene_cnn"] + segs["enc_class"] + segs["enc_reg"]
            + segs["dec_class"] + segs["dec_reg"])


def simaug_step_flops(cfg, batch_size: int) -> float:
    """One SimAug training step (models/simaug.py simaug_loss).

    Attack tower passes take the gradient wrt the INPUT only (no
    weight grads), so each costs ~2x a forward; the final training
    pass is a full fwd+bwd (3x).  Counts per mode:
      multiview (exp 1-4): N*M tiled attack pass (+1 extra CE forward
        when multiview_use_adv_for_loss) + N full train pass
      adv_train: adv_num_iter PGD attack passes (1 for FGSM) + N full
        train pass
      clean/standard_aug: N full train pass only.
    """
    tower = tower_fwd_flops(cfg)
    n = batch_size
    f = 3.0 * n * tower                       # final fwd+bwd
    if getattr(cfg, "multiview_train", False):
        m = cfg.multiview_max_num
        f += 2.0 * n * m * tower              # tiled attack fwd+bwd_in
        if cfg.multiview_exp == 3 and cfg.multiview_use_adv_for_loss:
            f += 1.0 * n * m * tower          # extra view-loss forward
    elif getattr(cfg, "adv_train", False):
        iters = 1 if cfg.adv_use_fgsm else cfg.adv_num_iter
        f += 2.0 * n * iters * tower
        if cfg.use_mixup and cfg.mixup_mix_adv:
            f += 2.0 * n * tower
    return f
