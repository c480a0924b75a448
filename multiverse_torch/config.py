"""Single dataclass configuration of the model and its runs.

The port's own copy of ``multiverse_tpu/config.py``: the same dataclass,
fields, defaults, ``validate()`` rules and JSON round-trip, so a
configuration written by either package loads in the other. Derived
fields (`scene_grids`, `use_grids`) mirror the derivations in
`process_args` (reference: code/pred_utils.py:121-132).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


def _grid_shape(scene_h: int, scene_w: int, stride: int) -> Tuple[int, int]:
    # round() (banker's rounding in py3) to match the reference derivation
    # (reference: code/pred_utils.py:127-132); consistent with a stride-s
    # SAME conv over an odd-sized input.
    return int(round(scene_h / stride)), int(round(scene_w / stride))


@dataclasses.dataclass(frozen=True)
class MultiverseConfig:
    """Model + training hyperparameters.

    Defaults follow the published Multiverse configs
    (reference: TESTING.md "Single Future" command; TRAINING.md Step 2).
    """

    # --- sequence lengths
    obs_len: int = 8
    pred_len: int = 12

    # --- scene semantic input
    scene_h: int = 36
    scene_w: int = 64
    scene_class: int = 11  # top-10 ADE20k classes + background
    scene_conv_kernel: int = 3
    scene_conv_dim: int = 64

    # --- model dims
    emb_size: int = 32
    enc_hidden_size: int = 256
    dec_hidden_size: int = 256
    convlstm_kernel: int = 3
    activation: str = "tanh"  # relu | lrelu | tanh

    # --- grid scales
    scene_grid_strides: Tuple[int, ...] = (2, 4)
    use_grids: Tuple[bool, ...] = (True, False)

    # --- model variants
    use_gnn: bool = True
    use_scene_enc: bool = True
    use_single_decoder: bool = False
    use_teacher_forcing: bool = False
    train_w_onehot: bool = True
    use_soft_grid_class: bool = False
    soft_grid: int = 1
    mask_grid_regression: bool = False

    # --- beam search
    use_beam_search: bool = False
    beam_size: int = 20
    diverse_beam: bool = False
    diverse_gamma: float = 0.01
    fix_num_timestep: int = 0

    # --- video geometry (pixel space for rasterization)
    video_h: int = 1080
    video_w: int = 1920

    # --- losses
    grid_loss_weight: float = 1.0
    grid_reg_loss_weight: float = 0.1
    wd: float = 0.0001

    # --- optimization
    optimizer: str = "adadelta"  # momentum | adadelta | adam | rmsprop
    init_lr: float = 0.3
    emb_lr: float = 1.0
    learning_rate_decay: Optional[float] = 0.95
    num_epoch_per_decay: float = 2.0
    use_cosine_lr: bool = False
    clip_gradient_norm: Optional[float] = 10.0
    # train-time input dropout on all four ConvLSTM cells (the
    # reference's DropoutWrapper(cell, keep_prob) under an is_train
    # cond, reference: code/pred_models.py:130-131,195-249).  1.0 =
    # off; the SimAug recipes default to 0.7
    # (reference: SimAug/code/train.py:159-160).
    keep_prob: float = 1.0
    batch_size: int = 20
    num_epochs: int = 80

    # Scale the one-hot scene-semantic maps to [-1, 1] before the scene
    # CNN (SimAug's adversarial-learning input convention).  A BASE
    # config field (not SimAug-only) because the reference applies it
    # inside build_tower for train AND test alike
    # (reference: SimAug/code/pred_models.py:284-286) and exposes the
    # flag on its test driver (SimAug/code/test.py:103-105) — a model
    # trained with norm_input must be evaluated with it too.
    norm_input: bool = False

    # --- numerics
    compute_dtype: str = "float32"  # float32 | bfloat16 for conv compute
    # int8 tier of the fused decode step ("none" | "int8" | "int8a" |
    # "int8_dyn"), inference only, on top of bfloat16 compute: "int8"
    # runs the gate product int8 x int8 -> int32 with static activation
    # scales folded into the weights, "int8a" also the two attention
    # products (all operands bounded by construction), "int8_dyn" two
    # int8 gate products, the embedding half at static scales and the
    # recurrent half at per-row dynamic scales (its 3x3 patch maximum).
    decode_quant: str = "none"

    # Per-step beam-successor selection: "twostage" (default), a
    # per-beam stable top-K of the raw logits, then the global top-K
    # over the K*K survivors, which is exact when the rank penalty is
    # non-positive (proof in models/beam_search.py of the JAX package);
    # "dense", the full-row log_softmax + rank penalty + flat top-K
    # over K*H*W, also the automatic fallback when K > H*W or
    # diverse_gamma > 1.
    beam_select: str = "twostage"

    # Recompute each encoder/decoder step in the backward
    # (torch.utils.checkpoint) instead of keeping its activations.
    remat: bool = False

    # The JAX package's paired encoder/decoder scans (the same math, a
    # TPU scheduling device); accepted so that configurations
    # round-trip, and run as the separate scans by the port.
    fuse_scan_pairs: bool = True

    # Run the fused decode step (a hand-written CUDA kernel on the
    # card, its plain version on the CPU) on the bf16 GNN decode path;
    # False runs the composed step. The name is the JAX package's.
    allow_pallas: bool = True

    # ------------------------------------------------------------------
    @property
    def seq_len(self) -> int:
        return self.obs_len + self.pred_len

    @property
    def scene_grids(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(
            _grid_shape(self.scene_h, self.scene_w, s)
            for s in self.scene_grid_strides
        )

    @property
    def active_scales(self) -> Tuple[int, ...]:
        return tuple(i for i, u in enumerate(self.use_grids) if u)

    @property
    def num_scales(self) -> int:
        return len(self.scene_grid_strides)

    def validate(self) -> "MultiverseConfig":
        if len(self.use_grids) != len(self.scene_grid_strides):
            raise ValueError("use_grids must match scene_grid_strides")
        if sum(self.use_grids) > 2:
            raise ValueError("at most two active grid scales")
        if self.use_beam_search and sum(self.use_grids) != 1:
            raise ValueError("beam search supports exactly one active scale")
        if self.enc_hidden_size != self.dec_hidden_size:
            # encoder last state seeds the decoder state directly
            raise ValueError("enc_hidden_size must equal dec_hidden_size")
        if not (0.0 < self.keep_prob <= 1.0):
            raise ValueError(
                f"keep_prob must be in (0, 1], got {self.keep_prob}")
        if self.decode_quant not in ("none", "int8", "int8a",
                                     "int8_dyn"):
            raise ValueError(
                f"decode_quant must be none|int8|int8a|int8_dyn, got "
                f"{self.decode_quant!r}")
        if self.decode_quant != "none" and self.compute_dtype != "bfloat16":
            # the int8 kernels ride the fused bf16 decode path; with
            # f32 compute they would silently never engage
            raise ValueError(
                "decode_quant requires compute_dtype=bfloat16")
        if self.beam_select not in ("twostage", "dense"):
            raise ValueError(
                f"beam_select must be twostage|dense, got "
                f"{self.beam_select!r}")
        return self

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "MultiverseConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "MultiverseConfig":
        d = json.loads(s)
        for key in ("scene_grid_strides", "use_grids"):
            if key in d and isinstance(d[key], list):
                d[key] = tuple(d[key])
        return cls(**d)

    @classmethod
    def parse_strides(cls, strides: str, use_grids: str) -> dict:
        """Parse reference-CLI style "2,4" / "1,0" strings."""
        return dict(
            scene_grid_strides=tuple(int(s) for s in strides.split(",")),
            use_grids=tuple(bool(int(u)) for u in use_grids.split(",")),
        )
