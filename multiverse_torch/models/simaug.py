"""SimAug (ECCV'20): adversarial-feature and multi-view-mixup training,
so that a model trained on simulation transfers to real cameras.

Port of ``multiverse_tpu/models/simaug.py`` (reference:
SimAug/code/pred_models.py): the white-box FGSM/PGD attack on the scene
input, the M-view augmentation with view ranking, Beta mixup and the
focal weight, the SimAug loss and its train step.

Random draws. The JAX package draws from keys split inside each
function; torch cannot reproduce those streams. So each public function
here draws first (:func:`attack_draws`, :func:`multiview_draws`,
:func:`step_draws`: tensors from a ``torch.Generator`` on the batch's
device, the Beta weight and the dropout seeds from a numpy
``Generator`` on the host, both seeded with the step's integer seed)
and hands the draws to an inner function (``_white_box_attack``,
``_multiview_augmentation``, ``_simaug_loss``) that takes them as
tensors.

Gradients. The attack differentiates the class cross entropy with
respect to the scene input alone: the parameters are detached
(:func:`_detached`, the counterpart of ``jax.lax.stop_gradient(params)``),
``torch.autograd.grad`` runs on an input leaf and frees each tower's
graph, and the adversarial features come back detached, so the outer
loss never differentiates through the attack. On the card's bf16 path
the class decoder's graph attention runs K4 forward and K5 backward in
every tower pass (``ops/gnn.gnn_step_auto``); in the attack K5's dnode
carries the input gradient, node -> scene mean -> scene conv pyramid ->
features.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multiverse_torch.config import MultiverseConfig
from multiverse_torch.geometry import one_hot_grid
from multiverse_torch.models.multiverse import (
    _site_generator,
    greedy_decode,
    huber_loss,
)
from multiverse_torch.ops import conv2d, convlstm_scan
from multiverse_torch.ops.layers import (
    _named_leaves,
    get_activation,
    l2_weight_decay,
)
from multiverse_torch.train.trainer import gradients


@dataclasses.dataclass(frozen=True)
class SimAugConfig(MultiverseConfig):
    """MultiverseConfig + SimAug training knobs
    (reference: SimAug/code/train.py:109-144)."""

    adv_train: bool = False
    adv_epsilon: float = 0.1
    adv_step_size: float = 0.001
    adv_num_iter: int = 30
    adv_start_from_clean_prob: float = 0.0
    adv_use_fgsm: bool = False
    norm_feat: bool = False
    standard_aug: bool = False
    use_mixup: bool = False
    mixup_alpha: float = 1.0
    mixup_mix_adv: bool = False
    multiview_train: bool = False
    multiview_max_num: int = 3
    multiview_exp: int = 3
    multiview_random: bool = False
    multiview_max_weight_for_first: bool = False
    multiview_use_adv_for_loss: bool = False
    double_weighting: bool = False
    fl_gamma: float = 1.0

    def validate(self) -> "SimAugConfig":
        super().validate()
        if (self.adv_train or self.multiview_train) \
                and sum(self.use_grids) != 1:
            raise ValueError("adv/multiview training needs exactly one "
                             "active grid scale")
        if not self.use_scene_enc:
            # the SimAug tower always convolves the scene input; the
            # reference has no scene-encoder-off mode (SimAug/code/
            # train.py:97 comments the flag out)
            raise ValueError(
                "SimAug training requires use_scene_enc=True "
                "(the SimAug tower always convolves the scene input)")
        return self


class MultiviewBatch(NamedTuple):
    """A training batch with the M extra camera views of each agent
    (built by :class:`multiverse_torch.data.multiview.MultiviewDataset`;
    ``data.dataset.batch_to_device`` uploads it)."""

    obs_grid_class: torch.Tensor       # [N, S, T_obs] int32
    obs_grid_target: torch.Tensor      # [N, T_obs, h, w, 2] active scale
    obs_scene: torch.Tensor            # [N, T_obs] int32 -> scene_feat rows
    scene_feat: torch.Tensor           # [F, SH, SW, C] uint8 one-hot maps
    pred_grid_class: torch.Tensor      # [N, S, T_pred] int32
    pred_grid_target: torch.Tensor     # [N, T_pred, h, w, 2]
    obs_grid_class_extra: Optional[torch.Tensor] = None   # [N, M, T_obs]
    pred_grid_class_extra: Optional[torch.Tensor] = None  # [N, M, T_pred]
    obs_scene_extra: Optional[torch.Tensor] = None        # [N, M, T_obs]


class MixInfo(NamedTuple):
    beta_weight: torch.Tensor      # [] mixup weight of the first feature
    selected_idx: torch.Tensor     # [N] which extra view was mixed in
    focal_weight: torch.Tensor     # [N] (1 - exp(-hardest loss))^gamma


class Draws(NamedTuple):
    """The random draws of one SimAug step; a field the configuration
    does not use stays None.

    * ``noise``, ``noise2``: attack starts, U(-eps, eps) times the keep
      draw of ``adv_start_from_clean_prob`` (None: the clean input);
    * ``offset``: the white-box targets' offsets, [N, T_pred] in
      [1, h*w);
    * ``view``: [N] in [0, M), multiview exp 2's first view or exp 3's
      random pick; ``view_offset``: [N] in [1, M), exp 2's second view;
    * ``beta``: the Beta(alpha, alpha) mixup weight;
    * ``attack_dropout``, ``dropout``: the dropout seeds of the attack's
      first tower pass and of the outer pass (None at keep_prob 1);
    * ``jitter``: standard_aug's U(-eps, eps) noise.
    """

    noise: Optional[torch.Tensor] = None
    noise2: Optional[torch.Tensor] = None
    offset: Optional[torch.Tensor] = None
    view: Optional[torch.Tensor] = None
    view_offset: Optional[torch.Tensor] = None
    beta: float = 0.5
    attack_dropout: Optional[int] = None
    jitter: Optional[torch.Tensor] = None
    dropout: Optional[int] = None


# ------------------------------------------------------------- draws


class StepRng:
    """The two sources of one step's draws, both seeded with its seed."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.host = np.random.default_rng(seed)

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return lo + (hi - lo) * u

    def randint(self, lo: int, hi: int, shape) -> torch.Tensor:
        return torch.randint(lo, hi, tuple(shape), generator=self.gen,
                             device=self.device, dtype=torch.int64)

    def beta(self, alpha: float) -> float:
        # one scalar a step, drawn on the host (torch's Beta takes no
        # generator); rounded to f32 as the features it weighs
        return float(np.float32(self.host.beta(alpha, alpha)))

    def seed(self, cfg: SimAugConfig) -> Optional[int]:
        if cfg.keep_prob >= 1.0:
            return None
        return int(self.host.integers(0, 2 ** 28))

    def start_noise(self, shape, cfg: SimAugConfig):
        """The random start of an attack (reference:
        SimAug/code/pred_models.py:76-89): uniform +-eps noise, kept
        with probability 1 - adv_start_from_clean_prob."""
        p = cfg.adv_start_from_clean_prob
        if p >= 1.0:
            return None
        noise = self.uniform(shape, -cfg.adv_epsilon, cfg.adv_epsilon)
        if p > 0:
            keep = (torch.rand((), generator=self.gen, device=self.device)
                    > p).float()
            noise = noise * keep
        return noise


def attack_draws(cfg: SimAugConfig, rng: StepRng, scene_shape,
                 labels_shape) -> Draws:
    """The draws of :func:`white_box_attack`."""
    h, w = cfg.scene_grids[cfg.active_scales[0]]
    return Draws(
        offset=rng.randint(1, h * w, labels_shape),
        noise=rng.start_noise(scene_shape, cfg),
        noise2=rng.start_noise(scene_shape, cfg)
        if cfg.use_mixup and cfg.mixup_mix_adv else None,
        beta=rng.beta(cfg.mixup_alpha) if cfg.use_mixup else 0.5,
        attack_dropout=rng.seed(cfg))


def multiview_draws(cfg: SimAugConfig, rng: StepRng, scene_shape,
                    num_views: int) -> Draws:
    """The draws of :func:`multiview_augmentation` for a current view of
    ``scene_shape`` ([N, T_obs, SH, SW, C]) and ``num_views`` extra
    views."""
    N, M = scene_shape[0], num_views
    tiled = (N * M,) + tuple(scene_shape[1:])
    exp = cfg.multiview_exp
    view = view_offset = None
    if exp == 2 or (exp == 3 and cfg.multiview_random):
        view = rng.randint(0, M, (N,))
    if exp == 2:
        view_offset = rng.randint(1, M, (N,))
    return Draws(
        noise=rng.start_noise(tiled, cfg),
        noise2=rng.start_noise(tiled, cfg)
        if exp == 3 and cfg.multiview_use_adv_for_loss else None,
        view=view, view_offset=view_offset,
        beta=rng.beta(cfg.mixup_alpha), attack_dropout=rng.seed(cfg))


def step_draws(cfg: SimAugConfig, batch: MultiviewBatch, seed: int) -> Draws:
    """Every draw of one :func:`simaug_loss` step from its seed."""
    N, T_obs = batch.obs_scene.shape
    scene_shape = (N, T_obs) + tuple(batch.scene_feat.shape[1:])
    rng = StepRng(seed, batch.obs_grid_class.device)
    if cfg.adv_train:
        draws = attack_draws(cfg, rng, scene_shape,
                             (N, batch.pred_grid_class.shape[-1]))
    elif cfg.multiview_train:
        draws = multiview_draws(cfg, rng, scene_shape,
                                batch.pred_grid_class_extra.shape[1])
    else:
        draws = Draws()
    jitter = rng.uniform(scene_shape, -cfg.adv_epsilon, cfg.adv_epsilon) \
        if cfg.standard_aug else None
    return draws._replace(jitter=jitter, dropout=rng.seed(cfg))


def _pass_seed(base: Optional[int], it: int) -> Optional[int]:
    """The dropout seed of attack tower pass ``it`` (fresh masks per
    pass, as the reference's dropout re-samples inside its attack
    loop)."""
    return None if base is None else base + it


# ------------------------------------------------------------ forward


def _detached(params) -> dict:
    """The parameter tree as nested dicts of detached tensors, which
    share storage with ``params``: the attack's view of the weights. The
    model's own parameters keep ``requires_grad`` for the outer step."""
    tree: dict = {}
    for name, p in _named_leaves(params):
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = p.detach()
    return tree


def _compute_dtype(cfg) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def _site_rng(cfg, seed: Optional[int], site: int, device):
    # site 0 class encoder, 1 regression encoder, 2 class decoder,
    # 3 regression decoder: the JAX package's fold_in(rng, site)
    if seed is None or cfg.keep_prob >= 1.0:
        return None
    return _site_generator(seed, 0, site, device)


def tower_class_logits(params, scene_input: torch.Tensor,
                       obs_onehot: torch.Tensor, cfg: SimAugConfig,
                       T_pred: int,
                       dropout_rng: Optional[int] = None) -> torch.Tensor:
    """The class half of :func:`tower_forward`: scene conv pyramid up to
    the active scale, the scene (x) one-hot masked class encoder and the
    GNN-attended greedy class decode. [N, T_pred, h, w, 1]."""
    compute_dtype = _compute_dtype(cfg)
    act = get_activation(cfg.activation)
    N, T_obs = scene_input.shape[:2]
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    sp = params["scales"][str(i)]
    dev = scene_input.device

    feats = scene_input.reshape((N * T_obs,) + tuple(scene_input.shape[2:]))
    for k in range(i + 1):
        feats = conv2d(params[f"scene_conv{k + 1}"], feats, stride=2,
                       activation=act, compute_dtype=compute_dtype)
    scene_conv = feats.reshape(N, T_obs, h, w, cfg.scene_conv_dim)

    _, enc_last = convlstm_scan(sp["enc_class"], scene_conv * obs_onehot,
                                compute_dtype=compute_dtype,
                                remat=cfg.remat, keep_prob=cfg.keep_prob,
                                dropout_rng=_site_rng(cfg, dropout_rng, 0,
                                                      dev))
    scene_mean = torch.mean(scene_conv, dim=1) if cfg.use_gnn else None
    logits, _ = greedy_decode(
        sp, cfg,
        first_input=obs_onehot[:, -1],
        init_state=enc_last,
        T_pred=T_pred,
        emb_name="dec_class_emb",
        cell_name="dec_class",
        h2g_name="h2g_class",
        use_gnn=cfg.use_gnn,
        scene_mean=scene_mean,
        feedback="onehot",
        compute_dtype=compute_dtype,
        keep_prob=cfg.keep_prob,
        dropout_rng=_site_rng(cfg, dropout_rng, 2, dev),
    )
    return logits


def tower_forward(
    params,
    scene_input: torch.Tensor,     # [N, T_obs, SH, SW, C] float
    obs_onehot: torch.Tensor,      # [N, T_obs, h, w, 1] (may be mixed)
    obs_reg: torch.Tensor,         # [N, T_obs, h, w, 2]
    cfg: SimAugConfig,
    T_pred: Optional[int] = None,
    dropout_rng: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass from the raw scene features, one active scale
    (reference: SimAug/code/pred_models.py:544-720 ``build_tower``).
    Returns (class logits [N, T, h, w, 1], offsets [N, T, h, w, 2]).

    ``dropout_rng`` (an int seed) drives the train-time input dropout of
    the four cells when ``cfg.keep_prob`` < 1, one ``torch.Generator``
    per cell site (``models/multiverse._site_generator``). The class
    decode is composed (``allow_fused`` stays off: the fused decode step
    has no backward), so on the card's bf16 path its GNN is K4/K5."""
    T = T_pred or cfg.pred_len
    compute_dtype = _compute_dtype(cfg)
    i = cfg.active_scales[0]
    sp = params["scales"][str(i)]
    dev = scene_input.device
    logits = tower_class_logits(params, scene_input, obs_onehot, cfg, T,
                                dropout_rng)
    _, enc_reg_last = convlstm_scan(
        sp["enc_reg"], obs_reg, compute_dtype=compute_dtype,
        remat=cfg.remat, keep_prob=cfg.keep_prob,
        dropout_rng=_site_rng(cfg, dropout_rng, 1, dev))
    reg, _ = greedy_decode(
        sp, cfg,
        first_input=obs_reg[:, -1],
        init_state=enc_reg_last,
        T_pred=T,
        emb_name="dec_reg_emb",
        cell_name="dec_reg",
        h2g_name="h2g_reg",
        use_gnn=False,
        feedback="raw",
        compute_dtype=compute_dtype,
        keep_prob=cfg.keep_prob,
        dropout_rng=_site_rng(cfg, dropout_rng, 3, dev),
    )
    return logits, reg


def _per_example_ce(params, scene_input: torch.Tensor,
                    obs_onehot: torch.Tensor, labels: torch.Tensor,
                    cfg: SimAugConfig,
                    dropout_rng: Optional[int] = None) -> torch.Tensor:
    """Mean-over-time CE of the class head per example, [N] (the
    regression half of the tower does not reach it and is not run)."""
    h, w = cfg.scene_grids[cfg.active_scales[0]]
    N, T = labels.shape
    logits = tower_class_logits(params, scene_input, obs_onehot, cfg, T,
                                dropout_rng).reshape(N, T, h * w)
    log_p = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(log_p, 2, labels.long()[..., None])[..., 0]
    return ce.mean(dim=1)


# -------------------------------------------------------------- attack


def _input_grad(params, adv: torch.Tensor, obs_onehot: torch.Tensor,
                target: torch.Tensor, cfg: SimAugConfig,
                dropout_rng: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d sum(CE) / d adv, the per-example CE at adv) from one forward
    and one backward; the graph is freed before returning."""
    with torch.enable_grad():
        leaf = adv.detach().requires_grad_(True)
        ce = _per_example_ce(params, leaf, obs_onehot, target, cfg,
                             dropout_rng)
        grad, = torch.autograd.grad(ce.sum(), leaf)
    return grad, ce.detach()


def _attack_step_with_loss(params, adv, obs_onehot, target, cfg,
                           step_size: float, lower, upper,
                           dropout_rng: Optional[int] = None):
    """One signed-gradient step toward ``target`` clipped to [lower,
    upper] (reference: SimAug/code/pred_models.py:91-130
    ``one_step_attack``), and the per-example CE at ``adv`` from the same
    forward and backward."""
    grad, ce = _input_grad(params, adv, obs_onehot, target, cfg,
                           dropout_rng)
    return torch.clamp(adv - step_size * torch.sign(grad), lower,
                       upper), ce


def _start_adv(feature: torch.Tensor,
               noise: Optional[torch.Tensor]) -> torch.Tensor:
    return feature if noise is None else feature + noise


def white_box_attack(params, seed: int, scene_input: torch.Tensor,
                     labels: torch.Tensor, obs_onehot: torch.Tensor,
                     cfg: SimAugConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Targeted FGSM / PGD on the scene features (``--adv_train``;
    reference: SimAug/code/pred_models.py:60-172): random wrong targets,
    a random start, one FGSM step or ``adv_num_iter`` PGD steps inside
    the eps-ball around the clean feature, optional Beta mixup. Draws
    from ``seed``. Returns (adversarial features, detached; targets)."""
    draws = attack_draws(cfg, StepRng(seed, scene_input.device),
                         scene_input.shape, labels.shape)
    return _white_box_attack(params, draws, scene_input, labels,
                             obs_onehot, cfg)


def _white_box_attack(params, draws: Draws, scene_input, labels,
                      obs_onehot, cfg: SimAugConfig):
    params = _detached(params)
    h, w = cfg.scene_grids[cfg.active_scales[0]]
    eps = cfg.adv_epsilon
    # a random target other than the true label (reference :68-74)
    target = torch.remainder(labels.long() + draws.offset, h * w)
    lower = torch.clamp(scene_input - eps, -1.0, 1.0)
    upper = torch.clamp(scene_input + eps, -1.0, 1.0)
    start = _start_adv(scene_input, draws.noise)
    if cfg.norm_feat:
        start = torch.softmax(start, dim=-1)

    def step(adv, size, it):
        return _attack_step_with_loss(
            params, adv, obs_onehot, target, cfg, size, lower, upper,
            _pass_seed(draws.attack_dropout, it))[0]

    if cfg.adv_use_fgsm:
        adv = step(start, eps, 0)
    else:
        adv = start
        for it in range(cfg.adv_num_iter):
            adv = step(adv, cfg.adv_step_size, it)

    if cfg.use_mixup:
        weight = draws.beta
        if cfg.mixup_mix_adv:
            adv2 = step(_start_adv(scene_input, draws.noise2), eps,
                        cfg.adv_num_iter + 1)
            adv = adv2 * weight + adv * (1.0 - weight)
        else:
            adv = scene_input * weight + adv * (1.0 - weight)
    return adv.detach(), target


# ----------------------------------------------------------- multiview


def multiview_augmentation(params, seed: int, batch: MultiviewBatch,
                           scene_input: torch.Tensor, cfg: SimAugConfig
                           ) -> Tuple[torch.Tensor, MixInfo]:
    """The SimAug multi-view augmentation (``--multiview_train``;
    reference: SimAug/code/pred_models.py:346-541). The M views fold
    into the batch axis for one attack forward and backward at N*M
    rows; ``multiview_exp`` picks the pair of features that is mixed (3,
    the paper's: the adversarial feature of the hardest view and the
    clean feature of the selected view). Draws from ``seed``. Returns
    (augmented features, detached; MixInfo for the label mixing)."""
    draws = multiview_draws(cfg, StepRng(seed, scene_input.device),
                            scene_input.shape,
                            batch.pred_grid_class_extra.shape[1])
    return _multiview_augmentation(params, draws, batch, scene_input, cfg)


def _multiview_augmentation(params, draws: Draws, batch: MultiviewBatch,
                            scene_input, cfg: SimAugConfig):
    params = _detached(params)
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    N, T_obs = scene_input.shape[:2]
    M = batch.pred_grid_class_extra.shape[1]
    T_pred = batch.pred_grid_class_extra.shape[-1]
    eps = cfg.adv_epsilon
    rows = torch.arange(N, device=scene_input.device)

    def tile(x):
        # the current view's inputs across M (reference :420-446)
        return x[:, None].expand((N, M) + tuple(x.shape[1:])).reshape(
            (N * M,) + tuple(x.shape[1:]))

    scene_tiled = tile(scene_input)
    onehot_tiled = tile(one_hot_grid(batch.obs_grid_class[:, i], h, w))
    # attack toward each extra view's future
    target = batch.pred_grid_class_extra.reshape(N * M, T_pred)

    start = _start_adv(scene_tiled, draws.noise)
    # the multiview attack centres its clip bounds on the noised start
    # (reference :370-410), the single-view attack on the clean feature
    # (:132-136): both as published
    lower = torch.clamp(start - eps, -1.0, 1.0)
    upper = torch.clamp(start + eps, -1.0, 1.0)
    # the ranking loss is the CE at the attack start (reference
    # :374-398), from the attack step's own forward
    adv_out, view_loss = _attack_step_with_loss(
        params, start, onehot_tiled, target, cfg, eps, lower, upper,
        _pass_seed(draws.attack_dropout, 0))
    if cfg.multiview_exp == 3 and cfg.multiview_use_adv_for_loss:
        with torch.no_grad():
            view_loss = _per_example_ce(
                params, _start_adv(adv_out, draws.noise2), onehot_tiled,
                target, cfg, _pass_seed(draws.attack_dropout, 1))

    view_loss = view_loss.reshape(N, M)
    adv_out = adv_out.reshape((N, M) + tuple(scene_tiled.shape[1:]))
    # descending, ties in view order (padded views repeat the example,
    # so their losses tie), as jnp.argsort's stable sort
    order = torch.argsort(-view_loss, dim=1, stable=True)
    selected = order[:, 0]
    focal = torch.ones((N,), dtype=torch.float32, device=scene_input.device)

    exp = cfg.multiview_exp
    if exp == 1:
        feat1, feat2 = adv_out[rows, order[:, 0]], adv_out[rows, order[:, 1]]
    elif exp == 4:
        feat1 = adv_out[rows, order[:, M - 1]]
        feat2 = adv_out[rows, order[:, M - 2]]
    elif exp == 2:
        r1 = draws.view
        r2 = torch.remainder(r1 + draws.view_offset, M)
        feat1, feat2 = adv_out[rows, r1], adv_out[rows, r2]
        selected = r2
    elif exp == 3:
        hardest = torch.gather(view_loss, 1, order[:, :1])[:, 0]
        focal = (1.0 - torch.exp(-hardest)) ** cfg.fl_gamma
        feat1 = adv_out[rows, order[:, 0]]
        if cfg.multiview_random:
            selected = draws.view
        # the clean features of the selected extra view (reference
        # :508-517). Under norm_input they stay the raw [0, 1] maps while
        # the own view's are [-1, 1]: the reference's embedding lookup
        # does not rescale them, and the published algorithm mixes them
        # so
        frames = batch.obs_scene_extra[rows, selected]        # [N, T_obs]
        feat2 = batch.scene_feat[frames.reshape(-1).long()].reshape(
            (N, T_obs) + tuple(batch.scene_feat.shape[1:])).to(
            scene_input.dtype)
    else:
        raise ValueError("multiview_exp must be 1..4")

    weight = draws.beta
    if cfg.multiview_max_weight_for_first:
        weight = max(weight, 1.0 - weight)
    adv_final = feat1 * weight + feat2 * (1.0 - weight)
    info = MixInfo(
        beta_weight=torch.tensor(weight, dtype=torch.float32,
                                 device=scene_input.device),
        selected_idx=selected,
        focal_weight=focal.detach(),
    )
    return adv_final.detach(), info


# ------------------------------------------------------------ training


def scene_input_of(batch: MultiviewBatch, cfg: SimAugConfig) -> torch.Tensor:
    """The current view's f32 scene features [N, T_obs, SH, SW, C],
    scaled to [-1, 1] under ``norm_input`` (reference :283-286)."""
    N, T_obs = batch.obs_scene.shape
    x = batch.scene_feat[batch.obs_scene.reshape(-1).long()].reshape(
        (N, T_obs) + tuple(batch.scene_feat.shape[1:])).float()
    return x * 2.0 - 1.0 if cfg.norm_input else x


def simaug_loss(params, batch: MultiviewBatch, cfg: SimAugConfig,
                seed: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The SimAug training loss: the augmentation branch, the class CE
    (on mixed labels under multiview exp 3), the Huber offsets and the
    weight decay (reference: SimAug/code/pred_models.py:271-336,
    :616-636, :1370-1412). Draws from ``seed`` (:func:`step_draws`).
    Returns (total, {part: loss})."""
    cfg.validate()
    return _simaug_loss(params, batch, cfg, step_draws(cfg, batch, seed))


def _simaug_loss(params, batch: MultiviewBatch, cfg: SimAugConfig,
                 draws: Draws):
    scene_input, obs_onehot, mix = augment(params, batch, cfg, draws)
    return tower_loss(params, batch, cfg, scene_input, obs_onehot, mix,
                      draws.dropout)


def augment(params, batch: MultiviewBatch, cfg: SimAugConfig, draws: Draws
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[MixInfo]]:
    """The augmentation branch of a step on its draws: adv, else
    multiview, then the standard_aug jitter. Returns (the scene
    features, the class encoder's one-hot input, mixed with the selected
    view's under multiview exp 3, and the MixInfo or None), all
    detached."""
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    scene_input = scene_input_of(batch, cfg)
    obs_onehot = one_hot_grid(batch.obs_grid_class[:, i], h, w)
    mix: Optional[MixInfo] = None
    if cfg.adv_train:
        scene_input, _ = _white_box_attack(
            params, draws, scene_input, batch.pred_grid_class[:, i],
            obs_onehot, cfg)
    elif cfg.multiview_train:
        scene_input, mix = _multiview_augmentation(params, draws, batch,
                                                   scene_input, cfg)
        if cfg.multiview_exp == 3:
            rows = torch.arange(scene_input.shape[0],
                                device=scene_input.device)
            extra_oh = one_hot_grid(
                batch.obs_grid_class_extra[rows, mix.selected_idx], h, w)
            obs_onehot = (mix.beta_weight * obs_onehot
                          + (1.0 - mix.beta_weight) * extra_oh)
    if cfg.standard_aug:
        # pixel jitter baseline (reference :310-325)
        scene_input = (scene_input + draws.jitter).detach()
    return scene_input, obs_onehot, mix


def tower_loss(params, batch: MultiviewBatch, cfg: SimAugConfig,
               scene_input: torch.Tensor, obs_onehot: torch.Tensor,
               mix: Optional[MixInfo], dropout_rng: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of the outer tower pass on :func:`augment`'s output:
    the class CE on integer labels, or on the Beta-mixed one-hot labels
    (weighted by the focal weight under double_weighting) under
    multiview exp 3; masked or plain Huber offsets (delta 1); the weight
    decay. Returns (total, {part: loss})."""
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    N = batch.obs_grid_class.shape[0]
    T_pred = cfg.pred_len
    labels = batch.pred_grid_class[:, i].long()

    logits, reg = tower_forward(
        params, scene_input, obs_onehot, batch.obs_grid_target, cfg,
        T_pred=T_pred, dropout_rng=dropout_rng)
    log_p = torch.log_softmax(logits.reshape(N, T_pred, h * w), dim=-1)

    if mix is not None and cfg.multiview_exp == 3:
        rows = torch.arange(N, device=labels.device)
        extra_labels = batch.pred_grid_class_extra[rows, mix.selected_idx]
        onehot = torch.nn.functional.one_hot
        mixup = (mix.beta_weight * onehot(labels, h * w).float()
                 + (1.0 - mix.beta_weight)
                 * onehot(extra_labels.long(), h * w).float())
        ce = -torch.sum(mixup * log_p, dim=-1)                  # [N, T]
        if cfg.double_weighting:
            ce = ce * mix.focal_weight[:, None]
    else:
        ce = -torch.gather(log_p, 2, labels[..., None])[..., 0]
    ce = ce.mean() * cfg.grid_loss_weight

    hub = huber_loss(reg, batch.pred_grid_target)
    if cfg.mask_grid_regression:
        m = one_hot_grid(labels, h, w)                     # [N, T, h, w, 1]
        reg_loss = torch.sum(hub * m) / torch.clamp_min(
            torch.sum(m) * 2.0, 1.0)
    else:
        reg_loss = torch.mean(hub)
    reg_loss = reg_loss * cfg.grid_reg_loss_weight

    wd = l2_weight_decay(params, cfg.wd)
    total = ce + reg_loss + wd
    parts = {"grid%d_class" % i: ce, "grid%d_reg" % i: reg_loss,
             "wd": wd, "total": total}
    return total, parts


def make_simaug_train_step(cfg: SimAugConfig, tx):
    """``step(model, opt_state, batch, seed) -> losses``: one SimAug step
    on a trainable :class:`~multiverse_torch.models.Multiverse`, updated
    in place by ``tx`` (``train.trainer.Optimizer``). The losses stay on
    the device, detached."""
    from multiverse_torch.train.trainer import gradients

    def step(model, opt_state: dict, batch: MultiviewBatch, seed: int):
        total, parts = simaug_loss(model, batch, cfg, seed)
        tx.update(dict(model.named_parameters()), gradients(model, total),
                  opt_state)
        return {k: v.detach() for k, v in parts.items()}

    return step
