"""The port's analytic FLOP counts (``multiverse_torch/flops.py``)
against the JAX package's: every public function of both modules on the
same configurations (the published beam configuration, the README's
flagship, ``beam_size=40``, ``use_gnn=False``, and SimAug's steps:
multiview, PGD, FGSM with mix-up, clean), each configuration built in
each package's own config class from the same keyword arguments.
Tolerance 0: the counts equal as floats. Also the identities of
``tests/test_ops.py``'s accounting test on the port's module."""

import dataclasses

import pytest

from multiverse_torch import flops
from multiverse_torch.config import MultiverseConfig
from multiverse_torch.models.simaug import SimAugConfig
from multiverse_tpu import flops as jax_flops
from multiverse_tpu.config import MultiverseConfig as JaxConfig
from multiverse_tpu.models.simaug import SimAugConfig as JaxSimAugConfig

PUBLISHED = dict(scene_grid_strides=(2, 4), use_grids=(True, False),
                 use_gnn=True, use_scene_enc=True, use_beam_search=True,
                 beam_size=20, diverse_beam=True)
FLAGSHIP = dict(use_gnn=True, use_scene_enc=True, use_beam_search=True,
                beam_size=20, diverse_beam=True, diverse_gamma=0.01,
                fix_num_timestep=1, compute_dtype="bfloat16")
CONFIGS = {
    "published": PUBLISHED,
    "flagship": FLAGSHIP,
    "beam_40": dict(PUBLISHED, beam_size=40),
    "no_gnn": dict(PUBLISHED, use_gnn=False),
    "soft_grid_single_decoder": dict(PUBLISHED, use_soft_grid_class=True,
                                     use_single_decoder=True),
    "no_scene": dict(PUBLISHED, use_scene_enc=False, use_gnn=False),
    "tiny": dict(PUBLISHED, scene_h=12, scene_w=16, scene_class=5,
                 emb_size=8, enc_hidden_size=16, dec_hidden_size=16,
                 scene_conv_dim=8, obs_len=4, pred_len=5),
}
SIMAUG = {
    "multiview": dict(multiview_train=True, multiview_exp=3,
                      multiview_use_adv_for_loss=True, use_mixup=True,
                      double_weighting=True),
    "multiview_exp1": dict(multiview_train=True, multiview_exp=1),
    "pgd": dict(adv_train=True, adv_num_iter=30),
    "fgsm_mixup": dict(adv_train=True, adv_use_fgsm=True, use_mixup=True,
                       mixup_mix_adv=True),
    "clean": dict(),
}
SIMAUG_BASE = dict(use_gnn=True, use_scene_enc=True,
                   scene_grid_strides=(2, 4), use_grids=(True, False))


def _counts(module, cfg):
    """Every public function of ``module`` on ``cfg``."""
    h, w = cfg.scene_grids[0]
    d = cfg.dec_hidden_size
    return {
        "convlstm_step_flops": module.convlstm_step_flops(
            h, w, cfg.emb_size, d),
        "gnn_step_flops": module.gnn_step_flops(h, w, d,
                                                cfg.scene_conv_dim),
        "readout_step_flops": module.readout_step_flops(h, w, d),
        "beam_decode_flops": module.beam_decode_flops(cfg, 64, 25),
        "beam_decode_flops_13": module.beam_decode_flops(cfg, 7, 13),
        "beam_decode_flops_split": module.beam_decode_flops_split(
            cfg, 64, 25),
        "train_fwd_flops": module.train_fwd_flops(cfg, 20),
        "train_step_flops": module.train_step_flops(cfg, 20),
        "scene_cnn_flops": module.scene_cnn_flops(cfg, 8),
        "emb_conv_flops": module.emb_conv_flops(h, w, 2, cfg.emb_size),
        "train_segment_flops": module.train_segment_flops(cfg, 20),
        "tower_fwd_flops": module.tower_fwd_flops(cfg),
        "simaug_step_flops": module.simaug_step_flops(cfg, 20),
    }


def test_every_public_function_is_counted():
    names = sorted(n for n, v in vars(jax_flops).items()
                   if callable(v) and not n.startswith("_")
                   and getattr(v, "__module__", "") == jax_flops.__name__)
    port_names = sorted(n for n, v in vars(flops).items()
                        if callable(v) and not n.startswith("_")
                        and getattr(v, "__module__", "") == flops.__name__)
    assert port_names == names
    cfg = MultiverseConfig(**PUBLISHED).validate()
    assert set(names) <= set(_counts(flops, cfg))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_counts_equal_jax(name):
    got = _counts(flops, MultiverseConfig(**CONFIGS[name]).validate())
    want = _counts(jax_flops, JaxConfig(**CONFIGS[name]).validate())
    assert got == want
    assert all(v > 0 for k, v in got.items() if not isinstance(v, dict))


@pytest.mark.parametrize("name", list(SIMAUG))
def test_simaug_counts_equal_jax(name):
    kw = dict(SIMAUG_BASE, **SIMAUG[name])
    got = _counts(flops, SimAugConfig(**kw).validate())
    want = _counts(jax_flops, JaxSimAugConfig(**kw).validate())
    assert got == want


def test_configs_match_field_for_field():
    """The counts read the same fields: the two config classes agree on
    every field the configurations above set or default."""
    for kw in CONFIGS.values():
        a = dataclasses.asdict(MultiverseConfig(**kw).validate())
        b = dataclasses.asdict(JaxConfig(**kw).validate())
        assert {k: a[k] for k in b if k in a} == {k: b[k] for k in b if k in a}


def test_analytic_flops_accounting_identities():
    """``tests/test_ops.py``'s identities on the port's module."""
    assert flops.convlstm_step_flops(18, 32, 32, 256) == \
        2 * 576 * 9 * 288 * 1024
    assert flops.gnn_step_flops(18, 32, 256, 64) == \
        2 * 576 * 576 * (256 + 64) + 2 * 576 * 576 * 256
    cfg = MultiverseConfig(**PUBLISHED).validate()
    f1 = flops.beam_decode_flops(cfg, 64, 25)
    f2 = flops.beam_decode_flops(cfg.replace(beam_size=40).validate(), 64, 25)
    assert 1.7 < f2 / f1 < 2.0
    assert 50e12 < f1 < 200e12
    assert flops.train_step_flops(cfg, 20) == \
        3.0 * flops.train_fwd_flops(cfg, 20)
    assert flops.train_fwd_flops(cfg.replace(use_gnn=False), 20) < \
        flops.train_fwd_flops(cfg, 20)
    split = flops.beam_decode_flops_split(cfg, 64, 25)
    assert split["int8_gate"] + split["int8_attn"] \
        + split["bf16_rest"] == f1
    assert split["bf16_readout_class"] / f1 < 0.002
    assert split["int8_gate"] / f1 > 0.5
