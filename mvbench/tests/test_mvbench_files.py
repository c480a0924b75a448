"""The benchmark's files load by name and agree with BENCHMARK.json; the
frozen copies agree with the program they were copied from."""

import json
import re

import numpy as np
import pytest
import torch

from mvbench import run
from mvbench.arith import flops, roofline
from mvbench.drivers.decode import decode_config
from mvbench.traffic import generators
from mvbench.weights import leaf_shapes, make_weights

SPEC = run.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FLAGSHIP = run.load_json("configs", "multiverse_flagship")
SMALL = dict(emb_size=8, enc_hidden_size=16, dec_hidden_size=16,
             scene_conv_dim=8, scene_h=12, scene_w=16)


def test_benchmark_names_files_and_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert NAME.match(c["name"])
        assert c["file"] == "mvbench/configs/%s.json" % c["name"]
        assert run.load_json("configs", c["name"])["reduced"] == c["reduced"]
    configs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["traffic"] == w["name"]
        wl = run.load_json("workloads", w["name"])
        assert wl["config"] == w["config"] in configs
        assert wl["chips"] == w["chips"] == 1
        assert len(w["why"]) <= 200
        run.load_module("drivers", wl["driver"])
        metrics = [m["name"] for m in run.cell_metrics(w["name"],
                                                       "end_to_end")]
        assert "setup_s" in metrics and len(metrics) >= 2
        assert run.cell_metrics(w["name"], "per_layer")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert hasattr(run.load_module("metrics", m["name"]), "read")
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_configs_are_the_published_commands():
    dec, args = decode_config(FLAGSHIP["decode_flags"])
    sizes = FLAGSHIP["sizes"]
    for k in ("obs_len", "pred_len", "scene_h", "scene_w", "scene_class",
              "scene_conv_dim", "emb_size", "enc_hidden_size",
              "dec_hidden_size"):
        assert getattr(dec, k) == sizes[k], k
    assert list(dec.scene_grids[dec.active_scales[0]]) == sizes["grid"]
    assert dec.compute_dtype == "bfloat16"
    assert (dec.beam_size, dec.diverse_beam, dec.diverse_gamma,
            dec.fix_num_timestep, dec.decode_quant, args.batch_size) == \
        (20, True, 0.01, 1, "none", 16)
    model = {**dec.__dict__, **{"use_grids": dec.use_grids}}
    n = sum(int(np.prod(s)) for _, s, _ in leaf_shapes(model))
    assert n == sizes["parameters"]


def test_weights_have_the_programs_layout():
    from multiverse_torch.config import MultiverseConfig
    from multiverse_torch.models import init_params
    from mvbench.weights import nest

    cfg = MultiverseConfig(**SMALL).validate()
    model = dict(cfg.__dict__)
    ours = make_weights(model, 2**31 + 11, "cpu")
    theirs = {}

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, pre + k + ".")
            else:
                theirs[pre + k] = tuple(v.shape)

    flat(init_params(cfg, torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in ours.items()} == theirs
    again = make_weights(model, 2**31 + 11, "cpu")
    assert all(torch.equal(ours[k], again[k]) for k in ours)
    assert set(nest(ours)) == {"scene_conv1", "scene_conv2", "scales"}


def test_generators_are_the_programs():
    from multiverse_torch.config import MultiverseConfig
    from multiverse_torch.inference import synthesize_multifuture_inputs

    cfg = MultiverseConfig(**SMALL).validate()
    model = dict(cfg.__dict__)
    ours = generators.multifuture_inputs(model, 12, 5, cfg.pred_len, 25)
    theirs = synthesize_multifuture_inputs(cfg, 12, seed=5, max_pred_len=25)
    for k in ("obs_traj", "obs_grid_class", "obs_scene", "scene_feat",
              "pred_lengths"):
        np.testing.assert_array_equal(ours[k], getattr(theirs, k))
    for a, b in zip(ours["obs_grid_target"], theirs.obs_grid_target):
        np.testing.assert_array_equal(a, b)
    assert ours["traj_ids"] == theirs.traj_ids
    big = generators.multifuture_inputs(model, 3, 2**31 + 7, cfg.pred_len,
                                        25)
    assert big["obs_traj"].shape == (3, cfg.obs_len, 2)


def test_frozen_arithmetic_pins():
    """The numbers known when the benchmark was defined."""
    from multiverse_torch.models.simaug import SimAugConfig

    dec, _ = decode_config(FLAGSHIP["decode_flags"])
    assert flops.beam_decode_flops(dec, 16, 25) / 1e12 == pytest.approx(
        29.42, abs=5e-3)
    assert flops.scene_cnn_flops(dec, 16 * 8) / 1e12 == pytest.approx(
        0.0023, abs=5e-5)
    assert flops.train_step_flops(dec, 20) / 1e12 == pytest.approx(
        7.40, abs=5e-3)
    sim = SimAugConfig(batch_size=12, multiview_train=True, multiview_exp=3)
    assert flops.simaug_step_flops(sim, 12) / 1e12 == pytest.approx(
        13.75, abs=5e-3)
    b = roofline.decode_step_bound(320, 18, 32, 256, 32, 64, 320)
    assert b["bound_ms"] == pytest.approx(0.9921, abs=5e-5)
    assert b["bound_by"] == "operations"
    g = roofline.gnn_bounds(20 * 576, 320, 256, 18, 32)
    assert g["K4"]["bytes"] / 1e6 == pytest.approx(25.1, abs=0.05)
    assert g["K5"]["bytes"] / 1e6 == pytest.approx(38.3, abs=0.05)
    assert roofline.PEAK_OPS == {"bf16": 989e12, "int8": 1979e12}
    assert roofline.HBM_BYTES_S == 3.35e12
