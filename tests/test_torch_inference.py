"""The port's inference slice against the JAX package on the CPU:
``beam_forward`` in f32 (ids equal, offsets within 1e-4) and in bf16
through the fused-step wiring (step-0 logits within 2e-2), the offline
run's pickles scored by the JAX package's evaluators, the CLI, and the
guarantees that the port imports nothing of jax or of the JAX package
and never falls back from CUDA to the CPU."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu import inference as jinf
from multiverse_tpu.config import MultiverseConfig
from multiverse_tpu.eval.multifuture import (
    evaluate_multifuture_nll,
    evaluate_multifuture_trajs,
)
from multiverse_tpu.models import init_params as jax_init_params
from multiverse_torch import inference as tinf
from multiverse_torch.bridge import params_from_jax, save_params_npz
from multiverse_torch.cli import multifuture_inference as tcli
from multiverse_torch.data.dataset import batch_to_device
from synthetic import write_multifuture_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    base = dict(
        scene_h=12, scene_w=16, scene_class=5, video_h=540, video_w=960,
        enc_hidden_size=16, dec_hidden_size=16, scene_conv_dim=8,
        emb_size=8, use_beam_search=True, beam_size=4, use_gnn=True,
        use_scene_enc=True, diverse_beam=True, diverse_gamma=0.01,
        fix_num_timestep=1, obs_len=8, pred_len=4)
    base.update(kw)
    return MultiverseConfig(**base).validate()


def _params(cfg):
    jparams = jax_init_params(jax.random.PRNGKey(1), cfg)
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


def _batches(cfg, n=5):
    inputs = jinf.synthesize_multifuture_inputs(cfg, n, seed=0,
                                                max_pred_len=6)
    jb = jax.tree_util.tree_map(
        jnp.asarray, jinf.make_batch(inputs, np.arange(n), cfg))
    tb = batch_to_device(tinf.make_batch(inputs, np.arange(n), cfg),
                         torch.device("cpu"))
    return jb, tb


def test_synthesized_inputs_equal_jax():
    cfg = _cfg()
    a = jinf.synthesize_multifuture_inputs(cfg, 6, seed=3)
    b = tinf.synthesize_multifuture_inputs(cfg, 6, seed=3)
    assert a.traj_ids == b.traj_ids
    for x, y in zip(a[1:], b[1:]):
        for u, v in zip(x if isinstance(x, list) else [x],
                        y if isinstance(y, list) else [y]):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("kw", [{}, {"use_single_decoder": True}])
def test_beam_forward_f32_matches_jax(kw):
    cfg = _cfg(**kw)
    jparams, model = _params(cfg)
    jb, tb = _batches(cfg)
    jbeam, jreg = jinf.beam_forward(jparams, jb, cfg, T_pred=6)
    with torch.inference_mode():
        tbeam, treg = tinf.beam_forward(model, tb, cfg, T_pred=6)
    lengths = np.asarray(jb.pred_length)
    for n, t_n in enumerate(lengths):
        np.testing.assert_array_equal(np.asarray(jbeam.ids[n, :, :t_n]),
                                      tbeam.ids[n, :, :t_n].numpy())
        np.testing.assert_allclose(np.asarray(jreg[n, :t_n]),
                                   treg[n, :t_n].numpy(),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(jbeam.logprobs),
                               tbeam.logprobs.numpy(), rtol=1e-4, atol=1e-4)


def test_beam_forward_bf16_fused_wiring_tracks_jax(monkeypatch):
    """bf16 with the GNN on: JAX runs its fused Pallas step in interpret
    mode, the port its fused step's plain version (CPU tensors)."""
    from multiverse_tpu.ops import pallas_decode
    from multiverse_torch.ops import decode_step_gathered
    from multiverse_torch.ops import quant

    monkeypatch.setattr(pallas_decode, "FORCE_INTERPRET_FUSED", True)
    calls = []

    def counting(*args, **kw):
        calls.append(1)
        return decode_step_gathered(*args, **kw)

    monkeypatch.setattr(quant, "decode_step_gathered", counting)
    cfg = _cfg(compute_dtype="bfloat16")
    jparams, model = _params(cfg)
    jb, tb = _batches(cfg)
    jbeam, _ = jinf.beam_forward(jparams, jb, cfg, T_pred=6)
    with torch.inference_mode():
        tbeam, _ = tinf.beam_forward(model, tb, cfg, T_pred=6)
    assert len(calls) == 6 and decode_step_gathered.launches == 0
    np.testing.assert_allclose(np.asarray(jbeam.logits[:, :, 0]),
                               tbeam.logits[:, :, 0].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_run_multifuture_inference_f32_evaluates_like_jax(tmp_path):
    cfg = _cfg(obs_len=8)
    jparams, model = _params(cfg)
    rng = np.random.RandomState(0)
    traj_p, mf_p, scene_p, id2name = write_multifuture_dataset(
        str(tmp_path), cfg, rng, num_traj=5, num_futures=3, max_pred_len=6)
    j_in = jinf.load_multifuture_inputs(traj_p, mf_p, scene_p, id2name, cfg)
    t_in = tinf.load_multifuture_inputs(traj_p, mf_p, scene_p, id2name, cfg)
    np.testing.assert_array_equal(j_in.obs_grid_class, t_in.obs_grid_class)
    np.testing.assert_array_equal(j_in.scene_feat, t_in.scene_feat)

    j_out, j_prob = jinf.run_multifuture_inference(jparams, j_in, cfg,
                                                   batch_size=4)
    t_out, t_prob = tinf.run_multifuture_inference(model, t_in, cfg,
                                                   batch_size=4,
                                                   device="cpu")
    # the same pickled types as the JAX package writes
    tid = j_in.traj_ids[0]
    assert type(t_out[tid][0][0]) is type(j_out[tid][0][0])
    assert t_out[tid][0][0].dtype == j_out[tid][0][0].dtype
    for a, b in zip(t_prob[tid], j_prob[tid]):
        assert a.dtype == b.dtype and a.shape == b.shape
    paths = {}
    for name, out, prob in (("jax", j_out, j_prob), ("torch", t_out, t_prob)):
        paths[name] = (str(tmp_path / f"{name}.traj.p"),
                       str(tmp_path / f"{name}.prob.p"))
        tinf.save_outputs(out, prob, *paths[name])

    def scores(name):
        traj_file, prob_file = paths[name]
        with open(traj_file, "rb") as f:
            trajs = pickle.load(f)
        with open(prob_file, "rb") as f:
            probs = pickle.load(f)
        h, w = cfg.scene_grids[0]
        first = next(iter(probs.values()))
        assert first[0].dtype == np.float32 and first[0].shape[-1] == h * w
        return {**evaluate_multifuture_trajs(trajs, mf_p),
                **evaluate_multifuture_nll(probs, mf_p, h, w, cfg.video_h,
                                           cfg.video_w)}

    s_jax, s_torch = scores("jax"), scores("torch")
    assert set(s_jax) == set(s_torch)
    for key in s_jax:
        np.testing.assert_allclose(s_torch[key], s_jax[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize("center_only", [False, True])
def test_reconstruct_beam_trajs_matches_jax(rng, center_only):
    from multiverse_tpu.geometry import grid_centers

    ids = rng.randint(0, 48, (2, 3, 5)).astype(np.int32)
    reg = rng.randn(2, 5, 6, 8, 2).astype(np.float32)
    centers = grid_centers(540, 960, 6, 8).reshape(-1, 2).astype(np.float32)
    j = jinf.reconstruct_beam_trajs(jnp.asarray(ids), jnp.asarray(reg),
                                    jnp.asarray(centers), center_only)
    t = tinf.reconstruct_beam_trajs(torch.from_numpy(ids),
                                    torch.from_numpy(reg),
                                    torch.from_numpy(centers), center_only)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-6,
                               atol=1e-4)


def test_prob_fetch_float16_and_need_prob_false():
    cfg = _cfg()
    _, model = _params(cfg)
    inputs = tinf.synthesize_multifuture_inputs(cfg, 3, seed=0,
                                                max_pred_len=6)
    out32, prob32 = tinf.run_multifuture_inference(model, inputs, cfg,
                                                   batch_size=2, device="cpu")
    out16, prob16 = tinf.run_multifuture_inference(
        model, inputs, cfg, batch_size=2, device="cpu",
        prob_fetch_dtype="float16")
    bare, empty = tinf.run_multifuture_inference(
        model, inputs, cfg, batch_size=2, device="cpu", need_prob=False)
    assert empty == {}
    for tid in inputs.traj_ids:
        np.testing.assert_array_equal(np.asarray(out16[tid]),
                                      np.asarray(out32[tid]))
        np.testing.assert_array_equal(np.asarray(bare[tid]),
                                      np.asarray(out32[tid]))
        assert prob16[tid][0].dtype == np.float32
        # f16 keeps ~3 decimal digits of the bounded class scores
        np.testing.assert_allclose(prob16[tid][0], prob32[tid][0],
                                   rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="prob_fetch_dtype"):
        tinf.run_multifuture_inference(model, inputs, cfg, device="cpu",
                                       prob_fetch_dtype="bfloat16")


def test_cli_writes_both_pickles_and_rejects_unported_modes(tmp_path,
                                                            capsys):
    cfg = _cfg(obs_len=8)
    _, model = _params(cfg)
    npz = str(tmp_path / "params.npz")
    save_params_npz(model, npz)
    traj_p, mf_p, scene_p, id2name = write_multifuture_dataset(
        str(tmp_path), cfg, np.random.RandomState(1), num_traj=3,
        max_pred_len=6)
    out, prob = str(tmp_path / "o.traj.p"), str(tmp_path / "o.prob.p")
    args = [npz, traj_p, mf_p, out, "--device", "cpu",
            "--save_prob_file", prob, "--scene_feat_path", scene_p,
            "--scene_id2name", id2name, "--num_out", "4", "--use_gnn",
            "--use_scene_enc", "--diverse_beam", "--diverse_gamma", "0.01",
            "--fix_num_timestep", "1", "--scene_h", "12", "--scene_w", "16",
            "--scene_class", "5", "--video_h", "540", "--video_w", "960",
            "--emb_size", "8", "--enc_hidden_size", "16",
            "--dec_hidden_size", "16", "--scene_conv_dim", "8"]
    tcli.main(args)
    with open(out, "rb") as f:
        trajs = pickle.load(f)
    with open(prob, "rb") as f:
        probs = pickle.load(f)
    assert len(trajs) == 3 and set(probs) == set(trajs)
    for tid, beams in trajs.items():
        assert np.asarray(beams).shape[:1] == (4,)
        assert probs[tid][0].shape[:2] == (1, 4)
    # the dynamic-scale tier (K7) writes both pickles too
    os.remove(out)
    os.remove(prob)
    tcli.main(args + ["--decode_quant", "int8_dyn"])
    with open(out, "rb") as f:
        dyn_trajs = pickle.load(f)
    with open(prob, "rb") as f:
        dyn_probs = pickle.load(f)
    assert set(dyn_trajs) == set(trajs) and set(dyn_probs) == set(trajs)
    for tid, beams in dyn_trajs.items():
        assert np.asarray(beams).shape == np.asarray(trajs[tid]).shape
        assert np.isfinite(np.asarray(beams)).all()
        assert dyn_probs[tid][0].shape == probs[tid][0].shape
    # greedy decode has no beams for the .prob.p output
    with pytest.raises(SystemExit, match="requires beam search"):
        tcli.main(args + ["--greedy"])
    with pytest.raises(ValueError, match=r"params\.scene_conv1\.b: "
                       r"checkpoint shape \(8,\) != model shape \(4,\)"):
        tcli.main(args[:-2] + ["--scene_conv_dim", "4"])


def test_cuda_request_raises_without_cuda():
    """No fallback: asking for the GPU on a machine without one raises
    instead of decoding on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = _cfg()
    _, model = _params(cfg)
    inputs = tinf.synthesize_multifuture_inputs(cfg, 2, seed=0,
                                                max_pred_len=5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.run_multifuture_inference(model, inputs, cfg, device="cuda")


def test_cli_profile_writes_trace_and_spans(tmp_path):
    """``--profile DIR``: the Chrome trace holds the program's spans as
    ranges, and ``spans.json`` each span's count and self time."""
    import json

    cfg = _cfg(obs_len=8)
    traj_p, mf_p, scene_p, id2name = write_multifuture_dataset(
        str(tmp_path), cfg, np.random.RandomState(1), num_traj=3,
        max_pred_len=6)
    prof = tmp_path / "prof"
    tcli.main(["unused", traj_p, mf_p, str(tmp_path / "o.traj.p"),
               "--random_init", "--device", "cpu", "--profile", str(prof),
               "--scene_feat_path", scene_p, "--scene_id2name", id2name,
               "--num_out", "4", "--use_gnn", "--use_scene_enc",
               "--diverse_beam", "--diverse_gamma", "0.01",
               "--fix_num_timestep", "1", "--scene_h", "12", "--scene_w",
               "16", "--scene_class", "5", "--video_h", "540", "--video_w",
               "960", "--emb_size", "8", "--enc_hidden_size", "16",
               "--dec_hidden_size", "16", "--scene_conv_dim", "8",
               "--batch_size", "2"])
    with open(prof / "spans.json") as f:
        got = json.load(f)
    assert got["dropped"] == 0
    spans = got["spans"]
    assert spans["decode.batch"]["count"] == 2
    assert spans["beam.step"]["count"] == got["counters"]["beam.steps"] > 0
    for v in spans.values():
        assert 0 <= v["self_s"] <= v["total_s"]
    with open(prof / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"decode.batch", "beam.step", "beam.select"} <= names


# --------------------------------------------- the offline decode's graphs


def _part_inputs(cfg, n=4, seed=0):
    inputs = tinf.synthesize_multifuture_inputs(cfg, n + 1, seed=seed,
                                                max_pred_len=6)
    b = batch_to_device(tinf.make_batch(inputs, np.arange(n), cfg),
                        torch.device("cpu"))
    return (b.obs_grid_class, b.obs_scene, b.scene_feat)


def test_graphs_apply_only_to_a_cache_and_cuda_tensors():
    from types import SimpleNamespace

    from multiverse_torch.decode_graphs import GraphCache, graphs_apply

    on_card = SimpleNamespace(is_cuda=True)
    on_cpu = torch.zeros(2)
    assert graphs_apply(GraphCache(), [on_card, on_card])
    assert not graphs_apply(None, [on_card])
    assert not graphs_apply(GraphCache(), [on_cpu])
    assert not graphs_apply(GraphCache(), [on_card, on_cpu])


def test_graph_key_hits_the_same_shapes_and_weights():
    from multiverse_torch.decode_graphs import graph_key

    cfg = _cfg()
    _, model = _params(cfg)
    weights = tinf._encode_weights(model, cfg)
    a = graph_key("encode", cfg, 6, _part_inputs(cfg, seed=0), weights)
    # other values of the same shapes, weights updated in place
    with torch.no_grad():
        weights[0].add_(1.0)
    b = graph_key("encode", cfg, 6, _part_inputs(cfg, seed=5),
                  tinf._encode_weights(model, cfg))
    assert a == b and hash(a) == hash(b)
    # every parameter each part reads, and no other
    names = {n for n, p in model.named_parameters()
             if any(p is w for w in weights)}
    assert names == {"scene_conv1.w", "scene_conv1.b", "scene_conv2.w",
                     "scene_conv2.b", "scales.0.enc_class.kernel",
                     "scales.0.enc_class.bias"}
    reg = {n for n, p in model.named_parameters()
           if any(p is w for w in tinf._reg_weights(model, cfg))}
    assert reg == {"scales.0.enc_reg.kernel", "scales.0.enc_reg.bias",
                   "scales.0.dec_reg.kernel", "scales.0.dec_reg.bias",
                   "scales.0.dec_reg_emb.w", "scales.0.dec_reg_emb.b",
                   "scales.0.h2g_reg.w"}


@pytest.mark.parametrize("change", ["part", "N", "T", "tier", "dtype",
                                    "device", "new_weights"])
def test_graph_key_misses_on_what_a_capture_depends_on(change):
    from multiverse_torch.decode_graphs import graph_key

    cfg = _cfg()
    _, model = _params(cfg)
    inputs = _part_inputs(cfg)
    weights = tinf._encode_weights(model, cfg)
    args = dict(part="encode", cfg=cfg, T=6, inputs=inputs, weights=weights)
    if change == "part":
        args["part"] = "reg"
    elif change == "N":
        args["inputs"] = _part_inputs(cfg, n=3)
    elif change == "T":
        args["T"] = 7
    elif change == "tier":
        args["cfg"] = cfg.replace(compute_dtype="bfloat16")
    elif change == "dtype":
        args["inputs"] = (inputs[0].long(),) + inputs[1:]
    elif change == "device":
        args["inputs"] = inputs[:2] + (inputs[2].to("meta"),)
    else:
        # the same values in new tensors (weights loaded by replacing them)
        model.load_state_dict(
            {k: v.clone() for k, v in model.state_dict().items()},
            assign=True)
        args["weights"] = tinf._encode_weights(model, cfg)
    assert graph_key(**args) != graph_key("encode", cfg, 6, inputs, weights)


def test_graph_cache_hits_and_evicts_the_oldest():
    from multiverse_torch.decode_graphs import CAPACITY, GraphCache

    made = []

    def make(k):
        return lambda: made.append(k) or ("entry", k)

    cache = GraphCache(capacity=2)
    assert cache.get("a", make("a")) == ("entry", "a")
    assert cache.get("a", make("a")) == ("entry", "a")
    assert made == ["a"]
    cache.get("b", make("b"))
    cache.get("a", make("a"))       # a is now the most recent
    cache.get("c", make("c"))       # evicts b, the oldest
    assert "a" in cache and "c" in cache and "b" not in cache
    assert len(cache) == 2
    cache.get("b", make("b"))
    assert made == ["a", "b", "c", "b"] and "a" not in cache
    assert GraphCache().capacity == CAPACITY == 8


def test_graph_cache_follows_the_parameters_object():
    import gc
    import weakref

    from multiverse_torch.decode_graphs import graph_cache

    cfg = _cfg()
    _, model = _params(cfg)
    _, other = _params(cfg)
    assert graph_cache(model) is graph_cache(model)
    assert graph_cache(other) is not graph_cache(model)
    # the cache does not keep the parameters alive
    gone = weakref.ref(other)
    del other
    gc.collect()
    assert gone() is None


def test_cpu_decode_runs_eagerly_and_captures_nothing():
    """On the CPU the offline decode makes no cache and counts no
    capture or replay, while its other counters record; a part given a
    cache runs eagerly on CPU tensors."""
    from torch.profiler import ProfilerActivity, profile

    from multiverse_torch import utils
    from multiverse_torch.decode_graphs import _CACHES, GraphCache

    cfg = _cfg()
    _, model = _params(cfg)
    inputs = tinf.synthesize_multifuture_inputs(cfg, 3, seed=0,
                                                max_pred_len=6)
    utils.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        tinf.run_multifuture_inference(model, inputs, cfg, batch_size=2,
                                       device="cpu")
    cache = GraphCache()
    names = {c.name for c in utils.span_snapshot()["counters"]}
    assert "beam.steps" in names
    assert not names & {"decode.graph_captures", "decode.graph_replays"}
    assert model not in _CACHES
    # given a cache, CPU tensors still run eagerly, and the regression
    # head is not sent ahead of the class decode
    batch = batch_to_device(tinf.make_batch(inputs, np.arange(2), cfg),
                            torch.device("cpu"))
    with torch.inference_mode():
        enc = tinf._encode_part(model, batch, cfg, None, cache)
        want = tinf._encode(model, batch, cfg, None)
    assert torch.equal(enc[0], want[0]) and torch.equal(enc[1].h, want[1].h)
    assert tinf._reg_ahead(model, batch, cfg, 6, None, cache) is None
    assert tinf._reg_ahead(model, batch, cfg, 6, None, None) is None
    assert len(cache) == 0


def test_port_never_imports_jax():
    """With jax, the JAX package, orbax, tensorstore, zstandard and
    tensorflow made unimportable, every module of the port and chip_smoke.py import
    (SimAug's and the scoring modules among them), the beam, greedy,
    int8a and int8_dyn (beam and greedy) paths run on the CPU, and so do
    one bf16 train step through mvt-torch-train's own pieces, one
    tensor-parallel step of two ranks (dp 1 x mp 2, in spawned processes
    that end with none of those modules imported), one bf16 SimAug
    multiview step,
    one minADE scoring, one preprocessed split, the read of the
    committed orbax checkpoint of the JAX package (equal to the leaves
    made from its seed), one ``CheckpointManager.save`` read back equal,
    and ``mvt-torch-convert-tf`` of the committed TF bundle (equal to the
    leaves made from its seed). With cv2, yaml, pygame and transformers
    unimportable too, the data-preparation modules import,
    mvt-torch-prepare-multifuture prepares a tiny bbox-JSON dataset, and
    mvt-torch-sdd-frames and mvt-torch-get-vehicle-traj stop with an
    ImportError naming cv2 and yaml; the plotting modules (``vis``,
    ``vis.trajs`` and the five ``mvt-torch-vis-*`` CLI modules) import,
    and mvt-torch-vis-grid and mvt-torch-batch-plot-traj-carla parse
    their arguments and stop with an ImportError naming cv2 and the
    command, having written no file; the CARLA toolkit's modules import
    (camera, scenes, sim, candidates, annotation, editor, recorder,
    interactive, the moment commands), a camera projection, the packaged
    registry and a planned frame run, ``replay_moment`` replays a moment
    through ``tests/torch_fake_carla.py`` and mvt-torch-spectator stops
    with an ImportError naming pygame; so do scene_extract and flops; the
    campaign modules import, their walks run, build a moment's controls
    and install the port's fake carla."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'multiverse_tpu', 'orbax',\n"
        "             'tensorstore', 'zstandard', 'tensorflow', 'cv2',\n"
        "             'yaml', 'pygame', 'transformers'):\n"
        "    sys.modules[name] = None      # any import of them raises\n"
        "import multiverse_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    multiverse_torch.__path__, 'multiverse_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "from multiverse_torch import inference\n"
        "from multiverse_torch.config import MultiverseConfig\n"
        "from multiverse_torch.models import Multiverse\n"
        "cfg = MultiverseConfig(scene_h=12, scene_w=16, scene_class=5,\n"
        "    enc_hidden_size=16, dec_hidden_size=16, scene_conv_dim=8,\n"
        "    emb_size=8, beam_size=3, use_gnn=True, diverse_beam=True,\n"
        "    compute_dtype='bfloat16', use_beam_search=True).validate()\n"
        "inp = inference.synthesize_multifuture_inputs(cfg, 3, seed=0,\n"
        "                                              max_pred_len=13)\n"
        "for quant, greedy in (('none', False), ('int8a', False),\n"
        "                      ('int8', True), ('int8_dyn', False),\n"
        "                      ('int8_dyn', True)):\n"
        "    out, prob = inference.run_multifuture_inference(\n"
        "        Multiverse.init(cfg), inp, cfg.replace(decode_quant=quant),\n"
        "        batch_size=2, greedy=greedy, device='cpu')\n"
        "    assert len(out) == 3 and len(prob) == (0 if greedy else 3)\n"
        "from multiverse_torch.data import dataset\n"
        "from multiverse_torch.train import trainer\n"
        "tcfg = cfg.replace(use_beam_search=False, obs_len=4, pred_len=3,\n"
        "                   use_soft_grid_class=True, keep_prob=0.8)\n"
        "ds = dataset.dataset_from_arrays(dataset.synthesize_split(\n"
        "    tcfg, 4, seed=0), tcfg, 'train')\n"
        "model = Multiverse.init(tcfg, trainable=True)\n"
        "tx = trainer.build_optimizer(tcfg, 4)\n"
        "losses = trainer.make_train_step(tcfg, tx)(\n"
        "    model, tx.init(dict(model.named_parameters())),\n"
        "    dataset.batch_to_device(ds.make_batch([0, 1, 2, 3])[0], 'cpu'),\n"
        "    rng=1)\n"
        "assert float(losses['total']) > 0\n"
        "from multiverse_torch import parallel\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_parallel_ranks\n"
        "tp = parallel.launch(torch_parallel_ranks.tp_step_without_jax,\n"
        "    parallel.make_mesh(devices=['cpu'] * 2, model_parallel=2),\n"
        "    tcfg, timeout=200)\n"
        "assert all(loss > 0 and not mods for loss, mods in tp), tp\n"
        "for name in ('models.simaug', 'data.multiview', 'cli.train_simaug',\n"
        "             'eval.multifuture', 'eval.sdd',\n"
        "             'cli.multifuture_eval_trajs',\n"
        "             'cli.multifuture_eval_trajs_prob', 'cli.evaluate_sdd',\n"
        "             'data.preprocess', 'data.vocab', 'cli.preprocess',\n"
        "             'parallel', 'parallel.mesh', 'forking_paths.controls',\n"
        "             'forking_paths.moments', 'forking_paths.prepared_data',\n"
        "             'data.sdd', 'data.argoverse', 'cli.prepare_data',\n"
        "             'cli.vis_annotation', 'train.orbax_writer',\n"
        "             'tools.tf_bundle', 'tools.tf_converter',\n"
        "             'cli.convert_tf', 'vis', 'vis.trajs',\n"
        "             'cli.visualize_output', 'cli.visualize_grid',\n"
        "             'cli.vis_multifuture_trajs_video', 'cli.vis_dataset',\n"
        "             'cli.vis_real_data', 'forking_paths.camera',\n"
        "             'forking_paths.scenes', 'forking_paths.sim',\n"
        "             'forking_paths.candidates', 'forking_paths.annotation',\n"
        "             'forking_paths.editor', 'forking_paths.recorder',\n"
        "             'forking_paths.interactive', 'cli.moment_tools',\n"
        "             'data.scene_extract', 'flops', 'campaign',\n"
        "             'campaign.walks', 'campaign.flagship',\n"
        "             'campaign.simaug'):\n"
        "    assert 'multiverse_torch.' + name in names, name\n"
        "import dataclasses\n"
        "from multiverse_torch.data import multiview\n"
        "from multiverse_torch.models import simaug\n"
        "scfg = simaug.SimAugConfig(**dataclasses.asdict(tcfg),\n"
        "    multiview_train=True, use_mixup=True, double_weighting=True,\n"
        "    adv_use_fgsm=True).validate()\n"
        "mds = multiview.MultiviewDataset(dataset.dataset_from_arrays(\n"
        "    multiview.synthesize_multiview_split(scfg, 2), scfg, 'train'),\n"
        "    scfg, 3)\n"
        "smodel = Multiverse.init(scfg, trainable=True)\n"
        "stx = trainer.build_optimizer(scfg, 8)\n"
        "parts = simaug.make_simaug_train_step(scfg, stx)(\n"
        "    smodel, stx.init(dict(smodel.named_parameters())),\n"
        "    dataset.batch_to_device(mds.make_batch([0, 1, 2, 3])[0], 'cpu'),\n"
        "    1)\n"
        "assert float(parts['total']) > 0\n"
        "from multiverse_torch.eval import multifuture\n"
        "m = multifuture.evaluate_multifuture_trajs(\n"
        "    {'a_cam1': [[[0.0, 0.0]]]}, None,\n"
        "    gt_trajs={'a_cam1': {0: {'x_agent_traj': [(0, 1, 3.0, 4.0)]}}})\n"
        "assert m['minade_45-degree'] == 5.0\n"
        "import os, tempfile\n"
        "from multiverse_torch.data import preprocess\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    os.makedirs(os.path.join(tmp, 'train'))\n"
        "    with open(os.path.join(tmp, 'train', 'v.txt'), 'w') as f:\n"
        "        f.writelines('%d\\t1\\t%d\\t9\\n' % (12 * t, 40 * t)\n"
        "                     for t in range(20))\n"
        "    assert preprocess.preprocess_split(tmp, 'train',\n"
        "        os.path.join(tmp, 'd.npz'), preprocess.PreprocessOptions())\n"
        "import numpy as np\n"
        "from multiverse_torch.train.checkpoints import load_checkpoint\n"
        "import chip_smoke\n"
        "fsave = os.path.join(chip_smoke.JAX_FIXTURE, 'multiverse', '00',\n"
        "                     'save')\n"
        "fcfg = MultiverseConfig(use_gnn=True,\n"
        "                        use_scene_enc=True).validate()\n"
        "fmodel = load_checkpoint(fsave, Multiverse.init(fcfg))\n"
        "fwant = chip_smoke.fixture_tree(fmodel)\n"
        "for n, p in fmodel.named_parameters():\n"
        "    node = fwant\n"
        "    for k in n.split('.'):\n"
        "        node = node[k]\n"
        "    assert np.array_equal(p.detach().numpy(), node), n\n"
        "from multiverse_torch.bridge import params_to_numpy_tree\n"
        "from multiverse_torch.cli import convert_tf\n"
        "from multiverse_torch.train.checkpoints import (\n"
        "    CheckpointManager, read_checkpoint_tree)\n"
        "def flat(tree, pre=''):\n"
        "    for k, v in sorted(tree.items()):\n"
        "        if isinstance(v, dict):\n"
        "            yield from flat(v, pre + k + '/')\n"
        "        else:\n"
        "            yield pre + k, v\n"
        "def same(a, b):\n"
        "    a, b = dict(flat(a)), dict(flat(b))\n"
        "    return sorted(a) == sorted(b) and all(\n"
        "        np.array_equal(a[k], b[k]) for k in b)\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    CheckpointManager(os.path.join(tmp, 'run')).save(3, fmodel)\n"
        "    assert same(read_checkpoint_tree(os.path.join(tmp, 'run',\n"
        "                'save')), params_to_numpy_tree(fmodel))\n"
        "    convert_tf.main([chip_smoke.TF_FIXTURE, tmp, 'tf', '0',\n"
        "                     *chip_smoke.TF_FIXTURE_FLAGS])\n"
        "    tfcfg = MultiverseConfig(use_gnn=True, use_scene_enc=True,\n"
        "        **chip_smoke.TF_FIXTURE_WIDTHS).validate()\n"
        "    assert same(read_checkpoint_tree(os.path.join(tmp, 'tf', '00',\n"
        "                'best')), chip_smoke.fixture_tree(\n"
        "                Multiverse.init(tfcfg)))\n"
        "import json, pickle\n"
        "from multiverse_torch.cli import prepare_data, vis_annotation\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    os.makedirs(os.path.join(tmp, 'ds', 'bbox'))\n"
        "    os.makedirs(os.path.join(tmp, 'split'))\n"
        "    vids = ['zara01_0_1_%d_a_cam1' % d for d in range(2)]\n"
        "    for d, name in enumerate(vids):\n"
        "        with open(os.path.join(tmp, 'ds', 'bbox', name + '.json'),\n"
        "                  'w') as f:\n"
        "            json.dump([{'frame_id': fr, 'track_id': 1,\n"
        "                        'class_name': 'Person', 'is_x_agent': 1,\n"
        "                        'bbox': [50.0 + fr * d, 60.0, 8.0, 16.0]}\n"
        "                       for fr in range(150)], f)\n"
        "    with open(os.path.join(tmp, 'split', 'test.lst'), 'w') as f:\n"
        "        f.write('\\n'.join(vids) + '\\n')\n"
        "    prepare_data.prepare_multifuture_main([os.path.join(tmp, 'ds'),\n"
        "        os.path.join(tmp, 'split'), os.path.join(tmp, 'obs'),\n"
        "        os.path.join(tmp, 'mf')])\n"
        "    with open(os.path.join(tmp, 'mf', 'test', 'zara01_0_1_cam1.p'),\n"
        "              'rb') as f:\n"
        "        assert sorted(pickle.load(f)) == vids\n"
        "    for main, nargs, package in (\n"
        "            (prepare_data.sdd_frames_main, 3, 'cv2'),\n"
        "            (prepare_data.resize_rotate_sdd_main, 3, 'cv2'),\n"
        "            (vis_annotation.extract_frames_seg_main, 5, 'cv2'),\n"
        "            (prepare_data.get_vehicle_traj_main, 4, 'yaml')):\n"
        "        try:\n"
        "            main([os.path.join(tmp, 'x%d' % i)\n"
        "                  for i in range(nargs)])\n"
        "        except ImportError as e:\n"
        "            assert e.name == package and 'mvt-torch-' in str(e), e\n"
        "        else:\n"
        "            raise AssertionError('no ImportError for ' + package)\n"
        "from multiverse_torch.cli import visualize_grid\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    for main, command, args in (\n"
        "            (visualize_grid.main, 'mvt-torch-vis-grid',\n"
        "             ['out.p', 'vis', 'frames', '--use_beam_search']),\n"
        "            (vis_annotation.batch_plot_traj_carla_main,\n"
        "             'mvt-torch-batch-plot-traj-carla',\n"
        "             ['world', 'carla', '--job', '2'])):\n"
        "        try:\n"
        "            main([a if a.startswith('--') or a.isdigit()\n"
        "                  else os.path.join(tmp, a) for a in args])\n"
        "        except ImportError as e:\n"
        "            assert e.name == 'cv2' and command in str(e), e\n"
        "        else:\n"
        "            raise AssertionError('no ImportError for ' + command)\n"
        "        assert os.listdir(tmp) == [], os.listdir(tmp)\n"
        "from multiverse_torch.forking_paths import (camera, candidates,\n"
        "                                            controls, scenes, sim)\n"
        "rig = camera.CameraRig(camera.Transform(x=-15.0, z=3.0), 64, 48, 90.0)\n"
        "uvd = camera.project_points(np.array([[0.0, 0.0, 0.5]]), rig)\n"
        "assert uvd[0, 2] > 0\n"
        "reg = scenes.load_default_registry()\n"
        "assert len(reg.recording_cameras('0400')) == 4\n"
        "ped = controls.traj_to_controls(np.asarray(\n"
        "    [[0, 1, 0, 0, 0.5], [5, 1, 1, 0, 0.5], [10, 1, 2, 0, 0.5]],\n"
        "    np.float64), -1, -1, 25.0)[0]\n"
        "state = sim.SimState()\n"
        "assert [c.kind for c in sim.plan_frame(0, ped, {}, state)] == [\n"
        "    'spawn_walker', 'walker_control']\n"
        "import torch_fake_carla\n"
        "carla = torch_fake_carla.install()\n"
        "client = carla.Client()\n"
        "world = client.get_world()\n"
        "lib = world.get_blueprint_library()\n"
        "assert candidates.replay_moment(\n"
        "    client, world, (lib.filter('walker.pedestrian.*'), [0]),\n"
        "    (lib.filter('vehicle.*'), [0]), ped, {}, start_frame=0,\n"
        "    total_frames=10) == (True, '', False)\n"
        "assert world.frame == 10\n"
        "from multiverse_torch.forking_paths import interactive\n"
        "try:\n"
        "    interactive.spectator_main(['--max_ticks', '1'])\n"
        "except ImportError as e:\n"
        "    assert e.name == 'pygame' and 'mvt-torch-spectator' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('no ImportError for pygame')\n"
        "from multiverse_torch.campaign import flagship, walks\n"
        "rnd = np.random.RandomState(17)\n"
        "xy = walks.walk_steps(rnd, walks.walk_init(rnd), 30)\n"
        "assert xy.shape == (30, 2) and np.abs(xy).max() <= walks.LIM\n"
        "rows = walks.rows_from_xy(xy, 1) + walks.rows_from_xy(\n"
        "    walks.walk_steps(rnd, walks.walk_init(rnd, 3.0), 30), 2)\n"
        "ctl = flagship.moment('zara01_0_1_0_a', rows)['ped_controls']\n"
        "assert sorted(map(int, ctl)) == list(range(0, 300, 10))\n"
        "fake = flagship.install_fake_carla()\n"
        "assert fake.__file__ == flagship.FAKE_CARLA\n"
        "assert sys.modules['carla'].Client is not None\n"
        "del sys.modules['carla']\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.startswith(('jax', 'multiverse_tpu', 'orbax',\n"
        "                               'tensorstore', 'zstandard', 'cv2',\n"
        "                               'yaml', 'pygame', 'transformers',\n"
        "                               'tensorflow')))\n"
        "print('MODULES', len(names), 'JAX_MODULES', bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout
