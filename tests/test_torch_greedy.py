"""The port's greedy decode against the JAX package on the CPU:
``greedy_forward`` in f32 (cell ids equal, floats within 1e-4),
``reconstruct_greedy_trajs``, the fused greedy class decode in bf16,
int8 and int8a against the JAX decode with interpret-mode Pallas
kernels (within 2e-2), the offline ``greedy=True`` run and its CLI, and
the device rasteriser ``xy_to_cell``."""

import itertools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu import inference as jinf
from multiverse_tpu.config import MultiverseConfig
from multiverse_tpu.geometry import xy_to_cell as j_xy_to_cell
from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.models.multiverse import greedy_decode as jgreedy
from multiverse_tpu.ops import ConvLSTMState as JState
from multiverse_tpu.ops import pallas_decode as jpd
from multiverse_torch import inference as tinf
from multiverse_torch.bridge import params_from_jax, save_params_npz
from multiverse_torch.cli import multifuture_inference as tcli
from multiverse_torch.config import MultiverseConfig as TConfig
from multiverse_torch.data.dataset import batch_to_device
from multiverse_torch.geometry import one_hot_grid, xy_to_cell, xy_to_cell_np
from multiverse_torch.models import beam_search as tbs
from multiverse_torch.models import multiverse as tmv
from multiverse_torch.ops import ConvLSTMState as TState
from multiverse_torch.ops import quant as tquant
from synthetic import write_multifuture_dataset


def _cfg(**kw):
    base = dict(
        scene_h=12, scene_w=16, scene_class=5, video_h=540, video_w=960,
        enc_hidden_size=16, dec_hidden_size=16, scene_conv_dim=8,
        emb_size=8, beam_size=4, use_gnn=True, use_scene_enc=True,
        obs_len=8, pred_len=4)
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


@pytest.mark.parametrize("kw", [{}, {"use_single_decoder": True},
                                {"use_scene_enc": False, "use_gnn": False}])
def test_greedy_forward_f32_matches_jax(kw):
    cfg = _cfg(**kw)
    jparams, model = _params(cfg)
    jb, tb = _batches(cfg)
    jl, jreg = jinf.greedy_forward(jparams, jb, cfg, T_pred=6)
    with torch.inference_mode():
        tl, treg = tinf.greedy_forward(model, tb, cfg, T_pred=6)
    assert tl.shape == jl.shape and treg.shape == jreg.shape
    N, T = tl.shape[:2]
    np.testing.assert_array_equal(
        np.argmax(np.asarray(jl).reshape(N, T, -1), axis=-1),
        torch.argmax(tl.reshape(N, T, -1), dim=-1).numpy())
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(jreg), treg.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("center_only", [False, True])
def test_reconstruct_greedy_trajs_matches_jax(rng, center_only):
    from multiverse_tpu.geometry import grid_centers

    logits = rng.randn(2, 5, 6, 8, 1).astype(np.float32)
    reg = rng.randn(2, 5, 6, 8, 2).astype(np.float32)
    centers = grid_centers(540, 960, 6, 8).reshape(-1, 2).astype(np.float32)
    j = jinf.reconstruct_greedy_trajs(jnp.asarray(logits), jnp.asarray(reg),
                                      jnp.asarray(centers), center_only)
    t = tinf.reconstruct_greedy_trajs(torch.from_numpy(logits),
                                      torch.from_numpy(reg),
                                      torch.from_numpy(centers), center_only)
    assert t.shape == (2, 5, 2)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("decode_quant", ["none", "int8", "int8a",
                                          "int8_dyn"])
def test_fused_greedy_decode_tracks_jax_interpret(rng, monkeypatch,
                                                  decode_quant):
    """bf16 argmax class decode with the GNN on, both packages through
    their fused step (JAX: the Pallas kernels in interpret mode; the
    port: the plain version, on CPU tensors); every step goes through
    the port's fused step, and logits and states agree within 2e-2."""
    monkeypatch.setattr(jpd, "FORCE_INTERPRET_FUSED", True)
    cfg = _cfg(compute_dtype="bfloat16", decode_quant=decode_quant)
    jparams, model = _params(cfg)
    N, H, W, D, C = 2, 6, 8, 16, 8
    cells = rng.randint(0, H * W, N)
    first = np.zeros((N, H * W), np.float32)
    first[np.arange(N), cells] = 1.0
    first = first.reshape(N, H, W, 1)
    c = rng.randn(N, H, W, D).astype(np.float32) * 0.5
    h = np.tanh(rng.randn(N, H, W, D)).astype(np.float32)
    scene = np.abs(rng.randn(N, H, W, C)).astype(np.float32)
    names = ("dec_class_emb", "dec_class", "h2g_class")
    jl, js = jgreedy(
        jparams["scales"]["0"], cfg, jnp.asarray(first),
        JState(c=jnp.asarray(c), h=jnp.asarray(h)), 5, *names,
        use_gnn=True, scene_mean=jnp.asarray(scene),
        compute_dtype=jnp.bfloat16, allow_fused=True)
    calls = []

    def counting(name):
        orig = getattr(tquant, name)

        def fn(*args, **kw):
            calls.append(name)
            return orig(*args, **kw)
        monkeypatch.setattr(tquant, name, fn)

    counting("decode_step_gathered")
    counting("decode_step_gathered_q8")
    counting("decode_step_gathered_q8dyn")
    tl, ts = tmv.greedy_decode(
        model["scales"]["0"], cfg, torch.from_numpy(first),
        TState(c=torch.from_numpy(c), h=torch.from_numpy(h)), 5, *names,
        use_gnn=True, scene_mean=torch.from_numpy(scene),
        compute_dtype=torch.bfloat16, allow_fused=True)
    assert calls == [{"none": "decode_step_gathered",
                      "int8_dyn": "decode_step_gathered_q8dyn"}.get(
                          decode_quant, "decode_step_gathered_q8")] * 5
    assert tl.dtype == torch.float32 and ts.dtype == torch.bfloat16
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(np.asarray(js, np.float32),
                               ts.float().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize(
    "bf16,allow_pallas,use_gnn,single,onehot,dropout",
    list(itertools.product((False, True), repeat=6)))
def test_one_decision_picks_the_fused_step(monkeypatch, bf16, allow_pallas,
                                           use_gnn, single, onehot,
                                           dropout):
    """Which step each class decoder runs, fused or composed, over every
    combination of what decides it. Both need bf16, ``allow_pallas`` and
    the GNN; the beam decoder also no saved states (the single decoder
    saves them), the greedy decoder also one-hot feedback and no
    dropout."""
    cfg = TConfig(scene_h=12, scene_w=16, scene_class=5, emb_size=8,
                  enc_hidden_size=16, dec_hidden_size=16, scene_conv_dim=4,
                  beam_size=3, use_beam_search=True, use_gnn=use_gnn,
                  use_single_decoder=single, allow_pallas=allow_pallas,
                  compute_dtype="bfloat16" if bf16 else "float32"
                  ).validate()
    sp = tmv.Multiverse.init(cfg, seed=0)["scales"]["0"]
    N, H, W, D, T = 2, 6, 8, 16, 2
    gen = torch.Generator().manual_seed(0)
    first = one_hot_grid(torch.tensor([3, 40]), H, W)
    state = TState(c=torch.randn(N, H, W, D, generator=gen),
                   h=torch.tanh(torch.randn(N, H, W, D, generator=gen)))
    scene = torch.rand(N, H, W, 4, generator=gen) if use_gnn else None
    dtype = torch.bfloat16 if bf16 else None
    calls = []

    def counting(module, name, tag):
        orig = getattr(module, name)

        def fn(*args, **kw):
            calls.append(tag)
            return orig(*args, **kw)
        monkeypatch.setattr(module, name, fn)

    counting(tquant, "decode_step_gathered", "fused")
    counting(tbs, "convlstm_step", "composed")
    counting(tmv, "convlstm_step", "composed")
    with torch.inference_mode():
        tbs.diverse_beam_search(sp, cfg, first, state, T, scene_mean=scene,
                                save_states=single, compute_dtype=dtype)
        beam_calls = calls[:]
        del calls[:]
        tmv.greedy_decode(
            sp, cfg, first, state, T, "dec_class_emb", "dec_class",
            "h2g_class", use_gnn=use_gnn, scene_mean=scene,
            feedback="onehot" if onehot else "raw", compute_dtype=dtype,
            allow_fused=True, keep_prob=0.5 if dropout else 1.0,
            dropout_rng=torch.Generator().manual_seed(1))
    shared = bf16 and allow_pallas and use_gnn
    beam_fused = shared and not single
    greedy_fused = shared and onehot and not dropout
    assert beam_calls == ["fused" if beam_fused else "composed"] * T
    assert calls == ["fused" if greedy_fused else "composed"] * T


def test_offline_greedy_pickle_matches_jax(tmp_path):
    cfg = _cfg()
    jparams, model = _params(cfg)
    inputs = jinf.synthesize_multifuture_inputs(cfg, 5, seed=0,
                                                max_pred_len=6)
    j_out, j_prob = jinf.run_multifuture_inference(
        jparams, inputs, cfg, batch_size=4, greedy=True)
    t_out, t_prob = tinf.run_multifuture_inference(
        model, inputs, cfg, batch_size=4, greedy=True, device="cpu")
    assert j_prob == {} and t_prob == {}
    assert set(t_out) == set(j_out)
    for tid in j_out:
        a, b = np.asarray(t_out[tid]), np.asarray(j_out[tid])
        assert a.shape == b.shape == (cfg.beam_size, a.shape[1], 2)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="not greedy"):
        tinf.save_outputs(t_out, t_prob, str(tmp_path / "o.traj.p"),
                          str(tmp_path / "o.prob.p"))


def test_cli_greedy_and_int8a(tmp_path):
    cfg = _cfg()
    _, model = _params(cfg)
    npz = str(tmp_path / "params.npz")
    save_params_npz(model, npz)
    traj_p, mf_p, scene_p, id2name = write_multifuture_dataset(
        str(tmp_path), cfg, np.random.RandomState(1), num_traj=3,
        max_pred_len=6)
    out = str(tmp_path / "o.traj.p")
    args = [npz, traj_p, mf_p, out, "--device", "cpu",
            "--scene_feat_path", scene_p, "--scene_id2name", id2name,
            "--num_out", "4", "--use_gnn", "--use_scene_enc",
            "--scene_h", "12", "--scene_w", "16", "--scene_class", "5",
            "--video_h", "540", "--video_w", "960", "--emb_size", "8",
            "--enc_hidden_size", "16", "--dec_hidden_size", "16",
            "--scene_conv_dim", "8"]
    for extra in (["--greedy", "--decode_quant", "int8a"],
                  ["--decode_quant", "int8"],
                  ["--greedy", "--decode_quant", "int8_dyn"]):
        tcli.main(args + extra)
        with open(out, "rb") as f:
            trajs = pickle.load(f)
        assert len(trajs) == 3
        for beams in trajs.values():
            pts = np.asarray(beams)
            assert pts.shape[0] == 4 and np.isfinite(pts).all()
            if "--greedy" in extra:
                np.testing.assert_array_equal(pts[0], pts[1])
    with pytest.raises(SystemExit, match="requires beam search"):
        tcli.main(args + ["--greedy", "--save_prob_file",
                          str(tmp_path / "o.prob.p")])


def test_xy_to_cell_matches_jax_and_numpy(rng):
    xy = np.concatenate([
        rng.uniform(-50, 1000, (40, 2)),
        # cell borders and the frame's edges
        np.array([[0, 0], [60, 45], [960, 540], [959.99, 539.99],
                  [120, 90], [-1, 600]])]).astype(np.float32)
    for h, w in ((6, 8), (3, 4)):
        j = np.asarray(j_xy_to_cell(jnp.asarray(xy), 540, 960, h, w))
        t = xy_to_cell(torch.from_numpy(xy), 540, 960, h, w)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(j, t.numpy())
        np.testing.assert_array_equal(xy_to_cell_np(xy, 540, 960, h, w),
                                      t.numpy())
