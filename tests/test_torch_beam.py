"""The port's diverse beam search against the JAX package's, in f32 on
the CPU (ids exactly equal, logprobs and logits within 1e-4), and its
successor selectors against each other with injected ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.config import MultiverseConfig
from multiverse_tpu.geometry import one_hot_grid as j_one_hot
from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.models import beam_search as jbs
from multiverse_tpu.ops import ConvLSTMState as JState
from multiverse_torch.bridge import params_from_jax
from multiverse_torch.models import beam_search as tbs
from multiverse_torch.ops import ConvLSTMState as TState

H, W, D, C, N = 6, 8, 16, 4, 2


def _setup(rng, **kw):
    base = dict(scene_h=12, scene_w=16, scene_class=5, emb_size=8,
                enc_hidden_size=D, dec_hidden_size=D, scene_conv_dim=C,
                use_beam_search=True, beam_size=4)
    base.update(kw)
    cfg = MultiverseConfig(**base).validate()
    jtree = jax.tree_util.tree_map(np.asarray,
                                   jax_init_params(jax.random.PRNGKey(1), cfg))
    first = rng.randint(0, H * W, N)
    arrays = dict(
        first=np.array(j_one_hot(jnp.asarray(first), H, W)),
        c=rng.randn(N, H, W, D).astype(np.float32) * 0.5,
        h=np.tanh(rng.randn(N, H, W, D)).astype(np.float32),
        scene=np.abs(rng.randn(N, H, W, C)).astype(np.float32),
    )
    return cfg, jtree, arrays


def _run_both(cfg, jtree, a, T, lengths=None, save_states=False):
    jout = jbs.diverse_beam_search(
        jax.tree_util.tree_map(jnp.asarray, jtree["scales"]["0"]), cfg,
        jnp.asarray(a["first"]), JState(c=jnp.asarray(a["c"]),
                                        h=jnp.asarray(a["h"])), T,
        pred_length=None if lengths is None else jnp.asarray(lengths),
        scene_mean=jnp.asarray(a["scene"]), save_states=save_states)
    model = params_from_jax(jtree)
    tout = tbs.diverse_beam_search(
        model["scales"]["0"], cfg, torch.from_numpy(a["first"]),
        TState(c=torch.from_numpy(a["c"]), h=torch.from_numpy(a["h"])), T,
        pred_length=None if lengths is None else torch.from_numpy(lengths),
        scene_mean=torch.from_numpy(a["scene"]), save_states=save_states)
    return jout, tout


@pytest.mark.parametrize("kw", [
    dict(),
    dict(diverse_beam=True, diverse_gamma=0.01, fix_num_timestep=1),
    dict(diverse_beam=True, diverse_gamma=0.01, fix_num_timestep=1,
         beam_select="dense"),
    dict(diverse_beam=True, diverse_gamma=2.0),       # dense fallback
])
def test_beam_search_f32_matches_jax(rng, kw):
    cfg, jtree, a = _setup(rng, **kw)
    T = 6
    lengths = np.array([6, 4], np.int32)
    jout, tout = _run_both(cfg, jtree, a, T, lengths)
    for n, t_n in enumerate(lengths):
        np.testing.assert_array_equal(np.asarray(jout.ids[n, :, :t_n]),
                                      tout.ids[n, :, :t_n].numpy())
        np.testing.assert_allclose(np.asarray(jout.logits[n, :, :t_n]),
                                   tout.logits[n, :, :t_n].numpy(),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(jout.logprobs),
                               tout.logprobs.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(jout.best_logits),
                               tout.best_logits.numpy(), rtol=1e-4, atol=1e-4)


def test_beam_search_save_states_matches_jax(rng):
    cfg, jtree, a = _setup(rng, use_single_decoder=True)
    jout, tout = _run_both(cfg, jtree, a, 3, save_states=True)
    np.testing.assert_array_equal(np.asarray(jout.ids), tout.ids.numpy())
    assert tout.states.shape == (N, cfg.beam_size, 3, H, W, D)
    np.testing.assert_allclose(np.asarray(jout.states), tout.states.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_diversity_penalty_matches_jax_with_ties():
    rng = np.random.RandomState(0)
    mixed = rng.randn(2, 3, 11).astype(np.float32)
    mixed[..., ::3] = 7.0
    for x in (rng.randn(4, 6, 17).astype(np.float32),
              np.full((2, 3, 9), -1e30, np.float32), mixed):
        np.testing.assert_allclose(
            np.asarray(jbs.add_diversity_penalty(jnp.asarray(x), 0.01)),
            tbs.add_diversity_penalty(torch.from_numpy(x), 0.01).numpy(),
            rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("diverse,gamma", [
    (True, 0.01), (True, 0.5), (True, 1.0), (False, 0.01)])
def test_twostage_select_equals_dense_with_ties(diverse, gamma):
    """Winners, scores, parents and tie order equal on tie-heavy
    integer logits (distinct values differ by >= 1, so the two forms'
    different roundings cannot flip a comparison)."""
    Nn, K, HW = 3, 5, 12
    rng = np.random.RandomState(11)
    for _ in range(12):
        logits = torch.from_numpy(
            rng.randint(0, 6, (Nn, K, HW)).astype(np.float32))
        logprob = torch.from_numpy(
            rng.randint(0, 4, (Nn, K)).astype(np.float32) * 0.5)
        for t in (0, 2):
            lp_d, ids_d, par_d = tbs.select_successors_dense(
                logprob, logits, K, t, diverse, gamma)
            lp_t, ids_t, par_t = tbs.select_successors_twostage(
                logprob, logits, K, t, diverse, gamma)
            torch.testing.assert_close(ids_d, ids_t, rtol=0, atol=0)
            torch.testing.assert_close(par_d, par_t, rtol=0, atol=0)
            torch.testing.assert_close(lp_d, lp_t, rtol=1e-5, atol=1e-5)
            # and both equal the JAX dense selector, ties included
            lp_j, ids_j, par_j = jbs.select_successors_dense(
                jnp.asarray(logprob.numpy()), jnp.asarray(logits.numpy()),
                K, jnp.asarray(t), diverse, gamma)
            np.testing.assert_array_equal(np.asarray(ids_j), ids_t.numpy())
            np.testing.assert_array_equal(np.asarray(par_j), par_t.numpy())


def test_fused_wiring_batched_equals_per_sample(rng):
    """The bf16 fused-step wiring (flat parents, un-reordered state
    carry, identity parents for finished samples, backtrace) on the CPU,
    where the step runs its plain version: a batched variable-length
    decode equals each sample decoded alone."""
    cfg, jtree, a = _setup(rng, diverse_beam=True, diverse_gamma=0.01,
                           fix_num_timestep=1)
    sp = params_from_jax(jtree)["scales"]["0"]
    bf = torch.bfloat16
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    lengths = torch.tensor([6, 4], dtype=torch.int32)
    out = tbs.diverse_beam_search(
        sp, cfg, t["first"], TState(c=t["c"], h=t["h"]), 6,
        pred_length=lengths, scene_mean=t["scene"], compute_dtype=bf)
    for n, t_n in ((0, 6), (1, 4)):
        one = tbs.diverse_beam_search(
            sp, cfg, t["first"][n:n + 1],
            TState(c=t["c"][n:n + 1], h=t["h"][n:n + 1]), t_n,
            scene_mean=t["scene"][n:n + 1], compute_dtype=bf)
        torch.testing.assert_close(out.ids[n, :, :t_n], one.ids[0],
                                   rtol=0, atol=0)
        torch.testing.assert_close(out.logprobs[n], one.logprobs[0],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(out.logits[n, :, :t_n], one.logits[0],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("feedback,use_gnn", [("onehot", True),
                                              ("raw", False)])
def test_greedy_decode_f32_matches_jax(rng, feedback, use_gnn):
    from multiverse_tpu.models.multiverse import greedy_decode as jgreedy
    from multiverse_torch.models import greedy_decode as tgreedy

    cfg, jtree, a = _setup(rng)
    names = (("dec_class_emb", "dec_class", "h2g_class")
             if feedback == "onehot"
             else ("dec_reg_emb", "dec_reg", "h2g_reg"))
    first = a["first"] if feedback == "onehot" else \
        rng.randn(N, H, W, 2).astype(np.float32)
    scene = a["scene"] if use_gnn else None
    jl, js = jgreedy(
        jax.tree_util.tree_map(jnp.asarray, jtree["scales"]["0"]), cfg,
        jnp.asarray(first), JState(c=jnp.asarray(a["c"]),
                                   h=jnp.asarray(a["h"])), 5, *names,
        use_gnn=use_gnn,
        scene_mean=None if scene is None else jnp.asarray(scene),
        feedback=feedback)
    tl, ts = tgreedy(
        params_from_jax(jtree)["scales"]["0"], cfg, torch.from_numpy(first),
        TState(c=torch.from_numpy(a["c"]), h=torch.from_numpy(a["h"])), 5,
        *names, use_gnn=use_gnn,
        scene_mean=None if scene is None else torch.from_numpy(scene),
        feedback=feedback)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=1e-4,
                               atol=1e-4)
