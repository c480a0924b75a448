"""The int8, int8a and int8_dyn tiers of the port against the JAX package
on the CPU: ``quantize_decode_weights`` and ``quantize_decode_weights_v2``
(int8 operands equal, scales within 1e-7 relative), the plain q8 decode
steps against the Pallas kernels ``decode_step_pallas_gathered_q8`` /
``_q8a`` / ``_q8v2`` in interpret mode (h, c and logits within 2e-2,
K1's tolerance), the int8_dyn gate inputs (h2_f, r_p) against the
quantities computed from JAX's ``_gnn_attention``, the tier dispatch,
and the q8 beam wiring against the JAX beam search with interpret-mode
kernels. The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverse_tpu.config import MultiverseConfig
from multiverse_tpu.geometry import one_hot_grid as j_one_hot
from multiverse_tpu.models import beam_search as jbs
from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.ops import ConvLSTMState as JState
from multiverse_tpu.ops import pallas_decode as jpd
from multiverse_torch.bridge import params_from_jax
from multiverse_torch.models import beam_search as tbs
from multiverse_torch.ops import (
    ConvLSTMState as TState,
    decode_step_gathered,
    decode_step_gathered_q8,
    decode_step_gathered_q8_ref,
    decode_step_gathered_q8dyn,
    decode_step_gathered_q8dyn_ref,
    make_decode_step,
    quantize_decode_weights,
    quantize_decode_weights_v2,
    select_quant,
)
from multiverse_torch.ops.quant import gate_k_order, gate_row_order
from multiverse_torch.ops.fused_decode import (
    _attention_weights,
    gate_input_q8,
    gate_inputs_q8dyn,
    gate_inputs_q8dyn_ref,
    h2f_weight_flips,
)

H, W, D, E, C, NK = 6, 8, 16, 8, 4, 6
HW = H * W


def _operands(rng, with_scene=True):
    emb = np.tanh(rng.randn(HW, H, W, E)).astype(np.float32)
    return dict(
        kernel=rng.randn(3, 3, E + D, 4 * D).astype(np.float32) * 0.2,
        bias=rng.randn(4 * D).astype(np.float32) * 0.5,
        w=rng.randn(3, 3, D, 1).astype(np.float32) * 0.3,
        # the decoders quantise a bf16 embedding table
        emb=np.asarray(jnp.asarray(emb).astype(jnp.bfloat16), np.float32),
        h=np.tanh(rng.randn(NK, H, W, D)).astype(np.float32),
        c=rng.randn(NK, H, W, D).astype(np.float32),
        scene=(rng.randn(NK, H, W, C).astype(np.float32)
               if with_scene else None),
        ids=rng.randint(0, HW, NK).astype(np.int32),
        par=rng.permutation(NK).astype(np.int32),
    )


def _quant_pair(o):
    jq = jpd.quantize_decode_weights({"kernel": jnp.asarray(o["kernel"])},
                                     jnp.asarray(o["emb"]))
    tq = quantize_decode_weights({"kernel": torch.from_numpy(o["kernel"])},
                                 torch.from_numpy(o["emb"]))
    return jq, tq


def _torch_q8(o, tq, attn_q8, fn=decode_step_gathered_q8):
    bf = torch.bfloat16

    def t(a):
        return torch.from_numpy(a)
    return fn(tq, t(o["bias"]), t(o["w"]).reshape(9, D).t().to(bf),
              t(o["ids"]), t(o["par"]), t(o["h"]).reshape(-1, D).to(bf),
              t(o["c"]).reshape(-1, D).to(bf),
              None if o["scene"] is None
              else t(o["scene"]).reshape(-1, C).to(bf), H, W,
              attn_q8=attn_q8)


def test_quantize_decode_weights_matches_jax(rng):
    o = _operands(rng)
    jq, tq = _quant_pair(o)
    for name, j, t in zip(("emb_q", "w_q"), jq[:2], tq[:2]):
        assert t.dtype == torch.int8 and t.shape == j.shape, name
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
    assert tq.t_c.dtype == torch.float32 and tq.t_c.shape == jq[2].shape
    np.testing.assert_allclose(np.asarray(jq[2]), tq.t_c.numpy(), rtol=1e-7)
    # the kernel's operand layout: each gate column's contraction, rows
    # in the gate launch's order
    assert tq.w_qt.is_contiguous()
    inverse = torch.argsort(gate_row_order(D))
    torch.testing.assert_close(tq.w_qt[inverse],
                               tq.w_q[gate_k_order(E, D)].t(), rtol=0, atol=0)


def test_quantize_decode_weights_v2_matches_jax(rng):
    o = _operands(rng)
    jq = jpd.quantize_decode_weights_v2({"kernel": jnp.asarray(o["kernel"])},
                                        jnp.asarray(o["emb"]))
    tq = quantize_decode_weights_v2({"kernel": torch.from_numpy(o["kernel"])},
                                    torch.from_numpy(o["emb"]))
    for name, j in zip(("emb_q", "w_eq", "t_e", "w_hq", "u_c"), jq):
        t = getattr(tq, name)
        assert t.shape == j.shape, name
        if name in ("t_e", "u_c"):
            assert t.dtype == torch.float32
            np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-7,
                                       err_msg=name)
        else:
            assert t.dtype == torch.int8, name
            np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                          err_msg=name)
    # the kernel's operand layouts: each gate column's contraction, rows
    # in the gate launch's order
    inverse = torch.argsort(gate_row_order(D))
    for t, tt in ((tq.w_eq, tq.w_eqt), (tq.w_hq, tq.w_hqt)):
        assert tt.is_contiguous()
        torch.testing.assert_close(tt[inverse], t.t(), rtol=0, atol=0)
    # the embedding rows are shift-major, not a slice of the fused w_q
    assert tq.w_eq.shape == (9 * E, 4 * D) and tq.w_hq.shape == (9 * D, 4 * D)
    torch.testing.assert_close(tq.emb_q, _quant_pair(o)[1].emb_q,
                               rtol=0, atol=0)


def _torch_q8dyn(o, tq, fn=decode_step_gathered_q8dyn):
    bf = torch.bfloat16

    def t(a):
        return torch.from_numpy(a)
    return fn(tq, t(o["bias"]), t(o["w"]).reshape(9, D).t().to(bf),
              t(o["ids"]), t(o["par"]), t(o["h"]).reshape(-1, D).to(bf),
              t(o["c"]).reshape(-1, D).to(bf),
              None if o["scene"] is None
              else t(o["scene"]).reshape(-1, C).to(bf), H, W)


@pytest.mark.parametrize("with_scene", [True, False])
def test_plain_q8dyn_step_matches_pallas_interpret(rng, with_scene):
    """The int8_dyn step (K7) against ``decode_step_pallas_gathered_q8v2``
    in interpret mode: h', c' and logits within 2e-2."""
    o = _operands(rng, with_scene)
    jq = jpd.quantize_decode_weights_v2({"kernel": jnp.asarray(o["kernel"])},
                                        jnp.asarray(o["emb"]))
    tq = quantize_decode_weights_v2({"kernel": torch.from_numpy(o["kernel"])},
                                    torch.from_numpy(o["emb"]))
    _, st, logits = jpd.decode_step_pallas_gathered_q8v2(
        jq, jnp.asarray(o["bias"]), {"w": jnp.asarray(o["w"])},
        jnp.asarray(o["ids"]), jnp.asarray(o["par"]),
        JState(c=jnp.asarray(o["c"]), h=jnp.asarray(o["h"])),
        None if o["scene"] is None else jnp.asarray(o["scene"]), H, W,
        interpret=True)
    h_t, c_t, logits_t = _torch_q8dyn(o, tq, decode_step_gathered_q8dyn_ref)
    assert h_t.dtype == torch.bfloat16 and logits_t.shape == (NK * HW, 1)
    for j, t in ((st.h, h_t), (st.c, c_t), (logits, logits_t)):
        np.testing.assert_allclose(np.asarray(j, np.float32).reshape(-1),
                                   t.float().numpy().reshape(-1),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("with_scene", [True, False])
def test_q8dyn_gate_inputs_match_jax_attention(rng, with_scene):
    """h2_f (h + agg left in f32) and the row scales r_p of the int8_dyn
    step against the same quantities from JAX's ``_gnn_attention`` on
    the parent rows: r_p = max(max |im2col9(h2_f) row|, 1e-6)."""
    o = _operands(rng, with_scene)
    bf = jnp.bfloat16
    mask = jpd._neighbor_bias(H, W)
    h_par = jnp.asarray(o["h"][o["par"]]).astype(bf).reshape(NK, HW, D)
    scene = (None if o["scene"] is None else
             jnp.asarray(o["scene"]).astype(bf).reshape(NK, HW, C))
    j_h2f = np.stack([np.asarray(jpd._gnn_attention(
        h_par[i], None if scene is None else scene[i], mask,
        scene is not None)) for i in range(NK)])
    j_rp = np.stack([np.maximum(np.abs(np.asarray(
        jpd._im2col9(jnp.asarray(j_h2f[i]), H, W))).max(axis=-1), 1e-6)
        for i in range(NK)])
    tb = torch.bfloat16
    h2_f, r_p = gate_inputs_q8dyn_ref(
        torch.from_numpy(o["par"]),
        torch.from_numpy(o["h"]).reshape(-1, D).to(tb),
        None if o["scene"] is None
        else torch.from_numpy(o["scene"]).reshape(-1, C).to(tb), H, W)
    assert h2_f.dtype == torch.float32 and h2_f.shape == (NK * HW, D)
    assert r_p.dtype == torch.float32 and r_p.shape == (NK * HW,)
    np.testing.assert_allclose(j_h2f.reshape(-1, D), h2_f.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(j_rp.reshape(-1), r_p.numpy(), rtol=1e-5)


def test_h2f_weight_flips_explain_whole_weight_steps_only(rng):
    """What K7's card gates accept where its h2_f differs from the plain
    version's: pixels whose bf16 attention weights moved by one step each
    (one weight up; two at a corner, one down and one up) are explained
    with that many flips and an f32-rounding residual; two steps of one
    weight, or noise, are not."""
    o = _operands(rng)
    tb = torch.bfloat16
    par = torch.from_numpy(o["par"])
    h = torch.from_numpy(o["h"]).reshape(-1, D).to(tb)
    scene = torch.from_numpy(o["scene"]).reshape(-1, C).to(tb)
    ref_h2f, _ = gate_inputs_q8dyn_ref(par, h, scene, H, W)
    hp = h.reshape(NK, HW, D)[par.long()]
    attn = _attention_weights(hp, scene, H, W)
    bits = attn.view(torch.int16)
    # (row, pixel, [(neighbour pixel, bf16 steps)])
    plants = [(1, 2 * W + 3, [(2 * W + 4, 1)]),
              (2, 0, [(1, -1), (W, 1)]),
              (3, 4 * W + 5, [(3 * W + 5, 2)])]
    for b, p, steps in plants:
        for q, k in steps:
            bits[b, p, q] += k
    got = (hp.float() + attn.float() @ hp.float()).reshape(-1, D)
    noisy = 5 * HW + 7
    got[noisy] += 1e-3 * torch.from_numpy(rng.randn(D).astype(np.float32))
    fl = h2f_weight_flips(par, h, scene, H, W, got, ref_h2f, 1e-5)
    want_rows = [b * HW + p for b, p, _ in plants] + [noisy]
    assert fl["rows"].tolist() == want_rows
    assert fl["flips"][:2].tolist() == [1, 2]
    assert fl["moved"][:2].tolist() == [D, D]
    assert float(fl["residual"][:2].max()) <= 1e-6
    assert float(fl["residual"][2:].min()) > 1e-5
    # no difference, nothing to explain
    assert h2f_weight_flips(par, h, scene, H, W, ref_h2f, ref_h2f,
                            1e-5)["rows"].numel() == 0


def test_cpu_tensors_take_the_plain_q8dyn_version(rng, monkeypatch):
    """No fallback for int8_dyn either: CPU tensors run the plain
    version, build nothing and count no launch."""
    from multiverse_torch.ops import _build

    def no_build():
        raise AssertionError("CPU tensors must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(decode_step_gathered_q8dyn, "launches", 0)
    monkeypatch.setattr(gate_inputs_q8dyn, "launches", 0)
    o = _operands(rng)
    tq = quantize_decode_weights_v2({"kernel": torch.from_numpy(o["kernel"])},
                                    torch.from_numpy(o["emb"]))
    got = _torch_q8dyn(o, tq)
    want = _torch_q8dyn(o, tq, decode_step_gathered_q8dyn_ref)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    h = torch.from_numpy(o["h"]).reshape(-1, D).to(torch.bfloat16)
    par = torch.from_numpy(o["par"])
    for a, b in zip(gate_inputs_q8dyn(par, h, None, H, W),
                    gate_inputs_q8dyn_ref(par, h, None, H, W)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert decode_step_gathered_q8dyn.launches == 0
    assert gate_inputs_q8dyn.launches == 0


@pytest.mark.parametrize("attn_q8", [False, True])
@pytest.mark.parametrize("with_scene", [True, False])
def test_plain_q8_step_matches_pallas_interpret(rng, attn_q8, with_scene):
    o = _operands(rng, with_scene)
    jq, tq = _quant_pair(o)
    _, st, logits = jpd.decode_step_pallas_gathered_q8(
        jq, jnp.asarray(o["bias"]), {"w": jnp.asarray(o["w"])},
        jnp.asarray(o["ids"]), jnp.asarray(o["par"]),
        JState(c=jnp.asarray(o["c"]), h=jnp.asarray(o["h"])),
        None if o["scene"] is None else jnp.asarray(o["scene"]), H, W,
        interpret=True, attn_q8=attn_q8)
    h_t, c_t, logits_t = _torch_q8(o, tq, attn_q8,
                                   decode_step_gathered_q8_ref)
    assert h_t.dtype == torch.bfloat16 and logits_t.shape == (NK * HW, 1)
    for j, t in ((st.h, h_t), (st.c, c_t), (logits, logits_t)):
        np.testing.assert_allclose(np.asarray(j, np.float32).reshape(-1),
                                   t.float().numpy().reshape(-1),
                                   rtol=2e-2, atol=2e-2)


def test_cpu_tensors_take_the_plain_q8_version(rng, monkeypatch):
    """No fallback: CPU tensors run the plain version because of where
    they lie; nothing is built and no launch is counted."""
    from multiverse_torch.ops import _build

    def no_build():
        raise AssertionError("CPU tensors must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(decode_step_gathered_q8, "launches",
                        {"int8": 0, "int8a": 0})
    o = _operands(rng)
    _, tq = _quant_pair(o)
    for attn_q8 in (False, True):
        got = _torch_q8(o, tq, attn_q8)
        want = _torch_q8(o, tq, attn_q8, decode_step_gathered_q8_ref)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        h2q = gate_input_q8(torch.from_numpy(o["par"]),
                            torch.from_numpy(o["h"]).reshape(-1, D)
                            .to(torch.bfloat16), None, H, W, attn_q8)
        assert h2q.dtype == torch.int8 and h2q.shape == (NK * HW, D)
        assert int(h2q.abs().max()) <= 127
    assert decode_step_gathered_q8.launches == {"int8": 0, "int8a": 0}


def test_select_quant_tiers(rng):
    o = _operands(rng)
    cell = {"kernel": torch.from_numpy(o["kernel"])}
    emb = torch.from_numpy(o["emb"])
    for tier, attn_q8 in (("int8", False), ("int8a", True)):
        quant, step = select_quant(tier, cell, emb)
        assert quant.emb_q.dtype == torch.int8
        assert step.func is decode_step_gathered_q8
        assert step.keywords == {"attn_q8": attn_q8}
    # int8_dyn steps through K7 on the split operands
    quant, step = select_quant("int8_dyn", cell, emb)
    assert step is decode_step_gathered_q8dyn
    for name, t in quantize_decode_weights_v2(cell, emb)._asdict().items():
        torch.testing.assert_close(getattr(quant, name), t, rtol=0, atol=0)
    with pytest.raises(ValueError, match="int8_x"):
        select_quant("int8_x", cell, emb)


@pytest.mark.parametrize("tier", ["none", "int8", "int8a", "int8_dyn"])
def test_make_decode_step_binds_each_tier(rng, tier):
    """The step of each tier equals a direct call of its wrapper with
    the operands prepared as the decoders used to prepare them."""
    o = _operands(rng)
    bf = torch.bfloat16
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    cell = {"kernel": t["kernel"], "bias": t["bias"]}
    scene = t["scene"].reshape(-1, C).to(bf)
    step_args = (t["ids"], t["par"], t["h"].reshape(-1, D).to(bf),
                 t["c"].reshape(-1, D).to(bf))
    args = (t["bias"], t["w"].reshape(9, D).t().to(bf), *step_args, scene, H,
            W)
    got = make_decode_step(tier, cell, {"w": t["w"]}, t["emb"],
                           scene)(*step_args)
    if tier == "none":
        want = decode_step_gathered(
            t["kernel"].to(bf).reshape(-1, 4 * D), *args[:4],
            t["emb"].to(bf).reshape(HW, HW, E), *args[4:])
    elif tier == "int8_dyn":
        want = decode_step_gathered_q8dyn(
            quantize_decode_weights_v2(cell, t["emb"]), *args)
    else:
        want = decode_step_gathered_q8(
            quantize_decode_weights(cell, t["emb"]), *args,
            attn_q8=tier == "int8a")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _beam_setup(rng, quant):
    cfg = MultiverseConfig(
        scene_h=12, scene_w=16, scene_class=5, emb_size=E,
        enc_hidden_size=D, dec_hidden_size=D, scene_conv_dim=C,
        use_beam_search=True, beam_size=4, diverse_beam=True,
        diverse_gamma=0.01, fix_num_timestep=1, compute_dtype="bfloat16",
        decode_quant=quant).validate()
    jtree = jax.tree_util.tree_map(np.asarray,
                                   jax_init_params(jax.random.PRNGKey(1), cfg))
    N = 2
    a = dict(
        first=np.array(j_one_hot(jnp.asarray(rng.randint(0, HW, N)), H, W)),
        c=rng.randn(N, H, W, D).astype(np.float32) * 0.5,
        h=np.tanh(rng.randn(N, H, W, D)).astype(np.float32),
        scene=np.abs(rng.randn(N, H, W, C)).astype(np.float32),
    )
    return cfg, jtree, a


@pytest.mark.parametrize("quant", ["int8", "int8a", "int8_dyn"])
def test_q8_beam_wiring_tracks_jax_interpret(rng, monkeypatch, quant):
    """The q8 beam wiring against the JAX beam search running the Pallas
    q8 kernels in interpret mode: every decode step goes through the q8
    step of the tier (K2, K3 or K7), the step-0 logits agree within
    2e-2, and the beam ids are equal on these seeded inputs (bf16
    near-ties could flip an id; on these inputs none does)."""
    monkeypatch.setattr(jpd, "FORCE_INTERPRET_FUSED", True)
    cfg, jtree, a = _beam_setup(rng, quant)
    T = 5
    jout = jbs.diverse_beam_search(
        jax.tree_util.tree_map(jnp.asarray, jtree["scales"]["0"]), cfg,
        jnp.asarray(a["first"]),
        JState(c=jnp.asarray(a["c"]), h=jnp.asarray(a["h"])), T,
        scene_mean=jnp.asarray(a["scene"]), compute_dtype=jnp.bfloat16)
    calls = []

    def counting(*args, **kw):
        calls.append(kw.get("attn_q8"))
        return decode_step_gathered_q8(*args, **kw)

    def counting_dyn(*args, **kw):
        calls.append("int8_dyn")
        return decode_step_gathered_q8dyn(*args, **kw)

    from multiverse_torch.ops import quant as tquant

    monkeypatch.setattr(tquant, "decode_step_gathered_q8", counting)
    monkeypatch.setattr(tquant, "decode_step_gathered_q8dyn", counting_dyn)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tout = tbs.diverse_beam_search(
        params_from_jax(jtree)["scales"]["0"], cfg, t["first"],
        TState(c=t["c"], h=t["h"]), T, scene_mean=t["scene"],
        compute_dtype=torch.bfloat16)
    assert calls == ["int8_dyn" if quant == "int8_dyn"
                     else quant == "int8a"] * T
    np.testing.assert_allclose(np.asarray(jout.logits[:, :, 0]),
                               tout.logits[:, :, 0].numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(np.asarray(jout.ids), tout.ids.numpy())


@pytest.mark.parametrize("quant", ["int8", "int8a", "int8_dyn"])
def test_q8_beam_batched_equals_per_sample(rng, quant):
    """Batched variable-length q8 decode equals each sample decoded
    alone (same step, same rounding: a difference is a parent or
    backtrace bug)."""
    cfg, jtree, a = _beam_setup(rng, quant)
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
