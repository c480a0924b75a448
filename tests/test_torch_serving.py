"""The port's serving path on the CPU: the engine answers concurrent
beam and greedy requests exactly as the offline forward does on the
same inputs, applies backpressure, swaps weights, and serves HTTP
through both front ends to the port's client; the wire frames are byte
for byte the JAX package's; ``mvt-torch-serve``'s tier defaults follow
the JAX rule with cuda as the accelerator."""

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from multiverse_torch import inference as tinf
from multiverse_torch.bridge import params_from_jax
from multiverse_torch.cli import serve as tserve
from multiverse_torch.config import MultiverseConfig
from multiverse_torch.data.dataset import batch_to_device
from multiverse_torch.geometry import grid_centers, rasterize_traj_np
from multiverse_torch.models import Batch, Multiverse
from multiverse_torch.serving import wire as twire
from multiverse_torch.serving.client import PredictionClient
from multiverse_torch.serving.engine import (
    EngineOverloadedError,
    PredictionResult,
    ServingEngine,
)


def _cfg(greedy=False, **kw):
    """The JAX serving tests' tiny configuration (tests/synthetic.py)."""
    base = dict(obs_len=4, pred_len=5, scene_h=12, scene_w=16,
                scene_class=5, emb_size=8, enc_hidden_size=16,
                dec_hidden_size=16, scene_conv_dim=8,
                use_beam_search=not greedy, beam_size=3, diverse_beam=True,
                diverse_gamma=0.01, fix_num_timestep=1)
    base.update(kw)
    return MultiverseConfig(**base).validate()


def _random_obs(rng, cfg, n):
    return [np.stack([rng.uniform(0, cfg.video_w, cfg.obs_len),
                      rng.uniform(0, cfg.video_h, cfg.obs_len)],
                     axis=1).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def beam_engine():
    cfg = _cfg()
    model = Multiverse.init(cfg, seed=0)
    eng = ServingEngine(model, cfg, max_batch=4, max_delay_ms=30.0,
                        T_pred=5, device="cpu")
    eng.warmup()
    yield cfg, model, eng
    eng.close()


def _direct(model, cfg, obs, pred_len, B, T):
    """The offline forward of one request in every row of a batch
    rasterised on the host (numpy), as the JAX serving tests build it."""
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    cls, tgt = rasterize_traj_np(obs, cfg.video_h, cfg.video_w,
                                 cfg.scene_grids)
    rows = np.zeros((B * cfg.obs_len, cfg.scene_h, cfg.scene_w,
                     cfg.scene_class), np.uint8)
    rows[..., 0] = 1
    batch = batch_to_device(Batch(
        obs_grid_class=np.tile(cls[None], (B, 1, 1)),
        obs_grid_target_all=(np.tile(tgt[i][None], (B, 1, 1, 1, 1)),),
        obs_scene=np.arange(B * cfg.obs_len,
                            dtype=np.int32).reshape(B, cfg.obs_len),
        scene_feat=rows,
        pred_length=np.full((B,), pred_len, np.int32)), torch.device("cpu"))
    centers = torch.as_tensor(
        grid_centers(cfg.video_h, cfg.video_w, h, w).reshape(-1, 2),
        dtype=torch.float32)
    with torch.inference_mode():
        if not cfg.use_beam_search:
            logits, reg = tinf.greedy_forward(model, batch, cfg, T_pred=T)
            trajs = tinf.reconstruct_greedy_trajs(logits, reg, centers)
            return trajs[0, :pred_len].numpy(), None
        beam, reg = tinf.beam_forward(model, batch, cfg, T_pred=T)
        trajs = tinf.reconstruct_beam_trajs(beam.ids, reg, centers)
        return trajs[0, :, :pred_len].numpy(), beam.logprobs[0].numpy()


@pytest.mark.parametrize("greedy", [False, True])
def test_concurrent_requests_equal_the_offline_forward(rng, greedy):
    cfg = _cfg(greedy, compute_dtype="bfloat16", decode_quant="int8a")
    model = Multiverse.init(cfg, seed=0)
    eng = ServingEngine(model, cfg, max_batch=4, max_delay_ms=20.0,
                        T_pred=5, device="cpu")
    try:
        obs = _random_obs(rng, cfg, 16)
        pred_lens = rng.randint(1, 6, 16)
        results = [None] * 16

        def call(k):
            results[k] = eng.predict(obs[k], pred_len=int(pred_lens[k]))

        threads = [threading.Thread(target=call, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = eng.stats.snapshot()
        assert stats["requests"] == 16 and stats["errors"] == 0
        assert stats["batches"] < 16      # requests were batched together
        for k, r in enumerate(results):
            assert r.trajs.shape == (cfg.beam_size, pred_lens[k], 2)
            want, logprobs = _direct(model, cfg, obs[k], int(pred_lens[k]),
                                     eng.max_batch, eng.T_pred)
            if greedy:
                for j in range(cfg.beam_size):
                    np.testing.assert_allclose(r.trajs[j], want, atol=1e-4)
                np.testing.assert_array_equal(r.logprobs, 0.0)
            else:
                np.testing.assert_allclose(r.trajs, want, atol=1e-4)
                np.testing.assert_allclose(r.logprobs, logprobs, atol=1e-5)
    finally:
        eng.close()


def test_bad_requests_rejected(beam_engine):
    cfg, _, eng = beam_engine
    with pytest.raises(ValueError):
        eng.submit(np.zeros((cfg.obs_len + 1, 2), np.float32))
    with pytest.raises(ValueError, match="non-finite"):
        eng.submit(np.full((cfg.obs_len, 2), np.nan, np.float32))
    with pytest.raises(ValueError):
        eng.submit(np.zeros((cfg.obs_len, 2), np.float32),
                   pred_len=eng.T_pred + 1)
    with pytest.raises(ValueError, match="class ids"):
        eng.submit(np.zeros((cfg.obs_len, 2), np.float32),
                   scene_class_map=np.full((cfg.scene_h, cfg.scene_w),
                                           cfg.scene_class))


def test_scene_map_changes_prediction(rng, beam_engine):
    cfg, _, eng = beam_engine
    obs = _random_obs(rng, cfg, 1)[0]
    base = eng.predict(obs, pred_len=4)
    cm = rng.randint(1, cfg.scene_class, (cfg.scene_h, cfg.scene_w))
    seen = eng.predict(obs, scene_class_map=cm, pred_len=4)
    assert not np.allclose(base.logprobs, seen.logprobs)


def test_bounded_queue_overload(rng):
    """With the batcher stalled inside a device step, queued requests
    beyond max_queue raise EngineOverloadedError, and every admitted
    request still resolves once the step unblocks."""
    cfg = _cfg()
    eng = ServingEngine(Multiverse.init(cfg), cfg, max_batch=1,
                        max_delay_ms=1.0, T_pred=4, max_queue=2,
                        device="cpu")
    gate = threading.Event()
    try:
        eng.warmup()
        orig_step = eng._device_step

        def slow_step(p, b):
            gate.wait(10)
            return orig_step(p, b)

        eng._device_step = slow_step
        obs = _random_obs(rng, cfg, 1)[0]
        p1 = eng.submit(obs)                  # the batcher takes it, stalls
        deadline = time.time() + 5
        while not eng._queue.empty() and time.time() < deadline:
            time.sleep(0.005)
        assert eng._queue.empty(), "the batcher never picked up p1"
        p2, p3 = eng.submit(obs), eng.submit(obs)
        with pytest.raises(EngineOverloadedError):
            eng.submit(obs)
        assert eng.stats.snapshot()["rejected"] == 1
        gate.set()
        for p in (p1, p2, p3):
            assert p.event.wait(15) and p.error is None
            assert p.result.trajs.shape == (cfg.beam_size, 4, 2)
    finally:
        gate.set()
        eng.close()
    with pytest.raises(ValueError, match="max_queue"):
        ServingEngine(Multiverse.init(cfg), cfg, max_queue=0, device="cpu")


def test_update_params_swaps_weights(rng):
    cfg = _cfg()
    eng = ServingEngine(Multiverse.init(cfg, seed=0), cfg, max_batch=2,
                        T_pred=4, device="cpu")
    try:
        obs = _random_obs(rng, cfg, 1)[0]
        before = eng.predict(obs)
        eng.update_params(Multiverse.init(cfg, seed=1))
        after = eng.predict(obs)
        assert not np.allclose(before.logprobs, after.logprobs)
        with pytest.raises(ValueError, match="do not match"):
            eng.update_params(Multiverse.init(_cfg(emb_size=4)))
    finally:
        eng.close()


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(Multiverse.init(cfg), cfg)


@pytest.mark.parametrize("backend", ["threads", "asyncio"])
def test_http_roundtrip_both_front_ends(rng, backend):
    from multiverse_torch.serving.aserver import AsyncPredictionServer
    from multiverse_torch.serving.server import PredictionServer

    cfg = _cfg()
    eng = ServingEngine(Multiverse.init(cfg), cfg, max_batch=2,
                        max_delay_ms=2.0, T_pred=4, max_queue=8,
                        device="cpu")
    cls = PredictionServer if backend == "threads" else AsyncPredictionServer
    server = cls(eng, host="127.0.0.1", port=0)
    server.start_background()
    try:
        obs = _random_obs(rng, cfg, 1)[0]
        want = eng.predict(obs, pred_len=3)
        for binary in (False, True):
            client = PredictionClient(port=server.port, binary=binary)
            try:
                assert client.healthy()
                out = client.predict(obs, pred_len=3)
                np.testing.assert_array_equal(out["trajs"], want.trajs)
                np.testing.assert_array_equal(out["logprobs"],
                                              want.logprobs)
                assert out["pred_len"] == 3
                assert client.stats()["requests"] >= 2
            finally:
                client.close()
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=10)
        conn.request("POST", "/v1/predict",
                     body=json.dumps({"obs_traj": [[1, 2]]}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 400 and b"obs_traj" in resp.read()
        conn.close()
    finally:
        server.close()


def test_wire_frames_equal_jax_bytes(rng):
    from multiverse_tpu.serving import wire as jwire

    assert twire.TENSOR_CONTENT_TYPE == jwire.TENSOR_CONTENT_TYPE
    for K, T in ((20, 12), (3, 1)):
        res = PredictionResult(
            trajs=rng.randn(K, T, 2).astype(np.float32) * 100,
            logprobs=rng.randn(K).astype(np.float32), pred_len=T)
        frame = twire.build_tensor_frame(res)
        assert frame == jwire.build_tensor_frame(res)
        for parsed in (twire.parse_tensor_frame(frame),
                       jwire.parse_tensor_frame(frame)):
            np.testing.assert_array_equal(parsed["trajs"], res.trajs)
            np.testing.assert_array_equal(parsed["logprobs"], res.logprobs)
            assert parsed["pred_len"] == T


def test_serving_dtype_resolution_flag_spellings():
    """On cuda with neither flag given the tier is bf16 + int8a; any
    explicit --compute_dtype/--decode_quant, in every argparse spelling,
    disables the default, as in the JAX package's mvt-serve."""
    base = ["out", "model", "--port", "8500"]

    def resolve(argv, device_type):
        a = tserve.build_parser().parse_args(argv)
        return tserve.resolve_serving_dtypes(device_type, a.compute_dtype,
                                             a.decode_quant)

    assert tserve.resolve_serving_dtypes("cuda", None, None) == (
        "bfloat16", "int8a")
    assert resolve(base, "cuda") == ("bfloat16", "int8a")
    assert resolve(base, "cpu") == ("float32", "none")
    for explicit, expect in (
            (["--compute_dtype", "float32"], ("float32", "none")),
            (["--compute_dtype=float32"], ("float32", "none")),
            (["--decode_quant", "none"], ("float32", "none")),
            (["--decode_quant=none"], ("float32", "none")),
            (["--decode_qua", "int8_dyn"], ("float32", "int8_dyn")),
            (["--decode_qua=int8_dyn"], ("float32", "int8_dyn")),
            (["--compute_dt", "float32"], ("float32", "none"))):
        assert resolve(base + explicit, "cuda") == expect
    # a flag whose VALUE merely mentions the name is not an override
    assert resolve(base + ["--load_from", "ckpt--compute_dtype"],
                   "cuda") == ("bfloat16", "int8a")
    assert tserve.resolve_max_batch(None, greedy=False) == 8
    assert tserve.resolve_max_batch(None, greedy=True) == 32
    assert tserve.resolve_max_batch(5, greedy=True) == 5


@pytest.mark.parametrize("extra,match", [
    (["--random_init", "--reload_poll_s", "5"], "--reload_poll_s needs"),
    (["--load_from", "ckpt", "--reload_poll_s", "5"],
     "--reload_poll_s needs"),
    # serving across devices is ported; four are not visible here
    (["--random_init", "--num_devices", "4"],
     "--num_devices 4: expected 4 devices, found 1"),
])
def test_serve_cli_refuses_what_is_not_ported(extra, match):
    with pytest.raises(SystemExit, match=match):
        tserve.main(["out", "model", "--device", "cpu", *extra])


def test_serve_cli_answers_in_the_int8_dyn_tier(rng, monkeypatch):
    """``mvt-torch-serve --decode_quant int8_dyn`` serves: the CLI's own
    main builds the engine in bf16 + int8_dyn, and one request sent to
    its asyncio front end is answered, every decode step through the
    int8_dyn step (K7's plain version on the CPU)."""
    from multiverse_torch.ops import quant as tquant
    from multiverse_torch.serving import aserver

    steps = []
    dyn = tquant.decode_step_gathered_q8dyn

    def counting(*args, **kw):
        steps.append(1)
        return dyn(*args, **kw)

    monkeypatch.setattr(tquant, "decode_step_gathered_q8dyn", counting)
    cfg = _cfg()
    obs = _random_obs(rng, cfg, 1)[0]
    answers = []

    def ask_then_stop(server):
        client = PredictionClient(port=server.port)
        try:
            answers.append(client.predict(obs, pred_len=3))
        finally:
            client.close()

    monkeypatch.setattr(aserver.AsyncPredictionServer, "wait", ask_then_stop)
    tserve.main(["out", "model", "--device", "cpu", "--random_init",
                 "--port", "0", "--use_gnn", "--use_scene_enc",
                 "--use_beam_search", "--beam_size", "3", "--diverse_beam",
                 "--diverse_gamma", "0.01", "--fix_num_timestep", "1",
                 "--compute_dtype", "bfloat16", "--decode_quant", "int8_dyn",
                 "--max_batch", "2", "--T_pred", "4", "--obs_len", "4",
                 "--scene_h", "12", "--scene_w", "16", "--scene_class", "5",
                 "--emb_size", "8", "--enc_hidden_size", "16",
                 "--dec_hidden_size", "16", "--scene_conv_dim", "8"])
    (answer,) = answers
    assert answer["trajs"].shape == (3, 3, 2) and answer["pred_len"] == 3
    assert np.isfinite(answer["trajs"]).all()
    assert np.isfinite(answer["logprobs"]).all()
    # warm-up and the request: T_pred steps each, all through int8_dyn
    assert len(steps) >= 2 * 4 and len(steps) % 4 == 0


def test_serve_cli_loads_npz_weights(tmp_path):
    from multiverse_tpu.models import init_params as jax_init_params
    from multiverse_torch.bridge import save_params_npz

    args = tserve.build_parser().parse_args(
        ["out", "model", "--device", "cpu", "--use_gnn", "--use_scene_enc",
         "--load_from", str(tmp_path / "p.npz"), "--emb_size", "8",
         "--enc_hidden_size", "16", "--dec_hidden_size", "16",
         "--scene_conv_dim", "8"])
    args.compute_dtype, args.decode_quant = tserve.resolve_serving_dtypes(
        "cpu", args.compute_dtype, args.decode_quant)
    cfg = tserve.config_from_args(args)
    model = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(2), cfg)))
    save_params_npz(model, args.load_from)
    loaded, step = tserve.load_model(args, cfg)
    assert step is None
    # the loaded module follows the configuration's order of names
    want = dict(model.named_parameters())
    got = dict(loaded.named_parameters())
    assert sorted(got) == sorted(want)
    for n, b in want.items():
        torch.testing.assert_close(got[n], b, rtol=0, atol=0)
