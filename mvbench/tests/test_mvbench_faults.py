"""A run whose timed path is broken underneath reads ``correct`` false:
each fault the decode cell can have, planted at a tiny size on the CPU,
the rest of the run driven as the command drives it (the look for a
card skipped). The sound runs of the same sizes read true
(``test_mvbench_run.py``); the planted runs compute in float32, where
the sound program equals the reference."""

import pytest

from mvbench import run

TINY = dict(emb_size=8, enc_hidden_size=16, dec_hidden_size=16,
            scene_conv_dim=8, scene_h=12, scene_w=16,
            compute_dtype="float32", beam_size=4)
TRAFFIC = dict(pool=64, chunk=32, sample_per_chunk=4, min_pred_len=3,
               max_pred_len=6)
CELL = "flagship.decode_b16"


def go(seed=2**31 + 3):
    return run.execute(CELL, seed, 0.5, False, "cpu", 0.0,
                       overrides=TINY, workload=TRAFFIC)


def selection(monkeypatch, fault):
    """Both forms of successor selection, called through ``fault``."""
    from multiverse_torch.models import beam_search

    for name in ("select_successors_twostage", "select_successors_dense"):
        real = getattr(beam_search, name)
        monkeypatch.setattr(
            beam_search, name,
            lambda *a, real=real: fault(real, *a))


def altered_token(monkeypatch):
    """The second beam's cell moved one cell on where it is chosen."""
    def fault(real, logprob, logits_t, K, t, diverse, gamma):
        lp, ids, parents = real(logprob, logits_t, K, t, diverse, gamma)
        ids = ids.clone()
        ids[:, 1] = (ids[:, 1] + 1) % logits_t.shape[-1]
        return lp, ids, parents

    selection(monkeypatch, fault)


def outside_first_k(monkeypatch):
    """The first step gives the second beam the (K+1)-th best cell."""
    import torch

    def fault(real, logprob, logits_t, K, t, diverse, gamma):
        lp, ids, parents = real(logprob, logits_t, K, t, diverse, gamma)
        if t == 0:
            ids = ids.clone()
            ids[:, 1] = torch.sort(logits_t[:, 0], dim=-1, descending=True,
                                   stable=True).indices[:, K].int()
        return lp, ids, parents

    selection(monkeypatch, fault)


def accumulation_dropped(monkeypatch):
    """Candidates scored without their beam's likelihood so far."""
    def fault(real, logprob, logits_t, K, t, diverse, gamma):
        return real(logprob * 0, logits_t, K, t, diverse, gamma)

    selection(monkeypatch, fault)


def penalty_ignored(monkeypatch):
    """The diversity penalty left out of the candidates' scores."""
    def fault(real, logprob, logits_t, K, t, diverse, gamma):
        return real(logprob, logits_t, K, t, False, gamma)

    selection(monkeypatch, fault)


def one_parent(monkeypatch):
    """Every step expands the best beam only, as the first step does."""
    def fault(real, logprob, logits_t, K, t, diverse, gamma):
        return real(logprob, logits_t, K, 0, diverse, gamma)

    selection(monkeypatch, fault)


def worst_candidates(monkeypatch):
    """From the second step on, the K worst of the K*K candidates kept,
    the best of them first."""
    import math

    import torch

    def fault(real, logprob, logits_t, K, t, diverse, gamma):
        if t == 0:
            return real(logprob, logits_t, K, t, diverse, gamma)
        N = logits_t.shape[0]
        vals, cells = torch.topk(logits_t, K)
        cand = logprob[:, :, None] + vals - torch.logsumexp(
            logits_t, dim=-1, keepdim=True)
        if diverse:
            cand = cand + math.log(gamma) * torch.arange(
                K, device=cand.device)
        cand = cand.reshape(N, K * K)
        flat = torch.argsort(cand, dim=-1)[:, :K].flip(-1)
        return (cand.gather(1, flat),
                cells.reshape(N, K * K).gather(1, flat).int(),
                (flat // K).int())

    selection(monkeypatch, fault)


def stale_state(monkeypatch):
    """The decode step hands back the state it was given."""
    from multiverse_torch.models import beam_search
    from multiverse_torch.ops import convlstm

    real = convlstm.convlstm_step

    def step(params, x, state, *a, **kw):
        out, _ = real(params, x, state, *a, **kw)
        return out, state

    monkeypatch.setattr(beam_search, "convlstm_step", step)


@pytest.mark.parametrize("fault", [altered_token, outside_first_k,
                                   accumulation_dropped,
                                   penalty_ignored, one_parent,
                                   worst_candidates, stale_state])
def test_decode_faults_read_incorrect(monkeypatch, fault):
    assert go()["correct"]
    fault(monkeypatch)
    out = go()
    assert not out["correct"], out["checks"]


def test_fp8_control_reads_incorrect():
    """The control's regression head at a tiny size: the reference with
    fp8 operands in the program's place moves the points past the
    limit."""
    import torch

    from mvbench.drivers import decode
    from mvbench.reference.plain import fp8
    from mvbench.trace import Spans

    wl = dict(run.load_json("workloads", CELL), **TRAFFIC)
    ctx = run.Ctx(CELL, wl, run.load_json("configs", wl["config"]),
                  2**31 + 9, torch.device("cpu"), Spans(), 0.5)
    s = decode.setup(ctx, TINY)
    decode.window(s, 0.5)
    decode.release(s)
    got = decode.readings(s, fp8)
    assert got["traj_px"] <= wl["limits"]["traj_px"]
    assert got["control.traj_px"] > wl["limits"]["traj_px"], got


@pytest.mark.cuda
def test_int8a_control_reads_incorrect():
    """The control at a small pool on the card: the program's int8a
    tier fails a limit of the cell."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8a tier runs only there")
    from mvbench import control

    got = control.readings(CELL, 2**31 + 9, "control", 2.0,
                           workload=dict(pool=256, chunk=128))
    limits = run.load_json("workloads", CELL)["limits"]
    assert any(got[k] > limits[k] for k in limits), got
