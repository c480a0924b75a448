"""Driver ``decode``: offline K-beam multi-future inference, as
``mvt-torch-multifuture-inference`` runs it.

Set-up makes the weights and a pool of observations from the seed (the
traffic file gives the pool, the chunk, the future lengths and the
batch), cuts the pool into chunks and warms the decode on one batch of
the timed shapes. The window calls ``run_multifuture_inference`` on one
chunk after another (both pickle dicts assembled in memory, beam logits
fetched in f32), counts each chunk's trajectories and keeps only the
entries of a seeded sample, until ``--seconds`` have passed; the rate is
over every chunk it ran and all their time. The check decodes the
sample with the plain reference (``mvbench/reference/decode_check.py``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mvbench.reference import decode_check
from mvbench.reference.plain import fp8
from mvbench.run import limited
from mvbench.traffic.generators import multifuture_inputs, np_seed
from mvbench.weights import make_weights, nest


def decode_config(flags, overrides=None):
    """The configuration ``mvt-torch-multifuture-inference`` builds from
    ``flags`` (its parser and its mapping), with ``overrides``."""
    from multiverse_torch.cli.multifuture_inference import build_parser
    from multiverse_torch.config import MultiverseConfig

    a = build_parser().parse_args(["model", "obs", "gt", "out"] + flags)
    cfg = MultiverseConfig(
        obs_len=a.obs_length, emb_size=a.emb_size,
        enc_hidden_size=a.enc_hidden_size,
        dec_hidden_size=a.dec_hidden_size,
        scene_conv_kernel=a.scene_conv_kernel,
        scene_conv_dim=a.scene_conv_dim, convlstm_kernel=a.convlstm_kernel,
        use_gnn=a.use_gnn, use_scene_enc=a.use_scene_enc,
        use_single_decoder=a.use_single_decoder,
        use_soft_grid_class=a.use_soft_grid_class, norm_input=a.norm_input,
        scene_h=a.scene_h, scene_w=a.scene_w, scene_class=a.scene_class,
        video_h=a.video_h, video_w=a.video_w, beam_size=a.num_out,
        use_beam_search=not a.greedy, diverse_beam=a.diverse_beam,
        diverse_gamma=a.diverse_gamma,
        fix_num_timestep=a.fix_num_timestep,
        compute_dtype=a.compute_dtype, decode_quant=a.decode_quant,
        beam_select=a.beam_select,
        **MultiverseConfig.parse_strides(a.grid_strides, a.use_grids),
    )
    return cfg.replace(**(overrides or {})).validate(), a


class State:
    pass


def setup(ctx, overrides=None) -> State:
    """``overrides``: configuration fields changed from the cell's (the
    tests' small widths, the control's lower-precision tier)."""
    from multiverse_torch.inference import (
        MultifutureInputs,
        run_multifuture_inference,
    )
    from multiverse_torch.models import Multiverse

    wl = ctx.workload
    cfg, args = decode_config(ctx.config["decode_flags"], overrides)
    model = dataclasses.asdict(cfg)
    s = State()
    s.ctx, s.cfg, s.model, s.args = ctx, cfg, model, args
    s.T = wl["max_pred_len"]
    s.weights = make_weights(model, ctx.seed, ctx.device)
    s.params = Multiverse(nest(s.weights)).to(ctx.device)
    pool = multifuture_inputs(model, wl["pool"], ctx.seed,
                              wl["min_pred_len"], wl["max_pred_len"])
    s.pool = pool

    def chunk(lo, hi):
        return MultifutureInputs(
            traj_ids=pool["traj_ids"][lo:hi],
            obs_traj=pool["obs_traj"][lo:hi],
            obs_grid_class=pool["obs_grid_class"][lo:hi],
            obs_grid_target=[t[lo:hi] for t in pool["obs_grid_target"]],
            obs_scene=pool["obs_scene"][lo:hi],
            scene_feat=pool["scene_feat"],
            pred_lengths=pool["pred_lengths"][lo:hi])

    n = wl["chunk"]
    s.chunks = [chunk(lo, lo + n) for lo in range(0, wl["pool"], n)]
    # the sample the check reads: seeded, the pool's longest future in it
    rnd = np.random.RandomState(np_seed(ctx.seed, 7))
    s.sample = {}
    for c in range(len(s.chunks)):
        pick = rnd.choice(n, wl["sample_per_chunk"], replace=False) + c * n
        s.sample[c] = set(int(i) for i in pick)
    s.sample[0].add(int(np.argmax(pool["pred_lengths"][:n])))

    def run(inputs, timings=None):
        return run_multifuture_inference(
            s.params, inputs, cfg, batch_size=args.batch_size, T_max=s.T,
            need_prob=True, prob_fetch_dtype=args.prob_fetch_dtype,
            device=ctx.device, timings=timings)

    s.run = run
    # warm the timed shapes: one batch of the decode at T_max
    b = args.batch_size
    run(chunk(0, b))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return s


def instrument(s: State) -> list:
    """Spans around the program's layers inside the decode (traced runs
    only): host batch packing, the upload, and the beam forward's
    enqueue."""
    from multiverse_torch import inference

    sp = s.ctx.spans
    return [sp.wrap(inference, "make_batch", "decode.make_batch"),
            sp.wrap(inference, "batch_to_device", "decode.upload"),
            sp.wrap(inference, "beam_forward", "decode.beam_forward")]


def decode_launches() -> int:
    """Launches of the fused decode step, every tier."""
    from multiverse_torch.ops import fused_decode as fd

    return (fd.decode_step_gathered.launches
            + sum(fd.decode_step_gathered_q8.launches.values())
            + fd.decode_step_gathered_q8dyn.launches)


def window(s: State, seconds: float) -> None:
    sp = s.ctx.spans
    s.timings = {}
    s.kept_out, s.kept_prob = {}, {}
    s.kept = []
    s.done = s.attempted = 0
    k0 = decode_launches()
    t0 = time.perf_counter()
    i = 0
    while True:
        c = i % len(s.chunks)
        chunk = s.chunks[c]
        with sp("decode.chunk"):
            out, prob = s.run(chunk, s.timings)
        s.attempted += len(chunk.traj_ids)
        s.done += sum(1 for t in chunk.traj_ids if t in out and t in prob)
        if i < len(s.chunks):
            for n in sorted(s.sample[c]):
                tid = s.pool["traj_ids"][n]
                if tid in out and tid in prob:
                    s.kept_out[tid], s.kept_prob[tid] = out[tid], prob[tid]
                s.kept.append(n)
        del out, prob
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    s.elapsed = time.perf_counter() - t0
    s.launches = decode_launches() - k0


def result(s: State) -> dict:
    t = s.timings
    return {"metrics": {"decode_traj_per_s": s.done / s.elapsed},
            "attempted": s.attempted, "failed": s.attempted - s.done,
            "facts": {"elapsed_s": s.elapsed, "batches": t["batches"],
                      "build_s": t["build_s"], "fetch_s": t["fetch_s"],
                      "pack_s": t["pack_s"], "trajectories": s.done,
                      "t_pred": s.T, "batch": s.args.batch_size,
                      "launches": s.launches, "cfg": s.cfg}}


def release(s: State) -> None:
    del s.params, s.chunks


def readings(s: State, low_quant=None) -> dict:
    """Every number the reference reads on the kept sample (with
    ``low_quant``, the control's too), and the fused decode's launches
    missing against batches x steps."""
    pool = s.pool
    idx = np.asarray(sorted(set(s.kept)))
    scale = s.cfg.active_scales[0]
    sample = {
        "traj_ids": [pool["traj_ids"][i] for i in idx],
        "obs_class": pool["obs_grid_class"][idx, scale],
        "obs_target": pool["obs_grid_target"][scale][idx],
        "maps": pool["scene_feat"][pool["obs_scene"][idx]],
        "pred_len": np.minimum(pool["pred_lengths"][idx], s.T),
    }
    got = decode_check.check(s.weights, s.model, sample, s.kept_out,
                             s.kept_prob, s.ctx.device,
                             low_quant=low_quant)
    if s.ctx.device.type == "cuda":
        want = int(s.timings["batches"]) * s.T
        got["launches_missing"] = float(abs(want - s.launches))
    return got


def check(s: State) -> dict:
    """{name: (number, limit)} of the numbers the traffic file limits."""
    return limited(readings(s), s.ctx)


MODES = ("program", "control")


def control_readings(ctx, mode: str, seconds: float,
                     overrides=None) -> dict:
    """The numbers the check compares, no limit applied, after a window
    of ``seconds`` at the cell's own load: the program as the cell runs
    it (``program``), or the control (``control``): the program's own
    int8a tier for the class decode, and the reference with fp8 (e4m3)
    operands in the program's place for the regression head, which has
    no int8 path (``control.*``)."""
    overrides = dict(overrides or {})
    if mode == "control":
        overrides["decode_quant"] = "int8a"
    s = setup(ctx, overrides)
    window(s, seconds)
    release(s)
    return readings(s, fp8 if mode == "control" else None)
