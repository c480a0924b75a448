#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``multiverse_torch/csrc`` with nvcc and prints the build time.
2. Kernel phase: the fused decode step (``decode_step_gathered``)
   against its plain PyTorch version on the card, in bf16, at the full
   width of the beam decode (320 beam rows, 18x32 grid, D=256, E=32,
   C=64, permuted parents, random ids). Fails above an absolute error
   of 2e-2 (the tolerance of the JAX package's own kernel test). Times
   both (median of repeated runs after warm-up, CUDA events).
3. Slice phase: ``run_multifuture_inference`` on 32 synthetic
   trajectories (2 batches of 16, K=20 diverse beams, T up to 25) with
   seeded random weights, as ``mvt-torch-multifuture-inference`` runs
   it. Writes and reads back both pickles, checks their shapes and
   finiteness, checks that every decode step went through the kernel,
   prints trajectories per second, and prints how many beam ids of the
   first batch agree with a rerun through the plain version (bf16 near
   ties may flip ids, so this number informs and does not gate).

Prints one JSON line describing the kernel, then, as its last line,
``{"ok": true, "device": {...}}``. Any failure raises and exits nonzero;
without CUDA it exits nonzero before printing anything.
"""

from __future__ import annotations

import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from multiverse_tpu.config import MultiverseConfig
from multiverse_torch import inference
from multiverse_torch.models import Multiverse, beam_search
from multiverse_torch.ops import _build, conv2d, get_activation
from multiverse_torch.ops.fused_decode import (
    decode_step_gathered,
    decode_step_gathered_ref,
)

TOL = 2e-2
KERNEL = {
    "name": "decode_step_gathered",
    "route": "cuda",
    "source": "multiverse_torch/csrc/fused_decode.cu",
    "replaces": "multiverse_tpu/ops/pallas_decode.py:430",
}


def flagship_config() -> MultiverseConfig:
    """The README quick-start beam configuration: K=20 diverse beam,
    gamma 0.01, fix_num_timestep 1, GNN and scene encoder on, bf16,
    18x32 grid, D=256, E=32, scene_conv_dim 64."""
    return MultiverseConfig(
        use_gnn=True, use_scene_enc=True, use_beam_search=True,
        beam_size=20, diverse_beam=True, diverse_gamma=0.01,
        fix_num_timestep=1, compute_dtype="bfloat16",
        beam_select="twostage").validate()


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_operands(model: Multiverse, cfg: MultiverseConfig, dev):
    """Full-width operands in the layouts the beam search passes: the
    model's decoder weights, random tanh-range state, permuted
    parents."""
    N, K = 16, cfg.beam_size
    NK = N * K
    H, W = cfg.scene_grids[0]
    HW, D = H * W, cfg.dec_hidden_size
    bf = torch.bfloat16
    sp = model["scales"]["0"]
    g = torch.Generator().manual_seed(1)
    emb_p = sp["dec_class_emb"]
    basis = torch.eye(HW, device=dev).reshape(HW, H, W, 1)
    emb = conv2d(emb_p, basis, activation=get_activation(cfg.activation),
                 compute_dtype=bf)
    ops = dict(
        cell_w=sp["dec_class"]["kernel"].to(bf).reshape(-1, 4 * D),
        cell_b=sp["dec_class"]["bias"].float(),
        h2g_w=sp["h2g_class"]["w"].to(bf).reshape(9, D).t(),
        prev_ids=torch.randint(0, HW, (NK,), generator=g, dtype=torch.int32),
        parent_rows=torch.randperm(NK, generator=g).to(torch.int32),
        emb_table=emb.to(bf).reshape(HW, HW, -1),
        h=(torch.rand(NK * HW, D, generator=g) * 2 - 1).to(bf),
        c=torch.randn(NK * HW, D, generator=g).to(bf),
        scene=torch.rand(NK * HW, cfg.scene_conv_dim, generator=g).to(bf),
    )
    ops = {k: v.to(dev).contiguous() for k, v in ops.items()}
    return ops, H, W


def kernel_phase(model, cfg, dev) -> dict:
    ops, H, W = kernel_operands(model, cfg, dev)
    out = decode_step_gathered(**ops, H=H, W=W)
    torch.cuda.synchronize()
    ref = decode_step_gathered_ref(**ops, H=H, W=W)
    errs = {name: float((a.float() - b.float()).abs().max())
            for name, a, b in zip(("h", "c", "logits"), out, ref)}
    print("kernel phase: max abs err vs plain (bf16, NK=%d, %dx%d):"
          % (ops["prev_ids"].shape[0], H, W), errs)
    for name, err in errs.items():
        if not err <= TOL:
            raise AssertionError(
                f"kernel disagrees with the plain version on {name}: "
                f"max abs err {err} > {TOL}")
    ms = median_ms(lambda: decode_step_gathered(**ops, H=H, W=W), reps=30)
    plain_ms = median_ms(lambda: decode_step_gathered_ref(**ops, H=H, W=W),
                         reps=20)
    print("kernel phase: kernel %.4f ms, plain %.4f ms (median)"
          % (ms, plain_ms))
    return {"max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms}


def check_pickles(out, prob, inputs, cfg) -> None:
    H, W = cfg.scene_grids[0]
    K = cfg.beam_size
    with tempfile.TemporaryDirectory() as tmp:
        traj_p = os.path.join(tmp, "out.traj.p")
        prob_p = os.path.join(tmp, "out.prob.p")
        inference.save_outputs(out, prob, traj_p, prob_p)
        with open(traj_p, "rb") as f:
            trajs = pickle.load(f)
        with open(prob_p, "rb") as f:
            probs = pickle.load(f)
    if set(trajs) != set(inputs.traj_ids) or set(probs) != set(trajs):
        raise AssertionError("pickles do not cover every trajectory")
    for n, tid in enumerate(inputs.traj_ids):
        T = int(inputs.pred_lengths[n])
        pts = np.asarray(trajs[tid], np.float32)
        logits, logprobs = probs[tid]
        if pts.shape != (K, T, 2) or not np.isfinite(pts).all():
            raise AssertionError(f"{tid}: trajectories {pts.shape}")
        if logits.shape != (1, K, T, H * W) or logits.dtype != np.float32 \
                or not np.isfinite(logits).all():
            raise AssertionError(f"{tid}: beam logits {logits.shape}")
        if logprobs.shape != (1, K) or not np.isfinite(logprobs).all():
            raise AssertionError(f"{tid}: beam logprobs {logprobs.shape}")


def slice_phase(model, cfg, dev) -> int:
    inputs = inference.synthesize_multifuture_inputs(cfg, 32, seed=0)
    batch_size = 16
    T = int(inputs.pred_lengths.max())
    n_batches = -(-len(inputs.traj_ids) // batch_size)

    decode_step_gathered.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, prob = inference.run_multifuture_inference(
        model, inputs, cfg, batch_size=batch_size, need_prob=True,
        device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = decode_step_gathered.launches
    print("slice phase: %d trajectories, %d batches, T=%d, %d kernel "
          "launches, first run %.3f s" % (len(inputs.traj_ids), n_batches,
                                          T, launches, first_s))
    if launches != n_batches * T:
        raise AssertionError(f"the decode ran {launches} kernel steps, "
                             f"expected {n_batches} x {T}")
    check_pickles(out, prob, inputs, cfg)

    t0 = time.perf_counter()
    inference.run_multifuture_inference(
        model, inputs, cfg, batch_size=batch_size, need_prob=True,
        device=dev)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    print("slice phase: %.2f traj/s (second run, %.3f s, .traj.p and "
          ".prob.p outputs)" % (len(inputs.traj_ids) / steady_s, steady_s))

    batch = inference.batch_to_device(
        inference.make_batch(inputs, np.arange(batch_size), cfg), dev)
    with torch.inference_mode():
        beam_k, _ = inference.beam_forward(model, batch, cfg, T_pred=T)
        with mock.patch.object(beam_search, "decode_step_gathered",
                               decode_step_gathered_ref):
            beam_p, _ = inference.beam_forward(model, batch, cfg, T_pred=T)
    lengths = batch.pred_length.cpu().numpy()
    ids_k, ids_p = beam_k.ids.cpu().numpy(), beam_p.ids.cpu().numpy()
    agree = np.mean(np.concatenate([
        (ids_k[n, :, :lengths[n]] == ids_p[n, :, :lengths[n]]).ravel()
        for n in range(batch_size)]))
    step0 = float((beam_k.logits[:, :, 0] - beam_p.logits[:, :, 0])
                  .abs().max())
    print("slice phase: beam ids of batch 0 agreeing with the plain "
          "version: %.4f; step-0 logits max abs diff %.3g" % (agree, step0))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    print(smi.stdout.strip())
    t0 = time.perf_counter()
    _build.load_library()
    print("kernel build + load: %.1f s (%s)"
          % (time.perf_counter() - t0, _build.library_path().name))

    cfg = flagship_config()
    model = Multiverse.init(cfg, seed=0, device=dev)
    stats = kernel_phase(model, cfg, dev)
    launches = slice_phase(model, cfg, dev)

    print(json.dumps({"kernels": [dict(KERNEL, launches=launches, **stats)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
