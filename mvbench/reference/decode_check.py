"""The reference's reading of a K-beam multi-future decode.

What the program wrote for a trajectory (its ``.traj.p`` entry: K
futures of ``pred_len`` points; its ``.prob.p`` entry: the beams'
logits [1, K, pred_len, HW] and log-likelihoods [1, K]) is judged
against the float32 reference on the same weights and inputs:

* ``traj_px``: each point is a cell center plus the regression
  decoder's offset at that cell. The reference decodes the offsets and
  finds, for each point, the cell whose center + offset lies nearest;
  the distance in pixels is the point's error, and that cell is the
  beam's cell at that step.
* ``cell_gap``: the reference decodes each beam's cells teacher-forced
  (step t reads cell t - 1) and reads, at each step, by how much the
  beam's cell lies below the K-th best logit of its parent's row: beam
  search keeps only cells among a row's K best, so an honest decode
  reads rounding only. The widest gap, in logits. Read, not compared
  (PERF.md): a first-step cell outside the K best shows in
  ``logits_err``, later ones in ``rank_gap``.
* ``rank_gap``: a beam's log-likelihood is the sum, over the counted
  steps (from ``fix_num_timestep``), of the log-softmax of its cells
  plus log(gamma) times each cell's rank in its parent's row, so the
  program's likelihood less the reference's log-softmax sum gives, in
  whole log(gamma) steps, the ranks the program gave the beam's cells.
  Where they differ from the ranks the cells have in the reference's
  rows, the number is how far the reference's logits would have to
  move for them to agree: for n ranks too many (too few), the n-th
  smallest of the distances from the beam's cells to the cells above
  (below) them in their rows, pooled over the steps. The widest, in
  logits; 1e6 where no move makes them agree (a likelihood that implies
  fewer than no ranks).
* ``select_steps``: the selection's own bound. After the last step
  whose likelihood is zeroed, the K beams score 0; at each later step
  every beam's best cell scores at least its beam's score less log(HW),
  so the K-th best score falls by at most log(HW) a step. Each final
  beam is among the K best of the last step, so its likelihood (the
  reference's log-softmax sum with the ranks the program gave) lies
  above that bound. The widest shortfall, in whole log(gamma) steps.
  A selection that keeps one parent's children or the worst candidates
  falls below it. Exact: 0.
* ``logprob_gap``, ``logprob_med``: what is left of (program -
  reference likelihood) after the whole log(gamma) steps; the largest
  and the median over beams. Read, not compared (PERF.md).
* ``logits_err``: the beams' logits at step 0 (every beam reads the
  observed state) against the reference's, and at step 1 each beam's
  row against the nearest of the K rows the step-0 choices give; the
  largest absolute difference.
* ``order_violations``, ``duplicate_beams``, ``malformed``: beams out of
  descending likelihood, two beams with the same cells, and entries not
  of the pickles' shapes. Exact: 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from mvbench.reference.plain import Model, no_tf32
from mvbench.traffic.geometry import grid_centers

NONE = 1e6      # rank_gap where no move of the logits gives the ranks


def unpack(output: dict, prob: dict, traj_ids: List[str], K: int, HW: int,
           pred_lens: np.ndarray):
    """The program's entries of ``traj_ids`` as arrays padded to the
    longest: points [n, K, T, 2], logits [n, K, T, HW], logprobs [n, K];
    and the count of entries that are not of the contract's shapes."""
    n, T = len(traj_ids), int(pred_lens.max())
    pts = np.zeros((n, K, T, 2), np.float32)
    logits = np.zeros((n, K, T, HW), np.float32)
    lps = np.zeros((n, K), np.float32)
    bad = 0
    for a, tid in enumerate(traj_ids):
        pl = int(pred_lens[a])
        try:
            p = np.asarray(output[tid], np.float32)
            lg, lp = prob[tid]
            lg, lp = np.asarray(lg), np.asarray(lp)
        except (KeyError, ValueError, TypeError):
            bad += 1
            continue
        if p.shape != (K, pl, 2) or lp.shape != (1, K) or (
                lg.shape != (1, K, pl, HW) or lg.dtype != np.float32):
            bad += 1
            continue
        pts[a, :, :pl] = p
        logits[a, :, :pl] = lg[0]
        lps[a] = lp[0]
    return pts, logits, lps, bad


def likelihood_steps(model: dict, ref_logits: torch.Tensor,
                     ids: torch.Tensor, lps: torch.Tensor,
                     counted: torch.Tensor) -> dict:
    """``rank_gap``, ``select_steps`` and the likelihood gaps of the
    program's beams ([n, K, T] cells ``ids`` along which the reference
    read ``ref_logits``; ``lps`` the program's likelihoods [n, K];
    ``counted`` [n, T] the steps whose log-softmax the likelihood sums)."""
    if not model["diverse_beam"] or model["fix_num_timestep"] < 1:
        raise ValueError("the selection is read for diverse beams whose "
                         "first step's likelihood is zeroed")
    K = model["beam_size"]
    HW = ref_logits.shape[-1]
    log_g = math.log(model["diverse_gamma"])
    unit = -log_g                                # one rank step
    cnt = counted[:, None].expand(ids.shape)                       # [n,K,T]
    own = ref_logits.gather(-1, ids[..., None])                    # [n,K,T,1]
    inf = torch.full((), math.inf, device=own.device)
    above = ref_logits > own
    places = above.sum(-1)                                         # [n,K,T]
    rank = (places * cnt).sum(-1)                                  # [n, K]
    # how far each of the K nearest cells above (below) lies: moving
    # the cell past j of them changes its rank by j; below, only as far
    # as rank K - 1
    ups = torch.topk(torch.where(above, ref_logits - own, inf), K,
                     largest=False).values                         # [..,K]
    downs = torch.topk(torch.where(ref_logits < own, own - ref_logits, inf),
                       K - 1, largest=False).values                # [..,K-1]
    downs = torch.where(torch.arange(K - 1, device=own.device)
                        < (K - 1 - places)[..., None], downs, inf)
    ups = torch.where(cnt[..., None], ups, inf).flatten(2)
    downs = torch.where(cnt[..., None], downs, inf).flatten(2)
    lsm = torch.log_softmax(ref_logits, dim=-1).gather(
        -1, ids[..., None])[..., 0]                                # [n,K,T]
    like = (lsm * cnt).sum(-1)                                     # [n, K]
    m = torch.round((like - lps) / unit)         # the program's rank sum
    delta = (m - rank).long()                                      # [n, K]
    # the |delta|-th smallest move of all the steps' is the least that
    # the widest move can be
    moves = [torch.cat([torch.zeros_like(x[..., :1]), x.sort(-1).values,
                        torch.full_like(x[..., :1], math.inf)], -1)
             for x in (ups, downs)]
    pick = [x.gather(-1, delta.abs().clamp_max(x.shape[-1] - 1)[..., None])
            for x in moves]
    gap = torch.where(delta < 0, pick[0][..., 0], pick[1][..., 0])
    score = like + m * log_g                     # reference sums, own ranks
    bound = -counted.sum(-1).float() * math.log(HW)                # [n]
    short = torch.clamp_min(bound - score.amin(-1), 0.0)
    return {"rank_gap": min(float(gap.max()), NONE),
            "select_steps": float(torch.round(short / unit).max()),
            "lp_beams": (lps - like + m * unit).abs().reshape(-1).cpu()}


@torch.no_grad()
def check_block(ref: Model, model: dict, inputs: Dict[str, torch.Tensor],
                pts: torch.Tensor, logits: torch.Tensor, lps: torch.Tensor,
                low: Optional[Model] = None) -> dict:
    """The readings of one block of trajectories. ``inputs``: obs_class
    [n, T_obs] (the active scale's cells), obs_target [n, T_obs, h, w,
    2], maps [n, T_obs, SH, SW, C], pred_len [n]; the program's pts,
    logits and lps as :func:`unpack` gives them, on the reference's
    device. ``low``: the reference at a lower precision, whose readings
    along the same paths are the control's. Returns the block's worst
    of each number, and each beam's log-likelihood gap ("lp_beams")."""
    dev = pts.device
    K = model["beam_size"]
    n, _, T, _ = pts.shape
    h, w = ref.h, ref.w_
    HW = h * w
    pl = inputs["pred_len"].long()
    valid = torch.arange(T, device=dev)[None, :] < pl[:, None]      # [n, T]
    vk = valid[:, None].expand(n, K, T)
    centers = torch.as_tensor(grid_centers(
        model["video_h"], model["video_w"], h, w).reshape(HW, 2),
        dtype=torch.float32, device=dev)

    enc, enc_reg, scene_mean = ref.encode(
        inputs["obs_class"], inputs["obs_target"], inputs["maps"])
    reg = ref.reg_decode(enc_reg, inputs["obs_target"][:, -1], T)
    cand = centers + reg.reshape(n, T, HW, 2)                      # [n,T,HW,2]
    dist = torch.linalg.vector_norm(
        pts[:, :, :, None, :] - cand[:, None], dim=-1)             # [n,K,T,HW]
    d_min, ids = dist.min(dim=-1)
    ids = torch.where(vk, ids, torch.zeros_like(ids))

    first = inputs["obs_class"][:, -1]
    ref_logits = ref.class_paths(enc, scene_mean, first, ids)      # [n,K,T,HW]
    kth = torch.topk(ref_logits, K, dim=-1).values[..., -1]
    own = ref_logits.gather(-1, ids[..., None])[..., 0]
    gap = torch.clamp_min(kth - own, 0.0)

    fix = model["fix_num_timestep"]
    counted = (torch.arange(T, device=dev)[None, :] >= fix) & valid  # [n, T]
    out = likelihood_steps(model, ref_logits, ids, lps, counted)
    err = _logits_err(ref, logits, ref_logits, enc, scene_mean, first, K)
    order = (lps[:, 1:] > lps[:, :-1]).sum()
    same = (ids[:, :, None] == ids[:, None, :]) | ~valid[:, None, None]
    dup = torch.triu(same.all(-1), diagonal=1).sum()
    out.update({"cell_gap": float(gap[vk].max()),
                "traj_px": float(d_min[vk].max()),
                "logits_err": float(err), "order_violations": float(order),
                "duplicate_beams": float(dup)})
    if low is not None:
        # the control: the reference at the lower precision in the
        # program's place, along the same paths. Its cells: those it
        # puts in its K best, read in the reference; its points: the
        # same cells' centers + its offsets
        l_enc, l_reg_enc, l_scene = low.encode(
            inputs["obs_class"], inputs["obs_target"], inputs["maps"])
        l_logits = low.class_paths(l_enc, l_scene, first, ids)
        top = torch.topk(l_logits, K, dim=-1).indices
        lgap = torch.clamp_min(kth[..., None] - ref_logits.gather(-1, top),
                               0.0).amax(-1)
        l_reg = low.reg_decode(l_reg_enc, inputs["obs_target"][:, -1], T)
        at = ids.transpose(1, 2)[..., None].expand(n, T, K, 2)
        moved = torch.linalg.vector_norm(
            (l_reg - reg).reshape(n, T, HW, 2).gather(2, at), dim=-1)
        out.update({"control.cell_gap": float(lgap[vk].max()),
                    "control.traj_px":
                    float(moved.transpose(1, 2)[vk].max())})
    return out


def _logits_err(ref, logits, ref_logits, enc, scene_mean, first, K):
    # step 0: every beam's row is the observed state's
    err0 = (logits[:, :, 0] - ref_logits[:, :1, 0]).abs().amax()
    # step 1: the beams of step 0 are the K best cells of that row
    order0 = torch.sort(logits[:, 0, 0], dim=-1, descending=True,
                        stable=True).indices[:, :K]                # [n, K]
    paths = torch.stack([order0, order0], dim=-1)                  # [n,K,2]
    rows1 = ref.class_paths(enc, scene_mean, first, paths)[:, :, 1]
    err1 = (logits[:, :, 1][:, :, None] - rows1[:, None]).abs().amax(-1)
    err1 = err1.min(dim=-1).values.amax()                          # [n,K]->1
    return torch.maximum(err0, err1)


def check(weights: Dict[str, torch.Tensor], model: dict, sample: dict,
          output: dict, prob: dict, device, block: int = 8,
          low_quant=None) -> Dict[str, float]:
    """Judge the program's entries of a sample of trajectories.
    ``sample``: traj_ids, obs_class [n, T_obs] (active scale), obs_target
    [n, T_obs, h, w, 2], maps [n, T_obs, SH, SW, C] uint8, pred_len [n]
    (numpy). Returns the worst of each number over the sample, the
    log-likelihood gaps as their largest (``logprob_gap``) and their
    median over every beam (``logprob_med``); with ``low_quant`` also
    the control's readings (``control.*``)."""
    no_tf32()
    ref = Model(weights, model)
    low = None if low_quant is None else Model(weights, model, low_quant)
    HW = ref.h * ref.w_
    pts, logits, lps, bad = unpack(output, prob, sample["traj_ids"],
                                   model["beam_size"], HW,
                                   sample["pred_len"])
    worst: Dict[str, float] = {"malformed": float(bad)}
    beams = []
    for lo in range(0, len(sample["traj_ids"]), block):
        sl = slice(lo, lo + block)
        t = {k: torch.as_tensor(np.ascontiguousarray(sample[k][sl])).to(
            device) for k in ("obs_class", "obs_target", "maps",
                              "pred_len")}
        got = check_block(ref, model, t,
                          torch.as_tensor(pts[sl]).to(device),
                          torch.as_tensor(logits[sl]).to(device),
                          torch.as_tensor(lps[sl]).to(device), low)
        beams.append(got.pop("lp_beams"))
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    v = torch.cat(beams)
    worst["logprob_gap"] = float(v.max())
    worst["logprob_med"] = float(v.median())
    return worst
