"""Diverse beam search over grid cells.

PyTorch port of ``multiverse_tpu/models/beam_search.py``. Beams are
folded into the batch axis for every conv ([N*K, h, w, .]) and unfolded
to [N, K, .] for the per-step successor selection; finished samples of
a variable-length batch are frozen (identity parents, carried
logprobs); a reverse pass over the parent pointers recovers each final
beam's cells and logits.

Ties decide beam ids, and ``torch.topk`` promises no tie order, so
every top-k here is a stable descending sort: among equal scores the
lower index wins, as with ``jax.lax.top_k``, which the exactness of the
two-stage selector relies on.

Where :func:`multiverse_torch.ops.quant.fused_decode` gives a fused
decode step (bf16, the GNN on) and no states are saved, each step is one
call of it: the state is carried in the order the step wrote it, and
the next step reads each row's parent through ``parent_rows``. Every
other configuration runs the composed step (GNN, cell, readout) with an
explicit parent gather.

Under ``torch.profiler`` the search records its spans
(:func:`multiverse_torch.utils.span`): ``beam.prepare`` (the embedding
table, the step's operands, the tiled state), ``beam.step`` once a step
over ``beam.fused_step`` (the fused step's launches) and ``beam.select``
(selection and freezing), ``beam.backtrace``, and the counter
``beam.steps``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from multiverse_torch.config import MultiverseConfig
from multiverse_torch.ops import (
    ConvLSTMState,
    conv2d,
    convlstm_step,
    gnn_step_auto,
)
from multiverse_torch.ops.layers import get_activation
from multiverse_torch.ops.quant import cell_embedding_table, fused_decode
from multiverse_torch.utils import count, span

NEG_INF = -1e30


class BeamOutputs(NamedTuple):
    best_logits: torch.Tensor        # [N, T, h, w, 1] best beam's logits
    logits: torch.Tensor             # [N, K, T, H*W]
    ids: torch.Tensor                # [N, K, T] grid cell per step
    logprobs: torch.Tensor           # [N, K] total log-likelihood
    states: Optional[torch.Tensor]   # [N, K, T, h, w, D] (single decoder)


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def add_diversity_penalty(logprobs: torch.Tensor,
                          gamma: float) -> torch.Tensor:
    """penalty[v] = log(gamma) * rank(v), rank 0 the best entry of each
    row, ties ranked by index (Li et al. 2016)."""
    order = torch.sort(logprobs, dim=-1, descending=True, stable=True).indices
    iota = torch.arange(logprobs.shape[-1], device=logprobs.device)
    ranks = torch.empty_like(order).scatter_(-1, order, iota.expand_as(order))
    return logprobs + math.log(gamma) * ranks.to(logprobs.dtype)


def _beam0_only(cand: torch.Tensor) -> torch.Tensor:
    keep = (torch.arange(cand.shape[1], device=cand.device) == 0)
    return torch.where(keep[None, :, None], cand,
                       torch.full((), NEG_INF, dtype=cand.dtype,
                                  device=cand.device))


def select_successors_dense(logprob: torch.Tensor, logits_t: torch.Tensor,
                            K: int, t: int, diverse: bool, gamma: float):
    """Full-row log-softmax + rank penalty over all H*W candidates, flat
    top-K over K*H*W. Returns (new logprobs, ids, parents)."""
    N, _, HW = logits_t.shape
    cand = logprob[:, :, None] + torch.log_softmax(logits_t, dim=-1)
    if diverse:
        cand = add_diversity_penalty(cand, gamma)
    if t == 0:          # all beams identical: expand beam 0 only
        cand = _beam0_only(cand)
    new_logprob, flat = stable_topk(cand.reshape(N, -1), K)
    return new_logprob, (flat % HW).int(), (flat // HW).int()


def select_successors_twostage(logprob: torch.Tensor,
                               logits_t: torch.Tensor, K: int, t: int,
                               diverse: bool, gamma: float):
    """Each beam's top-K of the raw logits, then the global top-K of the
    K*K survivors: the dense form's winners, scores and tie order when
    the rank penalty is non-positive (gamma <= 1) and K <= H*W (proof in
    ``multiverse_tpu/models/beam_search.py``)."""
    N = logits_t.shape[0]
    vals, cells = stable_topk(logits_t, K)              # [N, K, K]
    lse = torch.logsumexp(logits_t, dim=-1, keepdim=True)
    cand = logprob[:, :, None] + (vals - lse)
    if diverse:
        cand = cand + math.log(gamma) * torch.arange(
            K, dtype=cand.dtype, device=cand.device)
    if t == 0:
        cand = _beam0_only(cand)
    new_logprob, flat = stable_topk(cand.reshape(N, K * K), K)
    ids = torch.gather(cells.reshape(N, K * K), 1, flat)
    return new_logprob, ids.int(), (flat // K).int()


def _fold(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _gather_beams(x: torch.Tensor, parents: torch.Tensor) -> torch.Tensor:
    """x: [N, K, ...]; parents: [N, K] -> x[n, parents[n, k]]."""
    n = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[n, parents.long()]


def diverse_beam_search(
    scale_params,
    cfg: MultiverseConfig,
    first_input: torch.Tensor,       # [N, h, w, 1] last observed one-hot
    init_state: ConvLSTMState,       # [N, h, w, D] encoder last state
    T_pred: int,
    pred_length: Optional[torch.Tensor] = None,   # [N], <= T_pred
    scene_mean: Optional[torch.Tensor] = None,    # [N, h, w, Cc]
    save_states: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> BeamOutputs:
    cfg.validate()
    K = cfg.beam_size
    N, h, w, _ = first_input.shape
    HW = h * w
    D = init_state.h.shape[-1]
    dev = first_input.device
    act = get_activation(cfg.activation)
    use_gnn = cfg.use_gnn
    emb_p = scale_params["dec_class_emb"]
    cell_p = scale_params["dec_class"]
    h2g_p = scale_params["h2g_class"]

    with span("beam.prepare"):
        def tile(x):
            return x[:, None].expand((N, K) + tuple(x.shape[1:]))

        ids0 = torch.argmax(first_input.reshape(N, HW), dim=1).int()
        prev_ids = ids0[:, None].expand(N, K)
        state_dtype = compute_dtype or init_state.h.dtype
        state = ConvLSTMState(c=tile(init_state.c.to(state_dtype)),
                              h=tile(init_state.h.to(state_dtype)))
        scene_nk = None
        if scene_mean is not None and use_gnn:
            scene_nk = _fold(tile(scene_mean))
        logprob = torch.zeros((N, K), dtype=torch.float32, device=dev)
        beam_iota = torch.arange(K, dtype=torch.int32,
                                 device=dev).expand(N, K)
        prev_parents = beam_iota

        fused = None if save_states else fused_decode(
            cfg, compute_dtype, use_gnn, emb_p, cell_p, h2g_p, state.h,
            state.c, scene_nk)
        twostage = (cfg.beam_select == "twostage" and K <= HW
                    and (not cfg.diverse_beam or cfg.diverse_gamma <= 1.0))
        select_fn = (select_successors_twostage if twostage
                     else select_successors_dense)
        if fused:
            step, h_rows, c_rows = fused
            row0 = torch.arange(N, dtype=torch.int32,
                                device=dev)[:, None] * K
        else:
            # the decoder input is always a one-hot cell: its embedding is
            # a row of the table, gathered by id
            emb_table = cell_embedding_table(emb_p, h, w, act,
                                             compute_dtype)  # [HW, h, w, E]

    all_ids, all_parents, all_logits, all_states = [], [], [], []
    for t in range(T_pred):
        with span("beam.step"):
            if fused:
                with span("beam.fused_step"):
                    # the beam reorder rides the step's reads: row i reads
                    # its parent's state and its id's embedding-table row
                    ids_flat = prev_ids.reshape(-1).contiguous()
                    parents_flat = (row0 + prev_parents).reshape(-1) \
                        .contiguous()
                    h_rows, c_rows, logits_t = step(ids_flat, parents_flat,
                                                    h_rows, c_rows)
            else:
                emb = emb_table[prev_ids.reshape(-1).long()]
                hh = _fold(state.h)
                if use_gnn:
                    hh = hh + gnn_step_auto(hh, scene_nk,
                                            compute_dtype=compute_dtype,
                                            allow_pallas=cfg.allow_pallas)
                out, new_state_f = convlstm_step(
                    cell_p, emb, ConvLSTMState(c=_fold(state.c), h=hh),
                    compute_dtype=compute_dtype)
                logits_t = conv2d(h2g_p, out, compute_dtype=compute_dtype)
            logits_t = logits_t.reshape(N, K, HW)

            with span("beam.select"):
                new_logprob, ids, parents = select_fn(
                    logprob, logits_t, K, t, cfg.diverse_beam,
                    cfg.diverse_gamma)
                if t + 1 <= cfg.fix_num_timestep:
                    new_logprob = torch.zeros_like(new_logprob)

                if pred_length is not None:      # freeze finished samples
                    fin = (t >= pred_length)[:, None]
                    new_logprob = torch.where(fin, logprob, new_logprob)
                    parents = torch.where(fin, beam_iota, parents)
                    ids = torch.where(fin, torch.zeros_like(ids), ids)

            if fused:
                # carry the step's output un-reordered; the next step
                # reads through `parents`. A finished sample's state keeps
                # evolving under identity parents, but everything it emits
                # past pred_length is sliced away by the consumers.
                prev_parents = parents
            else:
                def unfold(x):
                    return x.reshape((N, K) + tuple(x.shape[1:]))
                new_state = ConvLSTMState(
                    c=_gather_beams(unfold(new_state_f.c), parents),
                    h=_gather_beams(unfold(new_state_f.h), parents))
                if pred_length is not None:
                    keep = fin.reshape(N, 1, 1, 1, 1)
                    new_state = ConvLSTMState(
                        c=torch.where(keep, state.c, new_state.c),
                        h=torch.where(keep, state.h, new_state.h))
                state = new_state
                if save_states:
                    all_states.append(out.reshape(N, K, h, w, D))
            logprob = new_logprob
            prev_ids = ids
            all_ids.append(ids)
            all_parents.append(parents)
            all_logits.append(logits_t)
    count("beam.steps", T_pred)

    # backtrace from the final beams through the parent pointers
    with span("beam.backtrace"):
        sel_ids, sel_logits, sel_states = [], [], []
        carry = beam_iota.long()
        for t in reversed(range(T_pred)):
            sel_ids.append(torch.gather(all_ids[t], 1, carry))
            sel_logits.append(_gather_beams(all_logits[t], carry))
            if save_states:
                sel_states.append(_gather_beams(all_states[t], carry))
            carry = torch.gather(all_parents[t], 1, carry).long()
        final_ids = torch.stack(sel_ids[::-1], dim=2)           # [N, K, T]
        final_logits = torch.stack(sel_logits[::-1], dim=2)     # [N, K, T, HW]
        final_states = (torch.stack(sel_states[::-1], dim=2)
                        if save_states else None)
    return BeamOutputs(
        best_logits=final_logits[:, 0].reshape(N, T_pred, h, w, 1),
        logits=final_logits,
        ids=final_ids,
        logprobs=logprob,
        states=final_states,
    )
