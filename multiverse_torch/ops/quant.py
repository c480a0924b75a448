"""Operands of the int8 decode tiers, the tier dispatch, and the fused
decode step that the beam and greedy decoders share.

Port of ``quantize_decode_weights``, ``quantize_decode_weights_v2`` and
``select_quant`` of ``multiverse_tpu/ops/pallas_decode.py``.
:func:`fused_decode` decides whether a decode runs the fused step and
prepares its operands, once for both decoders.

"int8" and "int8a" (K2, K3): every input of the gate product is
bounded, so the quantisation is static:

* the previous-cell embedding rows come from a precomputed table,
  quantised once per decode with per-channel scales ``s_emb[e]``;
* the recurrent half is h + agg with |h + agg| < 2 (h is tanh-bounded
  and agg a softmax-weighted mean of h), at a fixed scale of 127/2;

and the per-input scales fold into the weights:
gates[c] = sum_k x_q[k] * (s_k * w[k, c]) = t_c * sum_k x_q[k] w_q[k, c],
with ``w_q`` int8 per output channel and ``t_c`` its f32 scale.

"int8_dyn" (K7) splits the gate product into its embedding half (the
same static table scales, folded into ``w_eq`` and ``t_e``) and its
recurrent half (``w_hq`` per output channel with scale ``u_c``), whose
activations the kernel quantises per output row by the row's own 3x3
patch maximum.
"""

from __future__ import annotations

import functools
from typing import Callable, Mapping, NamedTuple, Optional, Tuple

import torch

from multiverse_torch.config import MultiverseConfig
from multiverse_torch.geometry import one_hot_grid
from multiverse_torch.ops.fused_decode import (
    decode_step_gathered,
    decode_step_gathered_q8,
    decode_step_gathered_q8dyn,
)
from multiverse_torch.ops.gate_layout import (  # noqa: F401
    gate_k_order,
    gate_row_order,
    kernel_rows,
    prepare_gate_weights,
)
from multiverse_torch.ops.layers import conv2d, get_activation


class DecodeQuant(NamedTuple):
    """The int8 operands of one decode (``emb_q``, ``w_q``, ``t_c`` as
    the JAX package's triple, in its layouts)."""

    emb_q: torch.Tensor    # [HW, H, W, E] int8
    w_q: torch.Tensor      # [9*Cin, 4D] int8
    t_c: torch.Tensor      # [1, 4D] f32 per-output-channel scales
    # the gate launch's B operand (ops/gate_layout.py): w_q with its rows
    # in gate_k_order(E, D), in kernel_rows' layout [4D, 9*Cin]
    w_qt: torch.Tensor


class DecodeQuantDyn(NamedTuple):
    """The int8 operands of one "int8_dyn" decode (the JAX package's
    5-tuple of ``quantize_decode_weights_v2``, in its layouts)."""

    emb_q: torch.Tensor    # [HW, H, W, E] int8, as DecodeQuant's
    w_eq: torch.Tensor     # [9*E, 4D] int8, shift-major embedding rows
    t_e: torch.Tensor      # [1, 4D] f32
    w_hq: torch.Tensor     # [9*D, 4D] int8, shift-major recurrent rows
    u_c: torch.Tensor      # [1, 4D] f32
    # w_eq and w_hq transposed to [4D, 9*E] and [4D, 9*D], contiguous,
    # rows in the order of gate_row_order(D) (as DecodeQuant.w_qt)
    w_eqt: torch.Tensor
    w_hqt: torch.Tensor


def _quantize_table(emb_table: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s_emb [E] per-channel scales, emb_q int8) of an embedding
    table."""
    emb = emb_table.float()
    s_emb = torch.clamp_min(torch.amax(emb.abs(), dim=(0, 1, 2)),
                            1e-6) / 127.0
    emb_q = torch.clamp(torch.round(emb / s_emb), -127, 127).to(torch.int8)
    return s_emb, emb_q


def _quantize_columns(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 w, its f32 per-column scale): w = scale * w_q."""
    scale = torch.clamp_min(torch.amax(w.abs(), dim=0), 1e-12) / 127.0
    return torch.round(w / scale[None, :]).to(torch.int8), scale


def quantize_decode_weights(cell_params: Mapping[str, torch.Tensor],
                            emb_table: torch.Tensor) -> DecodeQuant:
    """Precompute the int8 decode operands (once per decode: it holds a
    reduction over the whole table and the weights).

    ``cell_params["kernel"]`` is the [3, 3, Cin, 4D] gate kernel,
    ``emb_table`` the [HW, H, W, E] embedding of every cell."""
    E = emb_table.shape[-1]
    kern = cell_params["kernel"].float()
    Cin, D4 = kern.shape[2], kern.shape[3]
    kern = kern.reshape(9 * Cin, D4)

    s_emb, emb_q = _quantize_table(emb_table)
    s_h = torch.full((Cin - E,), 2.0 / 127.0, dtype=torch.float32,
                     device=kern.device)
    s_k9 = torch.cat([s_emb, s_h]).repeat(9)                   # [9*Cin]
    w_q, t_c = _quantize_columns(kern * s_k9[:, None])
    return DecodeQuant(emb_q=emb_q, w_q=w_q, t_c=t_c.reshape(1, D4),
                       w_qt=kernel_rows(
                           w_q[gate_k_order(E, Cin - E).to(w_q.device)]))


def quantize_decode_weights_v2(cell_params: Mapping[str, torch.Tensor],
                               emb_table: torch.Tensor) -> DecodeQuantDyn:
    """The "int8_dyn" operands: the gate kernel split into its embedding
    rows (scaled by the table's static ``s_emb``) and its recurrent rows,
    each quantised per output column. Both are shift-major slices of
    ``kernel.reshape(9, Cin, 4D)``, so ``w_eq`` is not a slice of
    :func:`quantize_decode_weights`' ``w_q``."""
    E = emb_table.shape[-1]
    kern = cell_params["kernel"].float()
    Cin, D4 = kern.shape[2], kern.shape[3]
    D = Cin - E
    s_emb, emb_q = _quantize_table(emb_table)
    k9 = kern.reshape(9, Cin, D4)
    w_eq, t_e = _quantize_columns(
        (k9[:, :E, :] * s_emb[None, :, None]).reshape(9 * E, D4))
    w_hq, u_c = _quantize_columns(k9[:, E:, :].reshape(9 * D, D4))
    return DecodeQuantDyn(emb_q=emb_q, w_eq=w_eq, t_e=t_e.reshape(1, D4),
                          w_hq=w_hq, u_c=u_c.reshape(1, D4),
                          w_eqt=kernel_rows(w_eq),
                          w_hqt=kernel_rows(w_hq))


def select_quant(decode_quant: str, cell_params: Mapping[str, torch.Tensor],
                 emb_table: torch.Tensor) -> Tuple[NamedTuple, Callable]:
    """(quantised operands, step function) for a ``cfg.decode_quant``
    value (bound into a step by :func:`make_decode_step`). "int8" steps
    through K2, "int8a" through K3
    (:func:`~multiverse_torch.ops.fused_decode.decode_step_gathered_q8`
    with ``attn_q8``), "int8_dyn" through K7
    (:func:`~multiverse_torch.ops.fused_decode.decode_step_gathered_q8dyn`
    on :func:`quantize_decode_weights_v2`'s operands)."""
    if decode_quant == "int8_dyn":
        return (quantize_decode_weights_v2(cell_params, emb_table),
                decode_step_gathered_q8dyn)
    if decode_quant not in ("int8", "int8a"):
        raise ValueError(f"no int8 decode mode named {decode_quant!r}")
    quant = quantize_decode_weights(cell_params, emb_table)
    return quant, functools.partial(decode_step_gathered_q8,
                                    attn_q8=decode_quant == "int8a")


def make_decode_step(decode_quant: str,
                     cell_params: Mapping[str, torch.Tensor],
                     h2g_params: Mapping[str, torch.Tensor],
                     emb_table: torch.Tensor,
                     scene: Optional[torch.Tensor]) -> Callable:
    """The fused decode step of a tier on the grid of ``emb_table``
    [HW, H, W, E], its operands prepared once per decode:
    ``step(prev_ids, parent_rows, h, c) -> (h', c', logits)``. Every
    tier binds the f32 gate bias, the readout's [D, 9] bf16 weights and
    the scene rows ``scene`` [M, C] (or None). "none" binds K1's bf16
    gate weights, their kernel layout (:func:`prepare_gate_weights`) and
    the embedding rows to :func:`decode_step_gathered`; "int8", "int8a"
    and "int8_dyn" bind :func:`select_quant`'s operands to K2, K3 or
    K7."""
    bf = torch.bfloat16
    HW, H, W = emb_table.shape[:3]
    D = h2g_params["w"].shape[-2]
    cell_b = cell_params["bias"].float().contiguous()
    h2g_w = h2g_params["w"].to(bf).reshape(9, D).t().contiguous()  # [D, 9]
    if decode_quant == "none":
        D4 = cell_params["kernel"].shape[-1]
        cell_w = cell_params["kernel"].to(bf).reshape(-1, D4).contiguous()
        emb_rows = emb_table.to(bf).reshape(HW, HW, -1).contiguous()
        weights = prepare_gate_weights(cell_w, emb_rows.shape[-1])

        def step(prev_ids, parent_rows, h, c):
            return decode_step_gathered(cell_w, cell_b, h2g_w, prev_ids,
                                        parent_rows, emb_rows, h, c, scene,
                                        H, W, weights=weights)
        return step
    quant, q8_step = select_quant(decode_quant, cell_params, emb_table)

    def step(prev_ids, parent_rows, h, c):
        return q8_step(quant, cell_b, h2g_w, prev_ids, parent_rows, h, c,
                       scene, H, W)
    return step


def cell_embedding_table(emb_params: Mapping[str, torch.Tensor], H: int,
                         W: int, activation: Callable,
                         compute_dtype: Optional[torch.dtype]
                         ) -> torch.Tensor:
    """The decoder's input embedding of every one-hot cell, [HW, H, W,
    E]: one conv over the HW basis maps, gathered by cell id."""
    basis = one_hot_grid(torch.arange(H * W, device=emb_params["w"].device),
                         H, W)
    return conv2d(emb_params, basis, activation=activation,
                  compute_dtype=compute_dtype)


def _rows(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[..., C] -> the fused step's rows [M, C], bf16 and contiguous."""
    return None if x is None else \
        x.to(torch.bfloat16).reshape(-1, x.shape[-1]).contiguous()


class FusedDecode(NamedTuple):
    """The fused decode step of one decode and its initial state rows."""

    step: Callable       # (prev_ids, parent_rows, h, c) -> (h', c', logits)
    h: torch.Tensor      # [M, D] bf16
    c: torch.Tensor      # [M, D] bf16


def fused_decode(cfg: MultiverseConfig, compute_dtype: Optional[torch.dtype],
                 use_gnn: bool, emb_params: Mapping[str, torch.Tensor],
                 cell_params: Mapping[str, torch.Tensor],
                 h2g_params: Mapping[str, torch.Tensor], h: torch.Tensor,
                 c: torch.Tensor, scene: Optional[torch.Tensor]
                 ) -> Optional[FusedDecode]:
    """The fused decode step of a class decode from the state ``h``, ``c``
    [..., H, W, D] and ``scene`` [..., H, W, C] (or None), or None where
    the decoder composes its step (GNN, cell, readout). The beam and
    greedy decoders share these conditions, each adding its own: bf16
    compute, ``cfg.allow_pallas``, the GNN on, and a one-channel class
    decoder (a one-hot input, one logit a cell). The step
    (:func:`make_decode_step` of ``cfg.decode_quant``'s tier) and the
    state rows are prepared once per decode."""
    if not (compute_dtype == torch.bfloat16 and cfg.allow_pallas and use_gnn
            and emb_params["w"].shape[-2] == 1
            and h2g_params["w"].shape[-1] == 1):
        return None
    H, W = h.shape[-3:-1]
    emb_table = cell_embedding_table(emb_params, H, W,
                                     get_activation(cfg.activation),
                                     compute_dtype)
    step = make_decode_step(cfg.decode_quant, cell_params, h2g_params,
                            emb_table, _rows(scene))
    return FusedDecode(step, _rows(h), _rows(c))
