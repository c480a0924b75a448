"""The weight layout of the gate launch (``csrc/gate_wgmma.cuh``), made
once per decode.

The launch reads its B operand by TMA as K-major [4D, K] weights (each
gate column's contraction contiguous, as wgmma takes it), int8 for the
int8 tiers (:mod:`multiverse_torch.ops.quant`) and bf16 for K1, K8, K9
and K6 (:func:`prepare_gate_weights`). Its rows are the gate columns in
:func:`gate_row_order`; its K columns are the contraction rows in
:func:`gate_k_order`, the embedding taps before the recurrent ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def gate_row_order(D: int) -> torch.Tensor:
    """The gate launch's order of the 4D gate columns: its row
    32 * (d // 8) + 8 * u + d % 8 is column u * D + d (gate u of channel
    d, u = i, g, f, o), so the four gates of each 8-channel chunk are 32
    consecutive rows. A block's 4 * DT rows then hold all four gates of
    its DT channels, and a wgmma accumulator's 8-column chunks 4c..4c+3
    hold gates i, g, f, o of the same 8 channels. Kernel weights are
    ``w.t()[gate_row_order(D)]``; ``argsort`` of it maps them back."""
    n = torch.arange(4 * D)
    return (n // 8) % 4 * D + n // 32 * 8 + n % 8


def gate_k_order(E: int, D: int) -> torch.Tensor:
    """The gate launch's order of the 9 * (E + D) contraction rows of a
    shift-major [9, E + D] gate kernel: the embedding channels of the
    nine taps, then the recurrent channels of the nine taps, so that no
    stage mixes the two sources and the recurrent stages can be boxes of
    h2."""
    k = torch.arange(9 * (E + D)).reshape(9, E + D)
    return torch.cat([k[:, :E].reshape(-1), k[:, E:].reshape(-1)])


def kernel_rows(w: torch.Tensor) -> torch.Tensor:
    """[K, 4D] weights in the gate launch's layout: K-major [4D, K], rows
    in gate_row_order, contiguous."""
    return w.t()[gate_row_order(w.shape[1] // 4).to(w.device)].contiguous()


class GateWeights(NamedTuple):
    """The bf16 gate launch's B operand, prepared once per decode: the
    [9*(E+D), 4D] gate kernel with its rows in ``gate_k_order(E, D)``,
    in :func:`kernel_rows`' layout."""

    w_t: torch.Tensor      # [4D, 9*(E+D)] bf16
    E: int


def prepare_gate_weights(cell_w: torch.Tensor, E: int) -> GateWeights:
    """The bf16 gate launch's weights from a shift-major gate kernel
    ``cell_w`` [9*(E+D), 4D] whose first E channels of each tap are the
    embedding's (K1, K8), x's (K6) or none (K9's h-only kernel, E = 0)."""
    D = cell_w.shape[1] // 4
    w = cell_w.to(torch.bfloat16)
    return GateWeights(kernel_rows(w[gate_k_order(E, D).to(w.device)]), E)
