"""Published peaks of one NVIDIA H100 and the least times of the
kernels, frozen for the benchmark.

Copied from ``chip_smoke.py`` (``PEAK_OPS``, ``HBM_BYTES_S``,
``roofline``, ``bound``, ``gnn_bounds``) as it stood when the benchmark
was defined; ``bound`` and ``gnn_bounds`` take shapes here instead of
the operand tensors. Peaks: NVIDIA's data sheet for the SXM part, dense
rates without sparsity, at its 700 W limit.
"""

from __future__ import annotations

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_S = 3.35e12


def roofline(nbytes: float, ops: dict) -> dict:
    """Least time for work that moves ``nbytes`` and does ``ops``
    (operations by type): the larger of the bytes over the HBM rate and
    the operations over the tensor-core peak of their type."""
    ops_s = sum(n / PEAK_OPS[t] for t, n in ops.items())
    bytes_s = nbytes / HBM_BYTES_S
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def decode_step_bound(NK: int, H: int, W: int, D: int, E: int, C: int,
                      n_ids: int, gate_type: str = "bf16",
                      attn_type: str = "bf16") -> dict:
    """Least time of one fused decode step (K1 in bf16, K2/K3 with an
    int8 gate, K3 with int8 attention too) over ``NK`` beam rows whose
    previous ids take ``n_ids`` distinct values: each input read once,
    each output written once (h, c, scene, the embedding-table rows
    these ids need, ids and parents; h', c', logits), and the gate
    product over 9(E + D), the nine-neighbour attention (edges and
    aggregation) and the readout."""
    HW, M = H * W, NK * H * W
    w_bytes = 1 if gate_type == "int8" else 2
    gate_k = 9 * (E + D)
    emb_bytes = n_ids * HW * E * w_bytes + NK * 8
    nbytes = (2 * M * D * 2 + M * C * 2 + emb_bytes
              + gate_k * 4 * D * w_bytes + 4 * D * 4
              + D * 9 * 2
              + 2 * M * D * 2 + M * 4)
    work = {"bf16": 2.0 * M * 9 * D, "int8": 0.0}
    work[gate_type] += 2.0 * M * gate_k * 4 * D
    work[attn_type] += 2.0 * M * 9 * ((D + C) + D)
    return roofline(nbytes, work)


def gnn_bounds(NHW: int, Dn: int, Ds: int, H: int, W: int) -> dict:
    """Least times of K4 and K5 over ``NHW`` node rows of width ``Dn``
    and state rows of width ``Ds``: bytes (each input read once, each
    output written once) over the HBM rate against the banded products'
    operations (only the in-grid neighbour pairs) over the bf16 peak."""
    pairs = NHW // (H * W) * (3 * H - 2) * (3 * W - 2)
    out = {}
    for name, nbytes, ops in (
            ("K4", NHW * (Dn * 2 + Ds * 2 + Ds * 4),
             2.0 * pairs * (Dn + Ds)),
            ("K5", NHW * (Dn * 2 + Ds * 2 + Ds * 4 + Dn * 2 + Ds * 2),
             2.0 * pairs * 2 * (Dn + Ds))):
        bytes_s, ops_s = nbytes / HBM_BYTES_S, ops / PEAK_OPS["bf16"]
        out[name] = {"bound_ms": max(bytes_s, ops_s) * 1e3,
                     "bound_by": "operations" if ops_s >= bytes_s
                     else "bytes", "bytes": nbytes}
    return out
