"""K1's share of its roofline in the decode window: the frozen least
time of one fused bf16 decode step at the window's rows (batch x K beam
rows), times the steps the program's counter saw, over the profiler's
device time of K1's three launches (attention, gate, readout)."""

from mvbench.arith.roofline import decode_step_bound

K1_KERNELS = ("gnn_attention_kernel", "gate_lstm_wgmma_kernel",
              "class_readout_kernel")


def read(facts, trace, ctx):
    cfg = facts["cfg"]
    device_s = trace.kernel_seconds(*K1_KERNELS)
    if device_s <= 0 or not facts["launches"] or cfg.decode_quant != "none":
        return None
    h, w = cfg.scene_grids[cfg.active_scales[0]]
    nk = facts["batch"] * cfg.beam_size
    b = decode_step_bound(nk, h, w, cfg.dec_hidden_size, cfg.emb_size,
                          cfg.scene_conv_dim, min(nk, h * w))
    return 100.0 * facts["launches"] * b["bound_ms"] * 1e-3 / device_s
