"""The whole decode's share of the card's bf16 peak: the frozen
``beam_decode_flops`` and ``scene_cnn_flops`` of every batch the window
decoded (batch trajectories, T steps, 8 scene maps each), over the
window's time and 989 TFLOP/s."""

from mvbench.arith.flops import beam_decode_flops, scene_cnn_flops
from mvbench.arith.roofline import PEAK_OPS


def read(facts, trace, ctx):
    cfg = facts["cfg"]
    if not facts.get("batches") or cfg.decode_quant != "none":
        return None
    n = facts["batch"]
    per = (beam_decode_flops(cfg, n, facts["t_pred"])
           + scene_cnn_flops(cfg, n * cfg.obs_len))
    return (100.0 * per * facts["batches"] / facts["elapsed_s"]
            / PEAK_OPS["bf16"])
