"""Scoring of the port's output pickles: multi-future minADE/minFDE and
grid NLL, and the Stanford-Drone rescaled ADE/FDE (numpy only)."""

from multiverse_torch.eval.multifuture import (  # noqa: F401
    evaluate_multifuture_nll,
    evaluate_multifuture_trajs,
)
from multiverse_torch.eval.sdd import evaluate_sdd  # noqa: F401
