"""Multiverse model and diverse beam search (PyTorch)."""

from multiverse_torch.models.beam_search import (  # noqa: F401
    BeamOutputs,
    diverse_beam_search,
)
from multiverse_torch.models.multiverse import (  # noqa: F401
    SOFT_GRID_KERNELS,
    Batch,
    ForwardOutputs,
    Multiverse,
    compute_loss,
    greedy_decode,
    init_params,
    model_forward,
    scene_encode,
    soft_grid_labels,
)
