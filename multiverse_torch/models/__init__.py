"""Multiverse model and diverse beam search (PyTorch)."""

from multiverse_torch.models.beam_search import (  # noqa: F401
    BeamOutputs,
    diverse_beam_search,
)
from multiverse_torch.models.multiverse import (  # noqa: F401
    Batch,
    Multiverse,
    greedy_decode,
    init_params,
    scene_encode,
)
