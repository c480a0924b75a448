"""Online prediction serving: the dynamic-batching engine and its HTTP
front ends (the port's own copies of ``multiverse_tpu.serving``)."""

from multiverse_torch.serving.engine import (  # noqa: F401
    EngineOverloadedError,
    PredictionResult,
    ServingEngine,
)
