"""Private split-inference serving: guarded per-hospital releases ->
``FeatureQueue`` -> continuously-batched trunk forward, driven by seeded
deterministic arrival traces. Port of ``repro.serving``."""
from repro_torch.serving.server import (
    ServeReport,
    SplitInferenceServer,
    make_server_batch_forward,
)
from repro_torch.serving.traces import (
    TRACE_SHAPES,
    ServeRequest,
    Trace,
    bursty_trace,
    make_trace,
    poisson_trace,
)

__all__ = [
    "ServeReport",
    "ServeRequest",
    "SplitInferenceServer",
    "Trace",
    "TRACE_SHAPES",
    "bursty_trace",
    "make_server_batch_forward",
    "make_trace",
    "poisson_trace",
]
