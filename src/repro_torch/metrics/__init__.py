"""The losses and metrics of the paper's models, as ``repro.metrics``."""
from repro_torch.metrics.losses import (
    bce_with_logits,
    binary_accuracy,
    ce_with_logits,
    mse,
    msle,
    multiclass_accuracy,
    rmsle,
    smape,
)
