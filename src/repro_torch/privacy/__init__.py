"""The privacy subsystem at the split cut: ``PrivacyGuard`` (clip →
Gaussian mechanism → quantize) built from ``DPConfig``, and the (ε, δ)
accountant. The fused clip+noise kernel lives in
``repro_torch.kernels.dp_release``."""
from repro_torch.privacy.accountant import (
    budget_advance,
    budget_init,
    budget_report,
    composed_epsilon,
    per_client_report,
)
from repro_torch.privacy.guard import (
    DPConfig,
    PrivacyGuard,
    clip_per_sample,
    gaussian_release,
    quantize_ste,
)

__all__ = [
    "DPConfig",
    "PrivacyGuard",
    "budget_advance",
    "budget_init",
    "budget_report",
    "clip_per_sample",
    "composed_epsilon",
    "gaussian_release",
    "per_client_report",
    "quantize_ste",
]
