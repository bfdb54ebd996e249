"""The privacy subsystem at the split cut:

- guard:      ``PrivacyGuard`` (clip → Gaussian mechanism → quantize) built
              from ``DPConfig``
- accountant: the (ε, δ) budget carried in the canonical state
- audit:      the inversion-attack privacy metric and guard noise sweeps
              (``SplitSession.audit_privacy``)

The fused clip+noise kernel lives in ``repro_torch.kernels.dp_release``.
``repro_torch.core.dp`` and ``repro_torch.core.inversion`` are deprecated
shims over this package."""
from repro_torch.privacy.accountant import (
    budget_advance,
    budget_init,
    budget_report,
    composed_epsilon,
    per_client_report,
)
from repro_torch.privacy.audit import (
    guard_noise_sweep,
    inversion_attack_report,
    invert_features,
    privacy_metrics,
)
from repro_torch.privacy.guard import (
    DPConfig,
    PrivacyGuard,
    clip_per_sample,
    dp_release,
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
    "dp_release",
    "gaussian_release",
    "guard_noise_sweep",
    "inversion_attack_report",
    "invert_features",
    "per_client_report",
    "privacy_metrics",
    "quantize_ste",
]
