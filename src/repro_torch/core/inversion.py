"""DEPRECATED shim: the inversion privacy metric lives in
``repro_torch.privacy.audit``, as the reference's ``repro.core.inversion``.

The attack is a session capability: ``SplitSession.audit_privacy()`` sweeps
the guard's noise level and reports MSE/PSNR/NCC per σ. This module
re-exports the old names so existing imports keep working.
"""
from __future__ import annotations

import warnings

warnings.warn(
    "repro_torch.core.inversion is deprecated; use repro_torch.privacy.audit "
    "(or SplitSession.audit_privacy)",
    DeprecationWarning,
    stacklevel=2,
)

from repro_torch.privacy.audit import (  # noqa: E402
    inversion_attack_report,
    invert_features,
    privacy_metrics,
)

__all__ = ["invert_features", "inversion_attack_report", "privacy_metrics"]
