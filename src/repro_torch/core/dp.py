"""DEPRECATED shim: the DP release lives in ``repro_torch.privacy``, as the
reference's ``repro.core.dp``.

The clip + Gaussian-mechanism release is the job of
``repro_torch.privacy.PrivacyGuard`` (applied at the cut by every engine),
the composition bookkeeping lives in ``repro_torch.privacy.accountant``,
and the fused clip+noise kernel in ``repro_torch.kernels.dp_release``. This
module re-exports the old names so existing imports keep working.
"""
from __future__ import annotations

import warnings

warnings.warn(
    "repro_torch.core.dp is deprecated; use repro_torch.privacy (PrivacyGuard, "
    "DPConfig, accountant) instead",
    DeprecationWarning,
    stacklevel=2,
)

from repro_torch.privacy.accountant import composed_epsilon  # noqa: E402
from repro_torch.privacy.guard import DPConfig, clip_per_sample, dp_release  # noqa: E402

__all__ = ["DPConfig", "clip_per_sample", "composed_epsilon", "dp_release"]
