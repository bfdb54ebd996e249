"""Plain PyTorch version of the fused DP release: the CPU path, the
backward pass, and what the CUDA kernel is checked against."""
from __future__ import annotations

from typing import Optional

import torch


def dp_release_ref(x: torch.Tensor, noise: Optional[torch.Tensor], *,
                   clip_norm: float, sigma: float = 0.0) -> torch.Tensor:
    """Per-sample L2 clip to ``clip_norm`` plus ``sigma``-scaled noise.

    x: [B, ...] (leading dim = samples); noise: standard-normal draws of the
    same shape (ignored when ``sigma == 0`` or ``None``). Computed in
    float32, cast back to ``x.dtype``. The scale is
    ``min(1, clip_norm / sqrt(max(n2, 1e-24)))`` with ``n2 = ||x||^2``: the
    formula of ``repro/kernels/dp_release/ref.py:20-23`` with its ``rsqrt``
    written as a division, as the CUDA kernel computes it. The clamp sits
    under the square root so that an all-zero row has a zero gradient.
    """
    xf = x.float()
    n2 = (xf * xf).reshape(x.shape[0], -1).sum(dim=1)
    scale = torch.clamp(clip_norm / torch.sqrt(torch.clamp(n2, min=1e-24)), max=1.0)
    out = xf * scale.reshape((-1,) + (1,) * (x.dim() - 1))
    if sigma > 0.0 and noise is not None:
        out = out + sigma * noise.float()
    return out.to(x.dtype)
