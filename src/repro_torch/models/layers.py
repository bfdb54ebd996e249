"""Building blocks of the paper's models."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def dense_init(generator: torch.Generator, fan_in: int, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LeCun-normal init, as ``repro.models.layers.dense_init``: standard
    normal draws from ``generator`` (on its device) times ``1/sqrt(fan_in)``."""
    scale = 1.0 / math.sqrt(fan_in)
    draw = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                       device=generator.device)
    return (draw * scale).to(dtype)


def add_privacy_noise(x: torch.Tensor, scale: float,
                      noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The paper's §III-A Gaussian feature perturbation with pre-drawn
    standard-normal ``noise`` of ``x``'s shape (``None`` or ``scale <= 0``:
    the identity). See ``repro_torch.privacy.guard.gaussian_release``."""
    from repro_torch.privacy.guard import gaussian_release

    return gaussian_release(x, scale, noise)
