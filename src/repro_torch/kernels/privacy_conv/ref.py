"""Plain PyTorch version of the fused privacy layer: the CPU path, the
backward pass, and what the CUDA kernel is checked against."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def privacy_conv_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     noise: Optional[torch.Tensor], *,
                     noise_scale: float = 0.0) -> torch.Tensor:
    """Conv3x3(SAME) + bias + ReLU + MaxPool2x2 + noise, computed in float32
    and cast back to ``x.dtype``. x: [B, H, W, Cin] NHWC; w: [3, 3, Cin,
    Cout] HWIO; b: [Cout]; noise: [B, H/2, W/2, Cout] (read only when
    ``noise_scale > 0``)."""
    B, H, W, _ = x.shape
    cout = w.shape[-1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 b.float(), padding=1).permute(0, 2, 3, 1)
    y = torch.relu(y)
    y = y.reshape(B, H // 2, 2, W // 2, 2, cout).amax(dim=(2, 4))
    if noise_scale > 0.0:
        y = y + noise_scale * noise.float()
    return y.to(x.dtype)
