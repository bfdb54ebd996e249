"""Plain PyTorch version of the fused privacy layer: the CPU path, the
backward pass, and what the CUDA kernel is checked against. The banked layer
has two: item by item (the CPU forward, bit for bit the unbanked layer) and
one grouped convolution over the items (the backward's, as XLA batches the
vmapped convolution)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _relu_pool_noise(y: torch.Tensor, noise: Optional[torch.Tensor], noise_scale: float,
                     dtype: torch.dtype) -> torch.Tensor:
    """ReLU, the 2x2 max-pool and the noise over a float32 conv output
    [..., H, W, Cout], cast to ``dtype``."""
    *lead, H, W, cout = y.shape
    y = torch.relu(y).reshape(*lead, H // 2, 2, W // 2, 2, cout).amax(dim=(-4, -2))
    if noise_scale > 0.0:
        y = y + noise_scale * noise.float()
    return y.to(dtype)


def privacy_conv_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     noise: Optional[torch.Tensor], *,
                     noise_scale: float = 0.0) -> torch.Tensor:
    """Conv3x3(SAME) + bias + ReLU + MaxPool2x2 + noise, computed in float32
    and cast back to ``x.dtype``. x: [B, H, W, Cin] NHWC; w: [3, 3, Cin,
    Cout] HWIO; b: [Cout]; noise: [B, H/2, W/2, Cout] (read only when
    ``noise_scale > 0``)."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 b.float(), padding=1).permute(0, 2, 3, 1)
    return _relu_pool_noise(y, noise, noise_scale, x.dtype)


def privacy_conv_banked_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            cids, noise: Optional[torch.Tensor], *,
                            noise_scale: float = 0.0) -> torch.Tensor:
    """The banked layer, item by item: x [N, b, H, W, Cin], stacked banks
    w [C, 3, 3, Cin, Cout] and b [C, Cout], ``cids`` [N] (each item's bank),
    noise [N, b, H/2, W/2, Cout] -> [N, b, H/2, W/2, Cout]; item n is
    :func:`privacy_conv_ref` of ``x[n]`` with bank ``cids[n]``."""
    return torch.stack([
        privacy_conv_ref(x[n], w[c], b[c], None if noise is None else noise[n],
                         noise_scale=noise_scale)
        for n, c in enumerate(torch.as_tensor(cids).tolist())])


def privacy_conv_grouped_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                             cids: torch.Tensor, noise: Optional[torch.Tensor], *,
                             noise_scale: float = 0.0) -> torch.Tensor:
    """The banked layer as ONE grouped convolution over the N items, the
    counterpart of XLA's batching of the vmapped ``conv_general_dilated``:
    x [N, b, H, W, Cin] becomes [b, N*Cin, H, W], the gathered banks
    ``w[cids]`` [N*Cout, Cin, 3, 3] with ``groups=N``; then bias, ReLU, the
    pool and the noise as :func:`privacy_conv_ref`, in float32, cast back
    to x's type. ``cids`` is an index tensor on x's device; the gather's
    backward adds each item's gradient into its bank."""
    N, per_item, H, W, cin = x.shape
    cout = w.shape[-1]
    wi, bi = w.float().index_select(0, cids), b.float().index_select(0, cids)
    xg = x.float().permute(1, 0, 4, 2, 3).reshape(per_item, N * cin, H, W)
    wg = wi.permute(0, 4, 3, 1, 2).reshape(N * cout, cin, 3, 3)
    y = F.conv2d(xg, wg, bi.reshape(N * cout), padding=1, groups=N)
    y = y.reshape(per_item, N, cout, H, W).permute(1, 0, 3, 4, 2)
    return _relu_pool_noise(y, noise, noise_scale, x.dtype)
