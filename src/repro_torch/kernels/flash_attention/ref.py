"""Plain PyTorch version of flash attention: naive full-matrix attention,
as ``repro/kernels/flash_attention/ref.py``. The CPU path, and what the
CUDA kernel is checked against."""
from __future__ import annotations

import torch

NEG_INF = -1e30  # finite, as the TPU kernel's sentinel: exp(NEG_INF - m) is 0, never NaN


def attention_mask(S: int, *, causal: bool, window: int, device=None) -> torch.Tensor:
    """``[S, S]`` bool, True where query ``q`` may attend to key ``k``:
    ``k <= q`` when causal, and ``|q - k| < window`` when ``window > 0``."""
    pos = torch.arange(S, device=device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos).abs() < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v: ``[BH, S, hd]`` -> ``[BH, S, hd]`` in q's dtype. The scale
    ``1/sqrt(hd)`` is applied to q in float32, the scores and the softmax are
    float32, and masked scores are ``NEG_INF``."""
    S = q.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqh,bkh->bqk", q.float() * scale, k.float())
    mask = attention_mask(S, causal=causal, window=window, device=q.device)
    s = torch.where(mask[None], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)
