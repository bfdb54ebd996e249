"""Shared building blocks of the paper's models and the LM stack, as
``repro.models.layers``. The norms, RoPE and the cross entropy compute in
float32 and cast back to the input's dtype, as the reference does."""
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


def embed_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal draws from ``generator`` times 0.02, as
    ``repro.models.layers.embed_init``."""
    draw = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                       device=generator.device)
    return (draw * 0.02).to(dtype)


def add_privacy_noise(x: torch.Tensor, scale: float,
                      noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The paper's §III-A Gaussian feature perturbation with pre-drawn
    standard-normal ``noise`` of ``x``'s shape (``None`` or ``scale <= 0``:
    the identity). See ``repro_torch.privacy.guard.gaussian_release``."""
    from repro_torch.privacy.guard import gaussian_release

    return gaussian_release(x, scale, noise)


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)  # jnp.var: biased
    return ((xf - mu) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # theta as a Python scalar: no host-to-device copy (a synchronising one
    # a layer held the card's decode to the host's pace)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]. Rotates the
    two HALVES of the head (not interleaved pairs), angles in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [hd/2]
    angles = positions.float()[..., None] * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ------------------------------------------------------------------ SwiGLU
def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype) -> dict:
    return {
        "w_gate": dense_init(generator, d_model, (d_model, d_ff), dtype),
        "w_up": dense_init(generator, d_model, (d_model, d_ff), dtype),
        "w_down": dense_init(generator, d_ff, (d_ff, d_model), dtype),
    }


def swiglu(params: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """``(silu(x W_gate) * x W_up) W_down``. ``tp`` (a
    ``sharding.tensor_parallel.LMParallel`` whose model axis shards
    ``d_ff``): ``w_gate``/``w_up`` column-parallel, ``w_down`` row-parallel,
    one all-reduce."""
    if tp is not None:
        h = torch.nn.functional.silu(tp.col(x, params["w_gate"])) * tp.col(x, params["w_up"])
        return tp.row(h, params["w_down"])
    h = torch.nn.functional.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ------------------------------------------------------------------ losses
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [..., V] (any float dtype), labels int [...]: the float32
    mean negative log-likelihood, over ``mask`` (its sum floored at 1)
    where one is given."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
