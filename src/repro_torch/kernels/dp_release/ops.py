"""Wrapper of the fused DP release kernel (``csrc/dp_release.cu``).

:func:`dp_release_forward` launches the CUDA kernel for CUDA tensors and
runs the plain version (``ref.dp_release_ref``) for CPU tensors, the port's
counterpart of the Pallas interpreter. There is no other fallback: a CUDA
tensor the kernel does not take, a failed build or a refused launch raises.
:class:`DPRelease` makes it differentiable the way the JAX ``custom_vjp``
does (``repro/kernels/dp_release/ops.py:27-48``): the forward runs the
kernel, the backward recomputes through the plain version, and the noise
gets no gradient. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dp_release.ref import dp_release_ref

launches = 0


def _launch(x, noise, clip_norm: float, sigma: float) -> torch.Tensor:
    global launches
    if x.dim() < 1:
        raise ValueError("dp_release wants x [B, ...]")
    use_noise = sigma > 0.0
    if use_noise and tuple(noise.shape) != tuple(x.shape):
        raise ValueError(f"noise {tuple(noise.shape)} != x {tuple(x.shape)}")
    for t in [x] + ([noise] if use_noise else []):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("dp_release kernel takes contiguous float32 tensors "
                             f"on one CUDA device; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    rows = x.shape[0]
    feats = math.prod(x.shape[1:])
    lib = build.library("dp_release")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dp_release_launch(
            x.data_ptr(), noise.data_ptr() if use_noise else None,
            out.data_ptr(), rows, feats, float(clip_norm), float(sigma), stream)
    if err:
        raise RuntimeError(f"dp_release kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def dp_release_forward(x: torch.Tensor, noise: Optional[torch.Tensor],
                       clip_norm: float, sigma: float = 0.0) -> torch.Tensor:
    """The fused release: the CUDA kernel for a CUDA ``x``, the plain
    version for a CPU ``x``; any other device raises. ``noise=None`` means
    no perturbation."""
    if noise is None:
        sigma = 0.0
    if x.device.type == "cpu":
        return dp_release_ref(x, noise, clip_norm=clip_norm, sigma=sigma)
    if x.device.type != "cuda":
        raise ValueError(f"dp_release runs on CUDA or the CPU, not {x.device}")
    return _launch(x, noise, clip_norm, sigma)


class DPRelease(torch.autograd.Function):
    """Kernel forward, plain-version backward; the noise gets no gradient."""

    @staticmethod
    def forward(ctx, x, noise, clip_norm, sigma):
        ctx.save_for_backward(x, noise)
        ctx.clip_norm, ctx.sigma = clip_norm, sigma
        return dp_release_forward(x, noise, clip_norm, sigma)

    @staticmethod
    def backward(ctx, g):
        x, noise = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            y = dp_release_ref(xx, noise, clip_norm=ctx.clip_norm, sigma=ctx.sigma)
            (dx,) = torch.autograd.grad(y, (xx,), g)
        return dx, None, None, None


def dp_release_with_noise(x: torch.Tensor, noise: Optional[torch.Tensor] = None, *,
                          clip_norm: float = 1.0, sigma: float = 0.0,
                          use_kernel: bool = False) -> torch.Tensor:
    """The release with pre-drawn standard-normal ``noise`` (``None`` means
    no perturbation). ``use_kernel=False`` runs the plain version on any
    device, as it selects the XLA path in ``repro``."""
    if use_kernel:
        return DPRelease.apply(x, noise, clip_norm, sigma)
    return dp_release_ref(x, noise, clip_norm=clip_norm,
                          sigma=sigma if noise is not None else 0.0)
