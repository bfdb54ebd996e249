"""Wrapper of the fused privacy layer kernel (``csrc/privacy_conv.cu``).

:func:`privacy_conv_forward` launches the CUDA kernel for CUDA tensors and
runs the plain version (``ref.privacy_conv_ref``) for CPU tensors, the
port's counterpart of the Pallas interpreter. There is no other fallback: a
CUDA tensor the kernel does not take, a failed build or a refused launch
raises. :class:`PrivacyConv` makes it differentiable the way the JAX
``custom_vjp`` does (``repro/kernels/privacy_conv/ops.py:28-50``): the
forward runs the kernel, the backward recomputes through the plain version.
``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.privacy_conv.ref import privacy_conv_ref

launches = 0


def _launch(x, w, b, noise, noise_scale: float) -> torch.Tensor:
    global launches
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError(f"want x [B,H,W,Cin], w [3,3,Cin,Cout], b [Cout]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    if H % 2 or W % 2:
        raise ValueError(f"H and W must be even, got {H}x{W}")
    if tuple(w.shape) != (3, 3, cin, cout) or tuple(b.shape) != (cout,):
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not match "
                         f"Cin={cin}")
    out_shape = (B, H // 2, W // 2, cout)
    use_noise = noise_scale > 0.0
    tensors = [x, w, b] + ([noise] if use_noise else [])
    if use_noise and tuple(noise.shape) != out_shape:
        raise ValueError(f"noise {tuple(noise.shape)} != output {out_shape}")
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("privacy_conv kernel takes contiguous float32 tensors "
                             f"on one CUDA device; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    lib = build.library("privacy_conv")
    out = torch.empty(out_shape, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.privacy_conv_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            noise.data_ptr() if use_noise else None, out.data_ptr(),
            B, H, W, cin, cout, float(noise_scale), stream)
    if err:
        raise RuntimeError(f"privacy_conv kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def privacy_conv_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         noise: Optional[torch.Tensor],
                         noise_scale: float = 0.0) -> torch.Tensor:
    """The fused forward: the CUDA kernel for a CUDA ``x``, the plain
    version for a CPU ``x``; any other device raises."""
    if x.device.type == "cpu":
        return privacy_conv_ref(x, w, b, noise, noise_scale=noise_scale)
    if x.device.type != "cuda":
        raise ValueError(f"privacy_conv runs on CUDA or the CPU, not {x.device}")
    return _launch(x, w, b, noise, noise_scale)


class PrivacyConv(torch.autograd.Function):
    """Kernel forward, plain-version backward; the noise gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, b, noise, noise_scale):
        ctx.save_for_backward(x, w, b, noise)
        ctx.noise_scale = noise_scale
        return privacy_conv_forward(x, w, b, noise, noise_scale)

    @staticmethod
    def backward(ctx, g):
        x, w, b, noise = ctx.saved_tensors
        with torch.enable_grad():
            xx, ww, bb = (t.detach().requires_grad_() for t in (x, w, b))
            y = privacy_conv_ref(xx, ww, bb, noise, noise_scale=ctx.noise_scale)
            dx, dw, db = torch.autograd.grad(y, (xx, ww, bb), g)
        return dx, dw, db, None, None


def privacy_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 noise: Optional[torch.Tensor] = None, *,
                 noise_scale: float = 0.0, use_kernel: bool = True) -> torch.Tensor:
    """Fused Conv3x3+ReLU+MaxPool2x2+noise (the paper's privacy layer).

    x: [B, H, W, Cin]; w: [3, 3, Cin, Cout]; b: [Cout]; ``noise``:
    standard-normal draws [B, H/2, W/2, Cout], required when
    ``noise_scale > 0``. ``use_kernel=False`` runs the plain version on any
    device, as it selects the XLA path in ``repro``.
    """
    if noise_scale > 0.0 and noise is None:
        raise ValueError("noise_scale > 0 requires noise")
    if use_kernel:
        return PrivacyConv.apply(x, w, b, noise, noise_scale)
    return privacy_conv_ref(x, w, b, noise, noise_scale=noise_scale)
