"""Wrapper of the fused privacy layer kernel (``csrc/privacy_conv.cu``).

:func:`privacy_conv_forward` launches the CUDA kernel for CUDA tensors and
runs the plain version (``ref.privacy_conv_ref``) for CPU tensors, the
port's counterpart of the Pallas interpreter. There is no other fallback: a
CUDA tensor the kernel does not take, a failed build or a refused launch
raises. :class:`PrivacyConv` makes it differentiable the way the JAX
``custom_vjp`` does (``repro/kernels/privacy_conv/ops.py:28-50``): the
forward runs the kernel, the backward recomputes through the plain version.
``launches`` counts kernel launches, so a run can show that its main path
went through the kernel. :func:`conv_plan` chooses the kernel's variant
from the shapes alone, so every branch can be tested on the CPU and named
in a report.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.privacy_conv.ref import privacy_conv_ref

launches = 0

TILE = (8, 8)          # pooled pixels a block (rows, columns); fixed in the source
CHANNELS_PER_THREAD = 4
MAX_CHANNELS_PER_BLOCK = 16
CIN_VARIANTS = (1,)  # the input widths with a variant of their own; any other is generic


@functools.cache
def conv_plan(B: int, H: int, W: int, cin: int, cout: int, aligned: bool = True) -> dict:
    """How ``csrc/privacy_conv.cu`` runs a shape, a pure function of it,
    worked out once a shape (the dict is shared: copy it to change it):

    - ``cin_variant``: 1 (unrolled, the COVID-CT stage) or 0 (generic,
      staging 16 input channels at a time);
    - ``vec4``: float4 noise reads and output writes, only when
      ``cout % 4 == 0`` and the output and noise are 16-byte aligned
      (``aligned``); else element by element;
    - ``channels_per_block``: output channels a block, 4 a thread, at most 16;
    - ``threads``, ``blocks``: one thread per pooled pixel of a
      ``TILE`` and channel group; blocks over images, tiles and channel
      blocks.
    """
    if min(B, H, W) < 0 or cin < 1 or cout < 1 or H % 2 or W % 2:
        raise ValueError(f"no plan for B={B}, H={H}, W={W}, Cin={cin}, Cout={cout}: "
                         "want Cin, Cout >= 1 and even H, W")
    groups = -(-cout // CHANNELS_PER_THREAD)
    per_block = min(groups, MAX_CHANNELS_PER_BLOCK // CHANNELS_PER_THREAD)
    tiles = -(-(H // 2) // TILE[0]) * -(-(W // 2) // TILE[1])
    return {"cin_variant": cin if cin in CIN_VARIANTS else 0,
            "vec4": cout % 4 == 0 and aligned,
            "tile": TILE,
            "channels_per_block": CHANNELS_PER_THREAD * per_block,
            "threads": TILE[0] * TILE[1] * per_block,
            "blocks": B * tiles * -(-groups // per_block)}


def plan_for(x: torch.Tensor, w: torch.Tensor, noise: Optional[torch.Tensor],
             noise_scale: float) -> dict:
    """The plan :func:`_launch` runs for these tensors: float4 where the
    noise it reads is 16-byte aligned (the output is a fresh allocation,
    which is)."""
    B, H, W, cin = x.shape
    aligned = noise_scale <= 0.0 or noise.data_ptr() % 16 == 0
    return conv_plan(B, H, W, cin, w.shape[-1], aligned)


def _launch(x, w, b, noise, noise_scale: float, plan: Optional[dict] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, with :func:`plan_for`'s plan unless
    ``plan`` is given (to time one variant against another); the source
    refuses a plan that does not fit the shape."""
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
    if plan is None:
        plan = plan_for(x, w, noise, noise_scale)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.privacy_conv_launch_plan(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            noise.data_ptr() if use_noise else None, out.data_ptr(),
            B, H, W, cin, cout, float(noise_scale), plan["cin_variant"],
            plan["channels_per_block"], int(plan["vec4"]), stream)
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
