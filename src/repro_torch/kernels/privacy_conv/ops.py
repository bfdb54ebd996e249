"""Wrapper of the fused privacy layer kernel (``csrc/privacy_conv.cu``).

:func:`privacy_conv_forward` launches the CUDA kernel for CUDA tensors and
runs the plain version (``ref.privacy_conv_ref``) for CPU tensors, the
port's counterpart of the Pallas interpreter. There is no other fallback: a
CUDA tensor the kernel does not take, a failed build or a refused launch
raises. :class:`PrivacyConv` makes it differentiable the way the JAX
``custom_vjp`` does (``repro/kernels/privacy_conv/ops.py:28-50``): the
forward runs the kernel, the backward recomputes through the plain version.
``launches`` counts kernel launches and ``plans`` the calls of each plan
(keyed by its sorted items), so a run can show that its main path went
through the kernel and with which variant; client threads launch at once,
so :func:`count` updates both under a lock. :func:`conv_plan` chooses the
kernel's variant from the shapes alone, so every branch can be tested on
the CPU and named in a report. The unbanked kernel takes float32, bfloat16
or float16 (:data:`DTYPES`; x, w, b and the noise of one type), sums in
float32 and stores the output in x's type, as the TPU kernel does.

:func:`privacy_conv_banked` is the banked layer: N items of b images, each
with its own bank of stacked banks, in one launch of the same kernel (the
counterpart of ``jax.vmap`` over the Pallas call, which is one call with one
more grid axis), bit for bit what N unbanked launches give; its CPU path is
``ref.privacy_conv_banked_ref``, item by item. :class:`PrivacyConvBanked`
makes it differentiable as the vmapped ``custom_vjp``: the backward
recomputes through ``ref.privacy_conv_grouped_ref``, one grouped
convolution over the items, once for the whole bank. The fused engine's
client stage runs it once a step over its clients (``models/cnn.py``
``fleet_client_forward``); :func:`privacy_conv_banked_forward` is the
queue fleet's forward-only view of it. It takes float32 alone.
"""
from __future__ import annotations

import collections
import functools
import threading
from typing import Optional

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.privacy_conv.ref import (
    privacy_conv_banked_ref,
    privacy_conv_grouped_ref,
    privacy_conv_ref,
)

launches = 0
plans: collections.Counter = collections.Counter()
_count_lock = threading.Lock()

TILE = (8, 8)          # pooled pixels a block (rows, columns); fixed in the source
CHANNELS_PER_THREAD = 4
MAX_CHANNELS_PER_BLOCK = 16
CIN_VARIANTS = (1,)  # the input widths with a variant of their own; any other is generic
# the element types the kernel takes, by the code its typed entry point reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def conv_plan(B: int, H: int, W: int, cin: int, cout: int, aligned: bool = True,
              dtype: str = "float32") -> dict:
    """How ``csrc/privacy_conv.cu`` runs a shape of element type ``dtype``
    (``"float32"``, ``"bfloat16"``, ``"float16"``), a pure function of them,
    worked out once a shape (the dict is shared: copy it to change it):

    - ``cin_variant``: 1 (unrolled, the COVID-CT stage) or 0 (generic,
      staging 16 input channels at a time);
    - ``vec4``: float4 noise reads and output writes, only for float32
      where ``cout % 4 == 0`` and the output and noise are 16-byte aligned
      (``aligned``); else element by element. A 2-byte type always reads
      and writes element by element; its variant, tile and channel blocks
      are float32's (they count elements);
    - ``dtype``: the element type, as given;
    - ``channels_per_block``: output channels a block, 4 a thread, at most 16;
    - ``threads``, ``blocks``: one thread per pooled pixel of a
      ``TILE`` and channel group; blocks over images, tiles and channel
      blocks.
    """
    if min(B, H, W) < 0 or cin < 1 or cout < 1 or H % 2 or W % 2:
        raise ValueError(f"no plan for B={B}, H={H}, W={W}, Cin={cin}, Cout={cout}: "
                         "want Cin, Cout >= 1 and even H, W")
    if dtype not in ("float32", "bfloat16", "float16"):
        raise ValueError(f"no plan for dtype {dtype!r}")
    groups = -(-cout // CHANNELS_PER_THREAD)
    per_block = min(groups, MAX_CHANNELS_PER_BLOCK // CHANNELS_PER_THREAD)
    tiles = -(-(H // 2) // TILE[0]) * -(-(W // 2) // TILE[1])
    return {"cin_variant": cin if cin in CIN_VARIANTS else 0,
            "vec4": cout % 4 == 0 and aligned and dtype == "float32",
            "tile": TILE,
            "channels_per_block": CHANNELS_PER_THREAD * per_block,
            "threads": TILE[0] * TILE[1] * per_block,
            "blocks": B * tiles * -(-groups // per_block),
            "dtype": dtype}


def plan_for(x: torch.Tensor, w: torch.Tensor, noise: Optional[torch.Tensor],
             noise_scale: float) -> dict:
    """The plan :func:`_launch` runs for these tensors: float4 where the
    noise it reads is 16-byte aligned (the output is a fresh allocation,
    which is). A banked ``x`` ``[N, b, H, W, Cin]`` gets the plan of its
    N*b images, with ``"banked": True``."""
    *lead, H, W, cin = x.shape
    aligned = noise_scale <= 0.0 or noise.data_ptr() % 16 == 0
    plan = conv_plan(math.prod(lead), H, W, cin, w.shape[-1], aligned,
                     str(x.dtype).removeprefix("torch."))
    return {**plan, "banked": True} if len(lead) == 2 else plan


def count(plan: dict) -> None:
    """One launch of ``plan``: ``launches`` and ``plans`` move together,
    under a lock, since several client threads may launch at once."""
    global launches
    with _count_lock:
        launches += 1
        plans[tuple(sorted(plan.items()))] += 1


def check_inputs(tensors, x, dtypes=tuple(DTYPES)) -> None:
    """Raise unless every tensor is contiguous, on x's device and of x's
    type, one of ``dtypes`` (the unbanked kernel's :data:`DTYPES`, the
    banked one's float32)."""
    for t in tensors:
        if (t.device != x.device or t.dtype != x.dtype or t.dtype not in dtypes
                or not t.is_contiguous()):
            names = ", ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise ValueError(f"privacy_conv kernel takes contiguous tensors of one type "
                             f"({names}) on one CUDA device; got {t.dtype} on {t.device} "
                             f"beside x's {x.dtype}, contiguous={t.is_contiguous()}")


def _launch(x, w, b, noise, noise_scale: float, plan: Optional[dict] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, with :func:`plan_for`'s plan unless
    ``plan`` is given (to time one variant against another); the source
    refuses a plan that does not fit the shape."""
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
    check_inputs(tensors, x)
    lib = build.library("privacy_conv")
    out = torch.empty(out_shape, device=x.device, dtype=x.dtype)
    if plan is None:
        plan = plan_for(x, w, noise, noise_scale)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.privacy_conv_launch_plan_typed(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            noise.data_ptr() if use_noise else None, out.data_ptr(),
            B, H, W, cin, cout, float(noise_scale), plan["cin_variant"],
            plan["channels_per_block"], int(plan["vec4"]), DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"privacy_conv kernel launch failed: CUDA error {err}")
    count(plan)
    return out


def _launch_banked(x, w, b, cids, noise, noise_scale: float,
                   plan: Optional[dict] = None) -> torch.Tensor:
    """The banked kernel on CUDA tensors (``cids`` int32 on the card), with
    :func:`plan_for`'s plan unless ``plan`` is given."""
    if x.dim() != 5 or w.dim() != 5 or b.dim() != 2 or cids.dim() != 1:
        raise ValueError(f"want x [N,b,H,W,Cin], w [C,3,3,Cin,Cout], b [C,Cout], cids [N]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}, "
                         f"{tuple(cids.shape)}")
    N, per_item, H, W, cin = x.shape
    C, cout = w.shape[0], w.shape[-1]
    if H % 2 or W % 2:
        raise ValueError(f"H and W must be even, got {H}x{W}")
    if tuple(w.shape) != (C, 3, 3, cin, cout) or tuple(b.shape) != (C, cout):
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not match "
                         f"Cin={cin}")
    if cids.shape[0] != N or cids.dtype != torch.int32 or cids.device != x.device:
        raise ValueError(f"cids must be [N={N}] int32 on {x.device}; got "
                         f"{tuple(cids.shape)} {cids.dtype} on {cids.device}")
    out_shape = (N, per_item, H // 2, W // 2, cout)
    use_noise = noise_scale > 0.0
    if use_noise and tuple(noise.shape) != out_shape:
        raise ValueError(f"noise {tuple(noise.shape)} != output {out_shape}")
    check_inputs([x, w, b] + ([noise] if use_noise else []), x, (torch.float32,))
    if not cids.is_contiguous():
        raise ValueError("cids must be contiguous")
    lib = build.library("privacy_conv")
    out = torch.empty(out_shape, device=x.device, dtype=torch.float32)
    if plan is None:
        plan = plan_for(x, w, noise, noise_scale)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.privacy_conv_banked_launch_plan(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), cids.data_ptr(),
            noise.data_ptr() if use_noise else None, out.data_ptr(),
            N * per_item, per_item, C, H, W, cin, cout, float(noise_scale),
            plan["cin_variant"], plan["channels_per_block"], int(plan["vec4"]), stream)
    if err:
        raise RuntimeError(f"privacy_conv banked kernel launch failed: CUDA error {err}")
    count(plan)
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


def _banked_forward(x, w, b, cids, noise, noise_scale: float) -> torch.Tensor:
    """One banked kernel launch for a CUDA ``x``, the item-by-item plain
    version for a CPU ``x``; any other device raises."""
    if x.device.type == "cpu":
        return privacy_conv_banked_ref(x, w, b, cids, noise, noise_scale=noise_scale)
    if x.device.type != "cuda":
        raise ValueError(f"privacy_conv runs on CUDA or the CPU, not {x.device}")
    return _launch_banked(x, w, b, cids, noise, noise_scale)


def privacy_conv_banked_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                cids: torch.Tensor, noise: Optional[torch.Tensor],
                                noise_scale: float = 0.0) -> torch.Tensor:
    """The queue fleet's layer, forward only: :func:`privacy_conv_banked`
    under ``no_grad``."""
    with torch.no_grad():
        return privacy_conv_banked(x, w, b, cids, noise, noise_scale=noise_scale)


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


class PrivacyConvBanked(torch.autograd.Function):
    """The banked layer: the banked launch forward, and a backward that
    recomputes through the grouped plain version once for the whole bank
    (the vmapped ``custom_vjp`` of ``repro/kernels/privacy_conv/ops.py``).
    It returns dx, dw [C, 3, 3, Cin, Cout] and db [C, Cout], each item's
    share added into its bank, for the inputs that need them; ``cids`` and
    the noise get none. The noise is left out of the recompute: it adds
    after the pool, so the gradient is the same without it."""

    @staticmethod
    def forward(ctx, x, w, b, cids, noise, noise_scale):
        ctx.save_for_backward(x, w, b, cids)
        return _banked_forward(x, w, b, cids, noise, noise_scale)

    @staticmethod
    def backward(ctx, g):
        x, w, b, cids = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip((x, w, b), need)]
            y = privacy_conv_grouped_ref(*leaves, cids, None)
            got = iter(torch.autograd.grad(y, [t for t in leaves if t.requires_grad], g))
        return (*(next(got) if n else None for n in need), None, None, None)


def privacy_conv_banked(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        cids: torch.Tensor, noise: Optional[torch.Tensor] = None, *,
                        noise_scale: float = 0.0) -> torch.Tensor:
    """The banked privacy layer, differentiable: x [N, b, H, W, Cin],
    stacked banks w [C, 3, 3, Cin, Cout] and b [C, Cout], ``cids`` [N]
    int32 on x's device (item n's bank), noise [N, b, H/2, W/2, Cout],
    required when ``noise_scale > 0``. One banked launch for a CUDA ``x``
    (:class:`PrivacyConvBanked`)."""
    if noise_scale > 0.0 and noise is None:
        raise ValueError("noise_scale > 0 requires noise")
    return PrivacyConvBanked.apply(x, w, b, cids, noise, noise_scale)
