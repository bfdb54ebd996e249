"""Wrapper of the fused DP release kernel (``csrc/dp_release.cu``).

:func:`dp_release_forward` launches the CUDA kernel for CUDA tensors and
runs the plain version (``ref.dp_release_ref``) for CPU tensors, the port's
counterpart of the Pallas interpreter. There is no other fallback: a CUDA
tensor the kernel does not take, a failed build or a refused launch raises.
:class:`DPRelease` makes it differentiable the way the JAX ``custom_vjp``
does (``repro/kernels/dp_release/ops.py:27-48``): the forward runs the
kernel, the backward recomputes through the plain version, and the noise
gets no gradient. ``launches`` counts kernel launches (one a call, or the
two of a split row) and ``plans`` the calls of each plan (keyed by its
sorted items), both updated by :func:`count` under a lock, since client
threads may launch at once. :func:`release_plan` chooses how a shape runs
from the shape, the element type and the card's SM count alone, so every
branch can be tested on the CPU and named in a report. The kernel takes
float32, bfloat16 or float16 (:data:`DTYPES`; x and the noise of one type),
sums in float32 and stores the release in x's type, as the TPU kernel does.
"""
from __future__ import annotations

import collections
import functools
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dp_release.ref import dp_release_ref

launches = 0
plans: collections.Counter = collections.Counter()
_count_lock = threading.Lock()

THREADS = 512        # a block; fixed in the source
MIN_CHUNK = 16384    # features a block sums at least when a row is split
# the element types the kernel takes, by the code its typed entry point reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def release_plan(rows: int, feats: int, sm_count: int, aligned: bool = True,
                 dtype: str = "float32") -> dict:
    """How ``csrc/dp_release.cu`` runs ``rows`` rows of ``feats`` features
    of type ``dtype`` (``"float32"``, ``"bfloat16"``, ``"float16"``) on a
    card of ``sm_count`` SMs, a pure function of them, worked out once a
    shape (the dict is shared: copy it to change it):

    - ``blocks_per_row`` k: 1 where the rows alone fill the SMs, or where a
      row has too few features to split (under ``2 * MIN_CHUNK``); else
      enough to fill the SMs, ``ceil(sm_count / rows)``, as far as chunks of
      at least ``MIN_CHUNK`` allow. k > 1 runs two launches (partial sums,
      then the release), k = 1 one.
    - ``chunk``: features of each block's part of a row, k of them cover
      the row once (the last may be shorter); a multiple of 4 with float4.
    - ``vec4``: float4 loads and stores, only for float32 where
      ``feats % 4 == 0`` and the tensors are 16-byte aligned (``aligned``);
      else scalar. A 2-byte type always loads and stores element by
      element, with the same k and chunks as float32 (they count elements).
    - ``dtype``: the element type, as given.
    """
    if rows < 0 or feats < 0 or sm_count < 1:
        raise ValueError(f"no plan for {rows} rows of {feats} on {sm_count} SMs")
    if dtype not in ("float32", "bfloat16", "float16"):
        raise ValueError(f"no plan for dtype {dtype!r}")
    vec4 = feats % 4 == 0 and aligned and dtype == "float32"
    k = 1
    if 0 < rows < sm_count:
        k = max(1, min(-(-sm_count // rows), feats // MIN_CHUNK))
    chunk = -(-feats // k)
    if vec4:
        chunk = -(-chunk // 4) * 4
    if chunk:
        k = -(-feats // chunk)
    return {"blocks_per_row": k, "chunk": chunk, "vec4": vec4, "threads": THREADS,
            "launches": 1 if k == 1 else 2, "dtype": dtype}


@functools.cache
def _sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x: torch.Tensor, noise: Optional[torch.Tensor], sigma: float) -> dict:
    """The plan :func:`_launch` runs for these CUDA tensors: the card's SM
    count, x's type, and float4 where ``x`` and the noise it reads are
    16-byte aligned (the output is a fresh allocation, which is)."""
    read = [x] + ([noise] if sigma > 0.0 else [])
    return release_plan(x.shape[0], math.prod(x.shape[1:]), _sm_count(x.device.index),
                        all(t.data_ptr() % 16 == 0 for t in read),
                        str(x.dtype).removeprefix("torch."))


def count(plan: dict) -> None:
    """One call of ``plan``: its launches (one, or the two of a split row)
    and the call, under a lock."""
    global launches
    with _count_lock:
        launches += plan["launches"]
        plans[tuple(sorted(plan.items()))] += 1


def check_inputs(x: torch.Tensor, noise: Optional[torch.Tensor], sigma: float) -> None:
    """Raise unless the kernel takes these tensors: x ``[B, ...]``, and
    where ``sigma > 0`` noise of x's shape, type and device; both
    contiguous, of one of :data:`DTYPES`."""
    if x.dim() < 1:
        raise ValueError("dp_release wants x [B, ...]")
    use_noise = sigma > 0.0
    if use_noise and tuple(noise.shape) != tuple(x.shape):
        raise ValueError(f"noise {tuple(noise.shape)} != x {tuple(x.shape)}")
    for t in [x] + ([noise] if use_noise else []):
        if (t.device != x.device or t.dtype != x.dtype or t.dtype not in DTYPES
                or not t.is_contiguous()):
            raise ValueError("dp_release kernel takes contiguous float32, bfloat16 or "
                             "float16 tensors of one type on one CUDA device; got "
                             f"{t.dtype} on {t.device} beside x's {x.dtype}, "
                             f"contiguous={t.is_contiguous()}")


def _launch(x, noise, clip_norm: float, sigma: float,
            plan: Optional[dict] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, with :func:`plan_for`'s plan unless
    ``plan`` is given (to time one plan against another); the source
    refuses a plan that does not fit the shape."""
    check_inputs(x, noise, sigma)
    use_noise = sigma > 0.0
    rows = x.shape[0]
    feats = math.prod(x.shape[1:])
    lib = build.library("dp_release")
    out = torch.empty_like(x)
    if plan is None:
        plan = plan_for(x, noise, sigma)
    k = plan["blocks_per_row"]
    partials = torch.empty((rows, k), device=x.device, dtype=torch.float32) if k > 1 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dp_release_launch_plan_typed(
            x.data_ptr(), noise.data_ptr() if use_noise else None, out.data_ptr(),
            partials.data_ptr() if partials is not None else None, rows, feats,
            float(clip_norm), float(sigma), k, plan["chunk"], int(plan["vec4"]),
            DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"dp_release kernel launch failed: CUDA error {err}")
    count(plan)
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
