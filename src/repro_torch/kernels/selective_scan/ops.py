"""Wrapper of the Mamba-1 selective scan kernel (``csrc/selective_scan.cu``).

:func:`selective_scan` is the public entry point, with the signature of
``repro/kernels/selective_scan/ops.py:13``. For CUDA tensors it launches the
kernel, which keeps the state ``h`` in registers across the whole time loop
(4 lanes of 4 states a channel for ``d_state <= 16``) and never writes ``dA``
or ``dBu`` to device memory. For CPU tensors it runs
the plain version (``ref.selective_scan_ref``), the port's counterpart of
the Pallas interpreter. There is no other fallback: a CUDA tensor the kernel
does not take, a failed build or a refused launch raises.

Under grad (a CUDA input that requires grad, grad mode on) the call goes
through :class:`SelectiveScan`, a ``torch.autograd.Function`` whose backward
is a kernel too: the forward also stores the state entering every
``CHECKPOINT_STEPS`` steps (``[Bsz, ceil(S / 32), di, st]`` float32, a
32nd of the states), and the backward recomputes each chunk's states from
them and walks them back, never writing ``[Bsz, S, di, st]``. It takes
``d_state <= 16``. ``u`` may be float32 or bfloat16 (read as float32, the
plain version's ``u.float()``; its gradient comes back in its dtype); dt,
B, C, A and D are float32, and y is float32. ``launches`` counts forward
launches and ``backward_launches`` backward ones (:func:`count`, under a
lock).
"""
from __future__ import annotations

import math
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

launches = 0
backward_launches = 0
_count_lock = threading.Lock()


def count(backward: bool = False) -> None:
    """One kernel launch, under a lock: threads may launch at once."""
    global launches, backward_launches
    with _count_lock:
        if backward:
            backward_launches += 1
        else:
            launches += 1

MAX_STATE = 128  # d_state the kernel holds in registers: 32 lanes x 4 states
BACKWARD_MAX_STATE = 16  # the backward's lanes: one state each, 16 a channel
CHECKPOINT_STEPS = 32  # the backward's chunk of time (csrc kBwdSteps)
BACKWARD_CHANNELS = 32  # channels a backward block takes (csrc kBwdChannels)
# lanes of a channel the kernel can take for a d_state up to the key; the
# first is its own choice (csrc/selective_scan.cu selective_scan_launch_lanes)
LANES = {16: (4, 16), 64: (16,), 128: (32,)}
_U_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(u, dt, B, C, A, D):
    """``(Bsz, S, di, st)``, raising on what the kernel does not take."""
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError(f"want u [Bsz,S,di] and A [di,st]; got {tuple(u.shape)}, "
                         f"{tuple(A.shape)}")
    Bsz, S, di = u.shape
    st = A.shape[1]
    want = {"dt": (Bsz, S, di), "B": (Bsz, S, st), "C": (Bsz, S, st), "A": (di, st),
            "D": (di,)}
    for name, t in zip(want, (dt, B, C, A, D)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} != {want[name]} for u {tuple(u.shape)}")
    if not 1 <= st <= MAX_STATE:
        raise ValueError(f"selective_scan kernel takes 1 <= d_state <= {MAX_STATE}, got {st}")
    for i, t in enumerate((u, dt, B, C, A, D)):
        ok = t.dtype in _U_TYPES if i == 0 else t.dtype == torch.float32
        if t.device != u.device or not ok or not t.is_contiguous():
            raise ValueError("selective_scan kernel takes contiguous tensors on one CUDA "
                             "device, u float32 or bfloat16 and the rest float32; got "
                             f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
    return Bsz, S, di, st


def _launch(u, dt, B, C, A, D, d_tile: int, t_chunk: int, lanes=None,
            checkpoints: bool = False):
    """Launch the forward; ``lanes`` (one of ``LANES[k]`` for the least key
    ``k >= d_state``, float32 u) overrides the lanes of a channel that the
    kernel picks for itself. ``checkpoints``: also return the states
    entering every ``CHECKPOINT_STEPS`` steps, for :func:`_launch_backward`."""
    Bsz, S, di, st = _check(u, dt, B, C, A, D)
    allowed = next(v for k, v in LANES.items() if st <= k)
    if lanes is not None and (lanes not in allowed or u.dtype != torch.float32 or checkpoints):
        raise ValueError(f"lanes {lanes} not in {allowed} for d_state {st}, or with a "
                         "bfloat16 u or checkpoints")
    if (checkpoints or u.dtype != torch.float32) and st > BACKWARD_MAX_STATE:
        raise ValueError(f"a bfloat16 u or the checkpoints take d_state <= "
                         f"{BACKWARD_MAX_STATE}, got {st}")
    y = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    hck = (torch.empty((Bsz, -(-S // CHECKPOINT_STEPS), di, st), dtype=torch.float32,
                       device=u.device) if checkpoints else None)
    if y.numel() == 0:
        return (y, hck) if checkpoints else y
    lib = build.library("selective_scan")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (u.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
                D.data_ptr(), y.data_ptr())
        if lanes is not None:
            err = lib.selective_scan_launch_lanes(*ptrs, Bsz, S, di, st, d_tile, t_chunk,
                                                  lanes, stream)
        else:
            err = lib.selective_scan_fwd_launch(
                *ptrs, None if hck is None else hck.data_ptr(), Bsz, S, di, st, d_tile,
                t_chunk, _U_TYPES[u.dtype], CHECKPOINT_STEPS, stream)
    if err:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    count()
    return (y, hck) if checkpoints else y


def backward_slabs(Bsz: int, di: int, device) -> int:
    """Blocks along the channels of the backward's grid, about one block an
    SM in all: each writes its own slab of dB and dC partial sums."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-di // BACKWARD_CHANNELS), math.ceil(sms / Bsz)))


def _launch_backward(u, dt, B, C, A, D, dy, hck):
    """``(du, d_dt, dB, dC, dA, dD)`` of the scan given ``dy`` and the
    forward's checkpoints ``hck``; du in u's dtype, the rest float32."""
    Bsz, S, di, st = _check(u, dt, B, C, A, D)
    if st > BACKWARD_MAX_STATE:
        raise ValueError(f"selective_scan's backward takes d_state <= {BACKWARD_MAX_STATE}, "
                         f"got {st}")
    nck = -(-S // CHECKPOINT_STEPS)
    for name, t, shape in (("dy", dy, (Bsz, S, di)), ("checkpoints", hck, (Bsz, nck, di, st))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != u.device):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {u.device}")
    slabs = backward_slabs(Bsz, di, u.device)
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    dBp = torch.empty((slabs, Bsz, S, st), dtype=torch.float32, device=u.device)
    dCp = torch.empty_like(dBp)
    dAp = torch.empty((Bsz, di, st), dtype=torch.float32, device=u.device)
    dDp = torch.empty((Bsz, di), dtype=torch.float32, device=u.device)
    if u.numel():
        lib = build.library("selective_scan")
        with torch.cuda.device(u.device):
            err = lib.selective_scan_bwd_launch(
                u.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
                D.data_ptr(), dy.data_ptr(), hck.data_ptr(), du.data_ptr(), ddt.data_ptr(),
                dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), dDp.data_ptr(), Bsz, S, di, st,
                _U_TYPES[u.dtype], slabs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"selective_scan backward launch failed: CUDA error {err}")
        count(backward=True)
    return du, ddt, dBp.sum(0), dCp.sum(0), dAp.sum(0), dDp.sum(0)


class SelectiveScan(torch.autograd.Function):
    """The scan on the card with its backward kernel: the forward saves its
    inputs and the checkpoints (a 32nd of the states), the backward
    launches ``selective_scan_bwd_launch`` once."""

    @staticmethod
    def forward(ctx, u, dt, B, C, A, D, d_tile: int, t_chunk: int):
        y, hck = _launch(u, dt, B, C, A, D, d_tile, t_chunk, checkpoints=True)
        ctx.save_for_backward(u, dt, B, C, A, D, hck)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, dt, B, C, A, D, hck = ctx.saved_tensors
        grads = _launch_backward(u, dt, B, C, A, D, dy.contiguous(), hck)
        return (*grads, None, None)


def selective_scan(u, dt, B, C, A, D, *, d_tile: int = 128, t_chunk: int = 64,
                   use_kernel: bool = True) -> torch.Tensor:
    """Mamba-1 selective scan: u, dt ``[Bsz, S, di]``; B, C ``[Bsz, S, st]``;
    A ``[di, st]``; D ``[di]``; returns ``y [Bsz, S, di]``.

    ``use_kernel=False`` runs the plain version on any device. On the card,
    ``d_tile`` is the number of channels a block takes (cut so that a block
    has at most 512 threads) and ``t_chunk`` the number of time steps it
    stages in shared memory at once (rounded up to whole groups of a
    channel's lanes); neither has to divide its dimension. B and C, small,
    are made contiguous here (the model's are views of ``x_proj``'s output);
    u and dt must be. A CUDA input that requires grad, under grad mode,
    takes :class:`SelectiveScan`.
    """
    if d_tile < 1 or t_chunk < 1:
        raise ValueError(f"d_tile and t_chunk must be positive, got {d_tile}, {t_chunk}")
    if not use_kernel or u.device.type == "cpu":
        return selective_scan_ref(u, dt, B, C, A, D)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on CUDA or the CPU, not {u.device}")
    B, C = B.contiguous(), C.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, dt, B, C, A, D)):
        return SelectiveScan.apply(u, dt, B, C, A, D, d_tile, t_chunk)
    return _launch(u, dt, B, C, A, D, d_tile, t_chunk)
