"""Wrapper of the Mamba-1 selective scan kernel (``csrc/selective_scan.cu``).

:func:`selective_scan` is the public entry point, with the signature of
``repro/kernels/selective_scan/ops.py:13``. For CUDA tensors it launches the
kernel, which keeps the state ``h`` in registers across the whole time loop
(4 lanes of 4 states a channel for ``d_state <= 16``) and never writes ``dA``
or ``dBu`` to device memory. For CPU tensors it runs
the plain version (``ref.selective_scan_ref``), the port's counterpart of
the Pallas interpreter. There is no other fallback: a CUDA tensor the kernel
does not take, a failed build or a refused launch raises.

Forward only, as the TPU kernel is: on a CUDA tensor that requires grad
under grad mode the wrapper raises. ``launches`` counts kernel launches
(:func:`count`, under a lock).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

launches = 0
_count_lock = threading.Lock()


def count() -> None:
    """One kernel launch, under a lock: threads may launch at once."""
    global launches
    with _count_lock:
        launches += 1

MAX_STATE = 128  # d_state the kernel holds in registers: 32 lanes x 4 states
# lanes of a channel the kernel can take for a d_state up to the key; the
# first is its own choice (csrc/selective_scan.cu selective_scan_launch_lanes)
LANES = {16: (4, 16), 64: (16,), 128: (32,)}


def _launch(u, dt, B, C, A, D, d_tile: int, t_chunk: int, lanes=None) -> torch.Tensor:
    """Launch the kernel; ``lanes`` (one of ``LANES[k]`` for the least key
    ``k >= d_state``) overrides the lanes of a channel that the kernel picks
    for itself."""
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
    tensors = (u, dt, B, C, A, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("selective_scan's CUDA kernel is forward only (the TPU kernel "
                           "has no VJP); call it under torch.no_grad() or on detached inputs")
    if not 1 <= st <= MAX_STATE:
        raise ValueError(f"selective_scan kernel takes 1 <= d_state <= {MAX_STATE}, got {st}")
    allowed = next(v for k, v in LANES.items() if st <= k)
    if lanes is not None and lanes not in allowed:
        raise ValueError(f"lanes {lanes} not in {allowed} for d_state {st}")
    for t in tensors:
        if t.device != u.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("selective_scan kernel takes contiguous float32 tensors on one "
                             f"CUDA device; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    y = torch.empty_like(u)
    if y.numel() == 0:
        return y
    lib = build.library("selective_scan")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (u.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
                D.data_ptr(), y.data_ptr(), Bsz, S, di, st, d_tile, t_chunk)
        err = (lib.selective_scan_launch(*args, stream) if lanes is None
               else lib.selective_scan_launch_lanes(*args, lanes, stream))
    if err:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    count()
    return y


def selective_scan(u, dt, B, C, A, D, *, d_tile: int = 128, t_chunk: int = 64,
                   use_kernel: bool = True) -> torch.Tensor:
    """Mamba-1 selective scan: u, dt ``[Bsz, S, di]``; B, C ``[Bsz, S, st]``;
    A ``[di, st]``; D ``[di]``; returns ``y [Bsz, S, di]``.

    ``use_kernel=False`` runs the plain version on any device. On the card,
    ``d_tile`` is the number of channels a block takes (cut so that a block
    has at most 512 threads) and ``t_chunk`` the number of time steps it
    stages in shared memory at once (rounded up to whole groups of a
    channel's lanes); neither has to divide its dimension.
    """
    if d_tile < 1 or t_chunk < 1:
        raise ValueError(f"d_tile and t_chunk must be positive, got {d_tile}, {t_chunk}")
    if not use_kernel or u.device.type == "cpu":
        return selective_scan_ref(u, dt, B, C, A, D)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on CUDA or the CPU, not {u.device}")
    return _launch(u, dt, B, C, A, D, d_tile, t_chunk)
