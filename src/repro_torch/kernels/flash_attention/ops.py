"""Wrapper of the flash attention kernel (``csrc/flash_attention.cu``).

:func:`flash_attention` is the public entry point, with the JAX layout of
``repro/kernels/flash_attention/ops.py:15``: q ``[B, S, H, hd]``, k and v
``[B, S, KV, hd]``, output ``[B, S, H, hd]`` in q's dtype. For a CUDA tensor
it launches the kernel, which reads the kv head ``h // (H // KV)`` of query
head ``h`` in place (what the JAX wrapper's ``jnp.repeat`` of k and v
produces, without the copy): for float32 the FMA kernel (every product in
float32), for bfloat16 the tensor-core kernel (``mma.sync``: bf16 products,
exact in float32, with float32 sums, and the probabilities split into two
bf16 parts for P.V). For a CPU tensor it runs the plain version
(``ref.flash_attention_ref`` on the repeated heads), the port's counterpart
of the Pallas interpreter. There is no other fallback: a CUDA tensor the
kernel does not take, a failed build or a refused launch raises.

Forward only, as the TPU kernel is (it has no VJP): on a CUDA tensor that
requires grad under grad mode the wrapper raises rather than hand back an
output cut off from autograd. ``launches`` counts kernel launches
(:func:`count`, under a lock).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

launches = 0
_count_lock = threading.Lock()


def count() -> None:
    """One kernel launch, under a lock: threads may launch at once."""
    global launches
    with _count_lock:
        launches += 1

# head dims the kernel is compiled for: those of the registered configs
# (csrc/flash_attention.cu dispatch_hd)
HEAD_DIMS = (32, 64, 80, 128)
# dtype codes of flash_attention_launch
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# query rows of a block: float32 64; bfloat16 64 (4 warps) by default, or 128
# (8 warps) through ``q_rows`` (csrc/flash_attention.cu kBf16QRows)
Q_ROWS = {torch.float32: (64,), torch.bfloat16: (64, 128)}


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,S,H,hd], k and v [B,S,KV,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, hd) or KV == 0 or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(H must be a multiple of KV)")
    return B, S, H, KV, hd


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """The plain version in the public layout: k and v repeated to H heads,
    (B, H) folded, :func:`flash_attention_ref`, and unfolded again."""
    B, S, H, KV, hd = _check_shapes(q, k, v)
    G = H // KV
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, hd)

    out = flash_attention_ref(fold(q), fold(k), fold(v), causal=causal, window=window)
    return out.reshape(B, H, S, hd).transpose(1, 2)


def _launch(q, k, v, causal: bool, window: int, q_rows=None) -> torch.Tensor:
    """Launch the kernel; ``q_rows`` (one of ``Q_ROWS[dtype]``) overrides
    the block's query rows that the kernel picks for itself."""
    B, S, H, KV, hd = _check_shapes(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention's CUDA kernel is forward only (the TPU kernel "
                           "has no VJP); call it under torch.no_grad() or on detached inputs")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("flash_attention kernel takes contiguous q, k, v of one dtype "
                             f"on one CUDA device; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, not {q.dtype}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        # the tensor-core kernel copies 16 bytes at a time (cp.async)
        raise ValueError("flash_attention's bfloat16 kernel takes q, k, v that start on "
                         "16 bytes")
    if q_rows is not None and q_rows not in Q_ROWS[q.dtype]:
        raise ValueError(f"q_rows {q_rows} not in {Q_ROWS[q.dtype]} for {q.dtype}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                B, S, H, KV, hd, int(causal), int(window), 1.0 / (hd ** 0.5))
        err = (lib.flash_attention_launch(*args, stream) if q_rows is None
               else lib.flash_attention_launch_tiles(*args, q_rows, stream))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    count()
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_block: int = 128,
                    kv_block: int = 128, use_kernel: bool = True) -> torch.Tensor:
    """GQA flash attention. q: ``[B, S, H, hd]``; k, v: ``[B, S, KV, hd]``.

    Masks: causal (``k <= q``), a window (``|q - k| < window`` when
    ``window > 0``), both, or neither (bidirectional). ``use_kernel=False``
    runs the plain version on any device. ``q_block`` and ``kv_block`` are
    the TPU kernel's tiles, kept for the JAX signature and ignored: both CUDA
    kernels take 64 query rows a block and stage kv tiles of 64 rows,
    whatever they are.
    """
    if q_block < 1 or kv_block < 1:
        raise ValueError(f"q_block and kv_block must be positive, got {q_block}, {kv_block}")
    if not use_kernel or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not {q.device}")
    return _launch(q, k, v, causal, window)
