"""Plain PyTorch version of the Mamba-1 selective scan: the sequential
scan of ``repro/kernels/selective_scan/ref.py``. The CPU path, and what the
CUDA kernel is checked against."""
from __future__ import annotations

import torch


def selective_scan_ref(u, dt, B, C, A, D) -> torch.Tensor:
    """u, dt: ``[Bsz, S, di]``; B, C: ``[Bsz, S, st]``; A: ``[di, st]``;
    D: ``[di]``. Returns ``y [Bsz, S, di]`` in float32::

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
        y_t = h_t @ C_t + D * u_t

    The state is float32 from ``h_0 = 0``. ``dA`` and ``dBu`` are
    materialised as ``[Bsz, S, di, st]`` float32, as in the JAX reference.
    The result is float32 whatever u's dtype, as there: the JAX reference
    casts to ``u.dtype`` after rebinding ``u`` to its float32 copy.
    """
    u = u.float()
    dt = dt.float()
    dA = torch.exp(dt[..., None] * A.float()[None, None])
    dBu = (dt * u)[..., None] * B.float()[:, :, None, :]
    Cf = C.float()
    Bsz, S, di, st = dA.shape
    h = torch.zeros((Bsz, di, st), dtype=torch.float32, device=u.device)
    ys = []
    for t in range(S):
        h = dA[:, t] * h + dBu[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + u * D.float()[None, None]
    return y
