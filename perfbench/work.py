"""Operations and bytes from the configurations' shapes, and the H100's
published peaks: the yardstick of every roofline and mfu metric.

``conv_work``, ``release_work`` and ``bound`` are frozen copies of the
arithmetic in ``chip_smoke.py`` (``bound`` returns seconds here). The
layer lists follow ``repro_torch.models.cnn``: each stage is ``repeats``
SAME 3x3 convolutions, a ReLU after each, then a 2x2 max-pool; the client
holds the first ``cut_layers`` stages; the trunk is the rest, flattened in
NHWC order, then the dense layers and the output layer. Only the
multiply-adds of the convolutions and the dense layers count (2 operations
each); bias, ReLU, pooling and the loss are left out, so an mfu here is a
lower bound of the arithmetic done.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS_PER_S = 67e12


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory bandwidth and the operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / peak_flops
    return {"bytes": nbytes, "flops": flops, "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def conv_work(B: int, H: int, W: int, cin: int, cout: int, scale: float,
              esize: int = 4) -> dict:
    """One ``privacy_conv`` call: x, the weights and bias read once, the
    pooled output written once, the noise read once where ``scale > 0``;
    9*Cin multiply-adds a pre-pool value, its bias and ReLU, three max and
    the noise's multiply-add a pooled value."""
    out = B * (H // 2) * (W // 2) * cout
    noisy = scale > 0
    nbytes = esize * (B * H * W * cin + 9 * cin * cout + cout + (2 if noisy else 1) * out)
    flops = B * H * W * cout * (2 * 9 * cin + 2) + out * (5 if noisy else 3)
    return bound(nbytes, flops)


def release_work(shape: Sequence[int], sigma: float, esize: int = 4) -> dict:
    """One ``dp_release`` call: x read once, the release written once, the
    noise read once where sigma > 0; a square and an add an element for the
    norm, the scale, and the noise's multiply-add."""
    n = int(np.prod(shape))
    nbytes = n * (2 * esize + (esize if sigma > 0 else 0))
    flops = n * (5 if sigma > 0 else 3)
    return bound(nbytes, flops)


def conv_layers(cfg: dict) -> List[Dict[str, int]]:
    """Every convolution of the model in order: its input height and width,
    channels in and out, and whether the client holds it."""
    h, w = cfg["input_hw"]
    cin = cfg["in_channels"]
    out = []
    for si, (filters, repeats) in enumerate(cfg["stages"]):
        for _ in range(repeats):
            out.append({"H": h, "W": w, "cin": cin, "cout": filters,
                        "client": si < cfg["cut_layers"]})
            cin = filters
        h, w = h // 2, w // 2
    return out


def dense_layers(cfg: dict) -> List[Dict[str, int]]:
    """The trunk's dense layers and its output layer, as (d_in, d_out)."""
    h, w = cfg["input_hw"]
    n = len(cfg["stages"])
    d_in = (h // 2 ** n) * (w // 2 ** n) * cfg["stages"][-1][0]
    out = []
    for units in list(cfg["dense_units"]) + [cfg["n_classes"]]:
        out.append({"d_in": d_in, "d_out": units})
        d_in = units
    return out


def conv_macs(layer: dict) -> int:
    return layer["H"] * layer["W"] * 9 * layer["cin"] * layer["cout"]


def client_macs(cfg: dict) -> int:
    """Multiply-adds of one input row through the client's stage."""
    return sum(conv_macs(c) for c in conv_layers(cfg) if c["client"])


def trunk_macs(cfg: dict) -> int:
    """Multiply-adds of one row through the trunk."""
    return (sum(conv_macs(c) for c in conv_layers(cfg) if not c["client"])
            + sum(d["d_in"] * d["d_out"] for d in dense_layers(cfg)))


def first_trunk_macs(cfg: dict) -> int:
    """The trunk's first layer's multiply-adds: the one whose input gradient
    a detached cut never computes."""
    trunk = [c for c in conv_layers(cfg) if not c["client"]]
    if trunk:
        return conv_macs(trunk[0])
    d = dense_layers(cfg)[0]
    return d["d_in"] * d["d_out"]


def serve_flops_per_row(cfg: dict) -> int:
    """Forward operations of one served row: its client stage and the
    trunk."""
    return 2 * (client_macs(cfg) + trunk_macs(cfg))


def detached_train_flops_per_row(cfg: dict) -> int:
    """Operations of one trained row in the detached (temporal) split: the
    client's forward; the trunk's forward, its weight gradients (as many
    again) and its input gradients, save the first layer's, which the
    detached cut never asks for."""
    trunk = trunk_macs(cfg)
    return 2 * (client_macs(cfg) + trunk + trunk + trunk - first_trunk_macs(cfg))


def feature_shape(cfg: dict, rows: int) -> tuple:
    """The released feature map of ``rows`` input rows (NHWC)."""
    h, w = cfg["input_hw"]
    c = cfg["in_channels"]
    for filters, _ in cfg["stages"][:cfg["cut_layers"]]:
        h, w, c = h // 2, w // 2, filters
    return (rows, h, w, c)


def sigma(guard: dict) -> float:
    """The Gaussian mechanism's noise scale: 2 * clip * sqrt(2 ln(1.25/δ)) / ε."""
    return (2.0 * guard["clip_norm"] * np.sqrt(2.0 * np.log(1.25 / guard["delta"]))
            / guard["epsilon"])
