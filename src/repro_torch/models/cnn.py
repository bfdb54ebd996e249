"""The paper's CNN classifiers (custom COVID-19 model, VGG19 for MURA).

Structured for split learning like ``repro.models.cnn``: ``params["client"]``
holds the input conv stage(s), the privacy-preserving layer (Conv2D +
MaxPool2D, paper §III-A), and ``params["server"]`` the remaining stages and
the dense head. Activations are NHWC and conv weights HWIO, as in the JAX
package; each conv turns NHWC into PyTorch's NCHW view and back.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.bridge import tree_map
from repro_torch.common.device import resolve_device
from repro_torch.configs.paper_models import CNNConfig
from repro_torch.kernels.privacy_conv.ops import privacy_conv, privacy_conv_banked
from repro_torch.models.layers import add_privacy_noise, dense_init


def _init_conv(generator, in_ch, out_ch, ksize=3, dtype=torch.float32):
    fan_in = in_ch * ksize * ksize
    return {
        "w": dense_init(generator, fan_in, (ksize, ksize, in_ch, out_ch), dtype),
        "b": torch.zeros((out_ch,), dtype=dtype, device=generator.device),
    }


def conv2d(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv with ``stride``, as ``repro.models.cnn.conv2d``. x: [B, H,
    W, C] NHWC; p["w"]: [kh, kw, C, O] HWIO. The NCHW view of a contiguous
    NHWC tensor is channels-last, so the conv runs channels-last and the
    result permutes back to contiguous NHWC. A stride above 1 pads as XLA's
    SAME does: ``ceil(H / stride)`` outputs, the odd pixel of padding at
    the bottom and right."""
    xc, wc = x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1)
    if stride == 1:
        y = F.conv2d(xc, wc, padding="same")
    else:
        pads = []
        for size, k in ((x.shape[2], wc.shape[3]), (x.shape[1], wc.shape[2])):
            total = max((-(-size // stride) - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        y = F.conv2d(F.pad(xc, pads), wc, stride=stride)
    return y.permute(0, 2, 3, 1) + p["b"]


def max_pool(x: torch.Tensor, size: int = 2) -> torch.Tensor:
    """Non-overlapping max-pool over NHWC as a reshape then ``amax``, the
    scheme of ``repro.models.cnn.max_pool`` (its gradient splits across tied
    values, as ``jnp.max``'s does). H and W must divide by ``size``."""
    h, w = x.shape[-3], x.shape[-2]
    if h % size or w % size:
        raise ValueError(f"max_pool needs H, W divisible by {size}, got {h}x{w}")
    shape = x.shape[:-3] + (h // size, size, w // size, size, x.shape[-1])
    return x.reshape(shape).amax(dim=(-4, -2))


def init_cnn(generator: torch.Generator, cfg: CNNConfig, device=None,
             dtype=torch.float32) -> Dict[str, Any]:
    """Random weights drawn from ``generator`` (a CPU generator gives the
    same weights whatever ``device`` is), placed on ``device`` (``None``:
    the card)."""
    device = resolve_device(device)
    in_ch = cfg.in_channels
    stages = []
    for filters, repeats in cfg.stages:
        convs = []
        for _ in range(repeats):
            convs.append(_init_conv(generator, in_ch, filters, dtype=dtype))
            in_ch = filters
        stages.append(convs)

    h, w = cfg.input_hw
    h, w = h // (2 ** len(cfg.stages)), w // (2 ** len(cfg.stages))
    d_in = h * w * in_ch
    dense = []
    for units in cfg.dense_units:
        dense.append({"w": dense_init(generator, d_in, (d_in, units), dtype),
                      "b": torch.zeros((units,), dtype=dtype, device=generator.device)})
        d_in = units
    out = {"w": dense_init(generator, d_in, (d_in, cfg.n_classes), dtype),
           "b": torch.zeros((cfg.n_classes,), dtype=dtype, device=generator.device)}

    cut = cfg.cut_layers
    params = {
        "client": {"stages": stages[:cut]},
        "server": {"stages": stages[cut:], "dense": dense, "out": out},
    }
    return tree_map(lambda t: t.to(device), params)


def _run_stage(convs, x):
    for c in convs:
        x = torch.relu(conv2d(c, x))
    return max_pool(x)


def feature_shape(cfg: CNNConfig, input_shape) -> tuple:
    """The shape of the feature map the client releases for a
    ``[B, H, W, C]`` input."""
    b, h, w, c = input_shape
    for filters, _ in cfg.stages[:cfg.cut_layers]:
        h, w, c = h // 2, w // 2, filters
    return (b, h, w, c)


def client_forward(params, cfg: CNNConfig, x: torch.Tensor,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The privacy-preserving layer: conv stage(s) + max-pool (+ noise).

    x: [B, H, W, C]; ``noise``: standard-normal draws of the output's shape
    (``None``: no model noise, as a ``None`` key in ``repro``). Returns the
    feature map shipped to the server.

    With ``cfg.use_kernel`` every single-conv stage runs through the fused
    privacy kernel (``repro/models/cnn.py:123``), the last one adding the
    noise after the pool; other stages run the plain convs.
    """
    stages = params["client"]["stages"]
    scale = cfg.privacy_noise if noise is not None else 0.0
    for si, convs in enumerate(stages):
        last = si == len(stages) - 1
        if cfg.use_kernel and len(convs) == 1:
            x = privacy_conv(
                x, convs[0]["w"], convs[0]["b"],
                noise if (last and scale > 0.0) else None,
                noise_scale=scale if last else 0.0,
            )
        else:
            x = _run_stage(convs, x)
            if last:
                x = add_privacy_noise(x, scale, noise)
    if not stages:
        x = add_privacy_noise(x, scale, noise)
    return x


@functools.lru_cache(maxsize=256)
def _bank_index(device: torch.device, bank_of: Tuple[int, ...]) -> torch.Tensor:
    """The item-to-bank map as the int32 index the banked launch reads, on
    ``device``, built once a map (the fused step's is ``arange(C)`` every
    step), so that no step copies it from the host."""
    return torch.tensor(bank_of, dtype=torch.int32, device=device)


def fleet_client_forward(params, cfg: CNNConfig, bank_of: Sequence[int], xs: torch.Tensor,
                         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`client_forward` of N items at once: item n with batch
    ``xs[n]`` ([N, b, H, W, C]) on bank ``bank_of[n]`` (a host sequence) of
    the stacked banks ``params["client"]`` (every leaf ``[n_banks, ...]``),
    ``noise`` [N, b, ...] of the output's shape.

    With ``cfg.use_kernel`` each single-conv stage is ONE banked
    ``privacy_conv`` launch (the JAX package vmaps the Pallas call over the
    items), differentiable through the grouped plain version; other stages
    run the plain ops item by item on their banks. Per item the forward's
    bits are those of :func:`client_forward`."""
    stages = params["client"]["stages"]
    scale = cfg.privacy_noise if noise is not None else 0.0
    x = xs
    for si, convs in enumerate(stages):
        last = si == len(stages) - 1
        if cfg.use_kernel and len(convs) == 1:
            x = privacy_conv_banked(
                x, convs[0]["w"], convs[0]["b"], _bank_index(x.device, tuple(bank_of)),
                noise if (last and scale > 0.0) else None,
                noise_scale=scale if last else 0.0,
            )
        else:
            x = torch.stack([_run_stage([tree_map(lambda a, c=c: a[c], cv) for cv in convs],
                                        x[n])
                             for n, c in enumerate(bank_of)])
            if last:
                x = add_privacy_noise(x, scale, noise)
    if not stages:
        x = add_privacy_noise(x, scale, noise)
    return x


def server_forward(params, cfg: CNNConfig, fmap: torch.Tensor) -> torch.Tensor:
    """Server trunk: remaining conv stages + dense head. fmap -> logits
    [B, n_classes]. The map is flattened in NHWC order, as ``cnn.py:144``."""
    x = fmap
    for convs in params["server"]["stages"]:
        x = _run_stage(convs, x)
    x = x.reshape(x.shape[0], -1)
    for dlay in params["server"]["dense"]:
        x = torch.relu(x @ dlay["w"] + dlay["b"])
    o = params["server"]["out"]
    return x @ o["w"] + o["b"]


def server_forward_tp(params, cfg: CNNConfig, fmap: torch.Tensor, tp) -> torch.Tensor:
    """:func:`server_forward` tensor-parallel over the mesh's model axis
    (``tp`` a ``sharding.tensor_parallel.TrunkParallel``): each conv shards
    its output channels, ReLU and the pool run on the shard, the stage
    gathers before the next conv and the flatten; the dense layers alternate
    column- and row-parallel; the logits are gathered."""
    sp = params["server"]
    specs = tp.specs(sp)
    x, sharded = fmap, False
    for convs, cspecs in zip(sp["stages"], specs["stages"]):
        for c, s in zip(convs, cspecs):
            x, sharded = tp.conv(conv2d, x, sharded, c, s)
            x = torch.relu(x)
        x = max_pool(x)
    x = tp.whole(x, sharded)
    x, sharded = x.reshape(x.shape[0], -1), False
    for dlay, s in zip(sp["dense"], specs["dense"]):
        x, sharded = tp.dense(x, sharded, dlay, s)
        x = torch.relu(x)
    x, sharded = tp.dense(x, sharded, sp["out"], specs["out"])
    return tp.whole(x, sharded)


def forward(params, cfg: CNNConfig, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
            detach_cut: bool = True) -> torch.Tensor:
    """The whole model in one trust domain, as ``repro.models.cnn.forward``:
    :func:`client_forward` with the standard-normal model ``noise`` (the
    reference's key), the cut detached where ``detach_cut``, then
    :func:`server_forward`. Split deployments go through ``SplitSession``,
    which guards the cut."""
    fmap = client_forward(params, cfg, x, noise)
    if detach_cut:
        fmap = fmap.detach()
    return server_forward(params, cfg, fmap)  # splitlint: ignore[SPL101]
