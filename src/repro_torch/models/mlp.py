"""The paper's cholesterol LDL-C regression MLP (LeakyReLU, MSE)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.bridge import tree_map
from repro_torch.common.device import resolve_device
from repro_torch.configs.paper_models import MLPConfig
from repro_torch.models.layers import add_privacy_noise, dense_init


def init_mlp(generator: torch.Generator, cfg: MLPConfig, device=None,
             dtype=torch.float32):
    """Random weights drawn from ``generator``, placed on ``device``
    (``None``: the card). Dense weights are ``[in, out]``."""
    device = resolve_device(device)
    dims = [cfg.in_features] + list(cfg.hidden) + [1]
    layers = [
        {"w": dense_init(generator, dims[i], (dims[i], dims[i + 1]), dtype),
         "b": torch.zeros((dims[i + 1],), dtype=dtype, device=generator.device)}
        for i in range(len(dims) - 1)
    ]
    cut = cfg.cut_layers
    params = {"client": {"layers": layers[:cut]}, "server": {"layers": layers[cut:]}}
    return tree_map(lambda t: t.to(device), params)


def feature_shape(cfg: MLPConfig, input_shape) -> tuple:
    """The shape of the features the client releases for a ``[B, F]`` input."""
    dims = [cfg.in_features] + list(cfg.hidden)
    return (input_shape[0], dims[cfg.cut_layers])


def client_forward(params, cfg: MLPConfig, x: torch.Tensor,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Privacy-preserving layer for tabular data: first dense layer + noise."""
    for lay in params["client"]["layers"]:
        x = F.leaky_relu(x @ lay["w"] + lay["b"], 0.01)
    return add_privacy_noise(x, cfg.privacy_noise, noise)


def server_forward(params, cfg: MLPConfig, h: torch.Tensor) -> torch.Tensor:
    layers = params["server"]["layers"]
    for lay in layers[:-1]:
        h = F.leaky_relu(h @ lay["w"] + lay["b"], 0.01)
    out = layers[-1]
    return (h @ out["w"] + out["b"])[..., 0]  # [B]


def server_forward_tp(params, cfg: MLPConfig, h: torch.Tensor, tp) -> torch.Tensor:
    """:func:`server_forward` tensor-parallel over the mesh's model axis
    (``tp`` a ``sharding.tensor_parallel.TrunkParallel``): the layers
    alternate column- and row-parallel, the output is gathered."""
    layers = params["server"]["layers"]
    specs = tp.specs(params["server"])["layers"]
    sharded = False
    for lay, s in zip(layers[:-1], specs[:-1]):
        h, sharded = tp.dense(h, sharded, lay, s)
        h = F.leaky_relu(h, 0.01)
    h, sharded = tp.dense(h, sharded, layers[-1], specs[-1])
    return tp.whole(h, sharded)[..., 0]  # [B]


def forward(params, cfg: MLPConfig, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
            detach_cut: bool = True) -> torch.Tensor:
    """The whole model in one trust domain, as ``repro.models.mlp.forward``,
    with the standard-normal model ``noise`` in the place of its key."""
    h = client_forward(params, cfg, x, noise)
    if detach_cut:
        h = h.detach()
    return server_forward(params, cfg, h)  # splitlint: ignore[SPL101]
