"""Split-model adapters: one (init / client_forward / server_forward / loss /
metrics) interface over the paper's CNN, VGG19 and MLP models, as
``repro.core.adapters``.

Differences from the JAX adapters: ``init`` takes ``(generator, device)``;
``client_forward`` takes pre-drawn standard-normal model noise where the JAX
one takes a key; and ``feature_shape`` gives the released feature map's
shape for an input shape, so a caller can draw that noise first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.paper_models import CNNConfig, MLPConfig
from repro_torch.metrics.losses import (
    bce_with_logits,
    binary_accuracy,
    ce_with_logits,
    mse,
    msle,
    multiclass_accuracy,
    rmsle,
    smape,
)
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import mlp as mlp_mod


@dataclasses.dataclass(frozen=True)
class SplitAdapter:
    name: str
    init: Callable[..., Any]  # (generator, device) -> params {"client","server"}
    client_forward: Callable[..., Any]  # (client_params, x, noise) -> features
    server_forward: Callable[..., Any]  # (server_params, features) -> outputs
    loss: Callable[[Any, Any], torch.Tensor]
    metrics: Callable[[Any, Any], Dict[str, torch.Tensor]]
    feature_shape: Callable[[Tuple[int, ...]], Tuple[int, ...]]  # input -> release shape


def cnn_adapter(cfg: CNNConfig) -> SplitAdapter:
    if cfg.loss == "bce":
        loss = bce_with_logits
        metrics = lambda out, y: {
            "loss": bce_with_logits(out, y),
            "accuracy": binary_accuracy(out, y),
        }
    else:  # multiclass
        loss = ce_with_logits
        metrics = lambda out, y: {
            "loss": ce_with_logits(out, y),
            "accuracy": multiclass_accuracy(out, y),
        }
    return SplitAdapter(
        name=cfg.name,
        init=lambda generator, device=None: cnn_mod.init_cnn(generator, cfg, device),
        client_forward=lambda cp, x, noise=None: cnn_mod.client_forward(
            {"client": cp}, cfg, x, noise
        ),
        server_forward=lambda sp, f: cnn_mod.server_forward({"server": sp}, cfg, f),
        loss=loss,
        metrics=metrics,
        feature_shape=lambda shape: cnn_mod.feature_shape(cfg, shape),
    )


def mlp_adapter(cfg: MLPConfig) -> SplitAdapter:
    def metrics(out, y):
        return {
            "loss": mse(out, y),
            "msle": msle(out, y),
            "rmsle": rmsle(out, y),
            "smape": smape(out, y),
        }

    return SplitAdapter(
        name=cfg.name,
        init=lambda generator, device=None: mlp_mod.init_mlp(generator, cfg, device),
        client_forward=lambda cp, x, noise=None: mlp_mod.client_forward(
            {"client": cp}, cfg, x, noise
        ),
        server_forward=lambda sp, f: mlp_mod.server_forward({"server": sp}, cfg, f),
        loss=mse,
        metrics=metrics,
        feature_shape=lambda shape: mlp_mod.feature_shape(cfg, shape),
    )
