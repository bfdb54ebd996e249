"""Split-model adapters: one (init / client_forward / server_forward / loss /
metrics) interface over the paper's CNN, VGG19 and MLP models, as
``repro.core.adapters``.

Differences from the JAX adapters: ``init`` takes ``(generator, device)``;
``client_forward`` takes pre-drawn standard-normal model noise where the JAX
one takes a key; ``feature_shape`` gives the released feature map's shape
for an input shape, and ``noise_scale`` the model noise's scale, so a
caller knows whether to draw that noise and can draw it first.

The banked views (``banked_client_forward``, ``per_client_loss``,
``per_client_metrics``) take a leading client axis C on every argument, as
the JAX package's vmapped ones do; here they loop over the clients, since
every client's bank differs. ``fleet_release_forward`` is the queue
engines' production cycle: N items, each on its own client's bank, with the
CNN's single-conv kernel stages in one banked ``privacy_conv`` launch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.common.tree import tree_map
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
    noise_scale: float = 0.0  # the model noise's scale in client_forward
    # (stacked_banks, cids, xs, noise) -> features [N, b, ...] of N items,
    # item n on bank cids[n]; None: client_forward item by item
    fleet_client_forward: Optional[Callable[..., Any]] = None


def banked_client_forward(adapter: SplitAdapter, guard=None) -> Callable[..., torch.Tensor]:
    """``(stacked_banks, xs, model_noise, guard_noise=None) -> features
    [C, b, ...]``: stacked banks (every leaf ``[C, ...]``), batches
    ``[C, b, ...]``, standard-normal model noise ``[C, b, ...]`` of the
    features' shape (``None``: no model noise) and, with an enabled
    ``PrivacyGuard``, its noise ``[C, b, ...]``.

    Each client's privacy layer runs on its own bank (one ``privacy_conv``
    launch a client where the model has the kernel on). The guard's release
    then runs ONCE over the ``[C*b, ...]`` rows: its clip is per row, so
    that equals a release per client (one ``dp_release`` call a step)."""
    guarded = guard is not None and guard.enabled

    def fwd(banks, xs, model_noise=None, guard_noise=None):
        feats = torch.stack([
            adapter.client_forward(tree_map(lambda a, c=c: a[c], banks), xs[c],
                                   None if model_noise is None else model_noise[c])
            for c in range(xs.shape[0])])
        if not guarded:
            return feats
        rows = feats.reshape((-1,) + tuple(feats.shape[2:]))
        noise = None if guard_noise is None else guard_noise.reshape(rows.shape)
        return guard.release_with_noise(rows, noise).reshape(feats.shape)

    return fwd


def fleet_release_forward(adapter: SplitAdapter, guard=None) -> Callable[..., torch.Tensor]:
    """``(stacked_banks, cids, xs, model_noise=None, guard_noise=None) ->
    features [N, b, ...]``: a production cycle of N queue items, item n with
    batch ``xs[n]`` on bank ``cids[n]`` (``cids`` an int32 tensor on the
    items' device) and its noise ``model_noise[n]``, ``guard_noise[n]``.

    The privacy layer runs as ``adapter.fleet_client_forward`` (the CNN's:
    one banked ``privacy_conv`` launch a single-conv kernel stage) or, for
    an adapter without one, ``client_forward`` item by item on views of the
    stacked banks. The guard's release then runs ONCE over the ``[N*b,
    ...]`` rows: its clip is per row, so that equals a release per item (one
    ``dp_release`` call a cycle). Per item the result is what
    ``client_forward`` and the guard give one item."""
    guarded = guard is not None and guard.enabled

    def fwd(banks, cids, xs, model_noise=None, guard_noise=None):
        if adapter.fleet_client_forward is not None:
            feats = adapter.fleet_client_forward(banks, cids, xs, model_noise)
        else:
            feats = torch.stack([
                adapter.client_forward(tree_map(lambda a, c=c: a[c], banks), xs[n],
                                       None if model_noise is None else model_noise[n])
                for n, c in enumerate(cids.tolist())])
        if not guarded:
            return feats
        rows = feats.reshape((-1,) + tuple(feats.shape[2:]))
        noise = None if guard_noise is None else guard_noise.reshape(rows.shape)
        return guard.release_with_noise(rows, noise).reshape(feats.shape)

    return fwd


def per_client_loss(adapter: SplitAdapter) -> Callable[..., torch.Tensor]:
    """(outputs [C, b, ...], labels [C, b, ...]) -> per-client losses [C]."""
    return lambda out, y: torch.stack([adapter.loss(out[c], y[c]) for c in range(out.shape[0])])


def per_client_metrics(adapter: SplitAdapter) -> Callable[..., Dict[str, torch.Tensor]]:
    """(outputs [C, b, ...], labels [C, b, ...]) -> {metric: [C]}."""
    def metrics(out, y):
        per = [adapter.metrics(out[c], y[c]) for c in range(out.shape[0])]
        return {k: torch.stack([m[k] for m in per]) for k in per[0]}

    return metrics


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
        noise_scale=cfg.privacy_noise,
        fleet_client_forward=lambda banks, cids, xs, noise=None: cnn_mod.fleet_client_forward(
            {"client": banks}, cfg, cids, xs, noise),
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
        noise_scale=cfg.privacy_noise,
    )
