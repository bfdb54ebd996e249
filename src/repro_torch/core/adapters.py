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
the JAX package's vmapped ones do. The client stage runs as the adapter's
``fleet_client_forward`` where it has one (the CNN's: one banked
``privacy_conv`` launch a single-conv kernel stage, over every client),
else as a loop over the clients, since every client's bank differs; the
loss and the metrics loop. ``fleet_release_forward`` is the queue engines'
production cycle: N items, each on its own client's bank, through the same
``fleet_client_forward``.
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
    # (stacked_banks, bank_of, xs, noise) -> features [N, b, ...] of N
    # items, item n on bank bank_of[n] (a host sequence); None:
    # client_forward item by item
    fleet_client_forward: Optional[Callable[..., Any]] = None
    # (server_params, features, tp) -> outputs: server_forward tensor-parallel
    # over a mesh's model axis (tp a sharding.tensor_parallel.TrunkParallel);
    # None: the adapter's trunk has no such path
    server_forward_tp: Optional[Callable[..., Any]] = None


def _client_features(adapter: SplitAdapter, banks, bank_of, xs, model_noise):
    """The privacy layer of N items, item n on bank ``bank_of[n]`` (a host
    sequence): ``adapter.fleet_client_forward``, or ``client_forward`` item
    by item on views of the stacked banks for an adapter without one."""
    if adapter.fleet_client_forward is not None:
        return adapter.fleet_client_forward(banks, bank_of, xs, model_noise)
    return torch.stack([
        adapter.client_forward(tree_map(lambda a, c=c: a[c], banks), xs[n],
                               None if model_noise is None else model_noise[n])
        for n, c in enumerate(bank_of)])


def _release_rows(guard, feats, guard_noise, plan_rows):
    """The guard's release ONCE over the ``[N*b, ...]`` rows of ``feats``
    ``[N, b, ...]``: its clip is per row, so that equals a release per
    item."""
    rows = feats.reshape((-1,) + tuple(feats.shape[2:]))
    noise = None if guard_noise is None else guard_noise.reshape(rows.shape)
    return guard.release_with_noise(rows, noise, plan_rows).reshape(feats.shape)


def banked_client_forward(adapter: SplitAdapter, guard=None) -> Callable[..., torch.Tensor]:
    """``(stacked_banks, xs, model_noise, guard_noise=None) -> features
    [C, b, ...]``: stacked banks (every leaf ``[C, ...]``), batches
    ``[C, b, ...]``, standard-normal model noise ``[C, b, ...]`` of the
    features' shape (``None``: no model noise) and, with an enabled
    ``PrivacyGuard``, its noise ``[C, b, ...]``.

    Client c runs on bank c, all C at once through
    ``adapter.fleet_client_forward`` where the adapter has one (the CNN
    with the kernel on: one differentiable banked ``privacy_conv`` launch a
    single-conv stage a step, the counterpart of the reference's
    ``jax.vmap`` of ``client_forward``), else one ``client_forward`` a
    client. The guard's release then runs ONCE over the ``[C*b, ...]``
    rows (one ``dp_release`` call a step). ``plan_rows``: the whole
    release's rows where ``banks`` are a rank's share of a mesh's clients
    (``dp_release``'s plan is chosen for them)."""
    guarded = guard is not None and guard.enabled

    def fwd(banks, xs, model_noise=None, guard_noise=None, plan_rows=None):
        feats = _client_features(adapter, banks, range(xs.shape[0]), xs, model_noise)
        return _release_rows(guard, feats, guard_noise, plan_rows) if guarded else feats

    return fwd


def fleet_release_forward(adapter: SplitAdapter, guard=None) -> Callable[..., torch.Tensor]:
    """``(stacked_banks, bank_of, xs, model_noise=None, guard_noise=None,
    plan_rows=None) -> features [N, b, ...]``: a production cycle of N
    queue items, item n with batch ``xs[n]`` on bank ``bank_of[n]`` (a host
    sequence) and its noise ``model_noise[n]``, ``guard_noise[n]``.

    The privacy layer runs as ``adapter.fleet_client_forward`` (the CNN's:
    one banked ``privacy_conv`` launch a single-conv kernel stage) or, for
    an adapter without one, ``client_forward`` item by item on views of the
    stacked banks. The guard's release then runs ONCE over the ``[N*b,
    ...]`` rows (one ``dp_release`` call a cycle). Per item the result is
    what ``client_forward`` and the guard give one item. ``plan_rows``: the
    whole cycle's rows where this is a rank's share of a mesh's items."""
    guarded = guard is not None and guard.enabled

    def fwd(banks, bank_of, xs, model_noise=None, guard_noise=None, plan_rows=None):
        feats = _client_features(adapter, banks, bank_of, xs, model_noise)
        return _release_rows(guard, feats, guard_noise, plan_rows) if guarded else feats

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
        fleet_client_forward=lambda banks, bank_of, xs, noise=None: cnn_mod.fleet_client_forward(
            {"client": banks}, cfg, bank_of, xs, noise),
        server_forward_tp=lambda sp, f, tp: cnn_mod.server_forward_tp({"server": sp}, cfg, f, tp),
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
        server_forward_tp=lambda sp, f, tp: mlp_mod.server_forward_tp({"server": sp}, cfg, f, tp),
    )
