"""Federated-learning (FedAvg) baseline, the comparison system of paper
Table 5, as ``repro.core.fedavg``. Every client owns a FULL copy of the
network, trains locally on its own shard, and the server averages the local
models weighted by data share.

Randomness is an input, as in the rest of the port. Batch indices come from
the caller's NumPy generator, drawn as the reference draws them, so they
equal the JAX package's. The guard's noise for (round, client, local step)
comes from ``noise_fn(round, client, step, shape)`` where one is given (a
test feeds the JAX package's fold-in draws), else from a CPU generator
seeded from ``(seed, round, client, step)``, so one seed gives the same
draws on the card and on the CPU and a resumed run continues the stream.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import seeded_generator
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core.adapters import SplitAdapter
from repro_torch.core.trainer import SplitTrainConfig
from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.privacy.guard import PrivacyGuard

# (round, client, local step, shape) -> standard-normal guard noise
NoiseFn = Callable[[int, int, int, Tuple[int, ...]], Any]


def make_local_sgd(adapter: SplitAdapter, tc: SplitTrainConfig, opt: Optimizer):
    """One client's full-model step: ``local_sgd(params, opt_state, x, y,
    step, guard_noise=None) -> (params, opt_state, loss)``.

    The forward is the whole model: the client stage with no model noise,
    the ``PrivacyGuard`` at the cut when ``tc.privacy`` is set (features
    never leave the client under FedAvg, but the same mechanism keeps the
    utility comparison with split learning fair, and the accountant counts
    the releases), then the trunk and the loss. The gradient covers both
    halves; then ``clip_by_global_norm`` at ``tc.grad_clip`` and
    ``opt.update`` at the int32 ``step``. ``guard_noise`` is read only when
    the guard's sigma is above 0."""
    guard = PrivacyGuard(tc.privacy)

    def local_sgd(params, opt_state, x, y, step, guard_noise=None):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            feats = adapter.client_forward(live["client"], x, None)
            if guard.enabled:
                feats = guard.release_with_noise(feats, guard_noise)
            loss = adapter.loss(adapter.server_forward(live["server"], feats), y)
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grad_of = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)}
        with torch.no_grad():
            grads, _ = clip_by_global_norm(tree_map(lambda p: grad_of[id(p)], live), tc.grad_clip)
            updates, opt_state = opt.update(grads, opt_state, params, step)
            return apply_updates(params, updates), opt_state, loss.detach()

    return local_sgd


def average_models(models: Sequence[Any], weights: Sequence[float]) -> Any:
    """The weighted average of the local models, leaf by leaf, as the
    reference computes it: each weight rounded to float32, then
    ``w_0 p_0 + w_1 p_1 + ...`` in client order."""
    w32 = [float(np.float32(w)) for w in weights]
    return tree_map(lambda *ps: sum(w * p for w, p in zip(w32, ps)), *models)


def fedavg_rounds(
    adapter: SplitAdapter,
    tc: SplitTrainConfig,
    opt: Optimizer,
    shards: Sequence[Tuple[np.ndarray, np.ndarray]],
    global_params: Any,
    *,
    rounds: int,
    local_steps: int,
    local_batch: int = 32,
    rng: Optional[np.random.Generator] = None,
    round_offset: int = 0,
    local_sgd: Optional[Callable] = None,
    eval_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
    seed: int = 0,
    noise_fn: Optional[NoiseFn] = None,
) -> Tuple[Any, List[Dict[str, float]]]:
    """The FedAvg loop from ``global_params`` (on their device); resumable
    through ``round_offset``, which keeps the optimizer's step count
    (``round * local_steps + step``) and the noise stream absolute across
    calls. Each round every client starts from the global model with a
    fresh optimizer state and takes ``local_steps`` steps on batches of
    ``min(local_batch, len(shard))`` rows drawn with ``rng.integers``; the
    new global model is the share-weighted average (:func:`average_models`).
    Returns the global model and one record a round: ``round``,
    ``mean_local_loss`` (of each client's last step) and ``eval_fn``'s
    metrics as ``val_`` keys."""
    n = tc.n_clients
    weights = np.asarray(tc.data_shares, np.float64)
    weights = weights / weights.sum()
    rng = rng if rng is not None else np.random.default_rng(0)
    local_sgd = local_sgd if local_sgd is not None else make_local_sgd(adapter, tc, opt)
    noisy = PrivacyGuard(tc.privacy).sigma > 0.0
    device = tree_leaves(global_params)[0].device
    data = [(torch.as_tensor(np.asarray(x), device=device),
             torch.as_tensor(np.asarray(y), device=device)) for x, y in shards]

    def guard_noise(rnd, c, s, x_shape):
        if not noisy:
            return None
        shape = tuple(adapter.feature_shape(tuple(x_shape)))
        if noise_fn is not None:
            return torch.tensor(np.asarray(noise_fn(rnd, c, s, shape)), dtype=torch.float32,
                                device=device)
        return torch.randn(shape, generator=seeded_generator(seed, rnd, c, s)).to(device)

    history: List[Dict[str, float]] = []
    for rnd in range(round_offset, round_offset + rounds):
        locals_: List[Any] = []
        losses = []
        for c in range(n):
            # the local step never writes in place, so each client starts
            # from the global tensors themselves
            params = global_params
            opt_state = opt.init(params)
            x_c, y_c = data[c]
            for s in range(local_steps):
                idx = rng.integers(0, len(x_c), size=min(local_batch, len(x_c)))
                ix = torch.as_tensor(idx, device=device)
                params, opt_state, loss = local_sgd(
                    params, opt_state, x_c[ix], y_c[ix],
                    torch.tensor(rnd * local_steps + s, dtype=torch.int32, device=device),
                    guard_noise(rnd, c, s, (len(idx),) + tuple(x_c.shape[1:])),
                )
            locals_.append(params)
            losses.append(float(loss))
        # weighted parameter averaging (only the models leave the clients)
        global_params = average_models(locals_, weights)
        rec = {"round": rnd, "mean_local_loss": float(np.mean(losses))}
        if eval_fn is not None:
            rec.update({f"val_{k}": v for k, v in eval_fn(global_params).items()})
        history.append(rec)
    return global_params, history


def train_fedavg(
    adapter: SplitAdapter,
    tc: SplitTrainConfig,
    opt: Optimizer,
    shards: Sequence[Tuple[np.ndarray, np.ndarray]],
    *,
    rounds: int,
    local_steps: int,
    local_batch: int = 32,
    seed: int = 0,
    eval_fn=None,
    device=None,
) -> Tuple[Any, List[Dict[str, float]]]:
    """Deprecated shim: use ``SplitSession(engine="fedavg")``. Returns
    (global_params, history), global_params = {"client", "server"} (the full
    model; FL shares everything). ``device`` ``None`` is the card."""
    warnings.warn(
        "train_fedavg is deprecated; use SplitSession(engine='fedavg')",
        DeprecationWarning, stacklevel=2,
    )
    from repro_torch.core.session import SplitSession

    wrapped = None
    if eval_fn is not None:
        def wrapped(canonical):  # the legacy eval_fn expects the full model
            client0 = tree_map(lambda a: a[0], canonical["client_banks"])
            return eval_fn({"client": client0, "server": canonical["server"]})

    session = SplitSession(adapter, tc, opt, engine="fedavg", seed=seed, device=device,
                           local_batch=local_batch)
    history = session.fit(shards, epochs=rounds, steps_per_epoch=local_steps, eval_fn=wrapped)
    return session.native_state["params"], history
