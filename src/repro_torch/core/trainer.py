"""The spatio-temporal split-learning trainers (paper Alg. 1), as
``repro.core.trainer``: the fused engine, the looped reference and
evaluation.

The fused engine keeps the JAX package's layout and math:

  * per-client parameter banks are stacked into one tree whose leaves have
    a leading client axis C, and the privacy layer runs over that axis
    (``banked_client_forward``: one client forward a bank, then ONE guard
    release over the ``[C*b, ...]`` rows);
  * every client contributes a homogeneous per-step batch
    (``fused_client_batch``); the paper's share-weighted (7:2:1) mix is the
    per-client loss weights ``client_weights``;
  * the trainable parameters are ONE flat buffer (``common.tree.ravel``, in
    ``ravel_pytree``'s leaf order): the server trunk alone in ``detached``
    mode (the temporal split, with ``.detach()`` at the cut), the stacked
    banks and the server in ``e2e`` mode, where the gradient runs back
    through the client stage, through ``privacy_conv``'s and
    ``dp_release``'s plain backward passes where the kernels are on;
  * the global gradient clip and the optimizer act on the flat buffer, and
    the optimizer's state is flat buffers, as the JAX engine's;
  * the (ε, δ) budget advances inside the canonical state: once per epoch
    in ``scan`` mode, once per step in ``stepwise`` mode, as the reference.

Randomness is an input, as in the JAX engine's scan path: a
:class:`SamplePlan` holds an epoch's batch indices and standard-normal model
and guard noise, drawn by ``make_sample_plan`` from one ``torch.Generator``
(or fed from the JAX package by a test), and ``run_epoch`` never draws.
Both epoch modes run the same Python loop of steps; they differ only in
when the budget advances.

``make_looped_step`` is the seed's per-client Python loop (concatenated
per-client batches, an unweighted loss, tree-shaped optimizer state), the
numerical reference.

The queue engines' server half: ``make_server_step`` is one trunk update on
one popped batch (``protocol.SplitServer``), and
``make_server_bank_runner`` the fused-queue engine's replay of a bank of
arrivals, a loop over the slots that calls the same step.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import ravel, tree_leaves, tree_map
from repro_torch.core.adapters import (
    SplitAdapter,
    banked_client_forward,
    per_client_loss,
    per_client_metrics,
)
from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.privacy.accountant import budget_advance, budget_init
from repro_torch.privacy.guard import DPConfig, PrivacyGuard


@dataclasses.dataclass(frozen=True)
class SplitTrainConfig:
    n_clients: int = 3
    data_shares: Tuple[float, ...] = (0.7, 0.2, 0.1)
    server_batch: int = 64
    mode: str = "detached"  # detached (paper) | e2e (classic split learning)
    # the PrivacyGuard every engine applies at the cut (None = guard off)
    privacy: Optional[DPConfig] = None
    # gradient global-norm clip of the trainable update
    grad_clip: float = 1.0
    # DEPRECATED, mapped onto the fields above in __post_init__ with a
    # DeprecationWarning, as in the reference: ``privacy_noise`` becomes an
    # unclipped guard, ``clip_norm`` (always the gradient clip) ``grad_clip``
    privacy_noise: float = 0.0
    clip_norm: Optional[float] = None

    def __post_init__(self):
        # consumed (mapped, then cleared) so that dataclasses.replace()
        # cannot re-apply them over explicitly set new fields
        if self.clip_norm is not None:
            warnings.warn(
                "SplitTrainConfig.clip_norm is deprecated (it is the GRADIENT "
                "clip); use grad_clip=",
                DeprecationWarning, stacklevel=3,
            )
            object.__setattr__(self, "grad_clip", float(self.clip_norm))
            object.__setattr__(self, "clip_norm", None)
        if self.privacy_noise != 0.0:
            warnings.warn(
                "SplitTrainConfig.privacy_noise is deprecated; use "
                "privacy=DPConfig(clip_norm=None, noise_scale=...), which "
                "reproduces the legacy perturbation when clipping is disabled",
                DeprecationWarning, stacklevel=3,
            )
            if self.privacy is None:
                object.__setattr__(
                    self, "privacy",
                    DPConfig(clip_norm=None, noise_scale=float(self.privacy_noise)),
                )
            object.__setattr__(self, "privacy_noise", 0.0)


def client_batch_sizes(tc: SplitTrainConfig) -> List[int]:
    """Per-step client contributions ∝ data shares, summing to server_batch
    (largest remainder; every client gets ≥ 1 sample whenever
    ``server_batch >= n_clients``)."""
    shares = tc.data_shares
    n = len(shares)
    total = float(sum(shares))
    raw = [s / total * tc.server_batch for s in shares]
    sizes = [int(r) for r in raw]
    by_remainder = sorted(
        range(n), key=lambda j: (raw[j] - sizes[j], shares[j]), reverse=True
    )
    for j in by_remainder[: tc.server_batch - sum(sizes)]:
        sizes[j] += 1
    if tc.server_batch >= n:
        while any(s == 0 for s in sizes):
            sizes[max(range(n), key=lambda j: sizes[j])] -= 1
            sizes[sizes.index(0)] += 1
    return sizes


def fused_client_batch(tc: SplitTrainConfig) -> int:
    """Homogeneous per-client batch of the fused engine; the share mix
    becomes loss weights instead (``client_weights``)."""
    return max(1, tc.server_batch // tc.n_clients)


def client_weights(tc: SplitTrainConfig, device=None) -> torch.Tensor:
    """Normalized float32 per-client loss weights (the shares), on
    ``device`` (``None``: the CPU; they are a constant of the config)."""
    w = torch.tensor(tc.data_shares, dtype=torch.float32)
    return (w / torch.sum(w)).to(device or "cpu")


def stack_batches(batches: Sequence[Tuple[Any, Any]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """List of equal-size per-client (x, y) -> stacked ([C, b, ...], [C, b])."""
    xs = torch.stack([torch.as_tensor(np.asarray(x)) for x, _ in batches])
    ys = torch.stack([torch.as_tensor(np.asarray(y)) for _, y in batches])
    return xs, ys


def finite_mean(values) -> float:
    """Mean over the FINITE entries of ``values``; NaN when there are none."""
    arr = np.asarray(values, np.float64)
    arr = arr[np.isfinite(arr)]
    return float(arr.mean()) if arr.size else float("nan")


def single_client_config(tc: SplitTrainConfig) -> SplitTrainConfig:
    """The conventional-split-learning baseline config: ONE client, all data."""
    return dataclasses.replace(tc, n_clients=1, data_shares=(1.0,))


def stack_pytrees(trees: Sequence[Any]) -> Any:
    """[tree, tree, ...] -> one tree whose leaves gain a leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack_pytree(tree: Any, n: int) -> List[Any]:
    """Inverse of ``stack_pytrees`` for a known leading-axis length."""
    return [tree_map(lambda a, c=c: a[c], tree) for c in range(n)]


def _client_banks_list(banks) -> List[Any]:
    """Canonical stacked banks (or the looped path's list) -> list of banks."""
    if isinstance(banks, (list, tuple)):
        return list(banks)
    return unstack_pytree(banks, tree_leaves(banks)[0].shape[0])


# ------------------------------------------------------------------ data
def device_put_shards(shards: Sequence[Tuple[np.ndarray, np.ndarray]], device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack ragged per-client shards into padded tensors on ``device``
    (``None``: the card): (data_x [C, N_max, ...], data_y [C, N_max, ...],
    lens [C] int32). Float padding is NaN on purpose: the sampler draws
    indices in ``[0, lens[c])``, so a bug that reads padding poisons the
    loss visibly."""
    device = resolve_device(device)
    if not all(len(x) > 0 for x, _ in shards):
        raise ValueError("empty client shard")
    n_max = max(len(x) for x, _ in shards)

    def pad(a):
        a = np.asarray(a)
        if len(a) == n_max:
            return a
        fill = np.nan if np.issubdtype(a.dtype, np.floating) else 0
        p = np.full((n_max - len(a),) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, p], axis=0)

    data_x = torch.as_tensor(np.stack([pad(x) for x, _ in shards]), device=device)
    data_y = torch.as_tensor(np.stack([pad(y) for _, y in shards]), device=device)
    lens = torch.tensor([len(x) for x, _ in shards], dtype=torch.int32, device=device)
    return data_x, data_y, lens


@dataclasses.dataclass
class SamplePlan:
    """One epoch's randomness, the port's counterpart of the JAX plan's
    ``(idx, step_keys)``: batch indices ``idx [T, C, b]`` (int64, each
    client's within its shard) and standard-normal noise of the released
    features' shape, ``[T, C, b, ...]``: the model noise of the clients'
    privacy layers (``None`` when the model adds none) and the guard's
    (``None`` when the guard adds none)."""

    idx: torch.Tensor
    model_noise: Optional[torch.Tensor] = None
    guard_noise: Optional[torch.Tensor] = None

    def to(self, device) -> "SamplePlan":
        move = lambda t: None if t is None else t.to(device)
        return SamplePlan(move(self.idx), move(self.model_noise), move(self.guard_noise))


def make_sample_plan(adapter: SplitAdapter, tc: SplitTrainConfig, steps_per_epoch: int):
    """``sample_plan(lens, sample_shape, generator, device=None) ->
    SamplePlan``: the whole epoch's plan from one ``torch.Generator``, drawn
    on the generator's device in a fixed order (each client's indices, then
    the model noise, then the guard noise) and moved to ``device``
    (``None``: the card). ``sample_shape`` is one input sample's shape. A
    CPU generator gives the same plan whatever ``device`` is."""
    c, b, t = tc.n_clients, fused_client_batch(tc), steps_per_epoch
    guard = PrivacyGuard(tc.privacy)

    def sample_plan(lens, sample_shape, generator: torch.Generator, device=None) -> SamplePlan:
        device = resolve_device(device)
        gdev = generator.device
        idx = torch.stack([
            torch.randint(0, int(n), (t, b), generator=generator, device=gdev)
            for n in torch.as_tensor(lens).tolist()], dim=1)
        feat = (t, c) + tuple(adapter.feature_shape((b,) + tuple(sample_shape)))
        draw = lambda: torch.randn(feat, generator=generator, device=gdev)
        model = draw() if adapter.noise_scale > 0.0 else None
        guard_noise = draw() if guard.sigma > 0.0 else None
        return SamplePlan(idx, model, guard_noise).to(device)

    return sample_plan


# ------------------------------------------------------------------ steps
def _make_fused(adapter: SplitAdapter, tc: SplitTrainConfig, opt: Optimizer, device=None):
    """Shared core of the fused engine: (init_state, step_core,
    trainable_of, with_trainable, step_flat)."""
    device = resolve_device(device)
    detached = tc.mode == "detached"
    weights = client_weights(tc, device)
    guard = PrivacyGuard(tc.privacy)
    fwd = banked_client_forward(adapter, guard=guard)
    loss_banked = per_client_loss(adapter)
    metrics_banked = per_client_metrics(adapter)

    def init_state(generator: torch.Generator):
        """Server trunk from the first full init drawn from ``generator``,
        then each client's bank from one more full init each."""
        server_params = adapter.init(generator, device)["server"]
        banks = [adapter.init(generator, device)["client"] for _ in range(tc.n_clients)]
        client_banks = stack_pytrees(banks)
        trainable = server_params if detached else (client_banks, server_params)
        # the optimizer state lives in the FLAT domain, as the reference's
        return {
            "client_banks": client_banks,
            "server": server_params,
            "opt": opt.init(ravel(trainable)[0]),
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "privacy": budget_init(device),
        }

    def loss_from(client_banks, server_params, xs, ys, model_noise, guard_noise):
        feats = fwd(client_banks, xs, model_noise, guard_noise)  # [C, b, ...]
        if detached:
            feats = feats.detach()
        c, b = feats.shape[0], feats.shape[1]
        out = adapter.server_forward(server_params, feats.reshape((c * b,) + feats.shape[2:]))
        out_cb = out.reshape((c, b) + out.shape[1:])
        return torch.sum(weights * loss_banked(out_cb, ys)), out_cb

    def trainable_of(state):
        return state["server"] if detached else (state["client_banks"], state["server"])

    def with_trainable(state, trainable, new_opt):
        """One optimizer step = one guarded release per client: the step
        and the budget advance by one."""
        priv = budget_advance(state["privacy"], tc.privacy)
        new = {**state, "opt": new_opt, "step": state["step"] + 1, "privacy": priv}
        if detached:
            return {**new, "server": trainable}
        cb, sp = trainable
        return {**new, "client_banks": cb, "server": sp}

    def step_flat(flat, opt_state, step, banks, unravel, xs, ys, model_noise=None,
                  guard_noise=None):
        """One fused step in the FLAT parameter domain: the model reads
        views of the one trainable buffer, the gradient comes back flat,
        and clip and update are whole-buffer ops."""
        fl = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            if detached:
                loss, out = loss_from(banks, unravel(fl), xs, ys, model_noise, guard_noise)
            else:
                cb, sp = unravel(fl)
                loss, out = loss_from(cb, sp, xs, ys, model_noise, guard_noise)
            (grads,) = torch.autograd.grad(loss, fl)
        with torch.no_grad():
            gnorm = torch.sqrt(torch.sum(torch.square(grads)))
            scale = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            updates, new_opt = opt.update(grads * scale, opt_state, flat, step)
            # share-weighted per-client means of every metric
            per = metrics_banked(out.detach(), ys)
            metrics = {k: torch.sum(weights * v) for k, v in per.items()}
            metrics["grad_norm"] = gnorm
            return flat.detach() + updates, new_opt, metrics

    def step_core(state, xs, ys, model_noise=None, guard_noise=None):
        flat, unravel = ravel(trainable_of(state))
        new_flat, new_opt, metrics = step_flat(
            flat, state["opt"], state["step"], state["client_banks"], unravel,
            xs, ys, model_noise, guard_noise,
        )
        return with_trainable(state, unravel(new_flat), new_opt), metrics

    return init_state, step_core, trainable_of, with_trainable, step_flat


def make_spatio_temporal_step(adapter: SplitAdapter, tc: SplitTrainConfig, opt: Optimizer,
                              device=None):
    """The fused engine step: (init_state, step) with ``step(state, xs, ys,
    model_noise=None, guard_noise=None)`` on stacked per-client batches
    ``[C, b, ...]`` of size ``fused_client_batch(tc)`` and their noise."""
    init_state, step_core, *_ = _make_fused(adapter, tc, opt, device)
    return init_state, step_core


def make_looped_step(adapter: SplitAdapter, tc: SplitTrainConfig, opt: Optimizer,
                     device=None):
    """The seed per-client Python-loop step (the reference).

    ``step(state, batches, model_noise=None, guard_noise=None)`` with
    ``batches`` a list of (x_c, y_c) and the noise per client (a ``[C, b,
    ...]`` tensor or a list). The state keeps a LIST of client banks and
    tree-shaped optimizer moments."""
    device = resolve_device(device)
    detached = tc.mode == "detached"
    guard = PrivacyGuard(tc.privacy)

    def init_state(generator: torch.Generator):
        server_params = adapter.init(generator, device)["server"]
        client_banks = [adapter.init(generator, device)["client"] for _ in range(tc.n_clients)]
        trainable = server_params if detached else (client_banks, server_params)
        return {
            "client_banks": client_banks,
            "server": server_params,
            "opt": opt.init(trainable),
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "privacy": budget_init(device),
        }

    def loss_from(client_banks, server_params, batches, model_noise, guard_noise):
        feats, labels = [], []
        for c, (x_c, y_c) in enumerate(batches):
            f = adapter.client_forward(client_banks[c], x_c,
                                       None if model_noise is None else model_noise[c])
            if guard.enabled:
                f = guard.release_with_noise(f, None if guard_noise is None else guard_noise[c])
            if detached:
                f = f.detach()
            feats.append(f)
            labels.append(y_c)
        fcat = torch.cat(feats, dim=0)  # paper Alg.1 l.11: concat features
        ycat = torch.cat(labels, dim=0)
        out = adapter.server_forward(server_params, fcat)
        return adapter.loss(out, ycat), out, ycat

    def step(state, batches, model_noise=None, guard_noise=None):
        trainable = state["server"] if detached else (state["client_banks"], state["server"])
        params = tree_map(lambda p: p.detach().requires_grad_(True), trainable)
        with torch.enable_grad():
            cb, sp = (state["client_banks"], params) if detached else params
            loss, out, ycat = loss_from(cb, sp, batches, model_noise, guard_noise)
            leaves = tree_leaves(params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grad_of = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)}
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(tree_map(lambda p: grad_of[id(p)], params),
                                               tc.grad_clip)
            updates, new_opt = opt.update(grads, state["opt"], trainable, state["step"])
            new = apply_updates(trainable, updates)
            metrics = adapter.metrics(out.detach(), ycat)
        metrics["grad_norm"] = gnorm
        new_state = {**state, "opt": new_opt, "step": state["step"] + 1,
                     "privacy": budget_advance(state["privacy"], tc.privacy)}
        if detached:
            new_state["server"] = new
        else:
            new_state["client_banks"], new_state["server"] = new
        return new_state, metrics

    return init_state, step


def make_server_step(adapter: SplitAdapter, opt: Optimizer, grad_clip: float = 1.0):
    """One trunk update on one popped batch, the per-pop step of
    ``protocol.SplitServer`` (``repro/core/protocol.py:283-295``):
    ``step(server_params, opt_state, step, features, labels) -> (params,
    opt_state, loss)``: the gradient of the adapter loss in the trunk's
    parameters, leaf-wise ``clip_by_global_norm``, ``opt.update`` at the
    int32 ``step`` and ``apply_updates``. The moments stay trees."""

    def step(params, opt_state, step, features, labels):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = adapter.loss(adapter.server_forward(live, features), labels)
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grad_of = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)}
        with torch.no_grad():
            grads, _ = clip_by_global_norm(tree_map(lambda p: grad_of[id(p)], live), grad_clip)
            t = torch.tensor(int(step), dtype=torch.int32, device=leaves[0].device)
            updates, new_opt = opt.update(grads, opt_state, params, t)
            return apply_updates(params, updates), new_opt, loss.detach()

    return step


def make_server_bank_runner(adapter: SplitAdapter, opt: Optimizer, grad_clip: float = 1.0,
                            *, step_fn=None):
    """The fused-queue engine's server half: replay a stacked bank of queue
    arrivals as trunk updates, as ``repro.core.trainer.make_server_bank_runner``.

    ``run_bank(server_params, opt_state, step0, features, labels, valid) ->
    (server_params, opt_state, step, losses)``: ``features`` ``[K, b, ...]``
    in queue order, ``labels`` ``[K, b, ...]``, ``valid`` a ``[K]`` bool mask
    (``FeatureBank.stacked``). The reference's ``lax.scan`` is a Python loop
    here that calls ``step_fn`` (default :func:`make_server_step`), the very
    step ``protocol.SplitServer`` takes a pop, so a replay is bit for bit
    the per-pop run over the same items. An invalid slot is an identity
    update (parameters, moments and the step hold still) with a NaN loss."""
    step_fn = step_fn if step_fn is not None else make_server_step(adapter, opt, grad_clip)

    def run_bank(server_params, opt_state, step0, features, labels, valid):
        step = int(step0)
        losses = []
        for k, ok in enumerate(torch.as_tensor(valid).tolist()):
            if not ok:
                losses.append(torch.full((), float("nan"), device=features.device))
                continue
            server_params, opt_state, loss = step_fn(server_params, opt_state, step,
                                                     features[k], labels[k])
            losses.append(loss)
            step += 1
        return server_params, opt_state, step, torch.stack(losses)

    return run_bank


# ------------------------------------------------------------------ epochs
def make_epoch_runner(
    adapter: SplitAdapter,
    tc: SplitTrainConfig,
    opt: Optimizer,
    steps_per_epoch: int,
    *,
    mode: str = "scan",
    device=None,
):
    """Returns (init_state, run_epoch). ``run_epoch(state, data_x, data_y,
    plan)`` runs ``steps_per_epoch`` fused steps on the padded epoch data
    (``device_put_shards``) with the plan's indices and noise
    (``make_sample_plan``; it draws nothing itself) and returns (new_state,
    metrics), each metric stacked over the steps.

    The trainable tree is raveled once into the flat buffer the steps
    carry. ``mode="scan"`` advances the budget once for the epoch, as the
    reference's scan; ``mode="stepwise"`` once a step. Both run the same
    Python loop of steps."""
    if mode not in ("scan", "stepwise"):
        raise ValueError(f"mode must be 'scan' or 'stepwise', got {mode!r}")
    init_state, _, trainable_of, with_trainable, step_flat = _make_fused(adapter, tc, opt, device)

    def run_epoch(state, data_x, data_y, plan: SamplePlan):
        if plan.idx.shape[0] != steps_per_epoch:
            raise ValueError(f"plan has {plan.idx.shape[0]} steps, the runner "
                             f"{steps_per_epoch}")
        flat, unravel = ravel(trainable_of(state))
        banks = state["client_banks"]  # fixed over the epoch in detached mode
        opt_state, step, priv = state["opt"], state["step"], state["privacy"]
        rows = torch.arange(tc.n_clients, device=data_x.device)[:, None]
        ms = []
        for t in range(steps_per_epoch):
            idx_t = plan.idx[t]
            flat, opt_state, m = step_flat(
                flat, opt_state, step, banks, unravel,
                data_x[rows, idx_t], data_y[rows, idx_t],
                None if plan.model_noise is None else plan.model_noise[t],
                None if plan.guard_noise is None else plan.guard_noise[t],
            )
            step = step + 1
            if mode == "stepwise":
                priv = budget_advance(priv, tc.privacy)
            ms.append(m)
        if mode == "scan":
            priv = budget_advance(priv, tc.privacy, steps_per_epoch)
        new_state = {**with_trainable(state, unravel(flat), opt_state),
                     "step": step, "privacy": priv}
        return new_state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return init_state, run_epoch


# --------------------------------------------------------------------- eval
def _eval_forward(adapter: SplitAdapter, client, server, x, batch: int) -> torch.Tensor:
    """Eval-only forward with no noise, ``batch`` rows at a time, on the
    device of the server's parameters."""
    dev = tree_leaves(server)[0].device
    outs = []
    with torch.no_grad():
        for i in range(0, len(x), batch):
            xb = torch.as_tensor(np.ascontiguousarray(x[i: i + batch]), device=dev)
            # local scoring, not a release: no noise, and the evaluator
            # already holds the data it scores
            feats = adapter.client_forward(client, xb, None)
            outs.append(adapter.server_forward(server, feats))  # splitlint: ignore[SPL101]
    return torch.cat(outs, dim=0)


def _metrics_of(adapter: SplitAdapter, out: torch.Tensor, y) -> Dict[str, float]:
    y = torch.as_tensor(np.asarray(y), device=out.device)
    return {k: float(v) for k, v in adapter.metrics(out, y).items()}


def evaluate(adapter: SplitAdapter, state, x, y, batch: int = 512) -> Dict[str, float]:
    """Full-model eval using client bank 0 (server-side metric suite)."""
    client0 = _client_banks_list(state["client_banks"])[0]
    return _metrics_of(adapter, _eval_forward(adapter, client0, state["server"], x, batch), y)


def evaluate_per_client(
    adapter: SplitAdapter, state, x, y, *,
    batch: int = 512, weights: Optional[Sequence[float]] = None,
    identical_banks: bool = False,
) -> Dict[str, Any]:
    """One eval pass PER client bank over the canonical state: the
    share-weighted mean of every metric at the top level plus
    ``"per_client"``, each hospital's own metric dict. ``weights`` defaults
    to uniform; ``identical_banks=True`` scores one bank and repeats it."""
    banks = _client_banks_list(state["client_banks"])
    per = []
    for client in banks[:1] if identical_banks else banks:
        out = _eval_forward(adapter, client, state["server"], x, batch)
        per.append(_metrics_of(adapter, out, y))
    if identical_banks:
        per = per * len(banks)
    if weights is None:
        weights = [1.0 / len(banks)] * len(banks)
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    result: Dict[str, Any] = {
        k: float(sum(wc * p[k] for wc, p in zip(w, per))) for k in per[0]
    }
    result["per_client"] = per
    return result
