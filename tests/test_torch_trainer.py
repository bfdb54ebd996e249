"""The port's trainers against ``repro.core.trainer`` on the same state,
batches and noise.

The JAX side draws the epoch's plan (``make_sample_plan``: batch indices and
step keys); the port is fed the same indices and the draws the JAX engines
make from those keys: model noise ``normal(split(step_key, C)[c])`` (the
draw in ``add_privacy_noise`` and ``privacy_conv``) and guard noise
``normal(guard.key_for(split(step_key, C)[c]))``. The MLP runs at its
published width; the CNN is narrow (two stages) and runs the port's
``privacy_conv`` and ``dp_release`` wrappers (their plain versions on CPU
tensors, through the kernels' ``autograd.Function``s in ``e2e`` mode),
the JAX side its XLA path (``use_kernel=False``, which
``tests/test_kernels.py`` holds against the Pallas kernel).

Tolerance: 1e-5 absolute and relative on every per-step metric and every
leaf of the final state (float32 sums and convolutions in another order,
through three AdamW steps). The MLP's loss and gradient norm are ~1e4 (an
LDL-C target of ~100 squared), so the relative part governs there. Counts
(the step, the budget's release count) are exact.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.paper_models import CHOLESTEROL_MLP, COVID_CNN, MURA_VGG19
from repro.core import trainer as jt
from repro.core.adapters import cnn_adapter as j_cnn_adapter
from repro.core.adapters import mlp_adapter as j_mlp_adapter
from repro.data import make_cholesterol, make_covid_ct, split_clients
from repro.optim import adamw as j_adamw
from repro.privacy.guard import DPConfig as JDPConfig
from repro.privacy.guard import PrivacyGuard as JPrivacyGuard
from repro_torch.common.bridge import to_torch
from repro_torch.common.tree import ravel, tree_leaves
from repro_torch.configs import CHOLESTEROL_MLP as T_MLP
from repro_torch.configs import COVID_CNN as T_COVID
from repro_torch.core import trainer as tt
from repro_torch.core.adapters import cnn_adapter, mlp_adapter
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig

TOL = dict(atol=1e-5, rtol=1e-5)
SHARES = (0.7, 0.2, 0.1)
T = 3
SMALL = dict(input_hw=(16, 16), stages=((4, 1), (8, 1)), dense_units=(8,))
SIGMAS = {0: dict(clip_norm=1.0, noise_scale=0.0), 1: dict(epsilon=8.0, clip_norm=1.0)}


def _model(name):
    """(jax adapter, port adapter, shards) of a model."""
    if name == "mlp":
        shards = split_clients(*make_cholesterol(90, seed=0), shares=SHARES)
        return j_mlp_adapter(CHOLESTEROL_MLP), mlp_adapter(T_MLP), shards
    shards = split_clients(*make_covid_ct(60, hw=16, seed=0), shares=SHARES)
    return (j_cnn_adapter(dataclasses.replace(COVID_CNN, **SMALL)),
            cnn_adapter(dataclasses.replace(T_COVID, **SMALL, use_kernel=True)), shards)


def _configs(mode, sigma):
    kw = dict(n_clients=3, data_shares=SHARES, server_batch=12, mode=mode)
    return (jt.SplitTrainConfig(**kw, privacy=JDPConfig(**SIGMAS[sigma])),
            tt.SplitTrainConfig(**kw, privacy=DPConfig(**SIGMAS[sigma], use_kernel=True)))


def _jax_plan(jtc, t_adapter, shards, steps=T, seed=7):
    """JAX's idx and step keys, and the noise its engines draw from them, as
    the port's ``SamplePlan``; the JAX epoch key and lens too."""
    _, _, lens = jt.device_put_shards(shards)
    epoch_key = jax.random.PRNGKey(seed)
    idx, step_keys = jt.make_sample_plan(jtc, steps)(lens, epoch_key)
    c, b = jtc.n_clients, jt.fused_client_batch(jtc)
    feat = t_adapter.feature_shape((b,) + np.asarray(shards[0][0]).shape[1:])
    guard = JPrivacyGuard(jtc.privacy)
    model, noise = [], []
    for t in range(steps):
        keys = jax.random.split(step_keys[t], c)
        model.append([jax.random.normal(k, feat, jnp.float32) for k in keys])
        noise.append([jax.random.normal(guard.key_for(k), feat, jnp.float32) for k in keys])
    to_t = lambda a: torch.from_numpy(np.array(a))
    plan = tt.SamplePlan(idx=to_t(idx).long(), model_noise=to_t(model),
                         guard_noise=to_t(noise) if guard.sigma > 0 else None)
    return plan, lens, epoch_key, idx, step_keys


def _assert_tree_close(got, want, what, **tol):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=f"{what} leaf {i}",
                                   **tol)


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), err_msg=k, **TOL)


def _assert_state(got, want):
    for part in ("client_banks", "server", "opt", "privacy"):
        _assert_tree_close(got[part], want[part], part, **TOL)
    assert int(got["step"]) == int(want["step"])
    assert int(got["privacy"]["releases"]) == int(want["privacy"]["releases"])


CASES = [(m, mode, s, "scan") for m in ("mlp", "cnn") for mode in ("detached", "e2e")
         for s in (0, 1)] + [("mlp", "e2e", 1, "stepwise"), ("cnn", "detached", 1, "stepwise")]


@pytest.mark.parametrize("model,mode,sigma,epoch_mode", CASES)
def test_fused_epoch_matches_jax(model, mode, sigma, epoch_mode):
    """One epoch of ``T`` fused steps on JAX's plan: per-step metrics and the
    final state (banks, server, flat ``opt`` buffers, step, budget)."""
    j_adapter, t_adapter, shards = _model(model)
    jtc, ttc = _configs(mode, sigma)
    plan, lens, epoch_key, _, _ = _jax_plan(jtc, t_adapter, shards)
    j_init, j_run = jt.make_epoch_runner(j_adapter, jtc, j_adamw(1e-2), T, unroll=1,
                                         mode=epoch_mode)
    j_state = j_init(jax.random.PRNGKey(0))
    t_state = to_torch(j_state, "cpu")  # before the JAX scan donates j_state
    data_x, data_y, _ = jt.device_put_shards(shards)
    j_state, j_ms = j_run(j_state, data_x, data_y, lens, epoch_key)
    _, t_run = tt.make_epoch_runner(t_adapter, ttc, adamw(1e-2), T, mode=epoch_mode,
                                    device="cpu")
    tx, ty, _ = tt.device_put_shards(shards, "cpu")
    t_state, t_ms = t_run(t_state, tx, ty, plan)
    _assert_metrics({k: v.numpy() for k, v in t_ms.items()}, j_ms)
    _assert_state(t_state, j_state)
    assert int(t_state["privacy"]["releases"]) == T


@pytest.mark.parametrize("model,mode,sigma", [("mlp", "detached", 1), ("mlp", "e2e", 0),
                                              ("cnn", "e2e", 1), ("cnn", "detached", 0)])
def test_looped_steps_match_jax(model, mode, sigma):
    """``make_looped_step`` for ``T`` steps on the same batches and noise:
    unweighted concat loss, tree-shaped moments (a list of banks)."""
    j_adapter, t_adapter, shards = _model(model)
    jtc, ttc = _configs(mode, sigma)
    plan, _, _, idx, step_keys = _jax_plan(jtc, t_adapter, shards)
    j_init, j_step = jt.make_looped_step(j_adapter, jtc, j_adamw(1e-2))
    _, t_step = tt.make_looped_step(t_adapter, ttc, adamw(1e-2), device="cpu")
    j_state = j_init(jax.random.PRNGKey(0))
    t_state = to_torch(j_state, "cpu")
    idx = np.asarray(idx)
    for t in range(T):
        batches = [(np.asarray(x)[idx[t, c]], np.asarray(y)[idx[t, c]])
                   for c, (x, y) in enumerate(shards)]
        j_state, j_m = j_step(j_state, [tuple(map(jnp.asarray, b)) for b in batches],
                              step_keys[t])
        t_state, t_m = t_step(t_state, [tuple(map(torch.from_numpy, b)) for b in batches],
                              plan.model_noise[t],
                              None if plan.guard_noise is None else plan.guard_noise[t])
        _assert_metrics({k: v.numpy() for k, v in t_m.items()}, j_m)
    _assert_state(t_state, j_state)


def test_step_core_matches_jax():
    """``make_spatio_temporal_step`` (one step from the canonical state) on
    stacked batches: e2e CNN, σ > 0."""
    j_adapter, t_adapter, shards = _model("cnn")
    jtc, ttc = _configs("e2e", 1)
    plan, _, _, idx, step_keys = _jax_plan(jtc, t_adapter, shards)
    j_init, j_step = jt.make_spatio_temporal_step(j_adapter, jtc, j_adamw(1e-2))
    _, t_step = tt.make_spatio_temporal_step(t_adapter, ttc, adamw(1e-2), device="cpu")
    j_state = j_init(jax.random.PRNGKey(3))
    t_state = to_torch(j_state, "cpu")
    idx = np.asarray(idx)
    xs, ys = jt.stack_batches([(np.asarray(x)[idx[0, c]], np.asarray(y)[idx[0, c]])
                               for c, (x, y) in enumerate(shards)])
    j_state, j_m = j_step(j_state, xs, ys, step_keys[0])
    t_state, t_m = t_step(t_state, torch.from_numpy(np.array(xs)),
                          torch.from_numpy(np.array(ys)), plan.model_noise[0],
                          plan.guard_noise[0])
    _assert_metrics({k: v.numpy() for k, v in t_m.items()}, j_m)
    _assert_state(t_state, j_state)


def test_evaluate_matches_jax():
    """``evaluate`` (bank 0) and ``evaluate_per_client`` (every bank,
    share-weighted) on one state, eval batches of 7 rows."""
    j_adapter, t_adapter, shards = _model("cnn")
    jtc, _ = _configs("e2e", 1)
    j_state = jt._make_fused(j_adapter, jtc, j_adamw(1e-2))[0](jax.random.PRNGKey(5))
    t_state = to_torch(j_state, "cpu")
    x, y = make_covid_ct(17, hw=16, seed=3)
    want = jt.evaluate(j_adapter, j_state, x, y, batch=7)
    got = tt.evaluate(t_adapter, t_state, x, y, batch=7)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    want = jt.evaluate_per_client(j_adapter, j_state, x, y, batch=7, weights=SHARES)
    got = tt.evaluate_per_client(t_adapter, t_state, x, y, batch=7, weights=SHARES)
    assert len(got["per_client"]) == 3
    for g, w in zip(got["per_client"] + [got], want["per_client"] + [want]):
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)


# ---------------------------------------------------------------- ravel
def _narrow(cfg):
    """The config's tree structure (every key and leaf position) at narrow
    widths: filters / 16, dense 16, 32x32 inputs."""
    return dict(input_hw=(32, 32), stages=tuple((max(1, f // 16), r) for f, r in cfg.stages),
                dense_units=tuple(16 for _ in cfg.dense_units))


@pytest.mark.parametrize("name", ["mlp", "covid", "mura"])
@pytest.mark.parametrize("mode", ["detached", "e2e"])
def test_ravel_matches_ravel_pytree(name, mode):
    """The fused engine's trainable trees (the server alone; the stacked
    banks and the server) ravel to the same flat vector as
    ``ravel_pytree``, leaf order and values exactly, and ``unravel`` gives
    the tree back. The MLP and COVID-CT at their published widths; MURA
    VGG19's structure (16 convs in five stages, two dense layers) narrowed
    (:func:`_narrow`)."""
    if name == "mlp":
        j_adapter = j_mlp_adapter(CHOLESTEROL_MLP)
    else:
        cfg = {"covid": COVID_CNN, "mura": MURA_VGG19}[name]
        j_adapter = j_cnn_adapter(cfg if name == "covid" else
                                  dataclasses.replace(cfg, **_narrow(cfg)))
    jtc = jt.SplitTrainConfig(mode=mode)
    j_state = jt._make_fused(j_adapter, jtc, j_adamw(1e-3))[0](jax.random.PRNGKey(1))
    trainable = (j_state["server"] if mode == "detached"
                 else (j_state["client_banks"], j_state["server"]))
    want, _ = ravel_pytree(trainable)
    t_tree = to_torch(trainable, "cpu")
    # the port builds its trees in init order (stages, dense, out): reorder
    # every dict so that sorting, not insertion order, has to set the order
    flip = lambda t: ({k: flip(t[k]) for k in reversed(list(t))} if isinstance(t, dict)
                      else [flip(v) for v in t] if isinstance(t, list) else t)
    flat, unravel = ravel(flip(t_tree))
    assert torch.equal(flat, torch.from_numpy(np.array(want)))
    for a, b in zip(tree_leaves(unravel(flat)), tree_leaves(t_tree)):
        assert torch.equal(a, b)
    # the views share the buffer: one flat gradient through them
    flat = flat.clone().requires_grad_(True)
    sum(x.sum() for x in tree_leaves(unravel(flat))).backward()
    assert torch.equal(flat.grad, torch.ones_like(flat))


def test_port_init_order_differs_from_sorted():
    """Why ravel sorts: the port's ``init_cnn`` inserts ``stages`` before
    ``dense`` and ``out``; JAX's flat order is ``dense``, ``out``,
    ``stages``."""
    server = cnn_adapter(dataclasses.replace(T_COVID, **SMALL)).init(
        torch.Generator().manual_seed(0), "cpu")["server"]
    assert list(server) == ["stages", "dense", "out"]
    first = tree_leaves(server)[0]
    assert first.shape == server["dense"][0]["b"].shape


# ---------------------------------------------------------------- helpers
CONFIGS = [dict(), dict(server_batch=2), dict(server_batch=7, data_shares=(0.5, 0.3, 0.2)),
           dict(n_clients=4, data_shares=(1, 1, 1, 1), server_batch=48),
           dict(n_clients=2, data_shares=(0.9, 0.1), server_batch=5)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_batch_helpers_exact(kw):
    jtc, ttc = jt.SplitTrainConfig(**kw), tt.SplitTrainConfig(**kw)
    assert tt.client_batch_sizes(ttc) == jt.client_batch_sizes(jtc)
    assert tt.fused_client_batch(ttc) == jt.fused_client_batch(jtc)
    np.testing.assert_array_equal(tt.client_weights(ttc).numpy(),
                                  np.asarray(jt.client_weights(jtc)))
    assert tt.single_client_config(ttc).data_shares == jt.single_client_config(jtc).data_shares


def test_deprecated_fields_map_as_reference():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        j = jt.SplitTrainConfig(privacy_noise=0.3, clip_norm=2.5)
    with pytest.warns(DeprecationWarning):
        t = tt.SplitTrainConfig(privacy_noise=0.3, clip_norm=2.5)
    assert (t.grad_clip, t.clip_norm, t.privacy_noise) == (j.grad_clip, j.clip_norm,
                                                           j.privacy_noise)
    assert dataclasses.asdict(t.privacy) == dataclasses.asdict(j.privacy)
    again = dataclasses.replace(t, grad_clip=0.5)  # the mapping is not re-applied
    assert again.grad_clip == 0.5


def test_data_helpers_exact():
    shards = split_clients(*make_covid_ct(23, hw=8, seed=1), shares=SHARES)
    jx, jy, jl = jt.device_put_shards(shards)
    tx, ty, tl = tt.device_put_shards(shards, "cpu")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))  # NaN padding included
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tl.dtype == torch.int32 and tl.tolist() == np.asarray(jl).tolist()
    with pytest.raises(ValueError):
        tt.device_put_shards([(np.zeros((0, 2)), np.zeros(0))], "cpu")
    batches = [(x[:2], y[:2]) for x, y in shards]
    for a, b in zip(tt.stack_batches(batches), jt.stack_batches(batches)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for vals in ([1.0, 2.0], [np.nan, 1.0, np.inf, 3.0], [np.nan], []):
        a, b = tt.finite_mean(vals), jt.finite_mean(vals)
        assert a == b or (np.isnan(a) and np.isnan(b))
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2)]}
    stacked = tt.stack_pytrees([tree, tree, tree])
    assert stacked["w"].shape == (3, 2, 3)
    assert tt._client_banks_list(stacked)[2]["b"][0].tolist() == [1.0, 1.0]
    assert len(tt.unstack_pytree(stacked, 3)) == 3


def test_sample_plan_draws_within_lens():
    """The port's own plan: indices within each client's shard, noise of the
    released features' shape, the same plan for the same generator seed."""
    _, t_adapter, shards = _model("cnn")
    _, ttc = _configs("e2e", 1)
    _, _, lens = tt.device_put_shards(shards, "cpu")
    plan_fn = tt.make_sample_plan(t_adapter, ttc, 5)
    plan = plan_fn(lens, (16, 16, 1), torch.Generator().manual_seed(0), "cpu")
    assert plan.idx.shape == (5, 3, 4)
    for c, n in enumerate(lens.tolist()):
        assert 0 <= int(plan.idx[:, c].min()) and int(plan.idx[:, c].max()) < n
    assert plan.model_noise.shape == plan.guard_noise.shape == (5, 3, 4, 8, 8, 4)
    again = plan_fn(lens, (16, 16, 1), torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(plan.idx, again.idx) and torch.equal(plan.guard_noise, again.guard_noise)
    off = tt.make_sample_plan(t_adapter, tt.SplitTrainConfig(server_batch=12), 2)(
        lens, (16, 16, 1), torch.Generator().manual_seed(0), "cpu")
    assert off.guard_noise is None  # no guard, no guard noise
