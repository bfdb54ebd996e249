"""The port's FedAvg baseline (``core.fedavg``, the ``fedavg`` engine)
against ``repro.core``'s.

The same inputs on both sides: the weights carried across with the bridge,
batch indices from the same NumPy generator, and the guard's noise fed from
the JAX package's draws (``fold_in(root, (round * n + client) * steps +
step)`` through ``PrivacyGuard.key_for``) by ``noise_fn``. Two rounds, so
the absolute optimizer step (AdamW's bias correction) and the fresh
optimizer of every client and round are both exercised. Leaves and losses
at 1e-5 absolute and relative (float32 dense layers and convs summed in
another order); counts and budgets exact. The narrow CNN runs its client
stage through ``privacy_conv`` and the guard through ``dp_release`` (the
JAX side's Pallas kernels in interpret mode, the port's plain versions on
CPU tensors).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import CHOLESTEROL_MLP as J_MLP
from repro.configs.paper_models import COVID_CNN as J_COVID
from repro.core import SplitSession as JSession
from repro.core import SplitTrainConfig as JConfig
from repro.core import fedavg as j_fedavg
from repro.core.adapters import cnn_adapter as j_cnn_adapter
from repro.core.adapters import mlp_adapter as j_mlp_adapter
from repro.data import make_cholesterol, make_covid_ct, split_clients
from repro.optim import adamw as j_adamw
from repro.privacy import DPConfig as JDPConfig
from repro.privacy import PrivacyGuard as JGuard
from repro_torch.common.bridge import to_torch
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import CHOLESTEROL_MLP, COVID_CNN
from repro_torch.core import SplitSession, SplitTrainConfig, train_fedavg
from repro_torch.core import fedavg
from repro_torch.core.adapters import cnn_adapter, mlp_adapter
from repro_torch.core.session import FedAvgEngine
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig

TOL = dict(atol=1e-5, rtol=1e-5)
DP = dict(epsilon=1.0, delta=1e-5, clip_norm=1.0)
SHARES = (0.7, 0.2, 0.1)
NARROW = dict(input_hw=(16, 16), stages=((8, 1),), dense_units=(8,))
ROUNDS, STEPS, BATCH = 2, 2, 8


def _models(model, dp):
    """(jax adapter, jax config, port adapter, port config, shards)."""
    if model == "mlp":
        shards = split_clients(*make_cholesterol(120, seed=0), shares=SHARES)
        return (j_mlp_adapter(J_MLP), JConfig(privacy=JDPConfig(**DP) if dp else None),
                mlp_adapter(CHOLESTEROL_MLP),
                SplitTrainConfig(privacy=DPConfig(**DP) if dp else None), shards)
    shards = split_clients(*make_covid_ct(60, hw=16, seed=0), shares=SHARES)
    jdp = JDPConfig(**DP, use_kernel=True, interpret=True) if dp else None
    return (j_cnn_adapter(dataclasses.replace(J_COVID, **NARROW, use_kernel=True,
                                              interpret=True)),
            JConfig(privacy=jdp),
            cnn_adapter(dataclasses.replace(COVID_CNN, **NARROW, use_kernel=True)),
            SplitTrainConfig(privacy=DPConfig(**DP, use_kernel=True) if dp else None), shards)


def jax_noise_fn(adapter, tc, seed=0, local_steps=STEPS):
    """The JAX FedAvg's guard draws for (round, client, step): the local
    step's key folded from the root, then ``key_for`` (``fedavg.py:89``,
    ``guard.py:174``)."""
    root, guard, n = jax.random.PRNGKey(seed), JGuard.from_config(tc.privacy), tc.n_clients

    def noise_fn(rnd, c, s, shape):
        k = jax.random.fold_in(root, (rnd * n + c) * local_steps + s)
        return np.asarray(jax.random.normal(guard.key_for(k), shape, jnp.float32))

    return noise_fn


def assert_trees_close(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("model", ["mlp", "cnn"])
@pytest.mark.parametrize("dp", [False, True], ids=["guard_off", "dp"])
def test_fedavg_rounds_match_jax(model, dp):
    """``fedavg_rounds`` from the same global model, rng and draws: every
    leaf of the averaged model and each round's mean local loss."""
    ja, jc, ta, tc, shards = _models(model, dp)
    gp = ja.init(jax.random.PRNGKey(0))
    j_gp, j_hist = j_fedavg.fedavg_rounds(
        ja, jc, j_adamw(1e-2), shards, gp, rounds=ROUNDS, local_steps=STEPS,
        local_batch=BATCH, rng=np.random.default_rng(7), noise_key=jax.random.PRNGKey(0))
    t_gp, t_hist = fedavg.fedavg_rounds(
        ta, tc, adamw(1e-2), shards, to_torch(jax.device_get(gp), "cpu"), rounds=ROUNDS,
        local_steps=STEPS, local_batch=BATCH, rng=np.random.default_rng(7),
        noise_fn=jax_noise_fn(ja, jc) if dp else None)
    assert [h["round"] for h in t_hist] == [h["round"] for h in j_hist] == [0, 1]
    np.testing.assert_allclose([h["mean_local_loss"] for h in t_hist],
                               [h["mean_local_loss"] for h in j_hist], **TOL)
    assert_trees_close(t_gp, j_gp)


def test_average_models_matches_jax_weighting():
    """float64-normalized shares rounded to float32, summed in client order:
    the reference's ``sum(w * p)`` over three leaves, at 1e-6."""
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(3)]
    w = np.asarray(SHARES, np.float64) / np.sum(SHARES)
    want = sum(wc * jnp.asarray(p) for wc, p in zip(w, leaves))
    got = fedavg.average_models([{"a": torch.from_numpy(p)} for p in leaves], w)["a"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def _pair(model="mlp", dp=True, seed=0):
    """A JAX fedavg session and a port one on the JAX session's weights."""
    ja, jc, ta, tc, shards = _models(model, dp)
    js = JSession(ja, jc, j_adamw(1e-2), engine="fedavg", seed=seed, local_batch=BATCH)
    ps = SplitSession(ta, tc, adamw(1e-2), engine="fedavg", seed=seed, device="cpu",
                      local_batch=BATCH, noise_fn=jax_noise_fn(ja, jc, seed) if dp else None)
    ps._native = ps.engine.from_canonical(to_torch(jax.device_get(js.state), "cpu"))
    return js, ps, shards


def test_fedavg_engine_canonical_state_and_budget():
    """Two fits through the session (the second reseeds the batch draws
    from (seed, round)): the canonical state has n identical banks, an
    empty ``opt``, ``step`` = rounds and the reference's budget, one release
    a local step; every leaf, the history and the evaluation equal JAX's."""
    js, ps, shards = _pair()
    for _ in range(2):
        jh = js.fit(shards, epochs=ROUNDS, steps_per_epoch=STEPS)
        ph = ps.fit(shards, epochs=ROUNDS, steps_per_epoch=STEPS)
        assert [h["epoch"] for h in ph] == [h["epoch"] for h in jh] == [0, 1]
        np.testing.assert_allclose([h["loss"] for h in ph], [h["loss"] for h in jh], **TOL)
        assert_trees_close(ps.state, js.state)
    st = ps.state
    assert st["opt"] == {} and int(st["step"]) == 2 * ROUNDS
    for leaf in tree_leaves(st["client_banks"]):
        assert leaf.shape[0] == 3 and all(torch.equal(leaf[0], leaf[c]) for c in (1, 2))
    assert ps.privacy_report()["releases"] == 2 * ROUNDS * STEPS
    assert ps.privacy_report() == js.privacy_report()
    assert ps.engine.identical_banks
    x, y = make_cholesterol(40, seed=5)
    got, want = ps.evaluate(x, y), js.evaluate(x, y)
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    assert got["per_client"][0] == got["per_client"][2]


def test_fedavg_engine_refuses_what_the_reference_refuses():
    _, _, ta, tc, _ = _models("mlp", False)
    with pytest.raises(ValueError, match="mode does not apply"):
        SplitSession(ta, dataclasses.replace(tc, mode="e2e"), adamw(1e-2), engine="fedavg",
                     device="cpu")
    with pytest.raises(ValueError, match="fedavg does not support mesh"):
        FedAvgEngine(ta, tc, adamw(1e-2), device="cpu", mesh=object())


def test_restore_then_fit_equals_continued_fit(tmp_path):
    """A session restored after 2 rounds and fit one more equals the
    uninterrupted session's next round, bit for bit (CPU, guard on)."""
    _, _, ta, tc, shards = _models("mlp", True)

    def session():
        return SplitSession(ta, tc, adamw(1e-2), engine="fedavg", seed=3, device="cpu",
                            local_batch=BATCH)

    a = session()
    a.fit(shards, epochs=2, steps_per_epoch=STEPS)
    path = a.save(str(tmp_path))
    ha = a.fit(shards, epochs=1, steps_per_epoch=STEPS)
    b = session()
    b.restore(path)
    hb = b.fit(shards, epochs=1, steps_per_epoch=STEPS)
    assert ha == hb and ha[0]["round"] == 2
    for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert torch.equal(x, y)
    assert a.privacy_report() == b.privacy_report()


def test_checkpoints_cross_with_the_jax_fedavg_engine(tmp_path):
    """A JAX fedavg save restores in the port leaf for leaf and continues
    as the JAX session does; a port save loads in a JAX fedavg session."""
    js, ps, shards = _pair()
    js.fit(shards, epochs=ROUNDS, steps_per_epoch=STEPS)
    ps2 = _pair()[1]
    ps2.restore(js.save(str(tmp_path / "jax")))
    for a, b in zip(tree_leaves(ps2.state), jax.tree.leaves(js.state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    js.fit(shards, epochs=1, steps_per_epoch=STEPS)
    ps2.fit(shards, epochs=1, steps_per_epoch=STEPS)
    assert_trees_close(ps2.state, js.state)

    path = ps2.save(str(tmp_path / "port"))
    js2 = JSession(*_models("mlp", True)[:2], j_adamw(1e-2), engine="fedavg",
                   local_batch=BATCH)
    js2.restore(path)
    for a, b in zip(tree_leaves(ps2.state), jax.tree.leaves(js2.state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert js2.privacy_report() == ps2.privacy_report()


def test_train_fedavg_warns_and_delegates():
    """The deprecated shim warns, then returns the session's full model and
    history, bit for bit a ``SplitSession(engine="fedavg")`` fit."""
    _, _, ta, tc, shards = _models("mlp", False)
    with pytest.warns(DeprecationWarning, match="train_fedavg is deprecated"):
        gp, hist = train_fedavg(ta, tc, adamw(1e-3), shards, rounds=2, local_steps=3,
                                local_batch=BATCH, device="cpu",
                                eval_fn=lambda p: {"n_leaves": len(tree_leaves(p))})
    s = SplitSession(ta, tc, adamw(1e-3), engine="fedavg", device="cpu", local_batch=BATCH)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = s.fit(shards, epochs=2, steps_per_epoch=3)
    assert [h["mean_local_loss"] for h in hist] == [h["mean_local_loss"] for h in want]
    assert all(h["val_n_leaves"] == len(tree_leaves(gp)) for h in hist)
    for a, b in zip(tree_leaves(gp), tree_leaves(s.native_state["params"])):
        assert torch.equal(a, b)
