"""The public names the port shares with the JAX package: the re-exported
losses (``repro_torch.metrics``) and tree helpers (``repro_torch.common``),
the whole-model ``forward`` of the CNN and the MLP, ``cnn.conv2d``'s
stride, ``make_single_client_step``, each against JAX on the same inputs;
and the deprecated shims ``train_spatio_temporal``, ``train_single_client``
and ``core.protocol.run_protocol``, which warn and give the numbers of the
``SplitSession`` they delegate to.

Tolerance: 1e-5 absolute and relative (float32 on both sides, sums in
another order); the shims bit for bit against the session.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.common as jcommon
import repro.metrics as jmetrics
from repro.configs.paper_models import CHOLESTEROL_MLP as J_MLP
from repro.configs.paper_models import COVID_CNN as J_COVID
from repro.core import trainer as jt
from repro.core.adapters import mlp_adapter as j_mlp_adapter
from repro.models import cnn as jcnn
from repro.models import mlp as jmlp
from repro.optim import adamw as j_adamw
import repro_torch.common as tcommon
import repro_torch.metrics as tmetrics
from repro_torch.common.bridge import to_torch
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import CHOLESTEROL_MLP, COVID_CNN
from repro_torch.core import SplitSession, SplitTrainConfig, single_client_config
from repro_torch.core import trainer as tt
from repro_torch.core.adapters import mlp_adapter
from repro_torch.core.protocol import run_protocol
from repro_torch.data import make_cholesterol, split_clients
from repro_torch.models import cnn, mlp
from repro_torch.optim import adamw

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(input_hw=(16, 16), stages=((4, 1), (8, 1)), dense_units=(8,))
LOSSES = ("bce_with_logits", "binary_accuracy", "ce_with_logits", "mse", "msle",
          "multiclass_accuracy", "rmsle", "smape")


@pytest.mark.parametrize("name", LOSSES)
def test_metrics_reexports_the_losses(name):
    rng = np.random.default_rng(0)
    if name in ("ce_with_logits", "multiclass_accuracy"):
        out = rng.normal(size=(16, 4)).astype(np.float32)
        y = rng.integers(0, 4, 16).astype(np.int32)
    elif name in ("bce_with_logits", "binary_accuracy"):
        out = rng.normal(size=(16, 1)).astype(np.float32)
        y = rng.integers(0, 2, (16, 1)).astype(np.float32)
    else:
        out = rng.random(16).astype(np.float32) * 3
        y = rng.random(16).astype(np.float32) * 3
    got = getattr(tmetrics, name)(torch.from_numpy(out), torch.from_numpy(y))
    want = getattr(jmetrics, name)(jnp.asarray(out), jnp.asarray(y))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_common_reexports_the_tree_helpers():
    rng = np.random.default_rng(1)
    a = {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": [rng.normal(size=5).astype(np.float32)]}
    b = {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": [rng.normal(size=5).astype(np.float32)]}
    ta, tb = to_torch(a, "cpu"), to_torch(b, "cpu")
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    for got, want in ((tcommon.tree_add(ta, tb), jcommon.tree_add(ja, jb)),
                      (tcommon.tree_scale(ta, 0.5), jcommon.tree_scale(ja, 0.5)),
                      (tcommon.tree_zeros_like(ta), jcommon.tree_zeros_like(ja))):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(float(tcommon.tree_global_norm(ta)),
                               float(jcommon.tree_global_norm(ja)), **TOL)
    assert tcommon.tree_size(ta) == jcommon.tree_size(ja) == 17
    assert tcommon.tree_bytes(ta) == jcommon.tree_bytes(ja) == 68


@pytest.mark.parametrize("detach_cut", [True, False])
def test_forward_of_the_cnn_and_the_mlp_against_jax(detach_cut):
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(3)
    jcfg = dataclasses.replace(J_COVID, **SMALL)
    tcfg = dataclasses.replace(COVID_CNN, **SMALL)
    jp = jcnn.init_cnn(jax.random.PRNGKey(0), jcfg)
    x = rng.random((2, 16, 16, 1), np.float32)
    noise = np.array(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    want = jcnn.forward(jp, jcfg, jnp.asarray(x), key, detach_cut=detach_cut)
    tp = to_torch(jp, "cpu")
    got = cnn.forward(tp, tcfg, torch.from_numpy(x), torch.from_numpy(noise),
                      detach_cut=detach_cut)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the gradient reaches the client stage only through an attached cut
    wj = jax.grad(lambda p: jnp.sum(jcnn.forward(p, jcfg, jnp.asarray(x), key,
                                                 detach_cut=detach_cut)))(jp)
    leaf = tp["client"]["stages"][0][0]["w"].requires_grad_(True)
    head = tp["server"]["out"]["b"].requires_grad_(True)
    g, _ = torch.autograd.grad(cnn.forward(tp, tcfg, torch.from_numpy(x),
                                           torch.from_numpy(noise),
                                           detach_cut=detach_cut).sum(), (leaf, head),
                               allow_unused=True)
    want_g = np.asarray(wj["client"]["stages"][0][0]["w"])
    if detach_cut:
        assert g is None and not want_g.any()
    else:
        np.testing.assert_allclose(g.numpy(), want_g, atol=1e-4, rtol=1e-4)

    mp = jmlp.init_mlp(jax.random.PRNGKey(1), J_MLP)
    xm = rng.normal(size=(6, 7)).astype(np.float32)
    nm = np.array(jax.random.normal(key, (6, 64), jnp.float32))
    want_m = jmlp.forward(mp, J_MLP, jnp.asarray(xm), key, detach_cut=detach_cut)
    got_m = mlp.forward(to_torch(mp, "cpu"), CHOLESTEROL_MLP, torch.from_numpy(xm),
                        torch.from_numpy(nm), detach_cut=detach_cut)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **TOL)
    # no noise: the key-less forward
    np.testing.assert_allclose(
        mlp.forward(to_torch(mp, "cpu"), CHOLESTEROL_MLP, torch.from_numpy(xm)).numpy(),
        np.asarray(jmlp.forward(mp, J_MLP, jnp.asarray(xm))), **TOL)


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("hw", [(9, 9), (8, 11), (16, 16)])
def test_conv2d_stride_pads_as_xla_same(stride, hw):
    rng = np.random.default_rng(stride * 100 + hw[1])
    p = {"w": rng.normal(size=(3, 3, 2, 5)).astype(np.float32),
         "b": rng.normal(size=5).astype(np.float32)}
    x = rng.normal(size=(2,) + hw + (2,)).astype(np.float32)
    want = np.asarray(jcnn.conv2d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride=stride))
    got = cnn.conv2d(to_torch(p, "cpu"), torch.from_numpy(x), stride=stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_make_single_client_step_against_jax():
    """One step of the conventional split-learning baseline (one client,
    all data) from the same state and batch; no model noise and no guard,
    so the JAX step's key draws nothing."""
    jcfg = dataclasses.replace(J_MLP, privacy_noise=0.0)
    tcfg = dataclasses.replace(CHOLESTEROL_MLP, privacy_noise=0.0)
    j_init, j_step = jt.make_single_client_step(j_mlp_adapter(jcfg),
                                                jt.SplitTrainConfig(server_batch=16),
                                                j_adamw(1e-2))
    t_init, t_step = tt.make_single_client_step(mlp_adapter(tcfg), SplitTrainConfig(server_batch=16),
                                                adamw(1e-2), device="cpu")
    jstate = j_init(jax.random.PRNGKey(0))
    assert jstate["client_banks"]["layers"][0]["w"].shape[0] == 1  # one client
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(1, 16, 7)).astype(np.float32)
    ys = (rng.random((1, 16)) * 3).astype(np.float32)
    jnew, jm = j_step(jstate, jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(1))
    tnew, tm = t_step(to_torch(jax.device_get(jstate), "cpu"), torch.from_numpy(xs),
                      torch.from_numpy(ys))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    for g, w in zip(tree_leaves(tnew["server"]), jax.tree.leaves(jnew["server"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert tuple(t_init(torch.Generator().manual_seed(0))["client_banks"]["layers"][0]["w"]
                 .shape)[0] == 1


# ------------------------------------------------------------------ shims
def _chol():
    x, y = make_cholesterol(300, seed=0)
    return split_clients(x, y)


def _assert_same(state, session):
    for a, b in zip(tree_leaves(state), tree_leaves(session.state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("epoch_mode", [None, "scan", "stepwise"])
def test_train_spatio_temporal_warns_and_delegates(epoch_mode):
    tc = SplitTrainConfig(server_batch=24)
    with pytest.warns(DeprecationWarning, match="train_spatio_temporal is deprecated"):
        state, hist = tt.train_spatio_temporal(mlp_adapter(CHOLESTEROL_MLP), tc, adamw(1e-2),
                                               _chol(), epochs=2, steps_per_epoch=3, seed=5,
                                               epoch_mode=epoch_mode, device="cpu")
    engine = {None: "auto", "scan": "fused-scan", "stepwise": "fused-stepwise"}[epoch_mode]
    s = SplitSession(mlp_adapter(CHOLESTEROL_MLP), tc, adamw(1e-2), engine=engine, seed=5,
                     device="cpu")
    assert [h["loss"] for h in s.fit(_chol(), epochs=2, steps_per_epoch=3)] == \
        [h["loss"] for h in hist]
    _assert_same(state, s)


def test_train_single_client_warns_and_delegates():
    tc = SplitTrainConfig(server_batch=24)
    shard = _chol()[1]
    with pytest.warns(DeprecationWarning, match="train_single_client is deprecated"):
        state, hist = tt.train_single_client(mlp_adapter(CHOLESTEROL_MLP), tc, adamw(1e-2),
                                             shard, epochs=2, steps_per_epoch=3, device="cpu")
    s = SplitSession(mlp_adapter(CHOLESTEROL_MLP), single_client_config(tc), adamw(1e-2),
                     device="cpu")
    assert [h["loss"] for h in s.fit([shard], epochs=2, steps_per_epoch=3)] == \
        [h["loss"] for h in hist]
    _assert_same(state, s)


def test_run_protocol_warns_and_delegates():
    shards = _chol()
    with pytest.warns(DeprecationWarning, match="run_protocol is deprecated"):
        res = run_protocol(mlp_adapter(CHOLESTEROL_MLP), shards, adamw(1e-2),
                           total_server_steps=12, client_batch=8, seed=2, threaded=False,
                           device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the session itself does not warn
        s = SplitSession(mlp_adapter(CHOLESTEROL_MLP),
                         SplitTrainConfig(n_clients=3, data_shares=(1 / 3,) * 3), adamw(1e-2),
                         engine="protocol-async", seed=2, device="cpu", threaded=False,
                         client_batch=8)
        s.fit(shards, epochs=1, steps_per_epoch=12)
    assert res["losses"] == s.engine.losses and res["server_steps"] == 12
    assert set(res) == {"server_params", "client_params", "losses", "queue_stats",
                        "server_steps"}
    for a, b in zip(tree_leaves(res["server_params"]), tree_leaves(s.native_state["server"])):
        assert torch.equal(a, b)
    assert len(res["client_params"]) == 3
