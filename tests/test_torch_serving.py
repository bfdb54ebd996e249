"""The whole path: guarded split-inference serving of a CNN in the port
against ``repro``'s ``SplitSession.serve`` on the same state, traces and
noise.

Setup: a small CNN whose client stage runs the privacy kernel, and a
CLIPPED guard (``clip_norm=1.0``) through the ``dp_release`` kernel; the
JAX side runs both Pallas kernels in interpret mode, the port their plain
versions (CPU tensors). The JAX release noise (model noise from the
release key, guard noise from its ``GUARD_KEY_FOLD`` fold) is fed to the
port through ``noise_fn``.

Tolerance: features and responses 1e-5 absolute and relative (float32
convs and matmuls summed in another order; the guard noise at sigma ~5 puts
features near 10, so the relative part dominates). Counts, cycle latencies
and the privacy budget are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import COVID_CNN
from repro.core import SplitSession, SplitTrainConfig
from repro.core.adapters import cnn_adapter as j_cnn_adapter
from repro.data import make_covid_ct, split_clients
from repro.optim import adamw
from repro.privacy import DPConfig as JDPConfig
from repro.privacy.guard import GUARD_KEY_FOLD
from repro.serving import bursty_trace, poisson_trace
from repro_torch.common.bridge import to_torch
from repro_torch.configs import COVID_CNN as T_COVID_CNN
from repro_torch.core.adapters import cnn_adapter
from repro_torch.kernels.dp_release import ops as dp_ops
from repro_torch.kernels.privacy_conv import ops as pc_ops
from repro_torch.privacy import DPConfig, PrivacyGuard, budget_advance
from repro_torch.serving import SplitInferenceServer
from repro_torch.serving import bursty_trace as t_bursty_trace
from repro_torch.serving import poisson_trace as t_poisson_trace

SMALL = dict(input_hw=(16, 16), stages=((8, 1), (16, 1)), dense_units=(16,),
             use_kernel=True)
DP = dict(epsilon=2.0, clip_norm=1.0, use_kernel=True)
TOL = dict(atol=1e-5, rtol=1e-5)
KNOBS = dict(max_batch=4, queue_size=6, request_batch=2, max_wait=2)
TRACES = [
    ("poisson", dict(rate=2.0, horizon=8, seed=3, shares=(0.7, 0.2, 0.1))),
    ("bursty", dict(base_rate=0.5, burst_rate=6.0, period=6, burst_len=2, horizon=10,
                    seed=4)),
]


def _trace(kind, kw, port=False):
    make = {"poisson": (poisson_trace, t_poisson_trace),
            "bursty": (bursty_trace, t_bursty_trace)}[kind][int(port)]
    return make(3, **kw)


@pytest.fixture(scope="module")
def shards():
    return split_clients(*make_covid_ct(36, hw=16, seed=0))


@pytest.fixture(scope="module")
def jax_session():
    cfg = dataclasses.replace(COVID_CNN, interpret=True, **SMALL)
    return SplitSession(j_cnn_adapter(cfg),
                        SplitTrainConfig(server_batch=12,
                                         privacy=JDPConfig(interpret=True, **DP)),
                        adamw(1e-3), engine="auto", seed=1)


def _jax_noise_fn(seed, step):
    """The JAX server's draws: key ``fold_in(fold_in(fold_in(root, step),
    client), release)`` for the model noise, its ``GUARD_KEY_FOLD`` fold for
    the guard's (``repro/serving/server.py:214-230``)."""
    root = jax.random.PRNGKey(seed)

    def noise_fn(client, release, model_shape, guard_shape):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(root, step), client),
                               release)
        return (np.asarray(jax.random.normal(k, model_shape, jnp.float32)),
                np.asarray(jax.random.normal(jax.random.fold_in(k, GUARD_KEY_FOLD),
                                             guard_shape, jnp.float32)))

    return noise_fn


def _port_server(state, **kw):
    return SplitInferenceServer(
        cnn_adapter(dataclasses.replace(T_COVID_CNN, **SMALL)), state,
        guard=PrivacyGuard(DPConfig(**DP)), device="cpu", record_features=True,
        **KNOBS, **kw)


@pytest.mark.parametrize("kind,kw", TRACES)
def test_serve_matches_jax(jax_session, shards, kind, kw):
    before = jax.device_get(jax_session.state)
    jrep = jax_session.serve(_trace(kind, kw), shards, record_features=True, **KNOBS)
    after = jax.device_get(jax_session.state)

    state = to_torch(before, "cpu")
    launches = (pc_ops.launches, dp_ops.launches)
    rep = _port_server(state, noise_fn=_jax_noise_fn(jax_session.seed, int(before["step"]))
                       ).serve(_trace(kind, kw, port=True), shards)
    assert (pc_ops.launches, dp_ops.launches) == launches  # CPU: plain versions

    assert rep.deterministic_stats() == jrep.deterministic_stats()
    assert rep.answered > 0 and rep.features.keys() == jrep.features.keys()
    for rid, f in jrep.features.items():
        np.testing.assert_allclose(rep.features[rid], f, err_msg=f"features {rid}", **TOL)
    assert rep.responses.keys() == jrep.responses.keys()
    for rid, r in jrep.responses.items():
        np.testing.assert_allclose(rep.responses[rid], r, err_msg=f"response {rid}", **TOL)
    if kind == "bursty":
        assert rep.dropped + rep.shed > 0  # admission control was exercised

    budget = budget_advance(state["privacy"], DPConfig(**DP), max(rep.releases_per_client))
    assert int(budget["releases"]) == int(after["privacy"]["releases"])
    assert (np.float32(budget["epsilon_basic"].item()).tobytes()
            == np.asarray(after["privacy"]["epsilon_basic"], np.float32).tobytes())


def test_port_serve_properties(jax_session, shards):
    """Port-only: the ledger balances, no request is answered twice, and a
    replay with the same seed is bit-identical (another seed is not)."""
    state = to_torch(jax.device_get(jax_session.state), "cpu")
    trace = t_bursty_trace(3, base_rate=1.0, burst_rate=8.0, period=5, burst_len=2,
                           horizon=10, seed=7)
    rep = _port_server(state, seed=11).serve(trace, shards)
    assert rep.offered == trace.offered
    assert rep.answered + rep.dropped + rep.shed == rep.offered
    assert rep.accepted == rep.answered + rep.shed
    assert rep.dropped == rep.dropped_full + rep.dropped_cap
    assert len(rep.responses) == rep.answered == sum(p["answered"] for p in rep.per_client)
    assert rep.queue_stats["popped"] == rep.answered + rep.shed
    for pc in rep.per_client:
        assert pc["offered"] == pc["answered"] + pc["dropped"] + pc["shed"]
    again = _port_server(state, seed=11).serve(trace, shards)
    assert again.fingerprint() == rep.fingerprint()
    for rid in rep.features:
        np.testing.assert_array_equal(again.features[rid], rep.features[rid])
    assert _port_server(state, seed=12).serve(trace, shards).fingerprint() != rep.fingerprint()


def test_server_refuses_bad_setups(jax_session, shards):
    state = to_torch(jax.device_get(jax_session.state), "cpu")
    with pytest.raises(ValueError, match="covers 2 clients"):
        _port_server(state).serve(t_poisson_trace(2, horizon=2, seed=0), shards)
    with pytest.raises(ValueError, match="max_batch"):
        SplitInferenceServer(cnn_adapter(T_COVID_CNN), state, max_batch=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SplitInferenceServer(cnn_adapter(T_COVID_CNN), state)
