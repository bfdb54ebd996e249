"""The port's ``SplitSession`` against ``repro.core.SplitSession``:
checkpoints cross both ways leaf for leaf (the fused engine's flat ``opt``
buffers included), restored states evaluate to the same metrics, the budget
reports agree, and what is not ported refuses loudly.

Tolerance: leaves restored from a checkpoint are compared exactly (the
same float32 bits); evaluations of one state at 1e-5 absolute and relative
(float32 convolutions and sums in another order); privacy reports exactly.
No test here anchors on convergence over a few steps.
"""
import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import CHOLESTEROL_MLP, COVID_CNN
from repro.core import SplitSession as JSession
from repro.core import SplitTrainConfig as JConfig
from repro.core.adapters import cnn_adapter as j_cnn_adapter
from repro.core.adapters import mlp_adapter as j_mlp_adapter
from repro.data import make_cholesterol, make_covid_ct, split_clients
from repro.optim import adamw as j_adamw
from repro.privacy import DPConfig as JDPConfig
from repro.serving import poisson_trace
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import CHOLESTEROL_MLP as T_MLP
from repro_torch.configs import COVID_CNN as T_COVID
from repro_torch.core import SplitSession, SplitTrainConfig, available_engines
from repro_torch.core.adapters import cnn_adapter, mlp_adapter
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig
from repro_torch.serving import poisson_trace as t_poisson_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
SHARES = (0.7, 0.2, 0.1)
SMALL = dict(input_hw=(16, 16), stages=((4, 1), (8, 1)), dense_units=(8,))
DP = dict(epsilon=4.0, clip_norm=1.0)


def _cnn(mode="e2e"):
    """(jax session factory, port session factory, shards, test set) of a
    narrow CNN with the guard on."""
    shards = split_clients(*make_covid_ct(60, hw=16, seed=0), shares=SHARES)
    test = make_covid_ct(11, hw=16, seed=1)
    kw = dict(n_clients=3, data_shares=SHARES, server_batch=12, mode=mode)

    def jax_session(engine):
        return JSession(j_cnn_adapter(dataclasses.replace(COVID_CNN, **SMALL)),
                        JConfig(**kw, privacy=JDPConfig(**DP)), j_adamw(1e-2), engine=engine)

    def port_session(engine, **opts):
        return SplitSession(cnn_adapter(dataclasses.replace(T_COVID, **SMALL, use_kernel=True)),
                            SplitTrainConfig(**kw, privacy=DPConfig(**DP, use_kernel=True)),
                            adamw(1e-2), engine=engine, device="cpu", **opts)

    return jax_session, port_session, shards, test


def _assert_leaves_equal(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _assert_eval_close(got, want):
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    for g, w in zip(got["per_client"], want["per_client"]):
        np.testing.assert_allclose(g["loss"], w["loss"], **TOL)
    assert got["privacy"] == want["privacy"]


@pytest.mark.parametrize("engine,mode", [("fused-scan", "e2e"), ("auto", "detached"),
                                         ("looped-ref", "e2e")])
def test_jax_checkpoint_restores_in_port(tmp_path, engine, mode):
    """A JAX session's save (after 2 epochs x 2 steps) restores in the port
    leaf for leaf, including the fused engine's flat ``opt`` buffers (and
    the looped engine's ``(banks, server)`` moment trees), and evaluates to
    the JAX session's metrics; the epoch count comes back too."""
    jax_session, port_session, shards, (xt, yt) = _cnn(mode)
    js = jax_session(engine)
    js.fit(shards, epochs=2, steps_per_epoch=2)
    path = js.save(str(tmp_path))
    ts = port_session(engine)
    manifest = ts.restore(path)
    _assert_leaves_equal(ts.state, js.state)
    if engine != "looped-ref":
        assert ts.state["opt"]["mu"].shape == js.state["opt"]["mu"].shape  # one flat buffer
    assert ts.engine._epochs_done == manifest["metadata"]["epochs_done"] == 2
    _assert_eval_close(ts.evaluate(xt, yt), js.evaluate(xt, yt))


@pytest.mark.parametrize("engine", ["auto", "looped-ref"])
def test_port_checkpoint_loads_in_jax(tmp_path, engine):
    """A port session's save loads in a JAX session of the same config, leaf
    for leaf, and both evaluate the state alike."""
    jax_session, port_session, shards, (xt, yt) = _cnn("e2e")
    ts = port_session(engine)
    ts.fit(shards, epochs=1, steps_per_epoch=3)
    path = ts.save(str(tmp_path))
    js = jax_session(engine)
    js.restore(path)
    _assert_leaves_equal(ts.state, js.state)
    assert int(js.state["privacy"]["releases"]) == 3
    _assert_eval_close(ts.evaluate(xt, yt), js.evaluate(xt, yt))


@pytest.mark.parametrize("engine", ["auto", "fused-stepwise", "looped-ref"])
def test_releases_and_privacy_report_match_jax(engine):
    """``epochs * steps`` releases, and a ``privacy_report`` equal to JAX's
    for the same count, the carried float32 spend included (per epoch in
    scan mode, per step in stepwise and looped mode)."""
    shards = split_clients(*make_cholesterol(120, seed=0), shares=SHARES)
    kw = dict(n_clients=3, data_shares=SHARES, server_batch=12)
    ts = SplitSession(mlp_adapter(T_MLP), SplitTrainConfig(**kw, privacy=DPConfig(**DP)),
                      adamw(1e-2), engine=engine, device="cpu")
    ts.fit(shards, epochs=3, steps_per_epoch=3)
    js = JSession(j_mlp_adapter(CHOLESTEROL_MLP), JConfig(**kw, privacy=JDPConfig(**DP)),
                  j_adamw(1e-2), engine=engine)
    js.fit(shards, epochs=3, steps_per_epoch=3)
    assert ts.privacy_report()["releases"] == 9
    assert ts.privacy_report() == js.privacy_report()
    assert ts.privacy_report(delta_prime=1e-3) == js.privacy_report(delta_prime=1e-3)


def test_restore_continues_the_schedule(tmp_path):
    """Save after 2 epochs, restore into a fresh session with the same seed:
    one more epoch equals the uninterrupted run's third, bit for bit (CPU)."""
    _, port_session, shards, _ = _cnn("e2e")
    a = port_session("auto", seed=3)
    a.fit(shards, epochs=2, steps_per_epoch=2)
    path = a.save(str(tmp_path))
    a.fit(shards, epochs=1, steps_per_epoch=2)
    b = port_session("auto", seed=3)
    b.restore(path)
    b.fit(shards, epochs=1, steps_per_epoch=2)
    for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert torch.equal(x, y)
    assert a.step_metrics[0]["loss"].tolist() == b.step_metrics[0]["loss"].tolist()


def test_engines_agree_on_uniform_shares():
    """Uniform shares: the fused engines and the looped reference consume the
    same plan; scan and stepwise are one loop of the same steps (equal
    losses), the looped reference equal to float32 reassociation (its loss
    is a mean over the concatenated batch, the fused one a mean of equal
    per-client means)."""
    shards = split_clients(*make_cholesterol(120, seed=0), shares=(1 / 3,) * 3)
    tc = SplitTrainConfig(server_batch=12, data_shares=(1.0, 1.0, 1.0))
    losses = {}
    for engine in ("fused-scan", "fused-stepwise", "looped-ref"):
        s = SplitSession(mlp_adapter(T_MLP), tc, adamw(1e-2), engine=engine, device="cpu")
        s.fit(shards, epochs=2, steps_per_epoch=3)
        losses[engine] = np.concatenate([m["loss"] for m in s.step_metrics])
    assert losses["fused-scan"].tolist() == losses["fused-stepwise"].tolist()
    np.testing.assert_allclose(losses["looped-ref"], losses["fused-scan"], rtol=1e-5)


def test_serve_spends_the_worst_clients_releases():
    """``serve`` answers a trace from the canonical state and advances the
    budget by the worst-case client's release count, as the reference."""
    _, port_session, shards, _ = _cnn("detached")
    s = port_session("auto")
    s.fit(shards, epochs=1, steps_per_epoch=2)
    trace = t_poisson_trace(3, rate=1.0, horizon=6, seed=0, shares=SHARES)
    assert trace.offered == poisson_trace(3, rate=1.0, horizon=6, seed=0,
                                          shares=SHARES).offered
    rep = s.serve(trace, shards, max_batch=4, request_batch=2)
    assert rep.answered == rep.offered > 0
    assert s.privacy_report()["releases"] == 2 + max(rep.releases_per_client)


def test_unported_paths_raise():
    _, port_session, shards, (xt, _) = _cnn("e2e")
    with pytest.raises(ValueError, match="unknown.*available"):
        port_session("no-such-engine")
    with pytest.raises(ValueError, match="mesh"):
        port_session("auto", mesh=object())
    s = port_session("auto")
    # faults= is rejected by a non-queue engine, with the reference's message
    with pytest.raises(ValueError, match="does not support faults"):
        s.fit(shards, epochs=1, steps_per_epoch=1, faults=object())
    # audit_privacy is ported: one row per sigma
    rows = s.audit_privacy(xt[:1], sigmas=(0.0, 2.0), steps=2)
    assert [r["sigma"] for r in rows] == [0.0, 2.0]
    assert all(r.keys() == {"sigma", "mse", "psnr_db", "ncc"} for r in rows)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        s.fit(shards, epochs=1, steps_per_epoch=0)
    # every engine of the reference is ported
    assert available_engines() == ["auto", "fedavg", "fused-queue", "fused-scan",
                                   "fused-stepwise", "llm-split", "looped-ref",
                                   "protocol-async"]


def test_readme_port_quickstart_runs():
    """The README's torch quickstart, as written (it trains on the CPU; a
    ``text`` fence, since the docs job installs no torch)."""
    with open(os.path.join(REPO, "README.md")) as f:
        blocks = re.findall(r"```(?:python|text)\n(.*?)```", f.read(), re.DOTALL)
    port = [b for b in blocks if "repro_torch" in b and "evaluate" in b]
    assert len(port) == 1
    scope = {}
    exec(compile(port[0], "README.md", "exec"), scope)
    metrics = scope["metrics"]
    assert all(np.isfinite(metrics[k]) for k in ("msle", "rmsle", "smape"))
    assert scope["session"].privacy_report()["releases"] == 0  # no guard in the snippet
    assert len(scope["session"].history) == 20


@pytest.mark.parametrize("engine,unroll", [("fused-scan", 2), ("fused-queue", 2),
                                           ("fused-scan", True), ("fused-queue", 0)])
def test_unroll_is_accepted_and_changes_nothing(engine, unroll):
    """``unroll`` as the reference takes it on the fused engines: a bool or
    an int of at least 0 runs with the metrics and state of a run without
    it (an epoch here is a Python loop, which has nothing to unroll); a
    negative one raises the ``ValueError`` of the reference's ``lax.scan``."""
    _, port_session, shards, _ = _cnn("detached")
    runs = []
    for opts in ({}, {"unroll": unroll}):
        s = port_session(engine, seed=2, **opts)
        runs.append((s.fit(shards, epochs=1, steps_per_epoch=2), s.state))
    assert runs[0][0] == runs[1][0]
    for x, y in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(x, y)
    assert s.engine.unroll == unroll
    with pytest.raises(ValueError, match="non-negative"):
        port_session(engine, unroll=-1)
