"""The port's fault subsystem (``repro_torch.core.faults`` and the faults
branches of ``protocol.drive_protocol``) against ``repro.core.faults``.

Every schedule is host NumPy with the reference's stream constants, so the
port must equal the JAX package exactly: availability, up masks, cycle
quanta, reweighted shares and the transport draws, by a seeded Hypothesis
sweep, and the fleet cycle planner likewise. The engines under a chaos plan
are held against the JAX queue engines on JAX's weights and noise (fed
through ``noise_fn``): ``fault_stats``, queue stats and ``dropped``/``drained``
exact; losses and state leaves within 1e-5 (float32 dense layers summed in
another order; relative to the loss, which is ~1e4 for the cholesterol MLP).
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.paper_models import CHOLESTEROL_MLP as J_MLP
from repro.core import FaultPlan as JFaultPlan
from repro.core import SplitSession as JSession
from repro.core import SplitTrainConfig as JConfig
from repro.core.adapters import mlp_adapter as j_mlp_adapter
from repro.core.protocol import _plan_round_robin_cycle as j_plan_cycle
from repro.data import make_cholesterol, split_clients
from repro.optim import adamw as j_adamw
from repro.privacy import DPConfig as JDPConfig
from repro.privacy.guard import GUARD_KEY_FOLD
from repro_torch.common.bridge import to_torch
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import CHOLESTEROL_MLP
from repro_torch.core import ClientLoopError, FaultPlan, SplitSession, SplitTrainConfig
from repro_torch.core.adapters import mlp_adapter
from repro_torch.core.protocol import _plan_round_robin_cycle
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig
from repro_torch.privacy.accountant import composed_epsilon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
DP = dict(epsilon=1.0, delta=1e-5, clip_norm=1.0)
QUEUE_ENGINES = ("protocol-async", "fused-queue")
# the chip smoke's chaos plan: a crash window, rotating dropout, a 2x
# straggler, transport drops and duplicates, a quorum of one
CHAOS = dict(n_clients=3, seed=0, crash_windows={1: [(4, 9)]}, dropout_frac=0.34,
             dropout_period=10, dropout_down=3, straggle={2: 2.0}, drop_prob=0.05,
             dup_prob=0.05, halt_below=1)
SWEEP = settings(max_examples=60, deadline=None, derandomize=True)


@pytest.fixture(scope="module")
def chol_shards():
    x, y = make_cholesterol(600, seed=0)
    return split_clients(x, y)


def jax_noise_fn(seed: int, step: int):
    """The JAX queue engines' draws: key ``fold_in(fold_in(fold_in(root,
    step), client), release)`` for the model noise, its ``GUARD_KEY_FOLD``
    fold for the guard's (``repro/core/session.py:442-455``,
    ``protocol.py:150-158``)."""
    root = jax.random.PRNGKey(seed)

    def noise_fn(client, release, model_shape, guard_shape):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(root, step), client),
                               release)
        return (np.asarray(jax.random.normal(k, model_shape, jnp.float32)),
                np.asarray(jax.random.normal(jax.random.fold_in(k, GUARD_KEY_FOLD),
                                             guard_shape, jnp.float32)))

    return noise_fn


def _pair(engine, production, dp=True, **kw):
    """A JAX session and a port session on the JAX session's weights."""
    jcfg = JConfig(server_batch=48, privacy=JDPConfig(**DP) if dp else None)
    tcfg = SplitTrainConfig(server_batch=48, privacy=DPConfig(**DP) if dp else None)
    js = JSession(j_mlp_adapter(J_MLP), jcfg, j_adamw(1e-2), engine=engine, seed=0,
                  threaded=False, production=production, **kw)
    ps = SplitSession(mlp_adapter(CHOLESTEROL_MLP), tcfg, adamw(1e-2), engine=engine,
                      seed=0, device="cpu", threaded=False, production=production, **kw)
    ps._native = ps.engine.from_canonical(to_torch(jax.device_get(js.state), "cpu"))
    return js, ps


def _fit_both(js, ps, shards, *, epochs, steps, jplan=None, plan=None):
    ps.engine.noise_fn = jax_noise_fn(0, int(ps.state["step"]))
    jh = js.fit(shards, epochs=epochs, steps_per_epoch=steps, faults=jplan)
    ph = ps.fit(shards, epochs=epochs, steps_per_epoch=steps, faults=plan)
    return jh, ph


def _assert_close_to_jax(js, ps):
    assert len(js.engine.losses) == len(ps.engine.losses)
    np.testing.assert_allclose(ps.engine.losses, js.engine.losses, **TOL)
    jl, pl = jax.tree.leaves(js.state), tree_leaves(ps.state)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)


def _assert_bitwise(sa, sb):
    la, lb = tree_leaves(sa.state), tree_leaves(sb.state)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert torch.equal(a, b)


# --------------------------------------------------- schedules, exactly
@st.composite
def _plans(draw):
    n = draw(st.integers(1, 6))
    windows = {c: [tuple(sorted(draw(st.lists(st.integers(0, 40), min_size=2,
                                              max_size=2))))]
               for c in draw(st.lists(st.integers(0, n - 1), max_size=n, unique=True))}
    period = draw(st.integers(1, 20))
    drop = draw(st.floats(0.0, 0.5))
    kw = dict(n_clients=n, seed=draw(st.integers(0, 2 ** 31 - 1)), crash_windows=windows,
              dropout_frac=draw(st.sampled_from([0.0, 0.2, 0.34, 0.5, 1.0])),
              dropout_period=period, dropout_down=draw(st.integers(1, period)),
              straggle={c: draw(st.floats(1.0, 4.0))
                        for c in draw(st.lists(st.integers(0, n - 1), max_size=n,
                                               unique=True))},
              drop_prob=drop, dup_prob=draw(st.floats(0.0, 1.0 - drop)),
              share_skew=draw(st.one_of(st.none(), st.lists(
                  st.floats(0.1, 3.0), min_size=n, max_size=n).map(tuple))),
              halt_below=draw(st.integers(0, n)))
    shares = draw(st.lists(st.floats(0.01, 1.0), min_size=n, max_size=n))
    return kw, shares


@SWEEP
@given(_plans())
def test_fault_plan_schedules_equal_jax(case):
    """Every schedule of a FaultPlan is the reference's, value for value:
    the plan is host NumPy with the reference's stream constants."""
    kw, shares = case
    plan, jplan = FaultPlan(**kw), JFaultPlan(**kw)
    assert plan.describe() == jplan.describe()
    for step in range(0, 45):
        assert plan.up_mask(step) == jplan.up_mask(step)
        assert plan.quorum_lost(step) == jplan.quorum_lost(step)
        assert plan.cycle_quanta(step, shares) == jplan.cycle_quanta(step, shares)
        up = plan.up_mask(step)
        assert plan.effective_shares(shares, up) == jplan.effective_shares(shares, up)
    for c in range(kw["n_clients"]):
        assert plan.straggler_sleep(c, 0.002) == jplan.straggler_sleep(c, 0.002)
    run, jrun = plan.start_run(7), jplan.start_run(7)
    for i in range(60):
        c = i % kw["n_clients"]
        assert run.transit(c) == jrun.transit(c)
    run.note_cycle(plan.up_mask(3))
    jrun.note_cycle(jplan.up_mask(3))
    run.halt("x")
    jrun.halt("x")
    assert run.stats() == jrun.stats()


@st.composite
def _cycle_cases(draw):
    n = draw(st.integers(1, 6))
    quanta = draw(st.lists(st.integers(0, 12), min_size=n, max_size=n))
    queue_size = draw(st.integers(1, 16))
    queue_len = draw(st.integers(0, queue_size))
    total = draw(st.integers(0, 60))
    step = draw(st.integers(0, total))
    available = draw(st.one_of(st.none(), st.lists(st.booleans(), min_size=n, max_size=n)))
    return queue_len, queue_size, step, total, quanta, available


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_cycle_cases())
def test_cycle_planner_equals_jax(case):
    """The fleet cycle planner is the reference's, count for count."""
    queue_len, queue_size, step, total, quanta, available = case
    assert (_plan_round_robin_cycle(queue_len, queue_size, step, total, quanta, available)
            == j_plan_cycle(queue_len, queue_size, step, total, quanta, available=available))


def test_plan_validation():
    for bad in (dict(n_clients=0), dict(n_clients=2, dropout_frac=1.5),
                dict(n_clients=2, dropout_frac=0.5, dropout_down=30, dropout_period=20),
                dict(n_clients=2, drop_prob=0.7, dup_prob=0.6),
                dict(n_clients=2, straggle={0: 0.5}), dict(n_clients=2, share_skew=(1.0,))):
        with pytest.raises(ValueError):
            FaultPlan(**bad)
    assert FaultPlan.none(3) == FaultPlan(n_clients=3)
    assert FaultPlan.dropout(3, 0.3, seed=7, period=10, down_for=5).dropout_frac == 0.3
    assert FaultPlan.straggler(3, {1: 2.0}).straggle == {1: 2.0}
    assert FaultPlan.imbalance(3, (1.0, 2.0, 3.0)).share_skew == (1.0, 2.0, 3.0)


# ------------------------------------------------ engines against JAX
@pytest.mark.parametrize("engine", QUEUE_ENGINES)
@pytest.mark.parametrize("production", ("fleet", "per-item"))
def test_chaos_run_matches_jax(chol_shards, engine, production):
    """The chip smoke's chaos plan on the CPU, two fits (the second resumes
    the schedule from the canonical step): counts exact, numbers 1e-5."""
    js, ps = _pair(engine, production)
    seen = []
    for _ in range(2):
        _fit_both(js, ps, chol_shards, epochs=2, steps=6, jplan=JFaultPlan(**CHAOS),
                  plan=FaultPlan(**CHAOS))
        assert ps.fault_stats == js.fault_stats
        assert ps.engine.stats == js.engine.stats
        assert ps.privacy_report() == js.privacy_report()
        _assert_close_to_jax(js, ps)
        seen.append(ps.fault_stats)
        for t, rep in zip(ps.fault_stats["releases_per_client"],
                          ps.fault_stats["per_client_privacy"]):
            assert rep == composed_epsilon(DPConfig(**DP), t)
    # the run went through a down window and a transport fault
    assert sum(sum(fs["down_cycles"]) for fs in seen) > 0
    assert sum(sum(fs["transit_dropped"]) + sum(fs["duplicated"]) for fs in seen) > 0


@pytest.mark.parametrize("halt_below,crash", [(2, {0: [(5, 10 ** 6)], 1: [(5, 10 ** 6)]}),
                                              (0, {c: [(0, 10 ** 6)] for c in range(3)})])
def test_halts_match_jax(chol_shards, halt_below, crash):
    """The quorum halt and the all-down halt: clean, with the reference's
    reason, the epoch loop stopped early."""
    js, ps = _pair("protocol-async", "fleet", dp=False)
    kw = dict(n_clients=3, crash_windows=crash, halt_below=halt_below)
    jh, ph = _fit_both(js, ps, chol_shards, epochs=3, steps=10, jplan=JFaultPlan(**kw),
                       plan=FaultPlan(**kw))
    assert ps.fault_stats["halted"] and ps.fault_stats == js.fault_stats
    assert [h.get("halted") for h in ph] == [h.get("halted") for h in jh]
    assert ph[-1]["halted"] is True and len(ph) < 3
    assert int(ps.state["step"]) == int(js.state["step"])


# ------------------------------------------------ inside torch
@pytest.mark.parametrize("engine", QUEUE_ENGINES)
@pytest.mark.parametrize("production", ("fleet", "per-item"))
def test_none_plan_bit_exact(chol_shards, engine, production):
    """FaultPlan.none() takes the fault-aware branches and changes nothing."""
    def fit(faults):
        s = SplitSession(mlp_adapter(CHOLESTEROL_MLP),
                         SplitTrainConfig(server_batch=48, privacy=DPConfig(**DP)),
                         adamw(1e-2), engine=engine, seed=0, device="cpu", threaded=False,
                         production=production)
        return s, s.fit(chol_shards, epochs=2, steps_per_epoch=6, faults=faults)

    s0, h0 = fit(None)
    s1, h1 = fit(FaultPlan.none(3))
    assert h0 == h1 and s0.engine.stats == s1.engine.stats
    _assert_bitwise(s0, s1)
    assert s1.fault_stats["halted"] is False and max(s1.fault_stats["releases_per_client"]) > 0


@pytest.mark.parametrize("engine", QUEUE_ENGINES)
def test_mid_fault_save_restore_resumes_schedule(chol_shards, engine, tmp_path):
    def session():
        return SplitSession(mlp_adapter(CHOLESTEROL_MLP),
                            SplitTrainConfig(server_batch=48, privacy=DPConfig(**DP)),
                            adamw(1e-2), engine=engine, seed=0, device="cpu",
                            threaded=False)

    sa = session()
    sa.fit(chol_shards, epochs=1, steps_per_epoch=7, faults=FaultPlan(**CHAOS))
    path = sa.save(str(tmp_path))
    sb = session()
    sb.restore(path)
    ha = sa.fit(chol_shards, epochs=1, steps_per_epoch=7, faults=FaultPlan(**CHAOS))
    hb = sb.fit(chol_shards, epochs=1, steps_per_epoch=7, faults=FaultPlan(**CHAOS))
    assert ha == hb and sa.fault_stats == sb.fault_stats
    _assert_bitwise(sa, sb)


def test_client_thread_exception_surfaces(chol_shards):
    """A raising client thread (here its noise_fn) surfaces as
    ClientLoopError with the cause, and lands in fault_stats."""
    def bad_noise(client, release, model_shape, guard_shape):
        if client == 2:
            raise KeyError("no draws for client 2")
        return np.zeros(model_shape, np.float32), np.zeros(guard_shape, np.float32)

    session = SplitSession(mlp_adapter(CHOLESTEROL_MLP), SplitTrainConfig(server_batch=48),
                           adamw(1e-2), engine="protocol-async", seed=0, device="cpu",
                           threaded=True, fleet_chunk=2, pop_timeout=0.05, noise_fn=bad_noise)
    with pytest.raises(ClientLoopError) as ei:
        session.fit(chol_shards, epochs=1, steps_per_epoch=10 ** 6)
    assert ei.value.client_id == 2 and isinstance(ei.value.cause, KeyError)
    fs = session.fault_stats
    assert fs["client_error_id"] == 2 and "KeyError" in fs["client_error"]


def test_faults_rejected_by_non_queue_engines(chol_shards):
    session = SplitSession(mlp_adapter(CHOLESTEROL_MLP), SplitTrainConfig(server_batch=48),
                           adamw(1e-2), engine="looped-ref", seed=0, device="cpu")
    with pytest.raises(ValueError, match="does not support faults"):
        session.fit(chol_shards, epochs=1, steps_per_epoch=2, faults=FaultPlan.none(3))
    queue = SplitSession(mlp_adapter(CHOLESTEROL_MLP), SplitTrainConfig(server_batch=48),
                         adamw(1e-2), engine="protocol-async", seed=0, device="cpu")
    with pytest.raises(ValueError, match="covers 5 clients"):
        queue.fit(chol_shards, epochs=1, steps_per_epoch=1, faults=FaultPlan.none(5))


def test_readme_faults_example_runs():
    """The README's fault-injection example in torch, as written (on the
    CPU; a ``text`` fence)."""
    with open(os.path.join(REPO, "README.md")) as f:
        blocks = re.findall(r"```(?:python|text)\n(.*?)```", f.read(), re.DOTALL)
    (block,) = [b for b in blocks if "repro_torch" in b and "FaultPlan" in b]
    scope = {}
    exec(compile(block, "README.md", "exec"), scope)
    fs = scope["session"].fault_stats
    assert sum(fs["down_cycles"]) > 0 and len(fs["releases_per_client"]) == 3
    assert scope["session"].privacy_report()["releases"] == max(fs["releases_per_client"])
    assert dataclasses.is_dataclass(scope["plan"])
