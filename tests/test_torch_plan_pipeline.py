"""The engines' plan pipeline (``trainer.PlanPipeline``): the plans of the
epochs ahead drawn on host worker threads are bit for bit the plans drawn
inline, across ``fit`` calls, a change of shards, a ``restore`` and a new
``init``; the counters; the workers' lifecycle and errors; and the gate,
which leaves a CPU session on its inline path.

The gate engages only where the plan crosses to another device (a session
on the card), so these tests force it on by patching
``session.plans_cross``; on this CPU pinned memory cannot be had and the
workers draw into pageable memory, the fallback. The card's own case is
``tests/test_torch_gpu.py::test_plan_pipeline_on_the_card_draws_the_cpu_plans``.
This file imports neither ``jax`` nor ``repro``.
"""
import concurrent.futures
import dataclasses
import gc
import sys
import threading
import weakref

import pytest
import torch

from repro_torch.common.device import seeded_generator
from repro_torch.configs import COVID_CNN
from repro_torch.core import SplitSession, SplitTrainConfig, trainer
from repro_torch.core import session as session_mod
from repro_torch.core.adapters import cnn_adapter
from repro_torch.data import make_covid_ct, split_clients
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig

SHARES = (0.7, 0.2, 0.1)
SMALL = dict(input_hw=(16, 16), stages=((4, 1), (8, 1)), dense_units=(8,), privacy_noise=0.05)
SHARDS = split_clients(*make_covid_ct(60, hw=16, seed=0), shares=SHARES)
OTHER_SHARDS = split_clients(*make_covid_ct(45, hw=16, seed=3), shares=SHARES)


def _session(engine="auto", seed=0):
    return SplitSession(cnn_adapter(dataclasses.replace(COVID_CNN, **SMALL)),
                        SplitTrainConfig(n_clients=3, data_shares=SHARES, server_batch=12,
                                         mode="detached",
                                         privacy=DPConfig(epsilon=4.0, clip_norm=1.0)),
                        adamw(1e-2), engine=engine, seed=seed, device="cpu")


def _recording(sess):
    """``sess`` with every plan its engine takes kept in ``sess.plans``."""
    sess.plans = []
    take = sess.engine._next_plan

    def next_plan(*args):
        plan = take(*args)
        sess.plans.append(plan)
        return plan

    sess.engine._next_plan = next_plan
    return sess


def _force(monkeypatch):
    """The gate on, and three workers whatever the host's cores."""
    monkeypatch.setattr(session_mod, "plans_cross", lambda device: True)
    monkeypatch.setattr(trainer.os, "sched_getaffinity", lambda pid: set(range(8)))


@pytest.fixture
def forced(monkeypatch):
    _force(monkeypatch)


def _six_fits(sess, tmp_path):
    return [sess.fit(SHARDS, epochs=1, steps_per_epoch=1) for _ in range(6)]


def _one_fit(sess, tmp_path):
    return [sess.fit(SHARDS, epochs=4, steps_per_epoch=2)]


def _shards_change(sess, tmp_path):
    return ([sess.fit(SHARDS, epochs=1, steps_per_epoch=1) for _ in range(3)]
            + [sess.fit(OTHER_SHARDS, epochs=1, steps_per_epoch=1) for _ in range(3)])


def _restore_back(sess, tmp_path):
    out = [sess.fit(SHARDS, epochs=1, steps_per_epoch=1)]
    path = sess.save(str(tmp_path / "ckpt"))
    out += [sess.fit(SHARDS, epochs=1, steps_per_epoch=1) for _ in range(2)]
    sess.restore(path)
    return out + [sess.fit(SHARDS, epochs=1, steps_per_epoch=1) for _ in range(2)]


def _reinit(sess, tmp_path):
    out = [sess.fit(SHARDS, epochs=1, steps_per_epoch=1) for _ in range(2)]
    sess._native = sess.engine.init(7)
    return out + [sess.fit(SHARDS, epochs=1, steps_per_epoch=1) for _ in range(2)]


# scenario: (drive, plans drawn inline, plans taken from the workers)
SCENARIOS = {"six_fits": (_six_fits, 1, 5), "one_fit": (_one_fit, 1, 3),
             "shards_change": (_shards_change, 2, 4), "restore_back": (_restore_back, 2, 3),
             "reinit": (_reinit, 2, 2)}


@pytest.mark.parametrize("engine", ["auto", "looped-ref"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_plans_drawn_ahead_are_the_inline_plans(monkeypatch, tmp_path, engine, scenario):
    drive, inline, taken = SCENARIOS[scenario]
    want_sess = _recording(_session(engine))
    want = drive(want_sess, tmp_path / "inline")
    assert want_sess.engine._pipeline.threads == []
    _force(monkeypatch)
    got_sess = _recording(_session(engine))
    got = drive(got_sess, tmp_path / "ahead")
    assert len(got_sess.plans) == len(want_sess.plans)
    for g, w in zip(got_sess.plans, want_sess.plans):
        for name in ("idx", "model_noise", "guard_noise"):
            assert getattr(w, name) is not None
            assert torch.equal(getattr(g, name), getattr(w, name)), name
    assert [[r["loss"] for r in h] for h in got] == [[r["loss"] for r in h] for h in want]
    eng = got_sess.engine
    assert eng.plans_inline == inline
    assert eng.plans_ready + eng.plans_waited == taken
    assert want_sess.engine.plans_inline == len(want_sess.plans)
    assert want_sess.engine.plans_ready == want_sess.engine.plans_waited == 0


def _settle(eng):
    concurrent.futures.wait(list(eng._pipeline._queued.values()))


def test_counters_ready_and_waited(forced, monkeypatch):
    sess = _session()
    eng = sess.engine
    sess.fit(SHARDS, epochs=1, steps_per_epoch=1)
    assert (eng.plans_inline, eng.plans_ready, eng.plans_waited) == (1, 0, 0)
    assert sorted(e for _, e in eng._pipeline._queued) == [2, 3, 4]
    _settle(eng)
    sess.fit(SHARDS, epochs=1, steps_per_epoch=1)
    _settle(eng)
    assert (eng.plans_inline, eng.plans_ready, eng.plans_waited) == (1, 1, 0)
    # the draws queued from here on hold until the step's thread waits
    go = threading.Event()
    draw, wait = session_mod._draw_ahead, session_mod.wait

    def held(*args):
        go.wait(60)
        return draw(*args)

    def waiting(futures):
        go.set()
        return wait(futures)

    monkeypatch.setattr(session_mod, "_draw_ahead", held)
    monkeypatch.setattr(session_mod, "wait", waiting)
    sess.fit(SHARDS, epochs=1, steps_per_epoch=1)  # epoch 3; 6 queued, held
    sess.fit(SHARDS, epochs=2, steps_per_epoch=1)  # epochs 4 and 5, drawn before the hold
    assert (eng.plans_inline, eng.plans_ready, eng.plans_waited) == (1, 4, 0)
    assert not go.is_set()
    sess.fit(SHARDS, epochs=1, steps_per_epoch=1)  # epoch 6: waits on its draw
    assert (eng.plans_inline, eng.plans_ready, eng.plans_waited) == (1, 4, 1)


def test_a_worker_error_is_raised_by_the_fit_that_takes_its_plan(forced, monkeypatch):
    def planted(*args):
        raise RuntimeError("planted in a worker's draw")

    monkeypatch.setattr(session_mod, "_draw_ahead", planted)
    sess = _session()
    sess.fit(SHARDS, epochs=1, steps_per_epoch=1)  # drawn inline
    with pytest.raises(RuntimeError, match="planted in a worker's draw"):
        sess.fit(SHARDS, epochs=1, steps_per_epoch=1)
    assert sess.engine._epochs_done == 1


def test_dropping_the_session_stops_the_workers_and_frees_the_plans(forced):
    sess = _session()
    sess.fit(SHARDS, epochs=1, steps_per_epoch=1)
    eng = sess.engine
    threads = eng._pipeline.threads
    assert 1 <= len(threads) <= eng._pipeline.workers
    assert all(t.is_alive() for t in threads)
    _settle(eng)
    plans = [weakref.ref(f.result().model_noise) for f in eng._pipeline._queued.values()]
    assert plans
    engine = weakref.ref(eng)
    del sess, eng
    gc.collect()
    assert engine() is None
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert all(p() is None for p in plans)


def test_a_cpu_session_starts_no_thread_and_draws_every_plan_inline():
    sess = _session()
    for _ in range(3):
        sess.fit(SHARDS, epochs=2, steps_per_epoch=1)
    eng = sess.engine
    assert (eng.plans_inline, eng.plans_ready, eng.plans_waited) == (6, 0, 0)
    assert eng._pipeline._pool is None and not eng._pipeline._queued
    assert not trainer.plans_cross("cpu")


def test_a_plan_over_the_byte_cap_is_drawn_inline(forced, monkeypatch):
    monkeypatch.setattr(trainer, "PLAN_AHEAD_BYTES", 1)
    sess = _session()
    for _ in range(3):
        sess.fit(SHARDS, epochs=1, steps_per_epoch=1)
    assert sess.engine.plans_inline == 3 and sess.engine._pipeline.threads == []


@pytest.mark.parametrize("cores,workers", [(1, 1), (2, 1), (3, 2), (4, 3), (64, 3)])
def test_workers_follow_the_cores(monkeypatch, cores, workers):
    monkeypatch.setattr(trainer.os, "sched_getaffinity", lambda pid: set(range(cores)))
    assert trainer.PlanPipeline().workers == workers


def test_the_lookahead_is_the_workers_within_the_byte_cap(monkeypatch):
    monkeypatch.setattr(trainer, "PLAN_AHEAD_BYTES", 250)
    pipeline = trainer.PlanPipeline()
    pipeline.workers = 3
    pipeline.ahead("k", 1, lambda e: e, plan_bytes=100)
    assert sorted(e for _, e in pipeline._queued) == [2, 3]
    pipeline.take("k", 2)
    pipeline.ahead("k", 2, lambda e: e, plan_bytes=100)
    assert sorted(e for _, e in pipeline._queued) == [3, 4]
    assert pipeline.take("other", 5) is None and not pipeline._queued
    monkeypatch.setattr(trainer, "PLAN_AHEAD_BYTES", 1000)
    pipeline.ahead("other", 5, lambda e: e, plan_bytes=100)
    assert sorted(e for _, e in pipeline._queued) == [6, 7, 8]


def test_a_pinned_draw_falls_back_to_pageable_memory_with_the_same_bits():
    t = trainer._host_empty((2, 3), torch.float32, pin=True)
    assert t.shape == (2, 3) and t.dtype == torch.float32
    planner = trainer.make_sample_plan(
        cnn_adapter(dataclasses.replace(COVID_CNN, **SMALL)),
        SplitTrainConfig(n_clients=3, data_shares=SHARES, server_batch=12,
                         privacy=DPConfig(epsilon=4.0, clip_norm=1.0)), 2)
    lens = [len(x) for x, _ in SHARDS]
    pinned = planner.draw(lens, (16, 16, 1), seeded_generator(5, 1), pin=True)
    plain = planner(lens, (16, 16, 1), seeded_generator(5, 1), "cpu")
    names = ("idx", "model_noise", "guard_noise")
    for name in names:
        assert torch.equal(getattr(pinned, name), getattr(plain, name)), name
    assert pinned.nbytes == sum(getattr(plain, n).numel() * getattr(plain, n).element_size()
                                for n in names)


def test_many_fits_under_a_short_switch_interval_keep_the_bits(monkeypatch):
    """The step's thread and three workers with the interpreter switching
    threads every microsecond: every plan is still the inline plan."""
    drive = [(1, 1), (3, 1), (1, 2), (2, 2), (1, 1), (4, 1), (1, 1)]
    want_sess = _recording(_session())
    for epochs, steps in drive:
        want_sess.fit(SHARDS, epochs=epochs, steps_per_epoch=steps)
    _force(monkeypatch)
    got_sess = _recording(_session())
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for epochs, steps in drive:
            got_sess.fit(SHARDS, epochs=epochs, steps_per_epoch=steps)
    finally:
        sys.setswitchinterval(switch)
    assert len(got_sess.plans) == len(want_sess.plans) == 13
    for g, w in zip(got_sess.plans, want_sess.plans):
        assert all(torch.equal(getattr(g, n), getattr(w, n))
                   for n in ("idx", "model_noise", "guard_noise"))
    eng = got_sess.engine
    assert eng.plans_inline == 3 and eng.plans_ready + eng.plans_waited == 10
