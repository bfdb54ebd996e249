"""The port's spans (``repro_torch.common.tracing``) and the serve loop's
wall-clock stamps.

With no profiler recording, ``span`` hands out one shared no-op object and
never builds a ``record_function``. Under ``torch.profiler`` a small
COVID-CT ``SplitSession.serve`` and a fused ``fit`` open every span of
the serving drive and of the fused engine, as many times as the report and
the fit say, each child inside its parent; the profiler changes neither
the served answers nor the losses, bit for bit. Every answered study's
stamps are ordered: from its arrival cycle, from its push, in the queue.
"""
import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.common import tracing
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import COVID_CNN
from repro_torch.core import SplitSession, SplitTrainConfig
from repro_torch.core.adapters import cnn_adapter
from repro_torch.data import make_covid_ct, split_clients
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig
from repro_torch.serving import poisson_trace

SHARES = (0.7, 0.2, 0.1)
SMALL = dict(input_hw=(16, 16), stages=((4, 1), (8, 1)), dense_units=(8,), use_kernel=True)
DP = dict(epsilon=2.0, clip_norm=1.0, use_kernel=True)
# 5 studies a cycle against 2 popped: a queue builds, so studies wait
KNOBS = dict(max_batch=2, queue_size=32, request_batch=2)
EPOCHS, STEPS = 2, 2

SERVE_PARENTS = {"serve.admit": "serve.cycle", "serve.batch": "serve.cycle",
                 "serve.trunk": "serve.cycle", "serve.readback": "serve.cycle",
                 "serve.cycle": "test.serve", "serve.build": "test.serve",
                 "serve.open": "test.serve", "serve.close": "test.serve"}
FIT_PARENTS = {"fit.shards": "test.fit", "fit.plan": "test.fit",
               "fit.plan.draw": "fit.plan", "fit.plan.copy": "fit.plan",
               "fit.step": "test.fit", "fit.forward": "fit.step",
               "fit.backward": "fit.step", "fit.update": "fit.step",
               "fit.readout": "test.fit"}


@pytest.fixture(scope="module")
def shards():
    return split_clients(*make_covid_ct(48, hw=16, seed=0), shares=SHARES)


def _session(mode="detached"):
    tc = SplitTrainConfig(n_clients=3, data_shares=SHARES, server_batch=12, mode=mode,
                          privacy=DPConfig(**DP))
    return SplitSession(cnn_adapter(dataclasses.replace(COVID_CNN, **SMALL)), tc,
                        adamw(1e-2), engine="auto", seed=1, device="cpu")


def _trace():
    return poisson_trace(3, rate=5.0, horizon=6, seed=3, shares=SHARES)


def _spans(prof, prefixes):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(prefixes)]


def _count(spans, name):
    return sum(n == name for n, _, _ in spans)


def _assert_nested(spans, parents):
    for name, s, e in spans:
        if name not in parents:
            continue
        outer = [(ps, pe) for pn, ps, pe in spans if pn == parents[name]]
        assert any(ps <= s and e <= pe for ps, pe in outer), (name, s, e, parents[name])


def test_off_span_is_one_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "_ON", refuse)
    assert not torch._C._autograd._profiler_enabled()
    got = {id(tracing.span(n)) for n in ("serve.admit", "fit.step", "x")}
    assert got == {id(tracing._OFF)}
    with tracing.span("serve.cycle"), tracing.span("serve.admit"):
        pass


def test_off_path_calls_no_record_function(monkeypatch, shards):
    """A whole serve and fit with no profiler open no profiler range."""
    calls = []
    for owner, attr in ((torch.profiler, "record_function"), (tracing, "_ON")):
        real = getattr(owner, attr)
        monkeypatch.setattr(owner, attr,
                            lambda name, real=real: calls.append(name) or real(name))
    sess = _session()
    sess.serve(_trace(), shards, **KNOBS)
    sess.fit(shards, epochs=1, steps_per_epoch=1)
    assert calls == []


def test_on_span_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("fit.plan"):
            torch.ones(3).sum()
    assert _count(_spans(prof, ("fit.",)), "fit.plan") == 1


def test_serve_spans_count_and_nest(shards):
    sess = _session()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.serve"):
            rep = sess.serve(_trace(), shards, **KNOBS)
    spans = _spans(prof, ("serve.", "test."))
    assert rep.offered > 0 and rep.batches > 0
    want = {"serve.build": 1, "serve.open": 1, "serve.close": 1,
            "serve.cycle": rep.cycles, "serve.batch": rep.cycles,
            "serve.admit": rep.offered,
            "serve.trunk": rep.batches, "serve.readback": rep.batches}
    assert {n: _count(spans, n) for n in want} == want
    _assert_nested(spans, SERVE_PARENTS)
    # in each cycle the admissions come first, then the batch, the trunk's
    # launch and the readback
    for _, cs, ce in [x for x in spans if x[0] == "serve.cycle"]:
        inner = sorted((s, n) for n, s, e in spans
                       if cs <= s and e <= ce and n in ("serve.admit", "serve.batch",
                                                        "serve.trunk", "serve.readback"))
        order = [n for _, n in inner]
        firsts = [order.index(n) for n in ("serve.batch", "serve.trunk", "serve.readback")
                  if n in order]
        assert firsts == sorted(firsts)
        assert all(n == "serve.admit" for n in order[:order.index("serve.batch")])


@pytest.mark.parametrize("mode", ["detached", "e2e"])
def test_fit_spans_count_and_nest(shards, mode):
    sess = _session(mode)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.fit"):
            sess.fit(shards, epochs=EPOCHS, steps_per_epoch=STEPS)
    spans = _spans(prof, ("fit.", "test."))
    steps = EPOCHS * STEPS
    want = {"fit.shards": 1, "fit.plan": EPOCHS, "fit.plan.draw": EPOCHS,
            "fit.plan.copy": EPOCHS, "fit.step": steps, "fit.forward": steps,
            "fit.backward": steps, "fit.update": steps, "fit.readout": EPOCHS}
    assert {n: _count(spans, n) for n in want} == want
    _assert_nested(spans, FIT_PARENTS)


def test_the_profiler_changes_no_answer_and_no_loss(shards):
    reports, metrics, states = [], [], []
    for on in (False, True):
        sess = _session()
        with profile(activities=[ProfilerActivity.CPU]) if on else contextlib.nullcontext():
            reports.append(sess.serve(_trace(), shards, **KNOBS))
            sess.fit(shards, epochs=EPOCHS, steps_per_epoch=STEPS)
        metrics.append(sess.step_metrics)
        states.append(sess.state)
    off, on = reports
    assert off.fingerprint() == on.fingerprint()
    assert off.deterministic_stats() == on.deterministic_stats()
    for a, b in zip(*metrics):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(tree_leaves(states[0]), tree_leaves(states[1])):
        assert torch.equal(a, b)


def test_stamps_are_ordered_and_outside_the_digest(shards):
    rep = _session().serve(_trace(), shards, **KNOBS)
    answered = set(rep.responses)
    assert answered and set(rep.latency_ms) == answered
    assert set(rep.arrival_latency_ms) == set(rep.queue_ms) == answered
    for rid in answered:
        assert rep.arrival_latency_ms[rid] >= rep.latency_ms[rid] >= rep.queue_ms[rid] >= 0
    assert max(rep.queue_ms.values()) > 0  # the queue built up
    stats = rep.deterministic_stats()
    assert not {"latency_ms", "arrival_latency_ms", "queue_ms"} & set(stats)
    digest = rep.fingerprint()
    rep.arrival_latency_ms = {rid: v + 1.0 for rid, v in rep.arrival_latency_ms.items()}
    rep.queue_ms = {}
    assert rep.fingerprint() == digest


def test_no_record_function_outside_the_tracing_module():
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                   if any(w in p.read_text() for w in ("record_function", "RecordFunction")))
    assert users == ["common/tracing.py"]
