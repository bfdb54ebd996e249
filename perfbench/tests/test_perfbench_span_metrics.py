"""The readers of the program's spans on canned events, each value worked
out by hand, and on a traced run of each cell at a small size on the CPU."""
import math

import pytest

from perfbench import bench, trace
from perfbench.bench import load_json
from perfbench.tests.conftest import ROOT, small_cell
from perfbench.trace import Event

COVID = load_json(ROOT / "perfbench/configs/covid-ct-cnn.json")
MURA = load_json(ROOT / "perfbench/configs/mura-vgg19.json")
SERVE = ("admission_ms_per_study.serve", "idle_in_admission_pct.serve",
         "trunk_wait_ms_per_cycle.serve")
TRAIN = ("plan_ms_per_step.train", "idle_in_plan_pct.train")

# a 10 ms window of two serve cycles. Device work 1500-4000 and 6000-7000,
# so the device idles over 0-1500, 4000-6000 and 7000-10000. Three
# admissions of 1 ms: the first wholly in a gap (1000 us idle), the second
# across a gap's end (300 us), the third across a gap's start (500 us); one
# more after the window, which no reader counts
SERVE_EVENTS = [
    Event("perfbench.window", "cpu", 0.0, 10000.0),
    Event("perfbench.unit", "cpu", 50.0, 9950.0),
    Event("serve.cycle", "cpu", 60.0, 4200.0),
    Event("serve.admit", "cpu", 100.0, 1100.0),
    Event("serve.admit", "cpu", 1200.0, 2200.0),
    Event("serve.batch", "cpu", 2200.0, 2300.0),
    Event("serve.trunk", "cpu", 2300.0, 2400.0),
    Event("serve.readback", "cpu", 2400.0, 4100.0),
    Event("serve.cycle", "cpu", 6400.0, 8600.0),
    Event("serve.admit", "cpu", 6500.0, 7500.0),
    Event("serve.batch", "cpu", 7500.0, 7600.0),
    Event("serve.trunk", "cpu", 7600.0, 7700.0),
    Event("serve.readback", "cpu", 7700.0, 8500.0),
    Event("serve.admit", "cpu", 10500.0, 11500.0),
    Event("conv_kernel", "device", 1500.0, 3000.0),
    Event("conv_kernel", "device", 3000.0, 4000.0),
    Event("dp_release_scaled<float>", "device", 6000.0, 7000.0),
]

# a 10 ms window of two steps: the device busy over 4000-5000 and
# 6000-9000. The first plan (0-4000) lies wholly in the first gap, the
# second (4500-6000) half in work and half in the gap 5000-6000
TRAIN_EVENTS = [
    Event("perfbench.window", "cpu", 0.0, 10000.0),
    Event("fit.plan", "cpu", 0.0, 4000.0),
    Event("fit.plan.draw", "cpu", 10.0, 3500.0),
    Event("fit.plan.copy", "cpu", 3500.0, 3990.0),
    Event("aten::normal_", "cpu", 20.0, 3400.0, 3380.0),
    Event("fit.step", "cpu", 4000.0, 4400.0),
    Event("fit.plan", "cpu", 4500.0, 6000.0),
    Event("fit.step", "cpu", 6000.0, 6500.0),
    Event("Memcpy HtoD (Pageable -> Device)", "device", 4000.0, 5000.0),
    Event("implicit_gemm", "device", 6000.0, 9000.0),
]


def ctx(events, counts=None, cfg=COVID):
    busy = trace.busy_us(events, 0.0, 10000.0) / 1e6
    return bench.Context(events, 0.01, busy, counts or {}, cfg)


def read(name, events, counts=None, cfg=COVID):
    return bench.reader(name)(ctx(events, counts, cfg))


def test_serve_readers():
    assert read("admission_ms_per_study.serve", SERVE_EVENTS) == pytest.approx(1.0)
    # (1000 + 300 + 500) us of 10000
    assert read("idle_in_admission_pct.serve", SERVE_EVENTS) == pytest.approx(18.0)
    # (1700 + 800) us over two dispatches
    assert read("trunk_wait_ms_per_cycle.serve", SERVE_EVENTS) == pytest.approx(1.25)


def test_train_readers():
    steps = {"steps": 2}
    # (4000 + 1500) us over two steps
    assert read("plan_ms_per_step.train", TRAIN_EVENTS, steps, MURA) == pytest.approx(2.75)
    # 4000 us wholly idle, 1000 of the second plan's 1500
    assert read("idle_in_plan_pct.train", TRAIN_EVENTS, steps, MURA) == pytest.approx(50.0)
    assert read("plan_ms_per_step.train", TRAIN_EVENTS, {"steps": 0}, MURA) is None


def test_a_gap_only_partly_in_an_admission_counts_only_its_overlap():
    events = [Event("perfbench.window", "cpu", 0.0, 10000.0),
              Event("serve.admit", "cpu", 2000.0, 3000.0),
              Event("serve.admit", "cpu", 3000.0, 3500.0),
              Event("k", "device", 0.0, 2500.0),
              Event("k", "device", 3200.0, 10000.0)]
    # the gap 2500-3200 meets the admissions over 2500-3200: 700 us
    assert read("idle_in_admission_pct.serve", events) == pytest.approx(7.0)
    # no gap at all inside the spans
    busy = events[:3] + [Event("k", "device", 0.0, 10000.0)]
    assert read("idle_in_admission_pct.serve", busy) == 0.0


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_without_the_programs_spans_a_reader_finds_nothing(name):
    """The parent's trace: the window, host operations and device work, but
    no span of the program."""
    bare = [e for e in SERVE_EVENTS + TRAIN_EVENTS
            if not e.name.startswith(("serve.", "fit."))]
    assert read(name, bare, {"steps": 2}) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_without_a_window_a_reader_finds_nothing(name):
    events = [e for e in SERVE_EVENTS + TRAIN_EVENTS if e.name != "perfbench.window"]
    assert read(name, events, {"steps": 2}) is None


@pytest.mark.parametrize("name", ["covid-serve-thin", "mura-train"])
def test_a_traced_cpu_run_reads_the_span_metrics(name, no_tf32):
    """On the CPU nothing runs on a device timeline, so the window is idle
    throughout and an idle share is its spans' share of the window: above
    0, below 100."""
    cell = small_cell(name)
    r = bench.run(cell, 2**31 + 8191, 0.3, True, "cpu")
    assert r["correct"], r["compared"]
    wanted = SERVE if name != "mura-train" else TRAIN
    got = {k: r["metrics"][k]["value"] for k in wanted}
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got
    assert all(v < 100 for k, v in got.items() if "_pct" in k), got
