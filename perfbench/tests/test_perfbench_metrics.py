"""The trace reduction and each per-layer reader on canned events."""
import pytest

from perfbench import bench, trace, work
from perfbench.bench import load_json
from perfbench.tests.conftest import ROOT
from perfbench.trace import Event

MURA = load_json(ROOT / "perfbench/configs/mura-vgg19.json")
COVID = load_json(ROOT / "perfbench/configs/covid-ct-cnn.json")
BENCH = load_json(ROOT / "BENCHMARK.json")

# a 10 ms window: two kernels of the conv (1 ms each), a release of two
# launches (0.5 + 0.5 ms), a copy; the host draws the plan between them
EVENTS = [
    Event("perfbench.window", "cpu", 0.0, 10000.0, 0.0),
    Event("aten::normal_", "cpu", 100.0, 3100.0, 3000.0),
    Event("aten::normal_", "cpu", 3100.0, 4100.0, 1000.0),
    Event("aten::conv", "cpu", 4100.0, 4200.0, 100.0),
    Event("privacy_conv_tile<float, 1, true>", "device", 4200.0, 5200.0),
    Event("privacy_conv_tile<float, 1, true>", "device", 5000.0, 6000.0),
    Event("dp_release_partials<float>", "device", 6000.0, 6500.0),
    Event("dp_release_scaled<float>", "device", 6500.0, 7000.0),
    Event("Memcpy HtoD (Pageable -> Device)", "device", 9000.0, 9500.0),
]


def ctx(counts, cfg=COVID, events=EVENTS):
    busy = trace.busy_us(events, 0.0, 10000.0) / 1e6
    return bench.Context(events, 0.01, busy, counts, cfg)


def test_busy_gaps_and_breakdown():
    assert trace.busy_us(EVENTS, 0.0, 10000.0) == pytest.approx(3300.0)
    assert trace.idle_gaps(EVENTS, 0.0, 10000.0) == [(0.0, 4200.0), (7000.0, 9000.0),
                                                     (9500.0, 10000.0)]
    b = trace.breakdown(EVENTS, 0.0, 10000.0)
    assert b["device_ops"][0] == ["privacy_conv_tile<float, 1, true>", 0.002]
    # the gap's middle (2100 us) falls in the first draw; the others in no host op
    # but the window's span
    assert dict(b["idle_gaps"]) == {"aten::normal_": 0.0042,
                                    "perfbench.window": pytest.approx(0.0025)}


def test_host_op_is_the_innermost():
    cpu = [Event("outer", "cpu", 0, 100), Event("inner", "cpu", 10, 20),
           Event("later", "cpu", 30, 40)]
    assert trace.host_ops_at(cpu, [5, 15, 25, 35, 200]) == ["outer", "inner", "outer",
                                                            "later", "python"]


def test_readers():
    read = lambda name, c, cfg=COVID: bench.reader(name)(ctx(c, cfg))  # noqa: E731
    assert read("batch_fill_pct.serve", {"batches": 4, "batched_items": 24,
                                         "max_batch": 8}) == pytest.approx(75.0)
    assert read("batch_fill_pct.serve", {"batches": 0}) is None
    shape = (256, 64, 64, 1, 16)
    least = 2 * work.conv_work(*shape, 0.05)["bound_s"]
    assert read("privacy_conv_roofline.serve", {"privacy_conv_calls": 2,
                                                "privacy_conv_shape": shape}) == pytest.approx(
        100 * least / 0.002)
    assert read("privacy_conv_roofline.serve", {"privacy_conv_calls": 0}) is None
    rel = (3, 112, 112, 64)
    for name in ("dp_release_roofline.serve", "dp_release_roofline.train"):
        got = read(name, {"dp_release_calls": 1, "dp_release_shape": rel}, MURA)
        assert got == pytest.approx(100 * work.release_work(rel, 9.6896)["bound_s"] / 0.001,
                                    rel=1e-4)
    for name in ("mfu.serve", "mfu.train"):
        assert read(name, {"model_flops": 67e9}) == pytest.approx(10.0)
        assert read(name, {}) is None
    for name in ("device_idle_pct.serve", "device_idle_pct.train"):
        assert read(name, {}) == pytest.approx(67.0)
    assert read("plan_draw_ms_per_step.train", {"steps": 2}) == pytest.approx(2.0)
    assert read("plan_draw_ms_per_step.train", {"steps": 0}) is None


def test_a_reader_finds_nothing_without_its_kernels():
    bare = [e for e in EVENTS if e.kind == "cpu"]
    c = bench.Context(bare, 0.01, 0.0, {"privacy_conv_calls": 3, "dp_release_calls": 3,
                                        "privacy_conv_shape": (1, 8, 8, 1, 4),
                                        "dp_release_shape": (1, 4)}, COVID)
    for name in ("privacy_conv_roofline.serve", "dp_release_roofline.serve"):
        assert bench.reader(name)(c) is None


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_events_from_a_cpu_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("perfbench.window"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    events = trace.events_from_profiler(prof)
    names = {e.name for e in events}
    assert "perfbench.window" in names and "aten::normal_" in names
    assert all(e.kind == "cpu" and e.end_us >= e.start_us for e in events)
