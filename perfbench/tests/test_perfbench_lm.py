"""The LM cell's pieces: its readers on canned events, the operations and
bytes of ``work_lm`` at the published widths, a planted fault in the
program coming out not correct, the plain reference giving one loss on
one seed, and the runner failing at once where the program lacks
the configuration's type (as the parent of the change that added it
does)."""
import math
import sys

import pytest
import torch

from perfbench import bench, trace, work, work_lm
from perfbench.bench import load_json
from perfbench.reference import jamba as ref
from perfbench.tests.conftest import ROOT, small_cell
from perfbench.trace import Event
from perfbench.weights_lm import make_tokens, make_weights

JAMBA = load_json(ROOT / "perfbench/configs/ai21-jamba2-3b.json")
SEED = 2**31 + 4099
SHAPE = (3, 8192, 5120, 16)

# a 100 ms window: the scan's forward (10 ms) and backward (20 ms), a GEMM
# (40 ms), a release of two launches (1 ms each) and 28 ms idle
EVENTS = [
    Event("perfbench.window", "cpu", 0.0, 100000.0, 0.0),
    Event("void (anonymous namespace)::selective_scan_kernel<4, 4, __nv_bfloat16>(...)",
          "device", 0.0, 10000.0),
    Event("void (anonymous namespace)::selective_scan_bwd_kernel<__nv_bfloat16>(...)",
          "device", 10000.0, 30000.0),
    Event("sm90_xmma_gemm_bf16bf16_bf16f32", "device", 30000.0, 70000.0),
    Event("dp_release_partials<__nv_bfloat16, float>", "device", 70000.0, 71000.0),
    Event("dp_release_scaled<__nv_bfloat16, float>", "device", 71000.0, 72000.0),
]
COUNTS = {"steps": 1, "rows": 3, "model_flops": 4.4e14, "scan_forward_launches": 3,
          "scan_backward_launches": 1, "scan_client_launches": 2,
          "scan_trunk_shape": SHAPE, "scan_client_shape": (1,) + SHAPE[1:], "scan_u_bytes": 2,
          "dp_release_calls": 1, "dp_release_shape": (3, 8192, 2560), "dp_release_x_bytes": 2,
          "dp_release_noise_bytes": 4}


def ctx(counts=COUNTS, events=EVENTS):
    busy = trace.busy_us(events, 0.0, 100000.0) / 1e6
    return bench.Context(events, 0.1, busy, counts, JAMBA)


def test_the_readers_on_canned_events():
    c = ctx()
    assert bench.reader("device_idle_pct.train")(c) == pytest.approx(28.0)
    assert bench.reader("scan_share_pct.lm_train")(c) == pytest.approx(100 * 30 / 72)
    assert bench.reader("mfu.lm_train")(c) == pytest.approx(100 * 4.4e14 / 0.1 / 989e12)
    least = (2 * work_lm.scan_forward_bytes(1, 8192, 5120, 16, 2, False)
             + work_lm.scan_forward_bytes(*SHAPE, 2, True)
             + work_lm.scan_backward_bytes(*SHAPE, 2))
    assert bench.reader("selective_scan_roofline.lm_train")(c) == pytest.approx(
        100 * least / work.PEAK_BYTES_PER_S / 0.03)
    rel = 3 * 8192 * 2560 * (2 + 2 + 4)
    assert bench.reader("dp_release_roofline.lm_train")(c) == pytest.approx(
        100 * rel / work.PEAK_BYTES_PER_S / 0.002)


def test_the_readers_read_nothing_where_nothing_ran():
    bare = [EVENTS[0]]
    zero = dict(COUNTS, scan_forward_launches=0, dp_release_calls=0, model_flops=0)
    for name in ("scan_share_pct.lm_train", "selective_scan_roofline.lm_train",
                 "dp_release_roofline.lm_train", "mfu.lm_train"):
        assert bench.reader(name)(ctx(zero, bare)) is None
    small = dict(COUNTS, dp_release_shape=(3, 64, 64))  # L2-resident: no HBM roofline
    assert bench.reader("dp_release_roofline.lm_train")(ctx(small)) is None


def test_work_at_the_published_widths():
    """4.4e14 model operations a step (24,576 tokens); the scan's least
    bytes at [3, 8192, 5120, 16] with a bfloat16 u."""
    flops = work_lm.lm_train_flops(JAMBA, 3, 8192)
    assert 4.2e14 < flops < 4.8e14
    n = math.prod(SHAPE[:3])
    ck = 4 * 3 * 256 * 5120 * 16
    bc = 4 * 2 * 3 * 8192 * 16 + 4 * (5120 * 16 + 5120)
    assert work_lm.scan_forward_bytes(*SHAPE, 2, False) == 2 * n + 4 * n + 4 * n + bc
    assert work_lm.scan_forward_bytes(*SHAPE, 2, True) == 2 * n + 4 * n + 4 * n + bc + ck
    assert work_lm.scan_backward_bytes(*SHAPE, 2) == (2 * n + 8 * n + bc + ck) + (2 * n + 4 * n
                                                                                 + bc)


def test_a_program_without_the_inner_norms_is_not_correct(monkeypatch, no_tf32):
    """A planted fault: the program's mixer skips Jamba's norms on dt, B
    and C."""
    from repro_torch.models import ssm

    monkeypatch.setattr(ssm, "rms_norm", lambda x, weight, eps: x)
    r = bench.run(small_cell("jamba2-3b-train"), SEED + 8, 0.05, False, "cpu")
    assert not r["correct"], r["compared"]


def test_the_reference_gives_one_loss_on_one_seed():
    """The reference (which ``tests/test_torch_jamba.py`` loads by its path
    too) on two draws of one seed's weights: one finite first-step loss."""
    cell = small_cell("jamba2-3b-train")
    drv = bench.runner_class("lm_train")(cell.config, cell.traffic, SEED, "cpu")
    drv.shards = [(t, t) for t in make_tokens(cell.traffic, cell.config, SEED, 3)]
    batches = drv.batches()

    losses = []
    for _ in range(2):
        w = make_weights(cell.config, SEED, "cpu", 3)
        losses.append(ref.train_steps(ref.Jamba(cell.config), w["client_banks"], w["server"],
                                      batches[:1], cell.config["guard"],
                                      work.sigma(cell.config["guard"]),
                                      cell.traffic["optimizer"], 1.0)[0])
    assert losses[0] == losses[1] and math.isfinite(losses[0][0])


def test_the_runner_fails_at_once_without_the_configuration_type(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.configs.jamba", None)
    cell = small_cell("jamba2-3b-train")
    with pytest.raises(ImportError):
        bench.runner_class("lm_train")(cell.config, cell.traffic, SEED, "cpu")


def test_the_reference_keeps_the_weights_types():
    """A reference step on the configuration's bfloat16 weights leaves each
    trunk leaf in its type (bfloat16 matrices, float32 norms and SSM
    constants) and moves it."""
    cell = small_cell("jamba2-3b-train")
    cfg = dict(cell.config, dtype="bfloat16")
    drv = bench.runner_class("lm_train")(cfg, cell.traffic, SEED, "cpu")
    drv.shards = [(t, t) for t in make_tokens(cell.traffic, cfg, SEED, 3)]
    w = make_weights(cfg, SEED, "cpu", 3)
    before = [t.clone() for t in ref.leaves(w["server"])]
    ref.train_steps(ref.Jamba(cfg), w["client_banks"], w["server"], drv.batches()[:1],
                    cfg["guard"], work.sigma(cfg["guard"]), cell.traffic["optimizer"], 1.0)
    after = ref.leaves(w["server"])
    assert {t.dtype for t in before} == {torch.bfloat16, torch.float32}
    assert [t.dtype for t in after] == [t.dtype for t in before]
    assert not all(torch.equal(a, b) for a, b in zip(after, before))
