"""Each cell's runner through a whole run on the CPU at a small size: the
program's answers within the cell's limits of the reference's, the
end-to-end metrics in an untraced run and the readable per-layer metrics
in a traced one; the control (the reference in emulated TF32 in the
program's place) and the planted faults of each cell come out not
correct."""
import pytest
import torch

from perfbench import bench
from perfbench.tests.conftest import CELLS, small_cell

SEED = 2**31 + 4099


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct_and_reports_its_metrics(name, no_tf32):
    cell = small_cell(name)
    r = bench.run(cell, SEED, 0.3, False, "cpu")
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "compared"
    assert set(r["compared"]) == set(cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(name, no_tf32):
    cell = small_cell(name)
    r = bench.run(cell, SEED + 2, 0.3, True, "cpu")
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    # the CPU has no device timeline: idle is the whole window
    idle = [k for k in r["metrics"] if k.startswith("device_idle_pct")]
    assert idle and all(r["metrics"][k]["value"] == pytest.approx(100.0) for k in idle)
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0


def _two_units(cell, seed):
    drv = bench.runner_class(cell.traffic["kind"])(cell.config, cell.traffic, seed, "cpu")
    drv.setup()
    drv.start_window()
    drv.unit()
    drv.unit()
    counts = drv.counts()
    drv.release()
    return counts, drv.check()


@pytest.mark.parametrize("name", CELLS)
def test_one_seed_gives_the_same_work_and_numbers(name, no_tf32):
    cell = small_cell(name)
    assert _two_units(cell, SEED + 4) == _two_units(cell, SEED + 4)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, no_tf32):
    cell = small_cell(name)
    got = {}
    bench.run(cell, SEED + 6, 0.05, False, "cpu", after=lambda d: got.update(d.control()))
    assert any(v > cell.limits[k] for k, v in got.items()), got


def _serve_answer_altered(monkeypatch):
    from repro_torch.serving import server

    make = server.make_server_batch_forward

    def altered(adapter, mesh=None):
        fwd = make(adapter, mesh)

        def forward(params, feats):
            out = fwd(params, feats)
            out[0] = out[0] + 1e-2 * out.abs().max()
            return out

        return forward

    monkeypatch.setattr(server, "make_server_batch_forward", altered)


def _train_state_unchanged(monkeypatch):
    from repro_torch.core import session

    make = session.make_epoch_runner

    def unchanged(*a, **kw):
        init, run_epoch = make(*a, **kw)

        def run(state, data_x, data_y, plan):
            _, ms = run_epoch(state, data_x, data_y, plan)
            return state, ms

        return init, run

    monkeypatch.setattr(session, "make_epoch_runner", unchanged)


def _train_half_batch(monkeypatch):
    from repro_torch.core import trainer

    def half(adapter):
        return lambda out, y: torch.stack([adapter.loss(out[c, :out.shape[1] // 2],
                                                        y[c, :y.shape[1] // 2])
                                           for c in range(out.shape[0])])

    monkeypatch.setattr(trainer, "per_client_loss", half)


FAULTS = [("mura-serve", _serve_answer_altered), ("covid-serve-thin", _serve_answer_altered),
          ("mura-train", _train_state_unchanged), ("mura-train", _train_half_batch)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch, no_tf32):
    fault(monkeypatch)
    r = bench.run(small_cell(name), SEED + 8, 0.05, False, "cpu")
    assert not r["correct"], r["compared"]
