"""``repro_torch.roofline`` and ``repro_torch.launch.dryrun``.

``model_flops_estimate`` equals the reference's for every config and
shape. The counts come from one traced step on the fake process-group
backend (a subprocess: this process may hold another default group): on a
reduced llama at a (4, 2) grid, the rank's FLOPs times 8 equal the
unsharded step's ``FlopCounterMode`` count exactly (every matmul of that
config shards over the grid: its attention heads, FFN and vocab divide the
model axis, and each data rank takes a quarter of the rows; no replicated
leaf does matmul work, so the replicated term is zero), and the count
split by dtype sums to ``FlopCounterMode``'s. The step is affine in the
number of groups with the group probe as its slope (a Python loop counts
every group; the first group's backward skips its input's gradient, as
the features arrive detached, which the constant absorbs). The CLI runs
at the reference's mini setup (``tests/test_system.py``: llama reduced,
seq 64, batch 8, a (4, 2) grid) and prints a roofline.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.roofline.analysis import model_flops_estimate as j_model_flops
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.roofline import analysis
from repro_torch.roofline import hlo_breakdown

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "CUDA_VISIBLE_DEVICES": "",
       "OMP_NUM_THREADS": "1"}

COUNT_SCRIPT = r"""
import dataclasses, json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import distributed as D
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import ModelOptions
from repro_torch.roofline.analysis import count_step

out = {}
dryrun.fake_world(8)
mesh = make_production_mesh(shape=(4, 2), device_type="cpu")
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
cfg = get_config("llama3.2-1b").reduced()
opts = ModelOptions(q_block=32, kv_block=32)
low = steps.build(cfg, shape, mesh, opts)
c = count_step(low, mesh)
# the rank's step once more under FlopCounterMode, whose formulas the count uses
with low.mode, FlopCounterMode(display=False) as fc:
    low.fn(*steps.local_args(low, mesh))
out["rank"] = {"flops": c.flops, "fc": fc.get_total_flops(), "by_dtype": c.flops_by_dtype}
# the unsharded step on the whole inputs, in the lowering's fake mode
ucfg = D.untie(cfg)
step = D.make_guarded_llm_step(ucfg, steps.production_opts(ucfg, mesh, kind="train", base=opts),
                               steps.adamw(3e-4, weight_decay=0.1), 4)
with low.mode, FlopCounterMode(display=False) as fc:
    step(*low.args)
out["unsharded"] = fc.get_total_flops()
# the step against its groups: n_layers 3, 4, 5 give 2, 3, 4 groups
out["groups"] = []
for n in (3, 4, 5):
    c2 = dataclasses.replace(cfg, n_layers=n)
    whole = count_step(steps.build(c2, shape, mesh, opts), mesh).flops
    probe = count_step(steps.build_group_probe(c2, shape, mesh, opts), mesh).flops
    out["groups"].append([n - 1, whole, probe])
print("RESULT", json.dumps(out))
"""


def _run(args, timeout=240):
    r = subprocess.run(args, capture_output=True, text=True, timeout=timeout, env=ENV, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_model_flops_estimate_equals_the_reference(arch):
    for name in SHAPES:
        assert analysis.model_flops_estimate(get_config(arch), SHAPES[name]) == \
            j_model_flops(j_get_config(arch), J_SHAPES[name]), name


@pytest.fixture(scope="module")
def counts():
    out = _run([sys.executable, "-c", COUNT_SCRIPT])
    line = next(x for x in out.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def test_rank_flops_times_the_grid_equal_the_unsharded_count(counts):
    rank = counts["rank"]
    assert rank["flops"] == rank["fc"] == sum(rank["by_dtype"].values())
    assert set(rank["by_dtype"]) == {"float32"}
    assert rank["flops"] * 8 == counts["unsharded"]


def test_the_step_is_the_groups_outside_plus_n_groups_probes(counts):
    rows = counts["groups"]
    outside = {whole - n * probe for n, whole, probe in rows}
    assert len(outside) == 1, rows
    assert len({probe for _, _, probe in rows}) == 1 and rows[0][2] > 0


def test_terms_use_each_dtypes_peak_and_each_groups_link():
    hw = analysis.HW_H100
    c = analysis.StepCounts(flops=3e12, flops_by_dtype={"float32": 1e12, "bfloat16": 2e12},
                            bytes=6.7e9,
                            collectives=[("all_reduce", 1e9, tuple(range(8))),
                                         ("all_gather", 1e9, (0, 16))],
                            held_bytes=1.0, peak_live_bytes=2.0, ops=[])
    rep = analysis.analyze_lowering(get_config("llama3.2-1b"), SHAPES["train_4k"], "16x16",
                                    256, c)
    assert rep.t_compute == pytest.approx(1e12 / 67e12 + 2e12 / 989e12)
    assert rep.t_memory == pytest.approx(6.7e9 / 3.35e12)
    # an all-reduce inside a node of 8 on NVLink, twice its bytes; a gather across nodes
    assert rep.t_collective == pytest.approx(2e9 / hw["link_bw"] + 1e9 / hw["inter_node_bw"])
    assert rep.collectives_by_type == {"all_reduce": 2e9, "all_gather": 1e9}
    assert rep.bottleneck == "collective" and rep.peak_memory_bytes == 3.0


def test_dryrun_cli_at_the_mini_setup(tmp_path):
    dump, res = tmp_path / "ops.json", tmp_path / "out.json"
    out = _run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b",
                "--shape", "train_4k", "--reduced", "--seq", "64", "--batch", "8",
                "--mesh", "4x2", "--dump-ops", str(dump), "--out", str(res)])
    assert "roofline: compute=" in out and "dry-run: 1 ok, 0 skip, 0 FAILED" in out
    rec = json.loads(res.read_text())[0]
    assert rec["status"] == "ok" and rec["mesh"] == "4x2" and rec["n_devices"] == 8
    assert rec["flops_per_device"] > 0 and rec["peak_memory_bytes"] > rec["held_bytes"]
    rep = hlo_breakdown.breakdown(json.loads(dump.read_text()), top=5)
    assert rep["by_opcode"]["mm"] > 0 and len(rep["biggest_instructions"]) == 5
    assert set(rep["collectives"]) == {"all_reduce", "all_gather"}
    # the skip rows print as the reference's
    out = _run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "hubert-xlarge",
                "--shape", "decode_32k"])
    assert "skip: encoder-only" in out and "0 FAILED" in out


def test_hlo_breakdown_cli(tmp_path, capsys, monkeypatch):
    path = tmp_path / "rec.json"
    path.write_text(json.dumps({"ops": [["%0", "mm", 64], ["%1", "add", 8], ["%2", "mm", 32]],
                                "collectives": [["all_reduce", 16, 2]]}))
    monkeypatch.setattr(sys, "argv", ["hlo_breakdown", str(path), "--top", "2"])
    hlo_breakdown.main()
    text = capsys.readouterr().out
    assert "ops: 3" in text and "mm" in text and "all_reduce" in text
    assert hlo_breakdown.breakdown(json.loads(path.read_text()))["by_opcode"] == {"mm": 96,
                                                                               "add": 8}
