"""What the benchmark's files promise: no module of the harness imports
JAX, Flax or the JAX package (top-level names compared whole), the
reference imports nothing of the program, ``BENCHMARK.json`` keeps its
shape, every name it gives has its file, and ``run.py`` refuses to run
without a card."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.bench import FORBIDDEN, load_json
from perfbench.tests.conftest import ROOT

HERE = ROOT / "perfbench"
BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def imported_tops(path: Path):
    """The top-level names of every module a file imports."""
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".")[0])
    return tops


PY = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", PY, ids=[str(p.relative_to(HERE)) for p in PY])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & set(FORBIDDEN)


def test_the_names_are_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.core\nfrom repro_torch import x\nimport reprox\n")
    assert imported_tops(p) == {"repro_torch", "reprox"}
    assert not imported_tops(p) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported_tops(path)
    assert imported_tops(path) <= {"__future__", "contextlib", "math", "typing", "numpy",
                                   "torch"}


def test_benchmark_json_keeps_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1] == "perfbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert load_json(ROOT / c["file"])["reduced"] == c["reduced"] == []
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "cells" / f"{w['name']}.json").is_file()
        kind = load_json(HERE / "traffic" / f"{w['traffic']}.json")["kind"]
        assert (HERE / "traffic" / f"{kind}.py").is_file()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for w in cells:
        reported = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    for c in cells:
        limits = load_json(HERE / "cells" / f"{c}.json")["limits"]
        assert limits and all(v > 0 for v in limits.values())


def test_run_refuses_without_a_card(tmp_path):
    r = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "mura-serve",
                        "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA card" in r.stderr
