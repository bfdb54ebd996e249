"""Shared pieces of the benchmark's CPU tests: the repository on the path,
and each cell of ``BENCHMARK.json`` cut to a size the CPU runs in a
second (narrow stages, small images, short traces), with the cell's own
limits."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench import bench  # noqa: E402

SMALL = {
    "mura-vgg19": dict(input_hw=[32, 32], stages=[[4, 2], [8, 2], [8, 1]], dense_units=[16, 16]),
    "covid-ct-cnn": dict(input_hw=[16, 16], stages=[[4, 1], [8, 1], [8, 1]], dense_units=[8]),
}
MIX = {
    "radiograph-studies": dict(horizon=8, shard_rows=30, check_requests=24),
    "thin-ct-studies": dict(horizon=8, request_batch=16, shard_rows=40, check_requests=24,
                            trunk_rows=64),
    "temporal-split": dict(server_batch=12, shard_rows=60),
}
CELLS = [w["name"] for w in bench.load_json(ROOT / "BENCHMARK.json")["workloads"]]


def small_cell(name: str) -> bench.Cell:
    """The cell ``name`` with its configuration and mix cut to CPU size."""
    cell = bench.load_cell(name)
    cell.config = {**cell.config, **SMALL[cell.workload["config"]]}
    cell.traffic = {**cell.traffic, **MIX[cell.workload["traffic"]]}
    return cell


@pytest.fixture
def no_tf32():
    """TF32 off around a test, as ``run.py`` sets it."""
    import torch

    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def load(path):
    with open(path) as f:
        return json.load(f)
