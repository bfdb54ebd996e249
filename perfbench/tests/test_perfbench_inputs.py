"""The frozen inputs: the same arrays from one seed in two processes, and
the same as the port's own generators where those are sound."""
import hashlib
import subprocess
import sys

import numpy as np
import pytest

from perfbench.inputs import data
from perfbench.tests.conftest import ROOT

DIGEST = """
import hashlib, sys
sys.path.insert(0, {root!r})
from perfbench.inputs import data
h = hashlib.sha256()
for kind, hw in (("mura", 224), ("covid_ct", 64)):
    x, y = data.make_images(kind, 6, 2**31 + 77, hw)
    h.update(x.tobytes()); h.update(y.tobytes())
    for sx, sy in data.split_clients(x, y, (0.7, 0.2, 0.1), seed=2**40 + 5):
        h.update(sx.tobytes()); h.update(sy.tobytes())
h.update(data.poisson_counts(3, 6.0, 64, 2**33 + 9, (0.7, 0.2, 0.1)).tobytes())
print(h.hexdigest())
"""


def test_two_processes_make_the_same_inputs():
    code = DIGEST.format(root=str(ROOT))
    # a salted string hash differs between these processes
    runs = [subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           env={"PYTHONHASHSEED": str(s)}, check=True, timeout=120).stdout
            for s in (1, 2)]
    assert runs[0] == runs[1] and len(runs[0].strip()) == 64


def test_covid_ct_split_and_counts_equal_the_ports():
    from repro_torch.data.split import split_clients
    from repro_torch.data.synthetic import make_covid_ct
    from repro_torch.serving.traces import poisson_trace

    x, y = data.make_covid_ct(5, seed=123)
    px, py = make_covid_ct(5, seed=123)
    assert np.array_equal(x, px) and np.array_equal(y, py)
    for (a, b), (c, d) in zip(data.split_clients(x, y, seed=9), split_clients(x, y, seed=9)):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    counts = data.poisson_counts(3, 6.0, 16, 2**31 + 3, (0.7, 0.2, 0.1))
    trace = poisson_trace(3, rate=6.0, horizon=16, seed=2**31 + 3, shares=(0.7, 0.2, 0.1))
    assert data.requests_from_counts(counts) == [(r.req_id, r.client_id, r.arrival)
                                                 for r in trace.requests]


def test_mura_differs_from_the_port_only_by_the_fixed_salt():
    from repro_torch.data.synthetic import make_mura

    salt = hash("wrist") % (1 << 16)
    x, y = data.make_mura(3, hw=32, seed=1000 + salt - data.PART_SALT["wrist"])
    px, py = make_mura(3, hw=32, seed=1000)
    assert np.array_equal(x, px) and np.array_equal(y, py)


def test_unknown_image_kind_is_refused():
    with pytest.raises(ValueError):
        data.make_images("mri", 1, 0, 8)
