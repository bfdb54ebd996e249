"""The port's copied data and trace generators give byte-identical output to
``repro``'s: same seeds, same arrays, same requests."""
import numpy as np
import pytest

from repro.data import make_cholesterol, make_covid_ct, split_clients
from repro.serving import bursty_trace, poisson_trace
from repro_torch.data import make_cholesterol as t_make_cholesterol
from repro_torch.data import make_covid_ct as t_make_covid_ct
from repro_torch.data import split_clients as t_split_clients
from repro_torch.serving import bursty_trace as t_bursty_trace
from repro_torch.serving import poisson_trace as t_poisson_trace


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,hw,seed", [(6, 64, 0), (5, 16, 3)])
def test_covid_ct_and_split_byte_identical(n, hw, seed):
    x, y = make_covid_ct(n, hw=hw, seed=seed)
    tx, ty = t_make_covid_ct(n, hw=hw, seed=seed)
    _same_bytes(x, tx)
    _same_bytes(y, ty)
    for (sx, sy), (ux, uy) in zip(split_clients(x, y, seed=seed),
                                  t_split_clients(tx, ty, seed=seed), strict=True):
        _same_bytes(sx, ux)
        _same_bytes(sy, uy)


def test_cholesterol_byte_identical():
    for a, b in zip(make_cholesterol(50, seed=4), t_make_cholesterol(50, seed=4)):
        _same_bytes(a, b)


def _trace_fields(t):
    return (t.kind, t.seed, t.n_clients, t.horizon,
            tuple((r.req_id, r.client_id, r.arrival) for r in t.requests))


@pytest.mark.parametrize("make,t_make,kw", [
    (poisson_trace, t_poisson_trace, dict(rate=2.0, horizon=32, seed=0,
                                          shares=(0.7, 0.2, 0.1))),
    (bursty_trace, t_bursty_trace, dict(horizon=24, seed=5)),
])
def test_traces_identical(make, t_make, kw):
    assert _trace_fields(make(3, **kw)) == _trace_fields(t_make(3, **kw))
