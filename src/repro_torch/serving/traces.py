"""Seeded synthetic arrival traces for the split-inference server.

A :class:`Trace` is a deterministic function of its seed: a tuple of
:class:`ServeRequest`\\ s, each naming WHICH hospital wants an answer and
WHEN (a logical arrival cycle — the serve drive is a logical-clock
simulation, so the whole request lifecycle replays bit-for-bit from the
same trace; see ``repro_torch.serving.server``). Two shapes model the ROADMAP's
"heavy traffic" story:

  * :func:`poisson_trace` — independent per-cycle Poisson arrivals, rates
    proportional to the hospitals' data shares (the paper's imbalance:
    bigger hospitals query more). The steady-state load every serving
    system is sized for.
  * :func:`bursty_trace` — an on/off process: quiet baseline traffic with
    synchronized burst windows where every hospital's rate multiplies.
    The admission-control stressor: bursts are what fill the queue, trip
    per-client caps and age requests past the shedding deadline.

Request ids are assigned in (cycle, client, draw) order, so the id
sequence — like everything else here — is a pure function of the trace
parameters. The generators draw from ``np.random.default_rng`` seeded
with ``(seed, <shape tag>)``: the same seed gives a Poisson and a bursty
trace DIFFERENT streams, while either shape alone replays identically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# fold tags separating the two shapes' RNG streams at equal seeds
_POISSON_TAG = 101
_BURSTY_TAG = 202


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One inference request: hospital ``client_id`` asks at logical cycle
    ``arrival`` (its private input rows are sampled by the serve drive from
    the client's OWN shard — raw data never enters the trace)."""

    req_id: int
    client_id: int
    arrival: int


@dataclasses.dataclass(frozen=True)
class Trace:
    """An immutable arrival schedule. ``requests`` are sorted by
    ``(arrival, req_id)`` and ``horizon`` is the number of arrival cycles
    (requests may only arrive at cycles ``0 .. horizon-1``; the serve drive
    keeps cycling past the horizon until the queue drains)."""

    kind: str
    seed: int
    n_clients: int
    horizon: int
    requests: Tuple[ServeRequest, ...]

    def __post_init__(self):
        arrivals = [r.arrival for r in self.requests]
        assert arrivals == sorted(arrivals), "requests must be arrival-sorted"
        assert all(0 <= a < self.horizon for a in arrivals), (
            "request arrivals must land inside the horizon")
        assert all(0 <= r.client_id < self.n_clients for r in self.requests)
        ids = [r.req_id for r in self.requests]
        assert len(set(ids)) == len(ids), "request ids must be unique"

    @property
    def offered(self) -> int:
        return len(self.requests)

    def by_cycle(self) -> Dict[int, List[ServeRequest]]:
        """Arrival cycle -> the requests landing on it (admission order)."""
        out: Dict[int, List[ServeRequest]] = {}
        for r in self.requests:
            out.setdefault(r.arrival, []).append(r)
        return out


def _client_rates(n_clients: int, rate: float,
                  shares: Optional[Sequence[float]]) -> np.ndarray:
    """Per-client mean arrivals per cycle. ``rate`` is the FLEET mean per
    cycle; shares (default uniform) split it share-proportionally, so the
    biggest hospital queries most — the paper's imbalance, on the serving
    side."""
    if shares is None:
        w = np.full(n_clients, 1.0 / n_clients)
    else:
        w = np.asarray(shares, np.float64)
        assert len(w) == n_clients and np.all(w > 0)
        w = w / w.sum()
    return rate * w


def _assemble(kind: str, seed: int, n_clients: int, horizon: int,
              counts: np.ndarray) -> Trace:
    """``counts[t, c]`` arrivals -> the sorted, id-stamped request tuple."""
    reqs: List[ServeRequest] = []
    rid = 0
    for t in range(horizon):
        for c in range(n_clients):
            for _ in range(int(counts[t, c])):
                reqs.append(ServeRequest(req_id=rid, client_id=c, arrival=t))
                rid += 1
    return Trace(kind=kind, seed=seed, n_clients=n_clients, horizon=horizon,
                 requests=tuple(reqs))


def poisson_trace(n_clients: int, *, rate: float = 2.0, horizon: int = 32,
                  seed: int = 0,
                  shares: Optional[Sequence[float]] = None) -> Trace:
    """Independent Poisson arrivals: ``counts[t, c] ~ Poisson(rate *
    share[c])`` per cycle. ``rate`` is the mean TOTAL arrivals per cycle
    across the fleet. Deterministic given ``(seed, n_clients, rate,
    horizon, shares)``."""
    assert horizon > 0 and rate >= 0
    rng = np.random.default_rng((int(seed), _POISSON_TAG))
    lam = _client_rates(n_clients, rate, shares)
    counts = rng.poisson(lam[None, :], size=(horizon, n_clients))
    return _assemble("poisson", seed, n_clients, horizon, counts)


def bursty_trace(n_clients: int, *, base_rate: float = 0.5,
                 burst_rate: float = 8.0, period: int = 16,
                 burst_len: int = 4, horizon: int = 32, seed: int = 0,
                 shares: Optional[Sequence[float]] = None) -> Trace:
    """On/off bursts over a quiet baseline: every ``period`` cycles the
    fleet rate jumps from ``base_rate`` to ``burst_rate`` for ``burst_len``
    cycles (all hospitals burst together — the worst case for the shared
    queue). Rates are fleet means split by share, like
    :func:`poisson_trace`."""
    assert horizon > 0 and period > 0 and 0 < burst_len <= period
    rng = np.random.default_rng((int(seed), _BURSTY_TAG))
    base = _client_rates(n_clients, base_rate, shares)
    burst = _client_rates(n_clients, burst_rate, shares)
    lam = np.stack([
        burst if (t % period) < burst_len else base for t in range(horizon)
    ])
    counts = rng.poisson(lam)
    return _assemble("bursty", seed, n_clients, horizon, counts)


TRACE_SHAPES = {"poisson": poisson_trace, "bursty": bursty_trace}


def make_trace(kind: str, n_clients: int, **kw) -> Trace:
    """Registry entry point: ``make_trace("poisson"|"bursty", n, ...)``."""
    try:
        factory = TRACE_SHAPES[kind]
    except KeyError:
        raise ValueError(
            f"unknown trace shape {kind!r}; available: {sorted(TRACE_SHAPES)}"
        ) from None
    return factory(n_clients, **kw)
