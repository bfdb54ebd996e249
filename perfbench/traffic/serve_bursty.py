"""The bursty serving runner: ``serve``'s runner on on/off bursts.

The fleet's rate is ``base_rate`` a cycle and jumps to ``burst_rate`` for
the first ``burst_len`` cycles of every ``period`` (every hospital bursts
together, the shared queue's worst case), split by the hospitals' shares:
one draw of the mix's ``horizon`` cycles from ``arrivals_seed``, a frozen
copy of the counts of ``repro_torch.serving.traces.bursty_trace``. The
k-th call takes the draw's periods in an order drawn from ``(seed, k)``,
each period whole, so every burst keeps its place at the head of its
period. The other parameters, the unit, the metrics and the check are
``serve``'s.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location("perfbench_traffic_serve",
                                               Path(__file__).with_name("serve.py"))
serve = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(serve)

BURSTY_TAG = 202  # the fold tag of bursty_trace's stream


def bursty_counts(n_clients: int, base_rate: float, burst_rate: float, period: int,
                  burst_len: int, horizon: int, seed: int, shares) -> np.ndarray:
    """``counts[t, c] ~ Poisson(rate_t * share[c])``, ``rate_t`` the burst's
    in the first ``burst_len`` cycles of each ``period``, else the base's,
    as ``bursty_trace``."""
    w = np.asarray(shares, np.float64)
    w = w / w.sum()
    lam = np.stack([(burst_rate if t % period < burst_len else base_rate) * w
                    for t in range(horizon)])
    return np.random.default_rng((int(seed), BURSTY_TAG)).poisson(lam)


class Runner(serve.Runner):
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        if mix["horizon"] % mix["period"]:
            raise ValueError("the horizon is whole periods")
        super().__init__(cfg, {**mix, "rate": 0.0}, seed, device)
        self.mix = mix
        self.arrivals = bursty_counts(cfg["hospitals"], mix["base_rate"], mix["burst_rate"],
                                      mix["period"], mix["burst_len"], mix["horizon"],
                                      mix["arrivals_seed"], cfg["shares"])

    def _trace(self, trace_seed: int, horizon: int):
        """A trace of ``horizon`` cycles: the draw's periods in the order
        ``trace_seed`` draws, each whole."""
        from repro_torch.serving.traces import ServeRequest, Trace

        p = self.mix["period"]
        periods = np.random.default_rng(trace_seed).permutation(len(self.arrivals) // p)
        order = np.concatenate([np.arange(k * p, (k + 1) * p) for k in periods])[:horizon]
        reqs = serve.requests_from_counts(self.arrivals[order])
        return reqs, Trace(kind="bursty", seed=trace_seed, n_clients=self.cfg["hospitals"],
                           horizon=horizon,
                           requests=tuple(ServeRequest(r, c, t) for r, c, t in reqs))
