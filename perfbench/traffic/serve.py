"""The serving runner: hospitals send studies to ``SplitSession.serve``.

A unit of work is one ``serve`` call on a trace of the mix's ``horizon``
cycles; a study is ``request_batch`` input rows. Every trace holds the
same arrivals: one Poisson draw at the fleet's ``rate`` a cycle, split by
the hospitals' shares, from the mix's ``arrivals_seed``; the k-th call
takes its cycles in an order drawn from ``(seed, k)``, and its rows come
from that trace's seed. So every seed serves the same studies a call, in
its own order, on its own rows and noise. The mix's parameters:
``rate``, ``arrivals_seed``, ``horizon``,
``request_batch``, ``max_batch``, ``queue_size``, ``shard_rows`` (input
rows made for the hospitals together), ``warm_cycles`` (the warm-up
trace), ``trace_seconds`` (the traced window), ``check_requests`` (studies
the reference answers again) and ``trunk_rows`` (the reference trunk's
rows at a time).

Correct: once the window has closed and the program's state is freed, a
sample of the answered studies drawn from the seed is answered again by
the plain reference (the hospital's privacy layer with its model noise,
the guard's clip and noise, the trunk) from the same weights, rows and
noise, worked out again from the seed. The number compared,
``logit_gap``, is the widest gap of a served logit from the reference's,
over the root mean square of the reference's logits in the sample.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import program, work
from perfbench.clock import Phases
from perfbench.inputs.data import make_images, poisson_counts, requests_from_counts, split_clients
from perfbench.reference import cnn as ref
from perfbench.reference import draws
from perfbench.weights import make_weights, seed_word

TRACE_TAG, DATA_TAG, WARM_TAG, SAMPLE_TAG = 11, 13, 17, 19


def logit_gap(got, want) -> float:
    """max |got - want| over the root mean square of ``want``."""
    got = torch.cat([g.reshape(-1).double() for g in got])
    want = torch.cat([w.reshape(-1).double() for w in want])
    rms = float(torch.sqrt(torch.mean(want * want)))
    return float(torch.max(torch.abs(got - want))) / max(rms, 1e-30)


class Runner:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), device
        self.b = mix["request_batch"]
        self.calls = []  # (trace seed, [(rid, client, arrival)], ServeReport)
        self.phases = Phases(device)
        self.arrivals = poisson_counts(cfg["hospitals"], mix["rate"], mix["horizon"],
                                       mix["arrivals_seed"], cfg["shares"])

    # ------------------------------------------------------------ set-up
    def _trace(self, trace_seed: int, horizon: int):
        """A trace of ``horizon`` cycles: the mix's arrivals with their
        cycles in the order ``trace_seed`` draws."""
        from repro_torch.serving.traces import ServeRequest, Trace

        order = np.random.default_rng(trace_seed).permutation(len(self.arrivals))[:horizon]
        reqs = requests_from_counts(self.arrivals[order])
        return reqs, Trace(kind="poisson", seed=trace_seed, n_clients=self.cfg["hospitals"],
                           horizon=horizon,
                           requests=tuple(ServeRequest(r, c, t) for r, c, t in reqs))

    def _serve(self, trace):
        return self.sess.serve(trace, self.shards, max_batch=self.mix["max_batch"],
                               request_batch=self.b, queue_size=self.mix["queue_size"])

    def setup(self):
        with self.phases("session"):
            self.sess = program.session(self.cfg, self.seed, self.device)
        with self.phases("weights"):
            program.put_weights(self.sess, make_weights(self.cfg, self.seed, self.device,
                                                        self.cfg["hospitals"]))
        with self.phases("data"):
            x, y = make_images(self.cfg["images"], self.mix["shard_rows"],
                               seed_word(self.seed, DATA_TAG) % 2**32, self.cfg["input_hw"][0])
            self.shards = split_clients(x, y, self.cfg["shares"],
                                        seed=seed_word(self.seed, DATA_TAG))
        with self.phases("warm_up"):
            _, warm = self._trace(seed_word(self.seed, WARM_TAG), self.mix["warm_cycles"])
            self._serve(warm)

    # ------------------------------------------------------------ window
    def start_window(self):
        self.calls = []
        self.launches0 = program.Launches.now()

    def unit(self):
        trace_seed = seed_word(self.seed, TRACE_TAG, len(self.calls))
        reqs, trace = self._trace(trace_seed, self.mix["horizon"])
        self.calls.append((trace_seed, reqs, self._serve(trace)))

    def end_to_end(self, window_s: float) -> dict:
        reports = [r for _, _, r in self.calls]
        lat = [ms for r in reports for ms in r.latency_ms.values()]
        return {"serve_samples_per_s": sum(r.answered for r in reports) * self.b / window_s,
                "serve_p95_ms": float(np.percentile(lat, 95)) if lat else None}

    def attempted_failed(self):
        reports = [r for _, _, r in self.calls]
        return (sum(r.offered for r in reports),
                sum(r.dropped + r.shed for r in reports))

    def counts(self) -> dict:
        reports = [r for _, _, r in self.calls]
        launched = program.Launches.now().since(self.launches0)
        h, w = self.cfg["input_hw"]
        first = work.conv_layers(self.cfg)[0]
        answered_rows = sum(r.answered for r in reports) * self.b
        return {"batches": sum(r.batches for r in reports),
                "batched_items": sum(r.batched_items for r in reports),
                "max_batch": self.mix["max_batch"],
                "privacy_conv_calls": launched.privacy_conv,
                "privacy_conv_shape": (self.b, h, w, first["cin"], first["cout"]),
                "dp_release_calls": launched.dp_release_calls,
                "dp_release_shape": work.feature_shape(self.cfg, self.b),
                "model_flops": answered_rows * work.serve_flops_per_row(self.cfg)}

    def release(self):
        del self.sess
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def sample(self):
        """The studies the reference answers: ``check_requests`` of the
        answered ones, drawn from the seed, as (call, rid, client, release
        number in its call)."""
        answered = [(k, rid) for k, (_, _, rep) in enumerate(self.calls)
                    for rid in sorted(rep.responses)]
        rng = np.random.default_rng(seed_word(self.seed, SAMPLE_TAG))
        pick = rng.choice(len(answered), size=min(self.mix["check_requests"], len(answered)),
                          replace=False)
        out = []
        for i in sorted(pick):
            k, rid = answered[i]
            reqs = self.calls[k][1]
            client = [c for r, c, _ in reqs if r == rid][0]
            release = [r for r, c, _ in reqs if c == client].index(rid) + 1
            out.append((k, rid, client, release))
        return out

    def reference_inputs(self, picked):
        """Each picked study's rows and noise, worked out again from the
        seed."""
        shape = work.feature_shape(self.cfg, self.b)
        sigma = work.sigma(self.cfg["guard"])
        noise = {}
        for c in sorted({c for _, _, c, _ in picked}):
            noise[c] = draws.serve_noise(self.seed, 0, c, shape,
                                         [r for _, _, cc, r in picked if cc == c],
                                         self.device, guard=sigma > 0)
        reqs = []
        for k, rid, c, r in picked:
            x_c = self.shards[c][0]
            idx = draws.serve_rows(self.calls[k][0], c, len(x_c), self.b, r)[-1]
            m, g = noise[c][r]
            reqs.append({"client": c, "model_noise": m, "guard_noise": g,
                         "x": torch.as_tensor(x_c[idx], device=self.device)})
        return reqs

    def reference_answers(self, reqs, mode: str = "float32"):
        weights = make_weights(self.cfg, self.seed, self.device, self.cfg["hospitals"])
        model = ref.Model(self.cfg, mode)
        with ref.precision(mode):
            return ref.serve_answers(model, weights["client_banks"], weights["server"], reqs,
                                     self.cfg["guard"], work.sigma(self.cfg["guard"]),
                                     self.mix["trunk_rows"])

    def served(self, picked):
        return [torch.as_tensor(self.calls[k][2].responses[rid]) for k, rid, _, _ in picked]

    def check(self) -> dict:
        picked = self.sample()
        if not picked:
            return {"logit_gap": None}
        want = [a.cpu() for a in self.reference_answers(self.reference_inputs(picked))]
        return {"logit_gap": logit_gap(self.served(picked), want)}

    def control(self) -> dict:
        """The control: the reference in TF32 in the program's place."""
        picked = self.sample()
        reqs = self.reference_inputs(picked)
        want = [a.cpu() for a in self.reference_answers(reqs)]
        got = [a.cpu() for a in self.reference_answers(reqs, "tf32")]
        return {"logit_gap": logit_gap(got, want)}
