"""Private split-inference serving: guarded releases -> queue -> batched trunk.

Port of ``repro.serving.server``. Each request runs its hospital's privacy
layer and releases through the guard at the cut (``make_client_release_fwd``),
and the guarded features enter a ``FeatureQueue``. A continuously-batching
consumer pops up to ``max_batch`` ready requests per cycle, pads them to
``max_batch`` slots and runs the trunk once over all ``[K*b, ...]`` rows
(the counterpart of the JAX server's vmap over the slots), then routes each
slot's output back by request id.

The drive is a logical-clock simulation: one cycle admits the trace's
arrivals for that tick, sheds queue items older than ``max_wait`` cycles,
dispatches one batch, then advances. No threads, so the whole request
lifecycle is a pure function of ``(state, trace, knobs, noise)`` and
replays bit for bit. Wall-clock latencies are measured beside it and carry
no semantics. Spans (``common.tracing.span``) mark the call's opening, each
cycle, a study's admission (rows, noise, release, push), the batch's
assembly, the trunk's launch and the readback, for a profiler that records;
with none recording they cost a flag read each.

Noise: the JAX server folds each release's key out of ``(root, step,
client, release)``. Here each client owns one ``torch.Generator`` on the
device, seeded from ``(seed, step, client)``, and every release draws its
model noise and then its guard noise from it, so a replay with the same
seed is bit-identical. ``noise_fn`` replaces those draws (a test feeds the
JAX package's draws through it).

Trust argument at the cut: the server consumes only guard-released feature
maps plus an opaque request id; raw inputs, client banks and the
per-hospital sampling RNGs never cross.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.bridge import to_torch, tree_map
from repro_torch.common.device import resolve_device
from repro_torch.common.tracing import span
from repro_torch.core.adapters import SplitAdapter
from repro_torch.core.protocol import _pop_with_backoff, make_client_release_fwd
from repro_torch.core.queue import FeatureQueue
from repro_torch.core.trainer import _server_forward, _trunk_sharder, check_mesh
from repro_torch.privacy.guard import PrivacyGuard
from repro_torch.serving.traces import Trace

# fold separating the serving fleet's sampling streams from training's
_SAMPLE_RNG_TAG = 977

NoiseFn = Callable[[int, int, Tuple[int, ...], Tuple[int, ...]], Tuple[Any, Any]]


def make_server_batch_forward(adapter: SplitAdapter, mesh=None):
    """The serving consumer's one trunk dispatch per cycle:
    ``forward(server_params, feats [K, b, ...]) -> outputs [K, b, ...]``.
    The ``K`` padded request slots run as one ``[K*b, ...]`` batch; padded
    slots run on zeros and their outputs are never routed. ``mesh`` runs
    the trunk tensor-parallel over its ``"model"`` axis like every training
    step (the identity on an axis of size 1 or none: bit for bit there)."""
    server_fwd = _server_forward(adapter, _trunk_sharder(mesh, adapter))

    @torch.no_grad()
    def forward(server_params, feats):
        k, b = feats.shape[:2]
        out = server_fwd(server_params, feats.reshape((k * b,) + feats.shape[2:]))
        return out.reshape((k, b) + out.shape[1:])

    return forward


@dataclasses.dataclass
class ServeReport:
    """One trace's serving outcome. Everything except the ``*_ms`` /
    ``wall_s`` fields is deterministic given (state, trace, knobs, noise);
    :meth:`fingerprint` is the replay digest.

    The wall-clock stamps of every answered request, in milliseconds by
    request id: ``latency_ms`` from its push into the queue (after its
    release was dispatched) to its answer; ``arrival_latency_ms`` from the
    start of its arrival cycle to its answer; ``queue_ms`` from the push to
    its pop into a batch. So ``arrival_latency_ms >= latency_ms >=
    queue_ms >= 0``."""

    trace_kind: str
    trace_seed: int
    offered: int = 0
    accepted: int = 0          # admitted into the queue
    answered: int = 0
    dropped: int = 0           # rejected at admission (full + cap)
    dropped_full: int = 0
    dropped_cap: int = 0
    shed: int = 0              # admitted, then aged past max_wait
    cycles: int = 0
    batches: int = 0
    batched_items: int = 0
    max_inflight_per_client: List[int] = dataclasses.field(default_factory=list)
    releases_per_client: List[int] = dataclasses.field(default_factory=list)
    per_client: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    latency_cycles: Dict[int, int] = dataclasses.field(default_factory=dict)
    latency_ms: Dict[int, float] = dataclasses.field(default_factory=dict)
    arrival_latency_ms: Dict[int, float] = dataclasses.field(default_factory=dict)
    queue_ms: Dict[int, float] = dataclasses.field(default_factory=dict)
    responses: Optional[Dict[int, np.ndarray]] = None
    features: Optional[Dict[int, np.ndarray]] = None
    queue_stats: Dict[str, int] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0

    def latency_percentiles(self, qs: Sequence[int] = (50, 99)) -> Dict[str, float]:
        """``{"p50_cycles", "p99_cycles", "p50_ms", "p99_ms", ...}`` over
        the answered requests (drops and sheds have no latency)."""
        out: Dict[str, float] = {}
        cyc = np.asarray(sorted(self.latency_cycles.values()), np.float64)
        ms = np.asarray(sorted(self.latency_ms.values()), np.float64)
        for q in qs:
            out[f"p{q}_cycles"] = float(np.percentile(cyc, q)) if cyc.size else float("nan")
            out[f"p{q}_ms"] = float(np.percentile(ms, q)) if ms.size else float("nan")
        return out

    def deterministic_stats(self) -> Dict[str, Any]:
        """The replayable summary: every count plus the per-request cycle
        latencies in request-id order; equal to ``repro``'s for the same
        trace and state."""
        return {
            "trace": (self.trace_kind, self.trace_seed),
            "offered": self.offered, "accepted": self.accepted,
            "answered": self.answered, "dropped": self.dropped,
            "dropped_full": self.dropped_full, "dropped_cap": self.dropped_cap,
            "shed": self.shed, "cycles": self.cycles,
            "batches": self.batches, "batched_items": self.batched_items,
            "max_inflight_per_client": list(self.max_inflight_per_client),
            "releases_per_client": list(self.releases_per_client),
            "per_client": [dict(d) for d in self.per_client],
            "latency_cycles": sorted(self.latency_cycles.items()),
            "queue_stats": dict(self.queue_stats),
        }

    def fingerprint(self) -> str:
        """SHA-256 over the deterministic stats and the response bytes in
        request-id order: bit-for-bit replay evidence."""
        h = hashlib.sha256(repr(self.deterministic_stats()).encode())
        if self.responses is not None:
            for rid in sorted(self.responses):
                h.update(np.ascontiguousarray(self.responses[rid]).tobytes())
        return h.hexdigest()


def _client_banks_list(banks) -> List[Any]:
    """Canonical stacked banks (every leaf ``[n_clients, ...]``) or a list
    of banks -> list of banks."""
    if isinstance(banks, (list, tuple)):
        return list(banks)
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, banks)
    return [tree_map(lambda a, i=i: a[i], banks) for i in range(leaves[0].shape[0])]


class SplitInferenceServer:
    """A frozen canonical state serving inference traffic, as
    ``repro.serving.SplitInferenceServer``.

    ``state`` is the canonical dict: ``client_banks`` (stacked or listed),
    the ``server`` trunk and the ``step``, with numpy or tensor leaves; it is
    moved to ``device`` (``None``: the card). Knobs:
      * ``max_batch``: requests per consumer cycle, padded into one trunk
        dispatch;
      * ``queue_size`` / ``per_client_cap``: the ``FeatureQueue``'s own
        overflow and fairness rejections (drops);
      * ``max_wait``: cycles a request may queue before it is shed instead
        of served (``None`` disables shedding);
      * ``request_batch``: input rows per request;
      * ``pop_retries`` / ``pop_backoff``: the consumer's backoff, counted
        in ``queue_stats``;
      * ``seed``: seeds the per-client noise generators; ``noise_fn``
        (``(client_id, release, model_shape, guard_shape) -> (model_noise,
        guard_noise)``, standard-normal arrays) replaces their draws;
      * ``mesh``: a ``launch.mesh`` mesh on ``device``'s type; every rank
        serves the trace (the drive is deterministic) and the trunk runs
        tensor-parallel over its ``"model"`` axis.
    """

    def __init__(self, adapter: SplitAdapter, state, *,
                 guard: Optional[PrivacyGuard] = None, max_batch: int = 8,
                 queue_size: int = 64, per_client_cap: Optional[int] = None,
                 max_wait: Optional[int] = None, request_batch: int = 1,
                 pop_retries: int = 0, pop_backoff: float = 2.0,
                 record_features: bool = False, keep_responses: bool = True,
                 seed: int = 0, noise_fn: Optional[NoiseFn] = None, device=None, mesh=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if request_batch < 1:
            raise ValueError(f"request_batch must be >= 1, got {request_batch}")
        if max_wait is not None and max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        if pop_backoff < 1.0:
            raise ValueError(f"pop_backoff must be >= 1.0, got {pop_backoff}")
        self.device = resolve_device(device)
        if mesh is not None:
            check_mesh(mesh, self.device, client_axis=None)
        self.mesh = mesh
        self.adapter = adapter
        self.guard = guard if guard is not None else PrivacyGuard()
        state = to_torch(state, self.device)
        self.banks = _client_banks_list(state["client_banks"])
        self.server_params = state["server"]
        self.step = int(state["step"])
        self.n_clients = len(self.banks)
        self.max_batch, self.queue_size = int(max_batch), int(queue_size)
        self.per_client_cap = per_client_cap
        self.max_wait, self.request_batch = max_wait, int(request_batch)
        self.pop_retries, self.pop_backoff = int(pop_retries), float(pop_backoff)
        self.record_features = record_features
        self.keep_responses = keep_responses
        self.seed = int(seed)
        self.noise_fn = noise_fn
        self._client_fwd = make_client_release_fwd(adapter, self.guard)
        self._batch_fwd = make_server_batch_forward(adapter, mesh)

    # ------------------------------------------------------------ admission
    def _noise(self, gens, client_id: int, release: int, shape):
        """The release's (model noise, guard noise): from ``noise_fn`` when
        given, else model then guard noise from the client's generator (the
        guard's only when it adds noise)."""
        if self.noise_fn is not None:
            m, g = self.noise_fn(client_id, release, shape, shape)
            return (torch.tensor(np.asarray(m), dtype=torch.float32, device=self.device),
                    torch.tensor(np.asarray(g), dtype=torch.float32, device=self.device))
        gen = gens[client_id]
        model = torch.randn(shape, generator=gen, device=self.device)
        guard = (torch.randn(shape, generator=gen, device=self.device)
                 if self.guard.sigma > 0.0 else None)
        return model, guard

    def _generators(self) -> List[torch.Generator]:
        gens = []
        for c in range(self.n_clients):
            seq = np.random.SeedSequence((self.seed, self.step, c))
            g = torch.Generator(device=self.device)
            g.manual_seed(int(seq.generate_state(1, np.uint64)[0]))
            gens.append(g)
        return gens

    # ---------------------------------------------------------------- drive
    def serve(self, trace: Trace, shards) -> ServeReport:
        """Run the trace to completion (every admitted request answered or
        shed) and return the :class:`ServeReport`.

        ``shards`` are the per-hospital datasets (``[(x, y), ...]``); each
        request samples ``request_batch`` rows from its own client's shard
        with an RNG keyed on ``(trace.seed, client)``, the JAX server's
        stream. Raw rows stay on the client side of the cut.
        """
        if trace.n_clients != self.n_clients:
            raise ValueError(
                f"trace covers {trace.n_clients} clients but the state has "
                f"{self.n_clients} banks")
        if len(shards) != self.n_clients:
            raise ValueError(f"{len(shards)} shards for {self.n_clients} clients")
        with span("serve.open"):
            xs = [torch.as_tensor(np.asarray(x), device=self.device) for x, _ in shards]
            rngs = [np.random.default_rng((trace.seed, _SAMPLE_RNG_TAG, c))
                    for c in range(self.n_clients)]
            gens = self._generators() if self.noise_fn is None else None
            queue = FeatureQueue(max_size=self.queue_size,
                                 per_client_cap=self.per_client_cap)
        report = ServeReport(trace_kind=trace.kind, trace_seed=trace.seed)
        report.per_client = [
            {"offered": 0, "accepted": 0, "answered": 0, "dropped": 0, "shed": 0}
            for _ in range(self.n_clients)
        ]
        releases = [0] * self.n_clients
        inflight = [0] * self.n_clients
        max_inflight = [0] * self.n_clients
        admitted_cycle: Dict[int, int] = {}
        admitted_wall: Dict[int, float] = {}  # the push
        cycle_wall: List[float] = []  # each cycle's start
        responses: Dict[int, np.ndarray] = {}
        if self.record_features:
            report.features = {}
        arrivals = trace.by_cycle()
        t = 0
        t0 = time.perf_counter()
        while t < trace.horizon or len(queue) > 0:
            with span("serve.cycle"):
                cycle_wall.append(time.perf_counter())
                # ---- admissions: this cycle's arrivals release + push
                for req in arrivals.get(t, ()):
                    with span("serve.admit"):
                        c = req.client_id
                        report.offered += 1
                        report.per_client[c]["offered"] += 1
                        idx = rngs[c].integers(0, len(xs[c]), size=self.request_batch)
                        releases[c] += 1  # budget spent whether or not the push lands
                        x = xs[c][torch.as_tensor(idx, device=self.device)]
                        model_noise, guard_noise = self._noise(
                            gens, c, releases[c], self.adapter.feature_shape(tuple(x.shape)))
                        feats = self._client_fwd(self.banks[c], x, model_noise, guard_noise)
                        if self.record_features:
                            report.features[req.req_id] = feats.cpu().numpy()
                        if queue.push(c, feats, req.req_id):
                            report.accepted += 1
                            report.per_client[c]["accepted"] += 1
                            admitted_cycle[req.req_id] = t
                            admitted_wall[req.req_id] = time.perf_counter()
                            inflight[c] += 1
                            max_inflight[c] = max(max_inflight[c], inflight[c])
                        else:
                            report.dropped += 1
                            report.per_client[c]["dropped"] += 1
                            if len(queue) >= self.queue_size:
                                report.dropped_full += 1
                            else:  # room in the queue: the per-client cap rejected
                                report.dropped_cap += 1
                # ---- one consumer cycle: batch up to max_batch ready requests,
                # shedding anything that aged past the deadline on the way
                with span("serve.batch"):
                    batch: List[Tuple[int, torch.Tensor, int, float]] = []
                    while len(batch) < self.max_batch:
                        item = _pop_with_backoff(queue, 0.0, self.pop_retries,
                                                 self.pop_backoff)
                        if item is None:
                            break
                        popped = time.perf_counter()
                        cid, feats, rid = item
                        inflight[cid] -= 1
                        if (self.max_wait is not None
                                and t - admitted_cycle[rid] > self.max_wait):
                            report.shed += 1
                            report.per_client[cid]["shed"] += 1
                            admitted_cycle.pop(rid), admitted_wall.pop(rid)
                            continue
                        batch.append((cid, feats, rid, popped))
                    if batch:
                        k = len(batch)
                        feats = torch.stack([f for _, f, _, _ in batch])
                        if k < self.max_batch:  # pad to max_batch slots
                            feats = torch.cat([feats, feats.new_zeros(
                                (self.max_batch - k,) + tuple(feats.shape[1:]))])
                if batch:
                    with span("serve.trunk"):
                        outs = self._batch_fwd(self.server_params, feats)
                    with span("serve.readback"):
                        outs = outs.cpu().numpy()  # the host waits for the device here
                        now = time.perf_counter()
                        for i, (cid, _, rid, popped) in enumerate(batch):
                            if rid in responses:
                                raise RuntimeError(f"request {rid} answered twice")
                            responses[rid] = outs[i]
                            report.answered += 1
                            report.per_client[cid]["answered"] += 1
                            arrived = admitted_cycle.pop(rid)
                            report.latency_cycles[rid] = t - arrived
                            pushed = admitted_wall.pop(rid)
                            report.latency_ms[rid] = (now - pushed) * 1e3
                            report.arrival_latency_ms[rid] = (now - cycle_wall[arrived]) * 1e3
                            report.queue_ms[rid] = (popped - pushed) * 1e3
                        report.batches += 1
                        report.batched_items += k
            t += 1
        report.wall_s = time.perf_counter() - t0
        report.cycles = t
        report.max_inflight_per_client = max_inflight
        report.releases_per_client = releases
        report.queue_stats = queue.stats()
        if self.keep_responses:
            report.responses = responses
        # conservation: every offered request is answered, dropped or shed
        if (report.offered != report.answered + report.dropped + report.shed
                or report.accepted != report.answered + report.shed
                or admitted_cycle):
            raise RuntimeError(f"serve ledger does not balance: {report.deterministic_stats()}")
        return report
