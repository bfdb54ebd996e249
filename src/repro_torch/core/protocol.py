"""The explicit two-program client/server protocol (paper Fig. 1), as
``repro.core.protocol``: separate client objects and a server object that
communicate only through a :class:`FeatureQueue`.

  * clients never expose raw data: only post-cut feature maps enter the
    queue;
  * the server never touches client parameters;
  * clients run round-robin (deterministic) or in threads, at rates
    proportional to their data.

This module is the client/arrival half of both queue engines
(``repro_torch.core.session``): ``protocol-async`` pairs the
:class:`SplitClient` fleet with :class:`SplitServer` (one trunk update a
pop), ``fused-queue`` pairs the same clients and the same
:func:`drive_protocol` arrival order with a :class:`BankedConsumer`, whose
bank one replay consumes (``trainer.make_server_bank_runner``).
:class:`FleetProducer` batches the fleet: a production cycle's releases run
as one fleet forward over the stacked client banks (one banked
``privacy_conv`` launch and one ``dp_release`` call where the model has the
kernels on), bit for bit what ``SplitClient.produce`` gives item by item.

Randomness is an input here, as in the rest of the port. Batch indices come
from each client's NumPy generator, seeded as in the reference, so they
equal the JAX package's. The release noise of client ``c`` comes from its
:class:`ReleaseNoise`: from ``noise_fn(c, release, model_shape,
guard_shape)`` where one is given (a test feeds JAX's draws through it),
else from the client's own CPU ``torch.Generator``, release by release, so
a fleet cycle and the per-item path consume each client's stream in the
same order.

Under a mesh (``launch.mesh``) every rank runs the whole drive, whose
order is deterministic: each rank holds every client's sampling RNG and
noise stream and draws every item, runs the privacy layers of its own
clients only, and the releases are gathered over the client axis, so every
rank's queue sees every item. The trunk steps tensor-parallel over a model
axis above 1 (``trainer.make_server_step``). The threaded drive under a
mesh has one arrival order, decided on the leader rank, which every rank
follows (:class:`LeaderRelay`).
"""
from __future__ import annotations

import collections
import json
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device, seeded_generator
from repro_torch.common.tree import tree_leaves
from repro_torch.core.adapters import SplitAdapter, fleet_release_forward
from repro_torch.core.faults import (
    ClientLoopError,
    FaultRun,
    RemoteClientError,
    RemoteLeaderError,
)
from repro_torch.core.queue import FeatureQueue, FeatureSlice, as_tensor
from repro_torch.core.trainer import CLIENT_AXIS, make_server_step, stack_pytrees
from repro_torch.launch.mesh import axis_names
from repro_torch.optim.optimizers import Optimizer
from repro_torch.privacy.guard import PrivacyGuard
from repro_torch.sharding.collectives import MeshAxis

# (client_id, release, model_shape, guard_shape) -> (model noise, guard noise)
NoiseFn = Callable[[int, int, Tuple[int, ...], Tuple[int, ...]], Tuple[Any, Any]]


def make_client_release_fwd(adapter: SplitAdapter,
                            guard: Optional[PrivacyGuard] = None
                            ) -> Callable[..., torch.Tensor]:
    """The client-side release: ``(params, x, model_noise, guard_noise) ->
    features``: the client's privacy layer with ``model_noise``, then the
    guard at the cut with ``guard_noise`` when the guard is enabled.
    Parameters are arguments, so one function serves every client."""
    guard = guard if guard is not None else PrivacyGuard()

    @torch.no_grad()
    def release(params, x, model_noise, guard_noise):
        feats = adapter.client_forward(params, x, model_noise)
        return guard.release_with_noise(feats, guard_noise) if guard.enabled else feats

    return release


def make_fleet_release_fwd(adapter: SplitAdapter, guard: Optional[PrivacyGuard] = None
                           ) -> Callable[..., torch.Tensor]:
    """The fleet-batched release: ``(stacked_banks, bank_of, xs,
    model_noise, guard_noise, plan_rows) -> features [N, b, ...]`` for a
    production cycle of N items (``adapters.fleet_release_forward``), item
    n on bank ``bank_of[n]``: per item exactly what
    ``make_client_release_fwd`` computes."""
    return torch.no_grad()(fleet_release_forward(adapter, guard))


class ReleaseNoise:
    """One client's release noise, release by release: ``draw(release,
    x_shape) -> (model_noise, guard_noise)``, standard normal of the
    features' shape, each ``None`` where the release adds none (the model
    noise where ``adapter.noise_scale > 0``, the guard's where its sigma is).

    From ``noise_fn`` where one is given; else model then guard noise from a
    CPU ``torch.Generator`` seeded from ``SeedSequence((seed, step,
    client_id))``, moved to ``device``, so one seed gives the same draws on
    the card and on the CPU."""

    def __init__(self, client_id: int, adapter: SplitAdapter, guard: PrivacyGuard, device,
                 *, seed: int = 0, step: int = 0, noise_fn: Optional[NoiseFn] = None):
        self.client_id = client_id
        self.adapter, self.guard, self.device = adapter, guard, device
        self.noise_fn = noise_fn
        self._gen = None if noise_fn is not None else seeded_generator(seed, step, client_id)

    def draw(self, release: int, x_shape) -> Tuple[Optional[torch.Tensor],
                                                   Optional[torch.Tensor]]:
        shape = tuple(self.adapter.feature_shape(tuple(x_shape)))
        want_model, want_guard = self.adapter.noise_scale > 0.0, self.guard.sigma > 0.0
        if self.noise_fn is not None:
            m, g = self.noise_fn(self.client_id, release, shape, shape)
            move = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                                          device=self.device)
            return (move(m) if want_model else None), (move(g) if want_guard else None)
        m = torch.randn(shape, generator=self._gen) if want_model else None
        g = torch.randn(shape, generator=self._gen) if want_guard else None
        return (None if m is None else m.to(self.device)), (None if g is None
                                                            else g.to(self.device))


class SplitClient:
    """A hospital: private data and the privacy-preserving layer ONLY.

    Batch indices come from ``default_rng(noise_seed + client_id)``, the
    reference's sampling stream; the release noise from ``noise`` (a
    :class:`ReleaseNoise`; by default one seeded from ``noise_seed``).
    ``releases`` counts every batch that left the privacy layer, whether or
    not the queue took it, for the (ε, δ) accountant. ``as_numpy=False``
    keeps the released features on the device (the fused-queue engine); with
    ``True`` each release is copied to the host, the queue being a host
    object (protocol-async).

    ``axis`` (a ``MeshAxis`` of the client axis) and ``owner`` (the index
    along it of the rank that holds this client): every rank samples and
    draws the noise, the owner alone runs the privacy layer, and the
    release is broadcast over the axis."""

    def __init__(self, client_id: int, adapter: SplitAdapter, client_params,
                 data: Tuple[np.ndarray, np.ndarray], batch: int, noise_seed: int = 0, *,
                 guard: Optional[PrivacyGuard] = None, fwd=None,
                 noise: Optional[ReleaseNoise] = None, as_numpy: bool = True, device=None,
                 axis: Optional[MeshAxis] = None, owner: int = 0):
        self.client_id = client_id
        self.axis, self.owner = axis, owner
        self.adapter = adapter
        self.params = client_params  # never leaves this object
        self.x, self.y = data
        self.batch = batch
        self.releases = 0
        self.device = resolve_device(device)
        guard = guard if guard is not None else PrivacyGuard()
        self._as_numpy = as_numpy
        self._rng = np.random.default_rng(noise_seed + client_id)  # batch sampling
        self.noise = noise if noise is not None else ReleaseNoise(
            client_id, adapter, guard, self.device, seed=noise_seed)
        self._fwd = fwd if fwd is not None else make_client_release_fwd(adapter, guard)

    def sample_batch(self):
        """One host-side batch draw ``(x[idx], y[idx])`` from this client's
        sampling RNG, shared by :meth:`produce` and :class:`FleetProducer`, so
        both consume the same index stream in the same order."""
        idx = self._rng.integers(0, len(self.x), size=self.batch)
        return self.x[idx], self.y[idx]

    def produce(self):
        """One queue item: (released feature map, labels). Raw x never returned."""
        xb, yb = self.sample_batch()
        self.releases += 1
        model_noise, guard_noise = self.noise.draw(self.releases, xb.shape)
        if self.axis is None or self.axis.index == self.owner:
            features = self._fwd(self.params, torch.as_tensor(xb, device=self.device),
                                 model_noise, guard_noise)
        else:
            features = torch.empty(self.adapter.feature_shape(tuple(xb.shape)),
                                   dtype=_dtype_of(self.params), device=self.device)
        if self.axis is not None:
            features = self.axis.broadcast(features.contiguous(), self.owner)
        return (features.cpu().numpy() if self._as_numpy else features), yb


def _dtype_of(params) -> torch.dtype:
    return tree_leaves(params)[0].dtype


class FleetProducer:
    """Production across the client fleet: one fleet forward a production
    cycle instead of one release a push.

    The clients' banks are stacked once (leading ``[n_clients]`` axis; the
    stack lives on the client side of the cut). A request for
    ``counts[c]`` items of client ``c``:

      1. draws every item's batch from the client's own sampling RNG
         (``SplitClient.sample_batch``) and its noise from the client's own
         :class:`ReleaseNoise`, in the per-item path's order;
      2. advances each client's ``releases`` by ``counts[c]`` (the drive's
         cycle planner guarantees the per-item path would have produced
         exactly these items);
      3. runs ONE :func:`make_fleet_release_fwd` call;
      4. returns the items in per-item production order as ``(client_id,
         FeatureSlice, labels)``, row views of the one release tensor.

    ``mesh`` (with a ``"clients"`` axis): the banks of this rank's clients
    alone are stacked; a cycle runs one fleet forward over this rank's
    items (the guard's plan chosen for the whole cycle's rows), and one
    all-gather over the client axis assembles the cycle's releases in
    production order on every rank. ``dispatches`` counts this rank's
    forwards.
    """

    def __init__(self, clients: Sequence[SplitClient], fleet_fwd, *, chunk: int = 8,
                 mesh=None):
        self.clients = list(clients)
        self.chunk = int(chunk)  # the threaded drive's items a dispatch
        self._fwd = fleet_fwd
        self.axis = (MeshAxis(mesh, CLIENT_AXIS)
                     if mesh is not None and CLIENT_AXIS in axis_names(mesh) else None)
        self._mine = (slice(None) if self.axis is None
                      else self.axis.rows(len(self.clients)))
        self._banks = stack_pytrees([c.params for c in self.clients[self._mine]])
        self._lo = self._mine.start or 0
        self.device = self.clients[0].device
        self.dispatches = 0  # fleet forwards run; client threads add under the lock
        self._lock = threading.Lock()

    def produce(self, counts: Sequence[int]) -> collections.deque:
        """Produce ``counts[c]`` items for client ``c`` (cycle order: all of
        client 0's items, then client 1's, ...) in one dispatch; returns a
        deque of ``(client_id, features, labels)`` queue items."""
        cids, xs, labels, model, guard = [], [], [], [], []
        for client, cnt in zip(self.clients, counts):
            for _ in range(int(cnt)):
                xb, yb = client.sample_batch()
                client.releases += 1
                m, g = client.noise.draw(client.releases, xb.shape)
                cids.append(client.client_id)
                xs.append(xb)
                labels.append(yb)
                model.append(m)
                guard.append(g)
        if not cids:
            return collections.deque()
        if self.axis is None:
            feats = self._forward(cids, xs, model, guard, None)
        else:
            # this rank's items are one run of the cycle (clients in order)
            width = len(self.clients) // self.axis.size
            per_rank = [sum(int(c) for c in counts[r * width:(r + 1) * width])
                        for r in range(self.axis.size)]
            lo = sum(per_rank[: self.axis.index])
            mine = slice(lo, lo + per_rank[self.axis.index])
            b = xs[0].shape[0]
            if per_rank[self.axis.index]:
                local = self._forward(cids[mine], xs[mine], model[mine], guard[mine],
                                      len(cids) * b)
            else:
                client = self.clients[0]
                shape = client.adapter.feature_shape((b,) + tuple(xs[0].shape[1:]))
                local = torch.empty((0,) + tuple(shape), dtype=_dtype_of(self._banks),
                                    device=self.device)
            feats = self.axis.gather_ragged(local, per_rank)
        return collections.deque((cid, FeatureSlice(feats, i), labels[i])
                                 for i, cid in enumerate(cids))

    def _forward(self, cids, xs, model, guard, plan_rows):
        """One fleet forward over these items, on this rank's banks."""
        stack = lambda ts: None if ts[0] is None else torch.stack(ts)  # noqa: E731
        args = (self._banks, [c - self._lo for c in cids],
                torch.as_tensor(np.stack(xs), device=self.device), stack(model), stack(guard))
        feats = self._fwd(*args, plan_rows=plan_rows)
        with self._lock:
            self.dispatches += 1
        return feats

    def produce_for(self, client: SplitClient, n: int) -> collections.deque:
        """Threaded drive: ``n`` upcoming items of ONE client in one
        dispatch (releases advance at production, as on the per-item path)."""
        return self.produce([n if c is client else 0 for c in self.clients])


class SplitServer:
    """The centralized server: trunk parameters, optimizer and the feature
    queue; one trunk update a pop (``trainer.make_server_step``, the step
    the fused-queue replay calls too). ``mesh``: the step runs the trunk
    tensor-parallel over a model axis above 1."""

    def __init__(self, adapter: SplitAdapter, server_params, opt: Optimizer,
                 queue: FeatureQueue, clip_norm: float = 1.0, opt_state=None,
                 step_count: int = 0, *, step_fn=None, device=None, mesh=None):
        self.adapter = adapter
        self.params = server_params
        self.opt = opt
        self.opt_state = opt.init(server_params) if opt_state is None else opt_state
        self.queue = queue
        self.step_count = step_count
        self.losses: List[float] = []
        self.device = resolve_device(device)
        self._step = step_fn if step_fn is not None else make_server_step(adapter, opt,
                                                                          clip_norm, mesh)

    def train_one(self, timeout: float = 1.0, retries: int = 0,
                  backoff: float = 2.0) -> Optional[float]:
        """One queue pop -> one trunk update. ``timeout`` is the pop wait; an
        empty-handed pop is retried up to ``retries`` times with waits
        ``timeout * backoff**k`` (counted in ``FeatureQueue.stats()``)."""
        item = _pop_with_backoff(self.queue, timeout, retries, backoff)
        if item is None:
            return None
        return self.consume(*item)

    def consume(self, client_id, features, labels) -> float:
        """One trunk update on one queue item."""
        self.params, self.opt_state, loss = self._step(
            self.params, self.opt_state, self.step_count,
            as_tensor(features, self.device), torch.as_tensor(labels, device=self.device))
        self.step_count += 1
        loss = float(loss)
        self.losses.append(loss)
        return loss


class BankedConsumer:
    """The fused-queue engine's consumer inside :func:`drive_protocol`: the
    ``step_count``/``train_one`` surface of ``SplitServer``, but each pop is
    accepted into a ``FeatureBank`` (in the queue's release order) instead
    of stepping the trunk; the bank replay steps it afterwards."""

    def __init__(self, queue: FeatureQueue, step_count: int = 0):
        self.queue = queue
        self.step_count = step_count
        self.bank = None  # the engine installs a fresh FeatureBank an epoch

    def train_one(self, timeout: float = 1.0, retries: int = 0,
                  backoff: float = 2.0) -> Optional[float]:
        if self.bank is None or self.bank.full:
            return None  # nowhere to put an item: leave it queued
        item = _pop_with_backoff(self.queue, timeout, retries, backoff)
        if item is None:
            return None
        return self.consume(*item)

    def consume(self, client_id, features, labels) -> None:
        """Bank one queue item; no loss yet: it comes from the replay."""
        self.bank.accept(client_id, features, labels)
        self.step_count += 1


def _pop_with_backoff(queue: FeatureQueue, timeout: float, retries: int,
                      backoff: float):
    """Pop with exponential backoff: wait ``timeout``, then ``timeout *
    backoff``, ``timeout * backoff**2``, … for up to ``retries`` re-pops,
    counting ``timeouts``/``retries`` in the queue's stats. Shared by both
    queue consumers and the serving server."""
    item = queue.pop(timeout=timeout)
    wait = timeout
    for _ in range(int(retries)):
        if item is not None:
            return item
        wait *= backoff
        queue.note_retry()
        item = queue.pop(timeout=wait)
    return item


# the threaded mesh drive's header kinds: a pop that found nothing, an item,
# the end of the drive
_EMPTY, _ITEM, _STOP = 0, 1, 2


class LeaderRelay:
    """The threaded drive across the ranks of a mesh: one arrival order,
    decided on the leader (global rank 0; a mesh covers the world), which
    every rank follows. Every collective runs on the main thread, and every
    rank issues the same ones in the same order.

    The leader alone runs the client threads, the queue, the fault run, the
    pops with their timeouts, retries and back-off, and the quorum halt.
    Its production runs without the client axis (the queue engines hold
    every bank whole on every rank), so no thread needs a collective; the
    client axis then places the banks but does not split production, and
    no value changes: a release is a function of (client, release number,
    noise) alone. After each pop attempt the leader broadcasts a header
    ``[kind, client_id, release]`` (nothing popped, an item, or the end)
    and, for an item, its features and labels, which every rank consumes
    (``SplitServer.consume``: the trunk step, tensor-parallel over a model
    axis above 1; ``BankedConsumer.consume``: a bank slot). The other ranks
    run no threads. At the end of a drive the leader broadcasts the
    accounting, which the other ranks adopt: the queue's counters, each
    client's releases, the fleet's dispatches, the fault run's counters
    and halt, and a client thread's error, which every rank then raises as
    ``ClientLoopError`` (a ``RemoteClientError`` with the leader's ``repr``
    as the cause). The end is sent from the drive's ``finally``, so an
    exception of the leader's main thread (a pop, the quorum check, the
    relay's own work) ends the drive on every rank too: the leader raises
    it, every other rank a ``RemoteLeaderError`` with its ``repr``. An item
    is built whole before its header goes out, so no such exception falls
    between a header and its payload. Not covered: an exception inside a
    collective, which breaks the group, and one inside the step that every
    rank runs on an item (``consume``: the trunk step, tensor-parallel over
    a model axis), which the other ranks raise themselves from the same
    computation; the leader then sends no end. A follower's queue carries
    the leader's counters, not its items, and its clients produce nothing;
    each run builds the clients anew from the server step, which every rank
    shares, so a later fit starts every rank's sampling and noise streams
    where the leader's stand. ``pops`` is the run's arrival order as ``(client_id,
    release)``, on every rank.

    Queue items cross the leader's queue as ``(client_id, (features,
    release), labels)``."""

    def __init__(self, device):
        self.device = device
        self.leader = dist.get_rank() == 0
        self.pops: List[Tuple[int, int]] = []
        self.stepping = False  # inside an item's step, which every rank runs

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=0)
        return t

    def _header(self, kind: int = 0, client_id: int = -1, release: int = 0) -> List[int]:
        return self._bcast(torch.tensor([kind, client_id, release], dtype=torch.int64,
                                        device=self.device)).tolist()

    def lead_one(self, server, timeout: float, retries: int, backoff: float) -> None:
        """Leader: one pop attempt, broadcast, and the item consumed."""
        item = _pop_with_backoff(server.queue, timeout, retries, backoff)
        if item is None:
            self._header(_EMPTY)
            return
        cid, (features, release), labels = item
        f = as_tensor(features, self.device).contiguous()
        y = torch.as_tensor(np.asarray(labels), device=self.device)
        self._header(_ITEM, cid, release)
        self._bcast(f)
        self._bcast(y)
        self.pops.append((cid, release))
        self.stepping = True
        server.consume(cid, features, labels)
        self.stepping = False

    def follow(self, server, clients: Sequence[SplitClient], queue: FeatureQueue,
               fleet: Optional[FleetProducer], faults: Optional[FaultRun]) -> None:
        """Another rank: consume the leader's items until the end of its
        drive, then adopt its accounting (raising its main thread's error,
        else its client error)."""
        c0 = clients[0]
        x_shape = (c0.batch,) + tuple(c0.x.shape[1:])
        f_shape, f_dtype = tuple(c0.adapter.feature_shape(x_shape)), _dtype_of(c0.params)
        y_shape = (c0.batch,) + tuple(c0.y.shape[1:])
        y_dtype = torch.as_tensor(np.asarray(c0.y[:1])).dtype
        while True:
            kind, cid, release = self._header()
            if kind == _STOP:
                break
            if kind == _ITEM:
                f = self._bcast(torch.empty(f_shape, dtype=f_dtype, device=self.device))
                y = self._bcast(torch.empty(y_shape, dtype=y_dtype, device=self.device))
                self.pops.append((cid, release))
                server.consume(cid, f, y.cpu().numpy())
        acc = self._json()
        for k, v in acc["queue"].items():
            setattr(queue, k, v)
        for c, n in zip(clients, acc["releases"]):
            c.releases = n
        if fleet is not None:
            fleet.dispatches = acc["dispatches"]
        if faults is not None:
            for k, v in acc["faults"].items():
                setattr(faults, k, v)
        if acc["leader_error"] is not None:
            raise RemoteLeaderError(acc["leader_error"])
        if acc["error"] is not None:
            cid, cause = acc["error"]
            err = RemoteClientError(cause)
            raise ClientLoopError(cid, err) from err

    def finish(self, clients: Sequence[SplitClient], queue: FeatureQueue,
               fleet: Optional[FleetProducer], faults: Optional[FaultRun],
               error: Optional[Tuple[int, BaseException]],
               leader_error: Optional[BaseException] = None) -> None:
        """Leader: end the drive on every rank and send the accounting, with
        a client thread's ``error`` and the main thread's
        ``leader_error``."""
        self._header(_STOP)
        fault_counters = None if faults is None else {
            k: getattr(faults, k) for k in ("transit_dropped", "duplicated", "down_cycles",
                                            "halted", "halt_reason")}
        self._json({"queue": queue.stats(), "releases": [int(c.releases) for c in clients],
                    "dispatches": None if fleet is None else fleet.dispatches,
                    "faults": fault_counters,
                    "error": None if error is None else [error[0], repr(error[1])],
                    "leader_error": None if leader_error is None else repr(leader_error)})

    def _json(self, obj=None):
        """``obj`` from the leader, as JSON, on every rank."""
        if self.leader:
            data = torch.frombuffer(bytearray(json.dumps(obj).encode()), dtype=torch.uint8)
            self._bcast(torch.tensor([data.numel()], dtype=torch.int64, device=self.device))
            self._bcast(data.to(self.device))
            return obj
        n = int(self._bcast(torch.empty(1, dtype=torch.int64, device=self.device)))
        data = self._bcast(torch.empty(n, dtype=torch.uint8, device=self.device))
        return json.loads(data.cpu().numpy().tobytes().decode())


def _plan_round_robin_cycle(
    queue_len: int, queue_size: int, step: int, total: int,
    quanta: Sequence[int], available: Optional[Sequence[bool]] = None,
) -> List[int]:
    """How many items each client PRODUCES in one round-robin cycle: the
    per-item drive's lazy production, restated as counting so that fleet
    production can batch a cycle without over-producing (the reference's
    function, line for line).

    The per-item loop produces an item just before its push attempt, so in
    the drive's last cycle production stops early: at a client boundary
    once the step target is reached, or one item after the queue jams (the
    ``dropped`` item). In round-robin mode the consumer advances only
    through drains, so a client with quantum ``q`` gets ``free_slots +
    (total - step)`` pushes before the queue jams. Producing more would
    advance the clients' sampling RNGs, noise streams and ``releases`` past
    the per-item path's, breaking resume parity and the (ε, δ) accounting.
    ``available`` (the fault plan's up mask, ``None`` = all up) leaves DOWN
    clients out of the cycle.
    """
    counts = [0] * len(quanta)
    for i, q in enumerate(int(x) for x in quanta):
        if step >= total:
            break
        if available is not None and not available[i]:
            continue
        if q <= 0:
            continue
        free = queue_size - queue_len
        capacity = free + (total - step)
        if q <= capacity:
            counts[i] = q
            step += max(0, q - free)           # drains this quantum forces
            queue_len = min(queue_size, queue_len + q)
        else:  # jams: `capacity` pushes land, the (capacity+1)-th drops
            counts[i] = capacity + 1
            break
    return counts


def _fault_halt_check(faults: FaultRun, queue: FeatureQueue, step: int) -> bool:
    """The drive's quorum policy: halt cleanly when too few clients are up,
    or when the whole fleet is down over an empty queue (crash windows are
    keyed on the server step, which cannot advance without arrivals)."""
    plan = faults.plan
    up = sum(plan.up_mask(step))
    if up < plan.halt_below:
        faults.halt(f"quorum lost at step {step}: {up} up < "
                    f"halt_below={plan.halt_below}")
        return True
    if up == 0 and len(queue) == 0:
        faults.halt(f"all clients down at step {step} with an empty queue")
        return True
    return False


def drive_protocol(
    clients: Sequence[SplitClient],
    server,
    queue: FeatureQueue,
    shares: Sequence[float],
    total_server_steps: int,
    *,
    threaded: bool = True,
    fleet: Optional[FleetProducer] = None,
    faults: Optional[FaultRun] = None,
    pop_timeout: float = 1.0,
    pop_retries: int = 0,
    pop_backoff: float = 2.0,
    relay: Optional[LeaderRelay] = None,
) -> Dict[str, Any]:
    """Drive prebuilt clients and a consumer until ``server.step_count``
    reaches ``total_server_steps`` (an ABSOLUTE target, so repeated calls
    resume), as the reference's ``drive_protocol``. ``server`` is a
    ``SplitServer`` (protocol-async) or a :class:`BankedConsumer`
    (fused-queue): both engines share this arrival order.

    With a :class:`FleetProducer`, the round-robin drive plans each cycle
    (:func:`_plan_round_robin_cycle`), produces its items in one dispatch,
    then replays the per-item push/drain/drop state machine over them; the
    threaded drive has each client thread produce ``fleet.chunk`` items a
    dispatch. A queue with a ``per_client_cap``, or a fault plan with
    transport faults, falls back to per-item production (the planner cannot
    see those rejections and losses).

    With a ``FaultRun``, down clients are skipped (no production, no RNG
    advance, no budget), the survivors' quanta are reweighted, stragglers
    produce smaller quanta (round-robin) or arrive late (threaded), the
    transport may drop or duplicate a release after it left the privacy
    layer, and the quorum policy (:func:`_fault_halt_check`) halts the drive
    cleanly. A threaded client loop that raises stops the drive and
    re-raises as ``ClientLoopError``, the original as ``__cause__``.

    Kernel launches from client threads go to the one current (default)
    stream; tensors cross threads through the queue.

    ``relay`` (a :class:`LeaderRelay`; the threaded drive under a mesh): the
    leader rank runs the threaded drive and relays each pop to the other
    ranks, which follow it without threads (the clients' production must
    then issue no collective: no client axis on them or the fleet).

    Returns ``{"dropped", "drained", "halted"}``: produced batches never
    enqueued; consumptions forced by a full queue between pushes (0 in
    threaded mode); whether the quorum policy stopped the drive.
    """
    dropped = drained = 0
    if threaded and relay is not None and not relay.leader:
        relay.follow(server, clients, queue, fleet, faults)
        return {"dropped": 0, "drained": 0,
                "halted": faults.halted if faults is not None else False}
    if threaded:
        stop = threading.Event()
        errors: List[Tuple[int, BaseException]] = []

        def client_loop(client: SplitClient, share: float):
            pending: collections.deque = collections.deque()
            try:
                while not stop.is_set():
                    if faults is not None and not faults.plan.available(
                        client.client_id, server.step_count
                    ):
                        pending.clear()  # a crash loses its in-flight items
                        time.sleep(0.002)  # (their budget is already spent)
                        continue
                    if not pending:
                        first = client.releases + 1
                        if fleet is not None:
                            made = fleet.produce_for(client, fleet.chunk)
                        else:
                            f, l = client.produce()
                            made = [(client.client_id, f, l)]
                        pending.extend((cid, f, l, first + i)
                                       for i, (cid, f, l) in enumerate(made))
                    cid, f, l, release = pending.popleft()
                    copies = 1
                    if faults is not None:
                        fate = faults.transit(cid)
                        copies = {"ok": 1, "dup": 2, "drop": 0}[fate]
                    if relay is not None:
                        f = (f, release)
                    for _ in range(copies):
                        while not queue.push(cid, f, l) and not stop.is_set():
                            time.sleep(0.001)  # backpressure
                    # arrival rate ∝ data share; stragglers arrive late
                    sleep = max(0.0005, 0.002 * (1 - share))
                    if faults is not None:
                        sleep = faults.plan.straggler_sleep(client.client_id, sleep)
                    time.sleep(sleep)
            except Exception as e:  # surfaced to the caller as ClientLoopError
                errors.append((client.client_id, e))
                stop.set()  # a dead producer must stop the drive, not hang it

        threads = [
            threading.Thread(target=client_loop, args=(c, s), daemon=True)
            for c, s in zip(clients, shares)
        ]
        for t in threads:
            t.start()
        leader_error = None
        try:
            while server.step_count < total_server_steps:
                if errors:
                    break
                if faults is not None and _fault_halt_check(
                    faults, queue, server.step_count
                ):
                    break
                if relay is None:
                    server.train_one(timeout=pop_timeout, retries=pop_retries,
                                     backoff=pop_backoff)
                else:
                    relay.lead_one(server, pop_timeout, pop_retries, pop_backoff)
        except BaseException as e:  # sent to the other ranks, then re-raised
            leader_error = e
            raise
        finally:
            # a thread mid-dispatch finishes it before it sees ``stop``; its
            # releases and launches must be counted before the run reports
            stop.set()
            for t in threads:
                t.join(timeout=30.0)
            if relay is not None and not relay.stepping:
                relay.finish(clients, queue, fleet, faults, errors[0] if errors else None,
                             leader_error)
        if errors:
            cid, exc = errors[0]
            raise ClientLoopError(cid, exc) from exc
    else:  # deterministic round-robin (rate ∝ share)
        base_quanta = np.maximum(1, np.round(np.asarray(shares) * 10).astype(int))
        plan_cycles = (fleet is not None and queue.per_client_cap is None
                       and (faults is None or not faults.plan.has_transport_faults))
        stalled_cycles = 0
        while server.step_count < total_server_steps:
            if faults is not None:
                if _fault_halt_check(faults, queue, server.step_count):
                    break
                if stalled_cycles >= 1000:
                    # e.g. drop_prob ~ 1.0: nothing ever arrives, the step
                    # target is unreachable; stop spending budget
                    faults.halt(f"no progress for {stalled_cycles} cycles "
                                f"at step {server.step_count}")
                    break
                step_before, pushed_before = server.step_count, queue.pushed
                quanta, up = faults.plan.cycle_quanta(server.step_count, shares)
                faults.note_cycle(up)
            else:
                quanta, up = base_quanta, None
            pending = None
            if plan_cycles:
                pending = fleet.produce(_plan_round_robin_cycle(
                    len(queue), queue.max_size, server.step_count,
                    total_server_steps, quanta, available=up,
                ))
            for i, (c, q) in enumerate(zip(clients, quanta)):
                if server.step_count >= total_server_steps:
                    break
                if up is not None and not up[i]:
                    continue  # down: no production, no RNG advance, no budget
                for _ in range(int(q)):
                    if pending is not None:
                        if not pending:  # planner: never produced per-item
                            break
                        cid, f, l = pending.popleft()
                    else:
                        f, l = c.produce()
                        cid = c.client_id
                    copies = 1
                    if faults is not None and faults.plan.has_transport_faults:
                        fate = faults.transit(cid)
                        if fate == "drop":
                            continue  # lost in transit; budget already spent
                        copies = 2 if fate == "dup" else 1
                    jammed = False
                    for _ in range(copies):
                        # a full queue DRAINS the consumer instead of
                        # dropping the batch
                        pushed = queue.push(cid, f, l)
                        while not pushed and server.step_count < total_server_steps:
                            before = server.step_count
                            server.train_one(timeout=0.0)
                            if server.step_count == before:
                                break  # consumer can't make room: fall through
                            drained += 1
                            pushed = queue.push(cid, f, l)
                        if not pushed:  # target reached, queue still full
                            dropped += 1
                            jammed = True
                            break
                    if jammed:
                        break
            while len(queue) and server.step_count < total_server_steps:
                server.train_one(timeout=0.0)
            if faults is not None:
                made_progress = (server.step_count != step_before
                                 or queue.pushed != pushed_before)
                stalled_cycles = 0 if made_progress else stalled_cycles + 1
    return {"dropped": dropped, "drained": drained,
            "halted": faults.halted if faults is not None else False}


def run_protocol(adapter: SplitAdapter, shards: Sequence[Tuple[np.ndarray, np.ndarray]],
                 opt: Optimizer, *, total_server_steps: int, client_batch: int = 32,
                 data_shares: Optional[Sequence[float]] = None, queue_size: int = 64,
                 seed: int = 0, threaded: bool = True, device=None) -> Dict[str, Any]:
    """DEPRECATED: use ``repro_torch.core.session.SplitSession`` with
    ``engine="protocol-async"``; delegates to it. Returns the legacy result
    dict."""
    warnings.warn(
        "run_protocol is deprecated; use SplitSession(engine='protocol-async')",
        DeprecationWarning, stacklevel=2,
    )
    from repro_torch.core.session import SplitSession
    from repro_torch.core.trainer import SplitTrainConfig

    n = len(shards)
    shares = tuple(data_shares or [1.0 / n] * n)
    session = SplitSession(
        adapter, SplitTrainConfig(n_clients=n, data_shares=shares), opt,
        engine="protocol-async", seed=seed, device=device, threaded=threaded,
        client_batch=client_batch, queue_size=queue_size,
    )
    session.fit(shards, epochs=1, steps_per_epoch=total_server_steps)
    native = session.native_state
    return {
        "server_params": native["server"],
        "client_params": list(native["client_banks"]),
        "losses": session.engine.losses,
        "queue_stats": session.engine.stats,
        "server_steps": int(native["step"]),
    }
