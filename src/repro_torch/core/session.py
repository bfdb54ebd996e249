"""One ``SplitSession`` over the port's execution regimes, as
``repro.core.session``.

Canonical state (the JAX package's, leaf for leaf, so checkpoints cross)::

    {
      "client_banks": tree, every leaf with a leading [n_clients] axis,
      "server":       server trunk params,
      "opt":          engine-native optimizer state (fused: flat buffers in
                      ``ravel_pytree`` order; looped: moment trees),
      "step":         int32 optimizer steps,
      "privacy":      the (ε, δ) accountant's budget leaves,
    }

Engines register by name (``available_engines()``): ``auto``,
``fused-scan`` and ``fused-stepwise`` (the fused engine; ``auto`` is scan
mode, the accelerator path of the reference's heuristic, since here both
modes run one loop of steps), ``looped-ref`` (the seed's per-client loop),
the two queue engines, ``protocol-async`` (real client and server
objects behind a ``FeatureQueue``, one trunk update a pop) and
``fused-queue`` (the same arrivals banked, then replayed), which alone take
``fit(..., faults=FaultPlan)``, and ``fedavg``, the paper's FL baseline
(``core.fedavg``). The queue engines' ``opt`` leaf is the optimizer's
moment tree and their ``step`` counts server steps, FedAvg's ``opt`` is
empty and its ``step`` counts rounds, as in the reference, so their
checkpoints cross with the JAX package's, and ``llm-split``, the LM split
workload (``core.distributed``) for the attention-only transformer
families. ``audit_privacy`` runs the inversion attack (``privacy.audit``)
on a client's trained bank.

``mesh=`` takes a ``DeviceMesh`` from ``launch.mesh``: a 1-D client mesh
(``make_client_mesh``) or the 2-D ``("clients", "model")`` grid
(``make_split_mesh``), on the session's device type, for the fused engines,
the queue engines and ``llm-split`` (``looped-ref`` and ``fedavg`` refuse
it, as the reference's do). Every rank runs the same session (one process a
rank, SPMD): each rank runs its clients' privacy layers and the releases
are all-gathered over the client axis. The fused and queue engines hold
the canonical state whole: the trunk runs tensor-parallel over a model
axis above 1 and every rank completes the gradient and takes the same
optimizer step, so the state stays identical across ranks. ``llm-split``
over a model axis above 1 (or on a production grid) holds only its
blocks of the state (``core.distributed``). ``save`` writes the whole
state from rank 0.
Every rank holds the epoch data whole and draws the epoch's whole plan
from the same seed, and each step reads its clients' rows of them, so the
noise is the same for every layout and no placement step is needed (the
reference's ``_place`` lays its arrays out across devices); a ``(1, 1)``
grid is bit for bit no mesh.

Randomness. The JAX engines fold an epoch key out of ``PRNGKey(seed)``;
here every draw comes from a CPU ``torch.Generator`` seeded with the first
64-bit word of ``numpy.random.SeedSequence(entropy)``
(``common.device.seeded_generator``): ``(seed,)`` for the
initial weights, ``(seed, e)`` for the plan of the session's e-th epoch
(e = 1, 2, ...; ``make_sample_plan``). The draws move to the session's
device, so one seed gives the same weights, batches and noise on the card
and on the CPU (the runs then part by float32 rounding, which AdamW
amplifies), and ``restore`` resumes the epoch count, so the schedule
continues instead of replaying. ``SplitSession.state`` is a copy where the
engine updates its state in place (``llm-split``).

    session = SplitSession(adapter, SplitTrainConfig(...), adamw(1e-3))
    session.fit(shards, epochs=30, steps_per_epoch=10)
    session.evaluate(x_test, y_test)   # per-client + share-weighted mean
    session.save("ckpts/")             # canonical state -> npz + manifest
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint
from repro_torch.common.device import resolve_device, seeded_generator
from repro_torch.common.tree import ravel, tree_map
from repro_torch.core import fedavg as fedavg_mod
from repro_torch.core import protocol as protocol_mod
from repro_torch.core.adapters import SplitAdapter
from repro_torch.core.distributed import (
    LLMSplitAdapter,
    init_llm_params,
    is_sharded,
    llm_state_specs,
    llm_state_template,
    llm_step_parts,
    trainable_of,
)
from repro_torch.core.faults import ClientLoopError, FaultPlan
from repro_torch.core.queue import FeatureBank, FeatureQueue
from repro_torch.core.trainer import (
    CLIENT_AXIS,
    SamplePlan,
    SplitTrainConfig,
    _client_banks_list,
    check_mesh,
    client_weights,
    device_put_shards,
    evaluate_per_client,
    finite_mean,
    fused_client_batch,
    make_epoch_runner,
    make_looped_step,
    make_sample_plan,
    make_server_bank_runner,
    make_server_step,
    make_spatio_temporal_step,
    stack_pytrees,
    unstack_pytree,
)
from repro_torch.launch.mesh import axis_names, mesh_shape
from repro_torch.optim.optimizers import Optimizer
from repro_torch.privacy.accountant import (
    budget_advance,
    budget_init,
    budget_report,
    per_client_report,
)
from repro_torch.privacy.audit import guard_noise_sweep
from repro_torch.privacy.guard import PrivacyGuard
from repro_torch.sharding.collectives import MeshAxis
from repro_torch.sharding.tensor_parallel import shard_tree, whole_tree

Shards = Sequence[Tuple[np.ndarray, np.ndarray]]
EvalFn = Optional[Callable[[Any], Dict[str, float]]]

_ENGINES: Dict[str, Callable[..., Any]] = {}


def register_engine(name: str):
    def deco(factory):
        _ENGINES[name] = factory
        return factory
    return deco


def available_engines() -> List[str]:
    return sorted(_ENGINES)


def _readout(ms: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Stacked per-step metrics to the host in one copy."""
    keys = list(ms)
    host = torch.stack([ms[k].float() for k in keys]).cpu().numpy()
    return dict(zip(keys, host))


def _record(ep: int, per_step: Dict[str, np.ndarray], eval_fn: EvalFn, canonical) -> dict:
    rec: Dict[str, Any] = {k: float(np.mean(v)) for k, v in per_step.items()}
    rec["epoch"] = ep
    if eval_fn is not None:
        rec.update({f"val_{k}": v for k, v in eval_fn(canonical).items()})
    return rec


class _Engine:
    """What the two engines share: the epoch count behind the plan's
    generators, the plan and ``step_metrics``, each epoch's per-step
    metrics of the last ``run`` (``{metric: [T]}``, the port's addition:
    the reference's history keeps epoch means only)."""

    def __init__(self, adapter: SplitAdapter, tc: SplitTrainConfig, opt: Optimizer, device):
        self.adapter, self.tc, self.opt = adapter, tc, opt
        self.device = resolve_device(device)
        self._plans: Dict[int, Callable[..., SamplePlan]] = {}
        self._epochs_done = 0
        self.step_metrics: List[Dict[str, np.ndarray]] = []

    def _start(self, seed: int):
        self._seed = seed
        self._epochs_done = 0
        return seeded_generator(seed)

    def _next_plan(self, steps_per_epoch: int, lens, sample_shape) -> SamplePlan:
        plan = self._plans.get(steps_per_epoch)
        if plan is None:
            plan = self._plans[steps_per_epoch] = make_sample_plan(
                self.adapter, self.tc, steps_per_epoch)
        self._epochs_done += 1
        return plan(lens, sample_shape, seeded_generator(self._seed, self._epochs_done),
                    self.device)


def check_unroll(unroll) -> int:
    """``unroll`` as the reference's ``lax.scan`` takes it: a bool or an int
    of at least 0, else the ``ValueError`` that ``lax.scan`` raises."""
    if not isinstance(unroll, (bool, int)) or unroll < 0:
        raise ValueError(f"`unroll` must be a `bool` or a non-negative `int`, got {unroll!r}")
    return unroll


class FusedEngine(_Engine):
    """The fused engine: stacked banks, one flat trainable buffer, epochs of
    ``make_epoch_runner`` steps. Native state IS the canonical state.
    ``unroll`` is the reference's option (8 by default), checked as its
    ``lax.scan`` checks it and kept: an epoch here is a Python loop, which
    has nothing to unroll, so it changes no arithmetic. ``mesh``: both
    axes, the client banks' work over ``"clients"``, the trunk
    tensor-parallel over ``"model"`` (``trainer._make_fused``)."""

    def __init__(self, adapter, tc, opt, *, device=None, mesh=None,
                 mode: Optional[str] = None, unroll: int = 8):
        if mode not in (None, "scan", "stepwise"):
            raise ValueError(f"mode must be None, 'scan' or 'stepwise', got {mode!r}")
        self.unroll = check_unroll(unroll)
        super().__init__(adapter, tc, opt, device)
        self.name = "auto" if mode is None else f"fused-{mode}"
        self.mode = mode or "scan"
        self.mesh = mesh
        self._init_state, _ = make_spatio_temporal_step(adapter, tc, opt, self.device, mesh)
        self._runners: Dict[int, Callable] = {}

    def init(self, seed: int):
        return self._init_state(self._start(seed))

    def run(self, state, shards, *, epochs, steps_per_epoch, eval_fn=None):
        run_epoch = self._runners.get(steps_per_epoch)
        if run_epoch is None:
            _, run_epoch = make_epoch_runner(self.adapter, self.tc, self.opt, steps_per_epoch,
                                             mode=self.mode, device=self.device, mesh=self.mesh)
            self._runners[steps_per_epoch] = run_epoch
        data_x, data_y, lens = device_put_shards(shards, self.device)
        sample_shape = data_x.shape[2:]
        history, self.step_metrics = [], []
        for ep in range(epochs):
            plan = self._next_plan(steps_per_epoch, lens, sample_shape)
            state, ms = run_epoch(state, data_x, data_y, plan)
            self.step_metrics.append(_readout(ms))  # one readout an epoch
            history.append(_record(ep, self.step_metrics[-1], eval_fn, state))
        return state, history

    def to_canonical(self, state):
        return state

    def from_canonical(self, canonical):
        return canonical


def _fused_factory(mode):
    def factory(adapter, tc, opt, **kw):
        return FusedEngine(adapter, tc, opt, mode=mode, **kw)
    return factory


register_engine("auto")(_fused_factory(None))
register_engine("fused-scan")(_fused_factory("scan"))
register_engine("fused-stepwise")(_fused_factory("stepwise"))


@register_engine("looped-ref")
class LoopedEngine(_Engine):
    """The seed per-client Python-loop step behind the session surface.
    Batches and noise come from the same plan as the fused engines', so with
    uniform shares the two consume identical batches and their losses agree
    to float32 reassociation."""

    name = "looped-ref"

    def __init__(self, adapter, tc, opt, *, device=None, mesh=None):
        if mesh is not None:
            raise ValueError("looped-ref does not support mesh=; use a fused engine")
        super().__init__(adapter, tc, opt, device)
        self.detached = tc.mode == "detached"
        self._init_state, self._step = make_looped_step(adapter, tc, opt, self.device)

    def init(self, seed: int):
        return self._init_state(self._start(seed))

    def run(self, state, shards, *, epochs, steps_per_epoch, eval_fn=None):
        data_x, data_y, lens = device_put_shards(shards, self.device)
        history, self.step_metrics = [], []
        for ep in range(epochs):
            plan = self._next_plan(steps_per_epoch, lens, data_x.shape[2:])
            ms = []
            for t in range(steps_per_epoch):
                batches = [(data_x[c][plan.idx[t, c]], data_y[c][plan.idx[t, c]])
                           for c in range(self.tc.n_clients)]
                state, m = self._step(
                    state, batches,
                    None if plan.model_noise is None else plan.model_noise[t],
                    None if plan.guard_noise is None else plan.guard_noise[t])
                ms.append(m)
            self.step_metrics.append(_readout({k: torch.stack([m[k] for m in ms])
                                               for k in ms[0]}))
            history.append(_record(ep, self.step_metrics[-1], eval_fn,
                                   None if eval_fn is None else self.to_canonical(state)))
        return state, history

    def _map_trainable_banks(self, opt_state, fn):
        """Apply ``fn`` to the banks half of every trainable-shaped moment in
        the optimizer state (e2e trainable = (banks, server))."""
        if self.detached:
            return opt_state  # moments are server-shaped: nothing banked
        return {k: (fn(v[0]), v[1]) for k, v in opt_state.items()}

    def to_canonical(self, state):
        return {
            "client_banks": stack_pytrees(state["client_banks"]),
            "server": state["server"],
            "opt": self._map_trainable_banks(state["opt"], stack_pytrees),
            "step": state["step"],
            "privacy": state["privacy"],
        }

    def from_canonical(self, canonical):
        n = self.tc.n_clients
        return {
            "client_banks": unstack_pytree(canonical["client_banks"], n),
            "server": canonical["server"],
            "opt": self._map_trainable_banks(canonical["opt"], lambda t: unstack_pytree(t, n)),
            "step": canonical["step"],
            "privacy": canonical["privacy"],
        }


# ------------------------------------------------------------ async protocol
@register_engine("protocol-async")
class ProtocolEngine:
    """The two-program protocol (``core.protocol``) behind the session
    surface, as the reference's: real client and server objects that
    communicate only through a ``FeatureQueue``. One ``steps_per_epoch`` is
    one pop and trunk update. ``threaded=False`` is the deterministic
    round-robin drive; ``production="fleet"`` (default) runs each production
    cycle as one fleet forward over the stacked banks, bit for bit
    ``production="per-item"``. The releases are host NumPy arrays (the queue
    is a host object, the trust boundary): a copy to the host a push, and
    back a pop.

    The port's options beyond the reference's: ``device`` (``None``: the
    card) and ``noise_fn``, ``(client_id, release, model_shape, guard_shape)
    -> (model_noise, guard_noise)`` in place of the clients' generators
    (``protocol.ReleaseNoise``); it is read at each ``run``, so a caller
    that needs draws keyed on the run's start step sets it before a fit.

    ``mesh`` splits the protocol across both axes of the cut: each rank
    runs its own clients' releases (fleet production: one forward a cycle
    over its banks, then one all-gather; per item: the owner's release,
    broadcast), and every pop's trunk update runs tensor-parallel over a
    model axis above 1. The queue, the trust boundary, stays a host object
    that every rank drives in the same order. ``threaded=True`` refuses a
    mesh: its client threads would issue the collectives in no fixed
    order."""

    name = "protocol-async"
    # clients keep host-NumPy releases here; the fused-queue subclass flips it
    _client_as_numpy = True
    # fit(..., faults=FaultPlan): failures are a property of the multi-site
    # transport, which only the queue engines model
    supports_faults = True

    def __init__(self, adapter: SplitAdapter, tc: SplitTrainConfig, opt: Optimizer, *,
                 device=None, mesh=None, threaded: bool = False,
                 client_batch: Optional[int] = None,
                 queue_size: int = 64, per_client_cap: Optional[int] = None,
                 production: str = "fleet", fleet_chunk: int = 8, pop_timeout: float = 1.0,
                 pop_retries: int = 0, pop_backoff: float = 2.0, noise_fn=None):
        self.device = resolve_device(device)
        self.mesh, self._cax = mesh, None
        if mesh is not None:
            check_mesh(mesh, self.device, client_axis=None)
            if CLIENT_AXIS in axis_names(mesh):
                size = mesh_shape(mesh)[CLIENT_AXIS]
                if tc.n_clients % size != 0:
                    raise ValueError(
                        f"n_clients={tc.n_clients} does not divide over mesh axis "
                        f"{CLIENT_AXIS!r} of size {size}; the stacked client banks shard "
                        "their leading axis evenly")
                self._cax = MeshAxis(mesh, CLIENT_AXIS)
            if threaded:
                raise ValueError(
                    "threaded=True does not run across ranks: its client threads would "
                    "issue the mesh's collectives in no fixed order; use threaded=False "
                    "(the deterministic drive) with mesh=")
        if tc.mode != "detached":
            raise ValueError(
                f"{self.name} trains the server trunk only (the paper's "
                "detached regime); mode='e2e' needs a fused or looped engine"
            )
        if production not in ("fleet", "per-item"):
            raise ValueError(
                f"production must be 'fleet' or 'per-item', got {production!r}"
            )
        if fleet_chunk < 1:
            # a 0-item chunk would starve the threaded client loops forever
            raise ValueError(f"fleet_chunk must be >= 1, got {fleet_chunk}")
        if pop_timeout < 0:
            raise ValueError(f"pop_timeout must be >= 0, got {pop_timeout}")
        if pop_retries < 0:
            raise ValueError(f"pop_retries must be >= 0, got {pop_retries}")
        if pop_backoff < 1.0:
            # a shrinking backoff would busy-wait the starved consumer
            raise ValueError(f"pop_backoff must be >= 1.0, got {pop_backoff}")
        self.adapter, self.tc, self.opt = adapter, tc, opt
        self.threaded = threaded
        self.client_batch = client_batch or fused_client_batch(tc)
        self.queue_size, self.per_client_cap = queue_size, per_client_cap
        self.pop_timeout, self.pop_retries = pop_timeout, pop_retries
        self.pop_backoff = pop_backoff
        self.production, self.fleet_chunk = production, fleet_chunk
        self.noise_fn = noise_fn
        self.guard = PrivacyGuard(tc.privacy)
        # one release function for the whole fleet across fits (parameters
        # are arguments), the fleet-batched one, and the per-pop step
        self._client_fwd = protocol_mod.make_client_release_fwd(adapter, self.guard)
        self._fleet_fwd = protocol_mod.make_fleet_release_fwd(adapter, self.guard)
        self._server_step = make_server_step(adapter, opt, tc.grad_clip, mesh)
        self.losses: List[float] = []
        self.stats: Dict[str, Any] = {}
        self.fault_stats: Dict[str, Any] = {}
        self.step_metrics: List[Dict[str, np.ndarray]] = []
        self.queue: Optional[FeatureQueue] = None
        self.fleet: Optional[protocol_mod.FleetProducer] = None

    def init(self, seed: int):
        """The trunk from the first full init drawn from the seed's
        generator, then each client's bank from one more full init each."""
        self._seed = int(seed)
        gen = seeded_generator(seed)
        server = self.adapter.init(gen, self.device)["server"]
        banks = [self.adapter.init(gen, self.device)["client"]
                 for _ in range(self.tc.n_clients)]
        return {"client_banks": banks, "server": server, "opt": self.opt.init(server),
                "step": 0, "privacy": budget_init(self.device)}

    def _noise_seed_for(self, step: int) -> int:
        """The clients' batch-sampling seed base, advanced by consumed server
        steps so a second fit (or a restore-then-fit) draws fresh batches:
        the reference's ``seed + 100003 * step``."""
        return self._seed + 100003 * int(step)

    def _make_clients(self, state, shards):
        """The fleet, seeded from the consumed server step; shared verbatim
        by protocol-async and fused-queue."""
        step = int(state["step"])
        per_rank = self.tc.n_clients // (1 if self._cax is None else self._cax.size)
        return [
            protocol_mod.SplitClient(
                c, self.adapter, state["client_banks"][c],
                (np.asarray(shards[c][0]), np.asarray(shards[c][1])),
                batch=self.client_batch, noise_seed=self._noise_seed_for(step),
                guard=self.guard, fwd=self._client_fwd,
                noise=protocol_mod.ReleaseNoise(c, self.adapter, self.guard, self.device,
                                                seed=self._seed, step=step,
                                                noise_fn=self.noise_fn),
                as_numpy=self._client_as_numpy, device=self.device,
                axis=self._cax, owner=c // per_rank,
            )
            for c in range(self.tc.n_clients)
        ]

    # ---- the two hooks that differ between the per-pop and banked servers
    def _make_consumer(self, state, queue):
        return protocol_mod.SplitServer(
            self.adapter, state["server"], self.opt, queue, clip_norm=self.tc.grad_clip,
            opt_state=state["opt"], step_count=int(state["step"]),
            step_fn=self._server_step, device=self.device,
        )

    def _make_fleet(self, clients):
        """The fleet producer over this run's clients (the banks are frozen
        for the run: these engines are detached), or ``None`` per item."""
        if self.production != "fleet":
            return None
        return protocol_mod.FleetProducer(clients, self._fleet_fwd, chunk=self.fleet_chunk,
                                          mesh=self.mesh)

    def _consume_epoch(self, consumer, clients, queue, shares, steps_per_epoch,
                       fleet=None, faults=None):
        """Drive one epoch and return ``(losses, server_params, opt_state,
        step, drive_stats)``; the bookkeeping around it is shared with the
        fused-queue subclass, which keeps the two engines in lockstep."""
        n_before = len(consumer.losses)
        d = protocol_mod.drive_protocol(
            clients, consumer, queue, shares,
            consumer.step_count + steps_per_epoch, threaded=self.threaded,
            fleet=fleet, faults=faults, pop_timeout=self.pop_timeout,
            pop_retries=self.pop_retries, pop_backoff=self.pop_backoff,
        )
        # slice by the count BEFORE the drive: a quorum halt can end an
        # epoch short
        return (consumer.losses[n_before:], consumer.params,
                consumer.opt_state, consumer.step_count, d)

    def _assemble_fault_stats(self, frun, clients, error=None):
        """The ``fault_stats`` report: the plan, the halt state, per-client
        fault counters, per-client releases produced and, with the guard on,
        each hospital's own (ε, δ) spend this run."""
        fs: Dict[str, Any] = {
            "plan": None, "halted": False, "halt_reason": None,
            "client_error": None,
        }
        if frun is not None:
            fs.update(frun.stats())
        if clients is not None:
            produced = [int(c.releases) for c in clients]
            fs["releases_per_client"] = produced
            if self.guard.enabled:
                fs["per_client_privacy"] = per_client_report(self.tc.privacy, produced)
        if error is not None:
            fs["client_error"] = repr(error.cause)
            fs["client_error_id"] = error.client_id
        return fs

    def run(self, state, shards, *, epochs, steps_per_epoch, eval_fn=None,
            faults: Optional[FaultPlan] = None):
        if faults is not None and faults.n_clients != self.tc.n_clients:
            raise ValueError(
                f"FaultPlan covers {faults.n_clients} clients but the config "
                f"has n_clients={self.tc.n_clients}"
            )
        shares = np.asarray(self.tc.data_shares, np.float64)
        shares = (shares / shares.sum()).tolist()
        queue = FeatureQueue(max_size=self.queue_size, per_client_cap=self.per_client_cap)
        clients = self._make_clients(state, shards)
        fleet = self._make_fleet(clients)
        # the last run's queue and fleet producer, for a caller's audit
        # (``len(queue)``, ``fleet.dispatches``)
        self.queue, self.fleet = queue, fleet
        consumer = self._make_consumer(state, queue)
        # one FaultRun spans the run: its transport streams are keyed on the
        # canonical step at fit time, the schedule on the server step
        frun = faults.start_run(int(state["step"])) if faults is not None else None
        dropped = drained = 0
        history, self.step_metrics = [], []
        new_state = state
        try:
            for ep in range(epochs):
                losses, server_params, opt_state, step, d = self._consume_epoch(
                    consumer, clients, queue, shares, steps_per_epoch, fleet, frun,
                )
                dropped += d["dropped"]
                drained += d["drained"]
                self.losses.extend(losses)
                self.step_metrics.append({"loss": np.asarray(losses, np.float32)})
                rec = {"epoch": ep, "loss": finite_mean(losses), "server_steps": step}
                # the budget: the WORST-CASE client's releases this run (every
                # produced batch left the privacy layer; a down client's
                # counter holds still)
                released = max(c.releases for c in clients)
                new_state = {
                    "client_banks": [c.params for c in clients],
                    "server": server_params,
                    "opt": opt_state,
                    "step": step,
                    "privacy": budget_advance(state["privacy"], self.tc.privacy, released)
                    if self.guard.enabled else state["privacy"],
                }
                if eval_fn is not None:
                    rec.update({f"val_{k}": v
                                for k, v in eval_fn(self.to_canonical(new_state)).items()})
                history.append(rec)
                if d.get("halted"):
                    rec["halted"] = True
                    break  # the quorum policy ended the run cleanly
        except ClientLoopError as e:
            # surface the exception, with the audit trail in place
            self.fault_stats = self._assemble_fault_stats(frun, clients, e)
            self.stats = {**queue.stats(), "dropped": dropped, "drained": drained,
                          "privacy": budget_report(self.tc.privacy, new_state["privacy"])}
            raise
        self.stats = {**queue.stats(), "dropped": dropped, "drained": drained,
                      "privacy": budget_report(self.tc.privacy, new_state["privacy"])}
        self.fault_stats = self._assemble_fault_stats(frun, clients)
        return new_state, history

    def to_canonical(self, state):
        return {
            "client_banks": stack_pytrees(state["client_banks"]),
            "server": state["server"],
            "opt": state["opt"],
            "step": torch.tensor(int(state["step"]), dtype=torch.int32, device=self.device),
            "privacy": state["privacy"],
        }

    def from_canonical(self, canonical):
        return {
            "client_banks": unstack_pytree(canonical["client_banks"], self.tc.n_clients),
            "server": canonical["server"],
            "opt": canonical["opt"],
            "step": int(canonical["step"]),
            "privacy": canonical["privacy"],
        }


# ------------------------------------------------------------- fused-queue
@register_engine("fused-queue")
class FusedQueueEngine(ProtocolEngine):
    """The async-queue arrival semantics with the trunk updates batched, as
    the reference's: the same clients, queue, ``drive_protocol`` arrival
    order and accounting as ``protocol-async``, but a ``BankedConsumer``
    accepts each epoch's arrivals into a ``FeatureBank`` and one replay
    (``trainer.make_server_bank_runner``, the same step a slot) then steps
    the trunk, so a run is bit for bit protocol-async's. The releases stay
    on the device. Checkpoints interchange with protocol-async's.
    ``steps_per_epoch`` is only the bank's chunk size (the step counter and
    the clients' seed base are absolute); one epoch's releases live on the
    device at once. ``unroll`` is the reference's option (1 by default),
    checked as its ``lax.scan`` checks it and kept: the replay is a Python
    loop, which has nothing to unroll, so it changes no arithmetic."""

    name = "fused-queue"
    _client_as_numpy = False

    def __init__(self, adapter: SplitAdapter, tc: SplitTrainConfig, opt: Optimizer, *,
                 unroll: int = 1, **kw):
        self.unroll = check_unroll(unroll)
        super().__init__(adapter, tc, opt, **kw)
        self._run_bank = make_server_bank_runner(adapter, opt, tc.grad_clip,
                                                 step_fn=self._server_step)

    def _make_consumer(self, state, queue):
        self._server_params, self._opt_state = state["server"], state["opt"]
        return protocol_mod.BankedConsumer(queue, step_count=int(state["step"]))

    def _consume_epoch(self, consumer, clients, queue, shares, steps_per_epoch,
                       fleet=None, faults=None):
        """Bank one epoch of arrivals, then replay the bank; everything else
        is ProtocolEngine's, line for line."""
        step_before = consumer.step_count
        consumer.bank = bank = FeatureBank(steps_per_epoch)
        d = protocol_mod.drive_protocol(
            clients, consumer, queue, shares,
            step_before + steps_per_epoch, threaded=self.threaded,
            fleet=fleet, faults=faults, pop_timeout=self.pop_timeout,
            pop_retries=self.pop_retries, pop_backoff=self.pop_backoff,
        )
        if len(bank) == 0:
            # a quorum halt can end an epoch before a single item arrived
            return [], self._server_params, self._opt_state, consumer.step_count, d
        self._server_params, self._opt_state, _, losses = self._run_bank(
            self._server_params, self._opt_state, step_before, *bank.stacked(self.device)
        )
        epoch_losses = losses.cpu().tolist()[: len(bank)]  # the valid slots
        return (epoch_losses, self._server_params, self._opt_state,
                consumer.step_count, d)


# ------------------------------------------------------------------- fedavg
@register_engine("fedavg")
class FedAvgEngine:
    """The paper's FL comparison behind the session surface, as the
    reference's. ``epochs`` are FedAvg rounds, ``steps_per_epoch`` local
    steps a round. The canonical ``client_banks`` are n identical copies of
    the one global client block (FedAvg shares everything), so per-client
    evaluation and the privacy metrics still apply.

    The port's options beyond the reference's: ``device`` (``None``: the
    card) and ``noise_fn``, ``(round, client, step, shape) -> guard noise``
    in place of the seeded generators (``fedavg.fedavg_rounds``); it is read
    at each ``run``."""

    name = "fedavg"
    identical_banks = True  # evaluate scores one bank and repeats the row

    def __init__(self, adapter: SplitAdapter, tc: SplitTrainConfig, opt: Optimizer, *,
                 device=None, mesh=None, local_batch: int = 32, noise_fn=None):
        if mesh is not None:
            raise ValueError("fedavg does not support mesh=; use a fused engine")
        if tc.mode != "detached":
            raise ValueError(
                "fedavg trains full local models; SplitTrainConfig.mode does "
                "not apply — leave it at the default"
            )
        self.adapter, self.tc, self.opt = adapter, tc, opt
        self.device = resolve_device(device)
        self.local_batch = local_batch
        self.noise_fn = noise_fn
        self.guard = PrivacyGuard(tc.privacy)
        self.step_metrics: List[Dict[str, np.ndarray]] = []  # round means only, in history
        self._local_sgd = fedavg_mod.make_local_sgd(adapter, tc, opt)

    def init(self, seed: int):
        self._seed = int(seed)
        self._rng = np.random.default_rng(self._seed)
        return {"params": self.adapter.init(seeded_generator(seed), self.device), "round": 0,
                "privacy": budget_init(self.device)}

    def run(self, state, shards, *, epochs, steps_per_epoch, eval_fn=None):
        wrapped = None
        if eval_fn is not None:
            def wrapped(gp):
                return eval_fn(self.to_canonical(
                    {"params": gp, "round": 0, "privacy": state["privacy"]}))
        round_offset = int(state["round"])
        # round 0 draws the session's first stream; a later offset (a second
        # fit, or restore-then-fit) reseeds from (seed, round), so a restored
        # session draws what a continued one would
        rng = (self._rng if round_offset == 0
               else np.random.default_rng((self._seed, round_offset)))
        params, history = fedavg_mod.fedavg_rounds(
            self.adapter, self.tc, self.opt, shards, state["params"],
            rounds=epochs, local_steps=steps_per_epoch, local_batch=self.local_batch,
            rng=rng, round_offset=round_offset, local_sgd=self._local_sgd,
            eval_fn=wrapped, seed=self._seed, noise_fn=self.noise_fn,
        )
        for i, rec in enumerate(history):
            rec.setdefault("epoch", i)
            rec.setdefault("loss", rec["mean_local_loss"])
        # the reference's count: one release a local step, not a client
        privacy = (budget_advance(state["privacy"], self.tc.privacy, epochs * steps_per_epoch)
                   if self.guard.enabled else state["privacy"])
        return {"params": params, "round": round_offset + epochs, "privacy": privacy}, history

    def to_canonical(self, state):
        n = self.tc.n_clients
        return {
            "client_banks": tree_map(
                lambda a: a.unsqueeze(0).expand((n,) + tuple(a.shape)).contiguous(),
                state["params"]["client"]),
            "server": state["params"]["server"],
            "opt": {},  # FedAvg re-inits the client optimizers every round
            "step": torch.tensor(int(state["round"]), dtype=torch.int32, device=self.device),
            "privacy": state["privacy"],
        }

    def from_canonical(self, canonical):
        return {
            "params": {"client": tree_map(lambda a: a[0].clone(), canonical["client_banks"]),
                       "server": canonical["server"]},
            "round": int(canonical["step"]),
            "privacy": canonical["privacy"],
        }


# ---------------------------------------------------------------- llm-split
@register_engine("llm-split")
class LLMSplitEngine(_Engine):
    """The LM split workload (``core.distributed``) behind the session
    surface, as the reference's: per-client banks (embedding + privacy
    block(s)), the server trunk with an UNTIED head. Shards are per-client
    ``(windows, windows)`` pairs of ``[N, S]`` int32 token windows (labels
    are the tokens; the loss shifts them). The plan is the fused engines'
    (``make_sample_plan``: indices ``[T, C, b]``, then model and guard noise
    of the features' shape ``[T, C, b, S, d]``, from ``SeedSequence((seed,
    e))``), and the guard releases once a step over all ``C*b`` rows.

    ``shared_bank=True`` keeps ONE bank in the native state (identically
    initialized frozen banks are one bank in detached mode); the canonical
    state broadcasts it to ``[n_clients, ...]`` and back. ``mode="e2e"``
    trains per-client banks and rejects ``shared_bank``.

    The native state holds the trainable part as one flat buffer and the
    optimizer's moments as flat buffers (``llm_step_parts``), which the
    steps update in place, as the reference donates its state: the
    engine's canonical state is views of them, and ``SplitSession.state``
    copies it (``updates_in_place``). The weights are drawn leaf by leaf
    from a CPU generator seeded with ``SeedSequence((seed,))``'s first word
    and moved to the engine's device, so one seed gives the same weights,
    plans and noise on the card and on the CPU.

    On a sharded mesh (``core.distributed.is_sharded``: a model axis above
    1, or a production grid) the native state holds this rank's blocks
    (``llm_state_specs``): the flat buffer and its moments only the trunk's
    blocks, the banks only the rank's clients'. ``init`` draws the whole
    state and keeps the blocks; ``to_canonical`` gathers the whole state
    (every rank calls it, as ``save``, ``state`` and ``evaluate`` do) and
    ``from_canonical`` places a whole one."""

    name = "llm-split"
    updates_in_place = True

    def __init__(self, adapter: SplitAdapter, tc: SplitTrainConfig, opt: Optimizer, *,
                 device=None, mesh=None, shared_bank: bool = False):
        if not isinstance(adapter, LLMSplitAdapter) or adapter.cfg is None:
            raise ValueError(
                "llm-split needs an adapter built by "
                "repro_torch.core.distributed.llm_adapter(cfg, opts): it carries "
                "the transformer config the engine's step reads")
        if tc.mode not in ("detached", "e2e"):
            raise ValueError(f"unknown mode {tc.mode!r}")
        super().__init__(adapter, tc, opt, device)
        if mesh is not None:
            check_mesh(mesh, self.device, client_axis=None)
        self.mesh = mesh
        self.shared_bank = shared_bank
        # evaluate() scores one bank and repeats the row when it is shared
        self.identical_banks = shared_bank
        self.guard = PrivacyGuard(tc.privacy)
        # raises for e2e with a shared bank
        self.parts = llm_step_parts(adapter.cfg, adapter.opts, opt, tc.n_clients,
                                    grad_clip=tc.grad_clip, privacy=tc.privacy,
                                    shared_bank=shared_bank, mode=tc.mode, mesh=mesh)
        self.sharded = is_sharded(mesh)
        self.specs = None
        if self.sharded:
            self.specs = llm_state_specs(
                llm_state_template(adapter.cfg, tc.n_clients, opt, adapter.dtype, shared_bank,
                                   tc.mode), mesh, shared_bank=shared_bank, mode=tc.mode)
        self._unravel = None

    def _native_state(self, banks, server, opt_state, step, privacy):
        """The native state of a canonical one's parts; ``opt_state`` maps
        each moment to its tree (``None``: fresh moments)."""
        flat, self._unravel = ravel(trainable_of({"server": server, "client_banks": banks},
                                                 self.parts.detached))
        opt_flat = (self.opt.init(flat) if opt_state is None
                    else {k: ravel(v)[0] for k, v in opt_state.items()})
        return {"client_banks": banks if self.parts.detached else None, "flat": flat,
                "opt": opt_flat, "step": step, "privacy": privacy}

    def init(self, seed: int):
        self._start(seed)
        banks, server = init_llm_params(seeded_generator(seed), self.adapter.cfg, self.tc.n_clients,
                                        self.adapter.dtype, self.shared_bank, self.device)
        if self.sharded:  # keep this rank's blocks
            banks = shard_tree(banks, self.specs["client_banks"], self.mesh)
            server = shard_tree(server, self.specs["server"], self.mesh)
        return self._native_state(banks, server, None,
                                  torch.zeros((), dtype=torch.int32, device=self.device),
                                  budget_init(self.device))

    def run(self, state, shards, *, epochs, steps_per_epoch, eval_fn=None):
        if len(shards) != self.tc.n_clients:
            raise ValueError(f"{len(shards)} shards for n_clients={self.tc.n_clients}")
        data_x, data_y, lens = device_put_shards(shards, self.device)
        sample_shape = data_x.shape[2:]
        rows = torch.arange(self.tc.n_clients, device=self.device)[:, None]
        banks, flat, opt_state = state["client_banks"], state["flat"], state["opt"]
        history, self.step_metrics = [], []
        for ep in range(epochs):
            plan = self._next_plan(steps_per_epoch, lens, sample_shape)
            step, priv = state["step"], state["privacy"]
            ms = []
            for t in range(steps_per_epoch):
                batch = {"tokens": data_x[rows, plan.idx[t]],
                         "labels": data_y[rows, plan.idx[t]]}
                g, m = self.parts.grad(
                    flat, self._unravel, banks, batch,
                    None if plan.model_noise is None else plan.model_noise[t],
                    None if plan.guard_noise is None else plan.guard_noise[t])
                m["grad_norm"] = self.parts.apply(flat, opt_state, step, g)
                del g
                step = step + 1
                if self.guard.enabled:
                    priv = budget_advance(priv, self.tc.privacy)
                ms.append(m)
            state = {**state, "step": step, "privacy": priv}
            self.step_metrics.append(_readout({k: torch.stack([m[k] for m in ms])
                                               for k in ms[0]}))
            history.append(_record(ep, self.step_metrics[-1], eval_fn,
                                   None if eval_fn is None else self.to_canonical(state)))
        return state, history

    def to_canonical(self, state):
        tr = self._unravel(state["flat"])
        banks, server = ((state["client_banks"], tr) if self.parts.detached
                         else (tr["client_banks"], tr["server"]))
        canonical = {"client_banks": banks, "server": server,
                     "opt": {k: self._unravel(v) for k, v in state["opt"].items()},
                     "step": state["step"], "privacy": state["privacy"]}
        if self.sharded:
            canonical = whole_tree(canonical, self.specs, self.mesh)
        if self.shared_bank:
            n = self.tc.n_clients
            canonical["client_banks"] = tree_map(lambda a: a[None].expand((n,) + tuple(a.shape)),
                                                 canonical["client_banks"])
        return canonical

    def from_canonical(self, canonical):
        if self.shared_bank:
            canonical = {**canonical,
                         "client_banks": tree_map(lambda a: a[0], canonical["client_banks"])}
        if self.sharded:
            canonical = shard_tree(canonical, self.specs, self.mesh)
        return self._native_state(canonical["client_banks"], canonical["server"],
                                  canonical["opt"], canonical["step"], canonical["privacy"])


class SplitSession:
    """The unified engine surface.

    ``SplitSession(adapter, config, opt, engine="auto", mesh=None, seed=0,
    device=None, **engine_options)``: ``engine`` is a registry name (see
    ``available_engines()``) or a prebuilt engine; ``mesh`` a
    ``launch.mesh`` mesh on ``device``'s type (see the module docstring);
    ``device`` ``None`` is the card (it raises without one), and the tests
    pass ``"cpu"``; ``engine_options`` go to the engine factory
    (``threaded=``, ``production=``, ``queue_size=``, ... for the queue
    engines).
    """

    def __init__(self, adapter: SplitAdapter, config: SplitTrainConfig,
                 opt: Optimizer, engine: Any = "auto", *, mesh=None, seed: int = 0,
                 device=None, **engine_options):
        self.adapter, self.config, self.opt = adapter, config, opt
        self.device = resolve_device(device)
        if isinstance(engine, str):
            factory = _ENGINES.get(engine)
            if factory is None:
                raise ValueError(f"engine {engine!r} is unknown; available: "
                                 f"{available_engines()}")
            engine = factory(adapter, config, opt, device=self.device, mesh=mesh,
                             **engine_options)
        elif mesh is not None or engine_options:
            raise ValueError("mesh= and engine options apply only when engine is a registry "
                             "name; configure the prebuilt engine instance directly")
        self.engine = engine
        self.seed = seed
        self.guard = PrivacyGuard(config.privacy)
        self._native = self.engine.init(seed)
        self.history: List[Dict[str, float]] = []

    def fit(self, shards: Shards, *, epochs: int, steps_per_epoch: int,
            eval_fn: EvalFn = None,
            faults: Optional[FaultPlan] = None) -> List[Dict[str, float]]:
        """Train ``epochs x steps_per_epoch`` engine-native steps and return
        this call's history (also appended to ``self.history``): each
        epoch's mean of every metric; ``eval_fn``, given the canonical state
        after each epoch, adds ``val_`` keys. ``step_metrics`` holds the
        per-step values. ``faults``, a :class:`FaultPlan`, injects its
        failures into the drive (queue engines only) and fills
        ``fault_stats``."""
        if len(shards) != self.config.n_clients:
            raise ValueError(f"{len(shards)} shards for n_clients={self.config.n_clients}")
        if steps_per_epoch < 1:
            raise ValueError(f"steps_per_epoch must be >= 1, got {steps_per_epoch}")
        kwargs: Dict[str, Any] = {}
        if faults is not None:
            if not getattr(self.engine, "supports_faults", False):
                raise ValueError(
                    f"engine {self.engine.name!r} does not support faults=; "
                    "fault injection models the multi-site transport, which "
                    "only the queue engines (protocol-async, fused-queue) have"
                )
            kwargs["faults"] = faults
        self._native, history = self.engine.run(
            self._native, shards, epochs=epochs, steps_per_epoch=steps_per_epoch,
            eval_fn=eval_fn, **kwargs)
        self.history.extend(history)
        return history

    @property
    def step_metrics(self) -> List[Dict[str, np.ndarray]]:
        """The last fit's per-step metrics, one ``{metric: [T]}`` an epoch."""
        return self.engine.step_metrics

    @property
    def fault_stats(self) -> Dict[str, Any]:
        """The last fit's fault report (plan, halt state, per-client
        releases and budget, transport counters); ``{}`` for engines that
        take no ``faults=``."""
        return getattr(self.engine, "fault_stats", {})

    def _canonical(self):
        """The engine's canonical state, for reading at once: an engine that
        ``updates_in_place`` gives views that its next fit changes."""
        return self.engine.to_canonical(self._native)

    @property
    def state(self):
        """The canonical state tree (see module docstring): a copy where the
        engine updates its state in place, so a later fit leaves it as it
        was."""
        canonical = self._canonical()
        if getattr(self.engine, "updates_in_place", False):
            canonical = tree_map(lambda a: a.clone(memory_format=torch.contiguous_format),
                                 canonical)
        return canonical

    @property
    def native_state(self):
        """The engine's own state representation."""
        return self._native

    def evaluate(self, x, y, *, batch: int = 512) -> Dict[str, Any]:
        """Per-client evaluation (one pass per client bank, no noise) plus
        the share-weighted mean of every metric and the budget under
        ``"privacy"``. See ``trainer.evaluate_per_client``."""
        result = evaluate_per_client(
            self.adapter, self._canonical(), x, y, batch=batch,
            weights=client_weights(self.config).numpy(),
            identical_banks=getattr(self.engine, "identical_banks", False),
        )
        result["privacy"] = self.privacy_report()
        return result

    def serve(self, trace, shards: Shards, **server_options):
        """Serve an arrival trace through the split-inference path
        (``repro_torch.serving.SplitInferenceServer``, built from the
        canonical state with this session's guard, seed and device;
        ``server_options`` are its knobs). Every release spends budget like
        a training release: the accountant advances by the worst-case
        client's releases. Returns the ``ServeReport``."""
        from repro_torch.serving.server import SplitInferenceServer

        server = SplitInferenceServer(self.adapter, self.state, guard=self.guard,
                                      seed=self.seed, device=self.device,
                                      mesh=getattr(self.engine, "mesh", None), **server_options)
        report = server.serve(trace, shards)
        released = max(report.releases_per_client, default=0)
        if self.guard.enabled and released:
            canonical = self.state
            self._native = self.engine.from_canonical({
                **canonical,
                "privacy": budget_advance(canonical["privacy"], self.config.privacy, released),
            })
        return report

    def privacy_report(self, delta_prime: float = 1e-6) -> Dict[str, Any]:
        """The (ε, δ) budget spent so far (``privacy.accountant.budget_report``)."""
        return budget_report(self.config.privacy, self._canonical()["privacy"], delta_prime)

    def audit_privacy(self, x_sample, *, sigmas: Sequence[float] = (0.0, 0.1, 1.0),
                      steps: int = 120, seed: int = 0, client: int = 0,
                      noise_fn=None, x0=None) -> List[Dict[str, float]]:
        """Inversion-attack audit of client ``client``'s trained privacy
        layer (the CNN case studies and the cholesterol MLP alike): for each
        guard σ the attack reconstructs ``x_sample`` from the released
        features through the noise-free client forward and reports
        MSE/PSNR/NCC (``privacy.audit.guard_noise_sweep``, with the
        session's feature clip ``config.privacy.clip_norm`` where one is
        set). ``noise_fn`` and ``x0`` feed the sweep's randomness, as there."""
        bank = _client_banks_list(self._canonical()["client_banks"])[client]

        def fwd(z):
            return self.adapter.client_forward(bank, z, None)

        clip = self.config.privacy.clip_norm if self.config.privacy else None
        return guard_noise_sweep(
            fwd, torch.as_tensor(x_sample, device=self.device), sigmas=sigmas,
            clip_norm=clip, steps=steps, seed=seed, noise_fn=noise_fn, x0=x0,
        )

    def save(self, directory: str, metadata: Optional[dict] = None) -> str:
        """Checkpoint the canonical state (``checkpoint/io``), with the
        engine's epoch count so that ``restore`` continues the schedule.
        Under a mesh every rank has the whole canonical state (an engine
        that shards it gathers it): rank 0 writes it and the others wait
        for the write."""
        state = self._canonical()
        meta = {"engine": self.engine.name, "adapter": self.adapter.name,
                "n_clients": self.config.n_clients,
                "privacy_releases": int(state["privacy"]["releases"]),
                **(metadata or {})}
        epochs_done = getattr(self.engine, "_epochs_done", None)
        if epochs_done is not None:  # the queue engines' schedule runs on the step
            meta["epochs_done"] = epochs_done
        return save_checkpoint(directory, int(state["step"]), state, meta,
                               mesh=getattr(self.engine, "mesh", None))

    def restore(self, path: str) -> dict:
        """Load a canonical checkpoint (this session's state is the
        template: keys, shapes and dtypes) and adopt it, with the epoch
        count it was saved at; returns the manifest. A checkpoint of the JAX
        package loads the same way, and one saved under any mesh (or none)
        loads under this session's: every rank reads it whole, and the next
        fit places it."""
        state, manifest = load_checkpoint(path, self.device, like=self._canonical())
        self._native = self.engine.from_canonical(state)
        epochs_done = manifest.get("metadata", {}).get("epochs_done")
        if epochs_done is not None and hasattr(self.engine, "_epochs_done"):
            self.engine._epochs_done = int(epochs_done)
        return manifest
