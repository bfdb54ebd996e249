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
modes run one loop of steps) and ``looped-ref`` (the seed's per-client
loop). The reference's other engines (``protocol-async``, ``fused-queue``,
``fedavg``, ``llm-split``), ``mesh=``, ``faults=`` and ``audit_privacy``
are not ported yet and raise a ``ValueError`` that says what is available.

Randomness. The JAX engines fold an epoch key out of ``PRNGKey(seed)``;
here every draw comes from a CPU ``torch.Generator`` seeded with the first
64-bit word of ``numpy.random.SeedSequence(entropy)``: ``(seed,)`` for the
initial weights, ``(seed, e)`` for the plan of the session's e-th epoch
(e = 1, 2, ...; ``make_sample_plan``). The draws move to the session's
device, so one seed gives the same weights, batches and noise on the card
and on the CPU (the runs then part by float32 rounding, which AdamW
amplifies), and ``restore`` resumes the epoch count, so the schedule
continues instead of replaying.

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
from repro_torch.common.device import resolve_device
from repro_torch.core.adapters import SplitAdapter
from repro_torch.core.trainer import (
    SamplePlan,
    SplitTrainConfig,
    client_weights,
    device_put_shards,
    evaluate_per_client,
    make_epoch_runner,
    make_looped_step,
    make_sample_plan,
    make_spatio_temporal_step,
    stack_pytrees,
    unstack_pytree,
)
from repro_torch.optim.optimizers import Optimizer
from repro_torch.privacy.accountant import budget_advance, budget_report
from repro_torch.privacy.guard import PrivacyGuard

Shards = Sequence[Tuple[np.ndarray, np.ndarray]]
EvalFn = Optional[Callable[[Any], Dict[str, float]]]

# the reference's engines that the port does not have yet
NOT_PORTED = ("protocol-async", "fused-queue", "fedavg", "llm-split")

_ENGINES: Dict[str, Callable[..., Any]] = {}


def register_engine(name: str):
    def deco(factory):
        _ENGINES[name] = factory
        return factory
    return deco


def available_engines() -> List[str]:
    return sorted(_ENGINES)


def seeded_generator(*entropy: int) -> torch.Generator:
    """A CPU generator seeded from ``SeedSequence(entropy)``'s first word."""
    seq = np.random.SeedSequence(entropy)
    return torch.Generator().manual_seed(int(seq.generate_state(1, np.uint64)[0]))


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


class FusedEngine(_Engine):
    """The fused engine: stacked banks, one flat trainable buffer, epochs of
    ``make_epoch_runner`` steps. Native state IS the canonical state."""

    def __init__(self, adapter, tc, opt, *, device=None, mode: Optional[str] = None):
        if mode not in (None, "scan", "stepwise"):
            raise ValueError(f"mode must be None, 'scan' or 'stepwise', got {mode!r}")
        super().__init__(adapter, tc, opt, device)
        self.name = "auto" if mode is None else f"fused-{mode}"
        self.mode = mode or "scan"
        self._init_state, _ = make_spatio_temporal_step(adapter, tc, opt, self.device)
        self._runners: Dict[int, Callable] = {}

    def init(self, seed: int):
        return self._init_state(self._start(seed))

    def run(self, state, shards, *, epochs, steps_per_epoch, eval_fn=None):
        run_epoch = self._runners.get(steps_per_epoch)
        if run_epoch is None:
            _, run_epoch = make_epoch_runner(self.adapter, self.tc, self.opt, steps_per_epoch,
                                             mode=self.mode, device=self.device)
            self._runners[steps_per_epoch] = run_epoch
        data_x, data_y, lens = device_put_shards(shards, self.device)
        history, self.step_metrics = [], []
        for ep in range(epochs):
            plan = self._next_plan(steps_per_epoch, lens, data_x.shape[2:])
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

    def __init__(self, adapter, tc, opt, *, device=None):
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


class SplitSession:
    """The unified engine surface.

    ``SplitSession(adapter, config, opt, engine="auto", seed=0,
    device=None)``: ``engine`` is a registry name (see
    ``available_engines()``) or a prebuilt engine; ``device`` ``None`` is
    the card (it raises without one), and the tests pass ``"cpu"``.
    """

    def __init__(self, adapter: SplitAdapter, config: SplitTrainConfig,
                 opt: Optimizer, engine: Any = "auto", *, mesh=None, seed: int = 0,
                 device=None):
        if mesh is not None:
            raise ValueError("mesh= is not ported yet: the port trains on one device "
                             f"(device=...) with the engines {available_engines()}")
        self.adapter, self.config, self.opt = adapter, config, opt
        self.device = resolve_device(device)
        if isinstance(engine, str):
            factory = _ENGINES.get(engine)
            if factory is None:
                why = "is not ported yet" if engine in NOT_PORTED else "is unknown"
                raise ValueError(f"engine {engine!r} {why}; available: {available_engines()}")
            engine = factory(adapter, config, opt, device=self.device)
        self.engine = engine
        self.seed = seed
        self.guard = PrivacyGuard(config.privacy)
        self._native = self.engine.init(seed)
        self.history: List[Dict[str, float]] = []

    def fit(self, shards: Shards, *, epochs: int, steps_per_epoch: int,
            eval_fn: EvalFn = None, faults=None) -> List[Dict[str, float]]:
        """Train ``epochs x steps_per_epoch`` steps and return this call's
        history (also appended to ``self.history``): each epoch's mean of
        every metric; ``eval_fn``, given the canonical state after each
        epoch, adds ``val_`` keys. ``step_metrics`` holds the per-step
        values."""
        if faults is not None:
            raise ValueError("faults= is not ported yet (core/faults.py); the port's "
                             f"engines {available_engines()} train without fault injection")
        if len(shards) != self.config.n_clients:
            raise ValueError(f"{len(shards)} shards for n_clients={self.config.n_clients}")
        if steps_per_epoch < 1:
            raise ValueError(f"steps_per_epoch must be >= 1, got {steps_per_epoch}")
        self._native, history = self.engine.run(
            self._native, shards, epochs=epochs, steps_per_epoch=steps_per_epoch,
            eval_fn=eval_fn)
        self.history.extend(history)
        return history

    @property
    def step_metrics(self) -> List[Dict[str, np.ndarray]]:
        """The last fit's per-step metrics, one ``{metric: [T]}`` an epoch."""
        return self.engine.step_metrics

    @property
    def state(self):
        """The canonical state tree (see module docstring)."""
        return self.engine.to_canonical(self._native)

    @property
    def native_state(self):
        """The engine's own state representation."""
        return self._native

    def evaluate(self, x, y, *, batch: int = 512) -> Dict[str, Any]:
        """Per-client evaluation (one pass per client bank, no noise) plus
        the share-weighted mean of every metric and the budget under
        ``"privacy"``. See ``trainer.evaluate_per_client``."""
        result = evaluate_per_client(
            self.adapter, self.state, x, y, batch=batch,
            weights=client_weights(self.config).numpy(),
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
                                      seed=self.seed, device=self.device, **server_options)
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
        return budget_report(self.config.privacy, self.state["privacy"], delta_prime)

    def audit_privacy(self, *args, **kwargs):
        raise ValueError("audit_privacy is not ported yet (privacy/audit.py); the port's "
                         "session has fit, evaluate, privacy_report, save, restore and serve")

    def save(self, directory: str, metadata: Optional[dict] = None) -> str:
        """Checkpoint the canonical state (``checkpoint/io``), with the
        engine's epoch count so that ``restore`` continues the schedule."""
        state = self.state
        meta = {"engine": self.engine.name, "adapter": self.adapter.name,
                "n_clients": self.config.n_clients,
                "privacy_releases": int(state["privacy"]["releases"]),
                "epochs_done": self.engine._epochs_done, **(metadata or {})}
        return save_checkpoint(directory, int(state["step"]), state, meta)

    def restore(self, path: str) -> dict:
        """Load a canonical checkpoint (this session's state is the
        template: keys, shapes and dtypes) and adopt it, with the epoch
        count it was saved at; returns the manifest. A checkpoint of the JAX
        package loads the same way."""
        state, manifest = load_checkpoint(path, self.device, like=self.state)
        self._native = self.engine.from_canonical(state)
        epochs_done = manifest.get("metadata", {}).get("epochs_done")
        if epochs_done is not None:
            self.engine._epochs_done = int(epochs_done)
        return manifest
