"""Deterministic fault injection for the queue engines (multi-site failure),
copied from ``repro.core.faults``: host NumPy only, with the same stream
constants, so every schedule equals the reference's.

The paper's platform assumes many spatially distributed hospitals feeding one
central trunk, so the protocol must keep training when hospitals crash,
straggle, or hold wildly imbalanced data. This module is the fault model the
queue engines (``protocol-async``, ``fused-queue``) train through:

  * :class:`FaultPlan`: a seeded, fully deterministic failure schedule:
    per-client crash/rejoin windows (in SERVER-STEP units), straggler
    slowdowns, release drop/duplicate probabilities at the transport, data-
    imbalance share skews, and a ``halt_below`` quorum policy. Every
    decision is a pure function of ``(plan.seed, client, server step)``,
    and the server step is a canonical state leaf, so a ``save``/``restore``
    resumes the schedule where it left off.
  * :class:`FaultRun`: the per-``Engine.run`` view of a plan: the transport
    RNG streams (keyed on ``(seed, start step, client)``, so a resumed fit
    draws the stream a continued one would) and the fault counters of the
    session's ``fault_stats`` report.
  * :class:`ClientLoopError`: a client thread's exception surfaced to the
    caller instead of dying silently inside ``drive_protocol``.

Semantics the engines rely on (see ``protocol.drive_protocol``):

  * a DOWN client produces nothing: its sampling RNG, noise stream and
    ``releases`` counter hold still, and it spends no (ε, δ) budget;
  * a transport-DROPPED release already left the privacy layer, so it DOES
    spend budget; a duplicate is the same release delivered twice, charged
    once;
  * share reweighting is live: when a hospital is down, the surviving
    hospitals' round-robin quanta come from their renormalized (optionally
    skewed) shares;
  * ``halt_below``: when fewer clients are up at a drive cycle boundary the
    drive halts cleanly (``fault_stats["halted"]``); an all-down fleet over
    an empty queue always halts (the step-keyed schedule cannot advance).

``FaultPlan.none(n)`` takes the same fault-aware drive code and is bit-exact
with ``faults=None``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# domain-separation constants for the plan's derived RNG streams
_DROPOUT_STREAM = 9176
_TRANSPORT_STREAM = 7907


class ClientLoopError(RuntimeError):
    """A threaded client loop raised: re-raised to ``drive_protocol``'s
    caller (the original exception is ``__cause__``) instead of leaving a
    dead producer thread and a drive spinning on an empty queue. The engine
    records ``repr(cause)`` in ``fault_stats["client_error"]``."""

    def __init__(self, client_id: int, cause: BaseException):
        super().__init__(f"client {client_id} thread raised: {cause!r}")
        self.client_id = client_id
        self.cause = cause


class RemoteClientError(RuntimeError):
    """A client thread's exception as another rank of a mesh sees it: the
    threaded drive runs the client threads on the leader rank alone
    (``protocol.LeaderRelay``), which sends the exception's ``repr``; this
    stands for it in every other rank's ``ClientLoopError``, and its
    ``repr`` is the leader's, so ``fault_stats`` agree across the ranks."""

    def __init__(self, leader_repr: str):
        super().__init__(leader_repr)
        self.leader_repr = leader_repr

    def __repr__(self) -> str:
        return self.leader_repr


class RemoteLeaderError(RuntimeError):
    """An exception of the leader rank's main thread in the threaded drive
    under a mesh (``protocol.LeaderRelay``: a pop, the quorum check, the
    relay's own work), as every other rank sees it: the leader ends the
    drive on every rank and sends the exception's ``repr``, which this
    carries; the leader itself raises the original."""

    def __init__(self, leader_repr: str):
        super().__init__(f"the leader rank raised {leader_repr}")
        self.leader_repr = leader_repr


def _quanta_from_shares(shares: Sequence[float]) -> List[int]:
    """The round-robin drive's share->quanta formula (one source of truth:
    ``drive_protocol`` and the fault path must agree bit-for-bit)."""
    return np.maximum(1, np.round(np.asarray(shares) * 10).astype(int)).tolist()


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic multi-site failure schedule.

    Parameters
    ----------
    n_clients:      fleet size the plan is defined over (validated at run).
    seed:           base seed for every derived stream (dropout window
                    membership, transport drop/dup draws).
    crash_windows:  ``{client_id: [(crash_at, rejoin_at), ...]}`` — client
                    ``c`` is DOWN while ``crash_at <= server_step < rejoin_at``.
    dropout_frac:   fraction of the fleet down per dropout window (rounded
                    to a count); windows repeat every ``dropout_period``
                    server steps, each down for the first ``dropout_down``
                    steps of its window, membership drawn per window from
                    ``(seed, window_index)``.
    straggle:       ``{client_id: slowdown >= 1.0}`` — divides the client's
                    round-robin quantum (deterministic drive) and multiplies
                    its arrival sleep (threaded drive).
    drop_prob:      per-release probability the transport loses the item
                    AFTER it left the privacy layer (budget already spent).
    dup_prob:       per-release probability the transport delivers twice.
    share_skew:     per-client multipliers on ``data_shares`` (imbalance
                    drill) applied before quanta derivation.
    halt_below:     quorum — halt the drive cleanly when fewer clients are
                    up. 0 disables (but an all-down fleet over an empty
                    queue still halts: that stall is provably permanent).
    """

    n_clients: int
    seed: int = 0
    crash_windows: Mapping[int, Sequence[Tuple[int, int]]] = \
        dataclasses.field(default_factory=dict)
    dropout_frac: float = 0.0
    dropout_period: int = 20
    dropout_down: int = 10
    straggle: Mapping[int, float] = dataclasses.field(default_factory=dict)
    drop_prob: float = 0.0
    dup_prob: float = 0.0
    share_skew: Optional[Sequence[float]] = None
    halt_below: int = 0

    def __post_init__(self):
        if self.n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {self.n_clients}")
        if not 0.0 <= self.dropout_frac <= 1.0:
            raise ValueError(f"dropout_frac must be in [0, 1], got {self.dropout_frac}")
        if self.dropout_frac > 0.0 and not (
            0 < self.dropout_down <= self.dropout_period
        ):
            raise ValueError(
                "need 0 < dropout_down <= dropout_period, got "
                f"{self.dropout_down} / {self.dropout_period}"
            )
        if self.drop_prob + self.dup_prob > 1.0:
            raise ValueError("drop_prob + dup_prob must be <= 1")
        for c, slow in dict(self.straggle).items():
            if slow < 1.0:
                raise ValueError(f"straggle[{c}] must be >= 1.0, got {slow}")
        if self.share_skew is not None and len(self.share_skew) != self.n_clients:
            raise ValueError("share_skew length must equal n_clients")

    # ------------------------------------------------------------- builders
    @classmethod
    def none(cls, n_clients: int) -> "FaultPlan":
        """The explicit no-fault plan: runs through the fault-aware drive
        and is bit-exact with ``faults=None`` (the acceptance contract)."""
        return cls(n_clients=n_clients)

    @classmethod
    def dropout(cls, n_clients: int, frac: float, *, seed: int = 0,
                period: int = 20, down_for: int = 10, **kw) -> "FaultPlan":
        """Rotating dropout: every ``period`` server steps a fresh seeded
        subset of ``round(frac * n)`` clients is down for ``down_for``."""
        return cls(n_clients=n_clients, seed=seed, dropout_frac=frac,
                   dropout_period=period, dropout_down=down_for, **kw)

    @classmethod
    def straggler(cls, n_clients: int, slowdowns: Mapping[int, float], *,
                  seed: int = 0, **kw) -> "FaultPlan":
        return cls(n_clients=n_clients, seed=seed, straggle=dict(slowdowns), **kw)

    @classmethod
    def imbalance(cls, n_clients: int, skew: Sequence[float], *,
                  seed: int = 0, **kw) -> "FaultPlan":
        return cls(n_clients=n_clients, seed=seed, share_skew=tuple(skew), **kw)

    # --------------------------------------------------------- availability
    @property
    def has_transport_faults(self) -> bool:
        """True when releases consume transport RNG draws (drop/dup). The
        fleet cycle planner can't see transport losses, so the drive falls
        back to per-item production — like ``per_client_cap``."""
        return self.drop_prob > 0.0 or self.dup_prob > 0.0

    def _dropout_down_set(self, window: int) -> frozenset:
        k = int(round(self.dropout_frac * self.n_clients))
        if k == 0:
            return frozenset()
        rng = np.random.default_rng((self.seed, _DROPOUT_STREAM, window))
        return frozenset(rng.choice(self.n_clients, size=k, replace=False).tolist())

    def available(self, client_id: int, step: int) -> bool:
        """Is ``client_id`` up at server step ``step``? Pure function of the
        plan — replays identically and survives save/restore via the step."""
        for lo, hi in self.crash_windows.get(client_id, ()):
            if lo <= step < hi:
                return False
        if self.dropout_frac > 0.0 and step % self.dropout_period < self.dropout_down:
            if client_id in self._dropout_down_set(step // self.dropout_period):
                return False
        return True

    def up_mask(self, step: int) -> List[bool]:
        return [self.available(c, step) for c in range(self.n_clients)]

    def quorum_lost(self, step: int) -> bool:
        up = sum(self.up_mask(step))
        if up < self.halt_below:
            return True
        return up == 0  # all-down: the step-keyed schedule cannot advance

    # ----------------------------------------------------- rates and shares
    def effective_shares(self, shares: Sequence[float],
                         up: Sequence[bool]) -> List[float]:
        """Skewed shares renormalized over the UP clients — the live
        reweighting that keeps total arrival rate from collapsing with a
        crashed hospital's share."""
        s = np.asarray(shares, np.float64)
        if self.share_skew is not None:
            s = s * np.asarray(self.share_skew, np.float64)
        s = np.where(np.asarray(up, bool), s, 0.0)
        total = s.sum()
        if total <= 0.0:
            return [0.0] * len(s)
        return (s / total).tolist()

    def cycle_quanta(self, step: int, shares: Sequence[float],
                     ) -> Tuple[List[int], List[bool]]:
        """Per-client production quanta for the round-robin cycle starting
        at server step ``step``: 0 for down clients, otherwise
        ``max(1, round(reweighted_share * 10 / slowdown))``. With all
        clients up and no skew/straggle this is EXACTLY the no-fault
        formula on the untouched shares (the ``FaultPlan.none()``
        bit-exactness contract)."""
        up = self.up_mask(step)
        if all(up) and self.share_skew is None and not self.straggle:
            return _quanta_from_shares(shares), up
        eff = self.effective_shares(shares, up)
        quanta = []
        for c, (s, u) in enumerate(zip(eff, up)):
            if not u:
                quanta.append(0)
                continue
            q = max(1, int(round(s * 10)))
            slow = float(self.straggle.get(c, 1.0))
            if slow > 1.0:
                q = max(1, int(round(q / slow)))
            quanta.append(q)
        return quanta, up

    def straggler_sleep(self, client_id: int, base: float) -> float:
        """Threaded drive: the client's inter-arrival sleep scaled by its
        slowdown (a straggler's releases arrive late, not never)."""
        return base * float(self.straggle.get(client_id, 1.0))

    # -------------------------------------------------------------- reports
    def describe(self) -> Dict[str, object]:
        """JSON-able summary for ``fault_stats`` and checkpoint metadata."""
        return {
            "n_clients": self.n_clients,
            "seed": self.seed,
            "crash_windows": {int(c): [list(w) for w in ws]
                              for c, ws in self.crash_windows.items()},
            "dropout": {"frac": self.dropout_frac,
                        "period": self.dropout_period,
                        "down_for": self.dropout_down},
            "straggle": {int(c): float(s) for c, s in self.straggle.items()},
            "drop_prob": self.drop_prob,
            "dup_prob": self.dup_prob,
            "share_skew": (list(self.share_skew)
                           if self.share_skew is not None else None),
            "halt_below": self.halt_below,
        }

    def start_run(self, start_step: int) -> "FaultRun":
        """The per-``Engine.run`` view: transport streams keyed on
        ``(seed, start_step, client)`` — the start step is the canonical
        ``state["step"]`` at fit time, so a session restored mid-fault
        draws the same transport stream the continued session does."""
        return FaultRun(self, int(start_step))


class FaultRun:
    """Mutable per-run fault state: transport RNG streams + counters.

    One ``FaultRun`` spans one ``Engine.run`` (all its epochs share the
    client fleet, so they share the transport streams too — exactly like
    the clients' own sampling RNGs). The counters feed the engine's
    ``fault_stats`` report.
    """

    def __init__(self, plan: FaultPlan, start_step: int):
        self.plan = plan
        self.start_step = start_step
        n = plan.n_clients
        self._rngs = [
            np.random.default_rng((plan.seed, _TRANSPORT_STREAM, start_step, c))
            for c in range(n)
        ]
        self.transit_dropped = [0] * n
        self.duplicated = [0] * n
        self.down_cycles = [0] * n
        self.halted = False
        self.halt_reason: Optional[str] = None

    def transit(self, client_id: int) -> str:
        """Transport fate of one released item: ``'ok' | 'drop' | 'dup'``.
        Consumes one uniform draw per release IN PRODUCTION ORDER (and none
        at all when the plan has no transport faults, preserving the
        ``FaultPlan.none()`` bit-exactness)."""
        plan = self.plan
        if not plan.has_transport_faults:
            return "ok"
        u = float(self._rngs[client_id].random())
        if u < plan.drop_prob:
            self.transit_dropped[client_id] += 1
            return "drop"
        if u < plan.drop_prob + plan.dup_prob:
            self.duplicated[client_id] += 1
            return "dup"
        return "ok"

    def note_cycle(self, up: Sequence[bool]) -> None:
        for c, is_up in enumerate(up):
            if not is_up:
                self.down_cycles[c] += 1

    def halt(self, reason: str) -> None:
        self.halted = True
        self.halt_reason = reason

    def stats(self) -> Dict[str, object]:
        return {
            "plan": self.plan.describe(),
            "halted": self.halted,
            "halt_reason": self.halt_reason,
            "transit_dropped": list(self.transit_dropped),
            "duplicated": list(self.duplicated),
            "down_cycles": list(self.down_cycles),
        }
