"""The centralized server's feature queue (paper Fig. 1, §III-B), as
``repro.core.queue``.

Clients push feature maps; the server pops without ever blocking an
incoming client. Per-client caps implement the paper's imbalance handling,
and ``stats()`` is the audit trail of pushes, pops and rejections.

The transport of both queue engines: ``protocol-async`` pops one item a
trunk update; ``fused-queue`` accepts arrivals into a :class:`FeatureBank`
(padded slots and a validity mask) that one bank replay consumes
(``repro_torch.core.trainer.make_server_bank_runner``). Fleet production
(``protocol.FleetProducer``) pushes :class:`FeatureSlice` items, row views
of one release tensor a production cycle. Nothing here is canonical state.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class FeatureSlice:
    """Row ``index`` of a batched release ``parent`` (``[N, b, ...]``), kept
    as a reference: :meth:`tensor` is a view of the row (no copy), and
    :meth:`FeatureBank.stacked` gathers each run of slices of one parent with
    one ``index_select``. A gather only moves data, so both give the bits of
    the row."""

    __slots__ = ("parent", "index")

    def __init__(self, parent: torch.Tensor, index: int):
        self.parent = parent
        self.index = int(index)

    def tensor(self) -> torch.Tensor:
        return self.parent[self.index]

    @property
    def shape(self):
        return tuple(self.parent.shape[1:])


def as_tensor(features, device) -> torch.Tensor:
    """A queue item's features as a tensor on ``device``: a
    :class:`FeatureSlice`'s row, a host array copied over, a tensor moved."""
    if isinstance(features, FeatureSlice):
        features = features.tensor()
    return torch.as_tensor(features, device=device)


class FeatureQueue:
    def __init__(self, max_size: int = 1024, per_client_cap: Optional[int] = None):
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._max_size = max_size
        self._per_client_cap = per_client_cap
        self._per_client_counts: Dict[Any, int] = collections.defaultdict(int)
        self.pushed = 0
        self.popped = 0
        self.rejected = 0
        self.timeouts = 0
        self.retries = 0

    @property
    def max_size(self) -> int:
        return self._max_size

    @property
    def per_client_cap(self) -> Optional[int]:
        return self._per_client_cap

    def push(self, client_id, features, labels) -> bool:
        """Non-blocking push. Returns False if the queue (or client cap) is full."""
        with self._lock:
            if len(self._q) >= self._max_size:
                self.rejected += 1
                return False
            if (
                self._per_client_cap is not None
                and self._per_client_counts[client_id] >= self._per_client_cap
            ):
                self.rejected += 1
                return False
            self._q.append((client_id, features, labels))
            self._per_client_counts[client_id] += 1
            self.pushed += 1
            self._not_empty.notify()
            return True

    def pop(self, timeout: Optional[float] = None):
        """Pop one item, waiting up to ``timeout`` seconds for an arrival.
        An empty-handed return counts as a ``timeout`` in :meth:`stats`."""
        with self._not_empty:
            if not self._q and timeout is not None:
                self._not_empty.wait(timeout)
            if not self._q:
                self.timeouts += 1
                return None
            client_id, f, l = self._q.popleft()
            self._per_client_counts[client_id] -= 1
            self.popped += 1
            return client_id, f, l

    def note_retry(self) -> None:
        """Record one consumer retry (a backed-off re-pop after a timeout)."""
        with self._lock:
            self.retries += 1

    def pop_many(self, n: int) -> List[Tuple[Any, Any, Any]]:
        out = []
        with self._lock:
            while self._q and len(out) < n:
                item = self._q.popleft()
                self._per_client_counts[item[0]] -= 1
                self.popped += 1
                out.append(item)
        return out

    def __len__(self):
        with self._lock:
            return len(self._q)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"pushed": self.pushed, "popped": self.popped,
                    "rejected": self.rejected, "timeouts": self.timeouts,
                    "retries": self.retries}


class FeatureBank:
    """Fixed-capacity accumulator of popped queue items, in the queue's
    release order: the bridge between the queue's arrival order and the
    fused-queue engine's bank replay. :meth:`stacked` gives ``[K, b, ...]``
    feature and label slots and a ``[K]`` validity mask; unfilled slots are
    zero and invalid, and the replay makes them identity updates, so a
    partial bank trains on exactly the items that arrived."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._features: List[Any] = []
        self._labels: List[Any] = []

    def __len__(self) -> int:
        return len(self._features)

    @property
    def full(self) -> bool:
        return len(self._features) >= self.capacity

    def accept(self, client_id, features, labels) -> None:
        """Bank one popped queue item (``client_id`` matches the queue-item
        layout; provenance stays with the queue's own counters)."""
        if self.full:
            raise RuntimeError("FeatureBank over capacity")
        self._features.append(features)
        self._labels.append(labels)

    def stacked(self, device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (features [K, b, ...], labels [K, b, ...], valid [K] bool), on
        the features' device (``device`` where they are host arrays): K is
        ``capacity``, slots past ``len(self)`` zero and invalid. Each run of
        :class:`FeatureSlice` items of one parent is one ``index_select``."""
        if not self._features:
            raise ValueError("stacking an empty FeatureBank")
        n, k = len(self), self.capacity
        feats = _stack_features(self._features, device)
        labels = torch.as_tensor(np.stack([np.asarray(l) for l in self._labels]),
                                 device=feats.device)
        if n < k:
            feats = torch.cat([feats, feats.new_zeros((k - n,) + tuple(feats.shape[1:]))])
            labels = torch.cat([labels, labels.new_zeros((k - n,) + tuple(labels.shape[1:]))])
        valid = torch.arange(k, device=feats.device) < n
        return feats, labels, valid


def _stack_features(items: List[Any], device=None) -> torch.Tensor:
    """Stack banked feature items into ``[K, b, ...]``, gathering each run
    of same-parent :class:`FeatureSlice` items with one ``index_select``."""
    chunks, i, n = [], 0, len(items)
    while i < n:
        f = items[i]
        if isinstance(f, FeatureSlice):
            j, idxs = i, []
            while (j < n and isinstance(items[j], FeatureSlice)
                   and items[j].parent is f.parent):
                idxs.append(items[j].index)
                j += 1
            chunks.append(f.parent.index_select(
                0, torch.tensor(idxs, dtype=torch.long, device=f.parent.device)))
            i = j
        else:
            chunks.append(as_tensor(f, device)[None])
            i += 1
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
