"""The centralized server's feature queue (paper Fig. 1, §III-B), copied
from ``repro.core.queue.FeatureQueue``.

Clients push feature maps; the server pops without ever blocking an
incoming client. Per-client caps implement the paper's imbalance handling,
and ``stats()`` is the audit trail of pushes, pops and rejections.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional, Tuple


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
