"""The two pieces of ``repro.core.protocol`` that serving needs: the
client-side guarded release and the consumer's pop with backoff."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.adapters import SplitAdapter
from repro_torch.core.queue import FeatureQueue
from repro_torch.privacy.guard import PrivacyGuard


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


def _pop_with_backoff(queue: FeatureQueue, timeout: float, retries: int,
                      backoff: float):
    """Pop with exponential backoff: wait ``timeout``, then ``timeout *
    backoff``, ``timeout * backoff**2``, … for up to ``retries`` re-pops,
    counting ``timeouts``/``retries`` in the queue's stats."""
    item = queue.pop(timeout=timeout)
    wait = timeout
    for _ in range(int(retries)):
        if item is not None:
            return item
        wait *= backoff
        queue.note_retry()
        item = queue.pop(timeout=wait)
    return item
