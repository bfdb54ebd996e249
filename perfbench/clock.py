"""Seconds of each phase of a set-up, by the host's clock, each phase ended
by a wait for the device, so that its work counts in the phase that
launched it."""
from __future__ import annotations

import contextlib
import time

import torch


class Phases(dict):
    """``{phase: seconds}``; ``with phases("name"): ...`` times one."""

    def __init__(self, device):
        super().__init__()
        self.cuda = torch.device(device).type == "cuda"

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.cuda:
            torch.cuda.synchronize()
        self[name] = self.get(name, 0.0) + time.perf_counter() - t0
