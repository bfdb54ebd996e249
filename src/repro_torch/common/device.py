"""Device selection and seeded generators for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card (``"cuda"``). A CUDA device with no card
    present raises: the port never moves to the CPU on its own; a caller
    that wants the CPU (the tests) asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def seeded_generator(*entropy: int) -> torch.Generator:
    """A CPU generator seeded from ``SeedSequence(entropy)``'s first word,
    so one seed gives the same draws whatever device they move to."""
    seq = np.random.SeedSequence(tuple(int(e) for e in entropy))
    return torch.Generator().manual_seed(int(seq.generate_state(1, np.uint64)[0]))
