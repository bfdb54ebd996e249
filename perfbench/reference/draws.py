"""The program's random draws, worked out again from the seed, so that the
reference sees the same rows and noise as the timed path without taking
anything the program made.

- Serving (``SplitInferenceServer``): client c's rows of every request come
  from ``numpy.random.default_rng((trace_seed, 977, c))``, ``request_batch``
  integers in ``[0, len(shard_c))`` a request, in admission order; its
  noise from a generator on the serving device seeded with the first word
  of ``SeedSequence((seed, step, c))``, model noise then guard noise a
  release, each of the released features' shape. Every ``serve`` call
  seeds them afresh.
- Training (``make_sample_plan``): the session's e-th plan (e = 1, 2, ...)
  comes from a CPU generator seeded with the first word of
  ``SeedSequence((seed, e))``: each hospital's ``[steps, b]`` indices, then
  the model noise, then the guard noise, each ``[steps, C, b, ...]``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

SAMPLE_RNG_TAG = 977


def first_word(*entropy: int) -> int:
    seq = np.random.SeedSequence(tuple(int(e) for e in entropy))
    return int(seq.generate_state(1, np.uint64)[0])


def serve_rows(trace_seed: int, client: int, n_rows: int, request_batch: int,
               upto: int) -> List[np.ndarray]:
    """Client ``client``'s row indices for its first ``upto`` requests of a
    trace."""
    rng = np.random.default_rng((trace_seed, SAMPLE_RNG_TAG, client))
    return [rng.integers(0, n_rows, size=request_batch) for _ in range(upto)]


def serve_noise(seed: int, step: int, client: int, shape: Sequence[int], releases: Sequence[int],
                device, guard: bool = True) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """``{release: (model_noise, guard_noise)}`` of client ``client``'s
    releases numbered ``releases`` (1, 2, ...) in one serve call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(first_word(seed, step, client))
    want = set(releases)
    out = {}
    buf = torch.empty(tuple(shape), device=device)
    for r in range(1, max(want) + 1):
        if r in want:
            m = torch.randn(tuple(shape), generator=gen, device=device)
            g = torch.randn(tuple(shape), generator=gen, device=device) if guard else None
            out[r] = (m, g)
        else:
            buf.normal_(generator=gen)
            if guard:
                buf.normal_(generator=gen)
    return out


def train_plan(seed: int, epoch: int, lens: Sequence[int], steps: int, batch: int,
               feat_shape: Sequence[int], model_noise: bool, guard_noise: bool):
    """The plan of the session's ``epoch``-th epoch: ``(idx [steps, C, b],
    model_noise, guard_noise)``, each noise ``[steps, C, b, *feat_shape]``
    or None, on the CPU."""
    gen = torch.Generator().manual_seed(first_word(seed, epoch))
    idx = torch.stack([torch.randint(0, int(n), (steps, batch), generator=gen)
                       for n in lens], dim=1)
    feat = (steps, len(lens), batch) + tuple(feat_shape)
    model = torch.randn(feat, generator=gen) if model_noise else None
    guard = torch.randn(feat, generator=gen) if guard_noise else None
    return idx, model, guard
