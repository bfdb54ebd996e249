"""Synthetic language-model token pipeline (for the ~100M end-to-end driver),
copied from ``repro.data.lm``: seeded NumPy, so streams, windows and
batches are byte for byte the reference's.

A k-order Markov stream over a Zipf vocabulary gives the model real structure
to learn (loss decreases measurably within a few hundred steps) without any
external corpus.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def token_stream(vocab_size: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Zipf unigram distribution
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    base = rng.choice(vocab_size, size=n_tokens, p=probs)
    # inject bigram structure: with prob 0.5, next token = f(prev)
    shift = rng.integers(1, max(vocab_size // 3, 2))
    follow = rng.random(n_tokens) < 0.5
    out = base.copy()
    out[1:] = np.where(follow[1:], (out[:-1] * 31 + shift) % vocab_size, base[1:])
    return out.astype(np.int32)


def token_windows(
    stream: np.ndarray, n_windows: int, seq_len: int, seed: int = 0
) -> np.ndarray:
    """A fixed ``[n_windows, seq_len]`` int32 window set sampled from the
    stream — the per-client shard format the ``llm-split`` engine consumes
    (``shards = [(w, w), ...]``; labels == tokens, the shift happens in the
    loss). Deterministic per (stream, seed): each hospital draws its own
    windows from its own stream without coordinating with the others."""
    rng = np.random.default_rng(seed)
    max_start = len(stream) - seq_len - 1
    if max_start <= 0:
        raise ValueError(f"stream of {len(stream)} tokens is too short for "
                         f"seq_len={seq_len}")
    starts = rng.integers(0, max_start, size=n_windows)
    return np.stack([stream[s : s + seq_len] for s in starts]).astype(np.int32)


def lm_batches(
    stream: np.ndarray, batch: int, seq_len: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    max_start = len(stream) - seq_len - 1
    while True:
        starts = rng.integers(0, max_start, size=batch)
        toks = np.stack([stream[s : s + seq_len] for s in starts])
        yield {"tokens": toks, "labels": toks}
