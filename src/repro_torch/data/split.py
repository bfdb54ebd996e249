"""Client data partitioning — the paper's 10% val / 10% test / 7:2:1 protocol."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def train_val_test_split(x, y, val_frac=0.1, test_frac=0.1, seed=0):
    n = len(x)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val, n_test = int(n * val_frac), int(n * test_frac)
    vi, ti, tri = perm[:n_val], perm[n_val : n_val + n_test], perm[n_val + n_test :]
    return (x[tri], y[tri]), (x[vi], y[vi]), (x[ti], y[ti])


def split_clients(
    x, y, shares: Sequence[float] = (0.7, 0.2, 0.1), seed: int = 0,
    label_skew: float = 0.0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Partition a training set into imbalanced client shards (paper §IV-C1).

    ``label_skew`` in [0, 1] makes shards non-IID (beyond-paper): 0 = random
    partition (the paper's setting); 1 = clients receive maximally
    label-sorted slices (each hospital sees a different case mix).
    """
    n = len(x)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    if label_skew > 0.0:
        # label-sorted head (assigned contiguously => skewed case mixes),
        # shuffled tail keeps a fraction of IID mixing
        order = np.argsort(np.asarray(y)[perm], kind="stable")
        n_sorted = int(n * label_skew)
        head = perm[order[:n_sorted]]
        tail = rng.permutation(perm[order[n_sorted:]])
        perm = np.concatenate([head, tail])
    shards = []
    start = 0
    for i, s in enumerate(shares):
        size = n - start if i == len(shares) - 1 else int(round(n * s))
        idx = perm[start : start + size]
        shards.append((x[idx], y[idx]))
        start += size
    return shards
