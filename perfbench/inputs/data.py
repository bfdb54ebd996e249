"""Frozen copies of the port's synthetic data, client split and arrival
counts, so that the benchmark's inputs stay the same whatever the program
later does to its own generators.

Copied from ``repro_torch.data.synthetic`` (``make_covid_ct``,
``make_mura``), ``repro_torch.data.split`` (``split_clients``) and
``repro_torch.serving.traces`` (``poisson_trace``'s counts). One change:
``make_mura`` seeded its generator with ``seed + hash(part) % 2**16``, and
Python salts ``hash`` of a string per process, so two processes drew
different images from one seed. The copy adds a fixed integer per body part
(``PART_SALT``) instead.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# part: (total, positive, negative), the MURA paper's per-part counts
MURA_BODY_PARTS: Dict[str, Tuple[int, int, int]] = {
    "finger": (5106, 1968, 3138),
    "hand": (5543, 1484, 4059),
    "wrist": (9752, 3987, 5765),
    "forearm": (1825, 661, 1164),
    "elbow": (4931, 2006, 2925),
    "humerus": (1272, 599, 673),
    "shoulder": (8379, 4168, 4211),
}
# the fixed stand-in for hash(part) % 2**16: the part's place in the table
PART_SALT = {part: i for i, part in enumerate(MURA_BODY_PARTS)}
# the fold tag of poisson_trace's stream
POISSON_TAG = 101


def _lung_mask(hw: int, rng) -> np.ndarray:
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    cx1, cx2 = 0.32 + 0.03 * rng.standard_normal(), 0.68 + 0.03 * rng.standard_normal()
    cy = 0.5 + 0.02 * rng.standard_normal()
    r1 = ((xx - cx1) / 0.18) ** 2 + ((yy - cy) / 0.33) ** 2
    r2 = ((xx - cx2) / 0.18) ** 2 + ((yy - cy) / 0.33) ** 2
    return ((r1 < 1) | (r2 < 1)).astype(np.float32)


def make_covid_ct(n: int, hw: int = 64, seed: int = 0):
    """CT-like slices: (x [n, hw, hw, 1] float32 in [0, 1], y [n] float32
    {0, 1}); positives carry ground-glass blobs inside the lungs."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, hw, hw, 1), np.float32)
    y = rng.integers(0, 2, size=n).astype(np.float32)
    for i in range(n):
        mask = _lung_mask(hw, rng)
        img = 0.15 + 0.05 * rng.standard_normal((hw, hw)).astype(np.float32)
        img += 0.35 * mask
        if y[i] > 0.5:
            n_blobs = rng.integers(2, 6)
            yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
            for _ in range(n_blobs):
                cy, cx = rng.uniform(0.25 * hw, 0.75 * hw, size=2)
                s = rng.uniform(hw * 0.04, hw * 0.12)
                blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)))
                img += 0.35 * blob * mask
        img += 0.04 * rng.standard_normal((hw, hw)).astype(np.float32)
        x[i, :, :, 0] = np.clip(img, 0, 1)
    return x, y


def make_mura(n: int, hw: int = 224, seed: int = 0, part: str = "wrist"):
    """Radiograph-like images: (x [n, hw, hw, 1] float32 in [0, 1], y [n]);
    positive = a dark crack across a bright bone bar, at the part's class
    balance."""
    total, pos, _ = MURA_BODY_PARTS[part]
    rng = np.random.default_rng(seed + PART_SALT[part])
    x = np.zeros((n, hw, hw, 1), np.float32)
    y = (rng.random(n) < pos / total).astype(np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    for i in range(n):
        img = 0.1 + 0.03 * rng.standard_normal((hw, hw)).astype(np.float32)
        theta = rng.uniform(-0.5, 0.5)
        cx = hw / 2 + rng.uniform(-hw * 0.1, hw * 0.1)
        d = np.abs((xx - cx) + np.tan(theta) * (yy - hw / 2))
        width = hw * rng.uniform(0.06, 0.1)
        bone = np.clip(1 - d / width, 0, 1)
        img += 0.6 * bone
        if y[i] > 0.5:
            fy = rng.uniform(0.3 * hw, 0.7 * hw)
            fw = hw * rng.uniform(0.008, 0.02)
            crack = np.exp(-((yy - fy) ** 2) / (2 * fw * fw))
            img -= 0.5 * crack * bone
        img += 0.03 * rng.standard_normal((hw, hw)).astype(np.float32)
        x[i, :, :, 0] = np.clip(img, 0, 1)
    return x, y


def split_clients(x, y, shares: Sequence[float] = (0.7, 0.2, 0.1),
                  seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """A random partition into imbalanced client shards (the paper's 7:2:1),
    the last shard taking the remainder."""
    n = len(x)
    perm = np.random.default_rng(seed).permutation(n)
    shards, start = [], 0
    for i, s in enumerate(shares):
        size = n - start if i == len(shares) - 1 else int(round(n * s))
        idx = perm[start:start + size]
        shards.append((x[idx], y[idx]))
        start += size
    return shards


def poisson_counts(n_clients: int, rate: float, horizon: int, seed: int,
                   shares: Sequence[float]) -> np.ndarray:
    """``counts[t, c] ~ Poisson(rate * share[c])``: arrivals of client c at
    cycle t, ``rate`` the fleet's mean a cycle, as ``poisson_trace``."""
    w = np.asarray(shares, np.float64)
    w = w / w.sum()
    rng = np.random.default_rng((int(seed), POISSON_TAG))
    return rng.poisson((rate * w)[None, :], size=(horizon, n_clients))


def requests_from_counts(counts: np.ndarray) -> List[Tuple[int, int, int]]:
    """``(req_id, client, arrival)`` in (cycle, client, draw) order, the
    trace's id order."""
    out, rid = [], 0
    for t in range(counts.shape[0]):
        for c in range(counts.shape[1]):
            for _ in range(int(counts[t, c])):
                out.append((rid, c, t))
                rid += 1
    return out


def make_images(kind: str, n: int, seed: int, hw: int):
    """The configuration's images: ``kind`` "covid_ct" or "mura", ``hw``
    pixels a side."""
    if kind == "covid_ct":
        return make_covid_ct(n, hw=hw, seed=seed)
    if kind == "mura":
        return make_mura(n, hw=hw, seed=seed)
    raise ValueError(f"unknown image kind {kind!r}")
