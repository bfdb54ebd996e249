"""Statistically-matched synthetic stand-ins for the paper's gated datasets.

The paper's data is not available offline (SNUH cholesterol is IRB-gated; the
COVID-CT and MURA snapshots are external downloads), so per the repro band we
SIMULATE each dataset with generators that preserve:

  * the modality and tensor shape (64x64x1 CT, 224x224x1 X-ray, 7-feature
    tabular),
  * the class structure and balance (MURA per-part counts from paper Table 2),
  * a *learnable* signal of a comparable character, so relative claims
    (multi-client vs single-client vs FedAvg) remain testable.

CT: "infected" lungs carry ground-glass blobs inside lung ellipses.
MURA: fractured bones are bright bars with a dark discontinuity.
Cholesterol: LDL-C follows the Friedewald relation LDL = TC - HDL - TG/5 + eps
(the clinical formula the paper cites [25]), so the regression target is real.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

MURA_BODY_PARTS: Dict[str, Tuple[int, int, int]] = {
    # part: (total, positive, negative) — paper Table 2
    "finger": (5106, 1968, 3138),
    "hand": (5543, 1484, 4059),
    "wrist": (9752, 3987, 5765),
    "forearm": (1825, 661, 1164),
    "elbow": (4931, 2006, 2925),
    "humerus": (1272, 599, 673),
    "shoulder": (8379, 4168, 4211),
}


def _lung_mask(hw: int, rng) -> np.ndarray:
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    cx1, cx2 = 0.32 + 0.03 * rng.standard_normal(), 0.68 + 0.03 * rng.standard_normal()
    cy = 0.5 + 0.02 * rng.standard_normal()
    r1 = ((xx - cx1) / 0.18) ** 2 + ((yy - cy) / 0.33) ** 2
    r2 = ((xx - cx2) / 0.18) ** 2 + ((yy - cy) / 0.33) ** 2
    return ((r1 < 1) | (r2 < 1)).astype(np.float32)


def make_covid_ct(n: int, hw: int = 64, seed: int = 0):
    """Returns (x [n,hw,hw,1] float in [0,1], y [n] float {0,1})."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, hw, hw, 1), np.float32)
    y = rng.integers(0, 2, size=n).astype(np.float32)
    for i in range(n):
        mask = _lung_mask(hw, rng)
        img = 0.15 + 0.05 * rng.standard_normal((hw, hw)).astype(np.float32)
        img += 0.35 * mask  # air-filled lungs brighter (inverted CT style)
        if y[i] > 0.5:  # COVID: ground-glass opacities inside the lungs
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
    """X-ray-like bone images; positive = fracture (dark discontinuity)."""
    total, pos, neg = MURA_BODY_PARTS[part]
    p_pos = pos / total  # per-part class balance from paper Table 2
    rng = np.random.default_rng(seed + hash(part) % (1 << 16))
    x = np.zeros((n, hw, hw, 1), np.float32)
    y = (rng.random(n) < p_pos).astype(np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    for i in range(n):
        img = 0.1 + 0.03 * rng.standard_normal((hw, hw)).astype(np.float32)
        # a bright "bone" bar at a random angle
        theta = rng.uniform(-0.5, 0.5)
        cx = hw / 2 + rng.uniform(-hw * 0.1, hw * 0.1)
        d = np.abs((xx - cx) * np.cos(theta) - (yy - hw / 2) * np.sin(theta) * 0.0
                   + (xx - cx) * 0.0 - 0.0)  # distance to vertical-ish line
        d = np.abs((xx - cx) + np.tan(theta) * (yy - hw / 2))
        width = hw * rng.uniform(0.06, 0.1)
        bone = np.clip(1 - d / width, 0, 1)
        img += 0.6 * bone
        if y[i] > 0.5:  # fracture: dark crack crossing the bone
            fy = rng.uniform(0.3 * hw, 0.7 * hw)
            fw = hw * rng.uniform(0.008, 0.02)
            crack = np.exp(-((yy - fy) ** 2) / (2 * fw * fw))
            img -= 0.5 * crack * bone
        img += 0.03 * rng.standard_normal((hw, hw)).astype(np.float32)
        x[i, :, :, 0] = np.clip(img, 0, 1)
    return x, y


CHOL_FEATURES = ("age", "sex", "height", "weight", "TC", "HDL_C", "TG")


def make_cholesterol(n: int, seed: int = 0, normalize: bool = True):
    """Tabular cholesterol records; target LDL-C via the Friedewald formula
    (TC - HDL - TG/5) + patient-level noise — the relation the paper's model
    learns. Returns (x [n,7], y [n] raw LDL-C mg/dL)."""
    rng = np.random.default_rng(seed)
    age = rng.uniform(20, 90, n)
    sex = rng.integers(0, 2, n).astype(np.float64)
    height = np.where(sex > 0.5, rng.normal(172, 6, n), rng.normal(158, 6, n))
    weight = np.clip(rng.normal(22.5, 3.0, n) * (height / 100) ** 2, 35, 140)
    tc = np.clip(rng.normal(185, 35, n) + 0.15 * (age - 50), 90, 320)
    hdl = np.clip(rng.normal(52, 12, n) - 2.0 * sex, 20, 100)
    tg = np.clip(rng.lognormal(np.log(110), 0.45, n), 30, 400)
    ldl = np.clip(tc - hdl - tg / 5.0 + rng.normal(0, 8, n), 10, 250)
    x = np.stack([age, sex, height, weight, tc, hdl, tg], axis=1).astype(np.float32)
    if normalize:
        mu = x.mean(0, keepdims=True)
        sd = x.std(0, keepdims=True) + 1e-6
        x = (x - mu) / sd
    return x, ldl.astype(np.float32)
