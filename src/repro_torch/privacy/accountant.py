"""(ε, δ) budget accounting, as ``repro.privacy.accountant``.

The budget is two scalar tensors that ride in the canonical state::

    {"releases": int32 (), "epsilon_basic": float32 ()}

``releases`` counts guard applications per client (the worst-case client);
``epsilon_basic`` accumulates the linear-composition spend in float32, with
the same roundings as the JAX package. The advanced-composition bound
(Dwork & Roth Thm 3.20) is derived from the count at report time.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.privacy.guard import DPConfig

Budget = Dict[str, torch.Tensor]


def budget_init(device=None) -> Budget:
    """Zero budget on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    return {
        "releases": torch.zeros((), dtype=torch.int32, device=device),
        "epsilon_basic": torch.zeros((), dtype=torch.float32, device=device),
    }


def budget_advance(budget: Budget, dp: Optional[DPConfig], releases: int = 1) -> Budget:
    """Account ``releases`` more guard applications. Identity when the guard
    is disabled (``dp is None``)."""
    if dp is None:
        return budget
    eps = torch.tensor(dp.release_epsilon, dtype=torch.float32)
    n = torch.tensor(releases, dtype=torch.float32)
    return {
        "releases": budget["releases"] + torch.tensor(releases, dtype=torch.int32,
                                                      device=budget["releases"].device),
        "epsilon_basic": budget["epsilon_basic"]
        + (eps * n).to(budget["epsilon_basic"].device),
    }


def composed_epsilon(dp: DPConfig, releases: int, delta_prime: float = 1e-6) -> dict:
    """Privacy spent after ``releases`` pushes from one client.

    Returns both the basic (linear) bound and the advanced-composition bound
    (Dwork & Roth Thm 3.20): eps' = eps*sqrt(2T ln(1/δ')) + T eps(e^eps - 1).
    """
    t = releases
    eps = dp.release_epsilon
    if not math.isfinite(eps):  # unclipped release: no finite DP guarantee
        basic = adv = math.inf if t > 0 else 0.0
    else:
        basic = t * eps
        # e^eps overflows float64 past ~709; the bound means nothing there
        growth = math.exp(eps) - 1 if eps < 700 else math.inf
        adv = eps * math.sqrt(2 * t * math.log(1 / delta_prime)) + t * eps * growth
        if t == 0:
            adv = 0.0
    return {
        "basic_epsilon": basic,
        "advanced_epsilon": adv,
        "delta": t * dp.delta + delta_prime,
        "releases": t,
    }


def per_client_report(dp: Optional[DPConfig], releases_per_client,
                      delta_prime: float = 1e-6) -> list:
    """Per-hospital budget breakdown from each client's own release count;
    empty when the guard is disabled."""
    if dp is None:
        return []
    return [composed_epsilon(dp, int(t), delta_prime) for t in releases_per_client]


def budget_report(dp: Optional[DPConfig], budget: Budget,
                  delta_prime: float = 1e-6) -> dict:
    """Human-readable budget: the carried counters + both composition
    bounds, with the smaller as ``spent_epsilon``."""
    t = int(budget["releases"])
    rep: dict = {
        "enabled": dp is not None,
        "releases": t,
        "sigma": dp.sigma if dp is not None else 0.0,
    }
    if dp is not None:
        rep.update(composed_epsilon(dp, t, delta_prime))
        rep["epsilon_basic_carried"] = float(budget["epsilon_basic"])
        rep["spent_epsilon"] = min(rep["basic_epsilon"], rep["advanced_epsilon"])
    return rep
