"""Model-inversion attack as a quantitative privacy metric, as
``repro.privacy.audit``.

The paper argues (§IV-D2, Figs. 2/7/8) that post-cut feature maps are
visually non-invertible. This measures it: a white-box attacker who knows
the client's privacy-layer parameters and observes the released feature map
optimizes a reconstruction x' minimizing ||f(x') - f(x)||^2. The privacy
score is the reconstruction error (MSE / PSNR / NCC) against the true
input: higher MSE is stronger privacy.

``guard_noise_sweep`` runs the attack against a :class:`PrivacyGuard`
release at a ladder of noise levels; ``SplitSession.audit_privacy`` runs it
on a trained state.

Randomness is an input, as in the rest of the port. The attack's start
point is ``x0`` where one is given (a test feeds the JAX package's threefry
draw), else ``0.5 + 0.01 * N(0, 1)`` from a CPU generator seeded from
``seed``. Row i of the sweep draws its guard noise from ``noise_fn(i,
shape)``, else from a CPU generator seeded from ``(seed, i)``. The
reference's ``interpret`` option selects the Pallas interpreter, which the
port does not have: a kernel wrapper runs its plain version on CPU tensors.

The reconstruction is clamped to the image box [0, 1], as the reference's.
For inputs outside the box (the cholesterol MLP's z-scored features) the
MSE then has a floor that does not depend on σ.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import seeded_generator
from repro_torch.privacy.guard import DPConfig, PrivacyGuard

# (row, shape) -> standard-normal guard noise of that shape
SweepNoiseFn = Callable[[int, tuple], object]


def _start_point(x_shape, seed: int, x0, device) -> torch.Tensor:
    if x0 is None:
        x0 = 0.5 + 0.01 * torch.randn(tuple(x_shape), generator=seeded_generator(seed))
    return torch.as_tensor(x0, dtype=torch.float32).to(device)


def invert_features(
    client_forward: Callable[[torch.Tensor], torch.Tensor],
    target_features: torch.Tensor,
    x_shape,
    *,
    steps: int = 300,
    lr: float = 0.05,
    seed: int = 0,
    x0=None,
) -> torch.Tensor:
    """Gradient-descent inversion: argmin_x ||client_forward(x) - f*||^2,
    from ``x0`` (else the seeded start point), one step
    ``x <- clip(x - lr * 0.01 * sign(g) - lr * g, 0, 1)`` at a time, with
    ``g`` the gradient of the feature MSE in x (zero where the forward is
    detached from x). Runs on the features' device."""
    target = target_features.detach()
    x = _start_point(x_shape, seed, x0, target.device)
    for _ in range(steps):
        z = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = torch.mean(torch.square(client_forward(z) - target))
            g = torch.autograd.grad(loss, z, allow_unused=True)[0] if loss.requires_grad else None
        if g is None:
            # a forward detached from x (the LM cut's detach, the reference's
            # stop_gradient) has a zero gradient in x, as jax.grad gives
            g = torch.zeros_like(z)
        with torch.no_grad():
            x = torch.clamp(z - lr * torch.sign(g) * 0.01 - lr * g, 0.0, 1.0)
    return x.detach()


def privacy_metrics(x_true: torch.Tensor, x_rec: torch.Tensor) -> Dict[str, float]:
    """MSE, PSNR (dB, peak 1) and normalized cross-correlation (1 = the
    structure fully reconstructed), in float32 as the reference's."""
    mse = float(torch.mean(torch.square(x_true - x_rec)))
    psnr = float(10.0 * torch.log10(torch.tensor(1.0 / max(mse, 1e-12), dtype=torch.float32)))
    xt = x_true - torch.mean(x_true)
    xr = x_rec - torch.mean(x_rec)
    denom = torch.sqrt(torch.sum(xt ** 2) * torch.sum(xr ** 2)) + 1e-9
    ncc = float(torch.sum(xt * xr) / denom)
    return {"mse": mse, "psnr_db": psnr, "ncc": ncc}


def inversion_attack_report(
    client_forward, x_true: torch.Tensor, *, steps: int = 300, seed: int = 0,
    attacker_forward: Optional[Callable] = None, x0=None,
) -> Dict[str, float]:
    """``client_forward`` produces the observed features (with the client's
    private noise); the attacker optimizes through ``attacker_forward``
    (default: the same function). Pass the noise-free forward there to
    model an attacker who knows the weights but not the noise."""
    with torch.no_grad():
        f_star = client_forward(x_true)
    atk = attacker_forward or client_forward
    x_rec = invert_features(atk, f_star, x_true.shape, steps=steps, seed=seed, x0=x0)
    return privacy_metrics(x_true, x_rec)


def guard_noise_sweep(
    client_forward: Callable[[torch.Tensor], torch.Tensor],
    x_true: torch.Tensor,
    *,
    sigmas: Sequence[float],
    clip_norm: Optional[float] = None,
    steps: int = 120,
    seed: int = 0,
    use_kernel: bool = False,
    noise_fn: Optional[SweepNoiseFn] = None,
    x0=None,
) -> List[Dict[str, float]]:
    """Inversion attack against guard noise level.

    For each σ the observed features pass through a ``PrivacyGuard`` with
    ``noise_scale=σ`` and the given ``clip_norm`` (the identity where σ = 0
    and there is no clip; ``use_kernel`` routes the release through
    ``dp_release``). The attacker knows the weights but not the noise, so it
    optimizes through the noise-free ``client_forward``. Returns one row per
    σ: ``{"sigma", "mse", "psnr_db", "ncc"}``."""
    rows = []
    for i, s in enumerate(sigmas):
        s = float(s)
        dp = None
        if s > 0.0 or clip_norm is not None:
            dp = DPConfig(clip_norm=clip_norm, noise_scale=s, use_kernel=use_kernel)
        guard = PrivacyGuard(dp)

        def observed(z, _guard=guard, _i=i):
            f = client_forward(z)
            noise = None
            if _guard.sigma > 0.0:
                noise = (torch.randn(f.shape, generator=seeded_generator(seed, _i))
                         if noise_fn is None else noise_fn(_i, tuple(f.shape)))
                noise = torch.tensor(np.asarray(noise), dtype=torch.float32, device=f.device)
            return _guard.release_with_noise(f, noise)

        rep = inversion_attack_report(observed, x_true, steps=steps, seed=seed,
                                      attacker_forward=client_forward, x0=x0)
        rows.append({"sigma": s, **rep})
    return rows
