"""The PrivacyGuard: the one release mechanism at the split cut.

  features --> per-sample L2 clip --> Gaussian mechanism --> optional
  quantize --> the ONLY thing that crosses the trust boundary

Port of ``repro.privacy.guard``. The JAX guard draws its noise from a key
folded out of the client's step key; here the noise is always a tensor of
standard-normal draws handed in (``release_with_noise``), drawn by the
caller from its own ``torch.Generator`` or fed in by a test.

Calibration (Dwork & Roth, Thm 3.22): one clipped release is (ε, δ)-DP with

  sigma = sensitivity * sqrt(2 ln(1.25/δ)) / ε,   sensitivity = 2 * clip_norm

The clip+noise release runs as plain PyTorch or, with
``DPConfig.use_kernel``, through the fused kernel
``repro_torch.kernels.dp_release`` (the CUDA kernel for CUDA tensors).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels.dp_release.ops import dp_release_with_noise as _dp_release_op


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """The privacy knob, as ``repro.privacy.guard.DPConfig``.

    Two ways to set the noise level:
      * mechanism-calibrated (the default): ``epsilon``/``delta`` +
        ``clip_norm`` give ``sigma`` via the Gaussian mechanism;
      * explicit: ``noise_scale`` pins σ directly; with ``clip_norm=None``
        the release is the raw perturbation (unclipped, so ε is unbounded
        and the accountant reports ``inf``).
    """

    epsilon: float = 1.0
    delta: float = 1e-5
    clip_norm: Optional[float] = 1.0  # None disables per-sample clipping
    noise_scale: Optional[float] = None  # explicit σ override
    quantize_bits: Optional[int] = None  # optional uniform quantization
    # use_kernel routes the clip+noise release through the fused kernel
    # (repro_torch.kernels.dp_release): the CUDA kernel for CUDA tensors, its
    # plain version for CPU tensors
    use_kernel: bool = False
    # kept so that configurations carry across from the JAX package; it has
    # no effect here
    interpret: Optional[bool] = None

    @property
    def sigma(self) -> float:
        """Noise stddev of one release."""
        if self.noise_scale is not None:
            return float(self.noise_scale)
        if self.clip_norm is None:
            return 0.0
        if self.epsilon <= 0:
            raise ValueError("epsilon must be positive")
        sens = 2.0 * self.clip_norm
        return sens * math.sqrt(2.0 * math.log(1.25 / self.delta)) / self.epsilon

    @property
    def release_epsilon(self) -> float:
        """ε spent by ONE release (the accountant's composition unit)."""
        if self.noise_scale is None:
            return float(self.epsilon)
        if self.clip_norm is None or self.noise_scale <= 0:
            return math.inf
        sens = 2.0 * self.clip_norm
        return sens * math.sqrt(2.0 * math.log(1.25 / self.delta)) / self.noise_scale


def clip_per_sample(features: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """L2-clip each sample's feature map (leading dim = batch)."""
    flat = features.reshape(features.shape[0], -1)
    norms = torch.linalg.vector_norm(flat.float(), dim=-1, keepdim=True)
    scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return (flat * scale).reshape(features.shape).to(features.dtype)


def gaussian_release(x: torch.Tensor, scale: float,
                     noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The paper's §III-A Gaussian feature perturbation with pre-drawn
    standard-normal ``noise``: ``x + scale * noise`` (the identity when
    ``scale <= 0`` or there is no noise)."""
    if scale <= 0.0 or noise is None:
        return x
    return x + scale * noise.to(x.dtype)


def quantize_ste(x: torch.Tensor, max_abs: float, bits: int) -> torch.Tensor:
    """Uniform symmetric quantization with a straight-through gradient
    (bandwidth knob for the released feature map; NOT a DP mechanism)."""
    levels = float((1 << (bits - 1)) - 1)
    step = max_abs / levels
    q = torch.clamp(torch.round(x / step), -levels, levels) * step
    return x + (q - x).detach()


def dp_release(noise: torch.Tensor, features: torch.Tensor, dp: DPConfig) -> torch.Tensor:
    """Clip + Gaussian-mechanism noise, the reference's legacy signature
    (kept for the ``core.dp`` shim; new code applies a ``PrivacyGuard``)
    with standard-normal ``noise`` of the features' shape in the place of
    the key: ``clip(features) + sigma * noise`` in float32, back in the
    features' dtype."""
    clipped = clip_per_sample(features, dp.clip_norm)
    return (clipped.float() + dp.sigma * noise.float()).to(features.dtype)


@dataclasses.dataclass(frozen=True)
class PrivacyGuard:
    """Release policy at the cut: clip → noise → quantize. ``dp=None`` is
    the identity."""

    dp: Optional[DPConfig] = None

    @property
    def enabled(self) -> bool:
        return self.dp is not None

    @property
    def sigma(self) -> float:
        return self.dp.sigma if self.dp is not None else 0.0

    def release_with_noise(self, features: torch.Tensor, noise: Optional[torch.Tensor],
                           plan_rows: Optional[int] = None) -> torch.Tensor:
        """The release with pre-drawn standard-normal ``noise`` of the
        features' shape (``None``: no perturbation, refused when σ > 0 so
        that no release is charged for a guarantee that does not hold).
        ``plan_rows``: the rows of the whole release where this call is a
        rank's share of it (the fused kernel then sums each row as the
        whole release does)."""
        if self.dp is None:
            return features
        dp = self.dp
        sigma = dp.sigma
        if sigma > 0.0 and noise is None:
            raise ValueError("guard sigma > 0 requires pre-drawn noise")
        if dp.clip_norm is None:
            # unclipped: the raw perturbation
            out = features
            if sigma > 0.0:
                out = features + sigma * noise.to(features.dtype)
        else:
            out = _dp_release_op(features, noise, clip_norm=float(dp.clip_norm),
                                 sigma=float(sigma), use_kernel=dp.use_kernel,
                                 plan_rows=plan_rows)
        if dp.quantize_bits is not None:
            out = quantize_ste(out, dp.clip_norm or 1.0, dp.quantize_bits)
        return out
