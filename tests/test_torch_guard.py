"""The port's guard and accountant against ``repro.privacy``: calibration and
accounting exactly, releases to float32 rounding."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.privacy import accountant as jacc
from repro.privacy.guard import DPConfig as JDPConfig
from repro.privacy.guard import PrivacyGuard as JPrivacyGuard
from repro.privacy.guard import clip_per_sample as j_clip_per_sample
from repro_torch.privacy import accountant as tacc
from repro_torch.privacy.guard import DPConfig, PrivacyGuard, clip_per_sample

CONFIGS = [dict(), dict(epsilon=0.25), dict(epsilon=2.0, delta=1e-6, clip_norm=0.5),
           dict(noise_scale=0.3, clip_norm=None), dict(noise_scale=1.5, clip_norm=2.0),
           dict(noise_scale=0.0, clip_norm=1.0), dict(clip_norm=None)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_calibration_exact(kw):
    j, t = JDPConfig(**kw), DPConfig(**kw)
    assert t.sigma == j.sigma
    assert t.release_epsilon == j.release_epsilon


@pytest.mark.parametrize("kw,use_kernel", [
    (dict(clip_norm=1.0), False), (dict(clip_norm=1.0), True),
    (dict(epsilon=4.0, clip_norm=50.0), True),  # clip inactive
])
def test_clipped_release_matches(kw, use_kernel):
    """Clipped path through ``dp_release`` (plain or the kernel's wrapper,
    which takes the plain version on the CPU): 1e-5, the sum-order and
    rsqrt-vs-division rounding of test_torch_dp_release.py."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 4, 8), np.float32)
    nz = rng.standard_normal((3, 4, 4, 8), np.float32)
    jg = JPrivacyGuard(JDPConfig(**kw, use_kernel=use_kernel, interpret=True))
    tg = PrivacyGuard(DPConfig(**kw, use_kernel=use_kernel))
    want = np.asarray(jg.release_with_noise(jnp.asarray(x), jnp.asarray(nz)))
    got = tg.release_with_noise(torch.from_numpy(x), torch.from_numpy(nz)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        clip_per_sample(torch.from_numpy(x), 1.0).numpy(),
        np.asarray(j_clip_per_sample(jnp.asarray(x), 1.0)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(noise_scale=0.3, clip_norm=None),
                                dict(noise_scale=0.3, clip_norm=None, quantize_bits=8),
                                dict(noise_scale=0.0, clip_norm=None, quantize_bits=4)])
def test_unclipped_and_quantized_release_exact(kw):
    """``clip_norm=None`` is ``x + sigma * noise`` (``guard.py:211-215``),
    then the optional quantizer: the same float32 operations in the same
    order, so the bits agree."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16), np.float32)
    nz = rng.standard_normal((2, 16), np.float32)
    want = np.asarray(JPrivacyGuard(JDPConfig(**kw)).release_with_noise(
        jnp.asarray(x), jnp.asarray(nz)))
    got = PrivacyGuard(DPConfig(**kw)).release_with_noise(
        torch.from_numpy(x), torch.from_numpy(nz)).numpy()
    np.testing.assert_array_equal(got, want)


def test_guard_off_and_missing_noise():
    x = torch.ones(2, 3)
    assert PrivacyGuard().release_with_noise(x, None) is x
    with pytest.raises(ValueError, match="pre-drawn noise"):
        PrivacyGuard(DPConfig()).release_with_noise(x, None)


@pytest.mark.parametrize("kw", CONFIGS[:5])
def test_budget_advance_exact(kw):
    j, t = JDPConfig(**kw), DPConfig(**kw)
    jb, tb = jacc.budget_init(), tacc.budget_init("cpu")
    for n in (1, 3, 7, 64, 1):
        jb, tb = jacc.budget_advance(jb, j, n), tacc.budget_advance(tb, t, n)
        assert int(tb["releases"]) == int(jb["releases"])
        assert tb["releases"].dtype == torch.int32
        assert tb["epsilon_basic"].dtype == torch.float32
        assert (np.float32(tb["epsilon_basic"].item()).tobytes()
                == np.asarray(jb["epsilon_basic"], np.float32).tobytes())
    assert tacc.budget_advance(tb, None, 5) is tb


@pytest.mark.parametrize("kw,t", [(dict(), 0), (dict(), 1), (dict(epsilon=0.25), 50),
                                  (dict(epsilon=0.1), 1000), (dict(clip_norm=None,
                                                                   noise_scale=0.3), 4)])
def test_composition_formulas(kw, t):
    """The accountant's formulas themselves, and equality with repro's:
    basic = T*eps and advanced = eps*sqrt(2T ln(1/d')) + T*eps*(e^eps - 1)
    (Dwork & Roth Thm 3.20). Neither bound is claimed to beat the other."""
    dp, jdp = DPConfig(**kw), JDPConfig(**kw)
    got = tacc.composed_epsilon(dp, t)
    assert got == jacc.composed_epsilon(jdp, t)
    eps = dp.release_epsilon
    if math.isfinite(eps) and t > 0:
        assert got["basic_epsilon"] == t * eps
        assert got["advanced_epsilon"] == pytest.approx(
            eps * math.sqrt(2 * t * math.log(1e6)) + t * eps * math.expm1(eps), rel=1e-12)
    assert got["delta"] == t * dp.delta + 1e-6
    assert tacc.per_client_report(dp, [t, 2 * t]) == jacc.per_client_report(jdp, [t, 2 * t])
    assert tacc.per_client_report(None, [t]) == []
    budget = tacc.budget_advance(tacc.budget_init("cpu"), dp, t)
    jbudget = jacc.budget_advance(jacc.budget_init(), jdp, t)
    assert tacc.budget_report(dp, budget) == jacc.budget_report(jdp, jbudget)
    assert tacc.budget_report(None, budget) == jacc.budget_report(None, jbudget)
