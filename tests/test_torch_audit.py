"""The port's inversion audit (``privacy.audit``, ``SplitSession.audit_privacy``)
and the deprecated shims ``core.dp`` and ``core.inversion`` against
``repro``'s.

The same inputs on both sides: the weights carried across with the bridge,
the attack's start point ``0.5 + 0.01 * N(0, 1)`` drawn by JAX from
``PRNGKey(seed)`` and fed as ``x0``, and the sweep's guard noise, JAX's
draw from ``fold_in(PRNGKey(seed), row)``, fed by ``noise_fn``. The narrow
CNN runs its client stage through ``privacy_conv`` (the JAX side's Pallas
kernel in interpret mode, the port's plain version on CPU tensors), whose
backward gives the attack's gradient in x.

Tolerance. One attack step at 1e-5 absolute and relative (float32 convs and
their backward summed in another order). A trajectory adds the sign term
``lr * 0.01 * sign(g)``: where g is within rounding of 0 the two sides may
take opposite signs, and that element then parts by ``2 * lr * 0.01 =
1e-3`` a step. So a 10-step trajectory holds every element at 1e-5 except
flipped ones, which may part by at most ``10 * 1e-3`` and may be at most 1%
of the elements (none flipped on this CPU when the test was written), and
metrics of such a trajectory hold at 1e-5 where no element flipped.
Pixels the max-pool does not select get ``g = 0`` on both sides, so sign 0
on both. ``privacy_metrics`` at 1e-6. No test here anchors on the MSE
ordering of the cholesterol MLP's sweep: the reconstruction is clamped to
[0, 1] while the MLP's z-scored features are not, so its MSE has a floor
that does not depend on sigma.
"""
import dataclasses
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import CHOLESTEROL_MLP as J_MLP
from repro.configs.paper_models import COVID_CNN as J_COVID
from repro.core import SplitSession as JSession
from repro.core import SplitTrainConfig as JConfig
from repro.core.adapters import cnn_adapter as j_cnn_adapter
from repro.core.adapters import mlp_adapter as j_mlp_adapter
from repro.data import make_cholesterol, make_covid_ct
from repro.optim import adamw as j_adamw
from repro.privacy import DPConfig as JDPConfig
from repro.privacy import audit as j_audit
from repro.privacy import dp_release as j_dp_release
from repro_torch.common.bridge import to_torch
from repro_torch.configs import CHOLESTEROL_MLP, COVID_CNN
from repro_torch.core import SplitSession, SplitTrainConfig
from repro_torch.core.adapters import cnn_adapter, mlp_adapter
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig, audit, dp_release

TOL = dict(atol=1e-5, rtol=1e-5)
NARROW = dict(input_hw=(16, 16), stages=((8, 1),), dense_units=(8,))
SIGN_STEP = 2 * 0.05 * 0.01  # a flipped sign(g) at the default lr


def _cnn():
    """(jax client forward, port client forward, the client params, x)."""
    jad = j_cnn_adapter(dataclasses.replace(J_COVID, **NARROW, use_kernel=True, interpret=True))
    tad = cnn_adapter(dataclasses.replace(COVID_CNN, **NARROW, use_kernel=True))
    p = jad.init(jax.random.PRNGKey(0))["client"]
    tp = to_torch(jax.device_get(p), "cpu")
    x, _ = make_covid_ct(2, hw=16, seed=2)
    return (lambda z: jad.client_forward(p, z, None),
            lambda z: tad.client_forward(tp, z, None), x)


def _mlp():
    jad, tad = j_mlp_adapter(J_MLP), mlp_adapter(CHOLESTEROL_MLP)
    p = jad.init(jax.random.PRNGKey(1))["client"]
    tp = to_torch(jax.device_get(p), "cpu")
    x, _ = make_cholesterol(3, seed=1)
    return jad, tad, p, tp, x


def jax_x0(shape, seed=0):
    return np.asarray(0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(seed), shape))


def jax_sweep_noise(seed=0):
    """The reference sweep's guard draws: row i from fold_in(root, i)
    directly, without ``key_for`` (``audit.py:94-108``)."""
    root = jax.random.PRNGKey(seed)
    return lambda i, shape: np.asarray(jax.random.normal(jax.random.fold_in(root, i), shape,
                                                         jnp.float32))


def assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["sigma"] == w["sigma"]
        for k in ("mse", "psnr_db", "ncc"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)


def test_invert_features_one_step_and_a_trajectory_match_jax():
    jf, tf, x = _cnn()
    fstar = jf(jnp.asarray(x))
    t_fstar = torch.from_numpy(np.array(fstar))
    x0 = jax_x0(x.shape)
    one_j = np.asarray(j_audit.invert_features(jf, fstar, x.shape, steps=1, seed=0))
    one_t = audit.invert_features(tf, t_fstar, x.shape, steps=1, x0=x0).numpy()
    np.testing.assert_allclose(one_t, one_j, **TOL)
    assert not np.array_equal(one_j, x0)  # the step moved x
    ten_j = np.asarray(j_audit.invert_features(jf, fstar, x.shape, steps=10, seed=0))
    ten_t = audit.invert_features(tf, t_fstar, x.shape, steps=10, x0=x0).numpy()
    err = np.abs(ten_t - ten_j)
    flipped = err > TOL["atol"] + TOL["rtol"] * np.abs(ten_j)
    assert flipped.mean() <= 0.01, int(flipped.sum())
    assert err.max() <= 10 * SIGN_STEP + TOL["atol"]


def test_invert_features_default_start_point_is_seeded():
    """Without ``x0`` the start point comes from a CPU generator seeded from
    ``seed``: the same seed gives the same reconstruction, on any device."""
    _, tf, x = _cnn()
    fstar = tf(torch.from_numpy(x)).detach()
    a = audit.invert_features(tf, fstar, x.shape, steps=3, seed=4)
    b = audit.invert_features(tf, fstar, x.shape, steps=3, seed=4)
    c = audit.invert_features(tf, fstar, x.shape, steps=3, seed=5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_privacy_metrics_match_jax():
    rng = np.random.default_rng(0)
    for shape in ((2, 16, 16, 1), (3, 7)):
        xt, xr = rng.random(shape, np.float32), rng.random(shape, np.float32)
        want = j_audit.privacy_metrics(jnp.asarray(xt), jnp.asarray(xr))
        got = audit.privacy_metrics(torch.from_numpy(xt), torch.from_numpy(xr))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-6, err_msg=k)
    same = audit.privacy_metrics(torch.from_numpy(xt), torch.from_numpy(xt))
    assert same["mse"] == 0.0 and same["psnr_db"] == pytest.approx(120.0)


@pytest.mark.parametrize("attacker", ["same_forward", "noise_free_attacker"])
def test_inversion_attack_report_matches_jax(attacker):
    """The MLP's observed release carries its model noise (JAX's draw from a
    fixed key, fed as the port's noise tensor); the attacker optimizes
    through that same noisy forward, or through the noise-free one."""
    jad, tad, p, tp, x = _mlp()
    key = jax.random.PRNGKey(5)
    feat_shape = tad.feature_shape(x.shape)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, feat_shape, jnp.float32)))
    kw_j, kw_t = {}, {}
    if attacker == "noise_free_attacker":
        kw_j["attacker_forward"] = lambda z: jad.client_forward(p, z, None)
        kw_t["attacker_forward"] = lambda z: tad.client_forward(tp, z, None)
    want = j_audit.inversion_attack_report(lambda z: jad.client_forward(p, z, key),
                                           jnp.asarray(x), steps=10, seed=3, **kw_j)
    got = audit.inversion_attack_report(lambda z: tad.client_forward(tp, z, noise),
                                        torch.from_numpy(x), steps=10, seed=3,
                                        x0=jax_x0(x.shape, 3), **kw_t)
    assert_rows_close([{"sigma": 0.0, **got}], [{"sigma": 0.0, **want}])


@pytest.mark.parametrize("clip", [None, 1.0], ids=["unclipped", "clipped"])
def test_guard_noise_sweep_matches_jax(clip):
    """sigma 0 (the identity, or the clip alone) and sigma > 0, fed JAX's
    fold-in draws; the narrow CNN through the kernel path on both sides."""
    jf, tf, x = _cnn()
    sigmas = (0.0, 0.5, 4.0)
    want = j_audit.guard_noise_sweep(jf, jnp.asarray(x), sigmas=sigmas, clip_norm=clip,
                                     steps=10, seed=0)
    got = audit.guard_noise_sweep(tf, torch.from_numpy(x), sigmas=sigmas, clip_norm=clip,
                                  steps=10, seed=0, noise_fn=jax_sweep_noise(0),
                                  x0=jax_x0(x.shape))
    assert [r["sigma"] for r in got] == list(sigmas)
    assert_rows_close(got, want)


def test_guard_noise_sweep_release_kernel_path_on_cpu():
    """``use_kernel=True`` routes each row's release through ``dp_release``
    (its plain version on CPU tensors): the rows equal the plain guard's."""
    _, tf, x = _cnn()
    kw = dict(sigmas=(0.0, 2.0), clip_norm=1.0, steps=4, seed=1)
    plain = audit.guard_noise_sweep(tf, torch.from_numpy(x), **kw)
    kernel = audit.guard_noise_sweep(tf, torch.from_numpy(x), use_kernel=True, **kw)
    assert plain == kernel


def test_session_audit_privacy_matches_jax_on_a_bridged_state():
    """``SplitSession.audit_privacy`` on client 1's bank of a state carried
    from a JAX session (the session's clip, a noise-free forward): one row
    per sigma, each equal to the JAX session's audit."""
    cfg = dict(n_clients=3, data_shares=(0.7, 0.2, 0.1), server_batch=12)
    js = JSession(j_cnn_adapter(dataclasses.replace(J_COVID, **NARROW, use_kernel=True,
                                                    interpret=True)),
                  JConfig(**cfg, privacy=JDPConfig(clip_norm=1.0)), j_adamw(1e-2), seed=2)
    ps = SplitSession(cnn_adapter(dataclasses.replace(COVID_CNN, **NARROW, use_kernel=True)),
                      SplitTrainConfig(**cfg, privacy=DPConfig(clip_norm=1.0)), adamw(1e-2),
                      seed=2, device="cpu")
    ps._native = ps.engine.from_canonical(to_torch(jax.device_get(js.state), "cpu"))
    x, _ = make_covid_ct(2, hw=16, seed=3)
    sigmas = (0.0, 1.0, 8.0)
    want = js.audit_privacy(jnp.asarray(x), sigmas=sigmas, steps=8, client=1)
    got = ps.audit_privacy(x, sigmas=sigmas, steps=8, client=1, noise_fn=jax_sweep_noise(0),
                           x0=jax_x0(x.shape))
    assert len(got) == len(sigmas)
    assert_rows_close(got, want)


def _fresh(name):
    # a real import statement after dropping the module, so the warning is
    # raised again (and blamed on the importer)
    sys.modules.pop(name, None)
    return importlib.import_module(name)


def test_deprecated_shims_reexport_the_same_objects():
    """``core.dp`` and ``core.inversion`` warn on import and re-export the
    privacy package's own objects, under the reference's ``__all__``."""
    import repro.core.dp as j_dp
    import repro.core.inversion as j_inv
    import repro_torch.privacy as priv

    with pytest.warns(DeprecationWarning, match="repro_torch.core.dp is deprecated"):
        core_dp = _fresh("repro_torch.core.dp")
    with pytest.warns(DeprecationWarning, match="repro_torch.core.inversion is deprecated"):
        core_inv = _fresh("repro_torch.core.inversion")
    assert core_dp.__all__ == j_dp.__all__ and core_inv.__all__ == j_inv.__all__
    for mod in (core_dp, core_inv):
        for name in mod.__all__:
            assert getattr(mod, name) is getattr(priv, name), name
    assert core_inv.invert_features is audit.invert_features


def test_legacy_dp_release_matches_jax():
    """The legacy ``dp_release`` (the ``core.dp`` name) with JAX's draw in
    the key's place: clip, then ``sigma * noise``, at 1e-5."""
    rng = np.random.default_rng(1)
    feats = (3.0 * rng.standard_normal((4, 6, 6, 2))).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jdp, tdp = JDPConfig(epsilon=2.0, clip_norm=1.5), DPConfig(epsilon=2.0, clip_norm=1.5)
    want = j_dp_release(key, jnp.asarray(feats), jdp)
    noise = np.asarray(jax.random.normal(key, feats.shape, jnp.float32))
    got = dp_release(torch.from_numpy(noise), torch.from_numpy(feats), tdp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
