"""The port's models against ``repro.models`` on bridged parameters and the
same noise: the COVID-CT CNN at its full published width (kernel and plain
client paths) and the cholesterol MLP.

Tolerance: 1e-5 absolute and relative on features and logits; float32 on
both sides, sums in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import CHOLESTEROL_MLP, COVID_CNN
from repro.models import cnn as jcnn
from repro.models import mlp as jmlp
from repro_torch.common.bridge import flatten, to_torch
from repro_torch.configs import CHOLESTEROL_MLP as T_CHOLESTEROL_MLP
from repro_torch.configs import COVID_CNN as T_COVID_CNN
from repro_torch.core.adapters import cnn_adapter, mlp_adapter
from repro_torch.models import cnn, mlp

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def covid_params():
    return jcnn.init_cnn(jax.random.PRNGKey(0), COVID_CNN)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_covid_cnn_full_width(covid_params, use_kernel):
    jcfg = dataclasses.replace(COVID_CNN, use_kernel=use_kernel, interpret=True)
    tcfg = dataclasses.replace(T_COVID_CNN, use_kernel=use_kernel)
    rng = np.random.default_rng(0)
    x = rng.random((2, 64, 64, 1), np.float32)
    key = jax.random.PRNGKey(5)
    # the draw client_forward makes from its key, fed to the port as a tensor
    noise = np.array(jax.random.normal(key, (2, 32, 32, 16), jnp.float32))
    want_f = np.array(jcnn.client_forward(covid_params, jcfg, jnp.array(x), key))
    want_y = np.array(jcnn.server_forward(covid_params, jcfg, jnp.array(want_f)))

    params = to_torch(covid_params, "cpu")
    got_f = cnn.client_forward(params, tcfg, torch.from_numpy(x), torch.from_numpy(noise))
    assert tuple(got_f.shape) == cnn.feature_shape(tcfg, x.shape) == want_f.shape
    np.testing.assert_allclose(got_f.numpy(), want_f, **TOL)
    got_y = cnn.server_forward(params, tcfg, torch.from_numpy(want_f))
    assert tuple(got_y.shape) == (2, 1)
    np.testing.assert_allclose(got_y.numpy(), want_y, **TOL)


def test_flatten_order_is_nhwc(covid_params):
    """The trunk flattens NHWC (``cnn.py:144``): a port that flattened NCHW
    would permute the dense layer's inputs, and this comparison sees it."""
    params = to_torch(covid_params, "cpu")
    fmap = torch.from_numpy(np.random.default_rng(1).random((2, 32, 32, 16), np.float32))
    want = np.array(jcnn.server_forward(covid_params, COVID_CNN, jnp.array(fmap.numpy())))
    np.testing.assert_allclose(cnn.server_forward(params, T_COVID_CNN, fmap).numpy(),
                               want, **TOL)
    x = fmap
    for convs in params["server"]["stages"]:
        x = cnn._run_stage(convs, x)
    nchw = x.permute(0, 3, 1, 2).reshape(2, -1)
    for d in params["server"]["dense"]:
        nchw = torch.relu(nchw @ d["w"] + d["b"])
    wrong = (nchw @ params["server"]["out"]["w"] + params["server"]["out"]["b"]).numpy()
    assert not np.allclose(wrong, want, **TOL)


def test_init_layouts_match_jax():
    """Port init gives the JAX package's tree: same keys, same shapes (HWIO
    convs, [in, out] dense), so states bridge either way."""
    for jinit, tinit, cfg, tcfg in (
        (jcnn.init_cnn, cnn.init_cnn, COVID_CNN, T_COVID_CNN),
        (jmlp.init_mlp, mlp.init_mlp, CHOLESTEROL_MLP, T_CHOLESTEROL_MLP),
    ):
        want = {k: v.shape for k, v in flatten(jinit(jax.random.PRNGKey(0), cfg)).items()}
        got = {k: v.shape for k, v in
               flatten(tinit(torch.Generator().manual_seed(0), tcfg, "cpu")).items()}
        assert got == want


def test_cholesterol_mlp():
    jparams = jmlp.init_mlp(jax.random.PRNGKey(1), CHOLESTEROL_MLP)
    params = to_torch(jparams, "cpu")
    x = np.random.default_rng(2).standard_normal((16, 7), np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, (16, 64), jnp.float32))
    want_h = np.array(jmlp.client_forward(jparams, CHOLESTEROL_MLP, jnp.array(x), key))
    want_y = np.array(jmlp.server_forward(jparams, CHOLESTEROL_MLP, jnp.array(want_h)))
    ad = mlp_adapter(T_CHOLESTEROL_MLP)
    got_h = ad.client_forward(params["client"], torch.from_numpy(x), torch.from_numpy(noise))
    assert tuple(got_h.shape) == ad.feature_shape(x.shape)
    np.testing.assert_allclose(got_h.numpy(), want_h, **TOL)
    got_y = ad.server_forward(params["server"], torch.from_numpy(want_h))
    np.testing.assert_allclose(got_y.numpy(), want_y, **TOL)


def test_adapter_losses_match_jax():
    from repro.core.adapters import cnn_adapter as j_cnn_adapter
    from repro.core.adapters import mlp_adapter as j_mlp_adapter

    rng = np.random.default_rng(4)
    out, yb = rng.standard_normal((8, 1), np.float32), rng.integers(0, 2, 8).astype(np.float32)
    pred, yr = rng.random(8, np.float32) * 100, rng.random(8, np.float32) * 100
    for jad, tad, o, y in ((j_cnn_adapter(COVID_CNN), cnn_adapter(T_COVID_CNN), out, yb),
                           (j_mlp_adapter(CHOLESTEROL_MLP), mlp_adapter(T_CHOLESTEROL_MLP),
                            pred, yr)):
        want = {k: float(v) for k, v in jad.metrics(jnp.array(o), jnp.array(y)).items()}
        got = {k: float(v) for k, v in
               tad.metrics(torch.from_numpy(o), torch.from_numpy(y)).items()}
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
        assert float(tad.loss(torch.from_numpy(o), torch.from_numpy(y))) == \
            pytest.approx(float(jad.loss(jnp.array(o), jnp.array(y))), rel=1e-5)


def test_bce_gradient_at_a_zero_logit_matches_jax():
    """A logit of exactly 0 (every hidden unit of the row dead, the output
    bias at its zero init) gets the reference's gradient, (0.5 - y) + (-0.5)
    a row over the batch, next to ordinary logits; values and gradients at
    1e-6."""
    from repro.metrics.losses import bce_with_logits as j_bce
    from repro_torch.metrics.losses import bce_with_logits

    out = np.array([[0.0], [1.5], [0.0], [-2.0], [16.4]], np.float32)
    y = np.array([[1.0], [0.0], [0.0], [1.0], [1.0]], np.float32)
    want_loss, want_grad = jax.value_and_grad(j_bce)(jnp.asarray(out), jnp.asarray(y))
    o = torch.from_numpy(out).requires_grad_(True)
    loss = bce_with_logits(o, torch.from_numpy(y))
    (grad,) = torch.autograd.grad(loss, o)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), atol=1e-6, rtol=1e-6)
