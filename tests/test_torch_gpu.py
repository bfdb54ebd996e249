"""The CUDA kernels against their plain versions on the card. Marked ``gpu``:
without a card every test skips with the reason. This file imports neither
``jax`` nor ``repro``, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance 1e-5 absolute and relative, with TF32 off for the cuDNN conv of
the plain version: float32 sums in another order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import COVID_CNN
from repro_torch.core.adapters import cnn_adapter
from repro_torch.data import make_covid_ct, split_clients
from repro_torch.kernels.dp_release import ops as dp_ops
from repro_torch.kernels.dp_release.ref import dp_release_ref
from repro_torch.kernels.privacy_conv import ops as pc_ops
from repro_torch.kernels.privacy_conv.ref import privacy_conv_ref
from repro_torch.privacy import DPConfig, PrivacyGuard
from repro_torch.serving import SplitInferenceServer, poisson_trace

pytestmark = pytest.mark.gpu
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).cuda()


@pytest.mark.parametrize("B,H,W,cin,cout,scale", [
    (64, 64, 64, 1, 16, 0.05), (8, 32, 32, 16, 32, 0.0), (3, 10, 14, 3, 5, 0.1)])
def test_privacy_conv_kernel(cuda, B, H, W, cin, cout, scale):
    g = torch.Generator().manual_seed(0)
    x, w = _randn(g, B, H, W, cin), _randn(g, 3, 3, cin, cout, scale=0.1)
    b, nz = _randn(g, cout, scale=0.1), _randn(g, B, H // 2, W // 2, cout)
    before = pc_ops.launches
    got = pc_ops.privacy_conv_forward(x, w, b, nz, scale)
    torch.cuda.synchronize()
    assert pc_ops.launches == before + 1
    torch.testing.assert_close(got, privacy_conv_ref(x, w, b, nz, noise_scale=scale), **TOL)


@pytest.mark.parametrize("shape,clip,sigma", [
    ((64, 32, 32, 16), 1.0, 0.0), ((64, 32, 32, 16), 1.0, 9.7), ((8, 112, 112, 64), 1.0, 9.7),
    ((5, 7), 1e4, 0.5)])
def test_dp_release_kernel(cuda, shape, clip, sigma):
    g = torch.Generator().manual_seed(1)
    x, nz = _randn(g, *shape), _randn(g, *shape)
    before = dp_ops.launches
    got = dp_ops.dp_release_forward(x, nz, clip, sigma)
    torch.cuda.synchronize()
    assert dp_ops.launches == before + 1
    torch.testing.assert_close(got, dp_release_ref(x, nz, clip_norm=clip, sigma=sigma), **TOL)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(2, 8, 8, 1, device=cuda)
    w, b = torch.randn(3, 3, 1, 4, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        pc_ops.privacy_conv_forward(x.double(), w, b, None, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        dp_ops.dp_release_forward(x.transpose(1, 2), None, 1.0)


def test_serve_launches_each_kernel_once_per_release(cuda):
    cfg = dataclasses.replace(COVID_CNN, use_kernel=True)
    ad = cnn_adapter(cfg)
    g = torch.Generator().manual_seed(0)
    state = {"client_banks": [ad.init(g, cuda)["client"] for _ in range(3)],
             "server": ad.init(g, cuda)["server"], "step": 0}
    shards = split_clients(*make_covid_ct(48, hw=64, seed=0))
    before = (pc_ops.launches, dp_ops.launches)
    rep = SplitInferenceServer(ad, state, guard=PrivacyGuard(DPConfig(use_kernel=True)),
                               request_batch=4, device=cuda).serve(
        poisson_trace(3, rate=2.0, horizon=6, seed=0), shards)
    releases = sum(rep.releases_per_client)
    assert releases == rep.offered > 0
    assert (pc_ops.launches - before[0], dp_ops.launches - before[1]) == (releases, releases)
    assert all(np.isfinite(r).all() for r in rep.responses.values())
