"""Port ``privacy_conv`` (plain version and the autograd Function on the
CPU) against the JAX package's Pallas kernel in interpret mode, and its
gradients against ``jax.vjp`` of the JAX reference.

Tolerance: 1e-5 absolute and relative. Both sides compute in float32; the
conv sums 9*Cin products in another order, which moves the last bits only.
The weight gradient sums over B*H*W positions, so it gets 1e-4 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.privacy_conv.kernel import privacy_conv_pallas
from repro.kernels.privacy_conv.ref import privacy_conv_ref as jax_privacy_conv_ref
from repro_torch.kernels.privacy_conv import ops
from repro_torch.kernels.privacy_conv.ref import privacy_conv_ref

TOL = dict(atol=1e-5, rtol=1e-5)
# tests/test_kernels.py's sweep, the COVID-CT client stage at batch 2, and a
# stage-2-like Cin=16 -> Cout=32
SHAPES = [(2, 8, 8, 1, 16, 0.0), (1, 32, 32, 3, 8, 0.1), (2, 16, 24, 4, 32, 0.0),
          (1, 64, 64, 1, 16, 0.05), (2, 64, 64, 1, 16, 0.05), (1, 16, 16, 16, 32, 0.0)]


def _inputs(seed, B, H, W, cin, cout):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, cin), np.float32),
            (0.1 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32),
            (0.1 * rng.standard_normal((cout,))).astype(np.float32),
            rng.standard_normal((B, H // 2, W // 2, cout), np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,H,W,cin,cout,scale", SHAPES)
def test_forward_matches_pallas(B, H, W, cin, cout, scale):
    x, w, b, nz = _inputs(0, B, H, W, cin, cout)
    want = np.asarray(privacy_conv_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                          jnp.asarray(nz), noise_scale=scale,
                                          interpret=True))
    before = ops.launches
    plain = privacy_conv_ref(*_t(x, w, b, nz), noise_scale=scale)
    fused = ops.privacy_conv(*_t(x, w, b, nz), noise_scale=scale, use_kernel=True)
    assert ops.launches == before  # a CPU tensor never reaches the kernel
    assert tuple(fused.shape) == want.shape == (B, H // 2, W // 2, cout)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    np.testing.assert_allclose(fused.numpy(), want, **TOL)


@pytest.mark.parametrize("B,H,W,cin,cout,scale", [SHAPES[0], SHAPES[1], SHAPES[4]])
def test_gradients_match_jax_vjp(B, H, W, cin, cout, scale):
    x, w, b, nz = _inputs(1, B, H, W, cin, cout)
    g = np.random.default_rng(2).standard_normal((B, H // 2, W // 2, cout), np.float32)
    _, vjp = jax.vjp(lambda xx, ww, bb: jax_privacy_conv_ref(
        xx, ww, bb, jnp.asarray(nz), noise_scale=scale), jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(b))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    tx, tw, tb = (t.requires_grad_() for t in _t(x, w, b))
    out = ops.PrivacyConv.apply(tx, tw, tb, torch.from_numpy(nz), scale)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), want[0], **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), want[1], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), want[2], atol=1e-4, rtol=1e-5)


def test_plain_path_and_argument_checks():
    x, w, b, nz = _t(*_inputs(3, 1, 8, 8, 2, 4))
    np.testing.assert_array_equal(
        ops.privacy_conv(x, w, b, nz, noise_scale=0.1, use_kernel=False).numpy(),
        privacy_conv_ref(x, w, b, nz, noise_scale=0.1).numpy())
    with pytest.raises(ValueError, match="requires noise"):
        ops.privacy_conv(x, w, b, None, noise_scale=0.1)
    # neither CPU nor CUDA: no path, and nothing falls back
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.privacy_conv_forward(*(t.to("meta") for t in (x, w, b, nz)), 0.1)
