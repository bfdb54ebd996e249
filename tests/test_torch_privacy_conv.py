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


# (B, H, W, Cin, Cout): the COVID-CT and TABLE1 client stages, Cin 16, Cout
# not a multiple of 4, H and W not multiples of the 16-pixel tile, Cin past
# the generic variant's 16-channel chunk, Cout past one block's 16 channels
PLAN_SHAPES = [(64, 64, 64, 1, 16), (64, 32, 32, 3, 16), (8, 32, 32, 16, 32), (3, 10, 14, 3, 5),
               (2, 18, 22, 1, 6), (2, 12, 20, 20, 7), (1, 2, 2, 2, 1), (2, 34, 16, 40, 36)]


@pytest.mark.parametrize("B,H,W,cin,cout", PLAN_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_conv_plan_covers_the_output(B, H, W, cin, cout, aligned):
    plan = ops.conv_plan(B, H, W, cin, cout, aligned)
    assert plan["cin_variant"] == (1 if cin == 1 else 0)
    assert plan["vec4"] == (cout % 4 == 0 and aligned)
    cpb = plan["channels_per_block"]
    assert cpb % 4 == 0 and 4 <= cpb <= 16 and cpb <= -(-cout // 4) * 4
    assert plan["threads"] == plan["tile"][0] * plan["tile"][1] * cpb // 4
    th, tw = plan["tile"]
    tiles = -(-(H // 2) // th) * -(-(W // 2) // tw)
    # every (image, pooled pixel, channel) in exactly one block's tile
    assert plan["blocks"] == B * tiles * -(-cout // cpb)
    assert tiles * th * tw >= (H // 2) * (W // 2) and -(-cout // cpb) * cpb >= cout


def test_every_conv_variant_is_reachable():
    seen = {(p["cin_variant"], p["vec4"]) for p in
            (ops.conv_plan(*s) for s in PLAN_SHAPES)}
    assert seen == {(c, v) for c in (1, 0) for v in (True, False)}
    with pytest.raises(ValueError, match="no plan"):
        ops.conv_plan(1, 9, 8, 1, 4)
    with pytest.raises(ValueError, match="no plan"):
        ops.conv_plan(1, 8, 8, 0, 4)
