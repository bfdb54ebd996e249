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


# (N, b, H, W, Cin, Cout, noise_scale, cids, banks): a fleet cycle of the
# COVID-CT client stage at batch 2, a generic Cin, and Cout 5 (scalar)
BANKED = [(10, 2, 16, 16, 1, 16, 0.05, (0,) * 7 + (1,) * 2 + (2,), 3),
          (4, 3, 8, 8, 16, 32, 0.1, (2, 0, 1, 2), 3),
          (3, 2, 10, 14, 3, 5, 0.0, (1, 0, 1), 2)]


@pytest.mark.parametrize("N,b,H,W,cin,cout,scale,cids,banks", BANKED)
def test_banked_matches_vmapped_jax(N, b, H, W, cin, cout, scale, cids, banks):
    """The banked plain version against ``jax.vmap`` of the JAX reference
    over the banks gathered by ``cids``, what the fleet's vmapped Pallas
    call computes (``repro/core/protocol.py:89-101``); and it is, bit for
    bit, the unbanked layer item by item."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, b, H, W, cin), np.float32)
    w = (0.1 * rng.standard_normal((banks, 3, 3, cin, cout))).astype(np.float32)
    bb = (0.1 * rng.standard_normal((banks, cout))).astype(np.float32)
    nz = rng.standard_normal((N, b, H // 2, W // 2, cout), np.float32)
    idx = jnp.asarray(cids)
    want = np.asarray(jax.vmap(lambda xx, ww, bbb, nn: jax_privacy_conv_ref(
        xx, ww, bbb, nn, noise_scale=scale))(jnp.asarray(x), jnp.take(jnp.asarray(w), idx, 0),
                                             jnp.take(jnp.asarray(bb), idx, 0),
                                             jnp.asarray(nz)))
    before = ops.launches
    tc = torch.tensor(cids, dtype=torch.int32)
    got = ops.privacy_conv_banked_forward(*_t(x, w, bb), tc, torch.from_numpy(nz), scale)
    assert ops.launches == before  # a CPU tensor never reaches the kernel
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    items = torch.stack([privacy_conv_ref(*_t(x[n], w[c], bb[c], nz[n]), noise_scale=scale)
                         for n, c in enumerate(cids)])
    assert torch.equal(got, items)
    plan = ops.plan_for(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(nz), scale)
    assert plan["banked"] and plan["blocks"] == ops.conv_plan(N * b, H, W, cin, cout)["blocks"]
    with pytest.raises(ValueError, match="requires noise"):
        ops.privacy_conv_banked_forward(*_t(x, w, bb), tc, None, 0.1)


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
@pytest.mark.parametrize("B,H,W,cin,cout,scale", [SHAPES[1], SHAPES[3], SHAPES[5]])
def test_half_types_match_pallas_within_one_ulp(half, B, H, W, cin, cout, scale):
    """bfloat16 and float16 inputs: the plain version (the kernel's
    yardstick and its CPU path) against the Pallas kernel in interpret mode,
    which loads them, sums in float32 and stores x's type."""
    from test_torch_dp_release import HALVES, assert_within_one_ulp

    tdt, jdt, mant = HALVES[half]
    ts = [torch.from_numpy(a).to(tdt) for a in _inputs(4, B, H, W, cin, cout)]
    want = privacy_conv_pallas(*(jnp.asarray(t.float().numpy()).astype(jdt) for t in ts),
                               noise_scale=scale, interpret=True)
    assert want.dtype == jdt
    for got in (privacy_conv_ref(*ts, noise_scale=scale),
                ops.privacy_conv(*ts, noise_scale=scale, use_kernel=True)):
        assert got.dtype == tdt
        assert_within_one_ulp(got, np.asarray(want.astype(jnp.float32)), mant)


def test_kernel_inputs_take_the_half_types_and_refuse_others():
    """What the CUDA wrapper checks before it launches: float32, bfloat16 or
    float16 tensors of one type, contiguous (the banked launch float32
    alone); int, float64 and a mixed set are refused. The plan of a 2-byte
    type is float32's but never float4."""
    x, w, b, nz = _t(*_inputs(3, 1, 8, 8, 2, 4))
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        ops.check_inputs([t.to(dt) for t in (x, w, b, nz)], x.to(dt))
    for bad in ([x.long()], [x.double()], [x, w.bfloat16()]):
        with pytest.raises(ValueError, match="one type"):
            ops.check_inputs(bad, bad[0])
    with pytest.raises(ValueError, match="float32\\)"):
        ops.check_inputs([x.bfloat16()], x.bfloat16(), (torch.float32,))
    f32, half = ops.conv_plan(64, 64, 64, 1, 16), ops.conv_plan(64, 64, 64, 1, 16, True,
                                                                "float16")
    assert f32["vec4"] and not half["vec4"] and half["dtype"] == "float16"
    assert {k: v for k, v in f32.items() if k not in ("vec4", "dtype")} == \
        {k: v for k, v in half.items() if k not in ("vec4", "dtype")}
