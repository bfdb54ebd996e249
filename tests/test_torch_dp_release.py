"""Port ``dp_release`` (plain version and the autograd Function on the CPU)
against the JAX package's Pallas kernel in interpret mode, and its gradient
against ``jax.vjp`` of the JAX reference.

Tolerance: 1e-5 absolute and relative. The row norm is a float32 sum in
another order, and the scale is ``clip / sqrt(max(n2, 1e-24))`` here against
``clip * rsqrt(max(n2, 1e-24))`` in the JAX reference, which agree within an
ulp or two of the scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dp_release.kernel import dp_release_pallas
from repro.kernels.dp_release.ref import dp_release_ref as jax_dp_release_ref
from repro_torch.kernels.dp_release import ops
from repro_torch.kernels.dp_release.ref import dp_release_ref

TOL = dict(atol=1e-5, rtol=1e-5)
# (shape, clip_norm, sigma): clip active (row norms ~ sqrt(F) >> clip) and
# inactive (clip far above every norm), with and without noise; the last is
# the COVID-CT cut at batch 2 (F = 32*32*16)
CASES = [((4, 8, 8, 8), 1.0, 0.0), ((4, 8, 8, 8), 1.0, 0.7), ((3, 5, 7), 1e4, 0.0),
         ((3, 5, 7), 1e4, 2.5), ((2, 32, 32, 16), 1.0, 9.689610525210778)]


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, np.float32), rng.standard_normal(shape, np.float32))


@pytest.mark.parametrize("shape,clip,sigma", CASES)
def test_forward_matches_pallas(shape, clip, sigma):
    x, nz = _inputs(0, shape)
    want = np.asarray(dp_release_pallas(jnp.asarray(x), jnp.asarray(nz), clip_norm=clip,
                                        sigma=sigma, interpret=True))
    before = ops.launches
    tx, tn = torch.from_numpy(x), torch.from_numpy(nz)
    plain = dp_release_ref(tx, tn, clip_norm=clip, sigma=sigma)
    fused = ops.dp_release_with_noise(tx, tn, clip_norm=clip, sigma=sigma, use_kernel=True)
    assert ops.launches == before  # a CPU tensor never reaches the kernel
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    np.testing.assert_allclose(fused.numpy(), want, **TOL)
    norms = np.linalg.norm(plain.numpy().reshape(shape[0], -1), axis=1)
    if sigma == 0.0:  # the clip itself: no row above clip_norm
        assert np.all(norms <= clip * (1 + 1e-6))


@pytest.mark.parametrize("shape,clip,sigma", [CASES[1], CASES[3]])
def test_gradient_matches_jax_vjp(shape, clip, sigma):
    x, nz = _inputs(1, shape)
    g = np.random.default_rng(2).standard_normal(shape, np.float32)
    _, vjp = jax.vjp(lambda xx: jax_dp_release_ref(xx, jnp.asarray(nz), clip_norm=clip,
                                                   sigma=sigma), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tn = torch.from_numpy(nz).requires_grad_()
    ops.DPRelease.apply(tx, tn, clip, sigma).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **TOL)
    assert tn.grad is None  # the noise is a constant of the release


def test_no_noise_means_no_perturbation_and_bad_device_raises():
    x, nz = (torch.from_numpy(a) for a in _inputs(3, (2, 6)))
    clipped = ops.dp_release_with_noise(x, None, clip_norm=0.5, sigma=3.0, use_kernel=True)
    np.testing.assert_allclose(clipped.numpy(),
                               dp_release_ref(x, None, clip_norm=0.5).numpy(), **TOL)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.dp_release_forward(x.to("meta"), nz.to("meta"), 1.0, 1.0)


# (rows, features, SMs): the serving cuts, the MURA cut, one row, a row
# just under and just over two chunks, F % 4 != 0, more rows than SMs, a
# smaller card, and empty shapes
PLAN_CASES = [(64, 16384, 132), (8, 802816, 132), (1, 802816, 132), (2, 50001, 132),
              (3, 2 * ops.MIN_CHUNK - 1, 132), (3, 2 * ops.MIN_CHUNK, 132), (5, 35, 132),
              (1, 100, 132), (200, 16384, 132), (131, 10 ** 6, 132), (7, 123457, 16),
              (1, 4 * 132 * ops.MIN_CHUNK + 3, 132), (0, 10, 132), (3, 0, 132)]


@pytest.mark.parametrize("rows,feats,sms", PLAN_CASES)
@pytest.mark.parametrize("aligned", [True, False])
def test_release_plan_chunks_cover_each_row_once(rows, feats, sms, aligned):
    plan = ops.release_plan(rows, feats, sms, aligned)
    k, chunk = plan["blocks_per_row"], plan["chunk"]
    assert plan["launches"] == (1 if k == 1 else 2)
    assert plan["vec4"] == (feats % 4 == 0 and aligned)
    if plan["vec4"]:
        assert chunk % 4 == 0
    covered = np.zeros(feats, np.int64)
    for j in range(k):  # block j's part, as the kernel cuts it
        part = slice(j * chunk, min(feats, (j + 1) * chunk))
        assert part.start < part.stop or feats == 0
        covered[part] += 1
    assert np.all(covered == 1)
    if k > 1:
        assert chunk >= ops.MIN_CHUNK and 0 < rows < sms
    # B*k reaches the SM count wherever the rows or the features allow it
    if rows >= sms or feats // ops.MIN_CHUNK >= -(-sms // max(rows, 1)):
        assert rows * k >= sms or rows == 0
    else:
        assert k == max(1, feats // ops.MIN_CHUNK)


def test_release_plan_at_the_cuts():
    covid = ops.release_plan(64, 32 * 32 * 16, 132)
    assert covid["blocks_per_row"] == 1 and covid["vec4"]  # one pass, one launch
    mura = ops.release_plan(8, 112 * 112 * 64, 132)
    assert mura["blocks_per_row"] == 17 and 8 * 17 >= 132 and mura["vec4"]
    assert not ops.release_plan(8, 112 * 112 * 64 + 2, 132)["vec4"]
    with pytest.raises(ValueError, match="no plan"):
        ops.release_plan(8, 100, 0)


HALVES = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 7), "float16": (torch.float16,
                                                                     jnp.float16, 10)}


def half_ulp(v: np.ndarray, mant: int) -> np.ndarray:
    """One ulp of a 2-byte float type with ``mant`` mantissa bits at the
    float32 values ``v`` (float16's subnormal step at its smallest)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return np.maximum(2.0 ** (e - mant), 2.0 ** -24 if mant == 10 else 2.0 ** -133)


def assert_within_one_ulp(got: torch.Tensor, want, mant: int):
    """Both sides sum in float32 and round once to the half type: they may
    land on neighbouring values, one ulp apart, where their float32 sums
    straddle a rounding boundary; never further."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert np.all(np.abs(g - w) <= np.maximum(half_ulp(w, mant), half_ulp(g, mant)))


@pytest.mark.parametrize("half", sorted(HALVES))
@pytest.mark.parametrize("shape,clip,sigma", [CASES[1], CASES[3], CASES[4]])
def test_half_types_match_pallas_within_one_ulp(half, shape, clip, sigma):
    """bfloat16 and float16 x and noise: the plain version (the kernel's
    yardstick and its CPU path) against the Pallas kernel in interpret mode,
    which loads them, computes in float32 and stores x's type."""
    tdt, jdt, mant = HALVES[half]
    x, nz = (torch.from_numpy(a).to(tdt) for a in _inputs(4, shape))
    want = dp_release_pallas(*(jnp.asarray(t.float().numpy()).astype(jdt) for t in (x, nz)),
                             clip_norm=clip, sigma=sigma, interpret=True)
    assert want.dtype == jdt
    for got in (dp_release_ref(x, nz, clip_norm=clip, sigma=sigma),
                ops.dp_release_with_noise(x, nz, clip_norm=clip, sigma=sigma, use_kernel=True)):
        assert got.dtype == tdt
        assert_within_one_ulp(got, np.asarray(want.astype(jnp.float32)), mant)


def test_kernel_inputs_take_the_half_types_and_refuse_others():
    """What the CUDA wrapper checks before it launches: float32, bfloat16 or
    float16 tensors, the noise of x's type (or float32: see the test
    below), contiguous; int, float64, a 2-byte noise beside another x and
    a strided view are refused. The plan of a 2-byte type splits a row into
    as many blocks as float32's, but never loads float4 (so its chunk need
    not be a multiple of 4)."""
    x = torch.zeros((3, 8))
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        ops.check_inputs(x.to(dt), x.to(dt), 1.0)
    for bad in ((x.long(), x.long()), (x.double(), x.double()), (x, x.bfloat16()),
                (x.bfloat16(), x.half()), (x.t().contiguous().t(), x)):
        with pytest.raises(ValueError, match="bfloat16 or float16"):
            ops.check_inputs(*bad, 1.0)
    ops.check_inputs(x.half(), None, 0.0)  # sigma 0: the noise is not read
    f32, bf = ops.release_plan(8, 802816, 132), ops.release_plan(8, 802816, 132, True,
                                                                 "bfloat16")
    assert f32["vec4"] and not bf["vec4"] and bf["dtype"] == "bfloat16"
    assert (f32["blocks_per_row"], f32["launches"]) == (bf["blocks_per_row"], bf["launches"])
    assert bf["chunk"] * bf["blocks_per_row"] >= 802816 > bf["chunk"] * (bf["blocks_per_row"] - 1)
    with pytest.raises(ValueError, match="no plan"):
        ops.release_plan(8, 100, 132, True, "float64")


@pytest.mark.parametrize("half", sorted(HALVES))
@pytest.mark.parametrize("shape,clip,sigma", [CASES[1], CASES[4]])
def test_half_x_takes_float32_noise_as_the_reference(half, shape, clip, sigma):
    """The reference's guard draws its noise in float32 beside a bf16 cut,
    and its kernel reads it as float32 (``kernel.py:35-36``): the plain
    version and the wrapper take that pair (the kernel's input checks pass
    it; the CUDA kernel itself is held by ``tests/test_torch_gpu.py`` and
    ``chip_smoke.py``) and agree with the Pallas kernel in interpret mode
    within one ulp of x's type. Rounding the noise to x's type first would
    be another release (other bits). Every other mix is refused: a 2-byte noise beside float32 x or
    beside the other 2-byte type, float64 noise, a strided noise, noise on
    another device."""
    tdt, jdt, mant = HALVES[half]
    x32, nz = (torch.from_numpy(a) for a in _inputs(5, shape))
    x = x32.to(tdt)
    want = dp_release_pallas(jnp.asarray(x.float().numpy()).astype(jdt), jnp.asarray(nz.numpy()),
                             clip_norm=clip, sigma=sigma, interpret=True)
    assert want.dtype == jdt
    ops.check_inputs(x, nz, sigma)
    for got in (dp_release_ref(x, nz, clip_norm=clip, sigma=sigma),
                ops.dp_release_with_noise(x, nz, clip_norm=clip, sigma=sigma, use_kernel=True)):
        assert got.dtype == tdt
        assert_within_one_ulp(got, np.asarray(want.astype(jnp.float32)), mant)
    rounded = dp_release_ref(x, nz.to(tdt), clip_norm=clip, sigma=sigma)
    assert not torch.equal(rounded, dp_release_ref(x, nz, clip_norm=clip, sigma=sigma))
    other = torch.float16 if tdt == torch.bfloat16 else torch.bfloat16
    for bad in ((x32, nz.to(tdt)), (x, nz.to(other)), (x, nz.double()),
                (x, nz.transpose(1, 2)),  # dims 1 and 2 are equal here: a strided view
                (x, nz.to("meta"))):
        with pytest.raises(ValueError, match="x's type or float32"):
            ops.check_inputs(*bad, sigma)
