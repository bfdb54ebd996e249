"""The LM stack's building blocks in ``repro_torch.models.layers`` against
``repro.models.layers`` on the same seeded NumPy inputs, in float32 and
bfloat16.

Tolerances: float32 1e-5 absolute and relative (sums and transcendental
functions in another order or library); bfloat16 two ulps (rtol 1.6e-2 =
2 x 2^-7 of the value, atol 2e-3 near zero): both sides compute in float32
and round the result to bfloat16, so they part where the float32 values
straddle a rounding boundary. The initialisers draw from other generators:
they are held to shapes, dtypes and their scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.common.bridge import to_torch
from repro_torch.models import layers as tl

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-3, rtol=1.6e-2)}
DTYPES = ("float32", "bfloat16")


def _pair(a: np.ndarray, dtype: str):
    """The same array as a JAX array and a CPU tensor, in ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))
    return j, to_torch(np.asarray(j), "cpu")


def _close(got: torch.Tensor, want, dtype: str):
    assert str(got.dtype).split(".")[-1] == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_norms(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)) * 3 + 0.5
    w, b = rng.standard_normal(48), rng.standard_normal(48)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, "float32")
    jb, tb = _pair(b, "float32")
    _close(tl.rms_norm(tx, tw, 1e-5), jl.rms_norm(jx, jw, 1e-5), dtype)
    _close(tl.layer_norm(tx, tw, tb, 1e-6), jl.layer_norm(jx, jw, jb, 1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(dtype, theta):
    """Halves rotated (not interleaved pairs), float32 angles, positions up
    to 700 (angles of hundreds of radians)."""
    np.testing.assert_allclose(tl.rope_freqs(64, theta).numpy(),
                               np.asarray(jl.rope_freqs(64, theta)), rtol=1e-6)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16))
    pos = np.stack([np.arange(7), np.arange(7) * 100]).astype(np.int32)
    jx, tx = _pair(x, dtype)
    _close(tl.apply_rope(tx, torch.from_numpy(pos), theta),
           jl.apply_rope(jx, jnp.asarray(pos), theta), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu(dtype):
    """In bfloat16 each side rounds the hidden activation h to bfloat16
    (after each product and the SiLU) before the down projection, so an
    element of h may part by an ulp (at most 2^-7 of it) per rounding, and
    the output by that carried through ``w_down``: the bfloat16 case adds
    ``2^-6 * sum_j |h_j| |w_down[j, k]|`` (two roundings) to its two ulps
    of the output. Measured: 22 of 320 outputs part by more than two ulps,
    by up to 0.0195 at an output of 1.3."""
    rng = np.random.default_rng(2)
    params = {k: rng.standard_normal(s) * 0.2 for k, s in
              (("w_gate", (32, 64)), ("w_up", (32, 64)), ("w_down", (64, 32)))}
    jp = {k: _pair(v, dtype)[0] for k, v in params.items()}
    tp = {k: _pair(v, dtype)[1] for k, v in params.items()}
    jx, tx = _pair(rng.standard_normal((2, 5, 32)), dtype)
    got, want = tl.swiglu(tp, tx), jl.swiglu(jp, jx)
    if dtype == "float32":
        _close(got, want, dtype)
        return
    f32 = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    x = np.asarray(jx, np.float32)
    g = x @ f32["w_gate"]
    h = g / (1 + np.exp(-g)) * (x @ f32["w_up"])
    carried = 2.0 ** -6 * (np.abs(h) @ np.abs(f32["w_down"]))
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want)
    assert got.dtype == torch.bfloat16
    assert (err <= TOL[dtype]["atol"] + TOL[dtype]["rtol"] * np.abs(want) + carried).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy(dtype, masked):
    """A float32 logsumexp whatever the logits' dtype; a mask mean floored
    at 1 (an all-zero mask gives 0)."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 6, 50)) * 4
    labels = rng.integers(0, 50, (3, 6)).astype(np.int32)
    jx, tx = _pair(logits, dtype)
    for mask in ([None] if not masked else
                 [(rng.random((3, 6)) < 0.5).astype(np.float32), np.zeros((3, 6), np.float32)]):
        got = tl.softmax_cross_entropy(tx, torch.from_numpy(labels),
                                       None if mask is None else torch.from_numpy(mask))
        want = jl.softmax_cross_entropy(jx, jnp.asarray(labels),
                                        None if mask is None else jnp.asarray(mask))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_initialisers(dtype):
    """embed_init: normal x 0.02; init_swiglu: LeCun normal over fan-in,
    ``[in, out]`` weights; in the requested dtype."""
    gen = torch.Generator().manual_seed(0)
    tdt = getattr(torch, dtype)
    emb = tl.embed_init(gen, (400, 64), tdt)
    assert emb.shape == (400, 64) and emb.dtype == tdt
    assert abs(float(emb.float().std()) - 0.02) < 0.02 * 0.05
    p = tl.init_swiglu(gen, 64, 256, tdt)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_gate": (64, 256), "w_up": (64, 256), "w_down": (256, 64)}
    assert all(v.dtype == tdt for v in p.values())
    assert abs(float(p["w_up"].float().std()) - 64 ** -0.5) < 64 ** -0.5 * 0.05
    assert abs(float(p["w_down"].float().std()) - 256 ** -0.5) < 256 ** -0.5 * 0.05
