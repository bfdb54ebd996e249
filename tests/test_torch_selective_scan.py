"""Port ``selective_scan`` (its plain version, which the wrapper runs on CPU
tensors) against the JAX package's sequential reference and its Pallas
kernel in interpret mode, on the JAX suite's sweep (tests/test_kernels.py:
96-113, the ragged S=17 case included) and with A and D from the JAX
``init_ssm``.

Inputs are numpy draws from a seed. Tolerance, the JAX suite's: atol 1e-5,
rtol 1e-4 (float32, with exp and the sum over states computed by another
library, carried through the recurrence).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.selective_scan.kernel import selective_scan_pallas
from repro.kernels.selective_scan.ops import selective_scan as jax_selective_scan
from repro.kernels.selective_scan.ref import selective_scan_ref as jax_ref
from repro.models.ssm import init_ssm
from repro_torch.kernels.selective_scan import ops
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

TOL = dict(atol=1e-5, rtol=1e-4)


def _softplus(x):
    return np.log1p(np.exp(x)).astype(np.float32)


def _inputs(seed, Bsz, S, di, st, init_a=False):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((Bsz, S, di)).astype(np.float32)
    dt = _softplus(rng.standard_normal((Bsz, S, di)) * 0.5 - 1)
    B = rng.standard_normal((Bsz, S, st)).astype(np.float32)
    C = rng.standard_normal((Bsz, S, st)).astype(np.float32)
    if init_a:  # the JAX init_ssm's A_log and D, on a reduced falcon-mamba
        cfg = get_config("falcon-mamba-7b").reduced()
        assert cfg.d_inner == di and cfg.ssm_state == st
        p = init_ssm(jax.random.PRNGKey(0), cfg, jnp.float32)
        A = -np.exp(np.asarray(p["A_log"]))
        D = np.array(p["D"])
    else:
        A = (-np.exp(rng.standard_normal((di, st)) * 0.3)).astype(np.float32)
        D = rng.standard_normal(di).astype(np.float32)
    return u, dt, B, C, A, D


def _check(arrays, dtile, tc):
    want_ref = np.asarray(jax_ref(*map(jnp.asarray, arrays)))
    want_pallas = np.asarray(selective_scan_pallas(*map(jnp.asarray, arrays), d_tile=dtile,
                                                   t_chunk=tc, interpret=True))
    got = selective_scan_ref(*map(torch.from_numpy, arrays))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, **TOL)
    return got


@pytest.mark.parametrize("Bsz,S,di,st,dtile,tc", [
    (2, 32, 64, 8, 32, 8), (1, 100, 128, 16, 64, 16), (2, 64, 256, 16, 128, 64),
    (1, 17, 64, 16, 64, 5)])
def test_plain_matches_jax_ref_and_pallas(Bsz, S, di, st, dtile, tc):
    _check(_inputs(Bsz * S + di, Bsz, S, di, st), dtile, tc)


@pytest.mark.parametrize("S,tc", [(17, 5), (64, 64)])
def test_init_ssm_parameters(S, tc):
    arrays = _inputs(5, 2, S, 512, 16, init_a=True)
    # A = -exp(log(1..st)), within an ulp of -(1..st)
    np.testing.assert_allclose(arrays[4], -np.tile(np.arange(1, 17, dtype=np.float32),
                                                   (512, 1)), rtol=2.5e-7)
    np.testing.assert_array_equal(arrays[5], np.ones(512, np.float32))
    _check(arrays, 128, tc)


def test_wrapper_on_cpu_matches_jax_wrapper():
    arrays = _inputs(6, 2, 24, 32, 8)
    want = np.asarray(jax_selective_scan(*map(jnp.asarray, arrays), d_tile=32, t_chunk=8))
    before = ops.launches
    got = ops.selective_scan(*map(torch.from_numpy, arrays), d_tile=32, t_chunk=8)
    plain = ops.selective_scan(*map(torch.from_numpy, arrays), use_kernel=False)
    assert ops.launches == before  # a CPU tensor never reaches the kernel
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_wrapper_rejects_bad_inputs():
    arrays = [torch.from_numpy(a) for a in _inputs(8, 1, 4, 8, 2)]
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.selective_scan(*(a.to("meta") for a in arrays))
    with pytest.raises(ValueError, match="positive"):
        ops.selective_scan(*arrays, t_chunk=0)
