"""``repro_torch.models.ssm`` (the Mamba-1 block) against
``repro.models.ssm`` on the same inputs, the reference's weights carried
over with ``common.bridge.to_torch``, at reduced falcon-mamba-7b widths
(d 256, d_inner 512, d_state 16, dt_rank 16, conv 4).

Tolerances: 1e-5 absolute and relative on the conv, the scan, the block
and its gradients and on decode steps (float32 products summed in another
order through the recurrence). The associative scan composes the steps in
another tree than ``lax.associative_scan``: held at the reference's own
test of its variant, atol 1e-4 and rtol 1e-3 (``tests/test_models.py``).
The init constants: ``dt_bias``, ``D`` and ``conv_b`` exact; ``A_log``
within an ulp (torch's ``log(7)`` is one ulp from XLA's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import ssm as jssm
from repro_torch.common.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.models import ssm as tssm

TOL = dict(atol=1e-5, rtol=1e-5)
ASSOC_TOL = dict(atol=1e-4, rtol=1e-3)
JCFG = j_get_config("falcon-mamba-7b").reduced()
TCFG = get_config("falcon-mamba-7b").reduced()
B, S = 2, 13


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               err_msg=what, **tol)


@pytest.fixture(scope="module")
def params():
    jp = jssm.init_ssm(jax.random.PRNGKey(0), JCFG, jnp.float32)
    return jp, to_torch(jp, "cpu")


def _scan_inputs(seed=0):
    rng = np.random.default_rng(seed)
    di, st = TCFG.d_inner, TCFG.ssm_state
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(0.5 * rng.standard_normal((B, S, di)) - 1)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, st)).astype(np.float32) for _ in range(2))
    A = -np.tile(np.arange(1, st + 1, dtype=np.float32), (di, 1))
    D = rng.standard_normal(di).astype(np.float32)
    return u, dt, Bm, Cm, A, D


def test_init_ssm_tree_and_constants_match_jax(params):
    jp, _ = params
    got = tssm.init_ssm(torch.Generator().manual_seed(0), TCFG, torch.float32)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in got.items()} == \
        {k: (tuple(v.shape), f"torch.{v.dtype}") for k, v in jp.items()}
    for k in ("dt_bias", "D", "conv_b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jp[k]), err_msg=k)
    np.testing.assert_array_max_ulp(got["A_log"].numpy(), np.asarray(jp["A_log"]), maxulp=1)
    assert TCFG.dt_rank == JCFG.dt_rank and TCFG.d_inner == JCFG.d_inner


def test_causal_conv_matches_jax(params):
    jp, tp = params
    x = np.random.default_rng(1).standard_normal((B, S, TCFG.d_inner)).astype(np.float32)
    _close(tssm._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"] + 0.1),
           jssm._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"] + 0.1))


@pytest.mark.parametrize("associative", [False, True])
def test_scans_match_jax_with_gradients(associative):
    """Each scan against the reference's same variant, values and the
    gradients of a weighted sum in every input."""
    args = _scan_inputs(2)
    g = np.random.default_rng(3).standard_normal(args[0].shape).astype(np.float32)
    jfn = jssm._ssm_scan_associative if associative else jssm._ssm_scan
    tfn = tssm._ssm_scan_associative if associative else tssm._ssm_scan
    tol = ASSOC_TOL if associative else TOL
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    jgrads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = tfn(*targs)
    _close(got, want, "y", tol)
    for i, (tg, jg) in enumerate(zip(torch.autograd.grad(got, targs, torch.from_numpy(g)),
                                     jgrads)):
        _close(tg, jg, f"grad {i}", tol)


def test_associative_scan_is_the_sequential_scan():
    """The port's two variants on one input, at the associative tolerance."""
    args = [torch.from_numpy(a) for a in _scan_inputs(4)]
    _close(tssm._ssm_scan_associative(*args), tssm._ssm_scan(*args).numpy(), tol=ASSOC_TOL)


@pytest.mark.parametrize("associative", [False, True])
def test_ssm_forward_and_gradients_match_jax(params, associative):
    jp, tp = params
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, TCFG.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    tol = ASSOC_TOL if associative else TOL
    fwd = lambda p, xx: jssm.ssm_forward(p, JCFG, xx, associative=associative)  # noqa: E731
    want, vjp = jax.vjp(jax.jit(fwd), jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    got = tssm.ssm_forward(leaves, TCFG, tx, associative=associative)
    _close(got, want, "y", tol)
    grads = torch.autograd.grad(got, [tx] + list(leaves.values()), torch.from_numpy(g))
    _close(grads[0], jgx, "dx", tol)
    for k, gr in zip(leaves, grads[1:]):
        _close(gr, jgp[k], f"d{k}", tol)


def test_decode_steps_match_jax(params):
    """Twelve one-token steps against the reference's, each output and the
    final state; and the steps' outputs equal the forward over the whole
    sequence (the recurrence is the scan)."""
    jp, tp = params
    x = np.random.default_rng(6).standard_normal((B, 12, TCFG.d_model)).astype(np.float32)
    js = jssm.init_ssm_state(JCFG, B)
    ts = tssm.init_ssm_state(TCFG, B, device="cpu")
    step = jax.jit(lambda p, xx, s: jssm.ssm_decode_step(p, JCFG, xx, s))
    outs = []
    with torch.no_grad():
        for t in range(12):
            want, js = step(jp, jnp.asarray(x[:, t:t + 1]), js)
            got, ts = tssm.ssm_decode_step(tp, TCFG, torch.from_numpy(x[:, t:t + 1]), ts)
            _close(got, want, f"step {t}")
            outs.append(got)
        for k in ("conv", "h"):
            _close(ts[k], js[k], k)
        _close(torch.cat(outs, 1), tssm.ssm_forward(tp, TCFG, torch.from_numpy(x)).numpy())


def test_init_ssm_state_dtypes_match_jax():
    """The conv ring is float32 by default (and ``dtype`` where given), the
    state float32 always."""
    for dt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        want = jssm.init_ssm_state(JCFG, 3) if jdt is None else jssm.init_ssm_state(JCFG, 3, jdt)
        got = (tssm.init_ssm_state(TCFG, 3, device="cpu") if dt is None
               else tssm.init_ssm_state(TCFG, 3, dt, "cpu"))
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} \
            == {k: (v.shape, str(v.dtype)) for k, v in want.items()}
