"""``repro_torch.models.moe`` against ``repro.models.moe`` on the same
inputs, the reference's weights carried over with ``common.bridge.to_torch``:
reduced granite-moe-1b-a400m (4 experts, top 2) and reduced mixtral-8x7b.

Tolerances: the capacity, the slots, the sorted tokens and the dropped set
exact (a stable sort on both sides); the dispatched rows, the sorted gates
and the aux loss 1e-6 (float32 router products summed in another order);
the layer's output and aux 1e-5, and the gradients of a summed loss
1e-5 of each leaf's largest element plus 1e-5 relative. The combine adds each token's
K weighted rows left to right, where the reference scatter-adds them: the
order of K float32 adds, within 1e-5 of it, and bit-equal from call to
call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as jmoe
from repro_torch.common.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe

TOL = dict(atol=1e-5, rtol=1e-5)
ROUTE_TOL = dict(atol=1e-6, rtol=1e-6)
ARCHS = ("granite-moe-1b-a400m", "mixtral-8x7b")


def _configs(arch, **kw):
    return (dataclasses.replace(j_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               err_msg=what, **tol)


def _grad_close(got, want, what=""):
    """A gradient within 1e-5 of its largest element, and 1e-5 relative:
    float32 sums over the tokens in another order part by a few ulps of
    the leaf's scale, a bf16 path or a wrong term by far more."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, err_msg=what,
                               atol=TOL["atol"] * float(np.abs(want).max()), rtol=TOL["rtol"])


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, to_torch(jp, "cpu")


@pytest.mark.parametrize("T", [1, 7, 24, 64, 1536, 3000])
@pytest.mark.parametrize("cf,K,E", [(1.25, 8, 32), (1.25, 2, 8), (1.0, 2, 4), (2.0, 2, 16),
                                    (8.0, 2, 4), (1.1, 3, 7)])
def test_capacity_matches_jax(T, cf, K, E):
    kw = dict(capacity_factor=cf, experts_per_token=K, n_experts=E)
    jcfg, tcfg = _configs("granite-moe-1b-a400m", **kw)
    assert tmoe._capacity(tcfg, T) == jmoe._capacity(jcfg, T)


def test_init_moe_tree_matches_jax():
    jcfg, tcfg = _configs("granite-moe-1b-a400m")
    want = jax.eval_shape(lambda k: jmoe.init_moe(k, jcfg, jnp.float32), jax.random.PRNGKey(0))
    got = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, torch.float32)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf,T", [(None, 24), (1.0, 40)])
def test_route_and_dispatch_matches_jax(arch, cf, T):
    """The slot of each assignment, the sorted tokens, the dropped set, the
    dispatched buffer, the sorted gates and the aux; at capacity factor 1
    some tokens are dropped."""
    kw = {} if cf is None else {"capacity_factor": cf}
    jcfg, tcfg = _configs(arch, **kw)
    jp, tp = _params(jcfg)
    xf = np.random.default_rng(1).standard_normal((T, jcfg.d_model)).astype(np.float32)
    jxe, (jdest, jst, jsg), jaux = jax.jit(
        lambda r, x: jmoe._route_and_dispatch(r, jcfg, x))(jp["router"], jnp.asarray(xf))
    xe, (dest, st, sg, order), aux = tmoe._route_and_dispatch(tp["router"], tcfg,
                                                              torch.from_numpy(xf))
    E, C = tcfg.n_experts, tmoe._capacity(tcfg, T)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    dropped = np.asarray(jdest) == E * C
    np.testing.assert_array_equal((dest == E * C).numpy(), dropped)
    assert dropped.any() == (cf == 1.0)
    _close(xe, jxe, "xe", ROUTE_TOL)
    _close(sg, jsg, "sg", ROUTE_TOL)
    _close(aux, jaux, "aux", ROUTE_TOL)
    assert sorted(order.tolist()) == list(range(T * tcfg.experts_per_token))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunks", [1, 4])
def test_moe_forward_and_gradients_match_jax(arch, chunks):
    """``moe_forward``'s output and aux, and the gradients of a loss of
    both in x and every weight, at one chunk and at four dispatched apart.
    The loss sums the output against a random cotangent, so that dL/dy is
    O(1); each gradient is held at 1e-5 of its own size (``_grad_close``)."""
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_forward(p, jcfg, xx, chunks=chunks)
        return jnp.sum(y * g) + 3.0 * aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                             has_aux=True))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    y, aux = tmoe.moe_forward(leaves, tcfg, tx, chunks=chunks)
    _close(y, jy, "y")
    _close(aux, jaux, "aux")
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(g)) + 3.0 * aux,
                                [tx] + list(leaves.values()))
    _grad_close(grads[0], jgx, "dx")
    for (k, _), gr in zip(leaves.items(), grads[1:]):
        _grad_close(gr, jgp[k], f"d{k}")


def test_combine_is_bit_equal_across_calls():
    """No atomics in the combine: two calls on one input give the same bits,
    forward and backward."""
    _, tcfg = _configs("granite-moe-1b-a400m", capacity_factor=1.0)
    tp = tmoe.init_moe(torch.Generator().manual_seed(4), tcfg, torch.float32)
    x = torch.randn((3, 20, tcfg.d_model), generator=torch.Generator().manual_seed(5))
    runs = []
    for _ in range(2):
        xx = x.clone().requires_grad_()
        y, aux = tmoe.moe_forward(tp, tcfg, xx)
        (dx,) = torch.autograd.grad(y.square().sum() + aux, [xx])
        runs.append((y, aux, dx))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
