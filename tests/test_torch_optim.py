"""The port's optimizers, clip and schedules against ``repro.optim`` on the
same parameters and gradients, over several steps.

Tolerance 1e-6 absolute and relative: the same float32 formulas; the bias
corrections' float32 powers and the square roots may round differently in
the last bit between XLA and PyTorch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.common import tree as jtree
from repro_torch import optim as topt
from repro_torch.common import tree as ttree

TOL = dict(atol=1e-6, rtol=1e-6)
STEPS = 6


def _tree(rng):
    """A small tree with dict keys out of sorted order, a list and a tuple."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": [f(3, 4), f(4)], "b": (f(2, 2),), "a": f(5)}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _assert_close(got, want, **tol):
    g, w = ttree.tree_leaves(got), [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), b, **tol)


OPTIMIZERS = {
    "adamw": lambda m: m.adamw(1e-2),
    "adamw_wd_schedule": lambda m: m.adamw(m.linear_warmup_cosine(3e-2, 2, 5), b2=0.999,
                                           weight_decay=0.1),
    "adamw_cosine": lambda m: m.adamw(m.cosine_schedule(1e-2, 4, final_frac=0.2)),
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd(m.constant_schedule(0.05), momentum=0.9),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match(name):
    """``STEPS`` updates from fresh gradients each step: params and every
    moment leaf at 1e-6."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for t in range(STEPS):
        grads = _tree(rng)
        ju, js = jo.update(_to_jax(grads), js, jp, jnp.int32(t))
        tu, ts = to.update(_to_torch(grads), ts, tp, torch.tensor(t, dtype=torch.int32))
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        _assert_close(tu, ju, **TOL)
    _assert_close(tp, jp, **TOL)
    _assert_close(ts, js, **TOL)


def test_clip_by_global_norm_matches():
    rng = np.random.default_rng(1)
    grads = _tree(rng)
    for max_norm in (0.5, 1e3):  # clipping, then not
        jg, jn = jopt.clip_by_global_norm(_to_jax(grads), max_norm)
        tg, tn = topt.clip_by_global_norm(_to_torch(grads), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), **TOL)
        _assert_close(tg, jg, **TOL)
    zero = {"a": np.zeros(3, np.float32)}  # the 1e-9 floor: no division by 0
    tg, tn = topt.clip_by_global_norm(_to_torch(zero), 1.0)
    assert float(tn) == 0.0 and torch.equal(tg["a"], torch.zeros(3))


@pytest.mark.parametrize("make", [
    lambda m: m.constant_schedule(3e-3),
    lambda m: m.cosine_schedule(1e-2, 7),
    lambda m: m.linear_warmup_cosine(1e-2, 3, 9, final_frac=0.05),
])
def test_schedules_match(make):
    j, t = make(jopt), make(topt)
    for step in range(12):
        np.testing.assert_allclose(float(t(torch.tensor(step, dtype=torch.int32))),
                                   float(j(jnp.int32(step))), **TOL)


def test_tree_helpers_match():
    rng = np.random.default_rng(2)
    a, b = _tree(rng), _tree(rng)
    ja, jb, ta, tb = _to_jax(a), _to_jax(b), _to_torch(a), _to_torch(b)
    np.testing.assert_allclose(float(ttree.tree_global_norm(ta)),
                               float(jtree.tree_global_norm(ja)), **TOL)
    assert ttree.tree_size(ta) == jtree.tree_size(ja)
    assert ttree.tree_bytes(ta) == jtree.tree_bytes(ja)
    _assert_close(ttree.tree_add(ta, tb), jtree.tree_add(ja, jb), **TOL)
    _assert_close(ttree.tree_sub(ta, tb), jtree.tree_sub(ja, jb), **TOL)
    _assert_close(ttree.tree_scale(ta, 0.5), jtree.tree_scale(ja, 0.5), **TOL)
    _assert_close(ttree.tree_zeros_like(ta), jtree.tree_zeros_like(ja), **TOL)
    half = ttree.tree_cast(ta, torch.float16)
    assert all(x.dtype == torch.float16 for x in ttree.tree_leaves(half))
    assert isinstance(half["b"], tuple)
