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


# A mixed tree as an LM state's: bfloat16 matrices beside float32 vectors.
MIXED = {"w": [jnp.bfloat16, jnp.float32], "b": (jnp.float32,), "a": jnp.bfloat16}


def _mixed(rng, exact):
    """``_tree``'s layout in ``MIXED``'s dtypes, as the JAX arrays and the
    port's tensors of the same values. ``exact``: multiples of 1/16 in
    [-3, 3], whose squares add up exactly in float32 in any order, so that
    both global norms are the same float32 (XLA and torch sum a leaf in
    another order, which parts a norm of random values by a few ulps)."""
    if exact:
        f = lambda *s: (rng.integers(-48, 49, s) / 16).astype(np.float32)  # noqa: E731
    else:
        f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    tree = {"w": [f(32, 48), f(48)], "b": (f(2, 2),), "a": f(8, 33)}
    j = jax.tree.map(lambda a, dt: jnp.asarray(a).astype(dt), tree, MIXED)
    t = ttree.tree_map(lambda a, dt: torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dt).name)), j, MIXED)
    return j, t


def _bits_equal(got, want):
    g, w = ttree.tree_leaves(got), jax.tree.leaves(want)
    assert [str(a.dtype).removeprefix("torch.") for a in g] == [b.dtype.name for b in w]
    return all(np.array_equal(a.float().numpy(), np.asarray(b.astype(jnp.float32)))
               for a, b in zip(g, w))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_of_a_bf16_tree_is_float32_as_the_reference(max_norm):
    """A bf16 leaf times the float32 scale is float32 in JAX (a strongly
    typed operand) and stays bf16 in torch: the port promotes as JAX, so
    the clipped tree is float32 throughout, and equal to the reference's
    bit for bit where the norms are the same float32. With sums exact in
    any order (``_mixed(exact=True)``) the norms part by at most the last
    ulp, and only where torch's CPU ``sqrt`` rounds the other way from
    XLA's (it is not always correctly rounded); at 0.5 the leaves then
    follow their scale within 2^-22 relative. At 1e3 the scale is 1 and
    the norm's last ulp does not reach the leaves. On random values the
    norms part by a few ulps (each side sums a leaf in its own order):
    within 1e-6."""
    rng = np.random.default_rng(4)
    for exact in (True, False):
        jg, tg = _mixed(rng, exact)
        (jc, jn), (tc, tn) = jopt.clip_by_global_norm(jg, max_norm), \
            topt.clip_by_global_norm(tg, max_norm)
        assert all(x.dtype == torch.float32 for x in ttree.tree_leaves(tc))
        assert all(x.dtype == jnp.float32 for x in jax.tree.leaves(jc))
        if not exact:
            np.testing.assert_allclose(float(tn), float(jn), **TOL)
            _assert_close(tc, jc, **TOL)
        elif float(tn) == float(jn) or max_norm > float(jn):
            assert _bits_equal(tc, jc)
        else:
            assert abs(float(tn) - float(jn)) <= np.spacing(np.float32(jn))
            _assert_close(tc, jc, atol=0.0, rtol=2.0 ** -22)


def test_adamw_over_a_mixed_tree_equals_the_reference():
    """The LM recipe's AdamW (warm-up cosine, weight decay) over a mixed
    tree, each step's gradient clipped first, below the clip's norm (scale
    1: see above for the norm's last ulp): float32 clipped gradients, bf16
    updates of the bf16 leaves, float32 moments, ``p + u`` in the leaf's
    dtype, all equal to the reference's bit for bit over ``STEPS`` steps."""
    rng = np.random.default_rng(5)
    jp, tp = _mixed(rng, False)
    make = lambda m: m.adamw(m.linear_warmup_cosine(3e-2, 2, STEPS), weight_decay=0.1)  # noqa
    jo, to = make(jopt), make(topt)
    js, ts = jo.init(jp), to.init(tp)
    assert all(x.dtype == torch.float32 for x in ttree.tree_leaves(ts))
    for t in range(STEPS):
        jg, tg = _mixed(rng, False)
        jg, tg = jopt.clip_by_global_norm(jg, 1e3)[0], topt.clip_by_global_norm(tg, 1e3)[0]
        assert _bits_equal(tg, jg)
        ju, js = jo.update(jg, js, jp, jnp.int32(t))
        tu, ts = to.update(tg, ts, tp, torch.tensor(t, dtype=torch.int32))
        assert _bits_equal(tu, ju)  # bf16 updates of the bf16 leaves
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        assert _bits_equal(tp, jp) and _bits_equal(ts, js)
    assert [x.dtype for x in ttree.tree_leaves(tp)] == [torch.bfloat16, torch.float32,
                                                        torch.bfloat16, torch.float32]


def test_sgd_schedule_over_a_bf16_leaf_promotes_as_the_reference():
    """``-lr_t * g`` with a schedule's float32 ``lr_t`` and a bf16 ``g`` is
    float32 in JAX before the update's rounding to bf16; the port's too."""
    rng = np.random.default_rng(6)
    jp, tp = _mixed(rng, False)
    jg, tg = _mixed(rng, False)
    ju, _ = jopt.sgd(jopt.constant_schedule(0.0123)).update(jg, {}, jp, jnp.int32(0))
    tu, _ = topt.sgd(topt.constant_schedule(0.0123)).update(tg, {}, tp,
                                                            torch.tensor(0, dtype=torch.int32))
    assert _bits_equal(tu, ju)
