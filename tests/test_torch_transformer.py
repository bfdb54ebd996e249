"""``repro_torch.models.transformer`` and ``models.model`` against the JAX
package's, at reduced widths (``get_config(name).reduced()`` with three
layers, so the trunk has two stacked groups), the JAX parameters carried
over with ``common.bridge.to_torch``: llama3.2-1b (dense), qwen2-7b (qkv
bias), hubert-xlarge (audio frames, encoder-only) and internvl2-26b (vlm;
its token frontend, and the patch stub).

Tolerances: 1e-5 absolute and relative on logits, losses and gradients
(float32 matmuls and the online softmax summed in another order, through
three blocks); the ``init_params`` trees equal in paths, shapes and dtypes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.models import transformer as jt
from repro_torch.common.bridge import flatten, to_torch
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("llama3.2-1b", "qwen2-7b", "hubert-xlarge", "internvl2-26b", "internvl2-26b/patches")
B, S = 2, 12


def _configs(arch, **kw):
    name, _, variant = arch.partition("/")
    kw = {"n_layers": 3, **kw}
    if variant == "patches":
        kw["frontend"] = "vision_patches"
    return (dataclasses.replace(j_get_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32),
                "labels": labels}
    if cfg.frontend == "vision_patches":
        return {"patch_embeds": rng.standard_normal((B, 4, cfg.frontend_dim)).astype(np.float32),
                "tokens": labels[:, : S - 4], "labels": labels}
    return {"tokens": labels, "labels": labels}


def _sides(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               err_msg=what, **tol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _configs(request.param)
    jp = jm.init_model(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, tcfg, jp, to_torch(jp, "cpu")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-7b", "hubert-xlarge", "internvl2-26b"])
def test_init_params_tree_matches_jax(arch):
    """The same key paths, shapes and dtypes; the groups stacked
    ``[n_groups, ...]``, no ``lm_head`` where the embedding is tied."""
    jcfg, tcfg = _configs(arch)
    want = jax.eval_shape(lambda k: jt.init_params(k, jcfg), jax.random.PRNGKey(0))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    got = tt.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in flatten(got).items()} == want
    assert tt.stack_split(tcfg) == jt.stack_split(jcfg) == (1, 0, 2)


def test_forward_and_loss_match_jax(model):
    jcfg, tcfg, jp, tp = model
    jb, tb = _sides(_batch(jcfg))
    opts_j, opts_t = jt.ModelOptions(q_block=8, kv_block=8), tt.ModelOptions(q_block=8,
                                                                             kv_block=8)

    @jax.jit
    def reference(p, b):
        jh, jpos, _ = jt.client_forward(p["client"], jcfg, b, opts_j)
        return jt.forward(p, jcfg, b, opts_j)[0], jh, jpos, jm.loss_fn(p, jcfg, b, opts_j)

    want, jh, jpos, (jloss, jparts) = reference(jp, jb)
    logits, aux = tt.forward(tp, tcfg, tb, opts_t)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits, want, "forward")
    # the split: the client's cut features, then the server's logits
    h, pos, _ = tt.client_forward(tp["client"], tcfg, tb, opts_t)
    _close(h, jh, "client_forward")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    tied = tp["client"]["embed"] if tcfg.tie_embeddings else None
    _close(tt.server_forward(tp["server"], tcfg, h, pos, opts_t, tied)[0], want,
           "server_forward")
    loss, parts = tm.loss_fn(tp, tcfg, tb, opts_t)
    _close(loss, jloss, "loss")
    _close(parts["ce"], jparts["ce"], "ce")
    _close(tm.prefill(tp, tcfg, {k: v for k, v in tb.items() if k != "labels"}, opts_t),
           want, "prefill")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge"])
def test_loss_gradients_match_jax(arch):
    """Autograd through the loop over the stacked groups accumulates into
    the stacked leaves; the cut not detached, so the client's leaves get a
    gradient too."""
    jcfg, tcfg = _configs(arch)
    jp = jm.init_model(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = to_torch(jp, "cpu")
    jb, tb = _sides(_batch(jcfg, seed=1))
    kw = dict(q_block=8, kv_block=8, detach_cut=False)
    want = jax.jit(jax.grad(lambda p: jm.loss_fn(p, jcfg, jb, jt.ModelOptions(**kw))[0]))(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    grads = torch.autograd.grad(tm.loss_fn(tp, tcfg, tb, tt.ModelOptions(**kw))[0], leaves,
                                allow_unused=True)
    for (path, w), g in zip(sorted(flatten(want).items()), grads):
        _close(torch.zeros(w.shape) if g is None else g, w, path)


def test_privacy_cut_takes_the_reference_noise():
    """``privacy_noise`` times the noise JAX draws from its key, fed in;
    the cut detaches in the temporal split."""
    jcfg, tcfg = _configs("llama3.2-1b", privacy_noise=0.05)
    jp = jm.init_model(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = to_torch(jp, "cpu")
    jb, tb = _sides(_batch(jcfg))
    key = jax.random.PRNGKey(7)
    noise = jax.random.normal(key, (B, S, jcfg.d_model), jnp.float32)
    jh, _, _ = jax.jit(lambda c, b, k: jt.client_forward(c, jcfg, b, jt.ModelOptions(q_block=8),
                                                         k))(jp["client"], jb, key)
    tp["client"]["embed"].requires_grad_()
    h, _, _ = tt.client_forward(tp["client"], tcfg, tb, tt.ModelOptions(q_block=8),
                                torch.from_numpy(np.array(noise)))
    _close(h, jh)
    assert not h.requires_grad
    plain, _, _ = tt.client_forward(tp["client"], tcfg, tb, tt.ModelOptions(q_block=8))
    assert not torch.equal(plain, h)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_steps_match_jax(window):
    """Fourteen decode steps (a ring of 8 slots wraps) of llama's reduced
    stack, tied embeddings: each step's logits and the final caches."""
    jcfg, tcfg = _configs("llama3.2-1b", sliding_window=window)
    jp = jm.init_model(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = to_torch(jp, "cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, 14)).astype(np.int32)
    js = jm.init_decode_state(jcfg, B, 14, jnp.float32)
    ts = tm.init_decode_state(tcfg, B, 14, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in flatten(ts).items()} == \
        {k: v.shape for k, v in flatten(js).items()}
    step = jax.jit(lambda p, st, tok, pos: jm.serve_step(p, jcfg, st, tok, pos))
    with torch.no_grad():
        for t in range(14):
            want, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            got, ts = tm.serve_step(tp, tcfg, ts, torch.from_numpy(toks[:, t:t + 1]), t)
            assert got.shape == (B, 1, jcfg.vocab_size) and got.dtype == torch.float32
            _close(got, want, f"step {t}")
    for (path, w), (_, g) in zip(sorted(flatten(js).items()), sorted(flatten(ts).items())):
        _close(torch.from_numpy(g), w, path)


# the MoE, SSM and hybrid families at their reduced widths (``.reduced()``:
# 2 layers, 4 for the hybrid at a period of 2), and a hybrid at jamba's own
# layer pattern (16 layers, attention at 4 of every 8, MoE every other
# layer), so that a prefix of 7 mixed blocks and a group of 8 are covered
FAMILIES = ("granite-moe-1b-a400m", "mixtral-8x7b", "falcon-mamba-7b", "jamba-1.5-large-398b",
            "jamba-1.5-large-398b/pattern")
PATTERN = dict(n_layers=16, attn_period=8, attn_offset=4, moe_period=2)
# the 16-block pattern carries float32 rounding through five times the
# depth of the 3-block cases: logits part by up to 2e-5 at logits of 3.9,
# the embedding's gradient by 1.4e-4 at 6.7
DEEP_TOL = dict(atol=1e-4, rtol=1e-4)


def _family(arch, **kw):
    name, _, variant = arch.partition("/")
    kw = {**(PATTERN if variant == "pattern" else {}), **kw}
    return (dataclasses.replace(j_get_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def _tree_shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in
            flatten(tree).items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_moe_ssm_and_hybrid_families_match_jax(arch):
    """Each family against the reference on its weights: the init tree's
    paths, shapes and dtypes, ``stack_split`` and ``period_of``; the
    forward's logits and MoE aux (the client's included); the loss and its
    parts and every gradient with the cut open; eight decode steps and the
    final decode state (``{"ssm": ...}`` on a mamba layer). TOL, and
    DEEP_TOL for the 16-block pattern."""
    jcfg, tcfg = _family(arch)
    tol = DEEP_TOL if arch.endswith("/pattern") else TOL
    assert tcfg.family in tt.PORTED_FAMILIES
    assert tt.stack_split(tcfg) == jt.stack_split(jcfg)
    assert tt.period_of(tcfg) == jt.period_of(jcfg)
    want = jax.eval_shape(lambda k: jt.init_params(k, jcfg, jnp.float32), jax.random.PRNGKey(0))
    assert _tree_shapes(tt.init_params(torch.Generator().manual_seed(0), tcfg, torch.float32,
                                       device="cpu")) == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in flatten(
            jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), want)).items()}

    jp = jm.init_model(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = to_torch(jp, "cpu")
    jb, tb = _sides(_batch(jcfg, seed=4))
    kw = dict(q_block=8, kv_block=8, detach_cut=False)
    jo, to = jt.ModelOptions(**kw), tt.ModelOptions(**kw)
    (jloss, jparts), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jcfg, jb, jo), has_aux=True))(jp)
    jlogits, jaux = jax.jit(lambda p: jt.forward(p, jcfg, jb, jo))(jp)
    logits, aux = tt.forward(tp, tcfg, tb, to)
    _close(logits, jlogits, "logits", tol)
    _close(aux, jaux, "aux", tol)
    assert (float(aux) > 0) == (tcfg.n_experts > 0)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    loss, parts = tm.loss_fn(tp, tcfg, tb, to)
    _close(loss, jloss, "loss", tol)
    _close(parts["moe_aux"], jparts["moe_aux"], "moe_aux", tol)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for (path, w), g in zip(sorted(flatten(jgrad).items()), grads):
        _close(torch.zeros(w.shape) if g is None else g, w, path, tol)

    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, 8)).astype(np.int32)
    js = jm.init_decode_state(jcfg, B, 8, jnp.float32)
    ts = tm.init_decode_state(tcfg, B, 8, torch.float32, "cpu")
    assert _tree_shapes(ts) == {k: (tuple(v.shape), str(v.dtype)) for k, v in
                                flatten(jax.device_get(js)).items()}
    step = jax.jit(lambda p, st, tok, pos: jm.serve_step(p, jcfg, st, tok, pos))
    with torch.no_grad():
        for t in range(8):
            want_t, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            got_t, ts = tm.serve_step(tp, tcfg, ts, torch.from_numpy(toks[:, t:t + 1]), t)
            _close(got_t, want_t, f"step {t}", tol)
    for (path, w), (_, g) in zip(sorted(flatten(js).items()), sorted(flatten(ts).items())):
        _close(torch.from_numpy(g), w, path, tol)


def test_hybrid_pattern_layout():
    """jamba's pattern: one client block, a prefix of 7 (global layers 1-7:
    attention at layer 4, MoE at the odd layers), one group of 8."""
    _, tcfg = _family("jamba-1.5-large-398b/pattern")
    assert tt.stack_split(tcfg) == (1, 7, 1) and tt.period_of(tcfg) == 8
    params = tt.init_params(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu")
    kinds = ["attn" if "attn" in b else "ssm" for b in params["server"]["prefix"]]
    assert kinds == ["ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"]
    assert ["moe" in b for b in params["server"]["prefix"]] == [True, False] * 3 + [True]
    groups = params["server"]["groups"]
    assert "attn" in groups["pos4"] and all("ssm" in groups[f"pos{p}"] for p in range(8)
                                             if p != 4)
    assert all(("moe" in groups[f"pos{p}"]) == (p % 2 == 1) for p in range(8))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b"])
def test_dropless_decode_equals_prefill(arch):
    """At capacity factor 8 no token is dropped, so decoding one token at a
    time equals the prefill's logits (the reference's own check, at its
    tolerance: atol 2e-4, rtol 1e-3)."""
    _, tcfg = _family(arch, capacity_factor=8.0)
    params = tm.init_model(torch.Generator().manual_seed(6), tcfg, torch.float32, "cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(7))
    opts = tt.ModelOptions(q_block=8, kv_block=8, detach_cut=False)
    with torch.no_grad():
        full = tm.prefill(params, tcfg, {"tokens": toks}, opts)
        state = tm.init_decode_state(tcfg, 2, 16, torch.float32, "cpu")
        outs = []
        for t in range(16):
            lg, state = tm.serve_step(params, tcfg, state, toks[:, t:t + 1], t, opts)
            outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b/pattern", "falcon-mamba-7b",
                                  "granite-moe-1b-a400m"])
def test_remat_gradients_are_bit_equal(arch):
    """``remat`` recomputes each group in the backward pass: the loss and
    every gradient are the ones without it, bit for bit."""
    _, tcfg = _family(arch, n_layers=4) if "pattern" not in arch else _family(arch)
    params = tm.init_model(torch.Generator().manual_seed(8), tcfg, torch.float32, "cpu")
    _, tb = _sides(_batch(tcfg, seed=8))
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    runs = []
    for remat in (False, True):
        opts = tt.ModelOptions(q_block=8, kv_block=8, detach_cut=False, remat=remat)
        loss, _ = tm.loss_fn(params, tcfg, tb, opts)
        runs.append([loss] + list(torch.autograd.grad(loss, leaves, allow_unused=True)))
    assert tt.stack_split(tcfg)[2] >= 1
    for a, b in zip(*runs):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("arch,opt", [("granite-moe-1b-a400m", {"moe_chunks": 4}),
                                      ("jamba-1.5-large-398b", {"moe_chunks": 2}),
                                      ("falcon-mamba-7b", {"associative_scan": True}),
                                      ("jamba-1.5-large-398b", {"associative_scan": True})])
def test_options_match_jax(arch, opt):
    """``moe_chunks`` and ``associative_scan`` through the whole model,
    against the reference under the same option: logits, aux and loss at
    1e-5 with chunks, at the associative scan's tolerance (atol 1e-4, rtol
    1e-3, the reference's own) with the parallel prefix."""
    jcfg, tcfg = _family(arch)
    jp = jm.init_model(jax.random.PRNGKey(9), jcfg, jnp.float32)
    tp = to_torch(jp, "cpu")
    jb, tb = _sides(_batch(jcfg, seed=9))
    tol = dict(atol=1e-4, rtol=1e-3) if opt.get("associative_scan") else TOL
    jo, to = jt.ModelOptions(q_block=8, kv_block=8, **opt), tt.ModelOptions(q_block=8,
                                                                             kv_block=8, **opt)
    (jlogits, jaux), (jloss, _) = jax.jit(lambda p: (jt.forward(p, jcfg, jb, jo),
                                                     jm.loss_fn(p, jcfg, jb, jo)))(jp)
    logits, aux = tt.forward(tp, tcfg, tb, to)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), **tol)
    np.testing.assert_allclose(float(tm.loss_fn(tp, tcfg, tb, to)[0]), float(jloss), **tol)


def test_make_batch_shapes_match_jax():
    from repro.configs.base import SHAPES as J_SHAPES
    from repro_torch.configs.base import SHAPES

    for name in ("llama3.2-1b", "hubert-xlarge", "internvl2-26b/patches"):
        jcfg, tcfg = _configs(name)
        for kind in ("train_4k", "decode_32k"):
            want = jm.make_batch_shapes(jcfg, J_SHAPES[kind], batch_override=2)
            got = tm.make_batch_shapes(tcfg, SHAPES[kind], batch_override=2)
            assert {k: (s, str(d).split(".")[-1]) for k, (s, d) in got.items()} == \
                {k: (v.shape, str(v.dtype)) for k, v in want.items()}
