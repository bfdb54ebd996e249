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


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               err_msg=what, **TOL)


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


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "falcon-mamba-7b", "jamba-1.5-large-398b",
                                  "granite-moe-1b-a400m"])
def test_moe_and_ssm_configs_raise(arch):
    cfg = get_config(arch).reduced()
    gen = torch.Generator()
    for call in (lambda: tt.init_params(gen, cfg, device="cpu"),
                 lambda: tm.init_decode_state(cfg, 1, 4, device="cpu")):
        with pytest.raises(ValueError, match="next slice"):
            call()
    assert tt.stack_split(cfg) == jt.stack_split(j_get_config(arch).reduced())


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
