"""``repro_torch.models.attention`` against ``repro.models.attention`` on
the same seeded NumPy inputs: the chunked (flash-style) path under every
mask and block layout, the KV-cache decode (a ring buffer that wraps
included) and the projected attention with a qkv bias.

Tolerances: float32 2e-5 absolute and relative (the JAX suite's attention
tolerance, ``tests/test_kernels.py``: the online softmax sums in another
order); bfloat16 two ulps (atol 2e-3, rtol 1.6e-2). With ``bf16_probs``
both sides round each kv block's P.V product to bfloat16, so an element of
a block may part by one bfloat16 ulp when the two sums land on either side
of a rounding boundary; held at the bfloat16 tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import attention as ja
from repro_torch.common.bridge import to_torch
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as ta

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-3, rtol=1.6e-2)
CFG = dict(name="attn-tiny", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=64, vocab_size=97, dtype="float32")


def _qkv(B, S, H, KV, hd, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, n, hd)).astype(np.float32) for n in (H, KV, KV)]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    return j, [to_torch(np.asarray(a), "cpu") for a in j]


# (S, H, KV, causal, window, q_block, kv_block, skip)
CASES = {
    "causal": (32, 4, 4, True, 0, 8, 8, False),
    "gqa_causal": (32, 8, 2, True, 0, 8, 8, False),
    "window": (40, 4, 2, True, 6, 8, 8, False),
    "bidirectional": (24, 4, 1, False, 0, 8, 8, False),
    "ragged_s": (27, 4, 2, True, 0, 8, 8, False),
    "ragged_bidirectional_window": (21, 4, 2, False, 5, 8, 4, False),
    "blocks_differ": (30, 4, 2, True, 0, 16, 8, False),
    "skip_masked_blocks": (29, 4, 2, True, 0, 8, 8, True),
    "skip_kv_past_the_end": (10, 2, 1, True, 0, 8, 4, True),
    "one_block": (16, 4, 2, True, 0, 1024, 1024, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("bf16_probs", [False, True])
def test_chunked_attention_matches_jax(case, bf16_probs):
    S, H, KV, causal, window, qb, kb, skip = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, S, H, KV, 16)
    kw = dict(causal=causal, window=window, q_block=qb, kv_block=kb, skip_masked_blocks=skip,
              bf16_probs=bf16_probs)
    got = ta.chunked_attention(tq, tk, tv, **kw)
    want = ja.chunked_attention(jq, jk, jv, **kw)
    assert got.shape == (2, S, H, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(BF16 if bf16_probs else F32))


@pytest.mark.parametrize("bf16_probs", [False, True])
def test_chunked_attention_bf16_inputs(bf16_probs):
    """bfloat16 q, k, v: float32 scores and softmax, the result rounded to
    bfloat16."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 27, 4, 2, 16, "bfloat16", seed=1)
    kw = dict(causal=True, window=0, q_block=8, kv_block=8, bf16_probs=bf16_probs)
    got = ta.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ja.chunked_attention(jq, jk, jv, **kw), np.float32),
                               **BF16)


def _params(cfg_kw, seed=2, bias=False):
    rng = np.random.default_rng(seed)
    d, hd, H, KV = cfg_kw["d_model"], cfg_kw["d_model"] // cfg_kw["n_heads"], \
        cfg_kw["n_heads"], cfg_kw["n_kv_heads"]
    p = {"wq": rng.standard_normal((d, H * hd)) * d ** -0.5,
         "wk": rng.standard_normal((d, KV * hd)) * d ** -0.5,
         "wv": rng.standard_normal((d, KV * hd)) * d ** -0.5,
         "wo": rng.standard_normal((H * hd, d)) * (H * hd) ** -0.5}
    if bias:
        p.update(bq=rng.standard_normal(H * hd) * 0.1, bk=rng.standard_normal(KV * hd) * 0.1,
                 bv=rng.standard_normal(KV * hd) * 0.1)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return {k: jnp.asarray(v) for k, v in p.items()}, to_torch(p, "cpu")


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_forward_matches_jax(qkv_bias, causal):
    """The projections (with qkv_bias), RoPE on q and k, the chunked path
    and the output projection; ``return_kv`` gives the rotated k and v."""
    kw = dict(CFG, qkv_bias=qkv_bias, causal=causal, rope_theta=500_000.0)
    jp, tp = _params(kw, bias=qkv_bias)
    x = np.random.default_rng(3).standard_normal((2, 19, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(19, dtype=np.int32), (2, 19))
    opts = dict(q_block=8, kv_block=8, return_kv=True)
    got, (gk, gv) = ta.attention_forward(tp, ModelConfig(**kw), torch.from_numpy(x),
                                         torch.from_numpy(pos.copy()), **opts)
    want, (wk, wv) = ja.attention_forward(jp, JConfig(**kw), jnp.asarray(x), jnp.asarray(pos),
                                          **opts)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_jax(window):
    """Twelve decode steps into a cache of 12 slots, or a ring of 5 that
    wraps twice: each step's output and the whole cache."""
    kw = dict(CFG, sliding_window=window)
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    jp, tp = _params(kw, seed=4)
    jc = ja.init_kv_cache(jcfg, 2, 12, jnp.float32)
    tc = ta.init_kv_cache(tcfg, 2, 12, torch.float32, "cpu")
    assert tuple(tc["k"].shape) == jc["k"].shape == (2, 5 if window else 12, 2, 8)
    xs = np.random.default_rng(5).standard_normal((12, 2, 1, 32)).astype(np.float32)
    for pos in range(12):
        want, jc = ja.decode_attention(jp, jcfg, jnp.asarray(xs[pos]), jc, jnp.int32(pos))
        got, tc = ta.decode_attention(tp, tcfg, torch.from_numpy(xs[pos]), tc, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"pos {pos}", **F32)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **F32)


def test_decode_leaves_the_cache_it_was_given():
    tcfg = ModelConfig(**CFG)
    _, tp = _params(CFG)
    cache = ta.init_kv_cache(tcfg, 1, 4, torch.float32, "cpu")
    _, new = ta.decode_attention(tp, tcfg, torch.ones((1, 1, 32)), cache, 0)
    assert not cache["k"].any() and new["k"][:, 0].abs().sum() > 0
