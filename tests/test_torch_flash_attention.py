"""Port ``flash_attention`` (its plain version, which the wrapper runs on CPU
tensors) against the JAX package's reference and its Pallas kernel in
interpret mode, on the JAX suite's sweep (tests/test_kernels.py:51-76) plus
an hd-80 case, and the GQA wrapper against the JAX wrapper. A plain-torch
model of the bfloat16 CUDA kernel's rounding (tensor-core products, the
scale after the product, P split into two bf16 parts) is held against the
same references at the same tolerance.

Inputs are numpy draws from a seed, rounded to bfloat16 the same way (to
nearest even) on both sides. Tolerance: float32 2e-5, the JAX suite's (sums
in another order); bfloat16 atol 2e-3, rtol 1.6e-2, two bfloat16 ulps (every
side computes in float32 and rounds the output to bfloat16, so they differ
where the float32 values straddle a rounding boundary).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask, flash_attention_ref

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-3, rtol=1.6e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,hd,causal,window,qb,kb", [
    (2, 64, 32, True, 0, 16, 16),
    (2, 100, 64, True, 0, 32, 16),    # ragged tail
    (1, 128, 64, False, 0, 64, 32),   # bidirectional (encoder)
    (2, 96, 32, True, 24, 32, 32),    # sliding window
    (1, 64, 128, True, 0, 64, 64),
    (2, 75, 80, False, 0, 32, 32),    # hd 80 (hubert-xlarge), ragged, bidirectional
])
def test_plain_matches_jax_ref_and_pallas(BH, S, hd, causal, window, qb, kb, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_draw(BH * S + hd, *[(BH, S, hd)] * 3), dtype)
    got = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][1]
    got = got.float().numpy()
    want_ref = np.asarray(jax_ref(jq, jk, jv, causal=causal, window=window), np.float32)
    want_pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, window=window, q_block=qb, kv_block=kb,
        interpret=True), np.float32)
    np.testing.assert_allclose(got, want_ref, **TOL[dtype])
    np.testing.assert_allclose(got, want_pallas, **TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 16), (True, 20)])
def test_gqa_wrapper_matches_jax_wrapper(causal, window):
    B, S, H, KV, hd = 2, 64, 8, 2, 32
    arrays = _draw(7, (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    want = np.asarray(jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                                          q_block=32, kv_block=32))
    before = ops.launches
    fused = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                q_block=32, kv_block=32)
    plain = ops.flash_attention(tq, tk, tv, causal=causal, window=window, use_kernel=False)
    assert ops.launches == before  # a CPU tensor never reaches the kernel
    assert fused.shape == (B, S, H, hd)
    np.testing.assert_allclose(fused.numpy(), want, **TOL["float32"])
    np.testing.assert_allclose(plain.numpy(), want, **TOL["float32"])


def test_kv_head_of_query_head_is_h_over_groups():
    """Query head h attends with kv head h // (H // KV), as jnp.repeat gives:
    the output of head h is unchanged when only the other kv heads change."""
    B, S, H, KV, hd = 1, 16, 6, 3, 16
    q, k, v = (torch.from_numpy(a) for a in _draw(9, (B, S, H, hd), (B, S, KV, hd),
                                                    (B, S, KV, hd)))
    out = ops.flash_attention(q, k, v)
    for g in range(KV):
        k2, v2 = k.clone(), v.clone()
        others = [j for j in range(KV) if j != g]
        k2[:, :, others] += 1.0
        v2[:, :, others] -= 2.0
        out2 = ops.flash_attention(q, k2, v2)
        heads = list(range(g * (H // KV), (g + 1) * (H // KV)))
        torch.testing.assert_close(out2[:, :, heads], out[:, :, heads], rtol=0, atol=0)


def test_window_attends_to_exactly_the_window():
    """With the finite sentinel, a row gets the softmax over its window alone
    (the masked scores weigh exactly 0) and stays finite."""
    q, k, v = (torch.from_numpy(a) for a in _draw(11, *[(1, 40, 16)] * 3))
    out = flash_attention_ref(q, k, v, causal=True, window=3)
    assert NEG_INF == -1e30 and torch.isfinite(out).all()
    i = 30
    s = (q[0, i] / 4.0) @ k[0, i - 2:i + 1].T
    want = torch.softmax(s, dim=0) @ v[0, i - 2:i + 1]
    torch.testing.assert_close(out[0, i], want, **TOL["float32"])


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="positive"):
        ops.flash_attention(q, q, q, q_block=0)


# ---- the bfloat16 CUDA kernel's rounding, modelled in plain torch
# (csrc/flash_attention.cu flash_attention_bf16): bf16 operands with float32
# products and sums, the scale (with log2 e) on the float32 scores after the
# product, 64-column kv tiles with the online rescaling in base 2, and P split
# into bf16 hi + lo parts for P.V. A model for this test only, not a second
# plain version: it shows that this rounding stays within the bf16 tolerance
# of the JAX reference and the Pallas kernel, which the card cannot show.
LOG2E = np.float32(1.4426950408889634)


def _split_bf16(p):
    hi = p.bfloat16().float()
    return hi, (p - hi).bfloat16().float()


def _bf16_kernel_model(q, k, v, *, causal, window, tile=64):
    BH, S, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    scale_log2 = float(np.float32(1.0 / hd ** 0.5) * LOG2E)  # float32, as the kernel's
    mask = attention_mask(S, causal=causal, window=window)
    m = torch.full((BH, S), NEG_INF)
    l = torch.zeros((BH, S))
    acc = torch.zeros((BH, S, hd))
    for k0 in range(0, S, tile):
        s = torch.einsum("bqh,bkh->bqk", qf, kf[:, k0:k0 + tile]) * scale_log2
        s = torch.where(mask[None, :, k0:k0 + tile], s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi, lo = _split_bf16(p)
        vt = vf[:, k0:k0 + tile]
        acc = (acc * corr[..., None] + torch.einsum("bqk,bkh->bqh", hi, vt)
               + torch.einsum("bqk,bkh->bqh", lo, vt))
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).bfloat16()


@pytest.mark.parametrize("BH,S,hd,causal,window,qb,kb", [
    (2, 64, 32, True, 0, 16, 16),
    (2, 100, 64, True, 0, 32, 16),
    (1, 128, 64, False, 0, 64, 32),
    (2, 96, 32, True, 24, 32, 32),
    (1, 64, 128, True, 0, 64, 64),
    (2, 75, 80, False, 0, 32, 32),
    (2, 150, 80, True, 40, 32, 32),   # hd 80, window past a tile, ragged
    (1, 130, 128, False, 24, 64, 64),  # bidirectional window, ragged by two rows
])
def test_bf16_kernel_rounding_matches_jax_ref_and_pallas(BH, S, hd, causal, window, qb, kb):
    (jq, jk, jv), (tq, tk, tv) = _both(_draw(BH * S + hd + 1, *[(BH, S, hd)] * 3), "bfloat16")
    got = _bf16_kernel_model(tq, tk, tv, causal=causal, window=window).float().numpy()
    want_ref = np.asarray(jax_ref(jq, jk, jv, causal=causal, window=window), np.float32)
    want_pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, window=window, q_block=qb, kv_block=kb,
        interpret=True), np.float32)
    np.testing.assert_allclose(got, want_ref, **TOL["bfloat16"])
    np.testing.assert_allclose(got, want_pallas, **TOL["bfloat16"])


def test_hi_lo_split_residual_is_within_2_pow_minus_17():
    """p - hi - lo, with hi = bf16(p) and lo = bf16(p - hi): p - hi is exact
    in float32 and below half a bf16 ulp of p (2^-8 p); rounding it to bf16
    leaves half an ulp of it, 2^-9 of a value below 2^(e-8) where
    p >= 2^e, so at most 2^-17 p, and values near that are reached."""
    p = torch.cat([torch.linspace(0, 1, 2 ** 20 + 1),
                   torch.rand(2 ** 20, generator=torch.Generator().manual_seed(0))])
    hi, lo = _split_bf16(p)
    assert torch.equal(hi, hi.bfloat16().float()) and torch.equal(lo, lo.bfloat16().float())
    residual = (p - hi - lo).abs()
    assert (residual <= 2.0 ** -17 * p).all()
    assert (residual > 2.0 ** -18 * p).any()
