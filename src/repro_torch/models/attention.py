"""GQA attention: the chunked (flash-style) training and prefill path and
the KV-cache decode, as ``repro.models.attention``.

The chunked path is the reference's own XLA code (not its Pallas kernel;
``repro/models/attention.py:3-6``), ported as plain PyTorch with the same
block structure, so it computes what the reference computes: the sequence
padded to block multiples with the padded keys masked, the scale applied
to q in float32 before the product, the ``-1e30`` sentinel, the online
softmax a kv block at a time with the normaliser floored at ``1e-30``, GQA
heads grouped ``[KV, G]`` (head h reads kv head ``h // G``). With
``bf16_probs`` the PV product reads bfloat16 probabilities and values and
is rounded to bfloat16 before it joins the float32 accumulator, as a JAX
einsum of two bfloat16 operands returns bfloat16.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def _scale(hd: int) -> float:
    """``1 / sqrt(hd)`` computed in float32, as the reference's, held as a
    Python float (exactly that float32 value)."""
    return (1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))).item()


def init_attention(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(generator, d, (d, cfg.n_heads * hd), dtype),
        "wk": dense_init(generator, d, (d, cfg.n_kv_heads * hd), dtype),
        "wv": dense_init(generator, d, (d, cfg.n_kv_heads * hd), dtype),
        "wo": dense_init(generator, cfg.n_heads * hd, (cfg.n_heads * hd, d), dtype),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = apply_rope(q.reshape(B, S, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, cfg.n_kv_heads, hd)


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int):
    """[q_blk, k_blk] additive float32 mask."""
    rel = q_pos[:, None] - k_pos[None, :]
    m = torch.zeros(rel.shape, dtype=torch.float32, device=rel.device)
    if causal:
        m = torch.where(rel < 0, NEG_INF, m)
    if window > 0:
        m = torch.where(torch.abs(rel) >= window, NEG_INF, m)
    return m


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                      window: int = 0, q_block: int = 1024, kv_block: int = 1024,
                      skip_masked_blocks: bool = False, bf16_probs: bool = False):
    """Flash-style chunked attention. q: [B, S, H, hd]; k, v: [B, S, KV, hd]
    (GQA: H = KV * G). Returns [B, S, H, hd] in q's dtype.

    With ``skip_masked_blocks`` (causal, no window) a q block's kv loop
    stops after the block that holds its diagonal. As in the reference, a
    kv block index past the last one reads the last block (``lax``'s
    dynamic index clamps) under the mask of the index asked for; only
    ``q_block > kv_block`` with a ragged S reaches that."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = _scale(hd)
    q_block, kv_block = min(q_block, S), min(kv_block, S)
    nq, nk = -(-S // q_block), -(-S // kv_block)
    Sq, Sk = nq * q_block, nk * kv_block
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n - S))  # noqa: E731
    qg = pad(q, Sq).reshape(B, nq, q_block, KV, G, hd)
    kg = pad(k, Sk).reshape(B, nk, kv_block, KV, hd)
    vg = pad(v, Sk).reshape(B, nk, kv_block, KV, hd)
    dev = q.device
    valid_k = (torch.arange(Sk, device=dev) < S).reshape(nk, kv_block)
    pv_dtype = torch.bfloat16 if bf16_probs else torch.float32

    outs = []
    for qi in range(nq):
        qb = qg[:, qi].float() * scale  # [B, qb, KV, G, hd]
        q_pos = qi * q_block + torch.arange(q_block, device=dev)
        m = torch.full((B, KV, G, q_block), NEG_INF, dtype=torch.float32, device=dev)
        l_sum = torch.zeros((B, KV, G, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, q_block, hd), dtype=torch.float32, device=dev)
        n_kv = nk
        if skip_masked_blocks and causal and window == 0:
            n_kv = (qi * q_block + q_block + kv_block - 1) // kv_block
        for kj in range(n_kv):
            kc = min(kj, nk - 1)
            kb, vb = kg[:, kc], vg[:, kc]  # [B, kb, KV, hd]
            k_pos = kj * kv_block + torch.arange(kv_block, device=dev)
            s = torch.einsum("bqkgh,bckh->bkgqc", qb, kb.float())  # [B, KV, G, qb, kb]
            mask = _block_mask(q_pos, k_pos, causal, window)
            mask = torch.where(valid_k[kc][None, :], mask, NEG_INF)
            s = s + mask
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(pv_dtype), vb.to(pv_dtype)).float()
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l_sum[..., None], min=1e-30)  # [B, KV, G, qb, hd]
        outs.append(out.permute(0, 3, 1, 2, 4))  # [B, qb, KV, G, hd]
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, hd)
    return out[:, :S].to(q.dtype)


def attention_forward(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                      *, q_block: int = 1024, kv_block: int = 1024,
                      skip_masked_blocks: bool = False, bf16_probs: bool = False,
                      return_kv: bool = False):
    """Training / prefill attention. x: [B, S, d]."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = chunked_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                            q_block=q_block, kv_block=kv_block,
                            skip_masked_blocks=skip_masked_blocks, bf16_probs=bf16_probs)
    B, S = x.shape[:2]
    y = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ params["wo"]
    return (y, (k, v)) if return_kv else y


# ------------------------------------------------------------------ decode
def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                  device=None) -> dict:
    """The cache of ONE attention layer; a sliding-window config's is a
    ring of ``window`` slots."""
    length = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, pos: int):
    """One-token decode. x: [B, 1, d]; cache k/v: [B, L, KV, hd]; ``pos``
    the token's position. Returns (y [B, 1, d], new_cache): the new key and
    value written to slot ``pos`` (``pos % L`` in a sliding window's ring),
    the cache itself unchanged."""
    B = x.shape[0]
    hd = cfg.head_dim
    L = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    slot = pos % L if cfg.sliding_window else pos
    k, v = cache["k"].clone(), cache["v"].clone()
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)

    KV, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,blkh->bkgl", qg.float() * _scale(hd), k.float())
    idx = torch.arange(L, device=x.device)
    valid = (idx <= slot) | (pos >= L) if cfg.sliding_window else idx <= pos
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,blkh->bkgh", p, v.float())
    y = o.reshape(B, 1, cfg.n_heads * hd).to(x.dtype) @ params["wo"]
    return y, {"k": k, "v": v}
