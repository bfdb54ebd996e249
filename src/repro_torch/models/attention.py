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

import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.sharding.collectives import copy_to

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


# ------------------------------------------------- over the model axis
def _rank_heads(params: dict, cfg: ModelConfig, x: torch.Tensor, positions, tp):
    """This rank's query heads, and k/v whole, where ``wq``'s columns are
    this rank's chunk (``tp`` a ``sharding.tensor_parallel.LMParallel``).

    The rank holds q's columns ``[c0, c0 + nq)``, which cover the heads
    ``[h_lo, h_hi)``; where they cut a head, q is gathered and the covering
    heads' columns taken. k and v are made whole (gathered where ``wk``
    shards, computed replicated where it does not): a rank's query heads
    need their GQA group's kv head whole, and RoPE rotates whole heads.
    Returns ``(q [B, S, Hc, hd], k, v [B, S, KV, hd], (h_lo, h_hi), (off,
    nq))``, ``off`` the rank's first column within the covering heads'
    output."""
    B, S, _ = x.shape
    hd, KV = cfg.head_dim, cfg.n_kv_heads
    nq = params["wq"].shape[1]
    c0 = tp.lo(nq)
    h_lo, h_hi = c0 // hd, -(-(c0 + nq) // hd)
    q = tp.col(x, params["wq"], params.get("bq"))
    if c0 % hd or nq % hd:
        q = tp.whole_for_mine(q)[..., h_lo * hd:h_hi * hd]

    def whole_kv(w, b):
        if tp.split(params[w].shape[1], KV * hd):
            return tp.whole_for_mine(tp.col(x, params[w], params.get(b)))
        y = x @ params[w] if b not in params else x @ params[w] + params[b]
        return copy_to(y, tp.model)

    k, v = whole_kv("wk", "bk"), whole_kv("wv", "bv")
    q = apply_rope(q.reshape(B, S, h_hi - h_lo, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, KV, hd), (h_lo, h_hi), (c0 - h_lo * hd, nq)


def _kv_for_heads(k, v, G: int, h_lo: int, h_hi: int, kv0: int):
    """The kv heads that query heads ``[h_lo, h_hi)`` read (head h reads kv
    head ``h // G``), out of k/v ``[..., KVc, hd]`` holding kv heads from
    ``kv0``: a contiguous run where the heads fill whole groups or sit in
    one, else one kv head a query head (G = 1)."""
    kv_lo, kv_hi = h_lo // G, (h_hi - 1) // G + 1
    if (h_lo % G == 0 and (h_hi - h_lo) % G == 0) or kv_hi - kv_lo == 1:
        return k[:, :, kv_lo - kv0:kv_hi - kv0], v[:, :, kv_lo - kv0:kv_hi - kv0]
    idx = torch.arange(h_lo, h_hi, device=k.device) // G - kv0
    return k[:, :, idx], v[:, :, idx]


def _attention_tp(params, cfg, x, positions, tp, **block_kw):
    q, k, v, (h_lo, h_hi), (off, nq) = _rank_heads(params, cfg, x, positions, tp)
    k, v = _kv_for_heads(k, v, cfg.n_heads // cfg.n_kv_heads, h_lo, h_hi, 0)
    out = chunked_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window, **block_kw)
    B, S = x.shape[:2]
    out = out.reshape(B, S, -1)[..., off:off + nq]
    return tp.row(out, params["wo"])


def attention_forward(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                      *, q_block: int = 1024, kv_block: int = 1024,
                      skip_masked_blocks: bool = False, bf16_probs: bool = False,
                      return_kv: bool = False, tp=None):
    """Training / prefill attention. x: [B, S, d]. ``tp`` (an
    ``LMParallel``): ``params`` are this rank's shards, and where ``wq``'s
    columns shard, the rank runs its heads (``_rank_heads``) and ``wo``
    sums the heads' rows over the model axis."""
    if tp is not None and tp.split(params["wq"].shape[1], cfg.n_heads * cfg.head_dim):
        if return_kv:
            raise ValueError("return_kv takes the unsharded path")
        return _attention_tp(params, cfg, x, positions, tp, q_block=q_block, kv_block=kv_block,
                             skip_masked_blocks=skip_masked_blocks, bf16_probs=bf16_probs)
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


def decode_attention(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, pos: int,
                     tp=None):
    """One-token decode. x: [B, 1, d]; cache k/v: [B, L, KV, hd]; ``pos``
    the token's position. Returns (y [B, 1, d], new_cache): the new key and
    value written to slot ``pos`` (``pos % L`` in a sliding window's ring),
    the cache itself unchanged.

    ``tp`` (an ``LMParallel``; forward only): ``params`` and ``cache`` are
    this rank's shards. The cache holds the kv heads from ``kv0`` (its
    heads shard over the model axis where it divides them) and, with
    ``tp.seq``, the rank's run of positions (the reference's B = 1 rule):
    the token's slot is written by the rank that holds it, and the softmax
    takes its max and sums over ``tp.seq``."""
    B = x.shape[0]
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    L_loc, KVc = cache["k"].shape[1], cache["k"].shape[2]
    seq = None if tp is None else tp.seq
    L = L_loc * (1 if seq is None else seq.size)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    split_heads = tp is not None and tp.split(params["wq"].shape[1], H * hd)
    if split_heads:
        q, k_new, v_new, (h_lo, h_hi), (off, nq) = _rank_heads(params, cfg, x, positions, tp)
    else:
        q, k_new, v_new = _project_qkv(params, cfg, x, positions)
        h_lo, h_hi = 0, H
    G = H // KV
    kv0 = 0 if KVc == KV else tp.model.index * KVc
    slot = pos % L if cfg.sliding_window else pos
    k, v = cache["k"].clone(), cache["v"].clone()
    s0 = 0 if seq is None else seq.index * L_loc
    if s0 <= slot < s0 + L_loc:  # the rank that holds the slot writes it
        k[:, slot - s0] = k_new[:, 0, kv0:kv0 + KVc].to(k.dtype)
        v[:, slot - s0] = v_new[:, 0, kv0:kv0 + KVc].to(v.dtype)
    kh, vh = _kv_for_heads(k, v, G, h_lo, h_hi, kv0)
    Gl = (h_hi - h_lo) // kh.shape[2]
    qg = q.reshape(B, kh.shape[2], Gl, hd)
    s = torch.einsum("bkgh,blkh->bkgl", qg.float() * _scale(hd), kh.float())
    idx = s0 + torch.arange(L_loc, device=x.device)
    valid = (idx <= slot) | (pos >= L) if cfg.sliding_window else idx <= pos
    s = torch.where(valid, s, NEG_INF)
    if seq is None:
        o = torch.einsum("bkgl,blkh->bkgh", torch.softmax(s, dim=-1), vh.float())
    else:
        m = seq.all_reduce(torch.amax(s, dim=-1), op=dist.ReduceOp.MAX)
        p = torch.exp(s - m[..., None])
        denom = seq.all_reduce(torch.sum(p, dim=-1))
        o = seq.all_reduce(torch.einsum("bkgl,blkh->bkgh", p, vh.float())) / denom[..., None]
    o = o.reshape(B, 1, (h_hi - h_lo) * hd).to(x.dtype)
    if split_heads:
        y = tp.row(o[..., off:off + nq], params["wo"])
    else:
        y = o @ params["wo"]
    return y, {"k": k, "v": v}

