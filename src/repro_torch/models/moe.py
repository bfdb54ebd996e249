"""Mixture-of-Experts FFN with sort-based, capacity-bounded token dispatch,
as ``repro.models.moe``: the router in float32, top-k gates renormalised,
the Switch/Mixtral load-balance aux loss, tokens sorted by expert (a stable
sort, so the order of tokens within an expert, and with it the tokens that
fit the capacity ``C``, is the reference's), the expert SwiGLU as one
batched product over ``[E, C, d]`` and the outputs combined by the gates.

The reference's no-mesh path. Its mesh path (``shard_map`` over the data
axes, ``moe.py:118-147`` in the JAX package) waits for the port's mesh.

Two choices keep the card's backward pass deterministic, so that a rerun
and a restored run give the same bits: every gather indexes distinct rows
(a token's K copies are an expand, whose backward is a sum, not a scatter
of repeated indices), and the combine adds no rows by atomics. The
reference's ``.at[st].add`` becomes: the rows back in token-major order
through the sort's inverse, ``[T, K, d]``, times the kept gates, summed
over K left to right. It parts from JAX's scatter-add only in the order of
the K float32 adds. The reference's ``.at[dest].set``, which sends every
dropped row to one discard slot, gives each dropped row its own spare row
past the ``E*C`` slots here, so that no index repeats; the
buffer and its gradient are the same. Nothing here waits on the card: the
kept rows are not picked out by a mask (which would read the mask back to
the host), but each dropped row is written to a spare row of its own.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """The router ``[d, E]`` (float32) and the stacked experts' SwiGLU
    ``w_gate``/``w_up`` ``[E, d, ff]`` and ``w_down`` ``[E, ff, d]``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init(generator, d, (d, E), torch.float32),
        "w_gate": dense_init(generator, d, (E, d, ff), dtype),
        "w_up": dense_init(generator, d, (E, d, ff), dtype),
        "w_down": dense_init(generator, ff, (E, ff, d), dtype),
    }


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert: ``capacity_factor * T * K / E`` truncated, rounded
    up to a multiple of 8, at least 8 (the reference's expression, term by
    term, so that it truncates alike)."""
    c = int(cfg.capacity_factor * n_tokens * cfg.experts_per_token / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _top_k(probs: torch.Tensor, k: int):
    """``(gate_vals, expert_ids)`` ``[T, k]``: each token's k largest router
    probabilities and their experts, largest first (``jax.lax.top_k``,
    whose order of exact ties, the lower index first, torch leaves
    unspecified; exact ties need degenerate inputs)."""
    return torch.topk(probs, k, dim=-1)


def _route_and_dispatch(router: torch.Tensor, cfg: ModelConfig, xf: torch.Tensor):
    """xf ``[T, d]`` -> (xe ``[E, C, d]``, meta, aux). ``meta`` is
    ``(dest, st, sg, order)``: the reference's slot, token and gate of each
    of the T*K assignments in expert order, and that order."""
    T, d = xf.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(xf.float() @ router, dim=-1)  # [T, E]
    gate_vals, expert_ids = _top_k(probs, K)  # [T, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(0)
    # one_hot by comparison (F.one_hot checks its input on the host)
    ce = (expert_ids[..., None] == torch.arange(E, device=xf.device)).float().sum(1).mean(0)
    aux = E * torch.sum(me * ce)

    C = _capacity(cfg, T)
    flat_expert = expert_ids.reshape(-1)  # [T*K]
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = torch.div(order, K, rounding_mode="floor")  # flat_token[order]
    sg = gate_vals.reshape(-1)[order]
    pos_in_expert = torch.arange(T * K, device=xf.device) - torch.searchsorted(se, se,
                                                                               side="left")
    keep = pos_in_expert < C
    dest = torch.where(keep, se * C + pos_in_expert, torch.full_like(se, E * C))

    # the K copies of each token, then expert order: every index distinct
    gathered = xf[:, None, :].expand(T, K, d).reshape(T * K, d)[order]
    # each kept row to its slot, each dropped row to a row of its own past
    # the E*C slots (cut off below): no index repeats, and no host sync to
    # pick the kept rows out
    rows = torch.where(keep, dest, E * C + torch.arange(T * K, device=xf.device))
    buf = torch.zeros((E * C + T * K, d), dtype=xf.dtype, device=xf.device)
    xe = buf.index_put((rows,), gathered)[:E * C].reshape(E, C, d)
    return xe, (dest, st, sg, order), aux


def _combine(cfg: ModelConfig, ye: torch.Tensor, meta, T: int) -> torch.Tensor:
    """ye ``[E, C, d]`` -> y ``[T, d]``: each token's K expert rows (a
    dropped one reads zeros) times its gates, summed over k = 0..K-1 in
    that order."""
    E, C, d = ye.shape
    K = cfg.experts_per_token
    dest, _, sg, order = meta
    ye_flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))], dim=0)
    slot_ok = dest < E * C
    contrib = ye_flat[dest] * (sg * slot_ok)[:, None].to(ye.dtype)  # [T*K, d], expert order
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    per_token = contrib[inverse].reshape(T, K, d)
    y = per_token[:, 0]
    for k in range(1, K):
        y = y + per_token[:, k]
    return y


def _expert_ffn(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """xe ``[..., E, C, d]`` -> ``[..., E, C, d]``: each expert's SwiGLU."""
    h = F.silu(torch.einsum("...ecd,edf->...ecf", xe, params["w_gate"]))
    h = h * torch.einsum("...ecd,edf->...ecf", xe, params["w_up"])
    return torch.einsum("...ecf,efd->...ecd", h, params["w_down"])


def moe_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                chunks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> (y ``[B, S, d]``, the aux loss). ``chunks > 1``
    dispatches each of ``chunks`` token chunks on its own (the reference's
    path without a mesh), the aux the mean over chunks."""
    B, S, d = x.shape
    T = B * S
    if chunks > 1:
        Tc = T // chunks
        xc = x.reshape(chunks, Tc, d).float()
        routed = [_route_and_dispatch(params["router"], cfg, xc[c]) for c in range(chunks)]
        ye = _expert_ffn(params, torch.stack([r[0] for r in routed]).to(x.dtype))
        y = torch.stack([_combine(cfg, ye[c].float(), routed[c][1], Tc)
                         for c in range(chunks)])
        aux = torch.stack([r[2] for r in routed]).mean()
        return y.reshape(B, S, d).to(x.dtype), aux

    xf = x.reshape(T, d).float()
    xe, meta, aux = _route_and_dispatch(params["router"], cfg, xf)
    ye = _expert_ffn(params, xe.to(x.dtype))
    y = _combine(cfg, ye.float(), meta, T)
    return y.reshape(B, S, d).to(x.dtype), aux
