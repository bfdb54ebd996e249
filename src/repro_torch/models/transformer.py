"""The decoder/encoder stack of every family, as
``repro.models.transformer``:

  dense  : [attn + SwiGLU] x L
  moe    : [attn + MoE] x L (granite, mixtral)
  ssm    : [mamba1] x L (falcon-mamba)
  hybrid : period groups of one attention and mamba layers, each with an
           FFN, MoE every ``moe_period``-th layer (jamba)
  audio  : encoder-only (bidirectional) attention over stub frame
           embeddings (hubert)
  vlm    : the dense decoder over stub patch embeddings + tokens (internvl2)

The layout is the reference's, so ``common.bridge.to_torch`` carries its
parameters over unchanged: dense weights ``[in, out]``, the client
(embedding + the first ``cut_layers`` blocks, the paper's privacy-preserving
layer) and the server (``prefix`` blocks, the scanned ``groups`` with every
leaf stacked ``[n_groups, ...]`` under ``pos{p}``, the final norm and an
untied head). The reference scans the groups; here a Python loop over g
indexes the stacked leaves, so autograd accumulates into the stacked
tensors; with ``ModelOptions.remat`` each group's body runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
scanned body), so a group's activations are recomputed in the backward
pass.

The reference's sharding annotations are GSPMD constraints; here ``tp``
(a ``sharding.tensor_parallel.LMParallel``) carries the model axis, and
the functions take the rank's shards of the parameters (and of a decode
state): each block runs its layers tensor-parallel, the embedding looks
up the rank's vocab rows and the head leaves the logits vocab-sharded
(``LMParallel.cross_entropy`` takes them as they are). Without ``tp`` the
path is the unsharded one, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.tree import tree_map
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import dense_init, embed_init, init_swiglu, rms_norm, swiglu

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Execution knobs (perf levers); the model's math is the same across
    their values: ``associative_scan`` (the SSM's parallel-prefix scan, its
    sums in another order), ``remat`` (each group recomputed in the
    backward pass; the same gradient, bit for bit) and ``moe_chunks`` (each
    of that many token chunks dispatched on its own, as the reference's
    path without a mesh)."""

    q_block: int = 1024
    kv_block: int = 1024
    skip_masked_blocks: bool = False  # causal two-phase FLOP skip (fwd-only)
    bf16_probs: bool = False  # bf16 attention probabilities for the PV matmul
    associative_scan: bool = False  # parallel-prefix SSM scan
    remat: bool = False  # checkpoint each group in the backward pass
    detach_cut: bool = True  # the paper's temporal split: no grads into the client
    logits_f32: bool = True
    moe_chunks: int = 1  # per-chunk MoE dispatch


# ---------------------------------------------------------------- structure
def period_of(cfg: ModelConfig) -> int:
    p = 1
    if cfg.family == "hybrid":
        p = cfg.attn_period
    if cfg.n_experts > 0:
        p = (max(p, cfg.moe_period) if p % cfg.moe_period == 0 or cfg.moe_period % p == 0
             else p * cfg.moe_period)
    return p


def stack_split(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_client, n_prefix, n_groups): client blocks, unrolled server prefix
    blocks, and whole groups of ``period_of(cfg)`` blocks."""
    period = period_of(cfg)
    cut = cfg.cut_layers
    start = -(-cut // period) * period  # the first group boundary at or after the cut
    n_groups, rem = divmod(cfg.n_layers - start, period)
    if rem:
        raise ValueError(f"{cfg.name}: layers {cfg.n_layers} not group-aligned")
    return cut, start - cut, n_groups


# ------------------------------------------------------------------- init
def init_block(generator: torch.Generator, cfg: ModelConfig, layer_idx: int,
               dtype: torch.dtype) -> Dict[str, Any]:
    """Global layer ``layer_idx``'s block: attention or a mamba mixer by
    ``cfg.layer_kind``, then an FFN where the reference has one (every
    attention layer, and every hybrid layer, with ``d_ff > 0``), a MoE where
    ``cfg.layer_is_moe``."""
    dev = generator.device
    ones = lambda: torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)  # noqa: E731
    kind = cfg.layer_kind(layer_idx)
    p: Dict[str, Any] = {}
    if kind == "attn":
        p["attn_norm"] = ones()
        p["attn"] = attn_mod.init_attention(generator, cfg, dtype)
    else:
        p["ssm_norm"] = ones()
        p["ssm"] = ssm_mod.init_ssm(generator, cfg, dtype)
    if (kind == "attn" or cfg.family == "hybrid") and cfg.d_ff > 0:
        p["ffn_norm"] = ones()
        if cfg.layer_is_moe(layer_idx):
            p["moe"] = moe_mod.init_moe(generator, cfg, dtype)
        else:
            p["mlp"] = init_swiglu(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def _dtype_of(cfg: ModelConfig, dtype) -> torch.dtype:
    return dtype if dtype is not None else getattr(torch, cfg.dtype)


def init_client(generator: torch.Generator, cfg: ModelConfig, dtype=None, device=None) -> dict:
    """The client half: the embedding and the first ``cut_layers`` blocks,
    drawn from ``generator`` on its device and placed on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    dtype = _dtype_of(cfg, dtype)
    n_client, _, _ = stack_split(cfg)
    client = {"embed": embed_init(generator, (cfg.vocab_size, cfg.d_model), dtype).to(device),
              "blocks": []}
    for i in range(n_client):
        client["blocks"].append(tree_map(lambda t: t.to(device),
                                         init_block(generator, cfg, i, dtype)))
    return client


def init_server(generator: torch.Generator, cfg: ModelConfig, dtype=None, device=None) -> dict:
    """The server half: the prefix blocks, the stacked groups, the final
    norm and (untied configs) the head."""
    device = resolve_device(device)
    dtype = _dtype_of(cfg, dtype)
    n_client, n_prefix, n_groups = stack_split(cfg)
    period = period_of(cfg)
    to_dev = lambda tree: tree_map(lambda t: t.to(device), tree)  # noqa: E731
    server: Dict[str, Any] = {
        "prefix": [to_dev(init_block(generator, cfg, n_client + j, dtype))
                   for j in range(n_prefix)],
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        server["lm_head"] = dense_init(generator, cfg.d_model, (cfg.d_model, cfg.vocab_size),
                                       dtype).to(device)
    start = n_client + n_prefix
    if n_groups > 0:
        groups = [to_dev({f"pos{p}": init_block(generator, cfg, start + p, dtype)
                          for p in range(period)}) for _ in range(n_groups)]
        server["groups"] = tree_map(lambda *xs: torch.stack(xs), *groups)
    return server


def init_params(generator: torch.Generator, cfg: ModelConfig, dtype=None, device=None) -> dict:
    """Random weights from ``generator``: the client half, then the server
    half. The draws are the port's own; a parity test takes the
    reference's parameters through ``common.bridge.to_torch``."""
    return {"client": init_client(generator, cfg, dtype, device),
            "server": init_server(generator, cfg, dtype, device)}


# ------------------------------------------------------------------ blocks
def _ffn_tp(blk: dict, cfg: ModelConfig, tp):
    """``tp`` where the SwiGLU's ``d_ff`` is this rank's chunk, else None."""
    if tp is None or not tp.split(blk["mlp"]["w_gate"].shape[1], cfg.d_ff):
        return None
    return tp


def apply_block(blk: dict, cfg: ModelConfig, layer_idx: int, h: torch.Tensor,
                positions: torch.Tensor, opts: ModelOptions, tp=None):
    """Training/prefill block. Returns (h, moe_aux_loss), the aux 0 without
    a MoE. ``tp``: the rank's shards over the model axis."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.layer_kind(layer_idx) == "attn":
        a = attn_mod.attention_forward(
            blk["attn"], cfg, rms_norm(h, blk["attn_norm"], cfg.norm_eps), positions,
            q_block=opts.q_block, kv_block=opts.kv_block,
            skip_masked_blocks=opts.skip_masked_blocks, bf16_probs=opts.bf16_probs, tp=tp)
        h = h + a
    else:
        h = h + ssm_mod.ssm_forward(blk["ssm"], cfg, rms_norm(h, blk["ssm_norm"], cfg.norm_eps),
                                    associative=opts.associative_scan, tp=tp)
    if "mlp" in blk:
        h = h + swiglu(blk["mlp"], rms_norm(h, blk["ffn_norm"], cfg.norm_eps),
                       _ffn_tp(blk, cfg, tp))
    elif "moe" in blk:
        y, aux = moe_mod.moe_forward(blk["moe"], cfg, rms_norm(h, blk["ffn_norm"], cfg.norm_eps),
                                     chunks=opts.moe_chunks, tp=tp)
        h = h + y
    return h, aux


def apply_block_decode(blk: dict, cfg: ModelConfig, layer_idx: int, h: torch.Tensor,
                       state: dict, pos: int, tp=None):
    """One-token decode block. Returns (h, new_state). ``tp``: the rank's
    shards of the block and of its state."""
    if cfg.layer_kind(layer_idx) == "attn":
        a, new_inner = attn_mod.decode_attention(
            blk["attn"], cfg, rms_norm(h, blk["attn_norm"], cfg.norm_eps), state["attn"], pos,
            tp=tp)
        new_state = {**state, "attn": new_inner}
    else:
        a, new_inner = ssm_mod.ssm_decode_step(
            blk["ssm"], cfg, rms_norm(h, blk["ssm_norm"], cfg.norm_eps), state["ssm"], tp=tp)
        new_state = {**state, "ssm": new_inner}
    h = h + a
    if "mlp" in blk:
        h = h + swiglu(blk["mlp"], rms_norm(h, blk["ffn_norm"], cfg.norm_eps),
                       _ffn_tp(blk, cfg, tp))
    elif "moe" in blk:
        y, _ = moe_mod.moe_forward(blk["moe"], cfg, rms_norm(h, blk["ffn_norm"], cfg.norm_eps),
                                   tp=None if tp is None else tp.model_only())
        h = h + y
    return h, new_state


def _per_group(groups: dict) -> list:
    """The stacked ``[n_groups, ...]`` groups as one tree of views a group.
    Each leaf is unbound once, so its gradient comes back as one stacked
    tensor, not one full-size tensor a group."""
    unbound = {k: _per_group(v) if isinstance(v, dict) else v.unbind(0)
               for k, v in groups.items()}
    n = len(next(iter(unbound.values())))
    return [{k: v[g] for k, v in unbound.items()} for g in range(n)]


def positions_for(B: int, S: int, device) -> torch.Tensor:
    """``[B, S]`` int32 positions 0..S-1: a function of the shape alone, so
    each side of the cut recomputes them and only features cross it."""
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


# ------------------------------------------------------------------ embed
def _lookup(embed: torch.Tensor, cfg: ModelConfig, tokens: torch.Tensor, tp) -> torch.Tensor:
    return embed[tokens.long()] if tp is None else tp.embed(embed, tokens, cfg.vocab_size)


def embed_inputs(params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor], tp=None):
    """Token / stub-frontend embedding. Returns (h [B, S, d], positions [B, S]).
    ``tp``: the embedding's rows may be the rank's vocab chunk."""
    embed = params["client"]["embed"]
    if cfg.frontend == "audio_frames":
        h = batch["frame_embeds"].to(embed.dtype)
    elif cfg.frontend == "vision_patches":
        tok = _lookup(embed, cfg, batch["tokens"], tp)
        h = torch.cat([batch["patch_embeds"].to(embed.dtype), tok], dim=1)
    else:
        h = _lookup(embed, cfg, batch["tokens"], tp)
    B, S = h.shape[:2]
    return h, positions_for(B, S, h.device)


def privacy_cut(cfg: ModelConfig, h: torch.Tensor, opts: ModelOptions,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paper's privacy boundary: ``privacy_noise`` times the standard
    normal ``noise`` of h's shape (the reference draws it from a key; here
    it is an input, ``None``: none), then the temporal split's detach."""
    if cfg.privacy_noise > 0.0 and noise is not None:
        h = h + cfg.privacy_noise * noise.to(h.dtype)
    if opts.detach_cut:
        h = h.detach()
    return h


# ----------------------------------------------------------------- forward
def client_forward(client_params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   opts: ModelOptions = ModelOptions(), noise: Optional[torch.Tensor] = None,
                   tp=None):
    """The hospital side: embedding + privacy-preserving block(s) + cut.
    Returns (feature_map [B, S, d], positions, client_moe_aux): the feature
    map is the only tensor that crosses the trust boundary. ``tp``: the
    rank's shards of the bank over the model axis."""
    h, positions = embed_inputs({"client": client_params}, cfg, batch, tp)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, blk in enumerate(client_params["blocks"]):
        h, a = apply_block(blk, cfg, i, h, positions, opts, tp)
        aux = aux + a
    h = privacy_cut(cfg, h, opts, noise)
    if opts.detach_cut:
        aux = aux.detach()
    return h, positions, aux


def _head(h: torch.Tensor, head: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """``h @ head``; over the model axis a vocab-sharded head gives the
    rank's vocab chunk of the logits."""
    if tp is not None and tp.split(head.shape[1], cfg.vocab_size):
        return tp.col(h, head)
    return h @ head


def server_forward(server_params: dict, cfg: ModelConfig, h: torch.Tensor,
                   positions: torch.Tensor, opts: ModelOptions = ModelOptions(),
                   tied_embed: Optional[torch.Tensor] = None, tp=None):
    """The server side: the remaining blocks and the head. Returns
    (logits, moe_aux). ``tp``: the rank's shards of the trunk; the logits
    are then the rank's vocab chunk where the head shards."""
    n_client, n_prefix, n_groups = stack_split(cfg)
    period = period_of(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for j, blk in enumerate(server_params["prefix"]):
        h, a = apply_block(blk, cfg, n_client + j, h, positions, opts, tp)
        aux = aux + a
    start = n_client + n_prefix

    def group_body(hh, aa, grp):
        for p in range(period):
            hh, a = apply_block(grp[f"pos{p}"], cfg, start + p, hh, positions, opts, tp)
            aa = aa + a
        return hh, aa

    for grp in (_per_group(server_params["groups"]) if n_groups > 0 else []):
        if opts.remat:
            h, aux = checkpoint(group_body, h, aux, grp, use_reentrant=False)
        else:
            h, aux = group_body(h, aux, grp)
    h = rms_norm(h, server_params["final_norm"], cfg.norm_eps)
    head = tied_embed.T if cfg.tie_embeddings else server_params["lm_head"]
    logits = _head(h, head, cfg, tp)
    if opts.logits_f32:
        logits = logits.float()
    return logits, aux


def forward(params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            opts: ModelOptions = ModelOptions(), noise: Optional[torch.Tensor] = None, tp=None):
    """Full forward (train/prefill). Returns (logits [B, S, V], moe_aux);
    with ``tp`` the logits are the rank's vocab chunk where the head shards."""
    h, positions, aux_c = client_forward(params["client"], cfg, batch, opts, noise, tp)
    # whole-model convenience for single-trust-domain use; split
    # deployments go through SplitSession, which guards the cut
    logits, aux_s = server_forward(  # splitlint: ignore[SPL101]
        params["server"], cfg, h, positions, opts,
        tied_embed=params["client"]["embed"] if cfg.tie_embeddings else None, tp=tp)
    return logits, aux_c + aux_s


# ------------------------------------------------------------------ decode
def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                      device=None) -> dict:
    """The per-layer decode state, laid out as the client/prefix/groups
    split (the groups' stacked ``[n_groups, ...]``), on ``device``
    (``None``: the card): ``{"attn": KV cache of dtype}`` for an attention
    layer, ``{"ssm": init_ssm_state}`` for a mamba layer (its conv ring
    float32 whatever ``dtype``, as the reference's)."""
    device = resolve_device(device)
    n_client, n_prefix, n_groups = stack_split(cfg)
    period = period_of(cfg)

    def layer(i):
        if cfg.layer_kind(i) == "attn":
            return {"attn": attn_mod.init_kv_cache(cfg, batch, max_seq, dtype, device)}
        return {"ssm": ssm_mod.init_ssm_state(cfg, batch, device=device)}

    start = n_client + n_prefix
    state: Dict[str, Any] = {"client": [layer(i) for i in range(n_client)],
                             "prefix": [layer(n_client + j) for j in range(n_prefix)]}
    if n_groups > 0:
        state["groups"] = tree_map(
            lambda x: x[None].expand((n_groups,) + tuple(x.shape)).contiguous(),
            {f"pos{p}": layer(start + p) for p in range(period)})
    return state


def decode_step(params: dict, cfg: ModelConfig, state: dict, tokens: torch.Tensor, pos: int,
                opts: ModelOptions = ModelOptions(), tp=None):
    """One decode step. tokens: [B, 1] integers; ``pos`` the step's
    position. Returns (logits [B, 1, V] float32, new_state); ``state`` is
    left as it was. ``tp``: the rank's shards of the parameters and of the
    state (the logits then the rank's vocab chunk where the head shards);
    ``tp.fetch``, where set, gives each block's weights as the blocks take
    them (the 2-D weight placement gathers them there)."""
    n_client, n_prefix, n_groups = stack_split(cfg)
    period = period_of(cfg)
    fetch = (lambda sub, path, g=None: sub if g is None else tree_map(lambda a: a[g], sub)) \
        if tp is None or tp.fetch is None else tp.fetch
    client = fetch({k: v for k, v in params["client"].items() if k != "blocks"}, "client")
    h = _lookup(client["embed"], cfg, tokens, tp)
    new_state: Dict[str, Any] = {"client": [], "prefix": []}
    for i, blk in enumerate(params["client"]["blocks"]):
        h, s = apply_block_decode(fetch(blk, f"client/blocks/{i}"), cfg, i, h,
                                  state["client"][i], pos, tp)
        new_state["client"].append(s)
    h = privacy_cut(cfg, h, opts, None)
    for j, blk in enumerate(params["server"]["prefix"]):
        h, s = apply_block_decode(fetch(blk, f"server/prefix/{j}"), cfg, n_client + j, h,
                                  state["prefix"][j], pos, tp)
        new_state["prefix"].append(s)
    start = n_client + n_prefix
    if n_groups > 0:
        group_states = []
        for g in range(n_groups):
            grp = fetch(params["server"]["groups"], "server/groups", g)
            st = tree_map(lambda a, g=g: a[g], state["groups"])
            new_st = {}
            for p in range(period):
                h, new_st[f"pos{p}"] = apply_block_decode(grp[f"pos{p}"], cfg, start + p, h,
                                                          st[f"pos{p}"], pos, tp)
            group_states.append(new_st)
        new_state["groups"] = tree_map(lambda *xs: torch.stack(xs), *group_states)
    server = fetch({k: v for k, v in params["server"].items()
                    if k not in ("prefix", "groups")}, "server")
    h = rms_norm(h, server["final_norm"], cfg.norm_eps)
    head = client["embed"].T if cfg.tie_embeddings else server["lm_head"]
    return _head(h, head, cfg, tp).float(), new_state
