"""The LM configurations' weights and tokens, made by the benchmark from
``--seed`` on the device (weights) and the host (tokens).

Weights: the tree is the port's canonical split state of a hybrid (Jamba)
model: ``client_banks`` (each hospital's embedding ``[V, d]`` and its first
``cut_layers`` blocks, a leading hospital axis on every leaf) and
``server`` (``prefix`` blocks up to the first whole period, ``groups`` of
one period with each position's leaves stacked ``[n_groups, ...]``,
``final_norm``, an untied ``lm_head`` ``[d, V]``); a block is
``attn_norm``/``attn`` (``wq``, ``wk``, ``wv``, ``wo``) or
``ssm_norm``/``ssm`` (``in_proj_u``, ``in_proj_z``, ``conv_w`` ``[di, K]``,
``conv_b``, ``x_proj``, ``dt_norm``, ``B_norm``, ``C_norm``, ``dt_proj``,
``dt_bias``, ``A_log``, ``D``, ``out_proj``), then ``ffn_norm``/``mlp``
(``w_gate``, ``w_up``, ``w_down``); dense matrices ``[in, out]``. Every
matrix is one standard-normal draw of one generator on the device, in the
tree's leaf order, times 1/sqrt(fan-in) (the embedding times 0.02), in the
configuration's dtype; the conv bias is 0 in that dtype; the float32
leaves are the port's constants (norms 1, ``A_log`` log(1..d_state), ``D``
1, ``dt_bias`` log(expm1(0.01))).

Tokens: each hospital's ``shard_rows`` windows of ``window`` tokens are
documents packed back to back, each ``eod_id`` then its tokens: lengths
lognormal (median ``doc_median``, log-sd ``doc_sigma``, at least 1),
token ids uniform over the vocabulary but ``eod_id``, from a numpy
generator of ``(seed word, hospital)``; no mask between documents.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from perfbench.weights import seed_word

WEIGHTS_TAG, TOKENS_TAG = 7, 13


def period(cfg: dict) -> int:
    return cfg["attn_layer_period"]


def split_layers(cfg: dict):
    """``(client, prefix, groups)``: the layer indices of the client's
    blocks, the server's prefix blocks, and each server group's."""
    cut, p, n = cfg["cut_layers"], period(cfg), cfg["num_hidden_layers"]
    start = -(-cut // p) * p
    if (n - start) % p:
        raise ValueError("the layers after the first period boundary are not whole periods")
    return (list(range(cut)), list(range(cut, start)),
            [list(range(g, g + p)) for g in range(start, n, p)])


def is_attention(cfg: dict, i: int) -> bool:
    return i % period(cfg) == cfg["attn_layer_offset"]


def _block_spec(cfg: dict, i: int) -> dict:
    """A block's leaves as ``(shape, how)``: ``("normal", fan_in)``,
    ``("const", name)``."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    di, st = cfg["mamba_expand"] * d, cfg["mamba_d_state"]
    dtr, K = cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // H
    w = lambda *shape: (shape, ("normal", shape[0]))  # noqa: E731
    ones = lambda n: ((n,), ("const", "ones"))  # noqa: E731
    spec = {"ffn_norm": ones(d), "mlp": {"w_gate": w(d, ff), "w_up": w(d, ff),
                                         "w_down": w(ff, d)}}
    if is_attention(cfg, i):
        spec["attn_norm"] = ones(d)
        spec["attn"] = {"wq": w(d, H * hd), "wk": w(d, KV * hd), "wv": w(d, KV * hd),
                        "wo": w(H * hd, d)}
    else:
        spec["ssm_norm"] = ones(d)
        spec["ssm"] = {"in_proj_u": w(d, di), "in_proj_z": w(d, di),
                       "conv_w": ((di, K), ("normal", K)), "conv_b": ((di,), ("const", "zeros")),
                       "x_proj": w(di, dtr + 2 * st), "dt_norm": ones(dtr), "B_norm": ones(st),
                       "C_norm": ones(st), "dt_proj": w(dtr, di), "out_proj": w(di, d),
                       "dt_bias": ((di,), ("const", "dt_bias")),
                       "A_log": ((di, st), ("const", "A_log")), "D": ones(di)}
    return spec


def _stacked(spec, n: int):
    if isinstance(spec, dict):
        return {k: _stacked(v, n) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_stacked(v, n) for v in spec]
    return ((n,) + spec[0], spec[1])


def tree_spec(cfg: dict, n_clients: int) -> dict:
    """The whole state's leaves as ``(shape, how)``."""
    client, prefix, groups = split_layers(cfg)
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    bank = {"embed": ((V, d), ("embed", None)), "blocks": [_block_spec(cfg, i) for i in client]}
    server = {"prefix": [_block_spec(cfg, i) for i in prefix],
              "final_norm": ((d,), ("const", "ones")), "lm_head": ((d, V), ("normal", d))}
    if groups:
        server["groups"] = {f"pos{p}": _stacked(_block_spec(cfg, i), len(groups))
                            for p, i in enumerate(groups[0])}
    return {"client_banks": _stacked(bank, n_clients), "server": server}


def _const(name: str, shape, st_axis_len: int, device) -> torch.Tensor:
    if name == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if name == "dt_bias":
        return torch.full(shape, math.log(math.expm1(0.01)), dtype=torch.float32,
                          device=device)
    if name == "A_log":
        return torch.log(torch.arange(1, st_axis_len + 1, dtype=torch.float32,
                                      device=device)).expand(shape).contiguous()
    raise ValueError(name)


def make_weights(cfg: dict, seed: int, device, n_clients: int) -> dict:
    """``{"client_banks": ..., "server": ...}``, drawn on ``device`` from
    ``seed``, leaf by leaf in the order of ``weights.leaves``."""
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_word(seed, WEIGHTS_TAG))

    def make(node):
        if isinstance(node, dict):
            return {k: make(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [make(v) for v in node]
        shape, (how, arg) = node
        if how in ("normal", "embed"):
            scale = 0.02 if how == "embed" else 1.0 / math.sqrt(arg)
            t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
            return t.mul_(scale).to(dtype)
        if arg == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        return _const(arg, shape, cfg["mamba_d_state"], device)

    return make(tree_spec(cfg, n_clients))


def make_tokens(mix: dict, cfg: dict, seed: int, n_clients: int) -> List[np.ndarray]:
    """Each hospital's ``[shard_rows, window]`` int32 token windows."""
    n, S, V = mix["shard_rows"], mix["window"], cfg["vocab_size"]
    eod = mix["eod_id"]
    out = []
    for c in range(n_clients):
        rng = np.random.default_rng((seed_word(seed, TOKENS_TAG), c))
        need, parts = n * S, []
        while need > 0:
            L = max(1, int(rng.lognormal(math.log(mix["doc_median"]), mix["doc_sigma"])))
            ids = rng.integers(0, V - 1, size=L)
            ids = ids + (ids >= eod)  # every id but eod
            parts.append(np.concatenate([[eod], ids]))
            need -= L + 1
        out.append(np.concatenate(parts)[:n * S].astype(np.int32).reshape(n, S))
    return out
