"""Operations and bytes of the LM configurations from their shapes: the
yardstick of the LM cells' mfu and roofline metrics (``work.py`` holds the
H100's peaks and the CNNs').

Model operations (``lm_train_flops``): the multiply-adds of every matrix
product (2 operations each) and of attention's two products over the
causal keys, counted once for the forward and twice for the backward (the
weight and the input gradients) of each trunk block and of the head, and
once for the client's forward; the recompute of a checkpointed block is not
counted, nor elementwise work, the scan's included. So the mfu read from
it is of the model's matrix work.

The scan's least bytes (``scan_forward_bytes``, ``scan_backward_bytes``):
each input read once and each output written once, the checkpoints the
forward writes for the backward among the outputs (the backward's partial
sums over channel tiles are the design's, not counted). The release's
(``release_bytes``): x and the noise read once, the release written once,
each in its own type.
"""
from __future__ import annotations

import math
from typing import Sequence

from perfbench.weights_lm import split_layers

CHECKPOINT_STEPS = 32  # the backward's chunk of time: a checkpoint every 32 steps
L2_BYTES = 50e6  # an H100's L2: a release smaller than this may read from it


def _widths(cfg: dict):
    d = cfg["hidden_size"]
    return (d, cfg["intermediate_size"], cfg["mamba_expand"] * d, cfg["mamba_d_state"],
            cfg["mamba_dt_rank"], cfg["num_attention_heads"], cfg["num_key_value_heads"],
            d // cfg["num_attention_heads"], cfg["vocab_size"])


def layer_flops_per_token(cfg: dict, i: int, seq: int) -> float:
    """Forward operations of one token through layer ``i`` at ``seq``
    tokens a window (attention's keys: the causal mean, (seq + 1) / 2)."""
    d, ff, di, st, dtr, H, KV, hd, _ = _widths(cfg)
    mlp = 2 * 3 * d * ff
    if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]:
        proj = 2 * d * (H + 2 * KV) * hd + 2 * H * hd * d
        return mlp + proj + 2 * 2 * H * hd * (seq + 1) / 2
    K = cfg["mamba_d_conv"]
    return mlp + 2 * (2 * d * di + di * (dtr + 2 * st) + dtr * di + di * d + K * di)


def lm_train_flops(cfg: dict, rows: int, seq: int) -> float:
    """Model operations of one detached training step over ``rows`` windows
    of ``seq`` tokens."""
    client, prefix, groups = split_layers(cfg)
    trunk = prefix + [i for g in groups for i in g]
    tokens = rows * seq
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    fwd_client = sum(layer_flops_per_token(cfg, i, seq) for i in client)
    fwd_trunk = sum(layer_flops_per_token(cfg, i, seq) for i in trunk) + head
    return tokens * (fwd_client + 3 * fwd_trunk)


def scan_forward_bytes(Bsz: int, S: int, di: int, st: int, u_bytes: int,
                       checkpoints: bool) -> float:
    """u, dt, B, C, A and D read, y (and the checkpoints) written."""
    n = Bsz * S * di
    out = 4 * n + (4 * Bsz * math.ceil(S / CHECKPOINT_STEPS) * di * st if checkpoints else 0)
    return u_bytes * n + 4 * n + 4 * 2 * Bsz * S * st + 4 * (di * st + di) + out


def scan_backward_bytes(Bsz: int, S: int, di: int, st: int, u_bytes: int) -> float:
    """u, dt, dy, B, C, A, D and the checkpoints read; du, d(dt), dB, dC,
    dA and dD written."""
    n = Bsz * S * di
    ck = 4 * Bsz * math.ceil(S / CHECKPOINT_STEPS) * di * st
    reads = u_bytes * n + 4 * n + 4 * n + 4 * 2 * Bsz * S * st + 4 * (di * st + di) + ck
    writes = u_bytes * n + 4 * n + 4 * 2 * Bsz * S * st + 4 * (di * st + di)
    return reads + writes


def release_bytes(shape: Sequence[int], x_bytes: int, noise_bytes: int) -> float:
    n = math.prod(shape)
    return n * (2 * x_bytes + noise_bytes)

# NVIDIA H100 SXM data sheet, dense bf16, at the 700 W limit
PEAK_BF16_FLOPS_PER_S = 989e12
