"""Mamba-1 selective state-space block (falcon-mamba's and jamba's mamba
layers), as ``repro.models.ssm``. Training and prefill run the selective
scan over time; decode keeps an O(1) recurrent state (the conv ring and
the ``[d_inner, d_state]`` SSM state).

The reference's scan is XLA code (a ``lax.scan``, ``ssm.py:51-73``), which
XLA compiles into one loop on the device. On the CPU the port's is plain
torch, a Python loop over time, so the parity tests against the JAX package
compare like with like; on the card the port's counterpart of that one loop
is ``kernels.selective_scan`` (a CUDA kernel with a backward that
recomputes the states from checkpoints), since a Python loop there is
``S`` launches a layer and autograd would keep every step's state. The
associative variant (``associative=True``, any device) is a log-depth
doubling (Hillis-Steele) of the same composition, which the JAX package
computes with ``lax.associative_scan`` in another tree, so the two part by
float32 rounding. The scan runs in the span ``ssm.scan``.

Jamba's mixer (``configs.jamba.mamba_inner_norm``) norms ``dt``, ``B`` and
``C`` after ``x_proj`` with learned float32 weights (``dt_norm``,
``B_norm``, ``C_norm``), in training and decode alike.

Over the model axis (``tp``, a ``sharding.tensor_parallel.LMParallel``),
the rank's shards follow one of the two placements: ``trunk_specs`` (the
``make_split_mesh`` grids) shards only the input projections' ``d_inner``
columns, so u and z are gathered and the rest runs replicated;
``tree_specs`` (the production grids) also shards ``conv_w``, ``conv_b``,
``x_proj``'s rows, ``dt_proj``'s columns, ``dt_bias``, ``A_log`` and
``D`` over ``d_inner``, so the conv and the scan run on the rank's
channels, ``x_proj`` sums its partial products (one all-reduce), and the
gated output is gathered for the replicated ``out_proj``. The decode state
(``conv``, ``h``) shards its channels with them.

``softplus`` is torch's, which returns x itself above 20 where
``jax.nn.softplus`` computes ``log1p(exp(x))``; they differ there by at
most ``exp(-20)`` relative, 2e-9, below float32's resolution.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.tracing import span
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.jamba import mamba_inner_norm
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.sharding.collectives import copy_to, gather, reduce_from


def init_ssm(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """The block's weights in the reference's layout (the u and z input
    projections apart, ``[in, out]`` matrices), the reference's constants:
    ``dt_bias = log(expm1(0.01))``, ``A_log = log(1..d_state)`` a channel,
    ``D = 1``, in float32 (torch's ``log`` parts from XLA's by an ulp at
    some integers, so a parity test carries the reference's across the
    bridge). Jamba's inner norms' weights are float32 ones."""
    d, di, st, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    dev = generator.device
    A = torch.arange(1, st + 1, dtype=torch.float32, device=dev)[None, :].repeat(di, 1)
    params = {
        "in_proj_u": dense_init(generator, d, (d, di), dtype),
        "in_proj_z": dense_init(generator, d, (d, di), dtype),
        "conv_w": dense_init(generator, cfg.ssm_conv, (di, cfg.ssm_conv), dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(generator, di, (di, dtr + 2 * st), dtype),
        "dt_proj": dense_init(generator, dtr, (dtr, di), dtype),
        "dt_bias": torch.log(torch.expm1(torch.full((di,), 0.01, dtype=torch.float32,
                                                    device=dev))),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(generator, di, (di, d), dtype),
    }
    if mamba_inner_norm(cfg):
        for k, n in (("dt", dtr), ("B", st), ("C", st)):
            params[f"{k}_norm"] = torch.ones((n,), dtype=torch.float32, device=dev)
    return params


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x ``[B, S, di]``; w ``[di, K]``:
    ``out[t] = sum_k x[t-K+1+k] * w[:, k] + b``, the taps added in k's
    order."""
    K = w.shape[1]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + S, :] * w[None, None, :, k]
    return out + b


def _discretize(u, dt, B_t, A):
    """``dA = exp(dt * A)`` and ``dBu = dt * u * B``, ``[B, S, di, st]``."""
    dA = torch.exp(dt[..., None] * A[None, None])
    dBu = (dt * u)[..., None] * B_t[:, :, None, :]
    return dA, dBu


def _ssm_scan(u, dt, B_t, C_t, A, D):
    """Selective scan. u, dt ``[B, S, di]``; B_t, C_t ``[B, S, st]``; A
    ``[di, st]``: ``h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t``,
    ``y_t = h_t C_t + D u_t``, one step of time at a time. The inputs are
    unbound along time once, so each step's gradient comes back as one
    stacked tensor: indexing ``dA[:, t]`` a step would give every step a
    gradient of the whole ``[B, S, di, st]`` tensor, summed S times."""
    dA, dBu = _discretize(u, dt, B_t, A)
    h = torch.zeros(dA.shape[:1] + dA.shape[2:], dtype=torch.float32, device=u.device)
    ys = []
    for dA_t, dBu_t, C_tt in zip(dA.unbind(1), dBu.unbind(1), C_t.unbind(1)):
        h = dA_t * h + dBu_t
        ys.append(torch.einsum("bds,bs->bd", h, C_tt))
    return torch.stack(ys, dim=1) + u * D[None, None]


def _ssm_scan_associative(u, dt, B_t, C_t, A, D):
    """The parallel-prefix variant: ``h_t = a_t h_{t-1} + b_t`` composes as
    ``(a, b) . (a', b') = (a a', a' b + b')``; log2(S) doubling rounds,
    each combining every position with the one ``2^r`` before it."""
    a, b = _discretize(u, dt, B_t, A)
    S = a.shape[1]
    step = 1
    while step < S:
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        a_cur, b_cur = a[:, step:], b[:, step:]
        a = torch.cat([a[:, :step], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :step], a_cur * b_prev + b_cur], dim=1)
        step *= 2
    y = torch.einsum("bsdt,bst->bsd", b, C_t)
    return y + u * D[None, None]


def _dt_b_c(params: dict, cfg: ModelConfig, proj: torch.Tensor):
    """``x_proj``'s float32 output split into the softplus'd ``dt``
    ``[..., di]``, ``B`` and ``C`` ``[..., st]``, each of the three normed
    first where the config's mixer norms them."""
    dt, B_t, C_t = torch.split(proj, [cfg.dt_rank, cfg.ssm_state, cfg.ssm_state], dim=-1)
    if mamba_inner_norm(cfg):
        dt, B_t, C_t = (rms_norm(t, params[f"{k}_norm"], cfg.norm_eps)
                        for k, t in (("dt", dt), ("B", B_t), ("C", C_t)))
    return F.softplus(dt @ params["dt_proj"].float() + params["dt_bias"]), B_t, C_t


def _tp_mode(params: dict, cfg: ModelConfig, tp):
    """``None`` (whole), ``"gather"`` (only the input projections shard) or
    ``"channels"`` (every ``d_inner`` leaf shards)."""
    if tp is None or not tp.split(params["in_proj_u"].shape[1], cfg.d_inner):
        return None
    return "channels" if tp.split(params["conv_w"].shape[0], cfg.d_inner) else "gather"


def ssm_forward(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                associative: bool = False, tp=None) -> torch.Tensor:
    """x ``[B, S, d]`` -> ``[B, S, d]``: the projections in x's dtype, dt,
    B, C and the scan in float32 (on the card the kernel, whose state is
    float32, reads u in its dtype). ``tp``: see the module docstring."""
    mode = _tp_mode(params, cfg, tp)
    xin = x if mode is None else copy_to(x, tp.model)
    u = xin @ params["in_proj_u"]
    z = xin @ params["in_proj_z"]
    if mode == "gather":
        u, z = gather(u, tp.model, u.dim() - 1), gather(z, tp.model, z.dim() - 1)
    u = F.silu(_causal_conv(u, params["conv_w"], params["conv_b"]))
    proj = u @ params["x_proj"]
    if mode == "channels":  # x_proj row-parallel; B, C and dt feed the rank's channels
        proj = copy_to(reduce_from(proj, tp.model), tp.model)
    dt, B_t, C_t = _dt_b_c(params, cfg, proj.float())
    A = -torch.exp(params["A_log"])
    with span("ssm.scan"):
        if associative:
            y = _ssm_scan_associative(u.float(), dt, B_t, C_t, A, params["D"])
        elif u.is_cuda:  # the kernel reads a bfloat16 u as it is
            y = selective_scan(u if u.dtype == torch.bfloat16 else u.float(), dt, B_t, C_t, A,
                               params["D"])
        else:
            y = _ssm_scan(u.float(), dt, B_t, C_t, A, params["D"])
    out = y.to(x.dtype) * F.silu(z)
    if mode == "channels":
        out = gather(out, tp.model, out.dim() - 1)
    return out @ params["out_proj"]


# ------------------------------------------------------------------ decode
def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    """The conv ring ``[B, ssm_conv - 1, d_inner]`` (float32 unless
    ``dtype`` says otherwise, as the reference's default) and the float32
    state ``h`` ``[B, d_inner, d_state]``, zeros."""
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                             device=device)}


def ssm_decode_step(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    state: dict, tp=None) -> Tuple[torch.Tensor, dict]:
    """One token. x ``[B, 1, d]`` -> (``[B, 1, d]``, the new state);
    ``state`` is left as it was. ``tp``: the ``tree_specs`` placement (the
    state's channels shard with the weights'), forward only."""
    mode = _tp_mode(params, cfg, tp)
    if mode == "gather":
        raise ValueError("decode over the model axis takes the tree_specs placement, whose "
                         "d_inner leaves all shard")
    u = x[:, 0] @ params["in_proj_u"]  # [B, di] (the rank's channels)
    z = x[:, 0] @ params["in_proj_z"]
    conv_in = torch.cat([state["conv"], u[:, None, :].to(state["conv"].dtype)], dim=1)
    # the ring's dtype meets the weights' in the promoted type, as in jnp
    ring = torch.promote_types(conv_in.dtype, params["conv_w"].dtype)
    u_c = F.silu(torch.einsum("bkd,dk->bd", conv_in.to(ring), params["conv_w"].to(ring))
                 + params["conv_b"])
    new_conv = conv_in[:, 1:]
    proj = u_c @ params["x_proj"].to(u_c.dtype)
    if mode == "channels":
        proj = tp.model.all_reduce(proj)
    dt, B_t, C_t = _dt_b_c(params, cfg, proj.float())
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[..., None] * A[None])  # [B, di, st]
    h = dA * state["h"] + (dt * u_c.float())[..., None] * B_t[:, None, :]
    y = torch.einsum("bds,bs->bd", h, C_t) + u_c.float() * params["D"][None]
    out = (y.to(x.dtype) * F.silu(z))[:, None, :]
    if mode == "channels":
        out = tp.model.gather(out, 2)
    return out @ params["out_proj"], {"conv": new_conv, "h": h}
