"""The plain reference of AI21-Jamba2-3B's split training, in plain PyTorch,
written from the model's description (arXiv:2403.19887; the HF ``jamba``
layers named in the configuration's ``source``) and not from the program's
code.

The model: a token embedding; ``num_hidden_layers`` blocks, each an
RMSNorm, a mixer and a residual, then an RMSNorm, a SwiGLU MLP and a
residual; a final RMSNorm and the head. Block i's mixer is attention iff
``i % attn_layer_period == attn_layer_offset``, else Mamba-1:

    u, z = x W_u, x W_z
    u = silu(causal depthwise conv of u (d_conv taps) + conv bias)
    dt, B, C = split(u W_x); each through its own RMSNorm (learned weights)
    dt = softplus(dt W_dt + dt bias);  A = -exp(A_log)
    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t;  y_t = h_t C_t + D u_t
    out = (y * silu(z)) W_out

Attention: GQA (head h reads kv head h // (heads / kv heads)), causal, no
positional encoding, softmax of q k^T / sqrt(head_dim). The split, as the
configuration states it: hospital c runs the embedding and the first
``cut_layers`` blocks with its own weights, adds ``privacy_noise`` times its
model noise, and the guard clips each window (all its positions and
features) to L2 norm ``clip_norm`` and adds sigma times the guard noise; no
gradient crosses the cut. The trunk's loss is the mean next-token cross
entropy over every window's positions but the last. The optimizer is
AdamW without weight decay after a global-norm clip, computed in float32
(float32 moments); the weights stay in the types the configuration gives
them (bfloat16 matrices beside float32 norms and SSM constants), each new
weight rounded to its type, and a weight's gradient comes back in its type
(the cast in the forward rounds it).

Memory: the trunk runs each block under ``torch.utils.checkpoint`` (its
input kept, the block recomputed in the backward), the scan in chunks of
``scan_chunk`` steps with its gradient written out (``Scan``: a chunk's
states recomputed from its first in the backward; checked against
autograd of the plain loop in the CPU tests), attention ``q_chunk`` query rows at a time and the head with
the loss ``ce_rows`` positions at a time, each recomputed in the backward;
so it fits beside float32 weights, gradients and moments once the
program's state is freed.

``dtype`` is the precision the model is computed in: float32, the
reference, or bfloat16, the control: everything the configuration keeps in
float32 (the scan's state, the norms, the logits and the loss) in bfloat16
too; the optimizer stays float32 either way.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def leaves(tree) -> List[torch.Tensor]:
    """Leaves with dict keys sorted and lists in order (the optimizer's
    flat order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


class Scan(torch.autograd.Function):
    """``y_t = h_t C_t`` with ``h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t`` from
    ``h_{-1} = 0``, one step at a time, with its gradient written out (the
    recurrence's adjoint), so that no autograd node is made a step. u, dt
    ``[B, S, di]``; B, C ``[B, S, st]``; A ``[di, st]``. The forward keeps
    the state entering every ``chunk`` steps; the backward walks the chunks
    from the last, recomputes a chunk's states from its first, then
    carries ``g_t = dL/dh_t = C_t dy_t + exp(dt_{t+1} A) g_{t+1}`` back
    through it:

        dC_t = sum_d h_t dy_t                   dB_t = sum_d g_t dt_t u_t
        x_t = sum_s g_t B_t                     du_t = x_t dt_t
        z_t = g_t h_{t-1} exp(dt_t A)           d(dt_t) = x_t u_t + sum_s z_t A
        dA = sum_{b,t} z_t dt_t
    """

    @staticmethod
    def _chunk(u, dt, Bm, A, h, n):
        """The chunk's decays, drives and states ``[B, n, di, st]``."""
        decay = torch.exp(dt[..., None] * A)
        drive = (dt * u)[..., None] * Bm[:, :, None, :]
        hs = []
        for j in range(n):
            h = torch.addcmul(drive[:, j], decay[:, j], h)
            hs.append(h)
        return decay, torch.stack(hs, dim=1)

    @staticmethod
    def forward(ctx, u, dt, Bm, Cm, A, chunk: int):
        Bsz, S, di = u.shape
        h = torch.zeros((Bsz, di, A.shape[1]), dtype=u.dtype, device=u.device)
        starts, ys = [], []
        for t0 in range(0, S, chunk):
            c = slice(t0, t0 + chunk)
            starts.append(h)
            _, hs = Scan._chunk(u[:, c], dt[:, c], Bm[:, c], A, h, u[:, c].shape[1])
            ys.append(torch.einsum("btds,bts->btd", hs, Cm[:, c]))
            h = hs[:, -1]
        ctx.chunk = chunk
        ctx.save_for_backward(u, dt, Bm, Cm, A, *starts)
        return torch.cat(ys, dim=1)

    @staticmethod
    def backward(ctx, dy):
        u, dt, Bm, Cm, A, *starts = ctx.saved_tensors
        chunk, S = ctx.chunk, u.shape[1]
        du, ddt = torch.empty_like(u), torch.empty_like(dt)
        dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
        dA = torch.zeros_like(A)
        carry = torch.zeros_like(starts[0])
        for k in reversed(range(len(starts))):
            c = slice(k * chunk, min(S, (k + 1) * chunk))
            uc, dtc, Bc, Cc, dyc = u[:, c], dt[:, c], Bm[:, c], Cm[:, c], dy[:, c]
            n = uc.shape[1]
            decay, hs = Scan._chunk(uc, dtc, Bc, A, starts[k], n)
            prev = torch.cat([starts[k][:, None], hs[:, :-1]], dim=1)
            gs = [None] * n
            for j in reversed(range(n)):
                g = torch.addcmul(carry, dyc[:, j, :, None], Cc[:, j, None, :])
                gs[j] = g
                carry = decay[:, j] * g
            g = torch.stack(gs, dim=1)
            z = g * prev * decay
            x = torch.einsum("btds,bts->btd", g, Bc)
            dC[:, c] = torch.einsum("btds,btd->bts", hs, dyc)
            dB[:, c] = torch.einsum("btds,btd->bts", g, dtc * uc)
            dA += torch.einsum("btds,btd->ds", z, dtc)
            ddt[:, c] = x * uc + torch.einsum("btds,ds->btd", z, A)
            du[:, c] = x * dtc
        return du, ddt, dB, dC, dA, None


class Jamba:
    """The model's layers computed in ``dtype``; ``cfg`` is the
    configuration file's dict (the HF ``config.json`` keys)."""

    def __init__(self, cfg: dict, dtype: torch.dtype = torch.float32, scan_chunk: int = 64,
                 q_chunk: int = 512, ce_rows: int = 4096):
        self.cfg, self.dtype = cfg, dtype
        self.d = cfg["hidden_size"]
        self.di = cfg["mamba_expand"] * self.d
        self.st = cfg["mamba_d_state"]
        self.dtr = cfg["mamba_dt_rank"]
        self.heads = cfg["num_attention_heads"]
        self.kv = cfg["num_key_value_heads"]
        self.hd = self.d // self.heads
        self.eps = cfg["rms_norm_eps"]
        self.scan_chunk, self.q_chunk, self.ce_rows = scan_chunk, q_chunk, ce_rows

    def is_attention(self, i: int) -> bool:
        return i % self.cfg["attn_layer_period"] == self.cfg["attn_layer_offset"]

    def w(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)

    def rms(self, x, weight):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.w(weight)

    # ------------------------------------------------------------- mixers
    def scan(self, u, dt, Bm, Cm, A, D):
        """The recurrence (``Scan``), then the skip ``D u``."""
        return Scan.apply(u, dt, Bm, Cm, A, self.scan_chunk) + u * D

    def mamba(self, p, x):
        u, z = x @ self.w(p["in_proj_u"]), x @ self.w(p["in_proj_z"])
        K = p["conv_w"].shape[1]
        conv = F.conv1d(F.pad(u.transpose(1, 2), (K - 1, 0)), self.w(p["conv_w"])[:, None, :],
                        self.w(p["conv_b"]), groups=self.di)
        u = F.silu(conv.transpose(1, 2))
        dt, Bm, Cm = torch.split(u @ self.w(p["x_proj"]), [self.dtr, self.st, self.st], dim=-1)
        dt = self.rms(dt, p["dt_norm"])
        Bm, Cm = self.rms(Bm, p["B_norm"]), self.rms(Cm, p["C_norm"])
        dt = F.softplus(dt @ self.w(p["dt_proj"]) + self.w(p["dt_bias"]))
        A = -torch.exp(self.w(p["A_log"]))
        y = self.scan(u, dt, Bm, Cm, A, self.w(p["D"]))
        return (y * F.silu(z)) @ self.w(p["out_proj"])

    def attention(self, p, x):
        B, S, _ = x.shape
        G = self.heads // self.kv
        q = (x @ self.w(p["wq"])).view(B, S, self.kv, G, self.hd)
        k = (x @ self.w(p["wk"])).view(B, S, self.kv, self.hd)
        v = (x @ self.w(p["wv"])).view(B, S, self.kv, self.hd)
        outs = [checkpoint(self._attend, q[:, q0:q0 + self.q_chunk], k, v, q0,
                           use_reentrant=False)
                for q0 in range(0, S, self.q_chunk)]
        o = torch.cat(outs, dim=1).reshape(B, S, self.heads * self.hd)
        return o @ self.w(p["wo"])

    def _attend(self, qc, k, v, q0: int):
        """Query rows ``[q0, q0 + len)`` over the keys at or before them."""
        n = qc.shape[1]
        k, v = k[:, :q0 + n], v[:, :q0 + n]
        s = torch.einsum("bqkgh,bckh->bkgqc", qc, k) / math.sqrt(self.hd)
        rows = torch.arange(q0, q0 + n, device=qc.device)[:, None]
        cols = torch.arange(q0 + n, device=qc.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        o = torch.einsum("bkgqc,bckh->bqkgh", torch.softmax(s, dim=-1), v)
        return o

    def mlp(self, p, x):
        return (F.silu(x @ self.w(p["w_gate"])) * (x @ self.w(p["w_up"]))) @ self.w(p["w_down"])

    def block(self, p, i: int, x):
        if self.is_attention(i):
            x = x + self.attention(p["attn"], self.rms(x, p["attn_norm"]))
        else:
            x = x + self.mamba(p["ssm"], self.rms(x, p["ssm_norm"]))
        return x + self.mlp(p["mlp"], self.rms(x, p["ffn_norm"]))

    # -------------------------------------------------------------- split
    def client(self, bank, tokens, model_noise: Optional[torch.Tensor]):
        """A hospital's side: its embedding and blocks, then its model
        noise times ``privacy_noise``. tokens ``[b, S]``."""
        x = self.w(bank["embed"])[tokens.long()]
        for i, p in enumerate(bank["blocks"]):
            x = self.block(p, i, x)
        if model_noise is not None and self.cfg["privacy_noise"] > 0:
            x = x + self.cfg["privacy_noise"] * model_noise.to(self.dtype)
        return x

    def release(self, feats, guard_noise, clip_norm: float, sigma: float):
        """The guard: each window clipped to L2 norm ``clip_norm`` over all
        its positions and features, then ``sigma`` times the guard noise."""
        flat = feats.reshape(feats.shape[0], -1)
        norms = torch.linalg.vector_norm(flat.float(), dim=1, keepdim=True)
        scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0)
        out = flat.float() * scale
        if sigma > 0:
            out = out + sigma * guard_noise.reshape(flat.shape).float()
        return out.reshape(feats.shape).to(self.dtype)

    def server_blocks(self, server) -> List[tuple]:
        """``(block params, global layer index)`` of the trunk in order."""
        cut = self.cfg["cut_layers"]
        out = [(p, cut + j) for j, p in enumerate(server["prefix"])]
        at = cut + len(server["prefix"])
        groups = server.get("groups", {})
        n_groups = len(leaves(groups)[0]) if groups else 0
        period = len(groups)
        for g in range(n_groups):
            for pos in range(period):
                out.append((tree_map(lambda t, g=g: t[g], groups[f"pos{pos}"]),
                            at + g * period + pos))
        return out

    def trunk_loss(self, server, feats, labels, keep: Optional[int] = None):
        """The mean next-token cross entropy of the trunk on the released
        windows ``feats`` ``[R, S, d]`` against ``labels`` ``[R, S]``;
        ``keep``: a planted fault's count of the first positions scored."""
        x = feats
        for p, i in self.server_blocks(server):
            x = checkpoint(self.block, p, i, x, use_reentrant=False)
        x = self.rms(x, server["final_norm"])
        n = x.shape[1] - 1 if keep is None else keep
        hs = x[:, :n].reshape(-1, self.d)
        ys = labels[:, 1:n + 1].reshape(-1).long()
        total = sum(checkpoint(self._ce_sum, hs[r:r + self.ce_rows], ys[r:r + self.ce_rows],
                               server["lm_head"], use_reentrant=False)
                    for r in range(0, hs.shape[0], self.ce_rows))
        return total / hs.shape[0]

    def _ce_sum(self, h, y, head):
        return F.cross_entropy(h @ self.w(head), y, reduction="sum").float()


def train_steps(model: Jamba, client_banks, server, batches: Sequence[Dict], guard: dict,
                sigma: float, opt: dict, grad_clip: float, keep: Optional[int] = None):
    """Detached split training: for each step's batch (``tokens`` [C, b, S],
    ``model_noise`` and ``guard_noise`` [C, b, S, d] or None) the released
    windows of every hospital, the trunk's loss over all of them, the
    float32 global-norm clip and AdamW (``opt``: lr, b1, b2, eps; no weight
    decay). ``server`` is updated in place, each leaf in its type. Returns
    each step's loss and the norm of the first step's clipped gradient a
    leaf (``leaves`` order)."""
    if opt.get("weight_decay", 0.0):
        raise ValueError("the reference's AdamW takes no weight decay")
    lr, b1, b2, eps = opt["lr"], opt["b1"], opt["b2"], opt["eps"]
    params = leaves(server)
    mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    losses, first_grad = [], None
    for t, batch in enumerate(batches):
        with torch.no_grad():
            feats = []
            for c in range(batch["tokens"].shape[0]):
                bank = tree_map(lambda a, c=c: a[c], client_banks)
                mn = None if batch["model_noise"] is None else batch["model_noise"][c]
                gn = None if batch["guard_noise"] is None else batch["guard_noise"][c]
                f = model.client(bank, batch["tokens"][c], mn)
                feats.append(model.release(f, gn, guard["clip_norm"], sigma))
            feats = torch.cat(feats)
        labels = batch["tokens"].reshape(feats.shape[0], -1)
        for p in params:
            p.requires_grad_(True)
        loss = model.trunk_loss(server, feats, labels, keep)
        grads = torch.autograd.grad(loss, params)
        del feats
        with torch.no_grad():
            for p in params:
                p.requires_grad_(False)
            gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            if first_grad is None:
                first_grad = [float(torch.linalg.vector_norm((g.float() * scale).double()))
                              for g in grads]
            bc1, bc2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
            for p, g, m, v in zip(params, grads, mu, nu):
                g = g.float() * scale
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.copy_((p.float() - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)).to(p.dtype))
            del grads
        losses.append(float(loss.detach()))
    return losses, first_grad
