"""The plain reference of the paper's split CNNs: the client's privacy layer,
the guard's release, the trunk, the weighted loss and the training step,
in plain PyTorch and float32, written from the model's description and not
from the program's code.

Layout: activations NCHW, contiguous (the program runs NHWC); weights come
in the canonical HWIO/[in, out] layout and are turned once. The flatten
before the dense layers is in NHWC order, as the model defines it.

``precision`` is "float32" (TF32 off around the reference's own work) or
"tf32", the control: on a card cuDNN's and cuBLAS's TF32 paths, on the CPU
the same rounding emulated (each convolution's and product's inputs
rounded to TF32's 10-bit mantissa), so that a test can run the control.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(mode: str):
    """TF32 on ("tf32") or off ("float32") for the block, restored after."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"precision {mode!r}")
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest), the gradient
    passed straight through."""
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach()


class Model:
    """The model's layers in ``mode``'s precision, ``cfg`` the configuration
    file's dict; the weights come as canonical trees (HWIO convolutions)."""

    def __init__(self, cfg: dict, mode: str = "float32"):
        self.cfg, self.mode = cfg, mode

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        emulate = self.mode == "tf32" and t.device.type != "cuda"
        return round_tf32(t) if emulate else t

    def conv(self, x, p):
        w = p["w"].permute(3, 2, 0, 1)
        return F.conv2d(self._in(x), self._in(w.contiguous()), p["b"], padding=1)

    def stage(self, x, convs):
        for p in convs:
            x = torch.relu(self.conv(x, p))
        return F.max_pool2d(x, 2)

    def client(self, bank, x_nhwc, model_noise_nhwc: Optional[torch.Tensor]):
        """The privacy layer: the client's stages, then the model noise
        times ``privacy_noise``. NHWC in, NCHW out."""
        x = x_nhwc.permute(0, 3, 1, 2).contiguous()
        for convs in bank["stages"]:
            x = self.stage(x, convs)
        if model_noise_nhwc is not None and self.cfg["privacy_noise"] > 0:
            x = x + self.cfg["privacy_noise"] * model_noise_nhwc.permute(0, 3, 1, 2)
        return x

    def release(self, feats, guard_noise_nhwc, clip_norm: float, sigma: float):
        """The guard: each row clipped to L2 norm ``clip_norm``, then
        ``sigma`` times the guard noise."""
        flat = feats.reshape(feats.shape[0], -1)
        norms = torch.linalg.vector_norm(flat, dim=1, keepdim=True)
        scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0)
        out = flat * scale
        if sigma > 0:
            out = out + sigma * guard_noise_nhwc.permute(0, 3, 1, 2).reshape(flat.shape)
        return out.reshape(feats.shape)

    def trunk(self, server, feats):
        """The trunk's stages, the NHWC flatten, the dense layers and the
        output layer: logits ``[B, n_classes]``."""
        x = feats
        for convs in server["stages"]:
            x = self.stage(x, convs)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for d in server["dense"]:
            x = torch.relu(self._in(x) @ self._in(d["w"]) + d["b"])
        return self._in(x) @ self._in(server["out"]["w"]) + server["out"]["b"]


def bank_of(client_banks, c: int):
    """Hospital ``c``'s client stage out of the stacked banks."""
    return {"stages": [[{k: v[c] for k, v in p.items()} for p in convs]
                       for convs in client_banks["stages"]]}


def bce(logits, labels):
    """Mean binary cross-entropy with logits."""
    return F.binary_cross_entropy_with_logits(logits.reshape(labels.shape), labels)


def server_leaves(server) -> List[torch.Tensor]:
    """The trunk's leaves, dict keys sorted (the optimizer's flat order)."""
    if isinstance(server, dict):
        return [leaf for k in sorted(server) for leaf in server_leaves(server[k])]
    if isinstance(server, (list, tuple)):
        return [leaf for v in server for leaf in server_leaves(v)]
    return [server]


def train_steps(model: Model, client_banks, server, batches: Sequence[Dict], weights,
                guard: dict, sigma: float, opt: dict, grad_clip: float, drop_half: bool = False):
    """Detached split training: for each step's batch (``xs`` [C, b, ...],
    ``ys`` [C, b], ``model_noise`` and ``guard_noise`` [C, b, ...]) the
    released features of every hospital (no gradient crosses the cut), the
    trunk, the share-weighted BCE, the global gradient clip and AdamW
    (``opt``: lr, b1, b2, eps; weight decay 0, refused otherwise).
    ``server`` is updated in place. Returns each step's loss and the first
    step's clipped gradient per leaf. ``drop_half``: a planted fault, each hospital's loss over the
    first half of its rows only."""
    if opt.get("weight_decay", 0.0):
        raise ValueError("the reference's AdamW takes no weight decay")
    lr, b1, b2, eps = opt["lr"], opt["b1"], opt["b2"], opt["eps"]
    params = server_leaves(server)
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    w = torch.as_tensor(weights, dtype=torch.float32, device=params[0].device)
    w = w / w.sum()
    losses, first_grad = [], None
    for t, batch in enumerate(batches):
        with torch.no_grad():
            feats = []
            for c in range(batch["xs"].shape[0]):
                f = model.client(bank_of(client_banks, c), batch["xs"][c], batch["model_noise"][c])
                feats.append(model.release(f, batch["guard_noise"][c], guard["clip_norm"], sigma))
            feats = torch.stack(feats)
        for p in params:
            p.requires_grad_(True)
        cn, b = feats.shape[:2]
        logits = model.trunk(server, feats.reshape((cn * b,) + feats.shape[2:])).reshape(cn, b)
        keep = b // 2 if drop_half else b
        per = torch.stack([bce(logits[c, :keep], batch["ys"][c, :keep]) for c in range(cn)])
        loss = torch.sum(w * per)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p in params:
                p.requires_grad_(False)
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            grads = [g * scale for g in grads]
            if first_grad is None:
                first_grad = [g.clone() for g in grads]
            bc1 = 1 - b1 ** (t + 1)
            bc2 = 1 - b2 ** (t + 1)
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.add_(-lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        losses.append(float(loss.detach()))
    return losses, first_grad


def chunks(n: int, size: int):
    """``range`` slices of at most ``size`` covering ``n``."""
    return [slice(i, min(i + size, n)) for i in range(0, n, max(1, size))]


def serve_answers(model: Model, client_banks, server, requests: Sequence[Dict], guard: dict,
                  sigma: float, trunk_rows: int) -> List[torch.Tensor]:
    """The answer of each request (``client``, ``x`` [b, ...], ``model_noise``
    and ``guard_noise`` [b, ...]): its hospital's privacy layer, the guard,
    and the trunk, the trunk run over ``trunk_rows`` rows at a time."""
    with torch.no_grad():
        feats = [model.release(model.client(bank_of(client_banks, r["client"]), r["x"],
                                            r["model_noise"]),
                               r["guard_noise"], guard["clip_norm"], sigma)
                 for r in requests]
        sizes = [f.shape[0] for f in feats]
        rows = torch.cat(feats)
        del feats
        out = torch.cat([model.trunk(server, rows[s]) for s in chunks(rows.shape[0], trunk_rows)])
        return list(torch.split(out, sizes))


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gap(got: Sequence[float], ref: Sequence[float], counted: Sequence[bool]) -> float:
    """The worst counted leaf's gap of norms, ``|got - ref|`` over the larger
    of the reference leaf's norm and the median leaf's."""
    med = float(torch.tensor([r for r, k in zip(ref, counted) if k]).median())
    return max(abs(g - r) / max(r, med, 1e-30) for g, r, k in zip(got, ref, counted) if k)


def counted_leaves(grad_norms: Sequence[float], share: float = 1e-3) -> List[bool]:
    """Leaves whose reference gradient is above ``share`` of the median
    leaf's; the others move under AdamW by rounding alone."""
    med = float(torch.tensor(list(grad_norms)).median())
    return [g >= share * med for g in grad_norms]


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))
