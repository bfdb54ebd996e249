"""The repo's own optimizers, as ``repro.optim.optimizers``: each is an
``(init, update)`` pair, ``update(grads, state, params, step) -> (updates,
state)`` over trees (or single tensors, as the fused engine's flat
buffers), so the trainers are optimizer-agnostic.

The formulas are the JAX package's, not ``torch.optim``'s: AdamW's default
``b2`` is 0.95 and its ``weight_decay`` 0; ``weight_decay * p`` joins the
Adam direction before the ``-lr`` scale; the bias corrections are float32
powers of ``step + 1``; ``lr`` may be a schedule of the int32 step tensor.
``update`` builds no autograd graph: call it on gradients, under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.common.tree import tree_global_norm, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]  # (grads, state, params, step) -> (updates, state)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / max(norm, 1e-9)), norm)``."""
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def adamw(
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(grads, state, params, step):
        t = (step + 1).float()
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state["nu"], grads)
        # float32 powers, as the reference's b ** t.astype(float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
        lr_t = lr_fn(step)

        def upd(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype)

        return tree_map(upd, mu, nu, params), {"mu": mu, "nu": nu}

    return Optimizer(init, update)


def sgd(lr: Union[float, Callable], momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"vel": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        if momentum == 0.0:
            return tree_map(lambda g, p: (-lr_t * g).to(p.dtype), grads, params), state
        vel = tree_map(lambda v, g: momentum * v + g.float(), state["vel"], grads)
        return tree_map(lambda v, p: (-lr_t * v).to(p.dtype), vel, params), {"vel": vel}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(torch.add, params, updates)
