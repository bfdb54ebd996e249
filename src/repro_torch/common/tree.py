"""Tree utilities over the port's nested ``dict``/``list``/``tuple`` trees
with tensor leaves, as ``repro.common.tree``.

Leaves come in the order of ``jax.tree.leaves``: dict keys **sorted**,
lists and tuples in index order, ``None`` skipped. :func:`ravel` keeps that
order, so a flat buffer here lines up with ``jax.flatten_util.ravel_pytree``
of the same tree, and flat optimizer moments carry across checkpoints.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch


def _children(tree) -> List[Tuple[Any, Any]]:
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, (dict, list, tuple)):
        return [leaf for _, child in _children(tree) for leaf in tree_leaves(child)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); containers keep their kind."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def tree_size(tree) -> int:
    """Total number of parameters."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def ravel(tree) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """``(flat, unravel)``: the leaves concatenated into one 1-D tensor in
    :func:`tree_leaves` order (the order of ``ravel_pytree``), and the
    inverse. ``unravel(flat)`` returns views into ``flat``, so autograd
    through them gives one flat gradient. The leaves must share a dtype."""
    leaves = tree_leaves(tree)
    dtypes = {x.dtype for x in leaves}
    if len(dtypes) > 1:
        raise ValueError(f"ravel wants leaves of one dtype, got {sorted(map(str, dtypes))}")
    shapes = [tuple(x.shape) for x in leaves]
    sizes = [math.prod(s) for s in shapes]
    flat = (torch.cat([x.reshape(-1) for x in leaves]) if leaves
            else torch.zeros((0,)))
    skeleton = tree_map(lambda _: True, tree)  # the structure, not the leaves

    def unravel(buf: torch.Tensor):
        parts = iter(t.view(s) for t, s in zip(torch.split(buf, sizes), shapes))

        def rebuild(node):
            if isinstance(node, dict):
                out = {}
                for k, _ in _children(node):
                    out[k] = rebuild(node[k])
                return {k: out[k] for k in node}  # the tree's own key order
            if isinstance(node, (list, tuple)):
                return type(node)(rebuild(v) for v in node)
            return None if node is None else next(parts)

        return rebuild(skeleton)

    return flat, unravel
