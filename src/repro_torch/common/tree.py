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
from torch._subclasses.fake_tensor import FakeTensor


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


def tree_map_with_path(fn: Callable[..., Any], tree, path: Tuple[Any, ...] = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, as
    ``jax.tree_util.tree_map_with_path``: ``path`` is the tuple of dict keys
    and list or tuple indices from the root to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The square root rounded correctly, as XLA's and CUDA's ``sqrt``:
    torch's float32 ``sqrt`` on the CPU (its vector path) rounds some
    values the other way (0.7% of random values in [0, 1e4), an ulp off),
    so a CPU float32 tensor's goes through float64, whose root rounds
    once more to the correct float32 (53 >= 2 * 24 + 2 bits). A fake
    tensor stands for a card's (the dry-run traces the card's ops)."""
    if x.device.type == "cpu" and x.dtype == torch.float32 and not isinstance(x, FakeTensor):
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def tree_size(tree) -> int:
    """Total number of parameters."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def dtype_groups(leaves) -> List[List[int]]:
    """The indices of ``leaves`` grouped by dtype, each group in leaf order,
    the groups in the order of their dtype's first leaf: the buffers of
    :func:`ravel`."""
    groups: dict = {}
    for i, x in enumerate(leaves):
        groups.setdefault(x.dtype, []).append(i)
    return list(groups.values())


def buffers(flat) -> List[torch.Tensor]:
    """The buffers of a :func:`ravel` result: ``[flat]`` for one tensor,
    else the tuple's."""
    return [flat] if isinstance(flat, torch.Tensor) else list(flat)


def ravel(tree, like=None) -> Tuple[Any, Callable[[Any], Any]]:
    """``(flat, unravel)``: the leaves concatenated into one 1-D tensor in
    :func:`tree_leaves` order (the order of ``ravel_pytree``), and the
    inverse. ``unravel(flat)`` returns views into ``flat``, so autograd
    through them gives one flat gradient.

    Leaves of several dtypes (an LM state's bfloat16 matrices beside its
    float32 norms) keep their dtypes: ``flat`` is then a tuple of 1-D
    buffers, one a dtype (:func:`dtype_groups`: each in leaf order, the
    dtypes in the order of their first leaf), ``unravel`` takes such a
    tuple, and autograd gives one gradient buffer a dtype. ``like``: a tree
    of the same structure whose leaves' dtypes group ``tree``'s in their
    place (an optimizer's float32 moments laid out as the parameters' buffers,
    so that buffer i of the moments lines up with buffer i of the
    parameters); ``unravel`` of ``ravel(like)`` reads them too."""
    leaves = tree_leaves(tree)
    groups = dtype_groups(tree_leaves(tree if like is None else like))
    shapes = [tuple(x.shape) for x in leaves]
    sizes = [math.prod(s) for s in shapes]
    if len(groups) > 1:
        flat = tuple(torch.cat([leaves[i].reshape(-1) for i in g]) for g in groups)
    else:
        flat = (torch.cat([x.reshape(-1) for x in leaves]) if leaves
                else torch.zeros((0,)))
    skeleton = tree_map(lambda _: True, tree)  # the structure, not the leaves

    def views(buf):
        if len(groups) <= 1:
            return [t.view(s) for t, s in zip(torch.split(buf, sizes), shapes)]
        bufs = buffers(buf)
        if len(bufs) != len(groups):
            raise ValueError(f"unravel wants {len(groups)} buffers, got {len(bufs)}")
        out = [None] * len(leaves)
        for g, b in zip(groups, bufs):
            for i, t in zip(g, torch.split(b, [sizes[i] for i in g])):
                out[i] = t.view(shapes[i])
        return out

    def unravel(buf):
        parts = iter(views(buf))

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
