"""Parameter and state trees between numpy (or any array that ``np.asarray``
takes, such as the JAX package's arrays) and the port's tensors.

A tree is nested ``dict``s, ``list``s and ``tuple``s with array leaves, as
the JAX package's params and canonical state are. Flat keys are the
``"/"``-joined paths that ``repro.checkpoint.io._flatten`` writes: a dict
key as itself, a list position as its index.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf; containers keep their kind (tuples come
    back as lists, as checkpoints store them). ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    if tree is None:
        return None
    return fn(tree)


def to_torch(tree, device: Optional[Union[str, torch.device]] = None):
    """Every leaf as a tensor on ``device`` (dtype kept); ``None`` means the
    card, as everywhere in the port (:func:`resolve_device`), so with no card
    it raises. An array leaf is copied (JAX arrays are read-only buffers); a
    tensor leaf is moved, not copied, when it is already there."""
    dev = resolve_device(device)

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    return tree_map(leaf, tree)


def to_numpy(tree):
    """Every leaf as a numpy array on the host."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy()
        return np.asarray(a)

    return tree_map(leaf, tree)


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a/0/w": leaf, ...}`` with numpy leaves, keyed like the JAX
    package's checkpoints."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        if tree is not None:
            out[prefix] = to_numpy(tree)
        return out
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten(flat: Dict[str, Any]):
    """Invert :func:`flatten` from the keys alone: a level whose keys are
    exactly ``0 .. n-1`` is a list, any other level a dict. An empty
    container has no key, so it does not come back."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def build(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and set(keys) == {str(i) for i in range(len(keys))}:
            return [build(node[str(i)]) for i in range(len(keys))]
        return {k: build(v) for k, v in node.items()}

    return build(root)
