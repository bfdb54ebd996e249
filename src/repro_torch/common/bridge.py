"""Parameter and state trees between numpy (or any array that ``np.asarray``
takes, such as the JAX package's arrays) and the port's tensors.

A tree is nested ``dict``s, ``list``s and ``tuple``s with array leaves, as
the JAX package's params and canonical state are. Flat keys are the
``"/"``-joined paths that ``repro.checkpoint.io._flatten`` writes: a dict
key as itself, a list position as its index.

bfloat16 crosses bit for bit, without ``ml_dtypes``: numpy has no bfloat16
of its own, so a JAX bf16 array comes to numpy as ``ml_dtypes``' type
(``dtype.name == "bfloat16"``) and the JAX checkpoint writer stores its
bits as 2-byte void (``|V2``). Both are read as ``uint16`` bits and viewed
as ``torch.bfloat16``; a ``torch.bfloat16`` tensor goes back to numpy as
``|V2``, the bits the JAX writer stores. float16 is a numpy type (``<f2``),
so a 2-byte void leaf can only be bfloat16.
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


def _is_bf16_bits(a: np.ndarray) -> bool:
    """bfloat16 as numpy holds it: ``ml_dtypes``' type, or 2-byte void."""
    dt = a.dtype
    return dt.name == "bfloat16" or (dt.kind == "V" and dt.itemsize == 2
                                     and dt.fields is None)


def _array_to_tensor(a, copy: bool = True) -> torch.Tensor:
    """A copy of ``a`` (anything ``np.array`` takes) as a CPU tensor of the
    same dtype; bfloat16 (:func:`_is_bf16_bits`) keeps its bits exactly.
    ``copy=False`` shares a writable numpy array's memory (one the caller
    owns, such as a checkpoint's freshly read leaf)."""
    a = np.array(a) if copy else np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if _is_bf16_bits(a):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host; a bfloat16 tensor as ``|V2`` with
    its bits unchanged, as the JAX checkpoint writer stores bfloat16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def to_torch(tree, device: Optional[Union[str, torch.device]] = None, copy: bool = True):
    """Every leaf as a tensor on ``device`` (dtype kept); ``None`` means the
    card, as everywhere in the port (:func:`resolve_device`), so with no card
    it raises. An array leaf is copied (JAX arrays are read-only buffers),
    unless ``copy=False`` and it is a writable numpy array, whose memory a
    CPU tensor then shares; a tensor leaf is moved, not copied, when it is
    already there."""
    dev = resolve_device(device)

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        return _array_to_tensor(a, copy).to(dev)

    return tree_map(leaf, tree)


def to_numpy(tree):
    """Every leaf as a numpy array on the host."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return _tensor_to_array(a)
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
