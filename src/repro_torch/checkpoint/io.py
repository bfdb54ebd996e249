"""Tree checkpoints as an npz plus a JSON manifest, in the format of
``repro.checkpoint.io``: leaves keyed by their ``"/"``-joined paths.

A checkpoint written by the JAX package loads here and the reverse. The JAX
manifest's ``treedef`` string is specific to JAX, so this side restores by
the keys alone (``common.bridge.unflatten``) and writes a plain description
in that field, which the JAX loader does not read.

Writes are crash-safe as in the JAX package: both files land under
temporary names and move into place with ``os.replace``, npz first and the
manifest last, so the manifest marks a complete checkpoint.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.common.bridge import flatten, to_torch, unflatten
from repro_torch.common.device import resolve_device


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = flatten(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    # the tmp name keeps the .npz suffix (np.savez appends one otherwise)
    # while staying invisible to latest_checkpoint's pattern
    tmp_npz = path.replace(".npz", ".tmp.npz")
    np.savez(tmp_npz, **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "treedef": "nested dicts and lists keyed by the '/'-joined paths in keys",
        "metadata": metadata or {},
    }
    json_path = path.replace(".npz", ".json")
    tmp_json = json_path + ".tmp"
    with open(tmp_json, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp_npz, path)
    os.replace(tmp_json, json_path)
    return path


def _restore_like(like, flat: dict, device, read: set, prefix: str = ""):
    """``like``'s structure (and each leaf's dtype) with the leaves of
    ``flat``, the ``"/"``-keyed arrays of a checkpoint, on ``device``. Adds
    every key it looks up to ``read``; a key that ``flat`` lacks gives a
    ``None`` leaf, for the caller to report."""
    if isinstance(like, (dict, list, tuple)):
        items = like.items() if isinstance(like, dict) else enumerate(like)
        kids = {k: _restore_like(v, flat, device, read, f"{prefix}/{k}" if prefix else str(k))
                for k, v in items}
        return kids if isinstance(like, dict) else type(like)(kids.values())
    if like is None:
        return None
    read.add(prefix)
    arr = flat.get(prefix)
    if arr is None:
        return None
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch at {prefix}: {arr.shape} vs {tuple(like.shape)}")
    return to_torch(arr, device, copy=False).to(like.dtype)  # arr is this load's own


def load_checkpoint(path: str, device=None, like: Any = None) -> Tuple[Any, dict]:
    """Restore the tree as tensors on ``device`` (``None``: the card).
    Returns ``(tree, manifest)``; raises when the npz and the manifest
    disagree on the keys. Without ``like`` the tree is rebuilt from the keys
    alone (``common.bridge.unflatten``); with ``like``, a template tree, as
    in the JAX loader: the keys must be exactly the template's, and each
    leaf takes the template's shape (checked), dtype and container kind, so
    tuples and empty containers come back too."""
    with open(path.replace(".npz", ".json")) as f:
        manifest = json.load(f)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if sorted(flat) != sorted(manifest["keys"]):
        raise ValueError(f"checkpoint {path}: npz keys differ from the manifest's")
    device = resolve_device(device)
    if like is None:
        return to_torch(unflatten(flat), device), manifest
    read = set()
    tree = _restore_like(like, flat, device, read)
    missing, extra = read - set(flat), set(flat) - read
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    return tree, manifest


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(f for f in os.listdir(directory) if re.match(r"ckpt_\d+\.npz$", f))
    return os.path.join(directory, ckpts[-1]) if ckpts else None
