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


def load_checkpoint(path: str, device=None) -> Tuple[Any, dict]:
    """Restore the tree by its keys, as tensors on ``device`` (``None``:
    the card). Returns ``(tree, manifest)``; raises when the npz and the
    manifest disagree on the keys."""
    with open(path.replace(".npz", ".json")) as f:
        manifest = json.load(f)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if sorted(flat) != sorted(manifest["keys"]):
        raise ValueError(f"checkpoint {path}: npz keys differ from the manifest's")
    return to_torch(unflatten(flat), resolve_device(device)), manifest


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(f for f in os.listdir(directory) if re.match(r"ckpt_\d+\.npz$", f))
    return os.path.join(directory, ckpts[-1]) if ckpts else None
