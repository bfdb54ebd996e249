"""Logical-axis sharding annotations, as ``repro.sharding.logical``.

Model code calls ``shard(x, "batch", "seq", "model")`` with *logical* axis
names; a context-scoped rule table maps them onto mesh axes (or ``None``,
replicated). With no rules installed the annotation is the identity, so
model code is mesh-agnostic.

A ``PartitionSpec`` here is a tuple of mesh-axis names (a name, a tuple of
names, or ``None`` a dimension), so it compares equal to ``tuple()`` of
JAX's. Under rules, ``shard`` lays a tensor out over a ``DeviceMesh`` as a
``DTensor`` with the spec's placements (a DTensor is redistributed).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.launch.mesh import axis_names, mesh_shape

_state = threading.local()

Axis = Union[str, Tuple[str, ...], None]


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh-axis name, a tuple of names (the
    dimension shards over their product) or ``None`` (replicated)."""

    def __new__(cls, *axes):
        # a one-name tuple is that name, as JAX normalizes it
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a
                                     for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# The production rule table: batch over (pod, data); tensor-parallel dims
# over model. "expert" also maps onto model (expert-parallel shares the axis).
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,           # activations keep d_model replicated
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",           # FFN hidden dim
    "vocab": "model",
    "expert": "model",       # expert-parallel
    "expert_ff": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "client": ("pod", "data"),  # per-client parameter banks live on the data axis
}

# The split-learning platform's table for the 2-D ("clients", "model") grid
# (``launch.mesh.make_split_mesh``): banks and per-client epoch data over
# "clients"; the trunk's tensor-parallel dims over "model" ("trunk_col" a
# column-parallel output dim, "trunk_row" a row-parallel input dim).
SPLIT_RULES: Dict[str, Axis] = {
    "clients": "clients",
    "batch": None,
    "trunk_col": "model",
    "trunk_row": "model",
    "features": None,        # released cut features are replicated
}


def split_axis_rules(mesh):
    """``axis_rules(SPLIT_RULES, mesh)``: axes missing from the mesh degrade
    to replication, so the same code runs on a 1-D client mesh or none."""
    return axis_rules(SPLIT_RULES, mesh)


def current_rules() -> Optional[Dict[str, Axis]]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, Axis], mesh=None):
    prev_r = getattr(_state, "rules", None)
    prev_m = getattr(_state, "mesh", None)
    _state.rules = rules
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.rules = prev_r
        _state.mesh = prev_m


def logical_to_spec(logical: Sequence[Optional[str]], rules=None, mesh=None) -> PartitionSpec:
    """Translate logical axis names to a ``PartitionSpec`` under ``rules``."""
    rules = rules if rules is not None else (current_rules() or {})
    mesh = mesh if mesh is not None else current_mesh()
    mesh_axes = set(axis_names(mesh)) if mesh is not None else None
    out = []
    for name in logical:
        ax = rules.get(name) if name else None
        if ax is not None and mesh_axes is not None:
            if isinstance(ax, tuple):
                ax = tuple(a for a in ax if a in mesh_axes) or None
            elif ax not in mesh_axes:
                ax = None
        out.append(ax)
    return P(*out)


def _axes_size(mesh, ax) -> int:
    if ax is None:
        return 1
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in ((ax,) if isinstance(ax, str) else ax))


def fit_spec(shape: Sequence[int], spec: Sequence, mesh) -> PartitionSpec:
    """``spec`` padded to ``len(shape)`` with ``None``, each axis whose size
    does not divide its dimension dropped (replicated)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return P(*(None if ax is not None and dim % _axes_size(mesh, ax) else ax
               for dim, ax in zip(shape, spec)))


def spec_placements(spec: Sequence, mesh) -> list:
    """A ``PartitionSpec``'s DTensor placements: for each mesh dimension,
    ``Shard(i)`` where tensor dimension i shards over it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names(mesh):
        dim = next((i for i, ax in enumerate(spec)
                    if ax == name or (isinstance(ax, tuple) and name in ax)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def shard(x, *logical: Optional[str]):
    """Lay ``x`` out by its logical axes where rules are installed; else the
    identity. Axes whose mesh size does not divide the dimension are dropped
    (replicated). On a ``DeviceMesh`` the result is a ``DTensor`` with the
    spec's placements (a DTensor input is redistributed); on a shape-only
    mesh, or with no mesh, ``x`` comes back as it was."""
    rules = current_rules()
    if rules is None:
        return x
    spec = logical_to_spec(logical, rules)
    mesh = current_mesh()
    if mesh is None or getattr(mesh, "device_type", None) is None:
        return x
    spec = fit_spec(tuple(x.shape), spec, mesh)
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = spec_placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements)
