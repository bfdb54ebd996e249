"""Parameter, state and batch placement rules, as ``repro.sharding.specs``.

Pattern: column-parallel in-projections (QKV, FFN up/gate, SSM in_proj),
row-parallel out-projections (O, FFN down, SSM out_proj), vocab-sharded
embedding and head, expert-parallel MoE weights, and per-client parameter
banks over the data axes. Every rule checks divisibility against the leaf's
shape and falls back to replication for that dimension.

The rules are pure functions of a leaf's path, its shape and the mesh's
axis sizes, so they run on a ``DeviceMesh`` or a shape-only mesh
(``launch.mesh.ShapeMesh``, or JAX's ``AbstractMesh``) alike. A path is the
``"/"``-joined dict keys and list indices (``common.tree.tree_map_with_path``),
JAX's ``_path_str`` for the same tree. ``*_placements`` turn the specs into
DTensor placements, one a mesh dimension.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from repro_torch.common.tree import tree_map_with_path
from repro_torch.launch.mesh import axis_names, mesh_shape
from repro_torch.sharding.logical import P, PartitionSpec, spec_placements


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in ((axes,) if isinstance(axes, str) else axes))


def _fit(mesh, shape: Tuple[int, ...], spec: Sequence) -> PartitionSpec:
    """Drop spec entries whose mesh-axes size doesn't divide the dim."""
    out = []
    for dim, axes in zip(shape, spec):
        if axes is not None and dim % _axes_size(mesh, axes) != 0:
            axes = None
        out.append(axes)
    return P(*out)


# Leaf-name based rules: name -> logical spec builder(shape)
_RULES = {
    "embed": lambda s: ("model", None),           # [V, d] vocab-sharded
    "lm_head": lambda s: (None, "model"),         # [d, V]
    "wq": lambda s: (None, "model"),
    "wk": lambda s: (None, "model"),
    "wv": lambda s: (None, "model"),
    "wo": lambda s: ("model", None),
    "bq": lambda s: ("model",),
    "bk": lambda s: ("model",),
    "bv": lambda s: ("model",),
    "w_gate": lambda s: ("model", None, None) if len(s) == 3 else (None, "model"),
    "w_up": lambda s: ("model", None, None) if len(s) == 3 else (None, "model"),
    "w_down": lambda s: ("model", None, None) if len(s) == 3 else ("model", None),
    "router": lambda s: (None, None),
    "in_proj_u": lambda s: (None, "model"),
    "in_proj_z": lambda s: (None, "model"),
    "conv_w": lambda s: ("model", None),
    "conv_b": lambda s: ("model",),
    "x_proj": lambda s: ("model", None),
    "dt_proj": lambda s: (None, "model"),
    "dt_bias": lambda s: ("model",),
    "A_log": lambda s: ("model", None),
    "D": lambda s: ("model",),
    # decode state. Batch-first; at B=1 (long-context decode) the data axis
    # would idle, so the KV cache's SEQUENCE dim shards over it instead
    "k": lambda s: ("data", None, "model", None) if s[0] > 1 else (None, "data", "model", None),
    "v": lambda s: ("data", None, "model", None) if s[0] > 1 else (None, "data", "model", None),
    "conv": lambda s: ("data", None, "model"),     # [B, K-1, di]
    "h": lambda s: ("data", "model", None),        # [B, di, st]
}

# Leaf names trunk_specs delegates to _RULES (the transformer trunk's
# tensor-parallel set; everything else in a trunk tree replicates)
_TRUNK_TP_NAMES = frozenset({
    "lm_head", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
    "w_gate", "w_up", "w_down", "in_proj_u", "in_proj_z",
})


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in np.shape(leaf))


def _leaf_spec(mesh, path, leaf, *, data_axes, banked_client: bool, zero1: bool = False,
               weights_2d: bool = False) -> PartitionSpec:
    pstr = _path_str(path)
    name = pstr.split("/")[-1]
    shape = _shape(leaf)
    names = axis_names(mesh)
    prepend = 0
    # stacked scan groups have a leading group dim
    if "groups" in pstr:
        prepend += 1
    # client banks have a leading [n_clients] dim sharded over the data axes
    bank = banked_client and pstr.startswith(("client", "client_banks"))
    rule = _RULES.get(name)
    if rule is None:
        base = [None] * (len(shape) - prepend - (1 if bank else 0))
    else:
        base = list(rule(shape[prepend + (1 if bank else 0):]))
    # expert weights: expert-parallel where n_experts divides the model
    # axis, else tensor-parallel WITHIN each expert (shard ff)
    n_core = len(shape) - prepend - (1 if bank else 0)
    if name in ("w_gate", "w_up", "w_down") and n_core == 3 and "model" in names:
        E = shape[prepend + (1 if bank else 0)]
        if E % _axes_size(mesh, "model") != 0:
            base = [None, "model", None] if name == "w_down" else [None, None, "model"]
    spec = [None] * prepend + list(base)
    # B=1 decode: weight matrices shard their `model` dim over (data, model)
    if weights_2d:
        dax = data_axes if isinstance(data_axes, tuple) else (data_axes,)

        def _uses_data(ax):
            axes = ax if isinstance(ax, tuple) else (ax,)
            return any(a in dax for a in axes if a)

        if not any(_uses_data(ax) for ax in spec if ax):  # skip state tensors
            combined = dax + ("model",)
            csz = _axes_size(mesh, combined)
            spec = [(combined if (ax == "model" and dim % csz == 0) else ax)
                    for ax, dim in zip(spec, shape)]
    if bank:
        spec = [data_axes] + spec
    # ZeRO-1 style: additionally shard the first replicated big dim over data
    if zero1 and not bank:
        size = math.prod(shape) if shape else 0
        if size >= 1 << 20:
            dsz = _axes_size(mesh, data_axes)
            for i in range(len(spec)):
                if spec[i] is None and shape[i] % dsz == 0 and shape[i] >= dsz:
                    spec[i] = data_axes
                    break
    return _fit(mesh, shape, spec)


def _data_axes(mesh):
    data_axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    return data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)


def tree_specs(tree, mesh, *, banked_client: bool = False, zero1: bool = False,
               weights_2d: bool = False):
    """PartitionSpec tree for params, optimizer state or decode state."""
    data_axes = _data_axes(mesh)
    return tree_map_with_path(
        lambda path, leaf: _leaf_spec(mesh, path, leaf, data_axes=data_axes,
                                      banked_client=banked_client, zero1=zero1,
                                      weights_2d=weights_2d), tree)


def tree_placements(tree, mesh, **kw):
    """``tree_specs`` as DTensor placements, one list a leaf."""
    return _map_specs(lambda s: spec_placements(s, mesh), tree_specs(tree, mesh, **kw))


def _map_specs(fn, specs):
    """``fn`` over a tree whose leaves are PartitionSpecs (themselves tuples,
    so the tree helpers would walk into them)."""
    if isinstance(specs, PartitionSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, v) for v in specs)
    return specs


def spec_leaves(specs) -> list:
    """A spec tree's specs in ``common.tree.tree_leaves`` order."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [s for v in specs for s in spec_leaves(v)]
    return []


def trunk_specs(tree, mesh, axis: str = "model"):
    """PartitionSpec tree for the split-learning SERVER TRUNK (and any tree
    mirroring its leaf layout, e.g. optimizer moment trees).

    Megatron-style tensor parallelism over the mesh's ``axis``: dense stacks
    alternate column-parallel (even layer index: ``w [din, dout]`` shards
    ``dout``, ``b`` with it) and row-parallel (odd index: ``w`` shards
    ``din``, ``b`` replicated; the partial products reduce with one
    all-reduce), so the activation between a column/row pair stays sharded
    and the only gathers left are at the CUT and at the LOGITS. Conv trunk
    stages shard their output channels. Dims the axis size does not divide
    fall back to replication (``_fit``), which also makes a ``(1, 1)`` mesh
    the identity. The layer index is the innermost list index of the path.

    Transformer trunks shard by leaf NAME via ``_RULES`` (QKV/FFN-up/SSM-in
    column-parallel, O/FFN-down/SSM-out row-parallel, the untied ``lm_head``
    vocab-sharded); leaves under ``groups`` keep their leading group dim
    replicated."""
    if axis not in axis_names(mesh):
        return tree_map_with_path(lambda path, leaf: P(*([None] * len(_shape(leaf)))), tree)

    def spec_of(path, leaf):
        parts = _path_str(path).split("/")
        name = parts[-1]
        shape = _shape(leaf)
        prepend = 1 if "groups" in parts else 0
        core = shape[prepend:]
        idx = 0
        for p in reversed(parts[:-1]):
            if p.isdigit():
                idx = int(p)
                break
        rule = _RULES.get(name) if name in _TRUNK_TP_NAMES else None
        if name == "w" and len(shape) == 2:
            spec = [axis, None] if idx % 2 else [None, axis]
        elif name == "w" and len(shape) == 4:  # conv [kh, kw, cin, cout]
            spec = [None, None, None, axis]
        elif name == "b" and len(shape) == 1:
            spec = [None] if idx % 2 else [axis]
        elif rule is not None and len(rule(core)) == len(core):
            spec = [None] * prepend + [axis if a == "model" else None for a in rule(core)]
        else:
            spec = [None] * len(shape)
        return _fit(mesh, shape, spec)

    return tree_map_with_path(spec_of, tree)


def trunk_placements(tree, mesh, axis: str = "model"):
    """``trunk_specs`` as DTensor placements, one list a leaf."""
    return _map_specs(lambda s: spec_placements(s, mesh), trunk_specs(tree, mesh, axis=axis))


def client_bank_specs(tree, mesh, axis: str = "clients"):
    """PartitionSpec tree for a canonical client-banked state fragment: every
    leaf's LEADING dim is the stacked client axis, sharded over ``axis``;
    dims the axis size does not divide fall back to replication."""

    def spec_of(path, leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        return _fit(mesh, shape, [axis] + [None] * (len(shape) - 1))

    return tree_map_with_path(spec_of, tree)


def client_bank_placements(tree, mesh, axis: str = "clients"):
    """``client_bank_specs`` as DTensor placements, one list a leaf."""
    return _map_specs(lambda s: spec_placements(s, mesh),
                      client_bank_specs(tree, mesh, axis=axis))


def batch_specs(batch_tree, mesh, *, banked: bool = False):
    """Input batch: leading dim (clients or batch) over the data axes."""
    data_axes = _data_axes(mesh)

    def spec_of(path, leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        return _fit(mesh, shape, [data_axes] + [None] * (len(shape) - 1))

    return tree_map_with_path(spec_of, batch_tree)
