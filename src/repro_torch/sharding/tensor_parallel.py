"""Megatron tensor parallelism of a split-learning trunk over the mesh's
model axis, following ``specs.trunk_specs``.

Every rank holds the trunk's parameters whole; :class:`TrunkParallel`
slices each rank's shard out of them by the leaf's spec and runs the layer
on it:

  * a dense layer whose ``w`` shards ``dout`` (column-parallel, an even
    layer index) takes its input whole (``copy_to``) and leaves its output
    sharded on the last dim, its bias sharded with it;
  * a dense layer whose ``w`` shards ``din`` (row-parallel, an odd index)
    takes its input sharded (the previous column layer's output, or its own
    chunk of a whole one: ``scatter_to``), sums the partial products with
    one all-reduce (``reduce_from``) and adds its replicated bias;
  * a conv whose ``w`` shards ``cout`` runs on the whole input and leaves
    its channels sharded; ReLU and the max-pool run on the shard, and the
    stage gathers before the next conv or the flatten;
  * a leaf the axis does not divide (``_fit``) stays whole: its layer runs
    replicated, on a gathered input;
  * the trunk's output is gathered at the head.

The ranks' gradients of the sharded leaves come back as their own chunks;
:meth:`TrunkParallel.gather_grads_` fills in the rest (one all-gather), so
every rank ends with the whole gradient and runs the unsharded optimizer.

:class:`LMParallel` is the transformer blocks' counterpart, where a rank
HOLDS only its shards (``specs.trunk_specs`` on ``make_split_mesh`` grids,
``specs.tree_specs`` on the production grids): the blocks
(``models.attention``, ``models.layers.swiglu``, ``models.moe``,
``models.ssm``) take the rank's leaves and tell a sharded leaf from a whole
one by its shape against the config's. Every value downstream of a
collective that makes it whole is computed alike on every rank, so a
replicated leaf's gradient comes out whole and equal on every rank, and a
sharded leaf's is the rank's own chunk: no gradient is gathered.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.tree import tree_leaves
from repro_torch.sharding.collectives import (
    MeshAxis,
    copy_to,
    gather,
    gather_chunks_,
    reduce_from,
    scatter_to,
)
from repro_torch.sharding.specs import spec_leaves, trunk_specs

def mesh_axis(mesh, axes) -> MeshAxis:
    """The :class:`MeshAxis` of a spec entry (a name or a tuple of names),
    made once a mesh and kept on it (a flattened one makes its group
    collectively)."""
    cache = mesh.__dict__.setdefault("_mesh_axes", {})
    if axes not in cache:
        cache[axes] = MeshAxis(mesh, axes)
    return cache[axes]


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a view)."""
    for dim, axes in enumerate(spec):
        if axes is not None:
            x = mesh_axis(mesh, axes).local(x, dim)
    return x


def whole_of(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block of it under ``spec``: one
    all-gather a sharded dimension (no autograd)."""
    for dim, axes in enumerate(spec):
        if axes is not None:
            x = mesh_axis(mesh, axes).gather(x, dim)
    return x


def shard_tree(tree, specs, mesh):
    """Each leaf's block under its spec, as a tensor of its own."""
    return _zip_specs(lambda x, s: local_shard(x, s, mesh).clone(), tree, specs)


def whole_tree(tree, specs, mesh):
    return _zip_specs(lambda x, s: whole_of(x, s, mesh), tree, specs)


def owner(spec, mesh) -> bool:
    """Whether this rank counts a leaf's block once for the mesh: it is at
    index 0 of every mesh axis the spec leaves the block replicated over."""
    used = set()
    for axes in spec:
        if axes is not None:
            used.update((axes,) if isinstance(axes, str) else axes)
    coord = mesh.get_coordinate()
    return all(c == 0 for name, c in zip(mesh.mesh_dim_names, coord) if name not in used)


def _zip_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_specs(fn, v, s) for v, s in zip(tree, specs))
    return tree if tree is None else fn(tree, specs)


def _dim(spec) -> Optional[int]:
    """The dimension a spec shards, or ``None`` (replicated)."""
    dims = [i for i, ax in enumerate(spec) if ax is not None]
    return dims[0] if dims else None


class TrunkParallel:
    """The trunk's layers over ``axis`` (a :class:`MeshAxis` of the model
    dimension). Activations travel as ``(x, sharded)``: ``sharded`` means
    ``x`` is this rank's chunk of the last dim."""

    def __init__(self, mesh, axis: str = "model"):
        self.mesh = mesh
        self.axis = MeshAxis(mesh, axis)
        self.name = axis

    def specs(self, tree):
        return trunk_specs(tree, self.mesh, axis=self.name)

    def local(self, leaf: torch.Tensor, spec) -> torch.Tensor:
        d = _dim(spec)
        return leaf if d is None else self.axis.local(leaf, d)

    def whole(self, x: torch.Tensor, sharded: bool) -> torch.Tensor:
        return gather(x, self.axis, x.dim() - 1) if sharded else x

    # ------------------------------------------------------------ layers
    def dense(self, x: torch.Tensor, sharded: bool, p, spec) -> Tuple[torch.Tensor, bool]:
        """``x @ w + b`` under the layer's specs (``p`` and ``spec`` with
        ``"w"`` and ``"b"``); returns ``(y, y_sharded)``."""
        wd = _dim(spec["w"])
        if wd == 1:  # column-parallel
            y = copy_to(self.whole(x, sharded), self.axis) @ self.local(p["w"], spec["w"])
            return y + self.local(p["b"], spec["b"]), True  # b shares w's dout
        if wd == 0:  # row-parallel
            xs = x if sharded else scatter_to(x, self.axis, -1)
            y = reduce_from(xs @ self.local(p["w"], spec["w"]), self.axis)
            return y + p["b"], False
        return self.whole(x, sharded) @ p["w"] + p["b"], False

    def conv(self, conv2d, x: torch.Tensor, sharded: bool, p, spec) -> Tuple[torch.Tensor, bool]:
        """``conv2d(p, x)`` (bias included) under the conv's specs: a
        ``cout``-sharded ``w`` gives channel-sharded output."""
        x = self.whole(x, sharded)
        if _dim(spec["w"]) is None:
            return conv2d(p, x), False
        w = self.local(p["w"], spec["w"])
        if _dim(spec["b"]) is None:
            y = conv2d({"w": w, "b": torch.zeros_like(self.axis.local(p["b"], 0))},
                       copy_to(x, self.axis))
            return gather(y, self.axis, y.dim() - 1) + p["b"], False
        return conv2d({"w": w, "b": self.local(p["b"], spec["b"])}, copy_to(x, self.axis)), True

    # --------------------------------------------------------- gradients
    def gather_grads_(self, grads: Any, specs: Any) -> None:
        """Complete, in place, the gradient tree ``grads`` (whole-shaped
        leaves holding this rank's chunks of the sharded ones, e.g. views of
        a flat gradient) from every rank's chunks: one all-gather."""
        views = [(g, _dim(s)) for g, s in zip(tree_leaves(grads), spec_leaves(specs))
                 if _dim(s) is not None]
        gather_chunks_(views, self.axis)


class LMParallel:
    """The LM blocks over the model axis ``model`` (a :class:`MeshAxis`, or
    ``None``: every leaf whole), with ``data`` the data axes a
    data-parallel trunk splits its tokens over (the MoE's data-axis
    dispatch averages its aux loss over them) and ``seq`` the axis a decode
    cache's positions shard over (the reference's B = 1 cache rule)."""

    def __init__(self, model: Optional[MeshAxis] = None, data: Optional[MeshAxis] = None,
                 seq: Optional[MeshAxis] = None, fetch=None):
        self.model = model if model is not None and model.size > 1 else None
        self.data = data if data is not None and data.size > 1 else None
        self.seq = seq if seq is not None and seq.size > 1 else None
        # decode: ``fetch(subtree, path, group=None)`` gives a block's
        # weights as the blocks take them (``launch.steps``' 2-D placement)
        self.fetch = fetch

    def model_only(self) -> "LMParallel":
        return LMParallel(self.model)

    def split(self, local: int, whole: int) -> bool:
        """Whether a dimension held at ``local`` of ``whole`` is this rank's
        chunk over the model axis."""
        if self.model is None or local == whole:
            return False
        if local * self.model.size != whole:
            raise ValueError(f"a dimension of {whole} held at {local} is not a chunk of the "
                             f"model axis of size {self.model.size}")
        return True

    def lo(self, local: int) -> int:
        """The first index of this rank's chunk of width ``local``."""
        return self.model.index * local

    def col(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        """Column-parallel ``x @ w (+ b)``: ``x`` whole, ``w`` (and ``b``)
        this rank's columns; the output is this rank's chunk of the last dim."""
        y = copy_to(x, self.model) @ w
        return y if b is None else y + b

    def row(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Row-parallel ``x @ w``: ``x`` and ``w``'s rows this rank's chunk;
        the partial products summed (one all-reduce)."""
        return reduce_from(x @ w, self.model)

    def whole_for_mine(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's chunk of ``x`` along ``dim``, for work that differs
        by rank: the backward sums the ranks' gradients first."""
        return copy_to(gather(x, self.model, dim % x.dim()), self.model)

    # ------------------------------------------------------ vocab-parallel
    def embed(self, table: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
        """``table[tokens]`` with ``table`` this rank's rows of the vocab (or
        whole): each rank looks up the tokens in its range, zeros the rest,
        and one all-reduce sums them."""
        if not self.split(table.shape[0], vocab):
            return table[tokens.long()]
        lo = self.lo(table.shape[0])
        t = tokens.long() - lo
        inside = (t >= 0) & (t < table.shape[0])
        rows = table[torch.where(inside, t, torch.zeros_like(t))]
        return reduce_from(rows * inside[..., None].to(rows.dtype), self.model)

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor, vocab: int):
        """The float32 mean NLL of ``logits`` [..., V] whose last dim is this
        rank's chunk of the vocab (or whole): the max and the sum of exps
        all-reduced, so the logits are never gathered."""
        from repro_torch.models.layers import softmax_cross_entropy

        if not self.split(logits.shape[-1], vocab):
            return softmax_cross_entropy(logits, labels)
        lg = logits.float()
        with torch.no_grad():
            m = self.model.all_reduce(torch.amax(lg, dim=-1), op=dist.ReduceOp.MAX)
        sumexp = reduce_from(torch.sum(torch.exp(lg - m[..., None]), dim=-1), self.model)
        t = labels.long() - self.lo(lg.shape[-1])
        inside = (t >= 0) & (t < lg.shape[-1])
        at = torch.where(inside, t, torch.zeros_like(t))
        picked = torch.gather(lg, -1, at[..., None])[..., 0]
        ll = reduce_from(picked * inside.to(lg.dtype), self.model)
        return torch.mean(m + torch.log(sumexp) - ll)
