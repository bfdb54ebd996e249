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
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

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
