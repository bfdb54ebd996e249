"""The collectives the engines run over one axis of a ``DeviceMesh``.

The port runs one program on every rank (SPMD): every rank holds the
canonical state whole, computes its own shard of the work, and the
collectives below assemble the rest. Their backward passes are written for
that layout: downstream of a gather every rank computes the same values,
so a gather's backward is the rank's own slice of the gradient (no sum),
and the Megatron pair for tensor parallelism is ``copy_to`` (identity
forward, all-reduce backward) before a column-parallel layer and
``reduce_from`` (all-reduce forward, identity backward) after a
row-parallel one.

``dist.all_gather`` orders its outputs by rank within the axis's group,
which is the rank's coordinate along the axis.

With the state sharded over the model axis (``core.distributed``), two
more pieces join them: a gather whose result feeds rank-specific work (a
rank's own attention heads out of gathered k/v columns) is
``copy_to(gather(x))``, whose backward sums the ranks' gradients before
each takes its slice; and ``pmean`` (all-reduce mean forward and backward)
averages a replicated scalar, such as the MoE's aux loss, over the data
axes.

Gloo and CUDA tensors: one card can host two ranks only over gloo (NCCL
refuses two ranks on one device). Gloo has a CUDA form of every collective
issued here (list all-gather, all-reduce with SUM and MAX, broadcast;
checked on an H100 with torch 2.11), so nothing is staged through the host.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_names

_RECORDS: list = []  # the open ``recording()`` lists, innermost last


@contextlib.contextmanager
def recording():
    """Inside ``with``, every collective issued here is appended to the
    yielded list as ``(op, result bytes, the global ranks of its group)``
    (the dry-run's count, ``roofline.analysis.count_step``)."""
    record: list = []
    _RECORDS.append(record)
    try:
        yield record
    finally:
        _RECORDS.remove(record)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _record(op: str, nbytes: int, group) -> None:
    if _RECORDS:
        _RECORDS[-1].append((op, nbytes,
                             tuple(dist.get_process_group_ranks(group)) if group is not None
                             else tuple(range(dist.get_world_size()))))


def all_reduce_world_(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of the default group, in place."""
    dist.all_reduce(x)
    _record("all_reduce", _nbytes(x), None)
    return x


class MeshAxis:
    """One named dimension of a ``DeviceMesh`` as this rank sees it: its
    ``size``, this rank's ``index`` along it and the dimension's process
    ``group``. A tuple of names is those dimensions flattened into one, in
    order (the production grids' ``("pod", "data")``)."""

    def __init__(self, mesh, name: Union[str, Tuple[str, ...]]):
        names = (name,) if isinstance(name, str) else tuple(name)
        missing = [n for n in names if n not in axis_names(mesh)]
        if missing:
            raise ValueError(f"mesh axes {axis_names(mesh)} have no {missing[0]!r} axis")
        self.mesh, self.name = mesh, name
        if len(names) == 1:
            self.group = mesh.get_group(names[0])
        else:  # the mesh's own bookkeeping tensors stay real under a fake mode
            from torch.utils._python_dispatch import _disable_current_modes

            with _disable_current_modes():
                self.group = mesh[names]._flatten("_".join(names)).get_group()
        self.size = dist.get_world_size(self.group)
        self.index = dist.get_rank(self.group)

    def chunk(self, n: int) -> Tuple[int, int]:
        """``(lo, width)`` of this rank's even share of ``n`` rows."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over the {self.name!r} axis of "
                             f"size {self.size}")
        width = n // self.size
        return self.index * width, width

    def rows(self, n: int) -> slice:
        lo, width = self.chunk(n)
        return slice(lo, lo + width)

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's chunk of ``x`` along ``dim``."""
        lo, width = self.chunk(x.shape[dim])
        return x.narrow(dim, lo, width)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in axis order (no
        autograd)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        out = torch.cat(parts, dim=dim)
        _record("all_gather", _nbytes(out), self.group)
        return out

    def gather_ragged(self, x: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
        """Every rank's ``x`` (``counts[r]`` rows on rank r, counts known to
        every rank) concatenated along dim 0: padded to the largest count
        for the all-gather, the padding dropped after."""
        n = max(counts)
        pad = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        pad[: x.shape[0]] = x
        parts = [torch.empty_like(pad) for _ in range(self.size)]
        dist.all_gather(parts, pad, group=self.group)
        _record("all_gather", _nbytes(pad) * self.size, self.group)
        return torch.cat([p[:c] for p, c in zip(parts, counts)], dim=0)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        self.all_reduce_(out, op)
        return out

    def all_reduce_(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced over the axis in place (``x`` contiguous)."""
        dist.all_reduce(x, op=op, group=self.group)
        _record("all_reduce", _nbytes(x), self.group)
        return x

    def broadcast(self, x: torch.Tensor, src_index: int) -> torch.Tensor:
        """``x`` of the rank at ``src_index`` along the axis, on every rank
        (in place into ``x``, which the other ranks allocate)."""
        src = dist.get_global_rank(self.group, src_index)
        dist.broadcast(x, src=src, group=self.group)
        _record("broadcast", _nbytes(x), self.group)
        return x


class _GatherSlice(torch.autograd.Function):
    """All-gather forward; the rank's own slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, axis: MeshAxis, dim: int):
        ctx.axis, ctx.dim, ctx.width = axis, dim, x.shape[dim]
        return axis.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.width, ctx.width), None, None


class _CopyToAxis(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward (the input of a
    column-parallel layer: each rank's gradient is partial)."""

    @staticmethod
    def forward(ctx, x, axis: MeshAxis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _ReduceFromAxis(torch.autograd.Function):
    """All-reduce forward; identity backward (the partial products of a
    row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, axis: MeshAxis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToAxis(torch.autograd.Function):
    """The rank's chunk of a replicated tensor forward; the all-gather of the
    gradient chunks backward."""

    @staticmethod
    def forward(ctx, x, axis: MeshAxis, dim: int):
        ctx.axis, ctx.dim = axis, dim
        return axis.local(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.gather(g, ctx.dim), None, None


class _PMean(torch.autograd.Function):
    """All-reduce mean forward and backward (a replicated mean over the
    axis of each rank's own value)."""

    @staticmethod
    def forward(ctx, x, axis: MeshAxis):
        ctx.axis = axis
        return axis.all_reduce(x) / axis.size

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g) / ctx.axis.size, None


def pmean(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    return _PMean.apply(x, axis)


def gather(x: torch.Tensor, axis: MeshAxis, dim: int = 0) -> torch.Tensor:
    return _GatherSlice.apply(x, axis, dim)


def copy_to(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    return _CopyToAxis.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    return _ReduceFromAxis.apply(x, axis)


def scatter_to(x: torch.Tensor, axis: MeshAxis, dim: int = -1) -> torch.Tensor:
    return _ScatterToAxis.apply(x, axis, dim % x.dim())


def gather_chunks_(views: Sequence[Tuple[torch.Tensor, int]], axis: MeshAxis) -> None:
    """Fill each ``(view, dim)`` with every rank's chunk along ``dim``, in
    place, from this rank's own chunk of it: ONE all-gather of the chunks
    packed together. The views may be parts of one flat gradient."""
    if not views:
        return
    mine = torch.cat([axis.local(v, d).reshape(-1) for v, d in views])
    parts = [torch.empty_like(mine) for _ in range(axis.size)]
    dist.all_gather(parts, mine, group=axis.group)
    _record("all_gather", _nbytes(mine) * axis.size, axis.group)
    for r, part in enumerate(parts):
        if r == axis.index:
            continue
        off = 0
        for v, d in views:
            width = v.shape[d] // axis.size
            dst = v.narrow(d, r * width, width)
            n = dst.numel()
            dst.copy_(part[off: off + n].view(dst.shape))
            off += n
