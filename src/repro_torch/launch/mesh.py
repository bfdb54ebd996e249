"""Mesh builders of the port, as ``repro.launch.mesh``, over
``torch.distributed.device_mesh``.

A mesh here is a ``DeviceMesh`` with named dimensions: ``("clients",)``,
``("clients", "model")``, ``("data", "model")`` or ``("pod", "data",
"model")``. One process drives one device (one rank per card, or one rank
per CPU process with gloo), so "the devices available" are the ranks of the
default process group. ``device_type`` is ``"cuda"`` unless the caller asks
for ``"cpu"``; a CUDA mesh with no card raises, and nothing moves to the
CPU on its own.

Process groups. With no default process group and one rank wanted, the
builders start a one-rank group from an in-memory store (NCCL on the card,
gloo on the CPU; no rendezvous, and the transports default to the loopback
interface, ``GLOO_SOCKET_IFNAME``/``NCCL_SOCKET_IFNAME``). More ranks must be
started by the caller, one process each, for example with ``torchrun``,
which sets the rendezvous that ``torch.distributed.init_process_group()``
reads; every rank then calls the same builders in the same order (a mesh's
dimension groups are made collectively). Meshes are cached by device type,
shape and names for the life of the default group.

:class:`ShapeMesh` is a mesh of names and sizes alone, as JAX's
``AbstractMesh``: the placement rules (``repro_torch.sharding``) read only
``axis_names`` and ``shape``, so they run on it at any grid size with no
process group.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_MESHES: Dict[tuple, object] = {}


class ShapeMesh:
    """Axis names and sizes with no devices: ``axis_names`` a tuple,
    ``shape`` an ordered ``{name: size}``, as ``jax.sharding.AbstractMesh``."""

    device_type = None

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axis names {tuple(axis_names)} differ "
                             "in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"ShapeMesh({self.shape})"


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's dimension names, for a ``DeviceMesh`` or a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None and not hasattr(mesh, "axis_names"):
        raise ValueError(f"{mesh!r} is not a mesh: build one with repro_torch.launch.mesh")
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{name: size}`` in dimension order, for a ``DeviceMesh`` or a
    shape-only mesh (``ShapeMesh``, or JAX's ``AbstractMesh``)."""
    names = axis_names(mesh)
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))


def _world() -> int:
    """Ranks available: the default group's size, else 1 (a one-rank group
    starts on demand)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _check_device_type(device_type: str) -> str:
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a card and none is available; pass "
                           "device_type='cpu' for a gloo mesh on the CPU")
    return device_type


def _ensure_group() -> None:
    """A one-rank default group from an in-memory store where none exists:
    gloo for CPU tensors, and NCCL for CUDA tensors where there is a card."""
    if dist.is_initialized():
        return
    _MESHES.clear()
    # a one-rank group talks to no one: keep its transports on the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
        backend = "cpu:gloo,cuda:nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _device_mesh(device_type: str, shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    _ensure_group()
    key = (device_type, shape, names)
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = init_device_mesh(device_type, shape, mesh_dim_names=names)
    return mesh


def release_meshes() -> None:
    """Forget the cached meshes and destroy the default process group (a
    caller's run ends with it; the next builder starts afresh)."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _check_divides(n_clients, axis_size: int, axis: str) -> None:
    """``n_clients`` must divide over the client axis: the stacked client
    banks shard their leading axis evenly; fail at mesh construction."""
    if n_clients is not None and int(n_clients) % int(axis_size) != 0:
        raise ValueError(
            f"n_clients={int(n_clients)} does not divide over the "
            f"{axis!r} mesh axis of size {int(axis_size)}; pick a rank "
            f"count that divides n_clients (the stacked client banks shard "
            f"their leading axis evenly, one hospital group per rank)"
        )


def _check_whole_world(what: str, n: int, world: int) -> None:
    """Every rank of the world is on the mesh: the engines run one program
    on every rank, so a rank left off the mesh would wait forever."""
    if n != world:
        raise ValueError(f"{what}: a mesh of {n} ranks in a world of {world}; every rank "
                         "runs the same program, so the mesh must cover the world")


def make_client_mesh(n_devices=None, axis: str = "clients", *, n_clients=None,
                     device_type: str = "cuda"):
    """1-D mesh over the split-learning client axis: each hospital group's
    bank and epoch data on its own rank (``SplitSession(mesh=...)``). On one
    rank this is the mesh every engine is pinned bit for bit against.
    ``n_clients``, when given, must divide over the ranks."""
    _check_device_type(device_type)
    world = _world()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(
            f"make_client_mesh: n_devices={n} outside [1, {world}] available devices"
        )
    _check_divides(n_clients, n, axis)
    _check_whole_world("make_client_mesh", n, world)
    return _device_mesh(device_type, (n,), (axis,))


def make_split_mesh(n_clients_axis: int = 1, n_model_axis: int = 1, *, n_clients=None,
                    client_axis: str = "clients", model_axis: str = "model",
                    device_type: str = "cuda"):
    """2-D ``("clients", "model")`` mesh for the split-learning platform:
    the client axis shards the stacked client banks and fleet production,
    the model axis the server trunk tensor-parallel (Megatron column/row
    alternation, ``repro_torch.sharding.specs.trunk_specs``). ``(1, 1)`` is
    the mesh every engine is pinned bit for bit against, ``(N, 1)`` the
    client-axis layout, ``(1, N)`` every rank on the trunk. The grid must
    fit the ranks, and ``n_clients`` (when given) divide over the client
    axis."""
    c, m = int(n_clients_axis), int(n_model_axis)
    if c < 1 or m < 1:
        raise ValueError(f"make_split_mesh: axis sizes must be >= 1, got ({c}, {m})")
    _check_device_type(device_type)
    world = _world()
    if c * m > world:
        raise ValueError(
            f"make_split_mesh: a ({c}, {m}) grid needs {c * m} devices but only "
            f"{world} are available (start one process a device, e.g. with torchrun)"
        )
    _check_divides(n_clients, c, client_axis)
    _check_whole_world("make_split_mesh", c * m, world)
    return _device_mesh(device_type, (c, m), (client_axis, model_axis))


def make_production_mesh(*, multi_pod: bool = False, shape=None, device_type: str = "cuda",
                         shape_only: bool = False):
    """The production grids: ``(data=16, model=16)``, or ``(pod=2, data=16,
    model=16)`` with ``multi_pod``; ``shape`` overrides the split (same rank
    count). ``shape_only=True`` gives the :class:`ShapeMesh`, for placement
    and planning with no ranks; else a ``DeviceMesh`` over that many ranks."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    shape = tuple(int(s) for s in shape)
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    if shape_only:
        return ShapeMesh(shape, names)
    _check_device_type(device_type)
    world = _world()
    if math.prod(shape) > world:
        raise ValueError(f"make_production_mesh: a {shape} grid needs {math.prod(shape)} "
                         f"devices but only {world} are available")
    _check_whole_world("make_production_mesh", math.prod(shape), world)
    return _device_mesh(device_type, shape, names)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """A ``("data", "model")`` mesh over every rank: one card a rank, or a
    CPU process a rank with ``device_type="cpu"``."""
    _check_device_type(device_type)
    n = _world()
    if n % model:
        raise ValueError(f"make_host_mesh: model={model} does not divide {n} ranks")
    return _device_mesh(device_type, (n // model, model), ("data", "model"))


def data_axis_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in ("pod", "data") if a in shape)


def mesh_device_type(mesh) -> Optional[str]:
    """The device type a ``DeviceMesh`` lives on (``None`` for a shape-only mesh)."""
    return getattr(mesh, "device_type", None)
