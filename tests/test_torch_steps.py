"""``repro_torch.launch.steps`` against ``repro.launch.steps``: the
placement of every input leaf, and the bytes a rank holds, for every
(arch x shape) that ``shape_applicable`` admits, on the production grids
(16, 16) and (2, 16, 16), ``zero1`` both ways for train.

Both sides run with no devices: the reference's ``steps_lib.build`` on a
``jax.sharding.AbstractMesh`` (no compile), the port's ``steps.build`` on
the shape-only ``ShapeMesh``, its inputs fake tensors. Specs must be equal
leaf for leaf (by path); the bytes a rank holds equal the sum over leaves
of ``NamedSharding(...).shard_shape`` times the item size, train compared
at float32 on both sides (the port trains in float32; the reference's
state takes the config's dtype).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import steps as j_steps
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.configs.base import shape_applicable
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import ModelOptions
from repro_torch.sharding.logical import PartitionSpec

GRIDS = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}
COMBOS = [(a, s) for a in sorted(list_configs()) for s in SHAPES
          if not shape_applicable(get_config(a), SHAPES[s])]


def _j_mesh(grid):
    names = ("pod", "data", "model") if len(grid) == 3 else ("data", "model")
    return AbstractMesh(grid, names)


def port_specs(tree, prefix=""):
    """``{path: spec tuple}`` of a port placement tree."""
    if isinstance(tree, PartitionSpec):
        return {prefix: tuple(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_specs(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(port_specs(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {}


def _key(p):
    return str(p.key) if hasattr(p, "key") else str(getattr(p, "idx", p))


def jax_specs(shardings, prefix=""):
    leaves = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    out = {}
    for path, s in leaves:
        key = "/".join(_key(p) for p in path)
        out[f"{prefix}/{key}" if prefix and key else (prefix or key)] = tuple(s.spec)
    return out


_J_CACHE = {}


def reference(arch, shape, grid, zero1):
    key = (arch, shape, grid, zero1)
    if key not in _J_CACHE:
        kw = {"zero1": zero1} if J_SHAPES[shape].kind == "train" else {}
        _J_CACHE[key] = j_steps.build(j_get_config(arch), J_SHAPES[shape], _j_mesh(grid), **kw)
    return _J_CACHE[key]


def port(arch, shape, grid, zero1):
    mesh = make_production_mesh(shape=grid, shape_only=True)
    kw = {"zero1": zero1} if SHAPES[shape].kind == "train" else {}
    return steps.build(get_config(arch), SHAPES[shape], mesh, **kw), mesh


def _cases():
    for gname in GRIDS:
        for a, s in COMBOS:
            for z in ((False, True) if SHAPES[s].kind == "train" else (False,)):
                yield pytest.param(a, s, gname, z, id=f"{a}-{s}-{gname}" + ("-zero1" if z else ""))


@pytest.mark.parametrize("arch,shape,grid,zero1", list(_cases()))
def test_placements_and_rank_bytes_equal_the_reference(arch, shape, grid, zero1):
    g = GRIDS[grid]
    ref = reference(arch, shape, g, zero1)
    low, mesh = port(arch, shape, g, zero1)
    kind = SHAPES[shape].kind
    names = {"train": ("state", "batch"), "prefill": ("params", "batch"),
             "decode": ("params", "state", "tokens", "pos")}[kind]
    for i, name in enumerate(names):
        got = port_specs(low.in_placements[i], name)
        want = jax_specs(ref.in_shardings[i], name)
        assert got == want, (name, {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                                    if got.get(k) != want.get(k)})
    # the bytes a rank holds of the same inputs
    port_bytes = steps.rank_bytes(low, mesh, n_args=len(names))
    ref_bytes = 0
    for i in range(len(names)):
        args, shard = ref.args[i], ref.in_shardings[i]
        if kind == "train" and i == 0:  # the state at float32, as the port trains
            args = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
                a.shape, jnp.float32 if jnp.issubdtype(a.dtype, jnp.floating) else a.dtype),
                args)
        for a, s in zip(jax.tree.leaves(args), jax.tree.leaves(
                shard, is_leaf=lambda x: isinstance(x, NamedSharding))):
            ref_bytes += math.prod(s.shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
    assert port_bytes == ref_bytes


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "llama3.2-1b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_production_opts_equal_the_reference(arch, kind):
    from repro.models.transformer import ModelOptions as JOpts

    for g in GRIDS.values():
        got = steps.production_opts(get_config(arch), make_production_mesh(shape=g,
                                                                           shape_only=True),
                                    kind=kind, base=ModelOptions(q_block=512))
        want = j_steps.production_opts(j_get_config(arch), _j_mesh(g), kind=kind,
                                       base=JOpts(q_block=512))
        assert (got.moe_chunks, got.q_block) == (want.moe_chunks, want.q_block)


def test_decode_weights_2d_is_the_references_choice():
    """B = 1 decode puts weight shards on the data axes too, except hybrid."""
    mesh = make_production_mesh(shape=(16, 16), shape_only=True)
    for arch in ("falcon-mamba-7b", "mixtral-8x7b", "jamba-1.5-large-398b"):
        low = steps.build(get_config(arch), SHAPES["long_500k"], mesh)
        ref = reference(arch, "long_500k", (16, 16), False)
        assert port_specs(low.in_placements[0], "p") == jax_specs(ref.in_shardings[0], "p")
    dt = steps.dtensor_placements(low.in_placements[0], mesh)
    assert all(isinstance(v, list) for v in [dt["client"]["embed"]])


def test_group_probe_shapes_and_kinds():
    mesh = make_production_mesh(shape=(16, 16), shape_only=True)
    for shape, kind in (("train_4k", "probe-train"), ("prefill_32k", "probe-prefill"),
                        ("decode_32k", "probe-decode")):
        low = steps.build_group_probe(get_config("llama3.2-1b"), SHAPES[shape], mesh)
        ref = j_steps.build_group_probe(j_get_config("llama3.2-1b"), J_SHAPES[shape],
                                        _j_mesh((16, 16)))
        assert low.kind == ref.kind == kind
        assert port_specs(low.in_placements[0], "g") == jax_specs(ref.in_shardings[0], "g")
        assert tuple(low.args[1].shape) == tuple(ref.args[1].shape)
    assert steps.build_group_probe(get_config("llama3.2-1b").reduced(), SHAPES["train_4k"],
                                   mesh) is None
