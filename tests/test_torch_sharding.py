"""The port's placement rules (``repro_torch.sharding``) against the JAX
package's, leaf for leaf.

The rules are pure functions of a leaf's path, its shape and the mesh's
axis sizes, so both sides run with no devices: JAX on
``jax.sharding.AbstractMesh``, the port on ``launch.mesh.ShapeMesh`` of the
same names and sizes. Every spec must be equal as a tuple
(``tuple(jax_spec)``), on every leaf, for the grids (1, 1), (4, 2), (2, 4),
(8, 1), (1, 8), (16, 16) and (2, 16, 16) under the split and the
production axis names. The trees: the paper's three models (their params,
the canonical state with stacked banks and AdamW moment trees; VGG19 by its
shapes alone, as meta tensors), and the ``llm-split`` states of reduced
llama3.2-1b, granite-moe-1b-a400m, falcon-mamba-7b and
jamba-1.5-large-398b (``groups`` stacks, banks, a shared bank). The port's
trees come from its own initializers where they are small, so its paths are
its own tree helpers'. A seeded Hypothesis sweep holds ``_fit``'s
divisibility fallback to the reference's over random shapes and specs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, seed, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_get_config
from repro.configs.paper_models import CHOLESTEROL_MLP as J_MLP
from repro.configs.paper_models import COVID_CNN as J_COVID
from repro.configs.paper_models import MURA_VGG19 as J_VGG
from repro.core import distributed as jd
from repro.models.cnn import init_cnn as j_init_cnn
from repro.models.mlp import init_mlp as j_init_mlp
from repro.optim import adamw as j_adamw
from repro.sharding import logical as jl
from repro.sharding import specs as js
from repro_torch.common.device import seeded_generator
from repro_torch.common.tree import tree_map, tree_map_with_path
from repro_torch.configs import CHOLESTEROL_MLP, COVID_CNN, get_config
from repro_torch.core import distributed as td
from repro_torch.launch.mesh import ShapeMesh, make_split_mesh
from repro_torch.models.cnn import init_cnn
from repro_torch.models.mlp import init_mlp
from repro_torch.optim import adamw
from repro_torch.sharding import logical as tl
from repro_torch.sharding import specs as ts
from repro_torch.sharding.logical import PartitionSpec

SPLIT = ("clients", "model")
PROD = ("data", "model")
GRIDS = [((1, 1), SPLIT), ((4, 2), SPLIT), ((2, 4), SPLIT), ((8, 1), SPLIT), ((1, 8), SPLIT),
         ((1, 1), PROD), ((4, 2), PROD), ((2, 4), PROD), ((8, 1), PROD), ((1, 8), PROD),
         ((16, 16), PROD), ((16, 16), SPLIT), ((2, 16, 16), ("pod", "data", "model"))]
GRID_IDS = ["x".join(map(str, s)) + "-" + n[0] for s, n in GRIDS]
LM_CONFIGS = ("llama3.2-1b", "granite-moe-1b-a400m", "falcon-mamba-7b", "jamba-1.5-large-398b")
N_CLIENTS = 4


def meshes(shape, names):
    return AbstractMesh(shape, names), ShapeMesh(shape, names)


def jax_specs(tree):
    """(path string, spec tuple) of every leaf of a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return [(js._path_str(p), tuple(s)) for p, s in flat]


def port_specs(tree):
    """The same for a port spec tree, by the port's own paths, in
    ``tree_leaves`` order (dict keys sorted)."""
    out = []

    def walk(node, path):
        if isinstance(node, PartitionSpec):
            out.append((ts._path_str(path), tuple(node)))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(tree, ())
    return out


def to_meta(tree):
    """A JAX tree of shapes as the port's tree of meta tensors."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return torch.empty(tuple(tree.shape), device="meta")


def stacked(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def paper_states():
    """name -> (JAX tree of shapes, port tree) for the three paper models:
    the canonical state of the queue engines (stacked banks, the server,
    AdamW moment trees over the server)."""
    out = {}
    key = jax.random.PRNGKey(0)
    for name, j_init, t_init, jcfg, tcfg in (
            ("mlp", j_init_mlp, init_mlp, J_MLP, CHOLESTEROL_MLP),
            ("covid", j_init_cnn, init_cnn, J_COVID, COVID_CNN),
            ("vgg19", j_init_cnn, None, J_VGG, None)):
        def j_state(k, j_init=j_init, jcfg=jcfg):
            p = j_init(k, jcfg)
            banks = jax.tree.map(lambda *xs: jnp.stack(xs),
                                 *[j_init(jax.random.fold_in(k, c), jcfg)["client"]
                                   for c in range(N_CLIENTS)])
            return {"client_banks": banks, "server": p["server"],
                    "opt": j_adamw(1e-3).init(p["server"]),
                    "step": jnp.zeros((), jnp.int32)}

        shapes = jax.eval_shape(j_state, key)
        if t_init is None:
            port = to_meta(shapes)
        else:
            gen = seeded_generator(0)
            p = t_init(gen, tcfg, "cpu")
            port = {"client_banks": stacked([t_init(gen, tcfg, "cpu")["client"]
                                             for _ in range(N_CLIENTS)]),
                    "server": p["server"], "opt": adamw(1e-3).init(p["server"]),
                    "step": torch.zeros((), dtype=torch.int32)}
        out[name] = (shapes, port)
    return out


def lm_states():
    """name -> (JAX tree of shapes, port tree): the llm-split canonical
    state of each reduced config (per-client banks, e2e moments over banks
    and server) and a shared-bank detached one."""
    out = {}
    for name in LM_CONFIGS:
        for shared in (False, True):
            mode = "detached" if shared else "e2e"
            jcfg, tcfg = j_get_config(name).reduced(), get_config(name).reduced()
            shapes = jax.eval_shape(
                lambda k, jcfg=jcfg, shared=shared, mode=mode: jd.init_llm_state(
                    k, jcfg, N_CLIENTS, j_adamw(1e-3), shared_bank=shared, mode=mode),
                jax.random.PRNGKey(0))
            port = td.init_llm_state(seeded_generator(0), tcfg, N_CLIENTS, adamw(1e-3),
                                     shared_bank=shared, mode=mode, device="cpu")
            out[f"{name}-{'shared' if shared else 'banked'}"] = (shapes, port)
    return out


@pytest.fixture(scope="module")
def trees():
    return {**paper_states(), **lm_states()}


def assert_same(jax_tree, port_tree, what):
    j, t = jax_specs(jax_tree), port_specs(port_tree)
    assert [p for p, _ in t] == [p for p, _ in j], f"{what}: paths differ"
    bad = [(p, a, b) for (p, a), (_, b) in zip(j, t) if a != b]
    assert not bad, f"{what}: {bad[:5]}"
    return len(j)


# ------------------------------------------------------------ tree rules
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_tree_specs_equal_the_reference(trees, grid):
    jm, tm = meshes(*grid)
    n = 0
    options = [{}, {"banked_client": True}]
    if "data" in grid[1]:  # zero1 and weights_2d act on the data axes
        options += [{"zero1": True}, {"weights_2d": True},
                    {"banked_client": True, "zero1": True, "weights_2d": True}]
    for name, (shapes, port) in trees.items():
        for kw in options:
            n += assert_same(js.tree_specs(shapes, jm, **kw), ts.tree_specs(port, tm, **kw),
                             f"{name} {kw}")
    assert n > 1000


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_trunk_and_bank_specs_equal_the_reference(trees, grid):
    jm, tm = meshes(*grid)
    for name, (shapes, port) in trees.items():
        # the server trunk, and the moment trees that mirror it
        assert_same(js.trunk_specs(shapes["server"], jm), ts.trunk_specs(port["server"], tm),
                    f"{name} trunk")
        assert_same(js.trunk_specs(shapes["opt"], jm), ts.trunk_specs(port["opt"], tm),
                    f"{name} moments")
        if len(grid[1]) == 2:
            assert_same(js.trunk_specs(shapes["server"], jm, axis=grid[1][0]),
                        ts.trunk_specs(port["server"], tm, axis=grid[1][0]),
                        f"{name} trunk over {grid[1][0]}")
        for axis in grid[1][:-1]:  # the grid's client (or data, pod) axes
            assert_same(js.client_bank_specs(shapes["client_banks"], jm, axis),
                        ts.client_bank_specs(port["client_banks"], tm, axis), f"{name} banks")


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_batch_specs_equal_the_reference(grid):
    jm, tm = meshes(*grid)
    rng = np.random.default_rng(0)
    for b in (1, 2, 16, 32, 48):
        batch = {"tokens": np.zeros((N_CLIENTS, b, 8), np.int32),
                 "labels": np.zeros((b, 8), np.int32), "x": np.zeros((b, 64, 64, 1)),
                 "scalar": np.float32(rng.normal())}
        assert_same(js.batch_specs(batch, jm), ts.batch_specs(batch, tm), f"batch {b}")


# ---------------------------------------------------------- logical rules
LOGICAL = [("batch", "seq", "embed"), ("batch", "seq", "heads", "head_dim"),
           ("embed", "ff"), ("vocab", "embed"), ("expert", "embed", "expert_ff"),
           ("client", None, "ssm_inner"), ("clients", "batch", "features"),
           ("trunk_col",), ("trunk_row", "trunk_col"), (None, "unknown")]


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_logical_to_spec_equals_the_reference(grid):
    jm, tm = meshes(*grid)
    for rules_j, rules_t in ((jl.DEFAULT_RULES, tl.DEFAULT_RULES),
                             (jl.SPLIT_RULES, tl.SPLIT_RULES)):
        assert rules_j == rules_t
        for logical in LOGICAL:
            want = tuple(jl.logical_to_spec(logical, rules_j, jm))
            assert tuple(tl.logical_to_spec(logical, rules_t, tm)) == want, logical
            # under the installed rules and mesh, as model code calls it
            with jl.axis_rules(rules_j, jm), tl.axis_rules(rules_t, tm):
                assert tuple(tl.logical_to_spec(logical)) == tuple(jl.logical_to_spec(logical))
                assert tl.current_mesh() is tm and tl.current_rules() is rules_t
        assert tuple(tl.logical_to_spec(("batch", "ff"), rules_t)) == tuple(
            jl.logical_to_spec(("batch", "ff"), rules_j))  # no mesh: every rule kept
    with tl.split_axis_rules(tm):
        assert tl.current_rules() is tl.SPLIT_RULES
    assert tl.current_rules() is None and tl.current_mesh() is None


def test_shard_is_the_identity_without_rules_and_lays_out_under_them():
    x = torch.arange(24.0).reshape(4, 6)
    assert tl.shard(x, "batch", "embed") is x
    with tl.axis_rules(tl.DEFAULT_RULES, ShapeMesh((2, 2), PROD)):
        assert tl.shard(x, "batch", "embed") is x  # a shape-only mesh places nothing
    mesh = make_split_mesh(1, 1, device_type="cpu")
    with tl.split_axis_rules(mesh):
        y = tl.shard(x, "clients", "trunk_col")
    from torch.distributed.tensor import DTensor, Shard

    assert isinstance(y, DTensor) and list(y.placements) == [Shard(0), Shard(1)]
    assert torch.equal(y.full_tensor(), x)
    with tl.split_axis_rules(mesh):
        z = tl.shard(y, "batch", "trunk_col")  # a DTensor is redistributed
    assert [type(p).__name__ for p in z.placements] == ["Replicate", "Shard"]
    assert torch.equal(z.full_tensor(), x)


def test_placements_follow_the_specs():
    mesh = make_split_mesh(1, 1, device_type="cpu")
    tree = {"layers": [{"w": torch.zeros(4, 8), "b": torch.zeros(8)},
                       {"w": torch.zeros(8, 3), "b": torch.zeros(3)}]}
    pl = ts.trunk_placements(tree, mesh)
    names = lambda ps: [f"{type(p).__name__}{getattr(p, 'dim', '')}" for p in ps]  # noqa: E731
    assert names(pl["layers"][0]["w"]) == ["Replicate", "Shard1"]
    assert names(pl["layers"][1]["w"]) == ["Replicate", "Shard0"]
    assert names(pl["layers"][1]["b"]) == ["Replicate", "Replicate"]
    banks = ts.client_bank_placements({"w": torch.zeros(3, 2)}, mesh)
    assert names(banks["w"]) == ["Shard0", "Replicate"]
    prod = ts.tree_placements({"embed": torch.zeros(64, 8)},
                              make_split_mesh(1, 1, device_type="cpu"))
    assert names(prod["embed"]) == ["Replicate", "Shard0"]  # vocab over the model axis


def test_tree_map_with_path_gives_the_reference_paths():
    tree = {"b": [1, (2, {"z": 3})], "a": {"groups": [4]}}
    paths = []
    tree_map_with_path(lambda p, leaf: paths.append(ts._path_str(p)), tree)
    want = [js._path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert sorted(paths) == sorted(want)


# ------------------------------------------------------ _fit, by sweep
AXES = st.sampled_from([None, "data", "model", "pod", ("pod", "data"), ("data", "model"),
                        ("pod", "data", "model")])


@seed(20261017)
@settings(max_examples=300, deadline=None, derandomize=False)
@given(shape=st.lists(st.integers(1, 96), min_size=0, max_size=4),
       axes=st.lists(AXES, min_size=4, max_size=4),
       grid=st.sampled_from([(1, 1, 1), (2, 4, 2), (2, 16, 16), (1, 3, 5), (4, 1, 8)]))
def test_fit_drops_what_does_not_divide_as_the_reference(shape, axes, grid):
    names = ("pod", "data", "model")
    jm, tm = meshes(grid, names)
    spec = axes[: len(shape)]
    want = tuple(js._fit(jm, tuple(shape), spec))
    assert tuple(ts._fit(tm, tuple(shape), spec)) == want
    assert tuple(tl.fit_spec(tuple(shape), spec, tm)) == want
