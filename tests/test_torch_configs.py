"""Port ``configs`` against the JAX package's: the same registry, and for
every registered config the same fields (derived ``head_dim``, ``dt_rank``
and ``frontend_dim`` included), ``d_inner``, parameter counts, layer kinds
and ``reduced()`` variant; the same shapes and skip reasons. Exact equality:
these are plain Python values."""
import dataclasses

import pytest

import repro.configs as jax_configs
import repro_torch.configs as port_configs
from repro.configs.base import shape_applicable as jax_shape_applicable

NAMES = sorted(jax_configs.list_configs())


def test_same_registry_and_shapes():
    assert sorted(port_configs.list_configs()) == NAMES
    assert {k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_jax(name):
    want, got = jax_configs.get_config(name), port_configs.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.d_inner == want.d_inner
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert [got.layer_kind(i) for i in range(got.n_layers)] == \
        [want.layer_kind(i) for i in range(want.n_layers)]
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert got.reduced().param_count() == want.reduced().param_count()
    for shape in jax_configs.SHAPES:
        assert port_configs.shape_applicable(got, port_configs.SHAPES[shape]) == \
            jax_shape_applicable(want, jax_configs.SHAPES[shape])


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_config("no-such-arch")


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "mixtral-8x7b", "falcon-mamba-7b",
                                  "jamba-1.5-large-398b"])
def test_moe_ssm_and_hybrid_layouts_match_jax(name):
    """The four MoE, SSM and hybrid configs, full and reduced: each layer's
    kind and MoE flag, ``d_inner``, ``dt_rank`` and the parameter counts
    equal the reference's; at the reduced widths the port's initialiser
    draws exactly ``param_count()`` parameters."""
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.models.transformer import init_params

    for want, got in ((jax_configs.get_config(name), port_configs.get_config(name)),
                      (jax_configs.get_config(name).reduced(),
                       port_configs.get_config(name).reduced())):
        layers = range(want.n_layers)
        assert [got.layer_kind(i) for i in layers] == [want.layer_kind(i) for i in layers]
        assert [got.layer_is_moe(i) for i in layers] == [want.layer_is_moe(i) for i in layers]
        assert (got.d_inner, got.dt_rank) == (want.d_inner, want.dt_rank)
        assert (got.param_count(), got.active_param_count()) == \
            (want.param_count(), want.active_param_count())
    params = init_params(torch.Generator().manual_seed(0), got, torch.float32, device="cpu")
    assert sum(t.numel() for t in tree_leaves(params)) == got.param_count()
