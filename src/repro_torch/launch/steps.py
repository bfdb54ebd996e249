"""The step of every (arch x shape x mesh), its inputs and their placements,
as ``repro.launch.steps``.

Three kinds:
  train   -> the spatio-temporal split train step (client banks over the
             data axes, every data shard one hospital; the trunk
             tensor-parallel over ``model`` and data-parallel over the data
             axes; AdamW; the detached cut), float32;
  prefill -> the full forward's logits (the paper's cut inline);
  decode  -> ``serve_step``: ONE token against a KV cache / SSM state of
             ``seq_len``.

A :class:`Lowering` is the reference's: ``fn`` the step, ``args`` its
inputs as fake tensors of the WHOLE shapes (the reference's
``ShapeDtypeStruct``s, made under ``mode``, a ``FakeTensorMode``),
``in_placements``/``out_placements`` a ``PartitionSpec`` a leaf (the
reference's ``in_shardings``/``out_shardings``; :func:`dtensor_placements`
gives them as DTensor placements). ``fn`` is the program every rank runs
(SPMD): it takes the rank's blocks of ``args`` (:func:`local_args`) on a
``DeviceMesh`` of the grid's shape, whose process group may be the fake
backend (``launch.dryrun``). The reference's rng key is the model noise
here, an input (``None`` where the config adds none at the cut).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import distributed
from repro_torch.launch.mesh import axis_names, data_axis_size
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.models.transformer import ModelOptions
from repro_torch.optim import adamw
from repro_torch.sharding.collectives import MeshAxis
from repro_torch.sharding.logical import P, spec_placements
from repro_torch.sharding.specs import _axes_size, _map_specs, batch_specs, tree_specs
from repro_torch.sharding.tensor_parallel import LMParallel, local_shard, mesh_axis, whole_of

TRAIN_DTYPE = torch.float32  # the port's llm-split trains in float32 (one flat buffer)


class Lowering(NamedTuple):
    fn: Any               # the rank's step
    args: tuple           # fake tensors of the whole shapes
    in_placements: tuple  # a PartitionSpec a leaf of args
    out_placements: Any
    kind: str
    mode: Any             # the FakeTensorMode the args live in


def production_opts(cfg: ModelConfig, mesh, *, kind: str,
                    base: Optional[ModelOptions] = None) -> ModelOptions:
    opts = base or ModelOptions()
    dsz = data_axis_size(mesh)
    return dataclasses.replace(opts, moe_chunks=dsz if (cfg.n_experts and kind != "decode") else 1)


def _fake(shapes, mode):
    """``{name: (shape, dtype)}`` as fake tensors."""
    with mode:
        return {k: torch.empty(s, dtype=dt) for k, (s, dt) in shapes.items()}


def _axis(mesh, name) -> Optional[MeshAxis]:
    return MeshAxis(mesh, name) if name is not None and name in axis_names(mesh) else None


def local_args(lowering: Lowering, mesh) -> tuple:
    """This rank's blocks of ``lowering.args`` (fake tensors, in its mode)."""
    def walk(tree, specs):
        if isinstance(tree, dict):
            return {k: walk(v, specs[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, s) for v, s in zip(tree, specs))
        if not isinstance(tree, torch.Tensor):
            return tree
        return local_shard(tree, specs, mesh)

    with lowering.mode:
        return tuple(walk(a, s) for a, s in zip(lowering.args, lowering.in_placements))


def rank_bytes(lowering: Lowering, mesh, n_args: Optional[int] = None) -> int:
    """Bytes of the rank's blocks of ``lowering.args`` (the first ``n_args``)
    under their placements; on any mesh, a shape-only one included."""
    total = 0

    def walk(tree, specs):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, specs[k])
        elif isinstance(tree, (list, tuple)):
            for v, s in zip(tree, specs):
                walk(v, s)
        elif isinstance(tree, torch.Tensor):
            total += math.prod(d // _axes_size(mesh, ax) for d, ax in zip(tree.shape, specs)) \
                * tree.element_size()
        elif isinstance(tree, np.generic):  # the decode position, a replicated int32
            total += tree.nbytes

    for a, s in list(zip(lowering.args, lowering.in_placements))[:n_args]:
        walk(a, s)
    return total


def dtensor_placements(specs, mesh):
    """A placement tree's specs as DTensor placements, one list a leaf."""
    return _map_specs(lambda s: spec_placements(s, mesh), specs)


def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh,
                opts: Optional[ModelOptions] = None, *, zero1: bool = False,
                shared_bank: bool = False) -> Lowering:
    ucfg = distributed.untie(cfg)
    opts = production_opts(ucfg, mesh, kind="train", base=opts)
    C = data_axis_size(mesh)  # one client a data shard
    if shape.global_batch % C:
        raise ValueError(f"global batch {shape.global_batch} does not divide over {C} clients "
                         "(one a data shard)")
    b = shape.global_batch // C
    opt = adamw(3e-4, weight_decay=0.1)
    mode = FakeTensorMode()
    with mode:
        state = distributed.init_llm_state(torch.Generator(), cfg, C, opt, dtype=TRAIN_DTYPE,
                                           shared_bank=shared_bank, device="cpu")
    per_client = model_lib.make_batch_shapes(ucfg, shape, batch_override=b)
    batch = _fake({k: ((C,) + s, dt) for k, (s, dt) in per_client.items()}, mode)
    noise = None
    if ucfg.privacy_noise > 0.0:
        noise = _fake({"n": ((C, b, shape.seq_len, ucfg.d_model), TRAIN_DTYPE)}, mode)["n"]
    state_specs = distributed.llm_state_specs(state, mesh, shared_bank=shared_bank, zero1=zero1)
    batch_sp = batch_specs(batch, mesh)
    noise_sp = None if noise is None else batch_specs(noise, mesh)
    made = []  # the step is made on the ranks' mesh at its first call

    def step(state, batch, model_noise=None):
        if not made:
            made.append(distributed.make_guarded_llm_step(ucfg, opts, opt, C,
                                                          shared_bank=shared_bank, mesh=mesh,
                                                          zero1=zero1))
        return made[0](state, batch, model_noise)

    return Lowering(fn=step, args=(state, batch, noise),
                    in_placements=(state_specs, batch_sp, noise_sp),
                    out_placements=(state_specs, None), kind="train", mode=mode)


def _params(cfg: ModelConfig, mode):
    with mode:
        return model_lib.init_model(torch.Generator(), cfg, device="cpu")


def _lm_parallel(mesh, *, data: bool, seq=None, fetch=None) -> LMParallel:
    daxes = distributed.data_axes_of(mesh)
    return LMParallel(_axis(mesh, "model"), data=MeshAxis(mesh, daxes) if data and daxes else None,
                      seq=seq, fetch=fetch)


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  opts: Optional[ModelOptions] = None) -> Lowering:
    opts = production_opts(cfg, mesh, kind="prefill", base=opts)
    mode = FakeTensorMode()
    params = _params(cfg, mode)
    shapes = model_lib.make_batch_shapes(cfg, shape)
    shapes.pop("labels", None)
    batch = _fake(shapes, mode)

    def fn(params, batch):
        return model_lib.prefill(params, cfg, batch, opts, tp=_lm_parallel(mesh, data=True))

    return Lowering(fn=fn, args=(params, batch),
                    in_placements=(tree_specs(params, mesh), batch_specs(batch, mesh)),
                    out_placements=None, kind="prefill", mode=mode)


def _subtree(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def _fetch_2d(param_specs, mesh):
    """``decode_step``'s ``fetch`` under the 2-D weight placement: a leaf
    whose dim shards over the data axes and ``model`` jointly (one
    flattened group) is gathered over that group where its block runs and
    cut to its ``model`` chunk, the layout the blocks take."""
    model = MeshAxis(mesh, "model")

    def fetch(sub, path, g=None):
        specs = _subtree(param_specs, path)

        def one(x, spec):
            if g is not None:
                x, spec = x[g], spec[1:]
            for dim, axes in enumerate(spec):
                if isinstance(axes, tuple) and "model" in axes:
                    x = model.local(mesh_axis(mesh, axes).gather(x, dim), dim)
            return x

        def walk(t, s):
            if isinstance(t, dict):
                return {k: walk(v, s[k]) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(walk(v, ss) for v, ss in zip(t, s))
            return one(t, s)

        return walk(sub, specs)

    return fetch


def _state_leaf_specs(state_specs):
    """``(name, spec without the groups' dim)`` of every decode-state leaf."""
    found = []

    def visit(specs, path=""):
        if isinstance(specs, dict):
            for k, v in specs.items():
                visit(v, f"{path}/{k}")
        elif isinstance(specs, list):
            for v in specs:
                visit(v, path)
        else:
            found.append((path.rsplit("/", 1)[-1], specs[1:] if "/groups" in path else specs))

    visit(state_specs)
    return found


def _state_batch_axes(state_specs):
    """The axes a decode state's rows shard over (the rules shard the batch
    over ``"data"`` alone, the tokens over every data axis)."""
    axes = {spec[0] for _, spec in _state_leaf_specs(state_specs)}
    if len(axes) != 1:
        raise ValueError(f"the decode state's rows shard over {axes}: one layout wanted")
    return axes.pop()


def _cache_seq_axis(state_specs, mesh):
    """The axes a KV cache's positions shard over (the B = 1 rule), if any."""
    found = [spec[1] for name, spec in _state_leaf_specs(state_specs)
             if name == "k" and spec[1] is not None]
    return _axis(mesh, found[0]) if found else None


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 opts: Optional[ModelOptions] = None,
                 weights_2d: Optional[bool] = None) -> Lowering:
    opts = production_opts(cfg, mesh, kind="decode", base=opts)
    B = shape.global_batch
    if weights_2d is None:
        # B < data idles the data axis for batch: weight shards go there too
        # (the reference's choice; hybrid stays out, as there)
        weights_2d = B < data_axis_size(mesh) and cfg.family != "hybrid"
    mode = FakeTensorMode()
    params = _params(cfg, mode)
    with mode:
        state = model_lib.init_decode_state(cfg, B, shape.seq_len, device="cpu")
        tokens = torch.empty((B, 1), dtype=torch.int32)
    param_specs = tree_specs(params, mesh, weights_2d=weights_2d)
    state_specs = tree_specs(state, mesh)
    tok_spec = batch_specs(tokens, mesh)
    rows = _state_batch_axes(state_specs)

    def fn(params, state, tokens, pos):
        tp = _lm_parallel(mesh, data=False, seq=_cache_seq_axis(state_specs, mesh),
                          fetch=_fetch_2d(param_specs, mesh) if weights_2d else None)
        if rows != tok_spec[0]:
            # the state's rows shard over "data" alone where the tokens' shard over
            # ("pod", "data"): the rank takes the tokens of its state's rows
            tokens = local_shard(whole_of(tokens, tok_spec, mesh), P(rows, None), mesh)
        return model_lib.serve_step(params, cfg, state, tokens, int(pos), opts, tp=tp)

    return Lowering(fn=fn, args=(params, state, tokens, np.int32(shape.seq_len - 1)),
                    in_placements=(param_specs, state_specs, tok_spec, P()),
                    out_placements=(None, state_specs), kind="decode", mode=mode)


def build(cfg: ModelConfig, shape: ShapeConfig, mesh,
          opts: Optional[ModelOptions] = None, **kw) -> Lowering:
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, opts, **kw)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, opts)
    return build_decode(cfg, shape, mesh, opts)


def build_group_probe(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      opts: Optional[ModelOptions] = None) -> Optional[Lowering]:
    """One group's body alone (train: the gradient of its summed output
    with respect to its parameters and its input). The reference needs it
    to correct XLA's count of a scanned body; here the dry-run counts every
    group of the traced step, and the tests hold the step to the groups
    outside plus ``n_groups`` probes."""
    ucfg = distributed.untie(cfg) if shape.kind == "train" else cfg
    opts = production_opts(ucfg, mesh, kind=shape.kind, base=opts)
    n_client, n_prefix, n_groups = transformer.stack_split(ucfg)
    if n_groups <= 1:
        return None
    period = transformer.period_of(ucfg)
    start = n_client + n_prefix
    mode = FakeTensorMode()
    dtype = TRAIN_DTYPE if shape.kind == "train" else getattr(torch, ucfg.dtype)
    with mode:
        groups = transformer.init_server(torch.Generator(), ucfg, dtype, "cpu")["groups"]
        grp = tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype), groups)
        B = shape.global_batch
        S = 1 if shape.kind == "decode" else shape.seq_len
        h = torch.empty((B, S, ucfg.d_model), dtype=dtype)
        positions = torch.empty((B, S), dtype=torch.int32)
    grp_specs = tree_specs({"probe": grp}, mesh)["probe"]
    h_spec, pos_spec = batch_specs(h, mesh), batch_specs(positions, mesh)

    if shape.kind == "decode":
        with mode:
            dstate = model_lib.init_decode_state(ucfg, B, shape.seq_len, device="cpu")["groups"]
            st = tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype), dstate)
        st_specs = tree_specs({"probe": st}, mesh)["probe"]

        rows = _state_batch_axes(st_specs)

        def probe_decode(grp, h, state, pos):
            tp = _lm_parallel(mesh, data=False)
            if rows != h_spec[0]:  # as build_decode's tokens
                h = local_shard(whole_of(h, h_spec, mesh), P(rows, None, None), mesh)
            new_state = {}
            for p in range(period):
                h, new_state[f"pos{p}"] = transformer.apply_block_decode(
                    grp[f"pos{p}"], ucfg, start + p, h, state[f"pos{p}"], int(pos), tp)
            return h, new_state

        return Lowering(fn=probe_decode, args=(grp, h, st, np.int32(shape.seq_len - 1)),
                        in_placements=(grp_specs, h_spec, st_specs, P()),
                        out_placements=None, kind="probe-decode", mode=mode)

    def group_fwd(grp, h, positions):
        tp = _lm_parallel(mesh, data=True)
        for p in range(period):
            h, _ = transformer.apply_block(grp[f"pos{p}"], ucfg, start + p, h, positions, opts,
                                           tp)
        return h

    if shape.kind == "prefill":
        return Lowering(fn=group_fwd, args=(grp, h, positions),
                        in_placements=(grp_specs, h_spec, pos_spec), out_placements=None,
                        kind="probe-prefill", mode=mode)

    def probe_train(grp, h, positions):
        leaves = [x.requires_grad_(True) for x in tree_leaves(grp)] + [h.requires_grad_(True)]
        with torch.enable_grad():
            out = group_fwd(grp, h, positions)
            return torch.autograd.grad(torch.sum(out.float()), leaves)

    return Lowering(fn=probe_train, args=(grp, h, positions),
                    in_placements=(grp_specs, h_spec, pos_spec), out_placements=None,
                    kind="probe-train", mode=mode)


