"""Spatio-temporal split learning over the LM stack, as
``repro.core.distributed``: the kernel of the ``llm-split`` engine
(``core.session.LLMSplitEngine``).

  * per-client parameter banks (embedding + privacy block(s)) with a
    leading ``[n_clients]`` axis, or one shared bank;
  * the server trunk (prefix + groups + an untied head);
  * the cut detached in ``detached`` mode, so no gradient reaches a bank;
  * the ``PrivacyGuard``'s release at the cut: ONE release over all
    clients' ``C*b`` rows a step (its clip is per row, so that equals the
    reference's release per client; one ``dp_release`` call a step where
    the guard clips with ``use_kernel``).

Randomness is an input, as everywhere in the port: the step takes the
clients' standard-normal model noise and guard noise ``[C, b, S, d]`` where
the reference splits its step key (the tests feed the reference's draws).

``llm_step_parts`` holds the step in the FLAT domain, as the fused engine:
the trainable tree is one buffer a dtype (``common.tree.ravel``, in
``ravel_pytree``'s leaf order within each; a float32 state has one, a
bfloat16 config's two: its matrices, and the float32 norms, router,
``A_log``, ``D`` and ``dt_bias``), the model reads views of them, autograd
returns one gradient buffer a dtype, and the clip and the optimizer act on
the buffers. ``apply`` updates the buffers and the optimizer's float32
moments (one buffer a parameter buffer) in place, a slice at a time: the
reference donates its state to the step, and at llama3.2-1b's width a
functional update of the whole buffer would hold several copies of 1.2 B
(``e2e``: 2.1 B) parameters at once.

Dtypes follow the reference's step (``clip_by_global_norm``, ``adamw``,
``apply_updates`` over its trees): a bf16 leaf's gradient is bf16; the
global norm is float32 (each buffer's float32 sum of squares); the clipped
gradient is float32 (a bf16 gradient is never rounded after the scale:
each slice is scaled in float32 as the update reads it); the moments are
float32; the update is rounded to the leaf's dtype, then added to the
weight in that dtype. No float32 copy of a 2-byte buffer is made, only of
a slice.
``make_guarded_llm_step`` wraps it as the reference's functional step over
the canonical state (tree-shaped moments, copied into flat buffers a step).

Multi-client split learning needs an UNTIED head: a tied embedding would
hand every client's embedding to the server. State init and the step
factories untie.

Meshes. A ``make_split_mesh`` grid whose model axis is 1 keeps the state
whole on every rank (each rank runs its clients' banks, the features are
all-gathered over the client axis, the trunk runs on every rank). Over a
model axis above 1, and on the production grids (``("data", "model")``,
``("pod", "data", "model")``, one client a data shard, as
``launch.steps``), the state is SHARDED (:func:`llm_state_specs`): a rank
holds the trunk, its flat gradient and its AdamW moments only as its
blocks (``trunk_specs`` on a split grid, ``tree_specs`` on a production
grid), and only its own clients' banks; the flat buffer is the rank's
blocks in ``ravel`` order. The blocks run tensor-parallel
(``sharding.tensor_parallel.LMParallel``); on a production grid each data
rank runs the trunk on its own clients' rows and the gradient is averaged
over the data axes (one all-reduce), the MoE routing each data rank's
tokens on its own. The global-norm clip sums the squares of the blocks
each rank counts once (``tensor_parallel.owner``) in one all-reduce.
``to_canonical`` gathers the whole state (every rank calls it, with
``sharding.tensor_parallel.whole_tree``), and ``shard_tree`` places a
whole one, so checkpoints stay the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import buffers, dtype_groups, ravel, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapters import SplitAdapter
from repro_torch.core.trainer import CLIENT_AXIS, MODEL_AXIS, check_mesh
from repro_torch.launch.mesh import axis_names, mesh_device_type, mesh_shape
from repro_torch.models import transformer
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.models.model import MOE_AUX_WEIGHT
from repro_torch.models.transformer import ModelOptions, positions_for
from repro_torch.optim.optimizers import Optimizer
from repro_torch.privacy.accountant import budget_advance, budget_init
from repro_torch.privacy.guard import DPConfig, PrivacyGuard
from repro_torch.sharding.collectives import (
    MeshAxis,
    all_reduce_world_,
    gather,
    gather_chunks_,
)
from repro_torch.sharding.logical import P
from repro_torch.sharding.specs import (
    _axes_size,
    client_bank_specs,
    spec_leaves,
    tree_specs,
    trunk_specs,
)
from repro_torch.sharding.tensor_parallel import LMParallel, owner

# elements of the flat buffer a slice of the in-place update takes: the
# update's temporaries stay a few hundred MB whatever the model's size
UPDATE_SLICE = 1 << 26


def untie(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, tie_embeddings=False) if cfg.tie_embeddings else cfg


def _shift(cfg: ModelConfig, logits, labels):
    if cfg.is_encoder_only:
        return logits, labels
    return logits[:, :-1], labels[:, 1:]


@dataclasses.dataclass(frozen=True)
class LLMSplitAdapter(SplitAdapter):
    """A :class:`SplitAdapter` that also carries the transformer config:
    the ``llm-split`` engine reads ``cfg``/``opts``/``dtype`` from it."""

    cfg: Optional[ModelConfig] = None
    opts: ModelOptions = ModelOptions()
    dtype: Any = None


def llm_adapter(cfg: ModelConfig, opts: ModelOptions = ModelOptions(),
                dtype: Optional[torch.dtype] = None) -> LLMSplitAdapter:
    """Adapter over ``models.transformer`` for the ``llm-split`` engine.

    ``client_forward(bank, x, noise=None)`` dispatches on the input's
    dtype: integer inputs are token batches and run the whole hospital side
    (embedding + privacy blocks + cut); FLOAT inputs are pre-embedded states
    ``[B, S, d]`` and run the privacy blocks + cut only, the surface that
    ``SplitSession.audit_privacy`` attacks. ``noise`` is the cut's standard
    normal model noise (``None``: none)."""
    cfg = untie(cfg)

    def client_forward(client_params, x, noise=None):
        x = torch.as_tensor(x)
        if not x.is_floating_point():
            h, _, _ = transformer.client_forward(client_params, cfg, {"tokens": x}, opts, noise)
            return h
        h = x
        positions = positions_for(h.shape[0], h.shape[1], h.device)
        for i, blk in enumerate(client_params["blocks"]):
            h, _ = transformer.apply_block(blk, cfg, i, h, positions, opts)
        return transformer.privacy_cut(cfg, h, opts, noise)

    def server_forward(server_params, feats):
        positions = positions_for(feats.shape[0], feats.shape[1], feats.device)
        logits, _aux = transformer.server_forward(server_params, cfg, feats, positions, opts)
        return logits

    def loss(logits, labels):
        return softmax_cross_entropy(*_shift(cfg, logits, labels))

    def metrics(logits, labels):
        lg, lb = _shift(cfg, logits, labels)
        pred = torch.argmax(lg, dim=-1)
        return {"loss": softmax_cross_entropy(lg, lb),
                "accuracy": torch.mean((pred == lb.long()).float())}

    return LLMSplitAdapter(
        name=cfg.name,
        init=lambda generator, device=None: transformer.init_params(generator, cfg, dtype,
                                                                    device),
        client_forward=client_forward,
        server_forward=server_forward,
        loss=loss,
        metrics=metrics,
        feature_shape=lambda shape: (shape[0], shape[1], cfg.d_model),
        noise_scale=cfg.privacy_noise,
        cfg=cfg,
        opts=opts,
        dtype=dtype,
    )


def init_llm_params(generator: torch.Generator, cfg: ModelConfig, n_clients: int,
                    dtype=None, shared_bank: bool = False, device=None):
    """``(client_banks, server)`` drawn from ``generator``: the server trunk,
    then one bank (``shared_bank``) or ``n_clients`` banks stacked on a
    leading axis. The draws are the port's own."""
    cfg = untie(cfg)
    server = transformer.init_server(generator, cfg, dtype, device)
    if shared_bank:
        return transformer.init_client(generator, cfg, dtype, device), server
    banks = [transformer.init_client(generator, cfg, dtype, device) for _ in range(n_clients)]
    return tree_map(lambda *xs: torch.stack(xs), *banks), server


def init_llm_state(generator: torch.Generator, cfg: ModelConfig, n_clients: int,
                   opt: Optimizer, dtype=None, shared_bank: bool = False,
                   mode: str = "detached", device=None) -> dict:
    """The canonical state of the LM split workload: stacked banks (or one
    shared bank, no leading axis), the server, the optimizer's moment trees
    over the trainable part (the server; ``e2e``: ``{"server",
    "client_banks"}``), the int32 step and the budget, on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    banks, server = init_llm_params(generator, cfg, n_clients, dtype, shared_bank, device)
    trainable = server if mode == "detached" else {"server": server, "client_banks": banks}
    return {
        "client_banks": banks,
        "server": server,
        "opt": opt.init(trainable),
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "privacy": budget_init(device),
    }


class LLMStepParts(NamedTuple):
    """The guarded step in the flat domain (see :func:`llm_step_parts`)."""

    grad: Callable[..., Any]
    apply: Callable[..., torch.Tensor]
    detached: bool


def _client_axis(mesh, n_clients: int) -> Optional[MeshAxis]:
    """The mesh's client axis for the whole-state step (``None``: no mesh
    or no client axis)."""
    if mesh is None:
        return None
    names = axis_names(mesh)
    if CLIENT_AXIS not in names:
        return None
    size = mesh_shape(mesh)[CLIENT_AXIS]
    if n_clients % size != 0:
        raise ValueError(
            f"n_clients={n_clients} does not divide over mesh axis {CLIENT_AXIS!r} of size "
            f"{size}; the stacked client banks shard their leading axis evenly")
    return MeshAxis(mesh, CLIENT_AXIS)


def data_axes_of(mesh):
    """The production grid's data axes: ``"data"``, or ``("pod", "data")``
    flattened (``None`` without a ``"data"`` axis)."""
    names = axis_names(mesh)
    axes = tuple(a for a in ("pod", "data") if a in names)
    if "data" not in axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def is_production(mesh) -> bool:
    """A production grid: data axes and no ``"clients"`` axis."""
    return data_axes_of(mesh) is not None and CLIENT_AXIS not in axis_names(mesh)


def is_sharded(mesh) -> bool:
    """Whether ``llm-split`` shards its state on ``mesh``: a model axis above
    1, or a production grid."""
    if mesh is None:
        return False
    return mesh_shape(mesh).get(MODEL_AXIS, 1) > 1 or is_production(mesh)


class Layout(NamedTuple):
    """How the sharded step lays out on its mesh: ``clients`` the axis the
    banks shard over (``"clients"``, or a production grid's data axes),
    ``model`` the model axis, ``production`` whether the trunk is
    data-parallel over ``clients`` and placed by ``tree_specs``."""

    clients: Optional[MeshAxis]
    model: Optional[MeshAxis]
    production: bool


def llm_layout(mesh, n_clients: int) -> Layout:
    names = axis_names(mesh)
    production = is_production(mesh)
    cname = data_axes_of(mesh) if production else (CLIENT_AXIS if CLIENT_AXIS in names else None)
    clients = None if cname is None else MeshAxis(mesh, cname)
    if clients is not None and n_clients % clients.size:
        raise ValueError(f"n_clients={n_clients} does not divide over mesh axis {cname!r} of "
                         f"size {clients.size}; the stacked client banks shard their leading "
                         "axis evenly")
    model = MeshAxis(mesh, MODEL_AXIS) if MODEL_AXIS in names else None
    return Layout(clients, model, production)


def llm_state_template(cfg: ModelConfig, n_clients: int, opt: Optimizer, dtype=None,
                       shared_bank: bool = False, mode: str = "detached") -> dict:
    """The canonical state's leaves as fake tensors (shapes and dtypes, no
    storage; the reference's ``jax.eval_shape`` of ``init_llm_state``)."""
    with FakeTensorMode():
        return init_llm_state(torch.Generator(), cfg, n_clients, opt, dtype=dtype,
                              shared_bank=shared_bank, mode=mode, device="cpu")


def llm_state_specs(state: dict, mesh, *, shared_bank: bool = False, mode: str = "detached",
                    zero1: bool = False) -> dict:
    """The canonical state's placement on ``mesh`` (a spec a leaf).

    A production grid places it as ``launch.steps.build_train`` (the
    reference's): the banks by ``tree_specs(banked_client=True)`` (their
    leading client dim over the data axes, their leaves over ``model``), the
    server by ``tree_specs``, the moments by ``tree_specs(zero1=)``. A
    ``make_split_mesh`` grid: the banks' leading dim over ``"clients"``
    (``client_bank_specs``; a shared bank whole), the trunk and the moments
    that mirror it by ``trunk_specs``. The step and the budget replicate."""
    replicated = lambda tree: tree_map(lambda x: P(*([None] * x.dim())), tree)  # noqa: E731
    banks = state["client_banks"]
    if is_production(mesh):
        if mode != "detached":
            raise ValueError("the production grids train the detached split (the reference's "
                             "launch.steps); e2e runs on make_split_mesh grids")
        bank_specs = tree_specs({"client_banks": banks}, mesh,
                                banked_client=not shared_bank)["client_banks"]
        server_specs = tree_specs(state["server"], mesh)
        opt_specs = tree_specs(state["opt"], mesh, zero1=zero1)
    else:
        if zero1:
            raise ValueError("zero1 places the moments over a production grid's data axes")
        bank_specs = replicated(banks) if shared_bank else client_bank_specs(banks, mesh)
        server_specs = trunk_specs(state["server"], mesh)
        trainable = (server_specs if mode == "detached"
                     else {"server": server_specs, "client_banks": bank_specs})
        opt_specs = {k: trainable for k in state["opt"]}
    return {"client_banks": bank_specs, "server": server_specs, "opt": opt_specs,
            "step": P(), "privacy": replicated(state["privacy"])}


def _owned_segments(trainable_specs, template, mesh):
    """Per buffer of ``ravel`` (:func:`common.tree.dtype_groups` of
    ``template``'s leaves): ``(lo, hi)`` ranges of this rank's blocks in it
    that it counts in the global norm, adjacent ranges merged."""
    leaves, specs = tree_leaves(template), spec_leaves(trainable_specs)
    out = []
    for group in dtype_groups(leaves):
        segs, off = [], 0
        for i in group:
            n = math.prod(_local_shape(leaves[i].shape, specs[i], mesh))
            if owner(specs[i], mesh):
                if segs and segs[-1][1] == off:
                    segs[-1] = (segs[-1][0], off + n)
                else:
                    segs.append((off, off + n))
            off += n
        out.append(segs)
    return out


def _local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    return tuple(d // _axes_size(mesh, ax) for d, ax in zip(shape, spec))


def _zero1_plan(tr_specs, opt_specs, template, mesh):
    """Per buffer of ``ravel``, per trainable leaf in it: its block's shape,
    its moments' block's shape and the dim (or ``None``) along which ZeRO-1
    splits the moments' block further over the data axes."""
    rows = []
    for leaf, ps, ms in zip(tree_leaves(template), spec_leaves(tr_specs), spec_leaves(opt_specs)):
        dims = [i for i, (a, b) in enumerate(zip(ps, ms)) if a != b]
        rows.append((_local_shape(leaf.shape, ps, mesh), _local_shape(leaf.shape, ms, mesh),
                     dims[0] if dims else None))
    return [[rows[i] for i in group] for group in dtype_groups(tree_leaves(template))]


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The clipped gradient ``g * scale`` in float32, as the reference's
    (a 2-byte ``g`` times the float32 scale is float32 there)."""
    return g.float() * scale


def _apply_zero1_(opt, flat, opt_state, step, g, scale, plan, data: MeshAxis) -> None:
    """The optimizer's update of one buffer with the moments sharded over
    the data axes (ZeRO-1): each leaf's data chunk of its block updated
    with the moments' chunk, then the block all-gathered over the data
    axes. ``g`` is clipped by ``scale`` as the update reads it."""
    p_views = torch.split(flat, [math.prod(p) for p, _, _ in plan])
    g_views = torch.split(g, [math.prod(p) for p, _, _ in plan])
    m_views = {k: torch.split(v, [math.prod(m) for _, m, _ in plan]) for k, v in opt_state.items()}
    for i, (p_shape, m_shape, dim) in enumerate(plan):
        p, gg = p_views[i].view(p_shape), g_views[i].view(p_shape)
        moments = {k: v[i].view(m_shape) for k, v in m_views.items()}
        if dim is None:
            upd, new = opt.update(_clipped(gg, scale), moments, p, step)
            p += upd
        else:
            part = data.local(p, dim)
            upd, new = opt.update(_clipped(data.local(gg, dim), scale), moments, part, step)
            p.copy_(data.gather(part + upd, dim))
        for k, v in new.items():
            moments[k].copy_(v)


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of squares of a 1-D buffer; a 2-byte one a slice at
    a time, so that no float32 copy of it is made."""
    if x.dtype == torch.float32:
        return torch.square(torch.linalg.vector_norm(x))
    sq = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, x.numel(), UPDATE_SLICE):
        sq = sq + torch.sum(torch.square(x[lo:lo + UPDATE_SLICE].float()))
    return sq


def _global_norm(g) -> torch.Tensor:
    """The float32 global norm of a gradient (one buffer, or one a dtype)."""
    if isinstance(g, torch.Tensor) and g.dtype == torch.float32:
        return torch.linalg.vector_norm(g)  # no temporary of the buffer's size
    return torch.sqrt(sum((_sumsq(x) for x in buffers(g)),
                          torch.zeros((), dtype=torch.float32, device=buffers(g)[0].device)))


def _check_buffers(g, n: int, dtype) -> None:
    if len(buffers(g)) != n:
        raise ValueError(f"the step was built for {n} buffer(s) (dtype={dtype}), got "
                         f"{len(buffers(g))}: pass the state's dtype as dtype=")


def _client_rows(cfg, opts, guard, shared_bank, banks, inputs, model_noise, guard_noise,
                 plan_clients, tp=None):
    """The client stage of the clients whose rows ``inputs`` hold (a leading
    dim a client; ``banks`` those clients' stacked banks, or the shared
    one; the noise cut alike): each bank on its client's rows, the features
    concatenated ``[n*b, S, d]`` (paper Alg. 1 l.11) and released by the
    guard, its plan chosen for ``plan_clients * b`` rows (``None``: these
    rows). ``tp``: the banks' blocks over a model axis."""
    n = next(iter(inputs.values())).shape[0]
    feats = torch.stack([
        transformer.client_forward(
            banks if shared_bank else tree_map(lambda a, i=i: a[i], banks),
            cfg, {k: v[i] for k, v in inputs.items()}, opts,
            None if model_noise is None else model_noise[i], tp)[0]
        for i in range(n)])
    _, b, S, d = feats.shape
    h = feats.reshape(n * b, S, d)
    if guard.enabled:
        noise = None if guard_noise is None else guard_noise.reshape(h.shape)
        h = guard.release_with_noise(h, noise, None if plan_clients is None else plan_clients * b)
    return h


def _trunk_loss(cfg, opts, server_params, h, labels, tp=None):
    """``(loss, ce)`` of the trunk on the released rows ``h`` [R, S, d]
    against ``labels`` (R rows): the cross entropy plus the weighted MoE
    aux. ``tp``: the trunk's blocks (a vocab-parallel cross entropy)."""
    R, S, _ = h.shape
    logits, aux = transformer.server_forward(server_params, cfg, h,
                                             positions_for(R, S, h.device), opts, tp=tp)
    shifted = _shift(cfg, logits, labels.reshape(R, -1))
    ce = (softmax_cross_entropy(*shifted) if tp is None
          else tp.cross_entropy(*shifted, cfg.vocab_size))
    return ce + MOE_AUX_WEIGHT * aux, ce


def _flat_grad(loss_fn, e2e, flat, unravel, banks, batch, model_noise, guard_noise):
    """``(grad, loss, ce)`` of ``loss_fn`` at the flat trainable buffer(s):
    the gradient one buffer a buffer of ``flat``, in its dtype."""
    fl = [b.detach().requires_grad_(True) for b in buffers(flat)]
    with torch.enable_grad():
        tr = unravel(fl[0] if isinstance(flat, torch.Tensor) else tuple(fl))
        server, cb = (tr, banks) if not e2e else (tr["server"], tr["client_banks"])
        loss, ce = loss_fn(server, cb, batch, model_noise, guard_noise)
        g = torch.autograd.grad(loss, fl)
    return (g[0] if isinstance(flat, torch.Tensor) else tuple(g)), loss.detach(), ce.detach()


def _sharded_step_parts(cfg, opts, opt, n_clients, mesh, *, grad_clip, privacy, shared_bank,
                        mode, zero1: bool = False, dtype=None) -> "LLMStepParts":
    """``llm_step_parts`` over a sharded layout (see the module docstring):
    ``flat`` is the rank's blocks of the trainable tree, ``banks`` its own
    clients' banks, ``batch`` and the noise whole or this rank's clients'
    rows (a leading dim of ``n_clients`` is cut to the rank's). ``zero1``
    (a production grid): the moments' blocks are split over the data axes
    as ``tree_specs(zero1=True)`` places them (``_apply_zero1_``).
    ``dtype``: the trainable leaves' dtype as ``init_llm_state``'s (the
    buffers' layout)."""
    e2e = mode == "e2e"
    lay = llm_layout(mesh, n_clients)
    if lay.production and e2e:
        raise ValueError("the production grids train the detached split (the reference's "
                         "launch.steps); e2e runs on make_split_mesh grids")
    cax = lay.clients
    mine = slice(None) if cax is None else cax.rows(n_clients)
    trunk_tp = LMParallel(lay.model, data=cax if lay.production else None)
    bank_tp = LMParallel(lay.model) if lay.production else None
    guard = PrivacyGuard(privacy)
    template = llm_state_template(cfg, n_clients, opt, dtype, shared_bank, mode)
    specs = llm_state_specs(template, mesh, shared_bank=shared_bank, mode=mode, zero1=zero1)
    tr_specs = trainable_of(specs, not e2e)
    segments = _owned_segments(tr_specs, trainable_of(template, not e2e), mesh)
    z_plan = None
    if zero1:
        z_plan = _zero1_plan(tr_specs, next(iter(specs["opt"].values())),
                             trainable_of(template, not e2e), mesh)
    if cfg.n_experts and lay.production and opts.moe_chunks % cax.size:
        raise ValueError(f"moe_chunks={opts.moe_chunks} on a data-parallel trunk over "
                         f"{cax.size} data ranks: each data rank routes its own tokens, so "
                         "moe_chunks must be a multiple of the data axes' size "
                         "(launch.steps.production_opts)")

    def take(x):
        if x is None or cax is None or x.shape[0] != n_clients:
            return x
        return x[mine]

    def loss_fn(server_params, client_banks, batch, model_noise, guard_noise):
        inputs = {k: take(v) for k, v in batch.items() if k != "labels"}
        h = _client_rows(cfg, opts, guard, shared_bank, client_banks, inputs, take(model_noise),
                         take(guard_noise), None if cax is None else n_clients, bank_tp)
        labels = take(batch["labels"])
        if cax is not None and not lay.production:  # every rank's trunk takes every row
            h, labels = gather(h, cax, 0), batch["labels"]
        return _trunk_loss(cfg, opts, server_params, h, labels, trunk_tp)

    def grad(flat, unravel, banks, batch, model_noise=None, guard_noise=None):
        g, loss, ce = _flat_grad(loss_fn, e2e, flat, unravel, banks, batch, model_noise,
                                 guard_noise)
        if lay.production and cax.size > 1:
            # the data ranks' mean gradient and loss; a bf16 gradient is summed
            # in bf16 (the all-reduce of GSPMD's bf16 partial gradients) and
            # halved exactly (the data axes are powers of two)
            for x in buffers(g):
                cax.all_reduce_(x).div_(cax.size)
            loss, ce = cax.all_reduce(loss) / cax.size, cax.all_reduce(ce) / cax.size
        return g, {"loss": loss, "ce": ce}

    def apply(flat, opt_state, step, g):
        _check_buffers(g, len(segments), dtype)
        with torch.no_grad():
            sq = torch.zeros((), dtype=torch.float32, device=buffers(g)[0].device)
            for x, segs in zip(buffers(g), segments):
                for lo, hi in segs:
                    sq = sq + _sumsq(x[lo:hi])
            all_reduce_world_(sq)  # the mesh covers the world
            gnorm = torch.sqrt(sq)
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            if z_plan is None:
                _update_(opt, flat, opt_state, step, g, scale)
            else:
                for i, (p, gg) in enumerate(zip(buffers(flat), buffers(g))):
                    _apply_zero1_(opt, p, {k: buffers(v)[i] for k, v in opt_state.items()},
                                  step, gg, scale, z_plan[i], cax)
        return gnorm

    return LLMStepParts(grad, apply, not e2e)


def _update_(opt, flat, opt_state, step, g, scale):
    """The optimizer's elementwise update of ``flat`` and of its flat
    moments (a buffer each, or one a dtype), in place, ``UPDATE_SLICE``
    elements at a time, each slice of ``g`` clipped by ``scale`` in float32
    as the update reads it (``g`` is left as it is)."""
    for i, (p, gg) in enumerate(zip(buffers(flat), buffers(g))):
        moments = {k: buffers(v)[i] for k, v in opt_state.items()}
        for lo in range(0, p.numel(), UPDATE_SLICE):
            part = slice(lo, lo + UPDATE_SLICE)
            upd, new = opt.update(_clipped(gg[part], scale),
                                  {k: v[part] for k, v in moments.items()}, p[part], step)
            p[part] += upd
            for k, v in new.items():
                moments[k][part] = v


def llm_step_parts(cfg: ModelConfig, opts: ModelOptions, opt: Optimizer, n_clients: int, *,
                   grad_clip: float = 1.0, privacy: Optional[DPConfig] = None,
                   shared_bank: bool = False, mode: str = "detached",
                   mesh=None, zero1: bool = False, dtype=None) -> LLMStepParts:
    """The two halves of one guarded step over the flat trainable buffers.

    ``grad(flat, unravel, banks, batch, model_noise=None, guard_noise=None)
    -> (grad, {"loss", "ce"})``: ``unravel(flat)`` is the server
    (``e2e``: ``{"server", "client_banks"}``), ``banks`` the stacked banks
    (or the shared one; unused in ``e2e``), ``batch`` ``{"tokens": [C, b,
    S], "labels": [C, b, S]}`` (or the stub frontends' inputs), the noise
    ``[C, b, S, d]``. Each client runs its bank; the guard releases the
    ``C*b`` rows at once; the server takes them concatenated (paper Alg. 1
    l.11). ``grad`` is the flat gradient (a buffer a buffer of ``flat``).

    ``apply(flat, opt_state, step, grad) -> grad_norm``: the global-norm
    clip and the optimizer's update of ``flat`` and of ``opt_state``'s
    flat moments, in place, ``UPDATE_SLICE`` elements at a time, each slice
    of ``grad`` scaled in float32 as it is read (``grad`` is left as it
    is; the repo's optimizers are elementwise, so a slice's update is the
    whole update's, bit for bit).

    ``mesh`` (a client axis; a model axis of size 1): each rank runs its
    clients' banks and releases their rows (the guard's plan chosen for all
    ``C*b`` rows), the features are all-gathered for the trunk, which every
    rank runs, and in ``e2e`` the banks' gradient rows are all-gathered
    into the whole flat gradient. ``batch`` is whole on every rank; each
    reads its clients' rows. A sharded mesh (``is_sharded``: a model axis
    above 1, or a production grid) takes the sharded layout
    (``_sharded_step_parts``; ``zero1`` its moments split over the data
    axes too). ``dtype``: the trainable leaves' dtype, as
    ``init_llm_state``'s (``None``: the config's); the sharded layout reads
    its buffers' layout from it."""
    cfg = untie(cfg)
    e2e = mode == "e2e"
    if e2e:
        opts = dataclasses.replace(opts, detach_cut=False)
        if shared_bank:
            raise ValueError("e2e clients train independently; banks must be per-client")
    elif not opts.detach_cut:
        raise ValueError("detached trainer requires detach_cut")
    if mesh is not None:
        check_mesh(mesh, mesh_device_type(mesh) or "cpu", client_axis=None)
    if is_sharded(mesh):
        return _sharded_step_parts(cfg, opts, opt, n_clients, mesh, grad_clip=grad_clip,
                                   privacy=privacy, shared_bank=shared_bank, mode=mode,
                                   zero1=zero1, dtype=dtype)
    if zero1:
        raise ValueError("zero1 splits the moments over a production grid's data axes")
    cax = _client_axis(mesh, n_clients)
    mine = slice(None) if cax is None else cax.rows(n_clients)
    guard = PrivacyGuard(privacy)

    def loss_fn(server_params, client_banks, batch, model_noise, guard_noise):
        # this rank's clients' rows (without a client axis, all of them)
        cut = (lambda x: x) if cax is None else (lambda x: None if x is None else x[mine])
        inputs = {k: cut(v) for k, v in batch.items() if k != "labels"}
        banks = client_banks if shared_bank else tree_map(cut, client_banks)
        h = _client_rows(cfg, opts, guard, shared_bank, banks, inputs, cut(model_noise),
                         cut(guard_noise), None if cax is None else n_clients)
        if cax is not None:
            h = gather(h, cax, 0)
        return _trunk_loss(cfg, opts, server_params, h, batch["labels"])

    def grad(flat, unravel, banks, batch, model_noise=None, guard_noise=None):
        g, loss, ce = _flat_grad(loss_fn, e2e, flat, unravel, banks, batch, model_noise,
                                 guard_noise)
        if cax is not None and e2e:
            with torch.no_grad():
                gather_chunks_([(v, 0) for v in tree_leaves(unravel(g)["client_banks"])], cax)
        return g, {"loss": loss, "ce": ce}

    def apply(flat, opt_state, step, g):
        with torch.no_grad():
            gnorm = _global_norm(g)
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            _update_(opt, flat, opt_state, step, g, scale)
        return gnorm

    return LLMStepParts(grad, apply, not e2e)


def trainable_of(state: dict, detached: bool):
    return state["server"] if detached else {"server": state["server"],
                                             "client_banks": state["client_banks"]}


def make_guarded_llm_step(cfg: ModelConfig, opts: ModelOptions, opt: Optimizer,
                          n_clients: int, *, grad_clip: float = 1.0,
                          privacy: Optional[DPConfig] = None, shared_bank: bool = False,
                          mode: str = "detached", mesh=None, zero1: bool = False,
                          dtype=None):
    """``step(state, batch, model_noise=None, guard_noise=None) -> (state,
    {"loss", "ce", "grad_norm"})`` over the canonical state, with the
    ``PrivacyGuard`` release at the cut; the reference's step with the
    noise as inputs in place of its key. ``state`` is left as it was. The
    budget advances one release a step when the guard is on.
    ``mode="e2e"`` (classic split learning) returns gradients to the banks.
    ``mesh``: the client axis shards the banks' work (a shared bank stays
    whole) and a model axis of size 1 is the identity, the state whole; on
    a sharded mesh (``is_sharded``) ``state`` and the result are this
    rank's blocks (``sharding.tensor_parallel.shard_tree`` of a whole state
    under :func:`llm_state_specs`) and every rank
    of the mesh calls the step (``llm_step_parts``; ``zero1`` on a
    production grid: the moments' blocks split over the data axes too).
    ``dtype``: the state's trainable dtype, as ``init_llm_state``'s
    (``None``: the config's); only the sharded layout reads it."""
    if mesh is not None:
        check_mesh(mesh, mesh_device_type(mesh) or "cpu", client_axis=None)
    parts = llm_step_parts(cfg, opts, opt, n_clients, grad_clip=grad_clip, privacy=privacy,
                           shared_bank=shared_bank, mode=mode, mesh=mesh, zero1=zero1,
                           dtype=dtype)
    guard = PrivacyGuard(privacy)

    def step(state, batch, model_noise=None, guard_noise=None):
        trainable = trainable_of(state, parts.detached)
        flat, unravel = ravel(trainable)
        moments = {k: ravel(v, like=trainable) for k, v in state["opt"].items()}
        opt_state = {k: v[0] for k, v in moments.items()}
        g, metrics = parts.grad(flat, unravel, state["client_banks"], batch, model_noise,
                                guard_noise)
        metrics["grad_norm"] = parts.apply(flat, opt_state, state["step"], g)
        new = unravel(flat)
        new_state = {**state, "opt": {k: moments[k][1](v) for k, v in opt_state.items()},
                     "step": state["step"] + 1}
        if parts.detached:
            new_state["server"] = new
        else:
            new_state.update(new)
        if guard.enabled and "privacy" in state:
            # one release per client a step: the budget composes the worst case
            new_state["privacy"] = budget_advance(state["privacy"], privacy)
        return new_state, metrics

    return step


# ----------------------------------------------------------- legacy shims
def init_split_state(generator: torch.Generator, cfg: ModelConfig, n_clients: int,
                     opt: Optimizer, dtype=None, shared_bank: bool = False,
                     mode: str = "detached", device=None) -> dict:
    """DEPRECATED: use ``init_llm_state`` (or ``SplitSession`` with
    ``engine="llm-split"``). The same state without the ``"privacy"``
    leaves."""
    warnings.warn(
        "init_split_state is deprecated; use init_llm_state (or "
        "SplitSession(engine='llm-split'), which carries the privacy budget "
        "in its canonical state)",
        DeprecationWarning, stacklevel=2,
    )
    state = init_llm_state(generator, cfg, n_clients, opt, dtype=dtype,
                           shared_bank=shared_bank, mode=mode, device=device)
    return {k: v for k, v in state.items() if k != "privacy"}


def make_llm_split_step(cfg: ModelConfig, opts: ModelOptions, opt: Optimizer,
                        n_clients: int, clip_norm: float = 1.0,
                        shared_bank: bool = False, mode: str = "detached"):
    """DEPRECATED: use ``make_guarded_llm_step`` (or ``SplitSession`` with
    ``engine="llm-split"``). The guarded step with the guard off."""
    warnings.warn(
        "make_llm_split_step is deprecated; use make_guarded_llm_step (or "
        "SplitSession(engine='llm-split'), which applies the PrivacyGuard "
        "at the cut)",
        DeprecationWarning, stacklevel=2,
    )
    return make_guarded_llm_step(cfg, opts, opt, n_clients, grad_clip=clip_norm,
                                 privacy=None, shared_bank=shared_bank, mode=mode)
