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
the trainable tree is one buffer (``common.tree.ravel``, in
``ravel_pytree``'s leaf order), the model reads views of it, autograd
returns one flat gradient, and the clip and the optimizer act on the
buffer. ``apply`` updates the buffer and the optimizer's flat moments in
place, a slice at a time: the reference donates its state to the step,
and at llama3.2-1b's width a functional update of the whole buffer would
hold several copies of 1.2 B (``e2e``: 2.1 B) parameters at once.
``make_guarded_llm_step`` wraps it as the reference's functional step over
the canonical state (tree-shaped moments, copied into flat buffers a step).

Multi-client split learning needs an UNTIED head: a tied embedding would
hand every client's embedding to the server. State init and the step
factories untie.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import ravel, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapters import SplitAdapter
from repro_torch.models import transformer
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.models.model import MOE_AUX_WEIGHT
from repro_torch.models.transformer import ModelOptions, positions_for
from repro_torch.optim.optimizers import Optimizer
from repro_torch.privacy.accountant import budget_advance, budget_init
from repro_torch.privacy.guard import DPConfig, PrivacyGuard

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


def llm_step_parts(cfg: ModelConfig, opts: ModelOptions, opt: Optimizer, n_clients: int, *,
                   grad_clip: float = 1.0, privacy: Optional[DPConfig] = None,
                   shared_bank: bool = False, mode: str = "detached") -> LLMStepParts:
    """The two halves of one guarded step over a flat trainable buffer.

    ``grad(flat, unravel, banks, batch, model_noise=None, guard_noise=None)
    -> (grad, {"loss", "ce"})``: ``unravel(flat)`` is the server
    (``e2e``: ``{"server", "client_banks"}``), ``banks`` the stacked banks
    (or the shared one; unused in ``e2e``), ``batch`` ``{"tokens": [C, b,
    S], "labels": [C, b, S]}`` (or the stub frontends' inputs), the noise
    ``[C, b, S, d]``. Each client runs its bank; the guard releases the
    ``C*b`` rows at once; the server takes them concatenated (paper Alg. 1
    l.11). ``grad`` is the flat gradient.

    ``apply(flat, opt_state, step, grad) -> grad_norm``: the global-norm
    clip (``grad`` scaled in place) and the optimizer's update of ``flat``
    and of ``opt_state``'s flat moments, in place, ``UPDATE_SLICE``
    elements at a time (the repo's optimizers are elementwise, so a slice's
    update is the whole update's, bit for bit)."""
    cfg = untie(cfg)
    e2e = mode == "e2e"
    if e2e:
        opts = dataclasses.replace(opts, detach_cut=False)
        if shared_bank:
            raise ValueError("e2e clients train independently; banks must be per-client")
    elif not opts.detach_cut:
        raise ValueError("detached trainer requires detach_cut")
    guard = PrivacyGuard(privacy)

    def loss_fn(server_params, client_banks, batch, model_noise, guard_noise):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        feats = torch.stack([
            transformer.client_forward(
                client_banks if shared_bank else tree_map(lambda a, c=c: a[c], client_banks),
                cfg, {k: v[c] for k, v in inputs.items()}, opts,
                None if model_noise is None else model_noise[c])[0]
            for c in range(n_clients)])
        C, b, S, d = feats.shape
        h = feats.reshape(C * b, S, d)  # concatenate all features (Alg. 1 l.11)
        if guard.enabled:
            noise = None if guard_noise is None else guard_noise.reshape(h.shape)
            h = guard.release_with_noise(h, noise)
        labels = batch["labels"].reshape(C * b, -1)
        logits, aux = transformer.server_forward(server_params, cfg, h,
                                                 positions_for(C * b, S, h.device), opts)
        ce = softmax_cross_entropy(*_shift(cfg, logits, labels))
        return ce + MOE_AUX_WEIGHT * aux, ce

    def grad(flat, unravel, banks, batch, model_noise=None, guard_noise=None):
        fl = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            tr = unravel(fl)
            server, cb = (tr, banks) if not e2e else (tr["server"], tr["client_banks"])
            loss, ce = loss_fn(server, cb, batch, model_noise, guard_noise)
            (g,) = torch.autograd.grad(loss, fl)
        return g, {"loss": loss.detach(), "ce": ce.detach()}

    def apply(flat, opt_state, step, g):
        with torch.no_grad():
            # the norm without a temporary of the buffer's size
            gnorm = torch.linalg.vector_norm(g)
            g.mul_(torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0))
            for lo in range(0, flat.numel(), UPDATE_SLICE):
                part = slice(lo, lo + UPDATE_SLICE)
                upd, new = opt.update(g[part], {k: v[part] for k, v in opt_state.items()},
                                      flat[part], step)
                flat[part] += upd
                for k, v in new.items():
                    opt_state[k][part] = v
        return gnorm

    return LLMStepParts(grad, apply, not e2e)


def trainable_of(state: dict, detached: bool):
    return state["server"] if detached else {"server": state["server"],
                                             "client_banks": state["client_banks"]}


def make_guarded_llm_step(cfg: ModelConfig, opts: ModelOptions, opt: Optimizer,
                          n_clients: int, *, grad_clip: float = 1.0,
                          privacy: Optional[DPConfig] = None, shared_bank: bool = False,
                          mode: str = "detached", mesh=None):
    """``step(state, batch, model_noise=None, guard_noise=None) -> (state,
    {"loss", "ce", "grad_norm"})`` over the canonical state, with the
    ``PrivacyGuard`` release at the cut; the reference's step with the
    noise as inputs in place of its key. ``state`` is left as it was. The
    budget advances one release a step when the guard is on.
    ``mode="e2e"`` (classic split learning) returns gradients to the banks;
    ``mesh=`` is not ported and raises."""
    if mesh is not None:
        raise ValueError("mesh= is not ported yet: the port trains on one device")
    parts = llm_step_parts(cfg, opts, opt, n_clients, grad_clip=grad_clip, privacy=privacy,
                           shared_bank=shared_bank, mode=mode)
    guard = PrivacyGuard(privacy)

    def step(state, batch, model_noise=None, guard_noise=None):
        flat, unravel = ravel(trainable_of(state, parts.detached))
        opt_state = {k: ravel(v)[0] for k, v in state["opt"].items()}
        g, metrics = parts.grad(flat, unravel, state["client_banks"], batch, model_noise,
                                guard_noise)
        metrics["grad_norm"] = parts.apply(flat, opt_state, state["step"], g)
        new = unravel(flat)
        new_state = {**state, "opt": {k: unravel(v) for k, v in opt_state.items()},
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
