"""The whole bfloat16 model and the optimizer step over the mixed-dtype
flat buffers, against the JAX package (the fits, checkpoints and the
sharded path: ``tests/test_torch_bf16_train.py``, whose helpers this file
takes).

Tolerances, each argued from a measurement on this suite's inputs:

- **The whole model** (reduced llama3.2-1b, granite-moe-1b-a400m,
  falcon-mamba-7b, 3 layers, bf16): both sides round at every bf16 op, at
  different points (XLA fuses elementwise chains and rounds once where
  torch rounds each op), so they part by about the rounding itself. The
  yardstick is the reference's own bf16 run against its float32 run on the
  same weights (seeds 0 and 1): the loss 9.5e-7–5.0e-3 apart, the logits
  up to 0.20, the gradient 1.2–8.2% in relative L2. The port against the
  reference's bf16 run: the loss up to 3.7e-3, the logits up to 0.082
  (granite; llama 0.015, falcon-mamba 0.070), the gradient 1.3–5.3%. So
  the loss within 8e-3, the logits within 0.125 (16 bf16 ulps at [1, 2))
  and the gradient within 0.08 relative L2, the reference's own spread.
- **The optimizer step** (``llm_step_parts``' ``apply``) fed the
  reference's own bf16 gradient tree: the port's global norm (a float32
  sum a buffer, a slice at a time) parts from the reference's (a sum a
  leaf, in XLA's order) by up to 1.1e-6 relative (measured; within
  ``NORM_RTOL``). Given the port's norm, the reference's rule
  (``clip_by_global_norm``'s product, ``adamw.update``,
  ``apply_updates``) gives the port's weights and moments bit for bit.
  With its own norm the clipped gradient parts in its last ulp
  everywhere, the moments with it, and at most 0.1% of the bf16 weights
  (measured up to 761 of 1,007,360, falcon-mamba) round to a neighbour.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.models import transformer as jtr
from repro.optim import adamw as j_adamw
from repro.optim import apply_updates as j_apply
from repro.optim import clip_by_global_norm as j_clip
from repro_torch.common.bridge import to_torch
from repro_torch.common.tree import buffers, ravel, tree_leaves
from repro_torch.configs import get_config
from repro_torch.core import distributed as td
from repro_torch.models import model as tm
from repro_torch.models import transformer as ttr
from repro_torch.models.transformer import ModelOptions
from repro_torch.optim import adamw
from test_torch_bf16_train import LR, C, _f32, _rel_l2, _vec

MODEL_TOL = {"loss": 8e-3, "logits": 0.125, "grad_rel_l2": 0.08}
NORM_RTOL = 2e-6


# ------------------------------------------------------- the whole model
@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m", "falcon-mamba-7b"])
def test_whole_bf16_model_matches_jax(arch):
    """The reduced config in bf16, 3 layers: forward logits, the loss and
    every leaf's gradient (the cut not detached), within ``MODEL_TOL``;
    the gradients in their leaves' dtypes."""
    kw = {"n_layers": 3, "dtype": "bfloat16"}
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jp = jm.init_model(jax.random.PRNGKey(0), jcfg)
    tp = to_torch(jax.device_get(jp), "cpu")
    assert {x.dtype for x in tree_leaves(tp)} == {torch.bfloat16, torch.float32}
    labels = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jb = {"tokens": jnp.asarray(labels), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(labels), "labels": torch.from_numpy(labels)}
    okw = dict(q_block=8, kv_block=8, detach_cut=False)
    jo, to = jtr.ModelOptions(**okw), ModelOptions(**okw)

    @jax.jit
    def reference(p):
        (loss, _), grads = jax.value_and_grad(lambda q: jm.loss_fn(q, jcfg, jb, jo),
                                              has_aux=True)(p)
        return jtr.forward(p, jcfg, jb, jo)[0], loss, grads

    jlogits, jloss, jgrads = reference(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    loss = tm.loss_fn(tp, tcfg, tb, to)[0]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    logits = ttr.forward(tp, tcfg, tb, to)[0].detach()
    assert abs(float(loss.detach()) - float(jloss)) <= MODEL_TOL["loss"]
    assert float(np.abs(logits.float().numpy() - _f32(jlogits)).max()) <= MODEL_TOL["logits"]
    got = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    assert [g.dtype for g in got] == [t.dtype for t in leaves]
    assert _rel_l2(_vec(got), _vec(jax.tree.leaves(jgrads))) <= MODEL_TOL["grad_rel_l2"]


# ---------------------------------------------------------- the update
def test_update_rule_fed_the_reference_gradient_is_bit_equal():
    """Three steps of ``llm_step_parts``' ``apply`` over the mixed flat
    buffers (reduced llama3.2-1b in bf16, 3 layers, AdamW with weight decay),
    each fed the reference's bf16 gradient of its own state: the norm within
    ``NORM_RTOL``; given the port's norm, the reference's rule gives the
    port's weights and moments bit for bit; with the reference's own norm,
    at most 0.1% of the weights round to a neighbour (module docstring).
    A bf16 gradient is never rounded after the clip."""
    kw = {"n_layers": 3, "dtype": "bfloat16"}
    jcfg = dataclasses.replace(j_get_config("llama3.2-1b").reduced(), **kw)
    tcfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), **kw)
    params = jm.init_model(jax.random.PRNGKey(0), jcfg)
    client, server = params["client"], params["server"]
    jo, to = j_adamw(LR, weight_decay=0.1), adamw(LR, weight_decay=0.1)
    jopt = jo.init(server)
    tserver = to_torch(jax.device_get(server), "cpu")
    flat, _ = ravel(tserver)
    assert [b.dtype for b in buffers(flat)] == [torch.float32, torch.bfloat16]  # final_norm 1st
    opt_state = {k: ravel(to_torch(jax.device_get(v), "cpu"), like=tserver)[0]
                 for k, v in jopt.items()}
    parts = td.llm_step_parts(tcfg, ModelOptions(), to, C, grad_clip=1.0)
    grad_of = jax.jit(lambda s, b: jax.grad(lambda q: jm.loss_fn(
        {"client": client, "server": q}, jcfg, b, jtr.ModelOptions(q_block=8, kv_block=8))[0])(s))
    rng = np.random.default_rng(0)
    for t in range(3):
        labels = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
        grads = grad_of(server, {"tokens": jnp.asarray(labels), "labels": jnp.asarray(labels)})
        tg = ravel(to_torch(jax.device_get(grads), "cpu"), like=tserver)[0]
        kept = [b.clone() for b in buffers(tg)]
        step = torch.tensor(t, dtype=torch.int32)
        norm = parts.apply(flat, opt_state, step, tg)
        assert all(torch.equal(a, b) for a, b in zip(buffers(tg), kept))  # not rounded
        own, jnorm = j_clip(grads, 1.0)
        assert abs(float(norm) / float(jnorm) - 1.0) <= NORM_RTOL
        # the reference's own norm: its weights, beside the port's
        own_server = j_apply(server, jo.update(own, jopt, server, jnp.int32(t))[0])
        own_flat = ravel(to_torch(jax.device_get(own_server), "cpu"))[0]
        # the reference's rule at the port's norm
        scale = jnp.minimum(1.0, 1.0 / jnp.maximum(jnp.float32(float(norm)), 1e-9))
        updates, jopt = jo.update(jax.tree.map(lambda g: g * scale, grads), jopt, server,
                                  jnp.int32(t))
        server = j_apply(server, updates)
        want = ravel(to_torch(jax.device_get(server), "cpu"))[0]
        assert all(torch.equal(a, b) for a, b in zip(buffers(flat), buffers(want)))
        for k, v in jopt.items():
            want_m = ravel(to_torch(jax.device_get(v), "cpu"), like=tserver)[0]
            assert all(torch.equal(a, b) for a, b in zip(buffers(opt_state[k]), buffers(want_m)))
        parted = sum(int((a != b).sum()) for a, b in zip(buffers(flat), buffers(own_flat)))
        assert parted <= sum(b.numel() for b in buffers(flat)) // 1000, (t, parted)
