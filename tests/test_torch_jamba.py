"""AI21-Jamba2-3B's layers in the port (``configs.jamba``: the inner norms
on dt, B and C, and attention without positional encoding; per-block
remat) against the benchmark's plain reference (``perfbench/reference/jamba.py``,
loaded by its path; it imports nothing of the port), at a
small Jamba-shaped size on the CPU with seeded random weights: d 64, 4
query heads over 1 KV head, period 4 with attention at offset 3, d_state
16, 8 layers, both switches on, float32.

Tolerance ``TOL``: 1e-5 absolute and relative, float32 sums in other
orders (the conv as a loop of taps against ``conv1d``, the scan step by
step against chunks, the port's online softmax over key blocks against one
softmax); ``GRAD_RTOL`` 1e-4 in relative L2 for a gradient, the same
roundings carried back through eight blocks.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro_torch.configs as port_configs
from repro_torch.common.device import seeded_generator
from repro_torch.common.tree import tree_leaves
from repro_torch.configs.jamba import JambaConfig, mamba_inner_norm, uses_rope
from repro_torch.core import distributed as td
from repro_torch.core.session import SplitSession
from repro_torch.core.trainer import SplitTrainConfig, make_sample_plan
from repro_torch.models import attention, ssm
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig

REFERENCE = Path(__file__).resolve().parents[1] / "perfbench" / "reference" / "jamba.py"
_spec = importlib.util.spec_from_file_location("jamba_reference", REFERENCE)
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_RTOL = 1e-4
CFG = JambaConfig(name="jamba-small", family="hybrid", n_layers=8, d_model=64, n_heads=4,
                  n_kv_heads=1, d_ff=128, vocab_size=256, head_dim=16, attn_period=4,
                  attn_offset=3, ssm_state=16, dt_rank=8, norm_eps=1e-6, dtype="float32",
                  cut_layers=1)
# the reference's configuration: the HF config.json keys of the same model
REF_CFG = {"hidden_size": 64, "intermediate_size": 128, "mamba_expand": 2, "mamba_d_state": 16,
           "mamba_dt_rank": 8, "mamba_d_conv": 4, "num_attention_heads": 4,
           "num_key_value_heads": 1, "num_hidden_layers": 8, "attn_layer_period": 4,
           "attn_layer_offset": 3, "rms_norm_eps": 1e-6, "vocab_size": 256, "cut_layers": 1,
           "privacy_noise": 0.0}
OPTS = tt.ModelOptions(q_block=8, kv_block=8)


def _params(seed=0):
    """Port-drawn weights with the float32 constants moved off their init
    (norm weights, dt_bias), so that a norm or a bias the code skipped
    would show."""
    params = tm.init_model(torch.Generator().manual_seed(seed), CFG, torch.float32, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for t in tree_leaves(params):
        if t.dtype == torch.float32 and t.dim() <= 2 and t.shape[-1] in (8, 16, 64, 128):
            if t.dim() == 1 or t.shape[0] == 1:
                t.add_(0.1 * torch.randn(t.shape, generator=g))
    return params


def _ref_logits(params, tokens):
    model = ref.Jamba(REF_CFG, scan_chunk=5, q_chunk=7)
    bank = params["client"]
    x = model.client(bank, tokens, None)
    for p, i in model.server_blocks(params["server"]):
        x = model.block(p, i, x)
    x = model.rms(x, params["server"]["final_norm"])
    return x @ params["server"]["lm_head"]


def test_the_registry_and_registered_configs_are_unchanged():
    """The Jamba2 config is not registered: the registry is the JAX
    package's, each registered config's fields are its own, and the two
    switches read as before (RoPE on, no inner norms) for every one."""
    from repro_torch.configs import ai21_jamba2_3b

    assert sorted(port_configs.list_configs()) == sorted(jax_configs.list_configs())
    assert ai21_jamba2_3b.CONFIG.name not in port_configs.list_configs()
    for name, cfg in port_configs.list_configs().items():
        assert type(cfg) is port_configs.ModelConfig
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_configs.get_config(name))
        assert uses_rope(cfg) and not mamba_inner_norm(cfg)
    c = ai21_jamba2_3b.CONFIG
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.d_ff, c.vocab_size,
            c.ssm_state, c.dt_rank, c.d_inner, c.norm_eps) == (28, 2560, 20, 1, 128, 8192,
                                                              65536, 16, 160, 5120, 1e-6)
    assert [i for i in range(28) if c.layer_kind(i) == "attn"] == [7, 21]
    assert tt.stack_split(c) == (1, 13, 1)
    assert not uses_rope(c) and mamba_inner_norm(c)
    assert isinstance(td.untie(c), JambaConfig) and not td.untie(c).tie_embeddings


def test_logits_match_the_reference():
    params = _params(1)
    tokens = torch.randint(0, 256, (2, 23), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, _ = tt.forward(params, CFG, {"tokens": tokens}, OPTS)
        want = _ref_logits(params, tokens)
    torch.testing.assert_close(got, want, **TOL)


def test_inner_norms_and_rope_free_attention_on_their_own():
    """The mixer with its norms on dt, B and C, and attention without RoPE,
    each against the reference's; each switch changes its layer."""
    model = ref.Jamba(REF_CFG, scan_chunk=4, q_chunk=5)
    params = _params(3)
    mixer = params["server"]["prefix"][0]["ssm"]
    attn = params["server"]["prefix"][2]["attn"]  # layer 3
    assert set(k for k in mixer if k.endswith("_norm")) == {"dt_norm", "B_norm", "C_norm"}
    x = torch.randn((2, 19, 64), generator=torch.Generator().manual_seed(4))
    pos = tt.positions_for(2, 19, "cpu")
    with torch.no_grad():
        torch.testing.assert_close(ssm.ssm_forward(mixer, CFG, x), model.mamba(mixer, x), **TOL)
        torch.testing.assert_close(attention.attention_forward(attn, CFG, x, pos, q_block=8,
                                                               kv_block=8),
                                   model.attention(attn, x), **TOL)
        plain = dataclasses.replace(CFG, rope=True, mamba_inner_norm=False)
        no_norm = {k: v for k, v in mixer.items() if not k.endswith("_norm")}
        assert not torch.allclose(ssm.ssm_forward(no_norm, plain, x),
                                  ssm.ssm_forward(mixer, CFG, x), atol=1e-3)
        assert not torch.allclose(attention.attention_forward(attn, plain, x, pos),
                                  attention.attention_forward(attn, CFG, x, pos), atol=1e-3)


def test_decode_matches_the_full_forward():
    """Decoding one token at a time (the mixers' states and the KV caches,
    with the inner norms and no RoPE) gives the full forward's logits."""
    params = _params(5)
    tokens = torch.randint(0, 256, (2, 17), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        full = tm.prefill(params, CFG, {"tokens": tokens}, OPTS)
        want = _ref_logits(params, tokens)
        state = tm.init_decode_state(CFG, 2, 17, torch.float32, "cpu")
        outs = []
        for t in range(17):
            lg, state = tm.serve_step(params, CFG, state, tokens[:, t:t + 1], t, OPTS)
            outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(full, want, **TOL)


@pytest.mark.parametrize("remat_layers", [8, 12])
def test_per_block_remat_is_bit_equal(remat_layers):
    """With ``remat`` every server block, the prefix's too, is recomputed in
    the backward: the loss and every gradient are the ones without it, bit
    for bit (8 layers: a prefix of 3 blocks and one group of 4; 12: two
    groups)."""
    cfg = dataclasses.replace(CFG, n_layers=remat_layers)
    params = tm.init_model(torch.Generator().manual_seed(8), cfg, torch.float32, "cpu")
    tokens = torch.randint(0, 256, (2, 13), generator=torch.Generator().manual_seed(9))
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    runs = []
    for remat in (False, True):
        opts = dataclasses.replace(OPTS, detach_cut=False, remat=remat)
        loss, _ = tm.loss_fn(params, cfg, {"tokens": tokens, "labels": tokens}, opts)
        runs.append([loss] + list(torch.autograd.grad(loss, leaves)))
    assert tt.stack_split(cfg)[1] == 3
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _session(seed):
    adapter = td.llm_adapter(CFG, OPTS, torch.float32)
    tc = SplitTrainConfig(n_clients=3, data_shares=(0.7, 0.2, 0.1), server_batch=3,
                          mode="detached", privacy=DPConfig(clip_norm=1.0), grad_clip=1.0)
    return adapter, tc, SplitSession(adapter, tc, adamw(1e-3), engine="llm-split", seed=seed,
                                     device="cpu")


def test_a_split_session_step_matches_the_reference():
    """One detached step through ``SplitSession(..., engine="llm-split")``
    (three hospitals, one 24-token window each, the guard at the calibrated
    sigma, AdamW): the loss within ``TOL``, each leaf's gradient (AdamW's
    first moment over 1 - b1) within ``GRAD_RTOL`` in relative L2, and each
    leaf's update within 1e-3 of the reference's in relative L2 (no element
    off by more than 2 lr): AdamW's first step divides g by |g| + 1e-8, so
    where |g| is near 1e-8 a rounding-size difference of g moves the update
    by up to lr times that difference over 1e-8."""
    seed = 2**31 + 77
    adapter, tc, sess = _session(seed)
    start = sess.state
    windows = [np.random.default_rng(c).integers(0, 256, (4, 24)).astype(np.int32)
               for c in range(3)]
    shards = [(w, w) for w in windows]
    loss = sess.fit(shards, epochs=1, steps_per_epoch=1)[0]["loss"]
    after = sess.state
    plan = make_sample_plan(adapter, tc, 1)([4, 4, 4], (24,), seeded_generator(seed, 1), "cpu")
    tokens = torch.stack([torch.from_numpy(windows[c][plan.idx[0, c].numpy()])
                          for c in range(3)])
    batch = {"tokens": tokens, "model_noise": None, "guard_noise": plan.guard_noise[0]}
    server = start["server"]
    before = [t.clone() for t in ref.leaves(server)]
    losses, grad = ref.train_steps(ref.Jamba(REF_CFG, scan_chunk=5, q_chunk=7),
                                   start["client_banks"], server, [batch],
                                   {"clip_norm": 1.0}, DPConfig(clip_norm=1.0).sigma,
                                   {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8}, 1.0)
    np.testing.assert_allclose(loss, losses[0], **TOL)
    got_grad = [float(torch.linalg.vector_norm(m.double())) / 0.1
                for m in ref.leaves(after["opt"]["mu"])]
    np.testing.assert_allclose(got_grad, grad, rtol=GRAD_RTOL)
    for a, b, s0 in zip(ref.leaves(after["server"]), ref.leaves(server), before):
        got, want = a - s0, b - s0
        assert float((got - want).norm() / want.norm()) <= 1e-3
        assert float((got - want).abs().max()) <= 2e-3


@pytest.mark.parametrize("S,chunk", [(23, 5), (16, 16), (7, 64)])
def test_the_references_written_out_scan_gradient_matches_autograd(S, chunk):
    """The reference's scan (``Scan``: its gradient written out, a chunk's
    states recomputed) against autograd of the port's plain loop
    (``ssm._ssm_scan`` without its D term): y and every input's gradient
    within ``TOL``."""
    g = torch.Generator().manual_seed(S)
    u, dt = torch.randn((2, S, 12), generator=g), torch.rand((2, S, 12), generator=g)
    Bm, Cm = torch.randn((2, S, 16), generator=g), torch.randn((2, S, 16), generator=g)
    A = -torch.rand((12, 16), generator=g) * 4
    dy = torch.randn((2, S, 12), generator=g)
    ins = [t.clone().requires_grad_() for t in (u, dt, Bm, Cm, A)]
    got_y = ref.Scan.apply(*ins, chunk)
    got = torch.autograd.grad(got_y, ins, dy)
    ins2 = [t.clone().requires_grad_() for t in (u, dt, Bm, Cm, A)]
    want_y = ssm._ssm_scan(*ins2, torch.zeros(12))
    want = torch.autograd.grad(want_y, ins2, dy)
    torch.testing.assert_close(got_y, want_y, **TOL)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


def test_llm_split_spans_count_and_nest():
    """Under the profiler a Jamba ``llm-split`` fit of 2 epochs x 2 steps
    opens ``fit.shards`` once, ``fit.plan`` an epoch, ``fit.step`` a step
    around one ``fit.grad`` and one ``fit.update``, and ``ssm.scan`` once a
    mamba layer's forward (each hospital's client layer and the trunk's 6,
    with remat again in the backward) inside ``fit.grad``."""
    from torch.profiler import ProfilerActivity, profile

    adapter = td.llm_adapter(CFG, dataclasses.replace(OPTS, remat=True), torch.float32)
    tc = SplitTrainConfig(n_clients=3, data_shares=(0.7, 0.2, 0.1), server_batch=3,
                          privacy=DPConfig(clip_norm=1.0))
    sess = SplitSession(adapter, tc, adamw(1e-3), engine="llm-split", seed=3, device="cpu")
    w = np.random.default_rng(0).integers(0, 256, (4, 16)).astype(np.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.fit([(w, w)] * 3, epochs=2, steps_per_epoch=2)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith(("fit.", "ssm."))]
    count = {n: sum(x == n for x, _, _ in spans) for n in
             ("fit.shards", "fit.plan", "fit.step", "fit.grad", "fit.update", "ssm.scan")}
    mamba = [CFG.layer_kind(i) for i in range(CFG.n_layers)].count("ssm")  # 6: 1 client, 5
    assert count == {"fit.shards": 1, "fit.plan": 2, "fit.step": 4, "fit.grad": 4,
                     "fit.update": 4, "ssm.scan": 4 * (3 * 1 + 2 * (mamba - 1))}
    for name, parent in (("fit.grad", "fit.step"), ("fit.update", "fit.step"),
                         ("ssm.scan", "fit.grad")):
        outer = [(s, e) for n, s, e in spans if n == parent]
        assert all(any(ps <= s and e <= pe for ps, pe in outer)
                   for n, s, e in spans if n == name), name
