"""The port's LM split workload (``core.distributed``, the ``llm-split``
engine, ``launch.train``) against ``repro.core.distributed`` and the
reference's engine.

The same inputs on both sides: the weights carried across with the bridge,
the JAX plan's batch indices, and the noise the reference draws inside its
step, fed in: for step key k, client c's model noise ``normal(split(k,
C)[c])`` and guard noise ``normal(guard.key_for(split(k, C)[c]))``. The
config is the reference suite's ``TINY`` (2 layers, width 32, model noise
0.02 at the cut). The port's guard runs ``dp_release``'s wrapper
(``use_kernel=True``: the plain version on CPU tensors, through its
``autograd.Function`` in ``e2e``), the reference's its XLA path.

Tolerance: 1e-5 absolute and relative on every metric and every leaf of
the state (float32 sums in another order through a few AdamW steps);
counts, the step and the budget's releases exact. One allowance, on the
weights alone: AdamW divides the first moment by ``sqrt(nu) + eps`` with
eps 1e-8, so an element whose gradient is itself of order 1e-8 (terms that
cancel) moves by a share of lr that its gradient's rounding decides.
Measured: ``server/groups/pos0/mlp/w_gate[0, 1, 2]`` of the shared-bank
run has a first gradient of -0.99e-8 here and -1.09e-8 in the reference
(its moments agree within 1e-9), so its first step moves it by 0.497 and
0.520 lr: 2.27e-5 apart, for good. So up to one weight in a thousand may
part by more than 1e-5, by at most ``lr * steps``; the moments and the
metrics carry no such amplification and hold at 1e-5 everywhere.

The shared bank is held to the per-client banks bit for bit (one loop runs
both here); the reference's own claim of that, which fails at four clients
on XLA:CPU, is not anchored on. In detached mode the cut detaches (the
reference's stop_gradient), so ``audit_privacy``'s attack through the float
branch has a zero gradient on both sides and leaves its start point.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JConfig
from repro.core import SplitSession as JSession
from repro.core import SplitTrainConfig as JTrainConfig
from repro.core import distributed as jd
from repro.core import trainer as jt
from repro.models.transformer import ModelOptions as JOptions
from repro.optim import adamw as j_adamw
from repro.privacy import DPConfig as JDP
from repro.privacy import PrivacyGuard as JGuard
from repro_torch.common.bridge import to_torch
from repro_torch.common.device import seeded_generator
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import SamplePlan, SplitSession, SplitTrainConfig
from repro_torch.core import distributed as td
from repro_torch.core.adapters import mlp_adapter
from repro_torch.configs import CHOLESTEROL_MLP
from repro_torch.models.model import MOE_AUX_WEIGHT
from repro_torch.models.transformer import ModelOptions
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig
from test_torch_audit import assert_rows_close, jax_sweep_noise, jax_x0

TOL = dict(atol=1e-5, rtol=1e-5)
TINY_KW = dict(name="llm-tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
               n_kv_heads=1, d_ff=64, vocab_size=97, dtype="float32", cut_layers=1,
               privacy_noise=0.02)
J_TINY, T_TINY = JConfig(**TINY_KW), ModelConfig(**TINY_KW)
J_OPTS, T_OPTS = JOptions(q_block=8, kv_block=8), ModelOptions(q_block=8, kv_block=8)
SEQ, C, B = 8, 3, 2
TC = dict(n_clients=C, data_shares=(0.7, 0.2, 0.1), server_batch=C * B)
GUARDS = {"off": None, "unclipped": dict(clip_norm=None, noise_scale=0.05),
          "clipped": dict(epsilon=1.0, delta=1e-5, clip_norm=1.0)}


def _dp(guard, port):
    kw = GUARDS[guard]
    if kw is None:
        return None
    return DPConfig(**kw, use_kernel=True) if port else JDP(**kw)


def tiny_shards(n_clients=C, seed=0, sizes=(24, 16, 12)):
    rng = np.random.default_rng(seed)
    return [(w, w) for w in (rng.integers(0, 97, (n, SEQ)).astype(np.int32)
                             for n in sizes[:n_clients])]


def jax_noise(key, dp, n_clients=C, b=B, d=TINY_KW["d_model"]):
    """The model and guard noise the reference's step draws from its key,
    ``[C, b, S, d]`` each (the guard's ``None`` where it draws none)."""
    keys = jax.random.split(key, n_clients)
    shape = (b, SEQ, d)
    model = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32)) for k in keys])
    guard = JGuard(dp)
    if guard.sigma <= 0:
        return torch.from_numpy(model), None
    noise = np.stack([np.asarray(jax.random.normal(guard.key_for(k), shape, jnp.float32))
                      for k in keys])
    return torch.from_numpy(model), torch.from_numpy(noise)


def jax_plan(jtc, steps, lens, epoch_key, d=TINY_KW["d_model"]):
    """The reference engine's epoch plan as the port's ``SamplePlan``."""
    idx, step_keys = jt.make_sample_plan(jtc, steps)(lens, epoch_key)
    noise = [jax_noise(step_keys[t], jtc.privacy, jtc.n_clients,
                       jt.fused_client_batch(jtc), d) for t in range(steps)]
    guard = None if noise[0][1] is None else torch.stack([n[1] for n in noise])
    return SamplePlan(torch.from_numpy(np.array(idx)).long(),
                      torch.stack([n[0] for n in noise]), guard)


def assert_close(got, want, what):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=f"{what} {i}",
                                   **TOL)


def assert_weights(got, want, steps, lr=1e-3):
    """``got``'s leaves within 1e-5 of ``want``'s but for the AdamW
    allowance of the module docstring."""
    g = np.concatenate([a.detach().numpy().ravel() for a in tree_leaves(got)])
    w = np.concatenate([np.asarray(b).ravel() for b in jax.tree.leaves(want)])
    err = np.abs(g - w)
    out = err > TOL["atol"] + TOL["rtol"] * np.abs(w)
    assert out.sum() <= len(w) // 1000 and (err <= lr * steps).all(), \
        (int(out.sum()), len(w), float(err.max()))


def assert_state(got, want, steps):
    for part in ("client_banks", "server"):
        assert_weights(got[part], want[part], steps)
    assert_close(got["opt"], want["opt"], "opt")
    assert int(got["step"]) == int(want["step"])
    if "privacy" in want:
        assert int(got["privacy"]["releases"]) == int(want["privacy"]["releases"])
        assert_close(got["privacy"], want["privacy"], "privacy")


def _batch(seed):
    xs = np.random.default_rng(seed).integers(0, 97, (C, B, SEQ)).astype(np.int32)
    return {"tokens": jnp.asarray(xs), "labels": jnp.asarray(xs)}, \
        {"tokens": torch.from_numpy(xs), "labels": torch.from_numpy(xs)}


# ------------------------------------------------------------------- step
@pytest.mark.parametrize("mode", ["detached", "e2e"])
@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_guarded_step_matches_jax(mode, guard):
    """Two steps of ``make_guarded_llm_step`` from one state: metrics, every
    leaf (banks, server, tree-shaped moments), the step and the budget."""
    jdp, tdp = _dp(guard, False), _dp(guard, True)
    j_step = jax.jit(jd.make_guarded_llm_step(J_TINY, J_OPTS, j_adamw(1e-3), C, privacy=jdp,
                                              mode=mode))
    t_step = td.make_guarded_llm_step(T_TINY, T_OPTS, adamw(1e-3), C, privacy=tdp, mode=mode)
    j_state = jd.init_llm_state(jax.random.PRNGKey(1), J_TINY, C, j_adamw(1e-3), jnp.float32,
                                mode=mode)
    t_state = to_torch(jax.device_get(j_state), "cpu")
    for t in range(2):
        jb, tb = _batch(t)
        key = jax.random.PRNGKey(10 + t)
        model_noise, guard_noise = jax_noise(key, jdp)
        j_state, j_m = j_step(j_state, jb, key)
        t_state, t_m = t_step(t_state, tb, model_noise, guard_noise)
        assert set(t_m) == set(j_m) == {"loss", "ce", "grad_norm"}
        for k in j_m:
            np.testing.assert_allclose(t_m[k].numpy(), np.asarray(j_m[k]), err_msg=k, **TOL)
    assert_state(t_state, j_state, 2)
    assert int(t_state["privacy"]["releases"]) == (0 if guard == "off" else 2)


def test_step_leaves_its_input_state_and_updates_in_slices(monkeypatch):
    """The functional step copies: the state it was given is unchanged. An
    update split into slices of 7 elements is the whole update, bit for bit
    (the optimizers are elementwise)."""
    state = td.init_llm_state(torch.Generator().manual_seed(0), T_TINY, C, adamw(1e-3),
                              torch.float32, device="cpu")
    before = tree_map(torch.clone, state)
    _, tb = _batch(0)
    noise = torch.randn((C, B, SEQ, 32), generator=torch.Generator().manual_seed(1))
    step = td.make_guarded_llm_step(T_TINY, T_OPTS, adamw(1e-3), C)
    whole, _ = step(state, tb, noise)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state), tree_leaves(before)))
    monkeypatch.setattr(td, "UPDATE_SLICE", 7)
    sliced, _ = td.make_guarded_llm_step(T_TINY, T_OPTS, adamw(1e-3), C)(state, tb, noise)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(whole), tree_leaves(sliced)))


# ----------------------------------------------------------------- engine
def _sessions(mode="detached", guard="clipped", shared=False, seed=0, cfgs=(J_TINY, T_TINY)):
    jtc = JTrainConfig(**TC, mode=mode, privacy=_dp(guard, False))
    ttc = SplitTrainConfig(**TC, mode=mode, privacy=_dp(guard, True))
    js = JSession(jd.llm_adapter(cfgs[0], J_OPTS, jnp.float32), jtc, j_adamw(1e-3),
                  engine="llm-split", seed=seed, shared_bank=shared)
    ps = SplitSession(td.llm_adapter(cfgs[1], T_OPTS, torch.float32), ttc, adamw(1e-3),
                      engine="llm-split", seed=seed, shared_bank=shared, device="cpu")
    # the reference's weights (before its donating fit frees them)
    ps._native = ps.engine.from_canonical(to_torch(jax.device_get(js.state), "cpu"))
    return js, ps, jtc


def _fit_both(js, ps, jtc, shards, epochs, steps):
    """Both sessions fit; the port's epochs take the reference's plans."""
    lens = jt.device_put_shards(shards)[2]
    root = jax.random.PRNGKey(js.seed)
    e0 = js.engine._epochs_done
    d = ps.adapter.cfg.d_model
    plans = [jax_plan(jtc, steps, lens, jax.random.fold_in(root, e0 + e + 1), d)
             for e in range(epochs)]

    def next_plan(steps_per_epoch, lens, sample_shape):
        ps.engine._epochs_done += 1
        return plans.pop(0)

    ps.engine._next_plan = next_plan
    return (js.fit(shards, epochs=epochs, steps_per_epoch=steps),
            ps.fit(shards, epochs=epochs, steps_per_epoch=steps))


@pytest.mark.parametrize("mode,guard,shared", [("detached", "clipped", False),
                                               ("e2e", "clipped", False),
                                               ("detached", "unclipped", True)])
def test_session_fit_matches_jax(mode, guard, shared):
    """``SplitSession(engine="llm-split").fit``, 2 epochs x 3 steps on the
    reference's plans: each epoch's means and the canonical state."""
    js, ps, jtc = _sessions(mode, guard, shared)
    j_hist, t_hist = _fit_both(js, ps, jtc, tiny_shards(), 2, 3)
    for g, w in zip(t_hist, j_hist):
        assert g.keys() == w.keys()
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
    assert [len(m["loss"]) for m in ps.step_metrics] == [3, 3]
    assert_state(ps.state, jax.device_get(js.state), 6)
    assert ps.privacy_report()["releases"] == 6


@pytest.mark.parametrize("n_clients", [2, 4])
def test_shared_bank_is_the_banked_run(n_clients):
    """``shared_bank=True`` and per-client banks that start equal train bit
    for bit alike (the reference claims the same of XLA's two vmaps, and
    its sweep falsifies that at four clients: ROADMAP queue 3)."""
    tc = SplitTrainConfig(n_clients=n_clients, data_shares=(1.0,) * n_clients,
                          server_batch=2 * n_clients,
                          privacy=DPConfig(epsilon=1.0, clip_norm=1.0, use_kernel=True))
    make = lambda shared: SplitSession(  # noqa: E731
        td.llm_adapter(T_TINY, T_OPTS, torch.float32), tc, adamw(1e-3), engine="llm-split",
        seed=3, shared_bank=shared, device="cpu")
    sa, sb = make(True), make(False)
    sb._native = sb.engine.from_canonical(tree_map(torch.clone, sa.state))
    shards = tiny_shards(n_clients, seed=3, sizes=tuple(12 + 2 * i for i in range(n_clients)))
    sa.fit(shards, epochs=1, steps_per_epoch=3)
    sb.fit(shards, epochs=1, steps_per_epoch=3)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(sa.state), tree_leaves(sb.state)))
    assert sa.engine.identical_banks and not sb.engine.identical_banks


def test_state_is_a_copy_of_weights_drawn_on_the_cpu():
    """The session's weights are ``init_llm_params`` over the CPU generator
    of ``seeded_generator(seed)``, moved to the device (one seed, one model
    on the card and on the CPU), and its ``state`` is a copy: a fit updates
    the native buffers in place and leaves a state taken before it as it
    was."""
    tc = SplitTrainConfig(**TC, privacy=_dp("clipped", True))
    ps = SplitSession(td.llm_adapter(T_TINY, T_OPTS, torch.float32), tc, adamw(1e-3),
                      engine="llm-split", seed=5, device="cpu")
    banks, server = td.init_llm_params(seeded_generator(5), T_TINY, C, torch.float32,
                                       device="cpu")
    before = ps.state
    for got, want in ((before["client_banks"], banks), (before["server"], server)):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    kept = tree_map(torch.clone, before)
    ps.fit(tiny_shards(), epochs=1, steps_per_epoch=2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(before), tree_leaves(kept)))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(ps.state["server"]),
                                                     tree_leaves(kept["server"])))


def test_checkpoints_cross_both_ways(tmp_path):
    """The tied config untied, the trunk's empty ``prefix`` list kept: a
    port checkpoint restores in the reference and the reverse, and a
    restored session continues as the saved one does."""
    tied = dict(TINY_KW, name="llm-tiny-tied", tie_embeddings=True)
    jtc = JTrainConfig(**TC, privacy=JDP(epsilon=1.0, clip_norm=1.0))
    ttc = SplitTrainConfig(**TC, privacy=DPConfig(epsilon=1.0, clip_norm=1.0, use_kernel=True))
    js = JSession(jd.llm_adapter(JConfig(**tied), J_OPTS, jnp.float32), jtc, j_adamw(1e-3),
                  engine="llm-split", seed=0)
    make = lambda: SplitSession(td.llm_adapter(ModelConfig(**tied), T_OPTS, torch.float32),  # noqa: E731
                                ttc, adamw(1e-3), engine="llm-split", seed=0, device="cpu")
    ps = make()
    assert "lm_head" in ps.state["server"] and ps.state["server"]["prefix"] == []
    ps.fit(tiny_shards(), epochs=1, steps_per_epoch=2)
    path = ps.save(str(tmp_path / "port"))
    manifest = js.restore(path)
    assert manifest["metadata"]["engine"] == "llm-split" and js.engine._epochs_done == 1
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in
               zip(tree_leaves(ps.state), jax.tree.leaves(jax.device_get(js.state))))

    jpath = js.save(str(tmp_path / "jax"))
    back = make()
    back.restore(jpath)
    assert back.state["server"]["prefix"] == [] and back.engine._epochs_done == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back.state), tree_leaves(ps.state)))
    h1 = ps.fit(tiny_shards(), epochs=1, steps_per_epoch=2)
    h2 = back.fit(tiny_shards(), epochs=1, steps_per_epoch=2)
    assert h1 == h2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back.state), tree_leaves(ps.state)))


def test_evaluate_and_audit_match_jax():
    """``evaluate`` (per client, share-weighted) on one state, and
    ``audit_privacy`` through the float branch (one attack step, the
    reference's start point and sweep noise fed in)."""
    js, ps, _ = _sessions()
    xs = np.random.default_rng(0).integers(0, 97, (5, SEQ)).astype(np.int32)
    want, got = js.evaluate(xs, xs, batch=2), ps.evaluate(xs, xs, batch=2)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert len(got["per_client"]) == C
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, SEQ, 32)))
    rows = js.audit_privacy(jnp.asarray(h), sigmas=(0.0, 0.5), steps=1)
    assert_rows_close(ps.audit_privacy(h, sigmas=(0.0, 0.5), steps=1,
                                       noise_fn=jax_sweep_noise(0), x0=jax_x0(h.shape)), rows)


def test_engine_rejects_what_the_reference_rejects():
    tc = SplitTrainConfig(**TC)
    with pytest.raises(ValueError, match="llm_adapter"):
        SplitSession(mlp_adapter(CHOLESTEROL_MLP), tc, adamw(1e-3), engine="llm-split",
                     device="cpu")
    with pytest.raises(ValueError, match="per-client"):
        SplitSession(td.llm_adapter(T_TINY, T_OPTS, torch.float32),
                     dataclasses.replace(tc, mode="e2e"), adamw(1e-3), engine="llm-split",
                     shared_bank=True, device="cpu")
    with pytest.raises(ValueError, match="detach_cut"):
        td.llm_step_parts(T_TINY, ModelOptions(detach_cut=False), adamw(1e-3), C)
    with pytest.raises(ValueError, match="mesh"):
        td.make_guarded_llm_step(T_TINY, T_OPTS, adamw(1e-3), C, mesh=object())


def test_deprecated_shims():
    """Both warn; the legacy state lacks the budget, and the legacy step is
    the guarded step with the guard off, bit for bit."""
    with pytest.warns(DeprecationWarning, match="init_llm_state"):
        legacy = td.init_split_state(torch.Generator().manual_seed(7), T_TINY, C, adamw(1e-3),
                                     torch.float32, device="cpu")
    assert "privacy" not in legacy
    with pytest.warns(DeprecationWarning, match="make_guarded_llm_step"):
        old = td.make_llm_split_step(T_TINY, T_OPTS, adamw(1e-3), C)
    new = td.make_guarded_llm_step(T_TINY, T_OPTS, adamw(1e-3), C)
    _, tb = _batch(0)
    noise = torch.randn((C, B, SEQ, 32), generator=torch.Generator().manual_seed(2))
    (s_old, m_old), (s_new, m_new) = old(legacy, tb, noise), new(legacy, tb, noise)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((s_old, m_old)),
                                                 tree_leaves((s_new, m_new))))


def test_train_driver_on_a_reduced_demo(tmp_path, monkeypatch, capsys):
    """``launch.train.main`` on demo-11m reduced, on the CPU: the history,
    a checkpoint a log interval, the metrics JSON."""
    from repro_torch.launch import train

    monkeypatch.setattr(train, "get_config", lambda name: get_config(name).reduced())
    out = tmp_path / "hist.json"
    hist = train.main(["--arch", "demo-11m", "--steps", "4", "--log-every", "2", "--seq", "16",
                       "--batch", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
                       "--ckpt-every", "2", "--out", str(out), "--dp-sigma", "0.1"])
    assert [r["step"] for r in hist] == [2, 4] and all(np.isfinite(r["ce"]) for r in hist)
    assert json.loads(out.read_text()) == hist
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_00000002.json", "ckpt_00000002.npz",
                                                   "ckpt_00000004.json", "ckpt_00000004.npz"]
    assert "privacy:" in capsys.readouterr().out


# ---------------------------------------------------------- the families
def _family(arch):
    """A reduced MoE or SSM config (2 layers, d 256; granite 4 experts, top
    2) with TINY's model noise at the cut, on both sides."""
    return tuple(dataclasses.replace(get(arch).reduced(), privacy_noise=0.02)
                 for get in (j_get_config, get_config))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "falcon-mamba-7b"])
def test_family_guarded_step_matches_jax(arch):
    """Two guarded steps (the clipped guard, detached) of the MoE and the
    SSM families against the reference's, fed its noise: metrics and the
    state at TOL (the AdamW allowance on the weights). The MoE aux counts
    in the loss: ``loss - ce`` is ``MOE_AUX_WEIGHT`` times the server's
    aux, above 0 for granite and 0 for falcon-mamba."""
    jcfg, tcfg = _family(arch)
    jdp, tdp = _dp("clipped", False), _dp("clipped", True)
    j_step = jax.jit(jd.make_guarded_llm_step(jcfg, J_OPTS, j_adamw(1e-3), C, privacy=jdp))
    t_step = td.make_guarded_llm_step(tcfg, T_OPTS, adamw(1e-3), C, privacy=tdp)
    j_state = jd.init_llm_state(jax.random.PRNGKey(2), jcfg, C, j_adamw(1e-3), jnp.float32)
    t_state = to_torch(jax.device_get(j_state), "cpu")
    for t in range(2):
        jb, tb = _batch(t)
        key = jax.random.PRNGKey(20 + t)
        model_noise, guard_noise = jax_noise(key, jdp, d=tcfg.d_model)
        j_state, j_m = j_step(j_state, jb, key)
        t_state, t_m = t_step(t_state, tb, model_noise, guard_noise)
        for k in j_m:
            np.testing.assert_allclose(t_m[k].numpy(), np.asarray(j_m[k]), err_msg=k, **TOL)
        aux = float(t_m["loss"] - t_m["ce"]) / MOE_AUX_WEIGHT
        assert aux > 0.5 if tcfg.n_experts else aux == 0.0
    assert_state(t_state, j_state, 2)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "falcon-mamba-7b"])
def test_family_session_fit_matches_jax(arch):
    """``SplitSession(engine="llm-split").fit`` of each family, 1 epoch x 2
    steps on the reference's plan: the epoch's means and the state."""
    js, ps, jtc = _sessions(cfgs=_family(arch))
    j_hist, t_hist = _fit_both(js, ps, jtc, tiny_shards(), 1, 2)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(t_hist[0][k], j_hist[0][k], err_msg=k, **TOL)
    assert_state(ps.state, jax.device_get(js.state), 2)
    assert ps.privacy_report()["releases"] == 2


def test_moe_checkpoints_cross_both_ways(tmp_path):
    """Reduced granite (tied, so the engine unties it): a port checkpoint
    restores in the reference and the reverse, bit for bit, and the two
    continue alike."""
    jcfg, tcfg = _family("granite-moe-1b-a400m")
    jtc = JTrainConfig(**TC, privacy=JDP(epsilon=1.0, clip_norm=1.0))
    ttc = SplitTrainConfig(**TC, privacy=DPConfig(epsilon=1.0, clip_norm=1.0, use_kernel=True))
    js = JSession(jd.llm_adapter(jcfg, J_OPTS, jnp.float32), jtc, j_adamw(1e-3),
                  engine="llm-split", seed=0)
    make = lambda: SplitSession(td.llm_adapter(tcfg, T_OPTS, torch.float32), ttc,  # noqa: E731
                                adamw(1e-3), engine="llm-split", seed=0, device="cpu")
    ps = make()
    assert "lm_head" in ps.state["server"] and "moe" in ps.state["server"]["groups"]["pos0"]
    ps.fit(tiny_shards(), epochs=1, steps_per_epoch=1)
    js.restore(ps.save(str(tmp_path / "port")))
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in
               zip(tree_leaves(ps.state), jax.tree.leaves(jax.device_get(js.state))))
    back = make()
    back.restore(js.save(str(tmp_path / "jax")))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back.state), tree_leaves(ps.state)))
    assert ps.fit(tiny_shards(), epochs=1, steps_per_epoch=1) == \
        back.fit(tiny_shards(), epochs=1, steps_per_epoch=1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back.state), tree_leaves(ps.state)))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "falcon-mamba-7b",
                                  "jamba-1.5-large-398b"])
def test_train_driver_on_the_families(arch, monkeypatch):
    """``launch.train.main`` takes every family's ``--arch`` (reduced, on the
    CPU): finite losses, the MoE aux in the loss where there is a MoE."""
    from repro_torch.launch import train

    monkeypatch.setattr(train, "get_config", lambda name: get_config(name).reduced())
    hist = train.main(["--arch", arch, "--steps", "2", "--log-every", "2", "--seq", "16",
                       "--batch", "2", "--device", "cpu"])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert (hist[0]["loss"] > hist[0]["ce"]) == (get_config(arch).n_experts > 0)
