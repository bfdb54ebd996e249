"""The port's ``fused-queue`` engine and its bank replay
(``trainer.make_server_bank_runner``) against ``repro.core``'s, and inside
torch.

Against JAX (the same weights and noise, as ``test_torch_protocol.py``):
accounting and budget exact, losses and state leaves 1e-5; checkpoints
interchange both ways with the JAX queue engines, leaf for leaf. Inside
torch, bit for bit: fused-queue against protocol-async (the replay calls
the per-pop step), the replay against stepping the same slots one by one, a
partial bank's masked slots, ``steps_per_epoch`` as a mere chunk size, and a
save/restore that continues.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import SplitSession as JSession
from repro.optim import adamw as j_adamw
from repro_torch.common.tree import tree_leaves
from repro_torch.core import SplitSession, make_server_bank_runner
from repro_torch.core.trainer import make_server_step
from repro_torch.optim import adamw

from test_torch_protocol import (  # noqa: E402
    _fit,
    _fit_both,
    _models,
    _pair,
    assert_bitwise,
    assert_matches_jax,
)


@pytest.fixture(scope="module")
def chol_shards():
    from repro.data import make_cholesterol, split_clients

    return split_clients(*make_cholesterol(600, seed=0))


# ------------------------------------------------ against JAX
@pytest.mark.parametrize("production", ("fleet", "per-item"))
@pytest.mark.parametrize("dp", (False, True), ids=("sigma0", "dp"))
def test_fused_queue_matches_jax(chol_shards, production, dp):
    js, ps = _pair("fused-queue", production, dp=dp)
    for _ in range(2):
        jh, ph = _fit_both(js, ps, chol_shards, epochs=2, steps=6)
        assert_matches_jax(js, ps, jh, ph)


def test_fused_queue_cnn_kernels_match_jax():
    from repro.data import make_covid_ct, split_clients

    shards = split_clients(*make_covid_ct(60, hw=16, seed=0), shares=(0.7, 0.2, 0.1))
    js, ps = _pair("fused-queue", "fleet", model="cnn")
    jh, ph = _fit_both(js, ps, shards, epochs=2, steps=4)
    assert_matches_jax(js, ps, jh, ph)


@pytest.mark.parametrize("engine", ("protocol-async", "fused-queue"))
def test_port_checkpoint_loads_in_jax_queue_engine(tmp_path, chol_shards, engine):
    """A port queue engine's save (moment-tree ``opt``, server-step
    ``step``) restores in the JAX engine of the other kind, leaf for leaf,
    and both continue alike."""
    js, ps = _pair(engine, "fleet")
    _fit_both(js, ps, chol_shards, epochs=1, steps=5)
    path = ps.save(str(tmp_path))
    other = "fused-queue" if engine == "protocol-async" else "protocol-async"
    ja, jc, _, _, lr = _models("mlp", True)
    j2 = JSession(ja, jc, j_adamw(lr), engine=other, seed=0, threaded=False)
    j2.restore(path)
    for a, b in zip(jax.tree.leaves(j2.state), tree_leaves(ps.state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert isinstance(ps.state["opt"], dict) and set(ps.state["opt"]) == {"mu", "nu"}
    assert int(j2.state["step"]) == 5


@pytest.mark.parametrize("engine", ("protocol-async", "fused-queue"))
def test_jax_checkpoint_restores_in_port_queue_engine(tmp_path, chol_shards, engine):
    """A JAX queue engine's save restores in the port's engine of the other
    kind leaf for leaf; the port then continues as the JAX session does."""
    js, _ = _pair(engine, "fleet")
    js.fit(chol_shards, epochs=1, steps_per_epoch=5)
    path = js.save(str(tmp_path))
    other = "fused-queue" if engine == "protocol-async" else "protocol-async"
    _, ps = _pair(other, "fleet")
    ps.restore(path)
    for a, b in zip(jax.tree.leaves(js.state), tree_leaves(ps.state)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jh, ph = _fit_both(js, ps, chol_shards, epochs=1, steps=5)
    np.testing.assert_allclose(ph[0]["loss"], jh[0]["loss"], rtol=1e-5)
    assert ps.privacy_report() == js.privacy_report()


# ------------------------------------------------ inside torch
@pytest.mark.parametrize("model,dp,production", [("mlp", False, "fleet"), ("mlp", True, "fleet"),
                                                 ("mlp", False, "per-item"),
                                                 ("cnn", True, "fleet")])
def test_bit_exact_with_protocol_async(model, dp, production):
    sp, hp = _fit("protocol-async", production, model, dp)
    sq, hq = _fit("fused-queue", production, model, dp)
    assert hp == hq and sp.engine.losses == sq.engine.losses
    assert sp.engine.stats == sq.engine.stats
    assert sp.fault_stats == sq.fault_stats
    assert_bitwise(sp, sq)


def test_full_queue_drop_drain_matches_protocol_async():
    sp, hp = _fit("protocol-async", "fleet", queue_size=2)
    sq, hq = _fit("fused-queue", "fleet", queue_size=2)
    assert sp.engine.stats == sq.engine.stats and sq.engine.stats["dropped"] > 0
    assert hp == hq
    assert_bitwise(sp, sq)


def _bank(seed, k, b=6, f=64):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((k, b, f), generator=gen), 100 * torch.rand((k, b), generator=gen))


def test_bank_replay_bit_exact_vs_per_pop_step():
    """The replay calls the per-pop step on each slot: the same bits as
    stepping the slots one by one, losses included."""
    _, _, ta, _, _ = _models("mlp", False)
    opt = adamw(1e-2)
    server = ta.init(torch.Generator().manual_seed(0), "cpu")["server"]
    feats, labels = _bank(1, 5)
    run = make_server_bank_runner(ta, opt, 1.0)
    p1, o1, step, losses = run(server, opt.init(server), 3, feats, labels,
                               torch.ones(5, dtype=torch.bool))
    step_fn = make_server_step(ta, opt, 1.0)
    p2, o2, want = server, opt.init(server), []
    for k in range(5):
        p2, o2, loss = step_fn(p2, o2, 3 + k, feats[k].clone(), labels[k].clone())
        want.append(loss)
    assert step == 8 and torch.equal(losses, torch.stack(want))
    for a, b in zip(tree_leaves((p1, o1)), tree_leaves((p2, o2))):
        assert torch.equal(a, b)


def test_partial_bank_masks_invalid_slots():
    """Invalid slots are identity updates with NaN losses: the valid prefix
    trains exactly as a bank of just those slots."""
    _, _, ta, _, _ = _models("mlp", False)
    opt = adamw(1e-2)
    server = ta.init(torch.Generator().manual_seed(0), "cpu")["server"]
    feats, labels = _bank(2, 5)
    run = make_server_bank_runner(ta, opt, 1.0)
    valid = torch.tensor([True, True, True, False, False])
    p1, o1, step, losses = run(server, opt.init(server), 0, feats, labels, valid)
    p2, o2, step2, losses2 = run(server, opt.init(server), 0, feats[:3], labels[:3],
                                 valid[:3])
    assert step == step2 == 3
    assert torch.isnan(losses[3:]).all() and torch.equal(losses[:3], losses2)
    for a, b in zip(tree_leaves((p1, o1)), tree_leaves((p2, o2))):
        assert torch.equal(a, b)


def test_steps_per_epoch_is_only_a_chunk_size():
    """3 epochs x 4 steps replay 1 epoch x 12 steps: the step counter and
    the clients' seed base are absolute, so steps_per_epoch only chunks the
    bank (at sigma 0: with the guard on, each epoch's drive produces a
    cycle ahead, so the release count depends on the chunking)."""
    sa, _ = _fit("fused-queue", "fleet", epochs=1, steps=12)
    sb, _ = _fit("fused-queue", "fleet", epochs=3, steps=4)
    assert sa.engine.losses == sb.engine.losses
    assert_bitwise(sa, sb)


def test_save_restore_mid_run_resumes_identically(tmp_path, chol_shards):
    sa, _ = _fit("fused-queue", "fleet", dp=True, epochs=1, steps=6)
    path = sa.save(str(tmp_path))
    _, _, ta, tc, lr = _models("mlp", True)
    sb = SplitSession(ta, tc, adamw(lr), engine="fused-queue", seed=0, device="cpu",
                      threaded=False)
    sb.restore(path)
    ha = sa.fit(chol_shards, epochs=2, steps_per_epoch=6)
    hb = sb.fit(chol_shards, epochs=2, steps_per_epoch=6)
    assert ha == hb
    assert_bitwise(sa, sb)


def test_zero_steps_per_epoch_rejected(chol_shards):
    s, _ = _fit("fused-queue", "fleet", epochs=1, steps=1)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        s.fit(chol_shards, epochs=1, steps_per_epoch=0)
    assert math.isfinite(s.history[0]["loss"])
