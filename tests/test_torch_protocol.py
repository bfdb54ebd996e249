"""The port's ``protocol-async`` engine and its pieces (``core.protocol``,
``core.queue``) against ``repro.core``'s, and inside torch.

Against JAX: the same weights (carried across with the bridge) and the same
noise (JAX's per-release draws fed through ``noise_fn``); batch indices
come from the reference's NumPy seeds. Queue stats, ``dropped``/``drained``
and the budget are exact; losses and state leaves 1e-5 absolute and
relative (float32 dense layers and convs summed in another order). The
narrow CNN runs its client stage through ``privacy_conv`` and the guard
through ``dp_release`` (the JAX side's Pallas kernels in interpret mode,
the port's plain versions on CPU tensors).

Inside torch, bit for bit: fleet production against per-item production,
at sigma 0 and sigma > 0, including a queue so small that every cycle
drains and each epoch ends with a drop. Plus the kernel wrappers'
counters under threads.
"""
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import CHOLESTEROL_MLP as J_MLP
from repro.configs.paper_models import COVID_CNN as J_COVID
from repro.core import SplitSession as JSession
from repro.core import SplitTrainConfig as JConfig
from repro.core.adapters import cnn_adapter as j_cnn_adapter
from repro.core.adapters import mlp_adapter as j_mlp_adapter
from repro.data import make_cholesterol, make_covid_ct, split_clients
from repro.optim import adamw as j_adamw
from repro.privacy import DPConfig as JDPConfig
from repro.privacy.guard import GUARD_KEY_FOLD
from repro_torch.common.bridge import to_torch
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import CHOLESTEROL_MLP, COVID_CNN
from repro_torch.core import FeatureBank, SplitSession, SplitTrainConfig
from repro_torch.core.adapters import cnn_adapter, mlp_adapter
from repro_torch.core.protocol import make_client_release_fwd, make_fleet_release_fwd
from repro_torch.core.queue import FeatureSlice, as_tensor
from repro_torch.kernels.dp_release import ops as dp_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.privacy_conv import ops as pc_ops
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig, PrivacyGuard

TOL = dict(atol=1e-5, rtol=1e-5)
DP = dict(epsilon=1.0, delta=1e-5, clip_norm=1.0)
SHARES = (0.7, 0.2, 0.1)
SMALL = dict(input_hw=(16, 16), stages=((4, 1), (8, 1)), dense_units=(8,))


@pytest.fixture(scope="module")
def chol_shards():
    x, y = make_cholesterol(600, seed=0)
    return split_clients(x, y)


@pytest.fixture(scope="module")
def ct_shards():
    return split_clients(*make_covid_ct(60, hw=16, seed=0), shares=SHARES)


def jax_noise_fn(seed: int, step: int):
    """The JAX queue engines' per-release draws (model noise from the
    release key, the guard's from its ``GUARD_KEY_FOLD`` fold)."""
    root = jax.random.PRNGKey(seed)

    def noise_fn(client, release, model_shape, guard_shape):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(root, step), client),
                               release)
        return (np.asarray(jax.random.normal(k, model_shape, jnp.float32)),
                np.asarray(jax.random.normal(jax.random.fold_in(k, GUARD_KEY_FOLD),
                                             guard_shape, jnp.float32)))

    return noise_fn


def _models(model, dp):
    """(jax adapter, jax config, port adapter, port config, lr)."""
    if model == "mlp":
        kw = dict(server_batch=48)
        return (j_mlp_adapter(J_MLP), JConfig(**kw, privacy=JDPConfig(**DP) if dp else None),
                mlp_adapter(CHOLESTEROL_MLP),
                SplitTrainConfig(**kw, privacy=DPConfig(**DP) if dp else None), 1e-2)
    kw = dict(server_batch=12, data_shares=SHARES)
    jdp = JDPConfig(**DP, use_kernel=True, interpret=True) if dp else None
    return (j_cnn_adapter(dataclasses.replace(J_COVID, **SMALL, use_kernel=True,
                                              interpret=True)),
            JConfig(**kw, privacy=jdp),
            cnn_adapter(dataclasses.replace(COVID_CNN, **SMALL, use_kernel=True)),
            SplitTrainConfig(**kw, privacy=DPConfig(**DP, use_kernel=True) if dp else None),
            1e-2)


def _pair(engine, production, model="mlp", dp=True, **kw):
    """A JAX session and a port session on the JAX session's weights."""
    ja, jc, ta, tc, lr = _models(model, dp)
    js = JSession(ja, jc, j_adamw(lr), engine=engine, seed=0, threaded=False,
                  production=production, **kw)
    ps = SplitSession(ta, tc, adamw(lr), engine=engine, seed=0, device="cpu",
                      threaded=False, production=production, **kw)
    ps._native = ps.engine.from_canonical(to_torch(jax.device_get(js.state), "cpu"))
    return js, ps


def _fit_both(js, ps, shards, *, epochs, steps):
    ps.engine.noise_fn = jax_noise_fn(0, int(ps.state["step"]))
    return (js.fit(shards, epochs=epochs, steps_per_epoch=steps),
            ps.fit(shards, epochs=epochs, steps_per_epoch=steps))


def assert_matches_jax(js, ps, jh, ph):
    assert ps.engine.stats == js.engine.stats
    assert ps.privacy_report() == js.privacy_report()
    assert [h["server_steps"] for h in ph] == [h["server_steps"] for h in jh]
    np.testing.assert_allclose(ps.engine.losses, js.engine.losses, **TOL)
    jl, pl = jax.tree.leaves(js.state), tree_leaves(ps.state)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def _fit(engine, production, model="mlp", dp=False, *, epochs=3, steps=6, **kw):
    _, _, ta, tc, lr = _models(model, dp)
    s = SplitSession(ta, tc, adamw(lr), engine=engine, seed=0, device="cpu",
                     threaded=False, production=production, **kw)
    shards = (split_clients(*make_cholesterol(600, seed=0)) if model == "mlp"
              else split_clients(*make_covid_ct(60, hw=16, seed=0), shares=SHARES))
    return s, s.fit(shards, epochs=epochs, steps_per_epoch=steps)


def assert_bitwise(sa, sb):
    la, lb = tree_leaves(sa.state), tree_leaves(sb.state)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert torch.equal(a, b)


# ------------------------------------------------ against JAX
@pytest.mark.parametrize("production", ("fleet", "per-item"))
@pytest.mark.parametrize("dp", (False, True), ids=("sigma0", "dp"))
def test_protocol_async_matches_jax(chol_shards, production, dp):
    """Two fits (the second reseeds from the consumed step): the sampled
    batches, queue accounting and budget exact, numbers 1e-5."""
    js, ps = _pair("protocol-async", production, dp=dp)
    for _ in range(2):
        jh, ph = _fit_both(js, ps, chol_shards, epochs=2, steps=6)
        assert_matches_jax(js, ps, jh, ph)


def test_protocol_async_matches_jax_under_a_full_queue(chol_shards):
    """A two-slot queue: drains every cycle and a drop at each epoch's end,
    counted as the reference counts them."""
    js, ps = _pair("protocol-async", "fleet", queue_size=2)
    jh, ph = _fit_both(js, ps, chol_shards, epochs=3, steps=6)
    assert ps.engine.stats["dropped"] > 0 and ps.engine.stats["drained"] > 0
    assert_matches_jax(js, ps, jh, ph)


@pytest.mark.parametrize("production", ("fleet", "per-item"))
def test_protocol_async_cnn_kernels_match_jax(ct_shards, production):
    """The narrow CNN with the privacy kernel in the client stage and the
    clipped guard through the release kernel, at sigma > 0."""
    js, ps = _pair("protocol-async", production, model="cnn")
    jh, ph = _fit_both(js, ps, ct_shards, epochs=2, steps=4)
    assert_matches_jax(js, ps, jh, ph)


# ------------------------------------------------ inside torch
@pytest.mark.parametrize("model,dp", [("mlp", False), ("mlp", True), ("cnn", True)])
def test_fleet_bit_exact_vs_per_item(model, dp):
    """Fleet production changes nothing but the dispatches: losses, state
    and accounting bit for bit, also across a second fit."""
    sp, hp = _fit("protocol-async", "per-item", model, dp)
    sf, hf = _fit("protocol-async", "fleet", model, dp)
    assert hp == hf and sp.engine.losses == sf.engine.losses
    assert sp.engine.stats == sf.engine.stats
    assert_bitwise(sp, sf)


def test_full_queue_drop_drain_matches_per_item():
    sp, hp = _fit("protocol-async", "per-item", queue_size=2)
    sf, hf = _fit("protocol-async", "fleet", queue_size=2)
    assert sf.engine.stats == sp.engine.stats
    assert sf.engine.stats["dropped"] > 0 and sf.engine.stats["drained"] > 0
    assert hp == hf
    assert_bitwise(sp, sf)


def test_per_client_cap_falls_back_to_per_item():
    sf, hf = _fit("protocol-async", "fleet", epochs=1, steps=5, per_client_cap=2)
    sp, hp = _fit("protocol-async", "per-item", epochs=1, steps=5, per_client_cap=2)
    assert hf == hp and sf.engine.stats == sp.engine.stats
    assert_bitwise(sf, sp)


def test_fleet_release_equals_item_releases():
    """The fleet forward of a cycle, item for item, is the per-item release:
    the banked privacy_conv stage, a plain conv stage after it (two client
    stages), the model noise and the guard at sigma > 0."""
    cfg = dataclasses.replace(COVID_CNN, input_hw=(16, 16), stages=((4, 1), (6, 2), (8, 1)),
                              dense_units=(8,), cut_layers=2, use_kernel=True)
    adapter = cnn_adapter(cfg)
    guard = PrivacyGuard(DPConfig(**DP, use_kernel=True))
    gen = torch.Generator().manual_seed(0)
    banks = [adapter.init(gen, "cpu")["client"] for _ in range(3)]
    cids = [0, 0, 2, 1, 2]
    xs = torch.rand((5, 3, 16, 16, 1), generator=gen)
    fshape = (5,) + adapter.feature_shape((3, 16, 16, 1))
    mn, gn = torch.randn(fshape, generator=gen), torch.randn(fshape, generator=gen)
    stacked = tree_map(lambda *a: torch.stack(a), *banks)
    fleet = make_fleet_release_fwd(adapter, guard)(
        stacked, torch.tensor(cids, dtype=torch.int32), xs, mn, gn)
    one = make_client_release_fwd(adapter, guard)
    for n, c in enumerate(cids):
        assert torch.equal(fleet[n], one(banks[c], xs[n], mn[n], gn[n]))


def test_threaded_fleet_conserves_items(chol_shards):
    """The threaded drive with fleet_chunk 4: arrival order is the OS's, so
    only conservation is asserted."""
    session = SplitSession(mlp_adapter(CHOLESTEROL_MLP),
                           SplitTrainConfig(server_batch=48, privacy=DPConfig(**DP)),
                           adamw(1e-2), engine="protocol-async", seed=0, device="cpu",
                           threaded=True, fleet_chunk=4)
    hist = session.fit(chol_shards, epochs=2, steps_per_epoch=5)
    stats, fs = session.engine.stats, session.fault_stats
    assert int(session.state["step"]) == 10 and stats["popped"] == 10
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert stats["dropped"] == stats["drained"] == 0
    # every release is produced in chunks of 4, and none is lost unaccounted
    assert all(r % 4 == 0 for r in fs["releases_per_client"])
    assert stats["pushed"] <= sum(fs["releases_per_client"])
    assert session.privacy_report()["releases"] == max(fs["releases_per_client"])


def test_bad_options_rejected():
    def make(**kw):
        return SplitSession(mlp_adapter(CHOLESTEROL_MLP), SplitTrainConfig(server_batch=48),
                            adamw(1e-2), engine="protocol-async", device="cpu", **kw)

    for bad, what in ((dict(production="batch"), "production"),
                      (dict(fleet_chunk=0), "fleet_chunk"),
                      (dict(pop_timeout=-1.0), "pop_timeout"),
                      (dict(pop_retries=-1), "pop_retries"),
                      (dict(pop_backoff=0.5), "pop_backoff")):
        with pytest.raises(ValueError, match=what):
            make(**bad)
    with pytest.raises(ValueError, match="detached"):
        SplitSession(mlp_adapter(CHOLESTEROL_MLP),
                     SplitTrainConfig(server_batch=48, mode="e2e"), adamw(1e-2),
                     engine="fused-queue", device="cpu")
    prebuilt = make().engine
    with pytest.raises(ValueError, match="engine options"):
        SplitSession(mlp_adapter(CHOLESTEROL_MLP), SplitTrainConfig(server_batch=48),
                     adamw(1e-2), engine=prebuilt, device="cpu", threaded=True)


def test_feature_slice_and_bank_gather():
    """A FeatureSlice is a view of its row; FeatureBank.stacked gathers
    same-parent runs and pads a partial bank with invalid zero slots, bit
    for bit what stacking the rows gives."""
    gen = torch.Generator().manual_seed(0)
    parent, other = torch.randn((5, 4, 3), generator=gen), torch.randn((2, 4, 3), generator=gen)
    sl = FeatureSlice(parent, 2)
    assert sl.shape == (4, 3) and sl.tensor().data_ptr() == parent[2].data_ptr()
    assert torch.equal(as_tensor(sl, "cpu"), parent[2])
    bank = FeatureBank(capacity=6)
    items = [FeatureSlice(parent, 0), FeatureSlice(parent, 3), other[0].numpy(),
             FeatureSlice(other, 1), FeatureSlice(parent, 4)]
    labels = np.arange(20, dtype=np.float32).reshape(5, 4)
    for f, lab in zip(items, labels):
        bank.accept(0, f, lab)
    feats, labs, valid = bank.stacked("cpu")
    want = torch.stack([parent[0], parent[3], other[0], other[1], parent[4],
                        torch.zeros((4, 3))])
    assert torch.equal(feats, want)
    assert torch.equal(labs[:5], torch.from_numpy(labels)) and not labs[5].any()
    assert valid.tolist() == [True] * 5 + [False]
    bank.accept(1, parent[1].numpy(), labels[0])
    with pytest.raises(RuntimeError, match="over capacity"):
        bank.accept(0, parent[1], labels[0])


# ------------------------------------------------ counters under threads
@pytest.mark.parametrize("ops,args", [(pc_ops, ({"cin_variant": 1, "vec4": True},)),
                                      (dp_ops, ({"blocks_per_row": 2, "launches": 2},)),
                                      (fa_ops, ()), (ss_ops, ())])
def test_launch_counters_exact_under_threads(ops, args):
    """Eight threads count at once (the threaded drive's client threads
    launch kernels together): no increment is lost. The CPU path does not
    count, so this drives the counting helper itself."""
    per_thread, threads = 2000, 8
    before = ops.launches
    plans_before = dict(ops.plans) if hasattr(ops, "plans") else None
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [ops.count(*args)
                                                    for _ in range(per_thread)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    step = args[0].get("launches", 1) if args else 1
    assert ops.launches - before == per_thread * threads * step
    if plans_before is not None:
        key = tuple(sorted(args[0].items()))
        assert ops.plans[key] - plans_before.get(key, 0) == per_thread * threads
        ops.plans.clear()
        ops.plans.update(plans_before)
    ops.launches = before
