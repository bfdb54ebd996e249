"""The reference's bfloat16 LM training in the port: ``llm-split`` fits,
checkpoints and the sharded path, against the JAX package (the whole bf16
model and the optimizer step over the mixed-dtype flat buffers:
``tests/test_torch_bf16_model.py``).

A bfloat16 config's state holds its matrices in bf16 beside float32 norms,
router, ``A_log``, ``D`` and ``dt_bias``, and float32 AdamW moments, on both
sides. The same inputs on both sides, as ``tests/test_torch_llm_split.py``:
the reference's weights through ``common.bridge.to_torch``, its plans, and
its draws fed in (the model noise drawn in h's dtype, bf16, as the
reference's ``privacy_cut``; the guard's in float32, as its guard).

Tolerances, each argued from a measurement on this suite's inputs (the
model's and the optimizer step's in ``tests/test_torch_bf16_model.py``):

- **``llm-split`` fits** (3 steps, detached and e2e, the clipped guard at
  the calibrated σ through ``dp_release``'s wrapper): the step's bf16
  gradients part as the whole model's (``test_torch_bf16_model.py``), so the losses within rtol 2e-4
  (measured 3.6e-5), the gradient norm within 1e-4 (7.8e-6), the moments
  within 1e-2 in relative L2 (2.0–2.8e-3). A bf16 weight moves by a
  rounded update ``bf16(w + bf16(-lr u))``: where ``w + u`` lies near a
  rounding boundary one side lands on the neighbour, one ulp of w away,
  and where the two sides' ``u`` part (a gradient near 0, so ``m / sqrt(v)``
  of either sign) by up to 2 lr. So every weight within ``steps * (ulp(w)
  + 2 lr)`` of the reference; measured: 3.1–4.5% of the weights part at
  all, 0.5–0.9% by more than an ulp, the largest by 3.9 lr (one ulp of a
  weight near 0.5); at most 10% and 2% allowed.
- **The sharded path** (four gloo ranks, (1, 4) split grid and a (2, 2)
  production grid with ``zero1``) against the unsharded bf16 run: each
  row-parallel layer rounds its partial products to bf16 before their
  sum, and on the production grid each data rank's bf16 gradient is summed
  with the other's in bf16 (the port's all-reduce, as GSPMD's of bf16
  partial gradients; the halving is exact): two roundings more than the
  unsharded step's one. Measured: the losses 7.9e-5 (split) and 5.7e-4
  (production) apart in relative terms, the moments 0.3% and 1.5–1.7% in
  relative L2; the weights as the fits' (1.1% and 2.6% part, 0.2% and
  0.5% by more than an ulp). So the losses within rtol 1.5e-3, the
  moments within 4% and the weights within the fits' allowances.
"""
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.common.tree import buffers, tree_leaves, tree_map_with_path
from repro_torch.configs.base import ModelConfig
from repro_torch.core import SamplePlan, SplitSession, SplitTrainConfig
from repro_torch.core import distributed as td
from repro_torch.models.transformer import ModelOptions
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_TOL = {"loss_rtol": 2e-4, "grad_norm_rtol": 1e-4, "moments_rel_l2": 1e-2,
           "weights_part": 0.10, "weights_past_an_ulp": 0.02}
LR = 1e-3
SEQ, C, B = 8, 3, 2
TINY_KW = dict(name="llm-tiny-bf16", family="dense", n_layers=2, d_model=32, n_heads=2,
               n_kv_heads=1, d_ff=64, vocab_size=97, dtype="bfloat16", cut_layers=1,
               privacy_noise=0.02)
J_TINY, T_TINY = JConfig(**TINY_KW), ModelConfig(**TINY_KW)
J_OPTS, T_OPTS = JOptions(q_block=8, kv_block=8), ModelOptions(q_block=8, kv_block=8)
TC = dict(n_clients=C, data_shares=(0.7, 0.2, 0.1), server_batch=C * B)
DP = dict(epsilon=1.0, delta=1e-5, clip_norm=1.0)


def _f32(x) -> np.ndarray:
    """A JAX or numpy leaf as float32 values (bf16 exactly)."""
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _vec(leaves) -> np.ndarray:
    return np.concatenate([(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                            else _f32(x)).ravel() for x in leaves])


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at the float32 values ``v`` (8 bits of mantissa)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def weights_parting(got, want, steps: int, lr: float = LR) -> dict:
    """How ``got``'s weights part from ``want``'s: the share that part at
    all and by more than an ulp, and whether each is within ``steps *
    (ulp(w) + 2 lr)`` (the module docstring)."""
    g, w = _vec(got), _vec(want)
    err = np.abs(g - w)
    ulp = np.maximum(bf16_ulp(g), bf16_ulp(w))
    return {"part": float((err > 0).mean()), "past_an_ulp": float((err > ulp).mean()),
            "within": bool((err <= steps * (ulp + 2 * lr)).all()),
            "max_over_lr": float(err.max() / lr)}


def assert_fit_state(got, want, steps: int, what: str) -> None:
    for part in ("server", "client_banks"):
        p = weights_parting(tree_leaves(got[part]), jax.tree.leaves(want[part]), steps)
        assert p["within"], (what, part, p)
        assert p["part"] <= FIT_TOL["weights_part"], (what, part, p)
        assert p["past_an_ulp"] <= FIT_TOL["weights_past_an_ulp"], (what, part, p)
    for k in ("mu", "nu"):
        assert _rel_l2(_vec(tree_leaves(got["opt"][k])), _vec(jax.tree.leaves(want["opt"][k]))) \
            <= FIT_TOL["moments_rel_l2"], (what, k)
    assert int(got["step"]) == int(want["step"])
    assert int(got["privacy"]["releases"]) == int(want["privacy"]["releases"])


def assert_mixed_state(state) -> None:
    """The reference's dtypes: bf16 matrices, float32 vectors of the norms
    (and the SSM's and router's float32 leaves), float32 moments."""
    found = []
    tree_map_with_path(lambda path, x: found.append((path, x)), state)
    for path, x in found:
        if path[0] in ("opt", "privacy", "step"):
            assert x.dtype in (torch.float32, torch.int32), path
        elif str(path[-1]).endswith("norm"):
            assert x.dtype == torch.float32, path
        elif path[-1] in ("embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                          "w_down"):
            assert x.dtype == torch.bfloat16, path


# ------------------------------------------------------------ the fits
def jax_noise(key, dp, n_clients=C, b=B, d=TINY_KW["d_model"]):
    """The model noise the reference's bf16 step draws in h's dtype, and
    its guard's float32 noise, ``[C, b, S, d]`` each, as float32 tensors."""
    keys = jax.random.split(key, n_clients)
    shape = (b, SEQ, d)
    model = np.stack([_f32(jax.random.normal(k, shape, jnp.bfloat16)) for k in keys])
    guard = np.stack([np.asarray(jax.random.normal(JGuard(dp).key_for(k), shape, jnp.float32))
                      for k in keys])
    return torch.from_numpy(model), torch.from_numpy(guard)


def jax_plan(jtc, steps, lens, epoch_key) -> SamplePlan:
    idx, step_keys = jt.make_sample_plan(jtc, steps)(lens, epoch_key)
    noise = [jax_noise(step_keys[t], jtc.privacy, jtc.n_clients, jt.fused_client_batch(jtc))
             for t in range(steps)]
    return SamplePlan(torch.from_numpy(np.array(idx)).long(),
                      torch.stack([n[0] for n in noise]), torch.stack([n[1] for n in noise]))


def tiny_shards(seed=0, sizes=(24, 16, 12)):
    rng = np.random.default_rng(seed)
    return [(w, w) for w in (rng.integers(0, 97, (n, SEQ)).astype(np.int32) for n in sizes)]


def _sessions(mode):
    jtc = JTrainConfig(**TC, mode=mode, privacy=JDP(**DP))
    ttc = SplitTrainConfig(**TC, mode=mode, privacy=DPConfig(**DP, use_kernel=True))
    js = JSession(jd.llm_adapter(J_TINY, J_OPTS), jtc, j_adamw(LR), engine="llm-split", seed=0)
    ps = SplitSession(td.llm_adapter(T_TINY, T_OPTS), ttc, adamw(LR), engine="llm-split",
                      seed=0, device="cpu")
    ps._native = ps.engine.from_canonical(to_torch(jax.device_get(js.state), "cpu"))
    return js, ps, jtc


def _fit_both(js, ps, jtc, steps):
    shards = tiny_shards()
    lens = jt.device_put_shards(shards)[2]
    plan = jax_plan(jtc, steps, lens,
                    jax.random.fold_in(jax.random.PRNGKey(js.seed), js.engine._epochs_done + 1))
    def next_plan(*_):
        ps.engine._epochs_done += 1
        return plan

    ps.engine._next_plan = next_plan
    return js.fit(shards, epochs=1, steps_per_epoch=steps), \
        ps.fit(shards, epochs=1, steps_per_epoch=steps)


@pytest.mark.parametrize("mode", ["detached", "e2e"])
def test_llm_split_fit_in_bf16_follows_jax(mode):
    """``SplitSession(engine="llm-split")`` on a bf16 config, 3 steps on the
    reference's plan, the clipped guard at the calibrated σ: the state
    keeps the reference's dtypes; the metrics, the moments and the weights
    within ``FIT_TOL`` (module docstring)."""
    js, ps, jtc = _sessions(mode)
    assert_mixed_state(ps.state)
    native = ps.native_state
    assert {b.dtype for b in buffers(native["flat"])} == {torch.bfloat16, torch.float32}
    assert all(b.dtype == torch.float32 for k in native["opt"] for b in buffers(native["opt"][k]))
    (jh,), (th,) = _fit_both(js, ps, jtc, 3)
    np.testing.assert_allclose([th["loss"], th["ce"]], [jh["loss"], jh["ce"]],
                               rtol=FIT_TOL["loss_rtol"])
    np.testing.assert_allclose(th["grad_norm"], jh["grad_norm"], rtol=FIT_TOL["grad_norm_rtol"])
    assert_mixed_state(ps.state)
    assert_fit_state(ps.state, jax.device_get(js.state), 3, mode)
    assert ps.privacy_report()["releases"] == 3


def test_bf16_checkpoints_cross_both_ways(tmp_path):
    """A reference bf16 checkpoint restores in the port bit for bit (bf16
    beside float32 leaves, through the bridge) and the restored session
    continues as the saved one does; the port's checkpoint of the same
    state holds the reference writer's keys, dtypes and bits, bf16 as its
    2-byte void (the reference's own loader reads neither: ROADMAP §3)."""
    js, ps, jtc = _sessions("detached")
    _fit_both(js, ps, jtc, 2)
    jpath = js.save(str(tmp_path / "jax"))
    back = SplitSession(td.llm_adapter(T_TINY, T_OPTS), ps.config, adamw(LR),
                        engine="llm-split", seed=0, device="cpu")
    back.restore(jpath)
    assert_mixed_state(back.state)
    assert all(np.array_equal(a.float().numpy(), _f32(b)) and
               str(a.dtype).removeprefix("torch.") == np.asarray(b).dtype.name
               for a, b in zip(tree_leaves(back.state), jax.tree.leaves(jax.device_get(js.state))))
    # the port's file of the reference's state: the reference writer's bits
    ps._native = ps.engine.from_canonical(back.state)
    ppath = ps.save(str(tmp_path / "port"))
    with np.load(jpath) as jf, np.load(ppath) as pf:
        assert sorted(jf.files) == sorted(pf.files)
        for k in jf.files:
            assert jf[k].dtype.str == pf[k].dtype.str and jf[k].tobytes() == pf[k].tobytes(), k
    # restored from either file, a session continues alike, bit for bit
    again = SplitSession(td.llm_adapter(T_TINY, T_OPTS), ps.config, adamw(LR),
                         engine="llm-split", seed=0, device="cpu")
    again.restore(ppath)
    h1 = back.fit(tiny_shards(), epochs=1, steps_per_epoch=2)
    h2 = again.fit(tiny_shards(), epochs=1, steps_per_epoch=2)
    assert h1 == h2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again.state),
                                                 tree_leaves(back.state)))


# --------------------------------------------- the sharded path (gloo)
SPAWN_LIMIT_S = 150
SHARD_KW = dict(name="tp-dense-bf16", family="dense", n_layers=3, d_model=32, n_heads=2,
                n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=96, dtype="bfloat16",
                cut_layers=1, privacy_noise=0.02)
N_CLIENTS = 4
SHARD_LOSS_RTOL, SHARD_MOMENTS_REL_L2 = 1.5e-3, 0.04


def test_4_rank_sharded_bf16_follows_the_unsharded_run(tmp_path):
    """The bf16 state sharded on four gloo ranks: ``llm-split`` over the
    (1, 4) split grid (3 steps of a fit) and ``launch.steps``' train step
    on a (2, 2) production grid with ``zero1``, against the unsharded bf16
    run; every rank's held buffers in the reference's dtypes; the state
    after the steps within ``FIT_TOL`` (module docstring)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "GLOO_SOCKET_IFNAME": "lo",
           "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    procs, logs = [], []
    for r in range(4):
        log = open(tmp_path / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                                       str(tmp_path)], env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"the ranks did not finish within {SPAWN_LIMIT_S} s")
    finally:
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{r}.log").read_text()[-4000:]
    got = json.loads((tmp_path / "result.json").read_text())
    for key in ("split_1x4", "production_2x2_zero1"):
        r = got[key]
        assert r["buffer_dtypes"] == [["bfloat16", "float32"]] * 4, key  # sorted
        np.testing.assert_allclose(r["losses"], r["base_losses"], rtol=SHARD_LOSS_RTOL,
                                   err_msg=key)
        assert r["weights"]["within"], (key, r["weights"])
        assert r["weights"]["part"] <= FIT_TOL["weights_part"], (key, r["weights"])
        assert r["weights"]["past_an_ulp"] <= FIT_TOL["weights_past_an_ulp"], (key, r["weights"])
        assert max(r["moments_rel_l2"]) <= SHARD_MOMENTS_REL_L2, (key, r)


def _rank_job(rank: int, out_dir: str) -> None:
    """One of four ranks (``python tests/test_torch_bf16_train.py <rank>
    <dir>``): gloo over a file store; rank 0 writes ``result.json``."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh, make_split_mesh
    from repro_torch.sharding.tensor_parallel import local_shard, shard_tree
    from repro_torch.sharding.specs import spec_leaves

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), 4),
                            rank=rank, world_size=4)
    cfg = ModelConfig(**SHARD_KW)
    opts = ModelOptions(q_block=SEQ, kv_block=SEQ)
    result = {}

    def gathered(obj):
        out = [None] * 4
        dist.all_gather_object(out, obj)
        return out

    def compare(got, want, lr):
        return {"weights": weights_parting([*tree_leaves(got["client_banks"]),
                                            *tree_leaves(got["server"])],
                                           [*tree_leaves(want["client_banks"]),
                                            *tree_leaves(want["server"])], 3, lr),
                "moments_rel_l2": [_rel_l2(_vec(tree_leaves(got["opt"][k])),
                                           _vec(tree_leaves(want["opt"][k])))
                                   for k in sorted(want["opt"])]}

    # the (1, 4) split grid: a fit of 3 steps against no mesh
    rng = np.random.default_rng(0)
    shards = [(w, w) for w in (rng.integers(0, 96, (12, SEQ), dtype=np.int32)
                               for _ in range(N_CLIENTS))]
    tc = SplitTrainConfig(n_clients=N_CLIENTS, data_shares=(1.0,) * N_CLIENTS,
                          server_batch=2 * N_CLIENTS, privacy=DPConfig(**DP, use_kernel=True))
    runs = {}
    for name, mesh in (("base", None), ("split", make_split_mesh(1, 4, device_type="cpu"))):
        s = SplitSession(td.llm_adapter(cfg, opts), tc, adamw(LR), engine="llm-split",
                         mesh=mesh, seed=0, device="cpu")
        dtypes = sorted(str(b.dtype).removeprefix("torch.")
                        for b in buffers(s.native_state["flat"]))
        s.fit(shards, epochs=1, steps_per_epoch=3)
        runs[name] = (s.state, [float(x) for x in s.step_metrics[-1]["loss"]], dtypes)
    result["split_1x4"] = {"losses": runs["split"][1], "base_losses": runs["base"][1],
                           "buffer_dtypes": gathered(runs["split"][2]),
                           **compare(runs["split"][0], runs["base"][0], LR)}
    # a (2, 2) production grid, zero1: launch.steps' train step, 3 times
    mesh = make_production_mesh(shape=(2, 2), device_type="cpu")
    low = steps.build_train(cfg, ShapeConfig("t", SEQ, 4, "train"), mesh, opts, zero1=True)
    opt = adamw(3e-4, weight_decay=0.1)
    state = td.init_llm_state(torch.Generator().manual_seed(3), cfg, 2, opt, device="cpu")
    local = shard_tree(state, low.in_placements[0], mesh)
    assert [str(x.dtype) for x in tree_leaves(local["server"])] == \
        [str(x.dtype) for x in tree_leaves(state["server"])]
    base_step = td.make_guarded_llm_step(
        cfg, steps.production_opts(cfg, mesh, kind="train", base=opts), opt, 2)
    base, losses, base_losses = state, [], []
    rng = np.random.default_rng(1)
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, 96, (2, 2, SEQ), dtype=np.int32))
        batch = {"tokens": toks, "labels": toks}
        noise = torch.from_numpy(rng.standard_normal((2, 2, SEQ, 32)).astype(np.float32))
        local, m = low.fn(local, shard_tree(batch, low.in_placements[1], mesh),
                          shard_tree({"n": noise}, {"n": low.in_placements[2]}, mesh)["n"])
        base, bm = base_step(base, batch, noise)
        losses.append(float(m["loss"]))
        base_losses.append(float(bm["loss"]))
    mine = {part: [local_shard(x, sp, mesh) for x, sp in zip(
        tree_leaves(base[part]), spec_leaves(low.in_placements[0][part]))]
        for part in ("client_banks", "server")}
    mine["opt"] = {k: [local_shard(x, sp, mesh) for x, sp in zip(
        tree_leaves(base["opt"][k]), spec_leaves(low.in_placements[0]["opt"][k]))]
        for k in base["opt"]}
    per_rank = gathered(compare(local, mine, 3e-4))
    result["production_2x2_zero1"] = {
        "losses": losses, "base_losses": base_losses,
        "buffer_dtypes": gathered(sorted({str(x.dtype).removeprefix("torch.")
                                          for x in tree_leaves(local["server"])})),
        "weights": {"within": all(r["weights"]["within"] for r in per_rank),
                    "part": max(r["weights"]["part"] for r in per_rank),
                    "past_an_ulp": max(r["weights"]["past_an_ulp"] for r in per_rank),
                    "max_over_lr": max(r["weights"]["max_over_lr"] for r in per_rank)},
        "moments_rel_l2": [max(v) for v in zip(*(r["moments_rel_l2"] for r in per_rank))]}
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_job(int(sys.argv[1]), sys.argv[2])
