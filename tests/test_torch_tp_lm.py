"""``llm-split`` over a model axis above 1 and on the production grids:
the transformer trunk's tensor parallelism (``sharding.tensor_parallel``,
the blocks' ``tp`` paths), the sharded state, the MoE's data-axis dispatch
and ``launch.steps``' steps on real ranks.

Four gloo ranks on the CPU, as ``tests/test_torch_mesh.py``: this file
doubles as the rank program (``python tests/test_torch_tp_lm.py <job>
<rank> <world> <dir>``), ``_spawn`` joins the ranks within
``SPAWN_LIMIT_S`` and kills them past it. The port's unsharded run is the
baseline (its own tests hold it against the JAX package). Tolerances:
losses within rtol 1e-5 (the row-parallel sums and the vocab-parallel
cross entropy add float32 in another order); after three AdamW steps every
state leaf within atol 1e-4, the AdamW amplification of that
reassociation, as the mesh tests' (the (4, 1) grid, where no model axis
splits the work, bit for bit); on the first step, before any update, every
rank's held blocks equal the unsharded state's slices exactly, and the
bytes it holds equal its placement's share exactly.

The families: a dense GQA config whose kv columns split a head at model 4
and whose query columns split one too; a MoE of two experts
(expert-parallel at model 2, tensor-parallel within each expert at model
4); falcon-mamba-style SSM; a jamba-style hybrid (attention, mamba, MoE
and SwiGLU layers in one group).
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.common.tree import tree_leaves
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import SplitSession, SplitTrainConfig
from repro_torch.core import distributed as dist_mod
from repro_torch.core.distributed import llm_adapter
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh, make_split_mesh
from repro_torch.models.transformer import ModelOptions
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig
from repro_torch.sharding.specs import spec_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_LIMIT_S = 150
SEQ = 8
N_CLIENTS = 4
SHAPES = ((4, 1), (2, 2), (1, 4))
DP = DPConfig(clip_norm=1.0, noise_scale=0.5)
LOSS_RTOL = 1e-5
STATE_ATOL = 1e-4
CFGS = {
    "dense": ModelConfig(name="tp-dense", family="dense", n_layers=3, d_model=32, n_heads=2,
                         n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=96, dtype="float32",
                         cut_layers=1, privacy_noise=0.02),
    "moe": ModelConfig(name="tp-moe", family="moe", n_layers=2, d_model=32, n_heads=4,
                       n_kv_heads=2, head_dim=8, d_ff=32, vocab_size=96, n_experts=2,
                       experts_per_token=1, dtype="float32", cut_layers=1),
    "ssm": ModelConfig(name="tp-ssm", family="ssm", n_layers=2, d_model=32, n_heads=0,
                       n_kv_heads=0, head_dim=0, d_ff=0, vocab_size=96, ssm_state=4, dt_rank=4,
                       dtype="float32", cut_layers=1),
    "hybrid": ModelConfig(name="tp-hybrid", family="hybrid", n_layers=4, d_model=32, n_heads=4,
                          n_kv_heads=2, head_dim=8, d_ff=32, vocab_size=96, n_experts=4,
                          experts_per_token=2, moe_period=2, ssm_state=4, dt_rank=4,
                          attn_period=2, attn_offset=1, dtype="float32", cut_layers=1),
}


def shards(n=N_CLIENTS):
    rng = np.random.default_rng(0)
    return [(w, w) for w in (rng.integers(0, 96, (12, SEQ), dtype=np.int32) for _ in range(n))]


def session(fam, mesh, mode="detached"):
    return SplitSession(llm_adapter(CFGS[fam], ModelOptions(q_block=SEQ, kv_block=SEQ)),
                        SplitTrainConfig(n_clients=N_CLIENTS, data_shares=(1.0,) * N_CLIENTS,
                                         server_batch=2 * N_CLIENTS, privacy=DP, mode=mode),
                        adamw(1e-2), engine="llm-split", mesh=mesh, seed=0, device="cpu")


def vector(state) -> np.ndarray:
    return np.concatenate([torch.as_tensor(a).detach().double().reshape(-1).numpy()
                           for a in tree_leaves(state)])


# ------------------------------------------------------- in one process
def test_sharded_layout_is_chosen_by_the_mesh():
    """A model axis above 1 or a production grid shards the state; a split
    grid with a model axis of 1 keeps it whole, as before; a shape-only
    mesh has no ranks to run on."""
    assert dist_mod.is_sharded(ShapeMesh((1, 2), ("clients", "model")))
    assert dist_mod.is_sharded(ShapeMesh((2, 1), ("data", "model")))
    assert not dist_mod.is_sharded(ShapeMesh((4, 1), ("clients", "model")))
    assert not dist_mod.is_sharded(None)
    with pytest.raises(ValueError, match="shape-only"):
        dist_mod.llm_step_parts(CFGS["dense"], ModelOptions(q_block=SEQ, kv_block=SEQ),
                                adamw(1e-3), N_CLIENTS,
                                mesh=ShapeMesh((1, 2), ("clients", "model")))


def test_state_specs_follow_the_placement_rules():
    """The split grid places the trunk by ``trunk_specs`` and the banks over
    ``clients``; the production grid as ``launch.steps`` (``tree_specs``)."""
    from repro_torch.sharding.specs import client_bank_specs, tree_specs, trunk_specs

    opt = adamw(1e-3)
    tmpl = dist_mod.llm_state_template(CFGS["ssm"], N_CLIENTS, opt)
    split = ShapeMesh((2, 2), ("clients", "model"))
    sp = dist_mod.llm_state_specs(tmpl, split)
    assert spec_leaves(sp["server"]) == spec_leaves(trunk_specs(tmpl["server"], split))
    assert spec_leaves(sp["client_banks"]) == spec_leaves(
        client_bank_specs(tmpl["client_banks"], split))
    assert spec_leaves(sp["opt"]["mu"]) == spec_leaves(sp["server"])
    prod = ShapeMesh((2, 2), ("data", "model"))
    pp = dist_mod.llm_state_specs(tmpl, prod)
    assert spec_leaves(pp["server"]) == spec_leaves(tree_specs(tmpl["server"], prod))
    # the production trunk shards every d_inner leaf of the SSM; the split one only in_proj
    names = [s for s in spec_leaves(pp["server"]) if "model" in s]
    assert len(names) > len([s for s in spec_leaves(sp["server"]) if "model" in s])
    with pytest.raises(ValueError, match="detached"):
        dist_mod.llm_state_specs(dist_mod.llm_state_template(CFGS["ssm"], N_CLIENTS, opt,
                                                             mode="e2e"), prod, mode="e2e")
    with pytest.raises(ValueError, match="zero1"):
        dist_mod.llm_state_specs(tmpl, split, zero1=True)


# --------------------------------------------------- multi-rank (gloo)
def _spawn(tmp_path, job: str, world: int = 4) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "GLOO_SOCKET_IFNAME": "lo",
           "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    procs, logs = [], []
    for r in range(world):
        log = open(tmp_path / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, str(r), str(world), str(tmp_path)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{job}: the ranks did not finish within {SPAWN_LIMIT_S} s")
    finally:
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            pytest.fail(f"{job}: rank {r} exited {p.returncode}:\n"
                        + (tmp_path / f"rank{r}.log").read_text()[-4000:])
    return json.loads((tmp_path / "result.json").read_text())


@pytest.mark.parametrize("fam", sorted(CFGS))
def test_4_rank_model_axis_follows_the_unsharded_run(tmp_path, fam):
    """(4, 1), (2, 2) and (1, 4) against no mesh: losses, every state leaf
    after 3 steps, the held blocks and their bytes (module docstring)."""
    got = _spawn(tmp_path, f"split:{fam}")
    base = np.load(tmp_path / "base.npy")
    for shape in SHAPES:
        key = f"{shape[0]}x{shape[1]}"
        r = got[key]
        np.testing.assert_allclose(r["losses"], got["base_losses"], rtol=LOSS_RTOL,
                                   err_msg=f"{fam} {key}")
        assert r["held_blocks_equal"] == [True] * 4, key
        assert r["held_bytes"] == r["placed_bytes"], key
        state = np.load(tmp_path / f"state_{key}.npy")
        if shape[1] == 1:
            assert np.array_equal(state, base), key
        else:
            np.testing.assert_allclose(state, base, rtol=0, atol=STATE_ATOL,
                                       err_msg=f"{fam} {key}")
            assert max(r["held_bytes"]) < r["whole_bytes"], key  # a rank holds a share


def test_4_rank_production_grid_steps(tmp_path):
    """``launch.steps`` on a real ("data", "model") (2, 2) grid: the train
    step for the MoE (each data rank routes its own tokens: the no-mesh
    ``moe_chunks=2`` step), the SSM (its channels sharded), the dense GQA
    config, against the unsharded step; prefill logits; decode at B = 4
    (batch over data) and B = 1 (the 2-D weight placement and the cache's
    positions over data), and on a (2, 2, 1) grid with a pod axis;
    ``zero1`` (the moments of the 2^20-element head split over data as
    well) updates the weights and the moments bit for bit as without it."""
    got = _spawn(tmp_path, "production")
    for fam in ("moe", "ssm", "dense"):
        r = got["train"][fam]
        np.testing.assert_allclose(r["loss"], r["base_loss"], rtol=LOSS_RTOL, err_msg=fam)
        assert r["max_state_err"] < STATE_ATOL, (fam, r["max_state_err"])
        assert r["grad_norm_rel"] < 1e-5, fam
    for fam, r in got["prefill"].items():
        assert r["max_err"] < 1e-5, (fam, r)
    for key, r in got["decode"].items():
        assert r["max_err"] < 1e-5, (key, r)
        assert r["weights_2d"] == key.endswith("b1"), key
    assert "detached" in got["e2e_error"]
    assert "multiple" in got["chunks_error"]
    assert got["zero1"] == {"split_leaves": 2, "params_equal": True, "moments_equal": True}


def test_4_rank_checkpoints_cross_grids(tmp_path):
    """Saved on (2, 2), restored value for value without a mesh and on
    (1, 4); saved without a mesh, restored on (2, 2); each restored run
    continues as the saved one does (rtol 1e-5)."""
    got = _spawn(tmp_path, "checkpoint")
    assert got["restored_equal"] == {"none": True, "1x4": True, "2x2_from_none": True}
    for name in ("none", "1x4"):
        np.testing.assert_allclose(got["continued"][name], got["continued"]["2x2"],
                                   rtol=LOSS_RTOL)


# ------------------------------------------------------- the rank program
def held_bytes(tree) -> int:
    """Bytes of the tensors a rank holds in ``tree``."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree) if x is not None)


def _split_job(fam, rank, out_dir, result):
    from repro_torch.sharding.tensor_parallel import local_shard

    base = session(fam, None)
    init = base.state
    base.fit(shards(), epochs=1, steps_per_epoch=3)
    result["base_losses"] = [float(x) for x in base.step_metrics[-1]["loss"]]
    if rank == 0:
        np.save(os.path.join(out_dir, "base.npy"), vector(base.state))
    for shape in SHAPES:
        key = f"{shape[0]}x{shape[1]}"
        s = session(fam, make_split_mesh(*shape, device_type="cpu"))
        eng = s.engine
        native = s.native_state
        whole = int(held_bytes({k: init[k] for k in ("client_banks", "server", "opt")}))
        held = int(held_bytes({k: native[k] for k in ("client_banks", "flat", "opt")}))
        if eng.specs is None:  # a model axis of 1: the state whole on every rank
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(eng._unravel(native["flat"])), tree_leaves(init["server"])))
            placed = whole
        else:
            # the held blocks, before any step, are the unsharded state's slices
            same = True
            for part, held_tree in (("server", eng._unravel(native["flat"])),
                                    ("client_banks", native["client_banks"])):
                same = same and all(torch.equal(a, local_shard(b, sp, eng.mesh)) for a, b, sp in
                                    zip(tree_leaves(held_tree), tree_leaves(init[part]),
                                        spec_leaves(eng.specs[part])))
            placed = sum(_block_bytes(x, sp, eng.mesh) for part in ("client_banks", "server")
                         for x, sp in zip(tree_leaves(init[part]), spec_leaves(eng.specs[part])))
            placed += sum(_block_bytes(x, sp, eng.mesh) for k in init["opt"]
                          for x, sp in zip(tree_leaves(init["opt"][k]),
                                           spec_leaves(eng.specs["opt"][k])))
        gathered = _gather_list([same, held, int(placed)])
        s.fit(shards(), epochs=1, steps_per_epoch=3)
        result[key] = {"losses": [float(x) for x in s.step_metrics[-1]["loss"]],
                       "held_blocks_equal": [g[0] for g in gathered],
                       "held_bytes": [g[1] for g in gathered],
                       "placed_bytes": [g[2] for g in gathered], "whole_bytes": whole}
        state = s.state  # every rank gathers
        if rank == 0:
            np.save(os.path.join(out_dir, f"state_{key}.npy"), vector(state))


def _block_bytes(x, spec, mesh) -> int:
    """Bytes of a rank's block of ``x`` under ``spec`` (axis sizes from the mesh)."""
    from repro_torch.launch.mesh import mesh_shape

    sizes = mesh_shape(mesh)
    return int(np.prod([d // (sizes[a] if a else 1) for d, a in zip(x.shape, spec)])
               * x.element_size())


def _gather_list(obj):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _production_job(rank, result):
    from repro_torch.common.tree import tree_map
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib
    from repro_torch.sharding.tensor_parallel import local_shard, whole_of

    mesh = make_production_mesh(shape=(2, 2), device_type="cpu")
    train = ShapeConfig("t", SEQ, 4, "train")
    result["train"] = {}
    for fam in ("moe", "ssm", "dense"):
        cfg = CFGS[fam]
        low = steps.build_train(cfg, train, mesh, ModelOptions(q_block=SEQ, kv_block=SEQ))
        opt = adamw(3e-4, weight_decay=0.1)
        state = dist_mod.init_llm_state(torch.Generator().manual_seed(3), cfg, 2, opt,
                                        dtype=torch.float32, device="cpu")
        rng = np.random.default_rng(1)
        batch = {"tokens": torch.from_numpy(rng.integers(0, 96, (2, 2, SEQ), dtype=np.int32))}
        batch["labels"] = batch["tokens"]
        noise = torch.from_numpy(rng.standard_normal((2, 2, SEQ, cfg.d_model)).astype(np.float32))
        noise = noise if cfg.privacy_noise > 0 else None
        args = (state, batch, noise)
        local = tuple(None if a is None else _shard(a, sp, mesh)
                      for a, sp in zip(args, low.in_placements))
        new, m = low.fn(*local)
        base_opts = steps.production_opts(cfg, mesh, kind="train",
                                          base=ModelOptions(q_block=SEQ, kv_block=SEQ))
        base_step = dist_mod.make_guarded_llm_step(cfg, base_opts, opt, 2)
        base_new, bm = base_step(state, batch, noise)
        err = max(float((a - local_shard(b, sp, mesh)).abs().max()) for a, b, sp in zip(
            tree_leaves(new), tree_leaves(base_new), spec_leaves(low.out_placements[0]))
            if a.is_floating_point())
        result["train"][fam] = {
            "loss": float(m["loss"]), "base_loss": float(bm["loss"]), "max_state_err": err,
            "grad_norm_rel": abs(float(m["grad_norm"]) / float(bm["grad_norm"]) - 1.0),
            "moe_chunks": base_opts.moe_chunks}
    # zero1: the moments' blocks split over data; the update the same, bit for bit
    cfgz = dataclasses.replace(CFGS["dense"], name="tp-zero1", vocab_size=1 << 15)
    opt = adamw(3e-4, weight_decay=0.1)
    state = dist_mod.init_llm_state(torch.Generator().manual_seed(6), cfgz, 2, opt,
                                    dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 1 << 15, (2, 2, SEQ), dtype=np.int32))}
    batch["labels"] = batch["tokens"]
    noise = torch.from_numpy(rng.standard_normal((2, 2, SEQ, 32)).astype(np.float32))
    outs = {}
    for z in (False, True):
        low = steps.build_train(cfgz, train, mesh, ModelOptions(q_block=SEQ, kv_block=SEQ),
                                zero1=z)
        local = tuple(_shard(a, sp, mesh) for a, sp in zip((state, batch, noise),
                                                           low.in_placements))
        outs[z] = (low.fn(*local)[0], low.in_placements[0])
    (plain, _), (z1, z1_specs) = outs[False], outs[True]
    split = sum(1 for a, b in zip(spec_leaves(outs[False][1]["opt"]), spec_leaves(z1_specs["opt"]))
                if a != b)
    same_params = all(torch.equal(a, b) for a, b in zip(tree_leaves(plain["server"]),
                                                         tree_leaves(z1["server"])))
    same_moments = all(torch.equal(local_shard(a, sp, mesh), b) for a, b, sp in zip(
        tree_leaves(whole_of_tree(plain["opt"], outs[False][1]["opt"], mesh)),
        tree_leaves(z1["opt"]), spec_leaves(z1_specs["opt"])))
    result["zero1"] = {"split_leaves": split, "params_equal": same_params,
                       "moments_equal": same_moments}
    # prefill and decode: the logits gathered over the vocab against no mesh
    result["prefill"], result["decode"] = {}, {}
    for fam in ("moe", "ssm", "dense"):
        cfg = CFGS[fam]
        opts = ModelOptions(q_block=SEQ, kv_block=SEQ)
        params = model_lib.init_model(torch.Generator().manual_seed(4), cfg, device="cpu")
        low = steps.build_prefill(cfg, ShapeConfig("p", SEQ, 4, "prefill"), mesh, opts)
        tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 96, (4, SEQ),
                                                                    dtype=np.int32))
        got = low.fn(_shard(params, low.in_placements[0], mesh),
                     _shard({"tokens": tokens}, low.in_placements[1], mesh))
        got = whole_of(whole_of(got, (None, None, "model"), mesh), ("data", None, None), mesh)
        want = model_lib.prefill(params, cfg, {"tokens": tokens},
                                 steps.production_opts(cfg, mesh, kind="prefill", base=opts))
        result["prefill"][fam] = {"max_err": float((got - want).abs().max())}
        if cfg.is_encoder_only:
            continue
        for B in (4, 1):
            low = steps.build_decode(cfg, ShapeConfig("d", SEQ, B, "decode"), mesh, opts)
            st = model_lib.init_decode_state(cfg, B, SEQ, torch.float32, "cpu")
            st = tree_map(lambda x: x.normal_(generator=torch.Generator().manual_seed(5)), st)
            tok = tokens[:B, :1]
            lp, ls = _shard(params, low.in_placements[0], mesh), _shard(st, low.in_placements[1],
                                                                      mesh)
            logits, new_st = low.fn(lp, ls, _shard(tok, low.in_placements[2], mesh), SEQ - 2)
            logits = whole_of(logits, ("data" if B > 1 else None, None, "model"), mesh)
            want, want_st = model_lib.serve_step(params, cfg, st, tok, SEQ - 2, opts)
            err = float((logits - want).abs().max())
            err = max([err] + [float((a - local_shard(b, sp, mesh)).abs().max()) for a, b, sp in
                               zip(tree_leaves(new_st), tree_leaves(want_st),
                                   spec_leaves(low.out_placements[1]))])
            w2d = any(isinstance(a, tuple) for sp in spec_leaves(low.in_placements[0])
                      for a in sp)
            result["decode"][f"{fam}_b{B}"] = {"max_err": err, "weights_2d": w2d}
    # a pod axis: the tokens shard over ("pod", "data"), the state's rows over "data"
    pods = make_production_mesh(shape=(2, 2, 1), device_type="cpu")
    cfg, opts = CFGS["dense"], ModelOptions(q_block=SEQ, kv_block=SEQ)
    params = model_lib.init_model(torch.Generator().manual_seed(4), cfg, device="cpu")
    low = steps.build_decode(cfg, ShapeConfig("d", SEQ, 4, "decode"), pods, opts)
    st = model_lib.init_decode_state(cfg, 4, SEQ, torch.float32, "cpu")
    st = tree_map(lambda x: x.normal_(generator=torch.Generator().manual_seed(5)), st)
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, 96, (4, 1), dtype=np.int32))
    logits, _ = low.fn(_shard(params, low.in_placements[0], pods),
                       _shard(st, low.in_placements[1], pods),
                       _shard(tok, low.in_placements[2], pods), SEQ - 2)
    want, _ = model_lib.serve_step(params, cfg, st, tok, SEQ - 2, opts)
    result["decode"]["dense_pods"] = {
        "max_err": float((whole_of(logits, ("data", None, None), pods) - want).abs().max()),
        "weights_2d": False}
    # the MoE's prefill there: each of the 4 data ranks routes its own tokens
    cfg = CFGS["moe"]
    params = model_lib.init_model(torch.Generator().manual_seed(4), cfg, device="cpu")
    low = steps.build_prefill(cfg, ShapeConfig("p", SEQ, 4, "prefill"), pods, opts)
    got = low.fn(_shard(params, low.in_placements[0], pods),
                 _shard({"tokens": tokens}, low.in_placements[1], pods))
    got = whole_of(got, (("pod", "data"), None, None), pods)
    want = model_lib.prefill(params, cfg, {"tokens": tokens},
                             steps.production_opts(cfg, pods, kind="prefill", base=opts))
    result["prefill"]["moe_pods"] = {"max_err": float((got - want).abs().max())}
    try:
        dist_mod.llm_step_parts(CFGS["dense"], ModelOptions(), adamw(1e-3), 2, mesh=mesh,
                                mode="e2e")
    except ValueError as e:
        result["e2e_error"] = str(e)
    try:
        dist_mod.llm_step_parts(CFGS["moe"], ModelOptions(moe_chunks=1), adamw(1e-3), 2,
                                mesh=mesh)
    except ValueError as e:
        result["chunks_error"] = str(e)


def whole_of_tree(tree, specs, mesh):
    from repro_torch.sharding.tensor_parallel import whole_tree

    return whole_tree(tree, specs, mesh)


def _shard(tree, specs, mesh):
    from repro_torch.sharding.tensor_parallel import shard_tree

    if isinstance(tree, torch.Tensor):
        return shard_tree({"x": tree}, {"x": specs}, mesh)["x"]
    return shard_tree(tree, specs, mesh)


def _checkpoint_job(rank, out_dir, result):
    s = session("dense", make_split_mesh(2, 2, device_type="cpu"))
    s.fit(shards(), epochs=1, steps_per_epoch=2)
    path = s.save(os.path.join(out_dir, "ckpt"))
    saved = [t.clone() for t in tree_leaves(s.state)]
    s.fit(shards(), epochs=1, steps_per_epoch=2)
    result["continued"] = {"2x2": [float(x) for x in s.step_metrics[-1]["loss"]]}
    result["restored_equal"] = {}
    for name, mesh in (("none", None), ("1x4", make_split_mesh(1, 4, device_type="cpu"))):
        r = session("dense", mesh)
        r.restore(path)
        result["restored_equal"][name] = all(torch.equal(a, b)
                                             for a, b in zip(tree_leaves(r.state), saved))
        r.fit(shards(), epochs=1, steps_per_epoch=2)
        result["continued"][name] = [float(x) for x in r.step_metrics[-1]["loss"]]
    import torch.distributed as dist

    plain = session("dense", None)
    plain.fit(shards(), epochs=1, steps_per_epoch=2)
    path = os.path.join(out_dir, "plain", "ckpt_00000002.npz")
    if rank == 0:  # without a mesh every rank has the file to write: one does
        plain.save(os.path.dirname(path))
    dist.barrier()
    back = session("dense", make_split_mesh(2, 2, device_type="cpu"))
    back.restore(path)
    result["restored_equal"]["2x2_from_none"] = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(back.state), tree_leaves(plain.state)))


def _rank_main(job: str, rank: int, world: int, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    result = {}
    if job.startswith("split:"):
        _split_job(job.split(":", 1)[1], rank, out_dir, result)
    elif job == "production":
        _production_job(rank, result)
    elif job == "checkpoint":
        _checkpoint_job(rank, out_dir, result)
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
