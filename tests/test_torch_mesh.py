"""``mesh=`` in the port: the builders (``launch.mesh``), the (1, 1) grid
against no mesh bit for bit, and real multi-rank grids on the CPU.

The port's unsharded trajectory is the baseline here: ``test_torch_trainer``
and ``test_torch_protocol`` hold it against the JAX engines. Tolerances are
the reference's (``tests/test_mesh_2d.py``): the (1, 1) grid equals no mesh
bit for bit, losses and every state leaf; the 4-rank grids follow the
unsharded losses within rtol 1e-5, and 5e-2 for ``fused-scan`` on a mixed
grid (the row-parallel all-reduce reassociates float32 sums, and AdamW
amplifies it).

Multi-rank runs: this file doubles as the rank program (``python
tests/test_torch_mesh.py <job> <rank> <world> <dir>``). ``_spawn`` starts
four ranks, each a gloo process group over a ``FileStore`` under the test's
``tmp_path`` on the loopback interface, one spawn a job running every grid
shape, and joins them within ``SPAWN_LIMIT_S``: on expiry it kills the
ranks and fails the test, so a hung collective never hangs the suite. The
rank program imports neither ``jax`` nor ``repro``.
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
from repro_torch.configs import CHOLESTEROL_MLP, COVID_CNN
from repro_torch.configs.base import ModelConfig
from repro_torch.core import SplitSession, SplitTrainConfig
from repro_torch.core.adapters import cnn_adapter, mlp_adapter
from repro_torch.core.distributed import llm_adapter
from repro_torch.data import make_cholesterol, make_covid_ct, split_clients
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import (
    ShapeMesh,
    make_client_mesh,
    make_production_mesh,
    make_split_mesh,
)
from repro_torch.models.transformer import ModelOptions
from repro_torch.optim import adamw
from repro_torch.privacy import DPConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_LIMIT_S = 150
ENGINES = ("fused-scan", "fused-queue", "protocol-async")
SHAPES = ((4, 1), (2, 2), (1, 4))
DP = DPConfig(clip_norm=1.0, noise_scale=0.5)
TINY = ModelConfig(name="llm-tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
                   n_kv_heads=1, d_ff=64, vocab_size=97, dtype="float32", cut_layers=1,
                   privacy_noise=0.02)
SEQ = 8
PRODUCTION = {"-": {}, "per-item": {"production": "per-item"}}
# a narrow COVID-CT CNN: a two-conv stage (its odd conv keeps a whole bias
# under a sharded weight) and channel counts the model axis divides
NARROW = dataclasses.replace(COVID_CNN, input_hw=(16, 16), stages=((4, 1), (8, 2), (8, 1)),
                             dense_units=(8,), use_kernel=True)


def cpu_grid(c, m):
    return make_split_mesh(c, m, device_type="cpu")


# ----------------------------------------------------------------- data
def chol(n_clients):
    x, y = make_cholesterol(100 * n_clients, seed=0)
    shares = (0.7, 0.2, 0.1) if n_clients == 3 else (1.0 / n_clients,) * n_clients
    return split_clients(x, y, shares=shares)


def covid(n_clients):
    x, y = make_covid_ct(12 * n_clients, hw=16, seed=0)
    return split_clients(x, y, shares=(1.0 / n_clients,) * n_clients)


def tokens(n_clients):
    rng = np.random.default_rng(0)
    out = []
    for c in range(n_clients):
        w = rng.integers(0, TINY.vocab_size, (6 + c, SEQ)).astype(np.int32)
        out.append((w, w))
    return out


def config(n_clients, privacy, mode="detached", batch=None):
    shares = (0.7, 0.2, 0.1) if n_clients == 3 else (1.0,) * n_clients
    return SplitTrainConfig(n_clients=n_clients, data_shares=shares,
                            server_batch=batch or 8 * n_clients, privacy=privacy, mode=mode)


def adapter_of(model):
    if model == "mlp":
        return mlp_adapter(CHOLESTEROL_MLP)
    if model == "cnn":
        return cnn_adapter(NARROW)
    return llm_adapter(TINY, ModelOptions(q_block=SEQ, kv_block=SEQ))


def shards_of(model, n_clients):
    return {"mlp": chol, "cnn": covid, "llm": tokens}[model](n_clients)


def fit(model, engine, mesh, privacy, *, n_clients=3, mode="detached", epochs=2, steps=3,
        session=None, **opts):
    s = session or SplitSession(adapter_of(model), config(n_clients, privacy, mode),
                                adamw(1e-2), engine=engine, seed=0, mesh=mesh, device="cpu",
                                **opts)
    hist = s.fit(shards_of(model, n_clients), epochs=epochs, steps_per_epoch=steps)
    return s, [h["loss"] for h in hist]


def state_vector(state) -> np.ndarray:
    """Every leaf of a canonical state, in ``tree_leaves`` order, as one
    float64 vector (float32 values and the int step convert exactly)."""
    return np.concatenate([torch.as_tensor(a).detach().double().reshape(-1).numpy()
                           for a in tree_leaves(state)])


def assert_states_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


# ------------------------------------------------------------- builders
def test_builders_validate_with_the_reference_messages():
    with pytest.raises(ValueError, match="axis sizes must be >= 1"):
        make_split_mesh(0, 1, device_type="cpu")
    world = mesh_mod._world()
    with pytest.raises(ValueError, match="needs"):
        make_split_mesh(world + 1, 1, device_type="cpu")
    with pytest.raises(ValueError, match=rf"outside \[1, {world}\]"):
        make_client_mesh(world + 1, device_type="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        mesh_mod._check_divides(6, 4, "clients")
    mesh = make_split_mesh(1, 1, n_clients=7, device_type="cpu")  # 1 divides anything
    assert mesh.mesh_dim_names == ("clients", "model") and tuple(mesh.shape) == (1, 1)
    assert mesh_mod.mesh_shape(mesh) == {"clients": 1, "model": 1}
    assert mesh_mod.mesh_shape(make_client_mesh(device_type="cpu")) == {"clients": 1}
    assert make_split_mesh(1, 1, device_type="cpu") is mesh  # cached
    with pytest.raises(ValueError, match="device_type"):
        make_client_mesh(1, device_type="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a card"):
            make_split_mesh(1, 1)  # device_type defaults to "cuda"


def test_shape_only_meshes_need_no_process_group():
    for multi_pod, shape, names in ((False, (16, 16), ("data", "model")),
                                    (True, (2, 16, 16), ("pod", "data", "model"))):
        m = make_production_mesh(multi_pod=multi_pod, shape_only=True)
        assert isinstance(m, ShapeMesh) and m.axis_names == names
        assert tuple(m.shape.values()) == shape and m.size == int(np.prod(shape))
        assert mesh_mod.data_axis_size(m) == int(np.prod(shape[:-1]))
    wide = make_production_mesh(shape=(64, 4), shape_only=True)
    assert wide.shape == {"data": 64, "model": 4}


def test_engines_refuse_what_does_not_run_on_a_mesh():
    mesh = cpu_grid(1, 1)
    mk = lambda engine, **kw: SplitSession(  # noqa: E731
        mlp_adapter(CHOLESTEROL_MLP), config(3, None), adamw(1e-2), engine=engine,
        device="cpu", **kw)
    with pytest.raises(ValueError, match="looped-ref does not support mesh="):
        mk("looped-ref", mesh=mesh)
    with pytest.raises(ValueError, match="fedavg does not support mesh="):
        mk("fedavg", mesh=mesh)
    # the threaded drive runs on a mesh, its arrival order decided on the
    # leader rank (tests/test_torch_threaded_mesh.py)
    assert mk("protocol-async", mesh=mesh, threaded=True).engine.threaded
    with pytest.raises(ValueError, match="mesh"):
        mk("auto", mesh=object())
    with pytest.raises(ValueError, match="shape-only"):
        mk("auto", mesh=ShapeMesh((1, 1), ("clients", "model")))
    with pytest.raises(ValueError, match="no 'clients' axis"):
        mk("auto", mesh=make_host_mesh_cpu())
    from repro_torch.core.trainer import check_mesh

    with pytest.raises(ValueError, match="lives on 'cpu'"):
        check_mesh(mesh, "cuda")
    # a prebuilt engine takes no mesh= from the session
    from repro_torch.core.session import FusedEngine

    eng = FusedEngine(mlp_adapter(CHOLESTEROL_MLP), config(3, None), adamw(1e-2), device="cpu")
    with pytest.raises(ValueError, match="registry"):
        SplitSession(mlp_adapter(CHOLESTEROL_MLP), config(3, None), adamw(1e-2), engine=eng,
                     mesh=mesh, device="cpu")


def make_host_mesh_cpu():
    return mesh_mod.make_host_mesh(1, device_type="cpu")


def test_llm_split_model_axis_above_one_takes_the_sharded_state():
    """A model axis above 1 shards the state (``core.distributed``; the
    4-rank ``llm`` job runs it); a shape-only mesh still has no ranks."""
    from repro_torch.core.distributed import is_sharded, llm_step_parts

    grid = ShapeMesh((1, 2), ("clients", "model"))
    assert is_sharded(grid) and not is_sharded(ShapeMesh((4, 1), ("clients", "model")))
    with pytest.raises(ValueError, match="shape-only"):
        llm_step_parts(TINY, ModelOptions(q_block=SEQ, kv_block=SEQ), adamw(1e-3), 3, mesh=grid)


# ------------------------------------------------------ (1, 1) bit-exact
@pytest.mark.parametrize("engine", ENGINES + ("llm-split",))
@pytest.mark.parametrize("privacy", [None, DP], ids=["sigma0", "sigma0.5"])
def test_1x1_grid_is_bit_exact(engine, privacy):
    """(1, 1) and no mesh: the same losses and every canonical state leaf
    equal, at sigma 0 and under the guard (the reference's
    ``test_1x1_grid_is_bit_exact`` and ``test_mesh_1x1_is_bit_exact_noop``)."""
    model = "llm" if engine == "llm-split" else "mlp"
    s0, l0 = fit(model, engine, None, privacy)
    s1, l1 = fit(model, engine, cpu_grid(1, 1), privacy)
    assert l0 == l1
    assert_states_equal(s0.state, s1.state)


@pytest.mark.parametrize("mode", ["detached", "e2e"])
def test_1x1_grid_is_bit_exact_on_the_cnn_with_a_client_mesh(mode):
    """The narrow CNN through its kernel wrappers, e2e included, on the 1-D
    client mesh and the (1, 1) grid; then serving the trace gives the same
    answers (``SplitSession.serve`` passes the mesh on)."""
    from repro_torch.serving import poisson_trace

    runs = {}
    for name, mesh in (("none", None), ("client", make_client_mesh(1, device_type="cpu")),
                       ("grid", cpu_grid(1, 1))):
        s, losses = fit("cnn", "auto", mesh, DP, mode=mode)
        trace = poisson_trace(3, rate=2.0, horizon=6, seed=0)
        rep = s.serve(trace, shards_of("cnn", 3), max_batch=4, request_batch=2)
        runs[name] = (s, losses, rep)
    s0, l0, r0 = runs["none"]
    for name in ("client", "grid"):
        s1, l1, r1 = runs[name]
        assert l1 == l0, name
        assert_states_equal(s1.state, s0.state)
        assert r1.fingerprint() == r0.fingerprint(), name


def test_1x1_grid_restores_across_mesh_and_no_mesh(tmp_path):
    """A checkpoint saved under the grid, restored without a mesh (and the
    reverse), continues bit for bit."""
    s_mesh, _ = fit("mlp", "fused-scan", cpu_grid(1, 1), DP)
    path = s_mesh.save(str(tmp_path / "grid"))
    fit("mlp", "fused-scan", None, DP, session=s_mesh, epochs=1)
    plain = SplitSession(adapter_of("mlp"), config(3, DP), adamw(1e-2), engine="fused-scan",
                         seed=0, device="cpu")
    plain.restore(path)
    _, got = fit("mlp", "fused-scan", None, DP, session=plain, epochs=1)
    assert got == [h["loss"] for h in s_mesh.history[-1:]]
    assert_states_equal(plain.state, s_mesh.state)
    back = SplitSession(adapter_of("mlp"), config(3, DP), adamw(1e-2), engine="fused-scan",
                        seed=0, device="cpu", mesh=cpu_grid(1, 1))
    back.restore(plain.save(str(tmp_path / "plain")))
    assert_states_equal(back.state, plain.state)


# --------------------------------------------------- multi-rank (gloo)
def _spawn(tmp_path, job: str, world: int = 4) -> dict:
    """Run ``job`` on ``world`` ranks; rank 0's JSON result. Fails the test
    (after killing every rank) past ``SPAWN_LIMIT_S`` or on a rank's error."""
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


def _rtol(engine, shape):
    if engine == "fused-scan" and 1 not in shape:
        return 5e-2  # mixed grid: amplified float32 reassociation
    return 1e-5


@pytest.mark.parametrize("engine", ENGINES)
def test_4_rank_grids_follow_the_unsharded_trajectory(tmp_path, engine):
    """(4, 1), (2, 2) and (1, 4) on four gloo ranks against the port's
    unsharded run: the cholesterol MLP with 8 clients at sigma 0.5 (and
    fused-scan at sigma 0 and in e2e, the queue engines with per-item
    production, each release broadcast from its owner), and the narrow CNN
    at sigma 0.5. Every rank ends with the same state, and on (4, 1),
    where only the client axis splits the work, it is bit for bit the
    unsharded run's, taken in a rank process (one thread, as the ranks:
    the CPU's conv sums in another order with another thread count)."""
    got = _spawn(tmp_path, f"engine:{engine}")
    for n, (key, losses) in enumerate(got.items()):
        model, shape, sigma, mode, production = key.split("|")
        privacy = DP if sigma == "0.5" else None
        shape = tuple(int(v) for v in shape.split("x"))
        _, base = fit(model, engine, None, privacy, n_clients=8 if model == "mlp" else 4,
                      mode=mode, **PRODUCTION[production])
        np.testing.assert_allclose(losses, base, rtol=_rtol(engine, shape),
                                   err_msg=f"{engine} {key}")
        ranks = [np.load(tmp_path / f"state{n}_r{r}.npy") for r in range(4)]
        for r in range(1, 4):
            assert np.array_equal(ranks[r], ranks[0]), f"{engine} {key}: rank {r} parted"
        if shape[1] == 1:
            case = "|".join((model, sigma, mode, production))
            assert np.array_equal(ranks[0], np.load(tmp_path / f"base_{case}.npy")), \
                f"{engine} {key}"
    assert len(got) == len(SHAPES) * (4 if engine == "fused-scan" else 3)


def test_4_rank_checkpoint_moves_across_grids(tmp_path):
    """Saved on (2, 2), restored value for value on (4, 1) and on no mesh;
    the three continued runs agree within 5e-2. The saved state served on
    (2, 2), the trunk tensor-parallel, answers as without a mesh (rtol
    1e-5: the row-parallel sums reassociate)."""
    got = _spawn(tmp_path, "checkpoint")
    serve = got["serve"]
    assert serve["stats_equal"] and serve["answered"] > 0
    np.testing.assert_allclose(serve["responses"][0], serve["responses"][1], rtol=1e-5,
                               atol=1e-5)
    assert got["restored_equal"] == {"4x1": True, "none": True}
    cont = {k: np.asarray(v) for k, v in got["continued"].items()}
    for name in ("4x1", "none"):
        np.testing.assert_allclose(cont[name], cont["2x2"], rtol=5e-2)


def test_4_rank_llm_split_and_refusals(tmp_path):
    """llm-split (reduced) on (4, 1), and on (2, 2) with the model axis
    sharding the state, against no mesh at rtol 1e-5, in both modes;
    ``n_clients`` that does not divide the client axis raises at the
    builder."""
    got = _spawn(tmp_path, "llm")
    for mode in ("detached", "e2e"):
        np.testing.assert_allclose(got[mode]["mesh"], got[mode]["none"], rtol=1e-5)
        np.testing.assert_allclose(got[mode]["model_axis"], got[mode]["none"], rtol=1e-5)
    assert "does not divide" in got["divide_error"]


# ------------------------------------------------------- the rank program
def _rank_main(job: str, rank: int, world: int, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    result = {}
    if job.startswith("engine:"):
        engine = job.split(":", 1)[1]
        cases = [("mlp", DP, "detached", "-"), ("cnn", DP, "detached", "-")]
        cases.append(("mlp", None, "detached", "-") if engine == "fused-scan"
                     else ("mlp", DP, "detached", "per-item"))
        if engine == "fused-scan":
            cases.append(("mlp", DP, "e2e", "-"))
        for model, privacy, mode, production in cases:
            sigma = "0.5" if privacy is not None else "0"
            if rank == 0:  # the unsharded run under the ranks' thread count
                s, _ = fit(model, engine, None, privacy, n_clients=8 if model == "mlp" else 4,
                           mode=mode, **PRODUCTION[production])
                np.save(os.path.join(out_dir, f"base_{model}|{sigma}|{mode}|{production}.npy"),
                        state_vector(s.state))
            for shape in SHAPES:
                s, losses = fit(model, engine, cpu_grid(*shape), privacy,
                                n_clients=8 if model == "mlp" else 4, mode=mode,
                                **PRODUCTION[production])
                np.save(os.path.join(out_dir, f"state{len(result)}_r{rank}.npy"),
                        state_vector(s.state))
                result[f"{model}|{shape[0]}x{shape[1]}|{sigma}|{mode}|{production}"] = losses
    elif job == "checkpoint":
        from repro_torch.serving import poisson_trace

        s, _ = fit("mlp", "fused-scan", cpu_grid(2, 2), DP, n_clients=8)
        path = s.save(os.path.join(out_dir, "ckpt"))
        saved = [t.clone() for t in tree_leaves(s.state)]
        # the saved state served with the trunk tensor-parallel, and without
        plain = SplitSession(adapter_of("mlp"), config(8, DP), adamw(1e-2), engine="fused-scan",
                             seed=0, device="cpu")
        plain.restore(path)
        trace = poisson_trace(8, rate=2.0, horizon=6, seed=0)
        reps = [sess.serve(trace, shards_of("mlp", 8), max_batch=4, request_batch=2)
                for sess in (s, plain)]
        result["serve"] = {
            "stats_equal": reps[0].deterministic_stats() == reps[1].deterministic_stats(),
            "answered": reps[0].answered,
            "responses": [[reps[i].responses[k].tolist() for k in sorted(reps[0].responses)]
                          for i in (0, 1)]}
        _, cont = fit("mlp", "fused-scan", None, DP, n_clients=8, session=s, epochs=1)
        result["continued"] = {"2x2": cont}
        result["restored_equal"] = {}
        for name, mesh in (("4x1", cpu_grid(4, 1)), ("none", None)):
            r = SplitSession(adapter_of("mlp"), config(8, DP), adamw(1e-2), engine="fused-scan",
                             seed=0, mesh=mesh, device="cpu")
            r.restore(path)
            result["restored_equal"][name] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(r.state), saved))
            _, result["continued"][name] = fit("mlp", "fused-scan", None, DP, n_clients=8,
                                               session=r, epochs=1)
    elif job == "llm":
        for mode in ("detached", "e2e"):
            result[mode] = {
                name: fit("llm", "llm-split", mesh, DP, n_clients=4, mode=mode)[1]
                for name, mesh in (("none", None), ("mesh", cpu_grid(4, 1)),
                                   ("model_axis", cpu_grid(2, 2)))}
        try:
            make_split_mesh(4, 1, n_clients=6, device_type="cpu")
        except ValueError as e:
            result["divide_error"] = str(e)
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
