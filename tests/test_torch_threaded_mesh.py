"""``threaded=True`` with ``mesh=`` on the queue engines, and an adapter
without a tensor-parallel trunk on a model axis above 1.

The threaded drive under a mesh has one arrival order, decided on the
leader rank (``protocol.LeaderRelay``), which every rank follows. Arrival
order is the OS's, so the anchor is a replay: the leader's recorded pops,
``(client_id, release)``, stepped in one process through a no-mesh
``SplitClient`` (item by item) and ``SplitServer``. ``test_torch_protocol``
and ``test_torch_fused_queue`` hold those two against the JAX engines.
The replay gives the mesh run's trunk and moments bit for bit on (4, 1),
where only the client axis splits the work; on (2, 2) and (1, 4) the trunk
steps tensor-parallel and the row-parallel sums reassociate float32, so
the losses are held at ``test_torch_mesh``'s rtol 1e-5 and the state at
``STATE_TOL``.

Multi-rank runs: this file doubles as the rank program (``python
tests/test_torch_threaded_mesh.py <job> <rank> <world> <dir>``), as
``test_torch_mesh.py``: four gloo ranks over a ``FileStore`` in the test's
``tmp_path``, joined within ``SPAWN_LIMIT_S``, killed and failed past it.
The rank program imports neither ``jax`` nor ``repro``.
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.common.tree import tree_leaves
from repro_torch.configs import CHOLESTEROL_MLP
from repro_torch.core import ClientLoopError, FaultPlan, SplitSession
from repro_torch.core.adapters import mlp_adapter
from repro_torch.core.protocol import SplitServer
from repro_torch.core.queue import FeatureQueue
from repro_torch.core.trainer import _trunk_sharder, make_server_step
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.optim import adamw

from test_torch_mesh import DP, adapter_of, config, cpu_grid, shards_of  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_LIMIT_S = 150
QUEUE_ENGINES = ("protocol-async", "fused-queue")
SHAPES = ((4, 1), (2, 2), (1, 4))
# (model, production, faults): the cholesterol MLP with 8 clients, fleet
# chunks and per item; the narrow CNN with 4; the MLP under a chaos plan
CASES = {"mlp": ("mlp", "fleet", False), "mlp-per-item": ("mlp", "per-item", False),
         "cnn": ("cnn", "fleet", False), "chaos": ("mlp", "fleet", True)}
CHAOS = dict(n_clients=8, seed=0, crash_windows={1: [(2, 5)]}, dropout_frac=0.25,
             dropout_period=10, dropout_down=3, straggle={2: 2.0}, drop_prob=0.1,
             dup_prob=0.1, halt_below=1)
EPOCHS, STEPS = 2, 3
LOSS_RTOL = 1e-5
# the trunk and moments with the trunk tensor-parallel, against the
# unsharded replay: ``test_torch_tp_lm``'s state tolerance (float32
# reassociation in the row-parallel sums, carried by AdamW)
STATE_TOL = dict(rtol=0, atol=1e-4)
# the MLP adapter with no tensor-parallel trunk (any user's own adapter):
# each engine that takes a mesh, as "engine|mode"
REPLICATED = ("fused-scan|detached", "fused-scan|e2e", "fused-queue|detached",
              "protocol-async|detached")
# a leader-only exception on the main thread: what raises it, at its third
# call on rank 0; every rank must raise within LEADER_ERROR_S, far inside
# the process group's timeout
LEADER_ERROR_TARGETS = ("lead_one", "_fault_halt_check")
# an item's step, which every rank runs: each rank raises its own error
STEP_ERROR_TARGET = "consume"
LEADER_ERROR_S, GROUP_TIMEOUT_S = 10.0, 60


def n_clients_of(model):
    return 8 if model == "mlp" else 4


def replicated_adapter():
    return dataclasses.replace(mlp_adapter(CHOLESTEROL_MLP), name="mlp-replicated",
                               server_forward_tp=None)


def session(model, engine, mesh, *, adapter=None, mode="detached", **opts):
    n = n_clients_of(model)
    return SplitSession(adapter or adapter_of(model), config(n, DP, mode), adamw(1e-2),
                        engine=engine, seed=0, mesh=mesh, device="cpu", **opts)


def threaded_session(case, engine, mesh, **opts):
    model, production, _ = CASES[case]
    return session(model, engine, mesh, threaded=True, production=production, fleet_chunk=4,
                   pop_timeout=0.02, **opts)


def trunk_vector(state) -> np.ndarray:
    """The trunk, its moments and the step as one float64 vector."""
    leaves = tree_leaves([state["server"], state["opt"]]) + [torch.tensor(int(state["step"]))]
    return np.concatenate([torch.as_tensor(a).detach().double().reshape(-1).numpy()
                           for a in leaves])


def replay(model, fits, shards):
    """The pops of each fit (``(client_id, release)`` in arrival order)
    stepped through a no-mesh protocol-async engine's own clients, item by
    item, and a ``SplitServer``: the trunk vector and the losses."""
    ref = session(model, "protocol-async", None, threaded=False, production="per-item")
    eng, state = ref.engine, ref.native_state
    step_fn = make_server_step(eng.adapter, eng.opt, eng.tc.grad_clip)
    losses = []
    for pops in fits:
        clients = eng._make_clients(state, shards)
        server = SplitServer(eng.adapter, state["server"], eng.opt, FeatureQueue(),
                             opt_state=state["opt"], step_count=int(state["step"]),
                             step_fn=step_fn, device="cpu")
        made = collections.defaultdict(list)
        for cid, release in pops:
            while len(made[cid]) < release:  # a client's releases come in order
                made[cid].append(clients[cid].produce())
            server.consume(cid, *made[cid][release - 1])
        losses += server.losses
        state = {**state, "server": server.params, "opt": server.opt_state,
                 "step": server.step_count}
    return trunk_vector(state), losses


# ------------------------------------------------------------ one rank
def test_shape_only_mesh_still_raises_for_a_replicated_trunk():
    with pytest.raises(ValueError, match="shape-only"):
        _trunk_sharder(ShapeMesh((1, 2), ("clients", "model")), replicated_adapter())
    assert _trunk_sharder(ShapeMesh((2, 1), ("clients", "model")), replicated_adapter()) is None


@pytest.mark.parametrize("engine", QUEUE_ENGINES)
def test_1x1_threaded_run_equals_its_replay(engine):
    """On a one-rank grid the leader is the only rank: its pops replayed
    with no mesh give its state bit for bit, its losses too, and the
    accounting is the threaded drive's."""
    s = threaded_session("mlp", engine, cpu_grid(1, 1))
    s.fit(shards_of("mlp", 8), epochs=EPOCHS, steps_per_epoch=STEPS)
    pops = s.engine.pops
    assert len(pops) == EPOCHS * STEPS == int(s.state["step"])
    vec, losses = replay("mlp", [pops], shards_of("mlp", 8))
    assert np.array_equal(trunk_vector(s.state), vec)
    assert s.engine.losses == losses
    st = s.engine.stats
    assert st["pushed"] - st["popped"] == len(s.engine.queue)
    assert s.privacy_report()["releases"] == max(s.fault_stats["releases_per_client"])


# --------------------------------------------------- multi-rank (gloo)
def _spawn(tmp_path, job: str, world: int = 4) -> list:
    """Run ``job`` on ``world`` ranks; every rank's JSON result. Fails the
    test (after killing every rank) past ``SPAWN_LIMIT_S`` or on a rank's
    error."""
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
    return [json.loads((tmp_path / f"result{r}.json").read_text()) for r in range(world)]


@pytest.fixture(scope="module")
def threaded(tmp_path_factory):
    d = tmp_path_factory.mktemp("threaded")
    return d, _spawn(d, "threaded")


def _ranks_agree(ranks, key, d):
    """Every rank's record of ``key`` equals rank 0's; rank 0's record."""
    rec = ranks[0][key]
    for r in range(1, len(ranks)):
        for field in ("privacy", "stats", "fault_stats", "pops", "losses", "steps", "error"):
            assert ranks[r][key].get(field) == rec.get(field), f"{key}: rank {r} {field}"
        assert np.array_equal(np.load(d / f"{key}_r{r}.npy"), np.load(d / f"{key}_r0.npy")), \
            f"{key}: rank {r}'s state parted"
    return rec


def _assert_replays(d, key, rec, shape):
    got, want = np.load(d / f"{key}_r0.npy"), np.load(d / f"{key}_replay.npy")
    if shape[1] == 1:
        assert np.array_equal(got, want), key
        assert rec["losses"] == rec["replay_losses"], key
    else:
        np.testing.assert_allclose(got, want, **STATE_TOL, err_msg=key)
        np.testing.assert_allclose(rec["losses"], rec["replay_losses"], rtol=LOSS_RTOL,
                                   err_msg=key)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("engine", QUEUE_ENGINES)
def test_threaded_mesh_follows_the_leaders_arrivals(threaded, engine, case, shape):
    """Four gloo ranks: every rank's state, budget, stats and fault_stats
    equal; pushed - popped is the leader's queue length and popped the
    steps; the leader's pops replayed with no mesh give the state (bit for
    bit on (4, 1), within STATE_TOL and the losses within LOSS_RTOL where
    the trunk is tensor-parallel)."""
    d, ranks = threaded
    key = f"{engine}|{case}|{shape[0]}x{shape[1]}"
    rec = _ranks_agree(ranks, key, d)
    st, fs = rec["stats"], rec["fault_stats"]
    assert st["pushed"] - st["popped"] == rec["queue_len"]
    assert st["popped"] == rec["steps"] == EPOCHS * STEPS == len(rec["pops"])
    assert rec["privacy"]["releases"] == max(fs["releases_per_client"])
    if CASES[case][2]:
        assert fs["plan"] is not None and not fs["halted"]
        assert sum(fs["transit_dropped"]) + sum(fs["duplicated"]) > 0, key
    _assert_replays(d, key, rec, shape)


@pytest.mark.parametrize("shape", ((4, 1), (1, 4)), ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_second_fit_continues_on_every_rank(threaded, shape):
    """protocol-async fit twice: every rank ends equal, and the replay of
    both fits' pops (the second fit's clients seeded from the step) gives
    the state."""
    d, ranks = threaded
    key = f"two-fits|{shape[0]}x{shape[1]}"
    rec = _ranks_agree(ranks, key, d)
    assert rec["steps"] == 2 * EPOCHS * STEPS
    _assert_replays(d, key, rec, shape)


@pytest.mark.parametrize("target", LEADER_ERROR_TARGETS)
def test_a_leader_error_raises_on_every_rank(tmp_path, target):
    """An exception on the leader's main thread (``lead_one`` or the quorum
    check raising at their third call, on rank 0 alone) ends the drive on
    both gloo ranks within ``LEADER_ERROR_S``, well inside the group's
    ``GROUP_TIMEOUT_S``: rank 0 raises its own exception, rank 1 a
    ``RemoteLeaderError`` carrying its ``repr``, not gloo's timeout."""
    ranks = _spawn(tmp_path, f"leader_error:{target}", world=2)
    leader, follower = ranks[0]["leader_error"], ranks[1]["leader_error"]
    want = f"RuntimeError('{target} failed')"
    assert leader["type"] == "RuntimeError" and leader["repr"] == want
    assert follower["type"] == "RemoteLeaderError" and want in follower["message"]
    assert follower["leader_repr"] == want
    assert "timed out" not in follower["message"].lower()
    for r, rec in ((0, leader), (1, follower)):
        assert rec["raised_at"] - leader["injected_at"] < LEADER_ERROR_S, f"rank {r}: {rec}"


def test_an_error_in_the_step_every_rank_runs_raises_on_every_rank(tmp_path):
    """``SplitServer.consume`` raising at its third call on both ranks (the
    same computation failing everywhere): each rank raises its own error
    within ``LEADER_ERROR_S``, and the leader sends no end of the drive
    that no rank would read."""
    ranks = _spawn(tmp_path, f"leader_error:{STEP_ERROR_TARGET}", world=2)
    want = f"RuntimeError('{STEP_ERROR_TARGET} failed')"
    for r, res in enumerate(ranks):
        rec = res["leader_error"]
        assert rec["type"] == "RuntimeError" and rec["repr"] == want, f"rank {r}: {rec}"
        assert rec["raised_at"] - rec["injected_at"] < LEADER_ERROR_S, f"rank {r}: {rec}"


@pytest.mark.parametrize("engine", QUEUE_ENGINES)
def test_a_client_error_raises_on_every_rank(threaded, engine):
    """A raising ``noise_fn`` on the leader's client threads: every rank
    raises ``ClientLoopError`` with the leader's client id and cause, and
    the same ``fault_stats``."""
    d, ranks = threaded
    key = f"error|{engine}"
    rec = _ranks_agree(ranks, key, d)
    err = rec["error"]
    assert err is not None and "no draws for client" in err["cause"]
    assert rec["fault_stats"]["client_error"] == err["cause"]
    assert rec["fault_stats"]["client_error_id"] == err["client_id"]


def test_no_collective_leaves_the_main_thread(threaded):
    """Every collective of the threaded fits (torch.distributed wrapped on
    every rank) ran on the main thread; the relay's broadcasts were among
    them."""
    _, ranks = threaded
    for r, res in enumerate(ranks):
        calls = res["collectives"]
        assert calls["off_main"] == 0, f"rank {r}: {calls}"
        assert calls["ops"].get("broadcast", 0) > 0 and calls["ops"].get("all_reduce", 0) > 0


@pytest.mark.parametrize("shape", ((1, 4), (2, 2)), ids=lambda s: f"{s[0]}x{s[1]}")
def test_an_adapter_without_a_tensor_parallel_trunk_runs_on_a_model_axis(tmp_path, shape):
    """The MLP adapter with ``server_forward_tp=None`` on (1, 4) and (2, 2):
    the trunk runs whole on every rank, every rank ends equal, and the
    losses follow the unsharded run's within LOSS_RTOL (taken in a rank
    process: one thread, as the ranks). Nothing on the model axis touches
    the values, so the trunk, its moments and the losses are the unsharded
    run's bit for bit too."""
    ranks = _spawn(tmp_path, f"replicated:{shape[0]}x{shape[1]}")
    for case in REPLICATED:
        got, base = ranks[0][case], ranks[0][f"{case}|none"]
        np.testing.assert_allclose(got, base, rtol=LOSS_RTOL, err_msg=case)
        assert got == base, case
        assert np.array_equal(np.load(tmp_path / f"{case}_r0.npy"),
                              np.load(tmp_path / f"{case}_none.npy")), case
        for r in range(1, 4):
            assert ranks[r][case] == got
            assert np.array_equal(np.load(tmp_path / f"{case}_r{r}.npy"),
                                  np.load(tmp_path / f"{case}_r0.npy")), f"{case}: rank {r}"


# ------------------------------------------------------- the rank program
def _watch_collectives():
    """Wrap torch.distributed's collectives: count each call by op, and
    those made off the main thread."""
    import torch.distributed as dist

    calls = {"ops": collections.Counter(), "off_main": 0}
    for name in ("broadcast", "all_gather", "all_reduce", "all_gather_into_tensor",
                 "reduce_scatter", "reduce_scatter_tensor", "barrier", "broadcast_object_list",
                 "all_gather_object", "send", "recv"):
        fn = getattr(dist, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            calls["ops"][_name] += 1
            if threading.current_thread() is not threading.main_thread():
                calls["off_main"] += 1
            return _fn(*args, **kwargs)

        setattr(dist, name, wrapped)
    return calls


def _record(sess, out_dir, key, rank, result, error=None):
    eng = sess.engine
    np.save(os.path.join(out_dir, f"{key}_r{rank}.npy"), trunk_vector(sess.state))
    result[key] = {"privacy": sess.privacy_report(), "stats": eng.stats,
                   "fault_stats": sess.fault_stats, "pops": [list(p) for p in eng.pops],
                   "queue_len": len(eng.queue), "losses": eng.losses,
                   "steps": int(sess.state["step"]), "error": error}
    return result[key]


def _threaded_job(rank, out_dir, result):
    calls = _watch_collectives()
    for shape in SHAPES:
        tag = f"{shape[0]}x{shape[1]}"
        for engine in QUEUE_ENGINES:
            for case, (model, _, chaos) in CASES.items():
                s = threaded_session(case, engine, cpu_grid(*shape))
                shards = shards_of(model, n_clients_of(model))
                s.fit(shards, epochs=EPOCHS, steps_per_epoch=STEPS,
                      faults=FaultPlan(**CHAOS) if chaos else None)
                key = f"{engine}|{case}|{tag}"
                rec = _record(s, out_dir, key, rank, result)
                if rank == 0:
                    vec, rec["replay_losses"] = replay(model, [s.engine.pops], shards)
                    np.save(os.path.join(out_dir, f"{key}_replay.npy"), vec)
        if shape in ((4, 1), (1, 4)):
            s, fits = threaded_session("mlp", "protocol-async", cpu_grid(*shape)), []
            for _ in range(2):
                s.fit(shards_of("mlp", 8), epochs=EPOCHS, steps_per_epoch=STEPS)
                fits.append(list(s.engine.pops))
            key = f"two-fits|{tag}"
            rec = _record(s, out_dir, key, rank, result)
            rec["losses"] = s.engine.losses  # both fits'
            if rank == 0:
                vec, rec["replay_losses"] = replay("mlp", fits, shards_of("mlp", 8))
                np.save(os.path.join(out_dir, f"{key}_replay.npy"), vec)

    def failing_noise(client, release, model_shape, guard_shape):
        raise RuntimeError(f"no draws for client {client}")

    for engine in QUEUE_ENGINES:
        s = threaded_session("mlp", engine, cpu_grid(2, 2), noise_fn=failing_noise)
        try:
            s.fit(shards_of("mlp", 8), epochs=EPOCHS, steps_per_epoch=STEPS)
        except ClientLoopError as e:
            error = {"client_id": e.client_id, "cause": repr(e.cause)}
        else:
            raise AssertionError("a raising client thread did not surface")
        _record(s, out_dir, f"error|{engine}", rank, result, error)
    result["collectives"] = {"ops": dict(calls["ops"]), "off_main": calls["off_main"]}


def _replicated_job(shape, rank, out_dir, result):
    adapter = replicated_adapter()
    for case in REPLICATED:
        engine, mode = case.split("|")
        for name, mesh in ((f"r{rank}", cpu_grid(*shape)), ("none", None)):
            if mesh is None and rank != 0:
                continue
            s = session("mlp", engine, mesh, adapter=adapter, mode=mode)
            hist = s.fit(shards_of("mlp", 8), epochs=EPOCHS, steps_per_epoch=STEPS)
            result[case if mesh is not None else f"{case}|none"] = [h["loss"] for h in hist]
            np.save(os.path.join(out_dir, f"{case}_{name}.npy"), trunk_vector(s.state))


def _leader_error_job(target, rank, result):
    """The threaded MLP protocol-async session on a (2, 1) grid, a fault
    plan with no faults (so the quorum check runs), ``target`` patched to
    raise at its third call, on rank 0 (on every rank for ``consume``);
    what each rank raised, and when."""
    from repro_torch.core import protocol

    owner = {"lead_one": protocol.LeaderRelay, "consume": SplitServer}.get(target, protocol)
    original, calls, rec = getattr(owner, target), [0], {}

    def failing(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 3:
            rec["injected_at"] = time.time()
            raise RuntimeError(f"{target} failed")
        return original(*args, **kwargs)

    if rank == 0 or target == STEP_ERROR_TARGET:
        setattr(owner, target, failing)
    s = threaded_session("mlp", "protocol-async", cpu_grid(2, 1))
    try:
        s.fit(shards_of("mlp", 8), epochs=EPOCHS, steps_per_epoch=STEPS,
              faults=FaultPlan(n_clients=8, seed=0))
    except Exception as e:  # recorded for the test to judge
        rec.update(raised_at=time.time(), type=type(e).__name__, repr=repr(e),
                   message=str(e), leader_repr=getattr(e, "leader_repr", None))
    else:
        raise AssertionError(f"rank {rank}: the leader's {target} error did not surface")
    finally:
        setattr(owner, target, original)
    result["leader_error"] = rec


def _rank_main(job: str, rank: int, world: int, out_dir: str) -> None:
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    timeout = {"timeout": datetime.timedelta(seconds=GROUP_TIMEOUT_S)} \
        if job.startswith("leader_error:") else {}
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world, **timeout)
    result = {}
    if job == "threaded":
        _threaded_job(rank, out_dir, result)
    elif job.startswith("leader_error:"):
        _leader_error_job(job.split(":", 1)[1], rank, result)
    elif job.startswith("replicated:"):
        shape = tuple(int(v) for v in job.split(":", 1)[1].split("x"))
        _replicated_job(shape, rank, out_dir, result)
    with open(os.path.join(out_dir, f"result{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
