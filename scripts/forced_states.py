"""The states of ``chip_smoke.py``'s ``train_forced`` kernel run, kept, and
each step retaken on them by the code of a given tree: whether a step that
parts from the CPU step by more than ``GRAD_TOL`` does so because of that
tree's kernel step or because of the state it starts from.

    python3 scripts/forced_states.py record OUT.pt
    python3 scripts/forced_states.py replay OUT.pt [ROOT]

``record`` runs train_forced's kernel run (COVID-CT at its published width,
e2e, 10 steps of one CPU plan) with this tree's code at the calibrated sigma
and at sigma 0, and keeps each step's starting state and the kernel step's
gradient (read back from AdamW's first moment). ``replay`` loads them and
takes every step from its kept state with ROOT's code (default: this tree)
on the kernel path, the plain path on the card and the plain path on the
CPU, and prints one JSON line a sigma: each step's gradient distances in
relative L2, among the three paths and against the recorded kernel step.
Runs on the card, TF32 off, cuDNN in its deterministic mode.
"""
import json
import os
import sys

ROOT = os.path.abspath(sys.argv[3] if len(sys.argv) > 3 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.data import make_covid_ct, split_clients  # noqa: E402

SIGMAS = {"calibrated": None, "sigma0": 0.0}


def setup(noise_scale, paths):
    """The epoch runners of ``paths`` and train_forced's 10-step plan."""
    dev = torch.device("cuda")
    shards = split_clients(*make_covid_ct(600, hw=64, seed=0), shares=cs.SHARES)
    where = {"kernel": (True, dev), "plain_card": (False, dev),
             "cpu": (False, torch.device("cpu"))}
    runs = {}
    for name in paths:
        on, place = where[name]
        sess = cs.covid_session(on, place, noise_scale)
        _, run = cs.make_epoch_runner(sess.adapter, sess.config, sess.opt, 1, device=place)
        runs[name] = (run, cs.device_put_shards(shards, place), place)
    n = cs.COVID_EPOCHS * cs.COVID_STEPS
    data_x, _, lens = cs.device_put_shards(shards, "cpu")
    plan = cs.make_sample_plan(sess.adapter, sess.config, n)(
        lens, tuple(data_x.shape[2:]), torch.Generator().manual_seed(5), "cpu")
    steps = [cs.SamplePlan(*(None if a is None else a[t:t + 1]
                             for a in (plan.idx, plan.model_noise, plan.guard_noise)))
             for t in range(n)]
    return runs, steps, cs.covid_session(True, dev, noise_scale).state


def take(runs, name, state, step):
    """One step of path ``name`` from ``state``: (new state, gradient)."""
    run, (data_x, data_y, _), place = runs[name]
    mu0 = state["opt"]["mu"].cpu()
    new, _ = run(cs.tree_map(lambda a: a.to(place), state), data_x, data_y, step.to(place))
    return new, (new["opt"]["mu"].cpu() - cs.ADAM_B1 * mu0) / (1 - cs.ADAM_B1)


def record(out: str) -> None:
    kept = {}
    for label, ns in SIGMAS.items():
        runs, steps, state = setup(ns, ("kernel",))
        states, grads = [], []
        for step in steps:
            states.append(cs.tree_map(lambda a: a.cpu(), state))
            state, grad = take(runs, "kernel", state, step)
            grads.append(grad)
        kept[label] = {"states": states, "grads": grads}
    torch.save(kept, out)


def replay(path: str) -> None:
    kept = torch.load(path)
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    for label, ns in SIGMAS.items():
        runs, steps, _ = setup(ns, ("kernel", "plain_card", "cpu"))
        rows = []
        for t, step in enumerate(steps):
            g = {name: take(runs, name, kept[label]["states"][t], step)[1] for name in runs}
            rows.append({"t": t, "kernel_vs_cpu": rel(g["cpu"], g["kernel"]),
                         "plain_card_vs_kernel": rel(g["plain_card"], g["kernel"]),
                         "plain_card_vs_cpu": rel(g["plain_card"], g["cpu"]),
                         "kernel_vs_recorded_kernel": rel(g["kernel"],
                                                          kept[label]["grads"][t])})
        print(json.dumps({"root": ROOT, "sigma": label, "grad_tol": cs.GRAD_TOL,
                          "rows": rows}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("forced_states: no CUDA device is available; this script runs on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cs.build.build()
    {"record": record, "replay": replay}[sys.argv[1]](sys.argv[2])


if __name__ == "__main__":
    main()
