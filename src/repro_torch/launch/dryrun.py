"""Dry-run: build and trace one rank's step of every (arch x shape x mesh),
as ``repro.launch.dryrun``.

The reference lowers and compiles each step for the single-pod (16, 16)
and the two-pod (2, 16, 16) grids on forced host devices and reads XLA's
memory and cost analyses. Here ``launch.steps.build`` gives the step, a
``make_production_mesh`` grid is built over the FAKE process-group
backend (world 256 or 512, one process: rank 0 of the grid), and rank 0's
step runs once on its blocks of the inputs as fake tensors: the code that
a real grid runs, with no card and no storage. ``roofline.analysis``
counts it and prints the memory and the three roofline terms. Its figures
are predictions from counts for an H100 cluster, not measurements.

The SSM families trace the associative scan by default (``--set
associative_scan=false`` for the loop): the same matmul FLOPs as the
sequential loop, in log2(S) rounds of elementwise work where the loop
would run S steps of Python.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs 6] [--out FILE]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k \\
      --reduced --seq 64 --batch 8 --mesh 4x2 [--dtype float32]

Every step runs at the config's dtype (the LM configs' bfloat16: train
holds bf16 matrices beside float32 norms and moments, as the reference);
``--dtype`` traces the config at another (a float32 run's count).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import multiprocessing as mp
import sys
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.configs.base import shape_applicable
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh, release_meshes
from repro_torch.roofline.analysis import analyze_lowering, count_step


def parse_opt_overrides(pairs):
    """``--set key=value`` ModelOptions overrides (ints and bools)."""
    from repro_torch.models.transformer import ModelOptions

    if not pairs:
        return None
    kw = {}
    fields = {f.name for f in dataclasses.fields(ModelOptions)}
    for pair in pairs:
        k, v = pair.split("=", 1)
        if k not in fields:
            raise SystemExit(f"unknown ModelOptions field {k}")
        kw[k] = v.lower() in ("1", "true", "yes") if v.lower() in (
            "1", "0", "true", "false", "yes", "no") else int(v)
    return ModelOptions(**kw)


def fake_world(size: int) -> None:
    """A default process group of ``size`` ranks on the fake backend, this
    process rank 0 (started afresh where another group runs)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        release_meshes()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False, verbose: bool = True,
            opts=None, zero1: bool = False, shared_bank: bool = False, dump_ops: str = None,
            mesh_shape=None, reduced: bool = False, seq: int = None, batch: int = None,
            dtype: str = None):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    shape = SHAPES[shape_name]
    if seq or batch:
        shape = dataclasses.replace(shape, seq_len=seq or shape.seq_len,
                                    global_batch=batch or shape.global_batch)
    skip = shape_applicable(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "status": "skip", "reason": skip}
    if opts is None and cfg.ssm_state:
        from repro_torch.models.transformer import ModelOptions

        opts = ModelOptions(associative_scan=True)
    grid = tuple(mesh_shape) if mesh_shape else ((2, 16, 16) if multi_pod else (16, 16))
    fake_world(math.prod(grid))
    mesh = make_production_mesh(shape=grid, device_type="cpu")
    mesh_name = "x".join(str(s) for s in grid)
    t0 = time.time()
    kw = {"zero1": zero1, "shared_bank": shared_bank} if shape.kind == "train" else {}
    lowering = steps_lib.build(cfg, shape, mesh, opts, **kw)
    t_build = time.time() - t0
    counts = count_step(lowering, mesh)
    t_trace = time.time() - t0 - t_build
    if dump_ops:
        with open(dump_ops, "w") as f:
            json.dump({"ops": counts.ops,
                       "collectives": [[op, nb, len(g)] for op, nb, g in counts.collectives]}, f)
    report = analyze_lowering(cfg, shape, mesh_name, mesh.size(), counts)
    out = report.to_dict()
    out.update({"status": "ok", "kind": lowering.kind, "t_build_s": t_build,
                "t_trace_s": t_trace, "held_bytes": counts.held_bytes,
                "peak_live_bytes": counts.peak_live_bytes})
    if verbose:
        gib = 1 << 30
        print(f"[{arch} × {shape_name} × {mesh_name}] kind={lowering.kind}")
        print(f"  build {t_build:.1f}s trace {t_trace:.1f}s")
        print(f"  memory: held {counts.held_bytes / gib:.3f} GiB, "
              f"peak {report.peak_memory_bytes / gib:.3f} GiB a rank")
        print(f"  counts: flops={counts.flops:.3e} bytes={counts.bytes:.3e} "
              f"collective={report.collective_bytes_per_device:.3e}")
        print(f"  roofline: compute={report.t_compute*1e3:.2f}ms "
              f"memory={report.t_memory*1e3:.2f}ms "
              f"collective={report.t_collective*1e3:.2f}ms "
              f"-> bottleneck={report.bottleneck} "
              f"useful_flops={report.useful_flops_ratio:.2%}")
    return out


def _case(task):
    """One (arch, shape) case: its result and what it printed (a failure,
    a bug in the system, is a result with its traceback)."""
    arch, shape, kw = task
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        try:
            out = run_one(arch, shape, **{**kw, "opts": parse_opt_overrides(kw["opts"])})
        except Exception as e:  # reported below, counted as FAILED
            out = {"arch": arch, "shape": shape, "status": "error", "error": str(e),
                   "traceback": traceback.format_exc()}
    return out, text.getvalue()


def _report(out, text):
    print(text, end="")
    if out["status"] == "skip":
        print(f"[{out['arch']} × {out['shape']}] skip: {out['reason']}")
    elif out["status"] == "error":
        print(out["traceback"], file=sys.stderr)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id (see repro_torch.configs)")
    ap.add_argument("--shape", help="input shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true", help="run every (arch × shape)")
    ap.add_argument("--multi-pod", action="store_true", help="use the 2x16x16 mesh")
    ap.add_argument("--zero1", action="store_true", help="shard optimizer state over data (ZeRO-1)")
    ap.add_argument("--set", nargs="*", default=None, dest="overrides",
                    help="ModelOptions overrides, e.g. --set remat=true q_block=512")
    ap.add_argument("--dump-ops", default=None, help="write the traced step's op record here")
    ap.add_argument("--out", default=None, help="write JSON results to this file")
    ap.add_argument("--mesh", default=None, help="grid shape in place of the production one, "
                    "e.g. 4x2 (data x model) or 2x4x2 (pod x data x model)")
    ap.add_argument("--reduced", action="store_true", help="the configs' reduced() variants")
    ap.add_argument("--seq", type=int, default=None, help="sequence length in place of the shape's")
    ap.add_argument("--batch", type=int, default=None, help="global batch in place of the shape's")
    ap.add_argument("--jobs", type=int, default=1, help="cases traced at once, a process each")
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="the config's dtype in place of its own")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in sorted(list_configs()) for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]
    kw = dict(multi_pod=args.multi_pod, zero1=args.zero1, opts=args.overrides,
              dump_ops=args.dump_ops,
              mesh_shape=tuple(int(v) for v in args.mesh.split("x")) if args.mesh else None,
              reduced=args.reduced, seq=args.seq, batch=args.batch, dtype=args.dtype)
    tasks = [(arch, shape, kw) for arch, shape in combos]
    if args.jobs > 1:  # each case in a process of its own (each its own fake world)
        with mp.get_context("spawn").Pool(args.jobs, maxtasksperchild=1) as pool:
            done = pool.imap(_case, tasks)
            results = [_report(out, text) for out, text in done]
    else:
        results = [_report(*_case(t)) for t in tasks]
    failures = sum(r["status"] == "error" for r in results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2, default=str)
        print(f"wrote {len(results)} results to {args.out}")
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skip" for r in results)
    print(f"dry-run: {ok} ok, {skip} skip, {failures} FAILED")
    release_meshes()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
