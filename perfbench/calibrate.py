"""Readings for the limits of ``correct``: the program's numbers compared
over many seeds, and those of the control (the reference in TF32 in the
program's place) and of the planted faults on some of them, in one
process, each seed a short run of the cell.

    python3 perfbench/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> ... [--controls <k>] [--out <file.jsonl>]

Prints one JSON line a seed: the program's numbers (``program``), and for
the first ``k`` seeds the control's (``control``) and, for a training
cell, the half-batch fault's (``fault_half_batch``). Needs a CUDA card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from perfbench import bench

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = bench.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        def after(drv, i=i):
            extra = {"details": getattr(drv, "details", None)}
            if i < args.controls:
                extra["control"] = drv.control()
                extra["control_details"] = getattr(drv, "details", None)
                if hasattr(drv, "fault_half_batch"):
                    extra["fault_half_batch"] = drv.fault_half_batch()
            return extra

        t0 = time.perf_counter()
        r = bench.run(cell, seed, args.seconds, False, "cuda", after=after)
        line = {"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0,
                "program": {k: v["value"] for k, v in r["compared"].items()},
                **r["after"], "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "attempted": r["attempted"], "failed": r["failed"],
                "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                "setup_phases": r["setup_phases"]}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
