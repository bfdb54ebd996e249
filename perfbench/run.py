"""Run one cell of the port's benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is the
result's JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error. Exits non-zero,
printing no result, without a CUDA card (or with fewer than the cell asks
for), or where JAX, Flax or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's CUDA kernels build into its own directory in the
    # checkout; any other compiler cache goes to fixed places there too
    cache = ROOT / "perfbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    import torch

    from perfbench import bench

    t_import = time.perf_counter() - T_START

    cell = bench.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    # the configurations' float32: TF32 off before any set-up
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    result = bench.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                       t_import=t_import)
    bad = bench.forbidden_modules()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, v in result["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
