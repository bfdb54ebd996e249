#!/usr/bin/env python3
"""A/B timing of two builds of the port's LM kernels on one NVIDIA card.

    python3 tools/kernel_ab.py --old OLD_CSRC --new NEW_CSRC

Each directory holds a ``flash_attention.cu`` and a ``selective_scan.cu``
(a ``src/repro_torch/csrc`` of the port, for example a parent commit's,
unpacked with ``git archive``). Every source is built with the flags of
``repro_torch.kernels.build`` into a temporary directory (one ``nvcc`` per
source, all started together), loaded with ``ctypes`` through its
``<name>_launch`` C function, and run on the inputs of ``chip_smoke.py``'s
LM cases: the three bfloat16 attention cases (llama3.2-1b, mixtral-8x7b,
hubert-xlarge) and the falcon-mamba-7b scan. Each build's output is held
against the plain version at ``chip_smoke.py``'s tolerance, then the two
builds are timed in turns (old, new, new, old, ...) with ``chip_smoke``'s
device timer. Prints one JSON line per case, with the card's name and power
limit, and exits non-zero without a card or when a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

NAMES = ("flash_attention", "selective_scan")


def load(csrc: str, tag: str, out_dir: str) -> dict:
    """``{name: C launch function}`` of the sources in ``csrc``."""
    procs = {}
    for name in NAMES:
        lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tag} {name}: nvcc exited {proc.returncode}\n{log}")
        fn = getattr(ctypes.CDLL(lib), f"{name}_launch")
        fn.argtypes = list(build.SIGNATURES[name][f"{name}_launch"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def in_turns(fns: dict, rounds: int) -> dict:
    """Median device ms of each function, timed in turns, order reversed
    every other round."""
    times = {k: [] for k in fns}
    keys = list(fns)
    for r in range(rounds):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            times[k].append(cs.cuda_ms(fns[k]))
    return {k: float(np.median(t)) for k, t in times.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="directory of the old sources")
    ap.add_argument("--new", required=True, help="directory of the new sources")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device is available")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"old": load(args.old, "old", tmp), "new": load(args.new, "new", tmp)}
        stream = torch.cuda.current_stream().cuda_stream

        for i, (name, B, S, _) in enumerate(cs.ATTN_CASES):
            c = cs.attention_inputs(name, B, S, torch.bfloat16, seed=10 + i, dev=dev)
            q, k, v = c["q"], c["k"], c["v"]
            sh = c["shape"]
            want = cs.attention_plain_by_group(c)
            outs = {t: torch.empty_like(q) for t in libs}

            def call(t):
                err = libs[t]["flash_attention"](
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[t].data_ptr(), 1, sh["B"],
                    sh["S"], sh["H"], sh["KV"], sh["hd"], int(c["causal"]), int(c["window"]),
                    1.0 / sh["hd"] ** 0.5, stream)
                if err:
                    raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")

            errs = {}
            for t in libs:
                call(t)
                torch.cuda.synchronize()
                errs[t] = cs.max_err(outs[t], want, **cs.ATTN_TOL[torch.bfloat16],
                                     what=f"{t} flash_attention/{name}")
            ms = in_turns({t: (lambda t=t: call(t)) for t in libs}, args.rounds)
            print(json.dumps({"case": f"flash_attention/{name}", "card": smi, "dtype": "bfloat16",
                              **sh, "causal": c["causal"], "window": c["window"],
                              "ms": ms, "max_abs_err": errs,
                              "bound_ms": cs.attention_work(c)["bound_ms"]}), flush=True)
            del c, q, k, v, want, outs
            torch.cuda.empty_cache()

        sname, sB, sS = cs.SCAN_CASE
        scfg = cs.get_config(sname)
        shape = (sB, sS, scfg.d_inner, scfg.ssm_state)
        sin = cs.scan_inputs(*shape, seed=20, dev=dev)
        want = cs.selective_scan_ref(*sin)
        ys = {t: torch.empty_like(sin[0]) for t in libs}

        def scan(t):
            # the entry point's defaults: d_tile 128, t_chunk 64
            err = libs[t]["selective_scan"](*(x.data_ptr() for x in sin), ys[t].data_ptr(),
                                            *shape, 128, 64, stream)
            if err:
                raise RuntimeError(f"selective_scan launch failed: CUDA error {err}")

        errs = {}
        for t in libs:
            scan(t)
            torch.cuda.synchronize()
            errs[t] = cs.max_err(ys[t], want, **cs.SCAN_TOL, what=f"{t} selective_scan")
        ms = in_turns({t: (lambda t=t: scan(t)) for t in libs}, args.rounds)
        print(json.dumps({"case": f"selective_scan/{sname}", "card": smi, "dtype": "float32",
                          **dict(zip(("B", "S", "di", "st"), shape)), "ms": ms,
                          "max_abs_err": errs, "bound_ms": cs.scan_work(*shape)["bound_ms"]}),
              flush=True)


if __name__ == "__main__":
    main()
