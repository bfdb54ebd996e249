#!/usr/bin/env python3
"""A/B timing of two builds of the port's kernels on one NVIDIA card.

    python3 tools/kernel_ab.py --old OLD_CSRC --new NEW_CSRC

Each directory holds the four sources ``privacy_conv.cu``,
``dp_release.cu``, ``flash_attention.cu`` and ``selective_scan.cu`` (a
``src/repro_torch/csrc`` of the port, for example a parent commit's,
written out with ``git show`` or ``git archive``). Every source is built
with the flags of ``repro_torch.kernels.build`` into a temporary directory
(one ``nvcc`` per source, all started together) and loaded with
``ctypes``. The cases are ``chip_smoke.py``'s: the serving kernels at the
COVID-CT client stage (``privacy_conv/covid``) and at the COVID-CT and
MURA cuts (``dp_release/covid``, ``dp_release/mura``), then the three
bfloat16 attention cases (llama3.2-1b, mixtral-8x7b, hubert-xlarge) and the
falcon-mamba-7b scan. A serving source that exports
``<name>_launch_plan`` runs the plan its wrapper chooses (``plan_for``);
one that exports only ``<name>_launch`` (the sources from before the plan
functions) chooses its own launch. Each build's output is held against the
plain version at ``chip_smoke.py``'s tolerance, with TF32 off for the
plain convolution and matmuls, then the two builds are timed in turns
(old, new, new, old, ...) with ``chip_smoke``'s device timer. Prints one
JSON line per case, with the card's name and power limit, and exits
non-zero without a card or when a check fails.
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
from repro_torch.kernels.dp_release import ops as dp_ops  # noqa: E402
from repro_torch.kernels.privacy_conv import ops as pc_ops  # noqa: E402

NAMES = ("privacy_conv", "dp_release", "flash_attention", "selective_scan")
_ptr, _int, _ll, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the serving kernels' C interface before the plan functions: one thread per
# pooled output, one block per row, each choosing its own launch
UNPLANNED = {"privacy_conv_launch": (_ptr,) * 5 + (_int,) * 5 + (_float, _ptr),
             "dp_release_launch": (_ptr,) * 3 + (_ll, _ll, _float, _float, _ptr)}


def load(csrc: str, tag: str, out_dir: str) -> dict:
    """``{name: loaded library}`` of the sources in ``csrc``, with the C
    functions of ``build.SIGNATURES`` (or the unplanned serving interface)
    declared where the library exports them."""
    procs = {}
    for name in NAMES:
        lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tag} {name}: nvcc exited {proc.returncode}\n{log}")
        lib = ctypes.CDLL(path)
        for fname, argtypes in {**build.SIGNATURES[name], **UNPLANNED}.items():
            if hasattr(lib, fname):
                fn = getattr(lib, fname)
                fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        libs[name] = lib
    return libs


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def conv_call(lib, x, w, b, nz, scale, out):
    """One launch of ``lib``'s privacy_conv into ``out``, and its plan."""
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), nz.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "privacy_conv_launch_plan"):
        plan = pc_ops.plan_for(x, w, nz, scale)
        return (lambda: _check(lib.privacy_conv_launch_plan(
            *ptrs, B, H, W, cin, cout, scale, plan["cin_variant"],
            plan["channels_per_block"], int(plan["vec4"]), stream), "privacy_conv")), plan
    return (lambda: _check(lib.privacy_conv_launch(*ptrs, B, H, W, cin, cout, scale, stream),
                           "privacy_conv")), "its own"


def release_call(lib, x, nz, sigma, out):
    """One call of ``lib``'s dp_release into ``out``, and its plan."""
    rows, feats = x.shape[0], int(np.prod(x.shape[1:]))
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "dp_release_launch_plan"):
        plan = dp_ops.plan_for(x, nz, sigma)
        k = plan["blocks_per_row"]
        partials = torch.empty((rows, k), device=x.device) if k > 1 else None
        return (lambda: _check(lib.dp_release_launch_plan(
            x.data_ptr(), nz.data_ptr(), out.data_ptr(),
            partials.data_ptr() if partials is not None else None, rows, feats, 1.0, sigma,
            k, plan["chunk"], int(plan["vec4"]), stream), "dp_release")), plan
    return (lambda: _check(lib.dp_release_launch(x.data_ptr(), nz.data_ptr(), out.data_ptr(),
                                                 rows, feats, 1.0, sigma, stream),
                           "dp_release")), "its own"


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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"old": load(args.old, "old", tmp), "new": load(args.new, "new", tmp)}
        stream = torch.cuda.current_stream().cuda_stream

        gen = torch.Generator().manual_seed(1)
        sigma = cs.DPConfig().sigma
        serving = [("privacy_conv/covid", cs.CONV_CASES["covid"]),
                   ("dp_release/covid", ((64, 32, 32, 16), sigma)),
                   ("dp_release/mura", ((8, 112, 112, 64), sigma))]
        for case, spec in serving:
            if case.startswith("privacy_conv"):
                B, H, W, cin, cout, scale = spec
                x, w, b, nz = cs.conv_case(gen, B, H, W, cin, cout, dev)
                want = cs.privacy_conv_ref(x, w, b, nz, noise_scale=scale)
                outs = {t: torch.empty_like(want) for t in libs}
                calls = {t: conv_call(libs[t]["privacy_conv"], x, w, b, nz, scale, outs[t])
                         for t in libs}
                shape, work = list(spec[:5]), cs.conv_work(*spec[:5])
            else:
                shape, s = spec
                x = torch.randn(shape, generator=gen).to(dev)
                nz = torch.randn(shape, generator=gen).to(dev)
                want = cs.dp_release_ref(x, nz, clip_norm=1.0, sigma=s)
                outs = {t: torch.empty_like(x) for t in libs}
                calls = {t: release_call(libs[t]["dp_release"], x, nz, s, outs[t])
                         for t in libs}
                shape, work = list(shape), cs.release_work(shape, s)
            errs = {}
            for t in libs:
                calls[t][0]()
                torch.cuda.synchronize()
                errs[t] = cs.max_err(outs[t], want, **cs.KERNEL_TOL, what=f"{t} {case}")
            ms = in_turns({t: calls[t][0] for t in libs}, args.rounds)
            print(json.dumps({"case": case, "card": smi, "shape": shape,
                              "plan": {t: calls[t][1] for t in libs}, "ms": ms,
                              "max_abs_err": errs, **cs.KERNEL_TOL, "tf32": False,
                              "bound_ms": work["bound_ms"]}), flush=True)

        for i, (name, B, S, _) in enumerate(cs.ATTN_CASES):
            c = cs.attention_inputs(name, B, S, torch.bfloat16, seed=10 + i, dev=dev)
            q, k, v = c["q"], c["k"], c["v"]
            sh = c["shape"]
            want = cs.attention_plain_by_group(c)
            outs = {t: torch.empty_like(q) for t in libs}

            def call(t):
                _check(libs[t]["flash_attention"].flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[t].data_ptr(), 1, sh["B"],
                    sh["S"], sh["H"], sh["KV"], sh["hd"], int(c["causal"]), int(c["window"]),
                    1.0 / sh["hd"] ** 0.5, stream), "flash_attention")

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
            _check(libs[t]["selective_scan"].selective_scan_launch(
                *(x.data_ptr() for x in sin), ys[t].data_ptr(), *shape, 128, 64, stream),
                "selective_scan")

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
