#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, all at once), holds each against its plain PyTorch version at the
shapes of the main path, then drives the main path: guarded split-inference
serving of the paper's COVID-CT CNN at its full published width (64x64x1
inputs, stages 16/32/64/128/256, dense 64 -> 1, cut after stage 1) for three
hospitals, with the privacy kernel in the client stage and a clipped
``DPConfig`` through the release kernel. It then serves the same trace on
the plain path and compares, profiles the device's busy share over one
serve, checks the card's answers against the CPU on a small trace, times
each kernel against its plain version, and prints one JSON object per
phase. The last line is ``{"ok": true, "device": ...}``.

Any failed phase raises and the script exits non-zero; so does a machine
without a CUDA card. The weights are random, drawn from seed 0. TF32 is off
for cuDNN and matmuls, so every comparison is float32 against float32.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import COVID_CNN  # noqa: E402
from repro_torch.core.adapters import cnn_adapter  # noqa: E402
from repro_torch.data import make_covid_ct, split_clients  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.dp_release import ops as dp_ops  # noqa: E402
from repro_torch.kernels.dp_release.ref import dp_release_ref  # noqa: E402
from repro_torch.kernels.privacy_conv import ops as pc_ops  # noqa: E402
from repro_torch.kernels.privacy_conv.ref import privacy_conv_ref  # noqa: E402
from repro_torch.privacy import DPConfig, PrivacyGuard  # noqa: E402
from repro_torch.serving import SplitInferenceServer, poisson_trace  # noqa: E402

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM3 rate and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS_PER_S = 67e12
# kernel vs plain version: float32 sums in another order
KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)
# whole-trunk logits: the float32 rounding of the release carried through
# four convs and two dense layers
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)
SHARES = (0.7, 0.2, 0.1)
REQUEST_BATCH = 64  # one chest-CT study of 64 slices; the paper's batch size
MAX_BATCH = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def max_err(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float, what: str) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside tolerance, "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def cuda_ms(fn, iters: int = 50) -> float:
    """Device milliseconds per call over ``iters`` calls, timed with CUDA
    events after a warm-up. A spin kernel holds the stream while the host
    enqueues the calls, so they run back to back on the device and the
    events measure the device's time, not the host's launch rate; the spin
    grows until it outlasts the enqueueing."""
    for _ in range(10):
        fn()
    cycles = 20_000_000
    while True:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.5 * host_ms:
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 4
        if cycles > 20_000_000 * 4 ** 5:
            raise RuntimeError("the host could not enqueue the timed calls ahead of the device")


def host_fed_ms(fn, iters: int = 100) -> float:
    """Milliseconds per call when the host launches the calls one after
    another with nothing queued ahead: the rate a Python caller sees, which
    includes the host's launch cost where it exceeds the device time."""
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain, timer=cuda_ms, rounds: int = 5) -> tuple:
    """Kernel and plain times in alternating turns; the median of each."""
    ks, ps = [], []
    for r in range(rounds):
        order = ((ks, kernel), (ps, plain)) if r % 2 else ((ps, plain), (ks, kernel))
        for acc, fn in order:
            acc.append(timer(fn))
    return float(np.median(ks)), float(np.median(ps))


def bound(nbytes: int, flops: int) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ----------------------------------------------------------------- inputs
def conv_case(gen, B, H, W, cin, cout, dev):
    return ((torch.rand((B, H, W, cin), generator=gen)).to(dev),
            (0.3 * torch.randn((3, 3, cin, cout), generator=gen)).to(dev),
            (0.1 * torch.randn((cout,), generator=gen)).to(dev),
            torch.randn((B, H // 2, W // 2, cout), generator=gen).to(dev))


def conv_work(B, H, W, cin, cout) -> dict:
    out = B * (H // 2) * (W // 2) * cout
    nbytes = 4 * (B * H * W * cin + 9 * cin * cout + cout + 2 * out)
    # 9*Cin multiply-adds per pre-pool value, bias and ReLU on each, then
    # three max and the noise multiply-add per pooled value
    flops = B * H * W * cout * (2 * 9 * cin + 2) + out * 5
    return bound(nbytes, flops)


def release_work(shape, sigma: float) -> dict:
    n = int(np.prod(shape))
    nbytes = 4 * n * (3 if sigma > 0 else 2)
    flops = n * (5 if sigma > 0 else 3)  # x*x+acc, x*scale (+ sigma*noise + add)
    return bound(nbytes, flops)


def covid_state(adapter, dev):
    gen = torch.Generator().manual_seed(0)
    return {"client_banks": [adapter.init(gen, dev)["client"] for _ in SHARES],
            "server": adapter.init(gen, dev)["server"], "step": 0}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available; this script runs on the card")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32})

    # ---- build: one nvcc per source, all started together
    t0 = time.perf_counter()
    info = build.build()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "kernels": {n: {k: v for k, v in i.items() if k != "path"} for n, i in info.items()}})

    # ---- check: each kernel against its plain version on the card
    gen = torch.Generator().manual_seed(1)
    errs = {}
    conv_cases = {"covid": (64, 64, 64, 1, 16, COVID_CNN.privacy_noise),
                  "cin16": (8, 32, 32, 16, 32, 0.0)}
    conv_inputs = {}
    for case, (B, H, W, cin, cout, scale) in conv_cases.items():
        x, w, b, nz = conv_inputs[case] = conv_case(gen, B, H, W, cin, cout, dev)
        got = pc_ops.privacy_conv_forward(x, w, b, nz, scale)
        torch.cuda.synchronize()
        err = max_err(got, privacy_conv_ref(x, w, b, nz, noise_scale=scale), **KERNEL_TOL,
                      what=f"privacy_conv/{case}")
        errs[f"privacy_conv/{case}"] = err
        emit({"phase": "check", "case": f"privacy_conv/{case}", "shape": [B, H, W, cin, cout],
              "noise_scale": scale, "max_abs_err": err, **KERNEL_TOL})
    sigma = DPConfig().sigma
    release_cases = {"covid_sigma0": ((64, 32, 32, 16), 0.0),
                     "covid": ((64, 32, 32, 16), sigma),
                     "mura": ((8, 112, 112, 64), sigma)}
    release_inputs = {}
    for case, (shape, s) in release_cases.items():
        x = torch.randn(shape, generator=gen).to(dev)
        nz = torch.randn(shape, generator=gen).to(dev)
        release_inputs[case] = (x, nz)
        got = dp_ops.dp_release_forward(x, nz, 1.0, s)
        torch.cuda.synchronize()
        err = max_err(got, dp_release_ref(x, nz, clip_norm=1.0, sigma=s), **KERNEL_TOL,
                      what=f"dp_release/{case}")
        errs[f"dp_release/{case}"] = err
        emit({"phase": "check", "case": f"dp_release/{case}", "shape": list(shape),
              "features": int(np.prod(shape[1:])), "sigma": s, "max_abs_err": err,
              **KERNEL_TOL})

    # ---- serve: the main path, full-width COVID-CT CNN, kernels on
    cfg = dataclasses.replace(COVID_CNN, use_kernel=True)
    dp = DPConfig(clip_norm=1.0, use_kernel=True)
    adapter = cnn_adapter(cfg)
    state = covid_state(adapter, dev)
    shards = split_clients(*make_covid_ct(320, hw=64, seed=0), shares=SHARES)
    trace = poisson_trace(3, rate=2.0, horizon=32, seed=0, shares=SHARES)
    knobs = dict(max_batch=MAX_BATCH, request_batch=REQUEST_BATCH, seed=0, device=dev)
    server = SplitInferenceServer(adapter, state, guard=PrivacyGuard(dp), **knobs)
    server.serve(poisson_trace(3, rate=2.0, horizon=4, seed=1, shares=SHARES), shards)  # warm-up
    torch.cuda.synchronize()
    pc_ops.launches = dp_ops.launches = 0
    rep = server.serve(trace, shards)
    launches = {"privacy_conv": pc_ops.launches, "dp_release": dp_ops.launches}
    releases = sum(rep.releases_per_client)
    if rep.offered != trace.offered or rep.answered + rep.dropped + rep.shed != rep.offered:
        raise AssertionError(f"serve ledger does not balance: {rep.deterministic_stats()}")
    if rep.answered != rep.accepted or rep.answered == 0:
        raise AssertionError(f"admitted requests left unanswered: {rep.deterministic_stats()}")
    if launches != {"privacy_conv": releases, "dp_release": releases}:
        raise AssertionError(f"launches {launches} != releases {releases}")
    for rid, out in rep.responses.items():
        if out.shape != (REQUEST_BATCH, 1) or not np.isfinite(out).all():
            raise AssertionError(f"response {rid}: shape {out.shape} or non-finite values")
    pct = rep.latency_percentiles()
    emit({"phase": "serve", "card": smi, "model": cfg.name, "use_kernel": True,
          "sigma": dp.sigma, "request_batch": REQUEST_BATCH, "max_batch": MAX_BATCH,
          "offered": rep.offered, "answered": rep.answered, "dropped": rep.dropped,
          "shed": rep.shed, "batches": rep.batches, "releases": releases,
          "launches": launches, "wall_s": rep.wall_s, "throughput_rps": rep.throughput_rps,
          "p50_ms": pct["p50_ms"], "p99_ms": pct["p99_ms"],
          "p50_cycles": pct["p50_cycles"], "p99_cycles": pct["p99_cycles"]})

    # ---- serve_plain: the same trace, state and noise on the plain path
    plain_server = SplitInferenceServer(
        cnn_adapter(dataclasses.replace(cfg, use_kernel=False)), state,
        guard=PrivacyGuard(dataclasses.replace(dp, use_kernel=False)), **knobs)
    plain_server.serve(poisson_trace(3, rate=2.0, horizon=4, seed=1, shares=SHARES), shards)
    plain = plain_server.serve(trace, shards)
    if plain.deterministic_stats() != rep.deterministic_stats():
        raise AssertionError("plain serve differs in its deterministic stats")
    resp_err = max(max_err(torch.from_numpy(rep.responses[r]), torch.from_numpy(v),
                           **SERVE_TOL, what=f"response {r}")
                   for r, v in plain.responses.items())
    emit({"phase": "serve_plain", "use_kernel": False, "stats_equal": True,
          "max_abs_err_responses": resp_err, "wall_s": plain.wall_s,
          "throughput_rps": plain.throughput_rps, **SERVE_TOL})

    # ---- serve_pairs: the trace served again on each path, in alternating
    # turns, for the end-to-end comparison (host clock, so it spreads)
    runs = {"kernel": [], "plain": []}
    for r in range(6):
        order = [("kernel", server), ("plain", plain_server)]
        for name, srv in (order if r % 2 else order[::-1]):
            rr = srv.serve(trace, shards)
            runs[name].append({"throughput_rps": rr.throughput_rps,
                               **rr.latency_percentiles()})
    emit({"phase": "serve_pairs", "card": smi, "rounds": 6, **{
        name: {f"median_{k}": float(np.median([x[k] for x in rs]))
               for k in ("throughput_rps", "p50_ms", "p99_ms")}
        | {"throughput_rps_all": [x["throughput_rps"] for x in rs]}
        for name, rs in runs.items()}})

    # ---- profile: the device's busy share over one more serve of the trace
    # (the profiler slows the host, so the share is a lower bound)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.serve(trace, shards)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    emit({"phase": "profile", "card": smi, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms, "device_events": len(dev_events),
          "top": [{"name": e.key[:90], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:10]]})

    # ---- reference: card (kernels) against the CPU (plain) on a small trace,
    # both fed the same numpy noise
    small = poisson_trace(3, rate=2.0, horizon=4, seed=2, shares=SHARES)

    def numpy_noise(client, release, model_shape, guard_shape):
        rng = np.random.default_rng((client, release))
        return (rng.standard_normal(model_shape, np.float32),
                rng.standard_normal(guard_shape, np.float32))

    answers = {}
    for where, cfg_, dp_ in ((dev, cfg, dp), ("cpu", dataclasses.replace(cfg, use_kernel=False),
                                               dataclasses.replace(dp, use_kernel=False))):
        answers[str(where)] = SplitInferenceServer(
            cnn_adapter(cfg_), state, guard=PrivacyGuard(dp_), max_batch=MAX_BATCH,
            request_batch=4, noise_fn=numpy_noise, device=where).serve(small, shards)
    card, cpu = answers[str(dev)], answers["cpu"]
    if card.deterministic_stats() != cpu.deterministic_stats() or card.answered == 0:
        raise AssertionError("card and CPU serves differ in their deterministic stats")
    ref_err = max(max_err(torch.from_numpy(card.responses[r]), torch.from_numpy(v),
                          **SERVE_TOL, what=f"cpu reference {r}")
                  for r, v in cpu.responses.items())
    emit({"phase": "reference", "answered": card.answered, "max_abs_err_vs_cpu": ref_err,
          **SERVE_TOL})

    # ---- time: kernel vs plain version at the main path's shapes. "ms" is
    # device time (calls queued back to back); "host_fed_ms" the rate of
    # back-to-back calls from Python. Inputs stay in the 50 MB L2 cache
    # across calls, as a release's input does after the client stage.
    timed = {}
    x, w, b, nz = conv_inputs["covid"]
    scale = conv_cases["covid"][-1]
    conv_fns = (lambda: pc_ops.privacy_conv_forward(x, w, b, nz, scale),
                lambda: privacy_conv_ref(x, w, b, nz, noise_scale=scale))
    k_ms, p_ms = paired_ms(*conv_fns)
    k_host, p_host = paired_ms(*conv_fns, timer=host_fed_ms)
    conv_only = cuda_ms(lambda: torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1))
    timed["privacy_conv"] = {"case": "privacy_conv/covid", "ms": k_ms, "plain_ms": p_ms,
                             "host_fed_ms": k_host, "plain_host_fed_ms": p_host,
                             "library_ms": None,
                             "library_note": "no single PyTorch call computes conv+bias+"
                                             "ReLU+pool+noise; cudnn_conv_only_ms times "
                                             "the conv alone",
                             "cudnn_conv_only_ms": conv_only,
                             **conv_work(*conv_cases["covid"][:5])}
    for case in ("covid", "mura"):
        xr, nr = release_inputs[case]
        rel_fns = (lambda: dp_ops.dp_release_forward(xr, nr, 1.0, sigma),
                   lambda: dp_release_ref(xr, nr, clip_norm=1.0, sigma=sigma))
        k_ms, p_ms = paired_ms(*rel_fns)
        k_host, p_host = paired_ms(*rel_fns, timer=host_fed_ms)
        timed[f"dp_release/{case}"] = {
            "case": f"dp_release/{case}", "ms": k_ms, "plain_ms": p_ms,
            "host_fed_ms": k_host, "plain_host_fed_ms": p_host, "library_ms": None,
            "library_note": "no single PyTorch call computes the per-row clip and noise",
            **release_work(tuple(xr.shape), sigma)}
    for t in timed.values():
        t["bound_share"] = t["bound_ms"] / t["ms"]
        emit({"phase": "time", "card": smi, **t})

    # ---- kernels: one line for every ported kernel
    rows = [
        ("privacy_conv", "src/repro_torch/csrc/privacy_conv.cu",
         "src/repro/kernels/privacy_conv/kernel.py:56", "privacy_conv/covid",
         timed["privacy_conv"]),
        ("dp_release", "src/repro_torch/csrc/dp_release.cu",
         "src/repro/kernels/dp_release/kernel.py:39", "dp_release/covid",
         timed["dp_release/covid"]),
    ]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep_line,
         "launches": launches[name], "max_abs_err": errs[case], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": t["library_ms"]}
        for name, src, rep_line, case, t in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
