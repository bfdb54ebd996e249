#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, all at once), holds each against its plain PyTorch version at the
shapes of the main path and at every variant the serving kernels' plan
functions choose (``privacy_conv``: Cin 1 or generic, float4 or scalar
stores; ``dp_release``: one block a row or a split row, float4 or scalar,
with and without noise; each line prints its plan, and every
``dp_release`` check is relaunched and must give the same bits), then
drives the main path: guarded split-inference
serving of the paper's COVID-CT CNN at its full published width (64x64x1
inputs, stages 16/32/64/128/256, dense 64 -> 1, cut after stage 1) for three
hospitals, with the privacy kernel in the client stage and a clipped
``DPConfig`` through the release kernel. It then serves the same trace on
the plain path and compares, profiles the device's busy share over one
serve, checks the card's answers against the CPU on a small trace, and times
each serving kernel against its plain version and against the plan it beat.

Then it drives the second path, the LM kernels' public entry points
``flash_attention`` and ``selective_scan``, at the full widths of the repo's
LM configs (llama3.2-1b, mixtral-8x7b with its sliding window,
hubert-xlarge bidirectional with a ragged S, falcon-mamba-7b's scan), holds
each output against its plain version on the card and small float32 and
bfloat16 cases against the CPU, and times the attention cases (the bfloat16
ones beside SDPA) and the scan, each tile or lane choice of a kernel against
the one it beat. It prints one JSON object per phase and a ``kernels`` line
with every ported kernel. The last line is ``{"ok": true, "device": ...}``.

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

from repro_torch.configs import COVID_CNN, get_config  # noqa: E402
from repro_torch.core.adapters import cnn_adapter  # noqa: E402
from repro_torch.data import make_covid_ct, split_clients  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.dp_release import ops as dp_ops  # noqa: E402
from repro_torch.kernels.dp_release.ref import dp_release_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_mask  # noqa: E402
from repro_torch.kernels.privacy_conv import ops as pc_ops  # noqa: E402
from repro_torch.kernels.privacy_conv.ref import privacy_conv_ref  # noqa: E402
from repro_torch.kernels.selective_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.selective_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.privacy import DPConfig, PrivacyGuard  # noqa: E402
from repro_torch.serving import SplitInferenceServer, poisson_trace  # noqa: E402

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM3 rate, float32 rate
# outside the tensor cores, and the dense bfloat16 tensor-core rate (a
# bfloat16 product is exact in float32, so bfloat16 operands can do their
# products at this rate whatever the kernel does)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS_PER_S = 67e12
PEAK_BF16_FLOPS_PER_S = 989e12
# kernel vs plain version: float32 sums in another order
KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)
# whole-trunk logits: the float32 rounding of the release carried through
# four convs and two dense layers
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)
# flash attention vs its plain version: float32, the JAX suite's 2e-5
# (tests/test_kernels.py:19), sums in another order (tile by tile, with the
# online rescaling); bfloat16, both sides compute in float32 and round the
# output to bfloat16, so they differ where the float32 values straddle a
# rounding boundary: rtol 1.6e-2 is two bfloat16 ulps (2 x 2^-7 of the
# value), atol 2e-3 covers the values near zero
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
            torch.bfloat16: dict(atol=2e-3, rtol=1.6e-2)}
# SDPA (the library yardstick) vs the kernel, bfloat16: another computation
# of the function, which rounds the probabilities to bfloat16 before P.V
# where the kernel keeps them in float32; held to four bfloat16 ulps of the
# value, and at least four ulps of 1
LIB_TOL = dict(atol=3.2e-2, rtol=3.2e-2)
# selective scan vs its plain version (tests/test_kernels.py:110): the sum
# over the states in another order and expf's ulps, carried by the recurrence
SCAN_TOL = dict(atol=1e-5, rtol=1e-4)
# (config, batch, sequence, dtypes) of the attention cases; the first dtype
# of llama3.2-1b is the timed case. Each case runs in float32 too, where the
# tolerance holds the mask, the window and the head dim tightly.
# hubert-xlarge: 30 s of 20 ms frames, 1500 rows, a ragged tail for the
# 64-row tiles
ATTN_CASES = (("llama3.2-1b", 4, 2048, (torch.bfloat16, torch.float32)),
              ("mixtral-8x7b", 1, 8192, (torch.bfloat16, torch.float32)),
              ("hubert-xlarge", 8, 1500, (torch.bfloat16, torch.float32)))
SCAN_CASE = ("falcon-mamba-7b", 4, 2048)
# privacy_conv check cases (B, H, W, Cin, Cout, noise_scale), together every
# variant conv_plan chooses: the COVID-CT client stage (Cin 1, float4), the
# TABLE1 one, Cin 16 and Cin 40 (generic, float4; one and three chunks of 16
# input channels, two and three channel blocks), and Cout 5, 6, 7 (scalar;
# Cin 3, 1 and 20) at H, W that are no multiples of the 16-pixel tile
CONV_CASES = {"covid": (64, 64, 64, 1, 16, 0.05), "table1": (64, 32, 32, 3, 16, 0.05),
              "cin16": (8, 32, 32, 16, 32, 0.0), "cin40": (2, 34, 16, 40, 36, 0.1),
              "cin3_cout5": (3, 10, 14, 3, 5, 0.1), "cin1_cout6": (2, 18, 22, 1, 6, 0.1),
              "cin20_cout7": (2, 12, 20, 20, 7, 0.1)}
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


def host_fed_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Milliseconds per call when the host launches the calls one after
    another with nothing queued ahead: the rate a Python caller sees, which
    includes the host's launch cost where it exceeds the device time."""
    for _ in range(warmup):
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


def bound(nbytes: int, flops: int, peak_flops: float = PEAK_F32_FLOPS_PER_S) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bytes": nbytes, "flops": flops, "peak_flops_per_s": peak_flops,
            "bound_ms": max(t_bytes, t_ops),
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


def release_cases(sigma: float) -> dict:
    """``{case: (shape, sigma)}`` of the check phase: the serving cut (k = 1)
    and the MURA cut (k > 1) with and without noise, and F % 4 != 0 (scalar)
    and B = 1 on each side of the split."""
    return {"covid_sigma0": ((64, 32, 32, 16), 0.0), "covid": ((64, 32, 32, 16), sigma),
            "mura": ((8, 112, 112, 64), sigma), "mura_sigma0": ((8, 112, 112, 64), 0.0),
            "odd_f_split": ((2, 50001), sigma), "odd_f_split_sigma0": ((2, 50001), 0.0),
            "odd_f": ((5, 7, 5), sigma), "odd_f_sigma0": ((5, 7, 5), 0.0),
            "b1_split": ((1, 112, 112, 64), sigma), "b1": ((1, 100), sigma)}


def other_release_plan(plan: dict, rows: int, feats: int, sm_count: int) -> dict:
    """The plan that ``plan`` beat: one block a row (the parent's design)
    where it splits rows, else the split that fills the SMs with no floor on
    the chunk (what ``MIN_CHUNK`` rules out)."""
    if plan["blocks_per_row"] > 1:
        return {"why": "one block a row",
                "plan": {**plan, "blocks_per_row": 1, "chunk": feats, "launches": 1}}
    k = -(-sm_count // rows)
    chunk = 4 * -(-feats // (4 * k))  # a multiple of 4, k or fewer chunks
    return {"why": "rows split to fill the SMs, no floor on the chunk",
            "plan": {**plan, "blocks_per_row": -(-feats // chunk), "chunk": chunk, "launches": 2}}


def release_work(shape, sigma: float) -> dict:
    n = int(np.prod(shape))
    nbytes = 4 * n * (3 if sigma > 0 else 2)
    flops = n * (5 if sigma > 0 else 3)  # x*x+acc, x*scale (+ sigma*noise + add)
    return bound(nbytes, flops)


def attention_inputs(name, B, S, dtype, seed, dev) -> dict:
    """A case at ``name``'s published widths, drawn on the card from
    ``seed``: q ``[B,S,H,hd]``, k and v ``[B,S,KV,hd]``, and the config's
    mask (causal or not, its sliding window)."""
    cfg = get_config(name)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.sliding_window and S <= cfg.sliding_window:
        raise AssertionError(f"{name}: S {S} does not exceed the window {cfg.sliding_window}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, S, h, hd), generator=gen, device=dev).to(dtype)
               for h in (H, KV, KV))
    return {"q": q, "k": k, "v": v, "causal": cfg.causal, "window": cfg.sliding_window,
            "shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd}}


def attention_plain_by_group(c) -> torch.Tensor:
    """The plain version one kv head's group of query heads at a time, so
    that its [heads, S, S] float32 scores stay a few GB at S 8192."""
    q, k, v = c["q"], c["k"], c["v"]
    G = q.shape[2] // k.shape[2]
    return torch.cat([fa_ops.flash_attention_plain(
        q[:, :, j * G:(j + 1) * G], k[:, :, j:j + 1], v[:, :, j:j + 1],
        causal=c["causal"], window=c["window"]) for j in range(k.shape[2])], dim=2)


def attention_work(c) -> dict:
    s = c["shape"]
    esize = c["q"].element_size()
    pairs = int(attention_mask(s["S"], causal=c["causal"], window=c["window"],
                               device=c["q"].device).sum())
    nbytes = esize * s["B"] * s["S"] * s["hd"] * (2 * s["H"] + 2 * s["KV"])
    # q.k and p.v: 2 flops each per head dim per unmasked pair, at the peak
    # of the operands' type
    peak = PEAK_F32_FLOPS_PER_S if c["q"].dtype == torch.float32 else PEAK_BF16_FLOPS_PER_S
    return {"unmasked_pairs": pairs,
            **bound(nbytes, 4 * s["hd"] * pairs * s["B"] * s["H"], peak)}


def attention_library(c) -> tuple:
    """One SDPA call on ``c``'s inputs (copies in SDPA's ``[B, H, S, hd]``
    layout, made here, outside the timed call) and its note. Without a
    window it is ``is_causal`` with ``enable_gqa``; a sliding window has no
    SDPA flag, so it is a boolean mask with k and v repeated to the query
    heads."""
    q, k, v = (t.transpose(1, 2).contiguous() for t in (c["q"], c["k"], c["v"]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not c["window"]:
        return (lambda: sdpa(q, k, v, is_causal=c["causal"], enable_gqa=True),
                f"torch scaled_dot_product_attention(is_causal={c['causal']}, enable_gqa) "
                "on [B,H,S,hd] copies; a yardstick the port never calls")
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    mask = attention_mask(q.shape[2], causal=c["causal"], window=c["window"], device=q.device)
    return (lambda: sdpa(q, k, v, attn_mask=mask),
            "torch scaled_dot_product_attention with a boolean [S,S] mask (causal and the "
            "window; SDPA has no window flag) on [B,H,S,hd] copies, kv repeated to the "
            "query heads; library_kernel names the device kernel it ran")


def top_device_kernel(fn) -> str:
    """The name of the device kernel that took most of one call of ``fn``
    (under the profiler), to name the backend a library call took."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        return "not identified: the profiler recorded no device kernel"
    return max(events, key=lambda e: e.self_device_time_total).key[:160]


def scan_inputs(B, S, di, st, seed, dev) -> tuple:
    """u, dt, B, C, A, D on the card from ``seed``: A and D as ``init_ssm``
    sets them (A = -exp(log(1..st)) per channel, D = 1), dt a softplus of
    normals as in tests/test_kernels.py:102."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn((B, S, di), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, di), generator=gen, device=dev) * 0.5 - 1)
    Bm = torch.randn((B, S, st), generator=gen, device=dev)
    Cm = torch.randn((B, S, st), generator=gen, device=dev)
    A = -torch.exp(torch.log(torch.arange(1, st + 1, dtype=torch.float32, device=dev)))
    A = A[None].repeat(di, 1).contiguous()
    D = torch.ones((di,), device=dev)
    return u, dt, Bm, Cm, A, D


def scan_work(B, S, di, st) -> dict:
    nbytes = 4 * (3 * B * S * di + 2 * B * S * st + di * st + di)
    # per state: dt*A, exp, dA*h, dtu*B, +, h*C and its sum; per channel:
    # dt*u, D*u, +
    return bound(nbytes, B * S * di * (8 * st + 3))


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
    wall = time.perf_counter() - t0
    # the bf16 attention kernels run on the tensor cores: HMMA in their SASS
    hmma = build.sass_counts("flash_attention", "HMMA")
    if hmma is not None and not all(n for f, n in hmma.items() if "bf16" in f):
        raise AssertionError(f"a bf16 attention kernel has no HMMA instruction: {hmma}")
    emit({"phase": "build", "wall_s": wall, "flash_attention_hmma": hmma,
          "kernels": {n: {k: v for k, v in i.items() if k != "path"} for n, i in info.items()}})

    # ---- check: each kernel against its plain version on the card, every
    # variant that the plan functions can choose (each line names its plan)
    gen = torch.Generator().manual_seed(1)
    errs = {}
    conv_inputs = {}
    seen = set()
    for case, (B, H, W, cin, cout, scale) in CONV_CASES.items():
        x, w, b, nz = conv_inputs[case] = conv_case(gen, B, H, W, cin, cout, dev)
        plan = pc_ops.plan_for(x, w, nz, scale)
        seen.add((plan["cin_variant"], plan["vec4"]))
        got = pc_ops.privacy_conv_forward(x, w, b, nz, scale)
        torch.cuda.synchronize()
        err = max_err(got, privacy_conv_ref(x, w, b, nz, noise_scale=scale), **KERNEL_TOL,
                      what=f"privacy_conv/{case}")
        errs[f"privacy_conv/{case}"] = err
        emit({"phase": "check", "case": f"privacy_conv/{case}", "shape": [B, H, W, cin, cout],
              "noise_scale": scale, "plan": plan, "max_abs_err": err, **KERNEL_TOL})
    if seen != {(c, v) for c in (1, 0) for v in (True, False)}:
        raise AssertionError(f"privacy_conv variants checked {sorted(seen)}, want all four")
    sigma = DPConfig().sigma
    release_inputs = {}
    seen = set()
    for case, (shape, s) in release_cases(sigma).items():
        x = torch.randn(shape, generator=gen).to(dev)
        nz = torch.randn(shape, generator=gen).to(dev)
        release_inputs[case] = (x, nz)
        plan = dp_ops.plan_for(x, nz, s)
        seen.add((plan["blocks_per_row"] > 1, plan["vec4"], s > 0))
        got = dp_ops.dp_release_forward(x, nz, 1.0, s)
        again = dp_ops.dp_release_forward(x, nz, 1.0, s)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"dp_release/{case}: a relaunch gave other bits")
        err = max_err(got, dp_release_ref(x, nz, clip_norm=1.0, sigma=s), **KERNEL_TOL,
                      what=f"dp_release/{case}")
        errs[f"dp_release/{case}"] = err
        emit({"phase": "check", "case": f"dp_release/{case}", "shape": list(shape),
              "features": int(np.prod(shape[1:])), "sigma": s, "plan": plan,
              "bit_identical_relaunch": True, "max_abs_err": err, **KERNEL_TOL})
    if seen != {(k, v, n) for k in (False, True) for v in (False, True) for n in (False, True)}:
        raise AssertionError(f"dp_release plans checked {sorted(seen)}, want k = 1 and k > 1, "
                             "float4 and scalar, each with and without noise")

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
    scale = CONV_CASES["covid"][-1]
    conv_fns = (lambda: pc_ops.privacy_conv_forward(x, w, b, nz, scale),
                lambda: privacy_conv_ref(x, w, b, nz, noise_scale=scale))
    k_ms, p_ms = paired_ms(*conv_fns)
    k_host, p_host = paired_ms(*conv_fns, timer=host_fed_ms)
    conv_only = cuda_ms(lambda: torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1))
    plan = pc_ops.plan_for(x, w, nz, scale)
    generic = {**plan, "cin_variant": 0}  # the variant the Cin = 1 one beat
    generic_ms = paired_ms(conv_fns[0], lambda: pc_ops._launch(x, w, b, nz, scale, generic))[1]
    timed["privacy_conv"] = {"case": "privacy_conv/covid", "ms": k_ms, "plain_ms": p_ms,
                             "host_fed_ms": k_host, "plain_host_fed_ms": p_host,
                             "plan": plan, "other_plan": {"plan": generic, "ms": generic_ms},
                             "library_ms": None,
                             "library_note": "no single PyTorch call computes conv+bias+"
                                             "ReLU+pool+noise; cudnn_conv_only_ms times "
                                             "the conv alone",
                             "cudnn_conv_only_ms": conv_only,
                             **conv_work(*CONV_CASES["covid"][:5])}
    for case in ("covid", "mura"):
        xr, nr = release_inputs[case]
        rel_fns = (lambda: dp_ops.dp_release_forward(xr, nr, 1.0, sigma),
                   lambda: dp_release_ref(xr, nr, clip_norm=1.0, sigma=sigma))
        k_ms, p_ms = paired_ms(*rel_fns)
        k_host, p_host = paired_ms(*rel_fns, timer=host_fed_ms)
        plan = dp_ops.plan_for(xr, nr, sigma)
        other = other_release_plan(plan, xr.shape[0], int(np.prod(xr.shape[1:])),
                                   torch.cuda.get_device_properties(dev).multi_processor_count)
        other_ms = paired_ms(rel_fns[0],
                             lambda: dp_ops._launch(xr, nr, 1.0, sigma, other["plan"]))[1]
        timed[f"dp_release/{case}"] = {
            "case": f"dp_release/{case}", "ms": k_ms, "plain_ms": p_ms,
            "host_fed_ms": k_host, "plain_host_fed_ms": p_host, "plan": plan,
            "other_plan": {**other, "ms": other_ms}, "library_ms": None,
            "library_note": "no single PyTorch call computes the per-row clip and noise",
            **release_work(tuple(xr.shape), sigma)}
    for t in timed.values():
        t["bound_share"] = t["bound_ms"] / t["ms"]
        emit({"phase": "time", "card": smi, **t})

    # ==== the second path: the LM kernels' entry points at the configs' widths
    attn = {}
    for i, (name, B, S, dtypes) in enumerate(ATTN_CASES):
        for dt_ in dtypes:
            attn[(name, dt_)] = attention_inputs(name, B, S, dt_, seed=10 + i, dev=dev)
    sname, sB, sS = SCAN_CASE
    scfg = get_config(sname)
    scan_shape = (sB, sS, scfg.d_inner, scfg.ssm_state)
    scan_in = scan_inputs(*scan_shape, seed=20, dev=dev)

    # ---- lm_path: each entry point once per case, the counts read around it
    torch.cuda.synchronize()
    fa_ops.launches = ss_ops.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        attn_out = {key: fa_ops.flash_attention(c["q"], c["k"], c["v"], causal=c["causal"],
                                                window=c["window"])
                    for key, c in attn.items()}
        scan_out = ss_ops.selective_scan(*scan_in)
    torch.cuda.synchronize()
    lm_wall = time.perf_counter() - t0
    lm_launches = {"flash_attention": fa_ops.launches, "selective_scan": ss_ops.launches}
    if lm_launches != {"flash_attention": len(attn), "selective_scan": 1}:
        raise AssertionError(f"LM path launches {lm_launches}, want one per call")
    for (name, dt_), out in attn_out.items():
        c = attn[(name, dt_)]
        if out.shape != c["q"].shape or out.dtype != dt_ or not torch.isfinite(out).all():
            raise AssertionError(f"flash_attention/{name}: shape, dtype or non-finite values")
    if scan_out.shape != scan_in[0].shape or not torch.isfinite(scan_out).all():
        raise AssertionError("selective_scan: shape or non-finite values")
    emit({"phase": "lm_path", "card": smi, "wall_s": lm_wall, "launches": lm_launches,
          "calls": [f"flash_attention/{n}/{str(d).split('.')[-1]}" for n, d in attn]
          + [f"selective_scan/{sname}"]})

    # ---- lm_check: each output of the path against its plain version on the card
    for (name, dt_), c in attn.items():
        case = f"flash_attention/{name}"
        err = max_err(attn_out[(name, dt_)], attention_plain_by_group(c), **ATTN_TOL[dt_],
                      what=f"{case}/{dt_}")
        errs[case] = max(err, errs.get(case, 0.0))
        emit({"phase": "check", "case": case, "config": name,
              "dtype": str(dt_).split(".")[-1], **c["shape"], "causal": c["causal"],
              "window": c["window"], "max_abs_err": err, **ATTN_TOL[dt_]})
    case = f"selective_scan/{sname}"
    errs[case] = max_err(scan_out, selective_scan_ref(*scan_in), **SCAN_TOL, what=case)
    emit({"phase": "check", "case": case, "config": sname, "dtype": "float32",
          **dict(zip(("B", "S", "di", "st"), scan_shape)), "max_abs_err": errs[case],
          **SCAN_TOL})

    # ---- lm_reference: the kernels on the card against the plain versions on
    # the CPU, on small inputs (hd 80, a ragged S, GQA, a window; S 17 scan)
    gen = torch.Generator().manual_seed(3)
    small = [torch.randn(shape, generator=gen) for shape in
             ((2, 100, 4, 80), (2, 100, 2, 80), (2, 100, 2, 80))]
    with torch.no_grad():
        card_attn = fa_ops.flash_attention(*(t.to(dev) for t in small), window=24).cpu()
    attn_ref_err = max_err(card_attn, fa_ops.flash_attention(*small, window=24),
                           **ATTN_TOL[torch.float32], what="flash_attention vs cpu")
    # the same in bfloat16: the tensor-core kernel against the CPU
    small_bf = [t.bfloat16() for t in small]
    with torch.no_grad():
        card_bf = fa_ops.flash_attention(*(t.to(dev) for t in small_bf), window=24).cpu()
    attn_bf_err = max_err(card_bf, fa_ops.flash_attention(*small_bf, window=24),
                          **ATTN_TOL[torch.bfloat16], what="bf16 flash_attention vs cpu")
    small_scan = [t.cpu() for t in scan_inputs(1, 17, 64, 16, seed=4, dev=dev)]
    with torch.no_grad():
        card_scan = ss_ops.selective_scan(*(t.to(dev) for t in small_scan), t_chunk=5).cpu()
    scan_ref_err = max_err(card_scan, ss_ops.selective_scan(*small_scan), **SCAN_TOL,
                           what="selective_scan vs cpu")
    emit({"phase": "lm_reference", "reference_device": "cpu",
          "flash_attention": {"shape": [2, 100, 4, 2, 80], "window": 24,
                              "max_abs_err_vs_cpu": attn_ref_err, **ATTN_TOL[torch.float32]},
          "flash_attention_bf16": {"shape": [2, 100, 4, 2, 80], "window": 24,
                                   "max_abs_err_vs_cpu": attn_bf_err,
                                   **ATTN_TOL[torch.bfloat16]},
          "selective_scan": {"shape": [1, 17, 64, 16], "t_chunk": 5,
                             "max_abs_err_vs_cpu": scan_ref_err, **SCAN_TOL}})

    # ---- lm_time: the three attention cases in bfloat16, each beside SDPA,
    # and the scan; each kernel's own tile (lane) choice is timed in turns
    # against the one it beat. The plain scan runs a Python loop of 2048
    # steps, some 8,000 launches a call, more than the launch queue holds: it
    # cannot be queued ahead of the device, so its time is host-fed.
    fa_other = fa_ops.Q_ROWS[torch.bfloat16][1]
    for name, *_ in ATTN_CASES:
        c = attn[(name, torch.bfloat16)]
        fa_args = (c["q"], c["k"], c["v"])
        fa_mask = dict(causal=c["causal"], window=c["window"])
        fa_fns = (lambda: fa_ops.flash_attention(*fa_args, **fa_mask),
                  lambda: fa_ops.flash_attention_plain(*fa_args, **fa_mask))
        k_ms, o_ms = paired_ms(fa_fns[0], lambda: fa_ops._launch(
            *fa_args, c["causal"], c["window"], q_rows=fa_other))
        lib_fn, lib_note = attention_library(c)
        lib_kernel = top_device_kernel(lib_fn)
        lib_ms = cuda_ms(lib_fn)
        lib_err = max_err(lib_fn().transpose(1, 2), attn_out[(name, torch.bfloat16)],
                          **LIB_TOL, what=f"sdpa vs kernel, {name}")
        t = {"case": f"flash_attention/{name}", "dtype": "bfloat16", **c["shape"],
             "causal": c["causal"], "window": c["window"], "ms": k_ms,
             "q_rows": fa_ops.Q_ROWS[torch.bfloat16][0],
             "other_tile": {"q_rows": fa_other, "ms": o_ms},
             "library_ms": lib_ms, "library_note": lib_note, "library_kernel": lib_kernel,
             "library_max_abs_err": lib_err, "library_tol": LIB_TOL, **attention_work(c)}
        if name == "llama3.2-1b":  # the kernels line's case: the plain version too
            t["plain_ms"] = paired_ms(*fa_fns)[1]
            t["host_fed_ms"], t["plain_host_fed_ms"] = paired_ms(*fa_fns, timer=host_fed_ms)
        timed[f"flash_attention/{name}"] = t
    ss_other = ss_ops.LANES[16][1]
    scan_fns = (lambda: ss_ops.selective_scan(*scan_in), lambda: selective_scan_ref(*scan_in))
    # the entry point's d_tile 128 and t_chunk 64, with the other lane count
    k_ms, o_ms = paired_ms(scan_fns[0], lambda: ss_ops._launch(*scan_in, 128, 64,
                                                                lanes=ss_other))
    p_runs = [host_fed_ms(scan_fns[1], iters=2, warmup=int(r == 0)) for r in range(3)]
    timed["selective_scan"] = {
        "case": f"selective_scan/{sname}", "dtype": "float32",
        **dict(zip(("B", "S", "di", "st"), scan_shape)),
        "ms": k_ms, "lanes": ss_ops.LANES[16][0],
        "other_lanes": {"lanes": ss_other, "ms": o_ms},
        "plain_ms": float(np.median(p_runs)), "plain_timer": "host_fed",
        "host_fed_ms": host_fed_ms(scan_fns[0]),
        "library_ms": None, "library_note": "no single PyTorch call computes the scan",
        **scan_work(*scan_shape)}
    for key in [f"flash_attention/{n}" for n, *_ in ATTN_CASES] + ["selective_scan"]:
        t = timed[key]
        t["bound_share"] = t["bound_ms"] / t["ms"]
        emit({"phase": "time", "card": smi, **t})

    # ---- kernels: one line for every ported kernel
    rows = [
        ("privacy_conv", "src/repro_torch/csrc/privacy_conv.cu",
         "src/repro/kernels/privacy_conv/kernel.py:56", "privacy_conv/covid",
         timed["privacy_conv"], launches),
        ("dp_release", "src/repro_torch/csrc/dp_release.cu",
         "src/repro/kernels/dp_release/kernel.py:39", "dp_release/covid",
         timed["dp_release/covid"], launches),
        ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:66", "flash_attention/llama3.2-1b",
         timed["flash_attention/llama3.2-1b"], lm_launches),
        ("selective_scan", "src/repro_torch/csrc/selective_scan.cu",
         "src/repro/kernels/selective_scan/kernel.py:53", f"selective_scan/{sname}",
         timed["selective_scan"], lm_launches),
    ]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep_line,
         "launches": counts[name], "max_abs_err": errs[case], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": t["library_ms"]}
        for name, src, rep_line, case, t, counts in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
