#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, all at once), holds each against its plain PyTorch version at the
shapes of the main path and at every variant the serving kernels' plan
functions choose (``privacy_conv``: Cin 1 or generic, float4 or scalar
stores; ``dp_release``: one block a row or a split row, float4 or scalar,
with and without noise; each line prints its plan, and every
``dp_release`` check is relaunched and must give the same bits) and at the
training path's shapes (a client's ``[21, 64, 64, 1]`` batch; the
``[63, 32, 32, 16]`` and ``[63, 112, 112, 64]`` releases, with and without
noise), then
drives the main path: guarded split-inference
serving of the paper's COVID-CT CNN at its full published width (64x64x1
inputs, stages 16/32/64/128/256, dense 64 -> 1, cut after stage 1) for three
hospitals, with the privacy kernel in the client stage and a clipped
``DPConfig`` through the release kernel. It then serves the same trace on
the plain path and compares, profiles the device's busy share over one
serve, checks the card's answers against the CPU on a small trace, and times
each serving kernel against its plain version and against the plan it beat.

Then it drives the training path, the paper's experiment through
``SplitSession.fit`` on the card: the COVID-CT CNN at its published width
trained e2e by three hospitals with ``privacy_conv`` in every client stage
(3 launches a step) and the guard's ``dp_release`` (one call a step over
the 63 rows), counted apart from ``evaluate``, with the plans that ran, the
budget, a save/restore round trip that continues bit for bit, and every
step of a kernel run retaken from the same state by the plain path on the
card and on the CPU at the calibrated sigma, and by the plain path on the
card at sigma 0, where the features are not drowned in noise (the gate:
metrics within ``TRAIN_TOL``, gradients within ``GRAD_TOL``); MURA VGG19
at 224x224 trained detached with ``dp_release`` at the
``[63, 112, 112, 64]`` cut, its first step's loss against the plain
guard's; the README quickstart in torch; and the steps per second of the
COVID-CT step with the kernels on and off, with the kernels' device time a
step. The ``kernels`` line gives each kernel's launches on the serving path
and on the training path.

Then it drives the queue path, the paper's Fig. 1 protocol through
``SplitSession(engine="protocol-async" | "fused-queue").fit``: the COVID-CT
CNN at its published width, detached, three hospitals pushing guarded
releases into a 64-item queue, fleet production running each production
cycle as ONE banked ``privacy_conv`` launch (every item on its hospital's
bank; checked bit for bit against one unbanked launch an item) and one
``dp_release`` call, at the calibrated sigma and at sigma 0
(``queue_covid``: launches per cycle or per release, releases and budget
equal to the planner's counts, fused-queue = protocol-async and fleet =
per-item bit for bit, every release against the plain fleet forward on the
card and the CPU, every trunk step retaken from its state, a bit-for-bit
restore, the CPU run's accounting); under a chaos ``FaultPlan`` equal to
the CPU run, and a quorum halt (``queue_faults``); with client threads
(``queue_threaded``: conservation, and a client's exception surfacing as
``ClientLoopError``); and times the banked launch and the four engine and
production pairs (``queue_time``).

Then it drives FedAvg, the paper's Table 5 baseline, through
``SplitSession(engine="fedavg")``: three hospitals each train the full
COVID-CT CNN at its published width on local batches of 32, the guard at
the cut (``fedavg_covid``: one ``privacy_conv`` launch and one
``dp_release`` call a local step, 30 of each in 2 rounds x 5 local steps,
``evaluate`` counted apart and printed beside train_covid's, the budget at
10 releases, each round's average recomputed on the CPU, a bit-for-bit
restore, and every local step retaken from its state by the plain path on
the card and the CPU at the calibrated sigma and on the card at sigma 0);
then the inversion audit of the trained privacy layer (``audit_covid``:
``SplitSession.audit_privacy`` over sigma 0, 0.5 and 4 with 120 attack
steps each, 363 ``privacy_conv`` launches, and ``guard_noise_sweep(...,
use_kernel=True)`` with its 3 ``dp_release`` releases; every attack step
retaken on the plain card and CPU paths with the flipped signs of the
gradient counted, and the sweeps' reconstructions held against the
session's: on the card within float32 rounding, below one flipped sign,
and on the CPU within the spread read over 16 start points by
``tools/audit_spread.py``); and times the local step and the attack
step with the kernels on and off, and both kernels at the slice's shapes
(``fedavg_time``).

Then it drives the LM path, the LM kernels' public entry points
``flash_attention`` and ``selective_scan``, at the full widths of the repo's
LM configs (llama3.2-1b, mixtral-8x7b with its sliding window,
hubert-xlarge bidirectional with a ragged S, falcon-mamba-7b's scan), holds
each output against its plain version on the card and small float32 and
bfloat16 cases against the CPU, and times the attention cases (the bfloat16
ones beside SDPA) and the scan, each tile or lane choice of a kernel against
the one it beat.

Then it drives the LM workload at llama3.2-1b's published width (16
layers, d 2048, 32 heads over 8 kv heads, vocab 128,256), float32: the
decode driver ``launch.serve.prefill_and_decode`` at temperature 0 with
batch 4, prompt 64 and 32 tokens, twice (bit-equal streams), its
teacher-forced replay against the CPU's (``lm_decode``); LM split learning
through ``SplitSession(engine="llm-split")`` by three hospitals, one
512-token window each a step, the clipped guard through ``dp_release`` at
the ``[3, 512, 2048]`` cut (one call a step, 6 in 2 x 3 steps; the budget
at 6), ``evaluate``, a save/restore that continues bit for bit
(``lm_train``, ``lm_restore``), every step of a 6-step plan retaken from
one state by the plain release on the card at the calibrated sigma and at
sigma 0 and one step by the CPU (``lm_forced``); the train steps per
second with the kernel on and off, the decode's tokens per second and
``dp_release`` at the LM cut (``lm_time``); and one e2e step, gradients
into the banks through the release's plain backward (``lm_train_e2e``).
Each LM phase prints the card's peak memory.

Then the same phases for the MoE and SSM families (``LM_SPECS``):
granite-moe-1b-a400m at its published width and depth (24 layers, 32
experts top 8; ``moe_decode``, ``moe_train``, ``moe_restore``,
``moe_forced``, ``moe_time``; the cut ``[3, 512, 1024]``) and
falcon-mamba-7b at its published width cut to 12 of its 64 layers
(``ssm_*``, the cut ``[3, 256, 4096]``, and ``ssm_remat``: one step's
gradient with each group recomputed equals the gradient without, bit for
bit, and the peak each adds); then ``hybrid``: jamba-1.5-large-398b's layer
pattern (attention at 4 of every 8 layers, MoE every other layer) at its
reduced widths, decoded bit-equal and against the CPU, and one
``llm-split`` step against the CPU. Every comparison of a MoE model
between two runs compares each token's top-K experts first
(``Routing``): a flip is accepted only at a near tie (``ROUTING_EPS``),
is printed, and then leaves that decode row out of the logits compared,
or has the second run retaken with the first run's routing before the
gradients are compared. ``check`` also holds both serving kernels in
bfloat16 and float16 (the COVID-CT shapes and the LM cut) to their plain
versions within one ulp and bit for bit on relaunch, and times them.

It prints one JSON object per phase and a ``kernels`` line
with every ported kernel (with its launches on the serving, training,
queue, FedAvg, audit and LM paths, the MoE, SSM and hybrid ones among
them, and the half-type cases). The last line is ``{"ok": true, "device": ...}``.

Any failed phase raises and the script exits non-zero; so does a machine
without a CUDA card. The weights are random, drawn from seed 0. TF32 is off
for cuDNN and matmuls, so every comparison is float32 against float32.
Checkpoints go to a temporary directory under ``build/``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.common.device import seeded_generator  # noqa: E402
from repro_torch.common.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import CHOLESTEROL_MLP, COVID_CNN, MURA_VGG19, get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ClientLoopError,
    FaultPlan,
    SplitSession,
    SplitTrainConfig,
)
from repro_torch.core import fedavg as fedavg_mod  # noqa: E402
from repro_torch.core.adapters import cnn_adapter, mlp_adapter  # noqa: E402
from repro_torch.core.distributed import llm_adapter, llm_step_parts  # noqa: E402
from repro_torch.core.protocol import (  # noqa: E402
    _plan_round_robin_cycle,
    make_fleet_release_fwd,
)
from repro_torch.core.trainer import (  # noqa: E402
    SamplePlan,
    device_put_shards,
    make_epoch_runner,
    make_sample_plan,
    make_server_step,
)
from repro_torch.data import (  # noqa: E402
    make_cholesterol,
    make_covid_ct,
    make_mura,
    split_clients,
    train_val_test_split,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.dp_release import ops as dp_ops  # noqa: E402
from repro_torch.kernels.dp_release.ref import dp_release_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_mask  # noqa: E402
from repro_torch.kernels.privacy_conv import ops as pc_ops  # noqa: E402
from repro_torch.kernels.privacy_conv.ref import (  # noqa: E402
    privacy_conv_banked_ref,
    privacy_conv_ref,
)
from repro_torch.kernels.selective_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.selective_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import lm_shards  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.transformer import ModelOptions, stack_split  # noqa: E402
from repro_torch.optim import adamw, linear_warmup_cosine  # noqa: E402
from repro_torch.privacy import DPConfig, PrivacyGuard, composed_epsilon  # noqa: E402
from repro_torch.privacy import audit as audit_mod  # noqa: E402
from repro_torch.privacy.audit import guard_noise_sweep, invert_features  # noqa: E402
from repro_torch.serving import SplitInferenceServer, poisson_trace  # noqa: E402

TOP_K = moe_mod._top_k  # the routing's own top-k, which ``Routing`` wraps

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
# Cin 3, 1 and 20) at H, W that are no multiples of the 16-pixel tile;
# "train_covid" is a client's batch of train_covid's step (21 of 63 rows);
# "fedavg_local" a FedAvg local batch and "audit" the attacked images, both
# without model noise (FedAvg's and the attack's client forward draw none)
CONV_CASES = {"covid": (64, 64, 64, 1, 16, 0.05), "train_covid": (21, 64, 64, 1, 16, 0.05),
              "fedavg_local": (32, 64, 64, 1, 16, 0.0), "audit": (4, 64, 64, 1, 16, 0.0),
              "table1": (64, 32, 32, 3, 16, 0.05),
              "cin16": (8, 32, 32, 16, 32, 0.0), "cin40": (2, 34, 16, 40, 36, 0.1),
              "cin3_cout5": (3, 10, 14, 3, 5, 0.1), "cin1_cout6": (2, 18, 22, 1, 6, 0.1),
              "cin20_cout7": (2, 12, 20, 20, 7, 0.1)}
# banked privacy_conv check cases (N, b, H, W, Cin, Cout, noise_scale, cids,
# banks): "fleet_covid" is one production cycle of queue_covid (quanta
# round(shares * 10) = 7/2/1 items of the 21-row client batch, the COVID-CT
# client stage), then the generic-Cin variant (float4) and the scalar one
BANKED_CASES = {
    "fleet_covid": (10, 21, 64, 64, 1, 16, 0.05, (0,) * 7 + (1,) * 2 + (2,), 3),
    "generic": (4, 3, 32, 32, 16, 32, 0.1, (2, 0, 1, 2), 3),
    "scalar": (3, 2, 10, 14, 3, 5, 0.1, (1, 0, 1), 2)}
SHARES = (0.7, 0.2, 0.1)
# the queue phases: 2 epochs of 10 server steps through a 64-item queue (one
# production cycle of 7/2/1 items an epoch), and the chaos plan of
# queue_faults: hospital 1 down for steps 4-8, a third of the fleet down for
# the first 3 steps of every 10, hospital 2 at half rate, 5% of releases
# dropped and 5% duplicated in transit, a quorum of one
QUEUE_EPOCHS, QUEUE_STEPS, QUEUE_SIZE = 2, 10, 64
CHAOS_PLAN = dict(n_clients=3, seed=0, crash_windows={1: [(4, 9)]}, dropout_frac=0.34,
                  dropout_period=10, dropout_down=3, straggle={2: 2.0}, drop_prob=0.05,
                  dup_prob=0.05, halt_below=1)
REQUEST_BATCH = 64  # one chest-CT study of 64 slices; the paper's batch size
MAX_BATCH = 8
# training: per-step losses and every leaf of the trained state, the kernel
# run against the plain run on the card and against the CPU (TF32 off):
# float32 sums in another order (the kernels', cuDNN's and the CPU's)
# carried through ten steps of the trunk, its backward and AdamW, the
# serving tolerance of the logits
TRAIN_TOL = dict(atol=1e-4, rtol=1e-4)
COVID_EPOCHS, COVID_STEPS = 2, 5  # train_covid: 2 epochs of 5 steps
MURA_STEPS = 3
TIME_ROUNDS = 5  # train_time: epochs a path, in turns
ADAM_B1 = 0.9  # adamw's default first-moment decay
# gradients of one step from one state, relative L2 error: float32 rounding
# alone gives ~1e-6; each ReLU or max-pool decision that the rounding flips
# moves one position's contribution, a few sparse elements (the CPU against
# an H100 at one step: 78 of 458,305 elements apart by up to 5.6e-5)
GRAD_TOL = 1e-3
# FedAvg (fedavg_covid): 2 rounds x 5 local steps of batch 32 a hospital;
# the audit (audit_covid): 4 images, 120 attack steps a sigma, the step of
# privacy/audit.py (lr 0.05, sign term lr * 0.01), whose flipped sign(g)
# moves an element by SIGN_STEP; the sweep's largest sigma for the release
# check; attack steps a timed call
FEDAVG_ROUNDS, FEDAVG_STEPS, LOCAL_BATCH = 2, 5, 32
AUDIT_SIGMAS, AUDIT_STEPS, AUDIT_ROWS = (0.0, 0.5, 4.0), 120, 4
ATTACK_LR = 0.05
SIGN_STEP = 2 * ATTACK_LR * 0.01
AUDIT_RELEASE_SIGMA = 4.0
ATTACK_TIME_STEPS = 40
# the audit sweeps against the session's (kernel) sweep, whole 120-step
# attacks. On the card no sign of g flips (the forced steps) and the
# reconstructions part by float32 rounding alone: 2.98e-8 in L1 at most
# over the 16 start points of tools/audit_spread.py. The limit sits 30x above that and 1000x below one flipped
# sign's displacement (SIGN_STEP), so a single flip fails it.
AUDIT_CARD_L1 = 1e-6
# Against the CPU signs do flip (up to 3 a step), and a flip does not stay
# one element: through the coupling of the gradient it spreads over
# thousands (23 flips left 8,154 elements parted), so no flip count bounds
# the spread. The limits are read instead: the largest of each quantity
# over the 16 start-point seeds of tools/audit_spread.py (every row, on an
# H100 80GB HBM3 at 700 W: L1 15.954905, MSE 4.6744943e-5, PSNR
# 2.9840470e-3 dB, NCC 6.5067783e-3), times 3, rounded up.
AUDIT_CPU_SPREAD = {"l1": 48.0, "mse": 1.5e-4, "psnr_db": 9e-3, "ncc": 2e-2}
# the serving kernels' half types: bfloat16 and float16 in, float32 sums,
# the input's type out (as the TPU kernels); mantissa bits of each, for the
# one-ulp gate of the check (kernel against its plain version, both
# rounding a float32 value once)
HALF_MANT = {torch.bfloat16: 7, torch.float16: 10}


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


def banked_case(gen, N, b, H, W, cin, cout, cids, banks, dev):
    """x [N,b,H,W,Cin], stacked banks w [C,3,3,Cin,Cout] and b [C,Cout],
    cids [N] int32 and noise [N,b,H/2,W/2,Cout], drawn on the CPU."""
    return ((torch.rand((N, b, H, W, cin), generator=gen)).to(dev),
            (0.3 * torch.randn((banks, 3, 3, cin, cout), generator=gen)).to(dev),
            (0.1 * torch.randn((banks, cout), generator=gen)).to(dev),
            torch.tensor(cids, dtype=torch.int32, device=dev),
            torch.randn((N, b, H // 2, W // 2, cout), generator=gen).to(dev))


def check_banked(gen, dev, errs: dict) -> dict:
    """The banked privacy_conv cases: each held against the plain banked
    version within KERNEL_TOL, bit for bit against one unbanked launch an
    item on the item's bank, and bit for bit on relaunch. Returns the
    inputs of each case."""
    inputs = {}
    for case, (N, b, H, W, cin, cout, scale, cids, banks) in BANKED_CASES.items():
        x, w, bb, c, nz = inputs[case] = banked_case(gen, N, b, H, W, cin, cout, cids, banks,
                                                      dev)
        plan = pc_ops.plan_for(x, w, nz, scale)
        got = pc_ops.privacy_conv_banked_forward(x, w, bb, c, nz, scale)
        again = pc_ops.privacy_conv_banked_forward(x, w, bb, c, nz, scale)
        items = torch.stack([pc_ops.privacy_conv_forward(x[n], w[k], bb[k], nz[n], scale)
                             for n, k in enumerate(cids)])
        item_plans = {tuple(sorted(pc_ops.plan_for(x[n], w[k], nz[n], scale).items()))
                      for n, k in enumerate(cids)}
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"privacy_conv_banked/{case}: a relaunch gave other bits")
        if not torch.equal(got, items):
            raise AssertionError(f"privacy_conv_banked/{case}: differs from {N} unbanked "
                                 f"launches by {float((got - items).abs().max())}")
        err = max_err(got, privacy_conv_banked_ref(x, w, bb, c, nz, noise_scale=scale),
                      **KERNEL_TOL, what=f"privacy_conv_banked/{case}")
        errs[f"privacy_conv_banked/{case}"] = err
        emit({"phase": "check", "case": f"privacy_conv_banked/{case}",
              "shape": [N, b, H, W, cin, cout], "cids": list(cids), "banks": banks,
              "noise_scale": scale, "plan": plan,
              "unbanked_plans": [dict(p) for p in item_plans],
              "bit_identical_unbanked": True, "bit_identical_relaunch": True,
              "max_abs_err": err, **KERNEL_TOL})
    return inputs


def conv_work(B, H, W, cin, cout, scale, esize: int = 4) -> dict:
    out = B * (H // 2) * (W // 2) * cout
    # at noise_scale 0 the kernel never reads the noise (privacy_conv.cu
    # sets it to null), so its bytes and multiply-add count only above 0;
    # ``esize`` bytes an element (2 for the half types)
    noisy = scale > 0
    nbytes = esize * (B * H * W * cin + 9 * cin * cout + cout + (2 if noisy else 1) * out)
    # 9*Cin multiply-adds per pre-pool value, bias and ReLU on each, then
    # three max (and the noise multiply-add) per pooled value
    flops = B * H * W * cout * (2 * 9 * cin + 2) + out * (5 if noisy else 3)
    return bound(nbytes, flops)


def release_cases(sigma: float) -> dict:
    """``{case: (shape, sigma)}`` of the check phase: the serving cut (k = 1)
    and the MURA cut (k > 1) with and without noise, the training path's
    releases (63 rows a step: train_covid's cut, k = 1, and train_mura's,
    k = 3) with and without noise, F % 4 != 0 (scalar) and B = 1 on
    each side of the split, the queue's cycle, a FedAvg local step's
    release (32 rows, k = 1) with and without noise, the audit's (4 rows
    at the sweep's largest sigma), and the cut of each LM path (3 rows
    of seq x d: llama3.2-1b's 512 x 2048, granite-moe-1b-a400m's 512 x
    1024 and falcon-mamba-7b's 256 x 4096, k > 1) with and without
    noise."""
    return {"covid_sigma0": ((64, 32, 32, 16), 0.0), "covid": ((64, 32, 32, 16), sigma),
            "mura": ((8, 112, 112, 64), sigma), "mura_sigma0": ((8, 112, 112, 64), 0.0),
            "train_covid": ((63, 32, 32, 16), sigma),
            "train_covid_sigma0": ((63, 32, 32, 16), 0.0),
            "train_mura": ((63, 112, 112, 64), sigma),
            "train_mura_sigma0": ((63, 112, 112, 64), 0.0),
            "odd_f_split": ((2, 50001), sigma), "odd_f_split_sigma0": ((2, 50001), 0.0),
            "odd_f": ((5, 7, 5), sigma), "odd_f_sigma0": ((5, 7, 5), 0.0),
            "b1_split": ((1, 112, 112, 64), sigma), "b1": ((1, 100), sigma),
            "fleet_cycle": ((210, 32, 32, 16), sigma),
            "fedavg_local": ((32, 32, 32, 16), sigma),
            "fedavg_local_sigma0": ((32, 32, 32, 16), 0.0),
            "audit": ((4, 32, 32, 16), AUDIT_RELEASE_SIGMA),
            **{f"{p}_cut{s}": ((3, spec.seq, spec_config(spec).d_model), sig)
               for p, spec in LM_SPECS.items() for s, sig in (("", sigma), ("_sigma0", 0.0))}}


def check_releases(gen, dev, cases: dict, errs: dict) -> tuple:
    """``check`` for dp_release: each of ``cases`` (``release_cases``) on
    inputs drawn from ``gen``, launched twice (identical bits) and held
    against its plain version; the errors go into ``errs``. Returns the
    inputs by case and the set of (k > 1, float4, noise) plans seen."""
    inputs, seen = {}, set()
    for case, (shape, s) in cases.items():
        x = torch.randn(shape, generator=gen).to(dev)
        nz = torch.randn(shape, generator=gen).to(dev)
        inputs[case] = (x, nz)
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
    return inputs, seen


def half_gate(got: torch.Tensor, want: torch.Tensor, dtype, what: str) -> float:
    """``got`` within one ulp of the half type ``dtype`` (at the larger of
    the two values; float16's subnormal step at its smallest) beyond
    KERNEL_TOL of ``want``: each side rounds a float32 value once, and the
    two float32 values part by up to KERNEL_TOL (sums in another order;
    cuDNN's conv algorithm), which near a value that the noise all but
    cancels is more than an ulp of that small value. Returns the largest
    difference in ulps."""
    g, w = got.float(), want.float()
    floor = 2.0 ** (-24 if dtype == torch.float16 else -133)

    def ulp(v):
        e = torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126)))
        return torch.exp2(e - HALF_MANT[dtype]).clamp(min=floor)

    one = torch.maximum(ulp(g), ulp(w))
    bad = (g - w).abs() > one + KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * w.abs()
    if not torch.isfinite(g).all() or bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond one ulp and "
                             f"KERNEL_TOL of the plain version")
    return float(((g - w).abs() / one).max())


def check_half(gen, dev, errs: dict, sigma: float) -> dict:
    """``check`` for the serving kernels' half types: each kernel in
    bfloat16 and float16 at the COVID-CT shapes (privacy_conv's client
    stage ``[64, 64, 64, 1]`` -> 16 channels; dp_release's serving cut
    ``[64, 32, 32, 16]``, 16,384 features a row) and dp_release at
    llama3.2-1b's LM cut ``[3, 512, 2048]`` (with and without noise); each
    launched twice (identical bits) and held to its plain version within
    one ulp of the type beyond the float32 tolerance (``half_gate``).
    Returns ``{case: (kernel, plain, work, dtype)}``
    for ``time_half``."""
    B, H, W, cin, cout, scale = CONV_CASES["covid"]
    conv = conv_case(gen, B, H, W, cin, cout, dev)
    lm_shape = (3, LM_SPECS["lm"].seq, spec_config(LM_SPECS["lm"]).d_model)
    rel = {"covid": ((64, 32, 32, 16), sigma), "lm_cut": (lm_shape, sigma),
           "lm_cut_sigma0": (lm_shape, 0.0)}
    rel_in = {k: (torch.randn(shape, generator=gen).to(dev), torch.randn(shape, generator=gen)
                  .to(dev)) for k, (shape, _) in rel.items()}
    out = {}
    for dt in HALF_MANT:
        name = str(dt).removeprefix("torch.")
        x, w, b, nz = (t.to(dt) for t in conv)
        kernel = (lambda x=x, w=w, b=b, nz=nz: pc_ops.privacy_conv_forward(x, w, b, nz, scale))
        plain = (lambda x=x, w=w, b=b, nz=nz: privacy_conv_ref(x, w, b, nz, noise_scale=scale))
        out[f"privacy_conv/covid/{name}"] = (kernel, plain, conv_work(B, H, W, cin, cout, scale,
                                                                      esize=2), dt,
                                             pc_ops.plan_for(x, w, nz, scale))
        for case, (shape, s) in rel.items():
            xr, nr = (t.to(dt) for t in rel_in[case])
            out[f"dp_release/{case}/{name}"] = (
                lambda xr=xr, nr=nr, s=s: dp_ops.dp_release_forward(xr, nr, 1.0, s),
                lambda xr=xr, nr=nr, s=s: dp_release_ref(xr, nr, clip_norm=1.0, sigma=s),
                release_work(shape, s, esize=2), dt, dp_ops.plan_for(xr, nr, s))
    for case, (kernel, plain, work, dt, plan) in out.items():
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if got.dtype != dt or not torch.equal(got, again):
            raise AssertionError(f"{case}: dtype {got.dtype} or a relaunch gave other bits")
        want = plain()
        u = half_gate(got, want, dt, case)
        errs[case] = float((got.float() - want.float()).abs().max())
        emit({"phase": "check", "case": case, "dtype": str(dt).removeprefix("torch."),
              "shape": list(got.shape), "plan": plan, "bit_identical_relaunch": True,
              "max_ulps": u, "tol": "one ulp beyond KERNEL_TOL", **KERNEL_TOL,
              "max_abs_err": errs[case]})
        out[case] = (kernel, plain, work, dt, plan, u)
    return out


def time_half(smi: str, cases: dict) -> dict:
    """Each half-type case of ``check_half``: kernel and plain device ms in
    turns, and its bound (2 bytes an element)."""
    timed = {}
    for case, (kernel, plain, work, dt, plan, u) in cases.items():
        k_ms, p_ms = paired_ms(kernel, plain)
        timed[case] = t = {"case": case, "dtype": str(dt).removeprefix("torch."), "ms": k_ms,
                           "plain_ms": p_ms, "plan": plan, "max_ulps": u, "library_ms": None,
                           **work, "bound_share": work["bound_ms"] / k_ms}
        emit({"phase": "time", "card": smi, **t})
    return timed


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


def release_work(shape, sigma: float, esize: int = 4) -> dict:
    n = int(np.prod(shape))
    nbytes = esize * n * (3 if sigma > 0 else 2)
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


def tree_diff(a, b) -> float:
    """The largest absolute difference between two trees of tensors."""
    return max(float((x.detach().cpu() - y.detach().cpu()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def reset_counts() -> None:
    pc_ops.launches = dp_ops.launches = 0
    pc_ops.plans.clear()
    dp_ops.plans.clear()


def kernel_counts() -> dict:
    """Launches and the plans run since :func:`reset_counts`."""
    return {name: {"launches": ops.launches,
                   "plans": [{"plan": dict(k), "calls": n} for k, n in ops.plans.items()]}
            for name, ops in (("privacy_conv", pc_ops), ("dp_release", dp_ops))}


def covid_session(on: bool, device, noise_scale=None) -> SplitSession:
    """The COVID-CT CNN at its published width, trained e2e with the guard
    at epsilon 1 (examples/covid_ct_split.py: server batch 64, adamw(1e-3));
    ``on`` routes the client stage and the release through the kernels;
    ``noise_scale`` pins the guard's sigma (``None``: calibrated to epsilon)."""
    cfg = dataclasses.replace(COVID_CNN, use_kernel=on)
    dp = DPConfig(epsilon=1.0, delta=1e-5, clip_norm=1.0, use_kernel=on,
                  noise_scale=noise_scale)
    tc = SplitTrainConfig(server_batch=64, mode="e2e", privacy=dp)
    return SplitSession(cnn_adapter(cfg), tc, adamw(1e-3), engine="auto", seed=0, device=device)


def step_losses(session) -> list:
    return [float(v) for m in session.step_metrics for v in m["loss"]]


def train_covid(dev, smi: str, tmp: str) -> dict:
    """The phases ``train_covid``, ``train_restore`` and ``train_forced``:
    the training main path with both kernels, counted; a save/restore round
    trip; and each step of a kernel run retaken by the plain path on the
    card and on the CPU at the calibrated sigma, and on the card at sigma
    0. cuDNN runs
    in its deterministic mode throughout, so that a rerun gives the same
    bits. Returns the path's launch counts."""
    shards = split_clients(*make_covid_ct(600, hw=64, seed=0), shares=SHARES)
    xt, yt = make_covid_ct(128, hw=64, seed=1)
    n = COVID_EPOCHS * COVID_STEPS
    torch.backends.cudnn.deterministic = True  # until the end of train_forced
    session = covid_session(True, dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    session.fit(shards, epochs=COVID_EPOCHS, steps_per_epoch=COVID_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = kernel_counts()
    # one privacy_conv launch a client a step; one dp_release call a step
    # over the 3 x 21 rows (one launch at k = 1, two at k > 1)
    (release,) = ran["dp_release"]["plans"]
    (conv,) = ran["privacy_conv"]["plans"]
    want = {"privacy_conv": 3 * n, "dp_release": n * release["plan"]["launches"]}
    got = {k: v["launches"] for k, v in ran.items()}
    if got != want or release["calls"] != n or conv["calls"] != 3 * n:
        raise AssertionError(f"training launches {ran}, want {want}")
    losses = step_losses(session)
    if len(losses) != n or not np.isfinite(losses).all():
        raise AssertionError(f"per-step losses {losses}")
    report = session.privacy_report()
    if report["releases"] != n:
        raise AssertionError(f"budget counts {report['releases']} releases, want {n}")
    path = session.save(os.path.join(tmp, "covid"))
    reset_counts()
    ev = session.evaluate(xt, yt)
    eval_counts = {k: v["launches"] for k, v in kernel_counts().items()}
    if eval_counts != {"privacy_conv": 3, "dp_release": 0}:  # a bank a pass, no release
        raise AssertionError(f"evaluate launches {eval_counts}")
    emit({"phase": "train_covid", "card": smi, "model": COVID_CNN.name, "mode": "e2e",
          "engine": "auto", "epochs": COVID_EPOCHS, "steps_per_epoch": COVID_STEPS,
          "rows_per_step": 63, "sigma": report["sigma"], "tf32": False, "wall_s": wall,
          "step_losses": losses, "launches": got, "plans": ran,
          "privacy": {k: report[k] for k in ("releases", "basic_epsilon", "advanced_epsilon",
                                             "epsilon_basic_carried")},
          "evaluate": {k: ev[k] for k in ("loss", "accuracy")}, "evaluate_launches": eval_counts})

    # ---- train_restore: the run continues one epoch; a session restored
    # from its checkpoint continues the same epoch, bit for bit (cuDNN in
    # its deterministic mode for this phase)
    session.fit(shards, epochs=1, steps_per_epoch=COVID_STEPS)
    restored = covid_session(True, dev)
    manifest = restored.restore(path)
    restored.fit(shards, epochs=1, steps_per_epoch=COVID_STEPS)
    a, b = session.state, restored.state
    if not all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b))):
        raise AssertionError(f"the restored run differs: max abs err {tree_diff(b, a)}")
    if (step_losses(restored) != step_losses(session)
            or manifest["metadata"]["epochs_done"] != COVID_EPOCHS):
        raise AssertionError("restored losses or epoch count differ")
    emit({"phase": "train_restore", "epochs_done_restored": manifest["metadata"]["epochs_done"],
          "bit_identical": True, "step_losses": step_losses(restored),
          "releases": restored.privacy_report()["releases"]})

    forced = {"calibrated": train_forced(dev, shards, None, ("plain_card", "cpu")),
              "sigma0": train_forced(dev, shards, 0.0, ("plain_card",))}
    torch.backends.cudnn.deterministic = False
    return {"covid": want, "shards": shards, "forced": forced,
            "evaluate": {k: ev[k] for k in ("loss", "accuracy")}}


def train_forced(dev, shards, noise_scale, against) -> dict:
    """``train_forced``: the gate of the kernel run against the plain run on
    the card (``"plain_card"``) and on the CPU (``"cpu"``), the paths named
    in ``against``. Along a kernel run of 10 steps (one CPU plan), every
    path takes each step from the SAME state, and is held to:

    - its loss, accuracy and gradient norm within TRAIN_TOL of the kernel
      step's;
    - its gradient (read back from AdamW's first moment, ``(mu' - b1 mu) /
      (1 - b1)``) within GRAD_TOL of the kernel step's in relative L2 norm.

    ``noise_scale`` pins the guard's sigma (``None``: calibrated). At the
    calibrated sigma (9.69) the guard's noise, of norm about 1240 a row,
    swamps the clipped features (norm 1), so a kernel that lost the signal
    would move the loss less than TRAIN_TOL; at sigma 0 the loss follows
    the features, and the kernels are held against the plain path on the
    card, where nothing else differs. The card against the CPU is held at
    the calibrated sigma; at sigma 0 their gradients part by more than
    GRAD_TOL (PERF.md §6). The weights are not compared: AdamW's normalized step
    moves a weight by up to lr where a flipped ReLU or pool decision moved
    its gradient, whatever the gradient's size.
    """
    n = COVID_EPOCHS * COVID_STEPS
    paths = {"kernel": (True, dev), "plain_card": (False, dev),
             "cpu": (False, torch.device("cpu"))}
    paths = {k: v for k, v in paths.items() if k == "kernel" or k in against}
    runs = {}
    for name, (on, where) in paths.items():
        sess = covid_session(on, where, noise_scale)
        _, run = make_epoch_runner(sess.adapter, sess.config, sess.opt, 1, device=where)
        runs[name] = (run, device_put_shards(shards, where), where)
    state = covid_session(True, dev, noise_scale).state
    data_x, _, lens = device_put_shards(shards, "cpu")
    plan = make_sample_plan(sess.adapter, sess.config, n)(
        lens, tuple(data_x.shape[2:]), torch.Generator().manual_seed(5), "cpu")
    worst = {name: {"metrics": 0.0, "grad_rel_l2": 0.0, "grad_max_abs_err": 0.0}
             for name in paths if name != "kernel"}
    cut = lambda a: None if a is None else a[t:t + 1]  # noqa: E731
    losses = []
    reset_counts()
    for t in range(n):
        step = SamplePlan(cut(plan.idx), cut(plan.model_noise), cut(plan.guard_noise))
        out = {}
        for name, (run, (data_x, data_y, _), where) in runs.items():
            s0 = tree_map(lambda a: a.to(where), state)
            out[name] = run(s0, data_x, data_y, step.to(where))
        k_state, k_m = out["kernel"]
        losses.append(float(k_m["loss"].reshape(-1)[0]))
        mu0 = state["opt"]["mu"].cpu()
        k_grad = (k_state["opt"]["mu"].cpu() - ADAM_B1 * mu0) / (1 - ADAM_B1)
        for name, w in worst.items():
            o_state, o_m = out[name]
            for key in k_m:
                w["metrics"] = max(w["metrics"], max_err(o_m[key].cpu(), k_m[key].cpu(),
                                                         **TRAIN_TOL, what=f"{name} {key} {t}"))
            o_grad = (o_state["opt"]["mu"].cpu() - ADAM_B1 * mu0) / (1 - ADAM_B1)
            rel = float((o_grad - k_grad).norm() / k_grad.norm())
            if not rel <= GRAD_TOL:
                raise AssertionError(f"{name} step {t}: gradient relative L2 error {rel}")
            w["grad_rel_l2"] = max(w["grad_rel_l2"], rel)
            w["grad_max_abs_err"] = max(w["grad_max_abs_err"],
                                        float((o_grad - k_grad).abs().max()))
        state = k_state
    launches = {"privacy_conv": pc_ops.launches, "dp_release": dp_ops.launches}
    if launches != {"privacy_conv": 3 * n, "dp_release": n}:
        raise AssertionError(f"forced steps launched {launches}")
    sigma = PrivacyGuard(sess.config.privacy).sigma
    emit({"phase": "train_forced", "sigma": sigma, "steps": n, "kernel_launches": launches,
          "kernel_step_losses": losses,
          "max_err": worst, "tf32": False,
          "cudnn_deterministic": torch.backends.cudnn.deterministic, "grad_tol": GRAD_TOL,
          **TRAIN_TOL})
    return worst


def train_mura(dev, smi: str) -> dict:
    """MURA VGG19 at 224x224, detached, the guard through dp_release at the
    [b, 112, 112, 64] cut (examples/mura_xray.py: server batch 64,
    adamw(1e-3)); its first stage has two convs, so the privacy layer runs
    the plain convs even with use_kernel, as in the JAX package."""
    cfg = dataclasses.replace(MURA_VGG19, use_kernel=True)
    shards = split_clients(*make_mura(150, hw=cfg.input_hw[0], seed=0), shares=SHARES)
    cut = cnn_adapter(cfg).feature_shape((63,) + cfg.input_hw + (cfg.in_channels,))

    def session(on):
        tc = SplitTrainConfig(server_batch=64, mode="detached",
                              privacy=DPConfig(clip_norm=1.0, use_kernel=on))
        return SplitSession(cnn_adapter(cfg), tc, adamw(1e-3), engine="auto", seed=0,
                            device=dev)

    kernel = session(True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    kernel.fit(shards, epochs=1, steps_per_epoch=MURA_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = kernel_counts()
    (release,) = ran["dp_release"]["plans"]
    want = {"privacy_conv": 0, "dp_release": MURA_STEPS * release["plan"]["launches"]}
    got = {k: v["launches"] for k, v in ran.items()}
    if got != want or release["calls"] != MURA_STEPS:
        raise AssertionError(f"MURA launches {ran}, want {want}")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    if release["plan"] != dp_ops.release_plan(cut[0], math.prod(cut[1:]), sm_count):
        raise AssertionError(f"the release ran {release}, not the plan of the {cut} cut")
    losses = step_losses(kernel)
    del kernel
    plain = session(False)
    plain.fit(shards, epochs=1, steps_per_epoch=MURA_STEPS)
    plain_losses = step_losses(plain)
    del plain
    torch.cuda.empty_cache()
    if not np.isfinite(losses).all():
        raise AssertionError(f"MURA losses {losses}")
    err = max_err(torch.tensor(losses[:1]), torch.tensor(plain_losses[:1]), **TRAIN_TOL,
                  what="MURA first-step loss")
    emit({"phase": "train_mura", "card": smi, "model": MURA_VGG19.name, "mode": "detached",
          "steps": MURA_STEPS, "cut": list(cut), "wall_s": wall,
          "step_losses": losses, "plain_guard_step_losses": plain_losses,
          "max_abs_err_first_loss": err, "launches": got, "plans": ran, **TRAIN_TOL})
    return want


def quickstart(dev) -> None:
    """The README quickstart in torch, on the card."""
    x, y = make_cholesterol(500, seed=0)
    train, _val, test = train_val_test_split(x, y)
    shards = split_clients(*train, shares=SHARES)
    session = SplitSession(
        mlp_adapter(CHOLESTEROL_MLP),
        SplitTrainConfig(n_clients=3, data_shares=SHARES, server_batch=128),
        adamw(3e-3), engine="auto", device=dev)
    session.fit(shards, epochs=20, steps_per_epoch=10)
    metrics = session.evaluate(*test)
    got = {k: metrics[k] for k in ("msle", "rmsle", "smape")}
    if not np.isfinite(list(got.values())).all() or len(session.history) != 20:
        raise AssertionError(f"quickstart metrics {got}")
    emit({"phase": "quickstart", **got, "releases": session.privacy_report()["releases"],
          "first_epoch_loss": session.history[0]["loss"],
          "last_epoch_loss": session.history[-1]["loss"]})


def train_time(dev, smi: str, shards) -> dict:
    """Steps per second of train_covid's step, kernels on and off, epochs
    in turns on one state and one pre-drawn plan (the plan's draws are not
    timed), and the device time of the two kernels a step from the
    profiler."""
    runs = {}
    for on in (True, False):
        sess = covid_session(on, dev)
        _, run = make_epoch_runner(sess.adapter, sess.config, sess.opt, COVID_STEPS,
                                   device=dev)
        runs["kernel" if on else "plain"] = (run, sess.state)
    data_x, data_y, lens = device_put_shards(shards, dev)
    plan = make_sample_plan(sess.adapter, sess.config, COVID_STEPS)(
        lens, tuple(data_x.shape[2:]), torch.Generator().manual_seed(5), dev)

    def epoch(name):
        run, state = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state, data_x, data_y, plan)
        torch.cuda.synchronize()
        return COVID_STEPS / (time.perf_counter() - t0)

    for name in runs:
        epoch(name)  # warm-up
    rates = {"kernel": [], "plain": []}
    for r in range(TIME_ROUNDS):
        for name in (("kernel", "plain") if r % 2 else ("plain", "kernel")):
            rates[name].append(epoch(name))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch("kernel")
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    per_step = {k: sum(e.self_device_time_total for e in dev_events if k in e.key)
                / 1e3 / COVID_STEPS for k in ("privacy_conv", "dp_release")}
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3 / COVID_STEPS
    emit({"phase": "train_time", "card": smi, "tf32": False, "steps_per_epoch": COVID_STEPS,
          "rounds": TIME_ROUNDS,
          **{f"{k}_steps_per_s": float(np.median(v)) for k, v in rates.items()},
          **{f"{k}_steps_per_s_all": v for k, v in rates.items()},
          "kernel_device_ms_per_step": per_step, "device_busy_ms_per_step": busy,
          "top": [{"name": e.key[:90], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]]})
    return per_step


# ==== the queue engines: protocol-async and fused-queue at COVID-CT width
class Recorder:
    """Wraps an engine's or a module's function, keeping each call's
    positional arguments and result (references: the functions do not
    mutate their inputs)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((args, out))
        return out


def queue_session(engine, dev, *, on=True, production="fleet", noise_scale=None,
                  **options) -> SplitSession:
    """The paper's Fig. 1 protocol at the COVID-CT CNN's published width:
    three hospitals (shares 0.7/0.2/0.1), detached, the guard at epsilon 1
    (``noise_scale`` pins its sigma), adamw(1e-3), server batch 64 (client
    batch 21), a 64-item queue, the deterministic drive; ``on`` routes the
    client stage and the release through the kernels."""
    cfg = dataclasses.replace(COVID_CNN, use_kernel=on)
    dp = DPConfig(epsilon=1.0, delta=1e-5, clip_norm=1.0, use_kernel=on,
                  noise_scale=noise_scale)
    tc = SplitTrainConfig(server_batch=64, mode="detached", privacy=dp)
    options.setdefault("threaded", False)
    return SplitSession(cnn_adapter(cfg), tc, adamw(1e-3), engine=engine, seed=0, device=dev,
                        production=production, queue_size=QUEUE_SIZE, **options)


def planned_drive(epochs: int, steps: int, queue_size: int = QUEUE_SIZE) -> dict:
    """The fault-free round-robin drive restated as counting with the
    planner (``protocol._plan_round_robin_cycle``), apart from the engines:
    each client's releases, the production cycles, drops and drains."""
    quanta = np.maximum(1, np.round(np.asarray(SHARES) * 10).astype(int)).tolist()
    qlen = step = cycles = dropped = drained = 0
    releases = [0] * len(quanta)
    for _ in range(epochs):
        target = step + steps
        while step < target:
            counts = _plan_round_robin_cycle(qlen, queue_size, step, target, quanta)
            cycles += any(counts)
            for c, n in enumerate(counts):
                releases[c] += n
                for _ in range(n):
                    if qlen < queue_size:
                        qlen += 1
                    elif step < target:
                        step, drained = step + 1, drained + 1
                    else:
                        dropped += 1
            d = min(qlen, target - step)
            qlen, step = qlen - d, step + d
    return {"releases_per_client": releases, "cycles": cycles, "dropped": dropped,
            "drained": drained}


def state_equal(a, b) -> bool:
    la, lb = tree_leaves(a.state), tree_leaves(b.state)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def queue_run(engine, dev, production, noise_scale, *, record=False):
    """One queue fit with the kernels on, its counts read around it. With
    ``record`` the engine's fleet forward and server step are recorded."""
    sess = queue_session(engine, dev, production=production, noise_scale=noise_scale)
    if record:
        sess.engine._fleet_fwd = Recorder(sess.engine._fleet_fwd)
        sess.engine._server_step = Recorder(sess.engine._server_step)
    shards = queue_shards()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sess.fit(shards, epochs=QUEUE_EPOCHS, steps_per_epoch=QUEUE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return sess, kernel_counts(), wall


def queue_shards():
    return split_clients(*make_covid_ct(600, hw=64, seed=0), shares=SHARES)


def check_queue_counts(sess, ran, production, what) -> dict:
    """One banked privacy_conv launch and one dp_release call a production
    cycle with the fleet; one of each a release per item. Returns the
    launches and calls."""
    rel = sess.fault_stats["releases_per_client"]
    items = sum(rel)
    conv_calls = sum(p["calls"] for p in ran["privacy_conv"]["plans"])
    dp_calls = sum(p["calls"] for p in ran["dp_release"]["plans"])
    if production == "fleet":
        want = sess.engine.fleet.dispatches
        if not all(p["plan"].get("banked") for p in ran["privacy_conv"]["plans"]):
            raise AssertionError(f"{what}: an unbanked privacy_conv launch on the fleet path")
    else:
        want = items
        if any(p["plan"].get("banked") for p in ran["privacy_conv"]["plans"]):
            raise AssertionError(f"{what}: a banked launch on the per-item path")
    if not (ran["privacy_conv"]["launches"] == conv_calls == dp_calls == want) or want == 0:
        raise AssertionError(f"{what}: launches {ran}, want {want} of each "
                             f"({production}, {items} releases)")
    return {"privacy_conv": ran["privacy_conv"]["launches"],
            "dp_release": ran["dp_release"]["launches"], "dp_release_calls": dp_calls}


def queue_covid(dev, smi: str, tmp: str) -> dict:
    """``queue_covid``: protocol-async and fused-queue, fleet and per-item,
    at the calibrated sigma and at sigma 0, 2 epochs of 10 server steps
    each, cuDNN deterministic. Gates: launches per production cycle (fleet)
    or release (per item); releases, cycles and the budget equal to the
    planner's counts; fused-queue = protocol-async and fleet = per-item bit
    for bit (losses and every state leaf); every release of the kernel run
    within KERNEL_TOL of the plain fleet forward on the card and on the CPU,
    on its draws; every trunk step retaken from its state with the plain
    releases on the card (and, at the calibrated sigma, with the CPU's on
    the CPU): loss within TRAIN_TOL, gradient within GRAD_TOL; a save and
    restore that continues bit for bit; and the same fit on the CPU, its
    accounting equal. Returns the launch counts and the fleet's cycle
    inputs."""
    torch.backends.cudnn.deterministic = True
    plan = planned_drive(QUEUE_EPOCHS, QUEUE_STEPS)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    b = 64 // len(SHARES)  # the client batch of server batch 64
    feats = 32 * 32 * COVID_CNN.stages[0][0]
    per_item_plan = dp_ops.release_plan(b, feats, sm_count)
    cycle_plan = dp_ops.release_plan(10 * b, feats, sm_count)
    if per_item_plan != cycle_plan:
        raise AssertionError(f"dp_release plans differ: {per_item_plan} per item, "
                             f"{cycle_plan} a cycle; fleet = per-item bits cannot hold")
    out = {"planned": plan, "sigma": {}}
    for label, noise_scale in (("calibrated", None), ("sigma0", 0.0)):
        runs, counts, walls = {}, {}, {}
        for engine in ("protocol-async", "fused-queue"):
            for production in ("fleet", "per-item"):
                key = f"{engine}/{production}"
                record = key == "protocol-async/fleet"
                sess, ran, walls[key] = queue_run(engine, dev, production, noise_scale,
                                                  record=record)
                counts[key] = check_queue_counts(sess, ran, production, key)
                runs[key] = sess
                fs, st = sess.fault_stats, sess.engine.stats
                if (fs["releases_per_client"] != plan["releases_per_client"]
                        or st["dropped"] != plan["dropped"] or st["drained"] != plan["drained"]
                        or (production == "fleet"
                            and sess.engine.fleet.dispatches != plan["cycles"])):
                    raise AssertionError(f"{key}: releases {fs['releases_per_client']}, "
                                         f"stats {st}; the planner gives {plan}")
                report = sess.privacy_report()
                if report["releases"] != max(plan["releases_per_client"]):
                    raise AssertionError(f"{key}: budget counts {report['releases']}")
                losses = sess.engine.losses
                if (len(losses) != QUEUE_EPOCHS * QUEUE_STEPS
                        or not np.isfinite(losses).all()):
                    raise AssertionError(f"{key}: losses {losses}")
        base = runs["protocol-async/fleet"]
        for key, sess in runs.items():
            if sess.engine.losses != base.engine.losses or not state_equal(sess, base):
                raise AssertionError(f"{label}: {key} differs from protocol-async/fleet")
            if sess.engine.stats != base.engine.stats:
                raise AssertionError(f"{label}: {key} stats differ")
        gate = queue_gate(base, cpu=noise_scale is None)
        sigma = PrivacyGuard(base.config.privacy).sigma
        emit({"phase": "queue_covid", "card": smi, "model": COVID_CNN.name, "mode": "detached",
              "sigma": sigma, "label": label, "epochs": QUEUE_EPOCHS,
              "steps_per_epoch": QUEUE_STEPS, "client_batch": b, "queue_size": QUEUE_SIZE,
              "planned": plan, "launches": counts,
              "dp_release_plan": {"per_item": per_item_plan, "cycle": cycle_plan},
              "bit_identical": {"fused_queue_vs_protocol_async": True,
                                "fleet_vs_per_item": True},
              "stats": {k: v for k, v in base.engine.stats.items() if k != "privacy"},
              "privacy": {k: v if math.isfinite(v) else str(v)  # sigma 0: no finite epsilon
                          for k, v in base.privacy_report().items()
                          if k in ("releases", "basic_epsilon", "advanced_epsilon")},
              "releases_per_client": base.fault_stats["releases_per_client"],
              "losses": base.engine.losses, "wall_s": walls, "tf32": False,
              "cudnn_deterministic": True, **gate})
        out["sigma"][label] = {"counts": counts, "gate": gate}
        if label == "calibrated":
            out["cycles"] = [args for args, _ in base.engine._fleet_fwd.calls]
            queue_cpu(base, plan)
            queue_restore(dev, base, tmp)
    torch.backends.cudnn.deterministic = False
    return out


def queue_gate(sess, cpu: bool) -> dict:
    """The release and trunk-step gates of a recorded kernel run (see
    :func:`queue_covid`)."""
    cfg = dataclasses.replace(COVID_CNN, use_kernel=False)
    plain_dp = dataclasses.replace(sess.config.privacy, use_kernel=False)
    plain_fleet = make_fleet_release_fwd(cnn_adapter(cfg), PrivacyGuard(plain_dp))
    to_cpu = lambda t: tree_map(lambda a: a.cpu(), t)  # noqa: E731
    kernel_rel, plain_rel, cpu_rel = [], [], []
    rel_err = {"plain_card": 0.0, "cpu": 0.0}
    reset_counts()
    for args, got in sess.engine._fleet_fwd.calls:
        plain = plain_fleet(*args)
        rel_err["plain_card"] = max(rel_err["plain_card"], max_err(
            got, plain, **KERNEL_TOL, what="release vs the plain fleet forward"))
        kernel_rel.append(got)
        plain_rel.append(plain)
        if cpu:
            on_cpu = plain_fleet(*to_cpu(args))
            rel_err["cpu"] = max(rel_err["cpu"], max_err(
                got.cpu(), on_cpu, **KERNEL_TOL, what="release vs the CPU"))
            cpu_rel.append(on_cpu)
    if pc_ops.launches or dp_ops.launches:
        raise AssertionError("the plain fleet forward launched a kernel")
    kernel_rel, plain_rel = torch.cat(kernel_rel), torch.cat(plain_rel)
    cpu_rel = torch.cat(cpu_rel) if cpu else None
    step_fn = make_server_step(sess.adapter, sess.opt, sess.config.grad_clip)
    worst = {k: {"loss": 0.0, "grad_rel_l2": 0.0} for k in
             (("plain_card", "cpu") if cpu else ("plain_card",))}
    for k, ((params, opt_state, step, f, y), (_, new_opt, loss)) in enumerate(
            sess.engine._server_step.calls):
        if not torch.equal(f, kernel_rel[k]):
            raise AssertionError(f"pop {k} is not the {k}-th release")
        # the step's clipped gradient, read back from AdamW's first moment
        mu0 = [m.cpu() for m in tree_leaves(opt_state["mu"])]
        grad = lambda o: torch.cat([  # noqa: E731
            ((m1.cpu() - ADAM_B1 * m0) / (1 - ADAM_B1)).reshape(-1)
            for m1, m0 in zip(tree_leaves(o["mu"]), mu0)])
        g_k = grad(new_opt)
        retake = {"plain_card": (params, opt_state, plain_rel[k], y)}
        if cpu:
            retake["cpu"] = (to_cpu(params), to_cpu(opt_state), cpu_rel[k], y.cpu())
        for name, (p0, o0, f0, y0) in retake.items():
            _, o2, loss2 = step_fn(p0, o0, step, f0, y0)
            g2 = grad(o2)
            err = max_err(loss2.reshape(1).cpu(), loss.reshape(1).cpu(), **TRAIN_TOL,
                          what=f"trunk step {k} loss, {name}")
            rel = float((g2 - g_k).norm() / g_k.norm())
            if not rel <= GRAD_TOL:
                raise AssertionError(f"trunk step {k}, {name}: gradient relative L2 {rel}")
            worst[name]["loss"] = max(worst[name]["loss"], err)
            worst[name]["grad_rel_l2"] = max(worst[name]["grad_rel_l2"], rel)
    return {"releases_checked": int(kernel_rel.shape[0]),
            "release_max_abs_err": rel_err if cpu else {"plain_card": rel_err["plain_card"]},
            "trunk_steps_checked": len(sess.engine._server_step.calls),
            "trunk_max_err": worst, "kernel_tol": KERNEL_TOL, "train_tol": TRAIN_TOL,
            "grad_tol": GRAD_TOL}


def queue_restore(dev, sess, tmp: str) -> None:
    """``queue_restore``: a protocol-async run saved after its fit continues
    one more epoch; a session restored from the checkpoint continues the
    same epoch, bit for bit."""
    path = sess.save(os.path.join(tmp, "queue"))
    shards = queue_shards()
    sess.fit(shards, epochs=1, steps_per_epoch=QUEUE_STEPS)
    restored = queue_session("protocol-async", dev)
    restored.restore(path)
    restored.fit(shards, epochs=1, steps_per_epoch=QUEUE_STEPS)
    if (restored.engine.losses != sess.engine.losses[-QUEUE_STEPS:]
            or not state_equal(restored, sess)):
        raise AssertionError("the restored queue run differs from the continued one")
    emit({"phase": "queue_restore", "step": int(restored.state["step"]), "bit_identical": True,
          "losses": restored.engine.losses,
          "releases": restored.privacy_report()["releases"]})


def queue_cpu(card, plan) -> None:
    """``queue_cpu``: the same protocol-async fleet fit on the CPU (plain
    versions): the accounting equals the card's exactly. Its losses are
    printed, not gated: AdamW carries float32 rounding through 20 steps."""
    t0 = time.perf_counter()
    cpu = queue_session("protocol-async", torch.device("cpu"), on=False)
    cpu.fit(queue_shards(), epochs=QUEUE_EPOCHS, steps_per_epoch=QUEUE_STEPS)
    wall = time.perf_counter() - t0
    first = card.engine.losses[:QUEUE_EPOCHS * QUEUE_STEPS]
    if (cpu.engine.stats != card.engine.stats or cpu.fault_stats != card.fault_stats
            or cpu.fault_stats["releases_per_client"] != plan["releases_per_client"]):
        raise AssertionError(f"CPU accounting {cpu.engine.stats} {cpu.fault_stats} differs "
                             f"from the card's {card.engine.stats} {card.fault_stats}")
    emit({"phase": "queue_cpu", "stats_equal": True, "fault_stats_equal": True,
          "wall_s": wall, "cpu_losses": cpu.engine.losses, "card_losses": first,
          "first_loss_abs_diff": abs(cpu.engine.losses[0] - first[0])})


def queue_faults(dev, smi: str) -> dict:
    """``queue_faults``: protocol-async, deterministic, at the same widths,
    under the chaos plan (transport faults: per-item production), on the
    card with the kernels and on the CPU with the plain versions:
    ``fault_stats``, the queue stats (``dropped``/``drained`` too) and the
    number of losses equal exactly; then a ``halt_below=3`` plan halts
    cleanly with the reference's reason, on both."""
    shards = queue_shards()
    out = {}
    for name, halt_below in (("chaos", 1), ("quorum", 3)):
        plan = FaultPlan(**{**CHAOS_PLAN, "halt_below": halt_below})
        runs = {}
        for name_, where, on in (("card", dev, True), ("cpu", torch.device("cpu"), False)):
            sess = queue_session("protocol-async", where, on=on)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            hist = sess.fit(shards, epochs=QUEUE_EPOCHS, steps_per_epoch=QUEUE_STEPS,
                            faults=plan)
            torch.cuda.synchronize()
            runs[name_] = (sess, hist, kernel_counts(), time.perf_counter() - t0)
        (card, hc, ran, wall), (cpu, hcpu, _, cpu_wall) = runs["card"], runs["cpu"]
        if (card.fault_stats != cpu.fault_stats or card.engine.stats != cpu.engine.stats
                or len(card.engine.losses) != len(cpu.engine.losses)
                or [h.get("halted") for h in hc] != [h.get("halted") for h in hcpu]):
            raise AssertionError(f"{name}: card {card.fault_stats} {card.engine.stats} != "
                                 f"CPU {cpu.fault_stats} {cpu.engine.stats}")
        fs = card.fault_stats
        if name == "chaos":
            if fs["halted"] or len(card.engine.losses) != QUEUE_EPOCHS * QUEUE_STEPS:
                raise AssertionError(f"chaos run halted or fell short: {fs}")
            if not sum(fs["down_cycles"]):
                raise AssertionError("the chaos plan took no client down")
            launches = check_queue_counts(card, ran, "per-item", "queue_faults")
        else:
            step = int(card.state["step"])
            up = sum(plan.up_mask(step))
            reason = f"quorum lost at step {step}: {up} up < halt_below={halt_below}"
            if not fs["halted"] or fs["halt_reason"] != reason or not hc[-1].get("halted"):
                raise AssertionError(f"quorum plan: {fs}, want the halt {reason!r}")
            launches = {k: v["launches"] for k, v in ran.items()}
        if card.privacy_report()["releases"] != max(fs["releases_per_client"]):
            raise AssertionError(f"{name}: the budget does not follow the worst client")
        emit({"phase": "queue_faults", "card": smi, "plan": name, "fault_stats": fs,
              "stats": {k: v for k, v in card.engine.stats.items() if k != "privacy"},
              "losses": len(card.engine.losses), "launches": launches,
              "equal_to_cpu": True, "wall_s": wall, "cpu_wall_s": cpu_wall})
        out[name] = launches
    return out


def queue_threaded(dev, smi: str) -> dict:
    """``queue_threaded``: protocol-async with client threads, fleet
    production in chunks of 4, 20 server steps. Arrival order is the OS's,
    so conservation is gated: pushed - popped is the queue's length, the
    releases are the chunks produced, the launches the dispatches, the
    budget the worst client's; then a client thread's exception (a raising
    ``noise_fn``) surfaces as ClientLoopError."""
    shards = queue_shards()
    sess = queue_session("protocol-async", dev, threaded=True, fleet_chunk=4,
                         pop_timeout=0.05)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sess.fit(shards, epochs=1, steps_per_epoch=2 * QUEUE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = kernel_counts()
    st, fs, eng = sess.engine.stats, sess.fault_stats, sess.engine
    rel = fs["releases_per_client"]
    dispatches = eng.fleet.dispatches
    checks = {
        "pushed_minus_popped_is_queue_length": st["pushed"] - st["popped"] == len(eng.queue),
        "popped_is_steps": st["popped"] == 2 * QUEUE_STEPS == int(sess.state["step"]),
        "releases_are_chunks": sum(rel) == 4 * dispatches,
        "launches_are_dispatches": (ran["privacy_conv"]["launches"] == dispatches
                                    == sum(p["calls"] for p in ran["dp_release"]["plans"])),
        "budget_follows_worst_client": sess.privacy_report()["releases"] == max(rel),
        "losses_finite": bool(np.isfinite(eng.losses).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"threaded drive: {checks}, stats {st}, releases {rel}, "
                             f"dispatches {dispatches}, launches {ran}")

    def failing_noise(client, release, model_shape, guard_shape):
        raise RuntimeError(f"no draws for client {client}")

    bad = queue_session("protocol-async", dev, threaded=True, fleet_chunk=4,
                        pop_timeout=0.05, noise_fn=failing_noise)
    try:
        bad.fit(shards, epochs=1, steps_per_epoch=2 * QUEUE_STEPS)
    except ClientLoopError as e:
        surfaced = {"client_id": e.client_id, "cause": repr(e.cause),
                    "fault_stats_error": bad.fault_stats["client_error"]}
    else:
        raise AssertionError("a raising client thread did not surface as ClientLoopError")
    emit({"phase": "queue_threaded", "card": smi, "fleet_chunk": 4, "wall_s": wall,
          "stats": {k: v for k, v in st.items() if k != "privacy"},
          "releases_per_client": rel, "dispatches": dispatches,
          "launches": {k: v["launches"] for k, v in ran.items()}, **checks,
          "client_error": surfaced})
    return {"privacy_conv": ran["privacy_conv"]["launches"],
            "dp_release": ran["dp_release"]["launches"]}


def queue_time(dev, smi: str, inputs: dict, cycle_release: tuple) -> dict:
    """``queue_time``: one production cycle's banked launch (device ms) with
    its bound, ten unbanked launches (device ms, in turns with it) and the
    plain banked version (host-fed); the cycle's dp_release call over
    ``[210, 32, 32, 16]``; and the wall server steps/s of protocol-async
    against fused-queue, fleet against per-item (one epoch of 10 steps
    each, 3 rounds in turns)."""
    N, b, H, W, cin, cout, scale, cids, _ = BANKED_CASES["fleet_covid"]
    x, w, bb, c, nz = inputs["fleet_covid"]
    banked = lambda: pc_ops.privacy_conv_banked_forward(x, w, bb, c, nz, scale)  # noqa: E731
    plain = lambda: privacy_conv_banked_ref(x, w, bb, c, nz, noise_scale=scale)  # noqa: E731
    unbanked = lambda: [pc_ops.privacy_conv_forward(x[n], w[k], bb[k], nz[n], scale)  # noqa
                        for n, k in enumerate(cids)]
    k_ms, u_ms = paired_ms(banked, unbanked)
    # the plain version reads cids on the host (a sync a call), so it cannot
    # be queued ahead of the device: host-fed time
    p_ms = float(np.median([host_fed_ms(plain, iters=20, warmup=int(r == 0))
                            for r in range(3)]))
    # the unbanked work of the N*b images, plus the other banks and the cids
    work = conv_work(N * b, H, W, cin, cout, scale)
    nbytes = work["bytes"] + 4 * ((w.shape[0] - 1) * (9 * cin * cout + cout) + len(cids))
    conv = {"case": "privacy_conv_banked/fleet_covid", "ms": k_ms, "plain_ms": p_ms,
            "plain_timer": "host_fed", "unbanked_x10_ms": u_ms, "plan": pc_ops.plan_for(x, w, nz, scale),
            "library_ms": None,
            "library_note": "no single PyTorch call computes a banked conv+bias+ReLU+pool+noise",
            **bound(nbytes, work["flops"])}
    xr, nr = cycle_release
    sigma = DPConfig().sigma
    r_ms, rp_ms = paired_ms(lambda: dp_ops.dp_release_forward(xr, nr, 1.0, sigma),
                            lambda: dp_release_ref(xr, nr, clip_norm=1.0, sigma=sigma))
    release = {"case": "dp_release/fleet_cycle", "shape": list(xr.shape), "ms": r_ms,
               "plain_ms": rp_ms, "plan": dp_ops.plan_for(xr, nr, sigma), "library_ms": None,
               **release_work(tuple(xr.shape), sigma)}
    for t in (conv, release):
        t["bound_share"] = t["bound_ms"] / t["ms"]
        emit({"phase": "time", "card": smi, **t})
    shards = queue_shards()
    rates = {f"{e}/{p}": [] for e in ("protocol-async", "fused-queue")
             for p in ("fleet", "per-item")}
    for r in range(3):
        for key in (rates if r % 2 == 0 else list(rates)[::-1]):
            engine, production = key.split("/")
            sess = queue_session(engine, dev, production=production)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.fit(shards, epochs=1, steps_per_epoch=QUEUE_STEPS)
            torch.cuda.synchronize()
            rates[key].append(QUEUE_STEPS / (time.perf_counter() - t0))
    emit({"phase": "queue_time", "card": smi, "steps_per_fit": QUEUE_STEPS, "rounds": 3,
          "note": "wall server steps/s of one fit each, session set-up excluded, host clock",
          **{f"{k}_steps_per_s": float(np.median(v)) for k, v in rates.items()},
          **{f"{k}_steps_per_s_all": v for k, v in rates.items()}})
    return {"privacy_conv": conv, "dp_release": release}


# ==== FedAvg (paper Table 5) and the inversion audit (paper §IV-D2)
def recording(obj, name):
    """``with recording(obj, "name") as rec:`` records ``obj.name`` (a
    :class:`Recorder`) for the block, and puts it back however it ends."""
    return mock.patch.object(obj, name, Recorder(getattr(obj, name)))


def fedavg_session(on: bool, device, noise_scale=None) -> SplitSession:
    """The paper's FL baseline (Table 5; examples/covid_ct_split.py) at the
    COVID-CT CNN's published width: three hospitals (shares 0.7/0.2/0.1)
    each train the full model on local batches of 32, the guard at epsilon
    1 at the cut (``noise_scale`` pins its sigma), adamw(1e-3); ``on``
    routes the client stage and the release through the kernels."""
    cfg = dataclasses.replace(COVID_CNN, use_kernel=on)
    dp = DPConfig(epsilon=1.0, delta=1e-5, clip_norm=1.0, use_kernel=on,
                  noise_scale=noise_scale)
    return SplitSession(cnn_adapter(cfg), SplitTrainConfig(privacy=dp), adamw(1e-3),
                        engine="fedavg", seed=0, device=device, local_batch=LOCAL_BATCH)


def flat_moment(opt_state) -> torch.Tensor:
    """AdamW's first-moment tree as one CPU vector, in leaf order."""
    return torch.cat([a.reshape(-1) for a in tree_leaves(opt_state["mu"])]).cpu()


def fedavg_gate(sess, calls, against) -> dict:
    """Every recorded local step (``calls``) of a kernel run retaken from its own state,
    batch and noise by the plain path on the card (``"plain_card"``) and on
    the CPU (``"cpu"``), the paths named in ``against``: loss within
    TRAIN_TOL, the clipped gradient (read back from AdamW's first moment,
    ``(mu' - b1 mu) / (1 - b1)``) within GRAD_TOL in relative L2 norm, as
    ``train_forced``. Returns the worst errors."""
    tc = sess.config
    plain = fedavg_mod.make_local_sgd(
        cnn_adapter(dataclasses.replace(COVID_CNN, use_kernel=False)),
        dataclasses.replace(tc, privacy=dataclasses.replace(tc.privacy, use_kernel=False)),
        sess.opt)
    to_cpu = lambda t: tree_map(lambda a: a.cpu(), t)  # noqa: E731
    worst = {name: {"loss": 0.0, "grad_rel_l2": 0.0, "grad_max_abs_err": 0.0}
             for name in against}
    reset_counts()
    for i, (args, (_, k_opt, k_loss)) in enumerate(calls):
        mu0 = flat_moment(args[1])
        k_grad = (flat_moment(k_opt) - ADAM_B1 * mu0) / (1 - ADAM_B1)
        for name, w in worst.items():
            _, o_opt, o_loss = plain(*(args if name == "plain_card" else to_cpu(args)))
            w["loss"] = max(w["loss"], max_err(o_loss.cpu().reshape(1), k_loss.cpu().reshape(1),
                                               **TRAIN_TOL, what=f"{name} local step {i} loss"))
            o_grad = (flat_moment(o_opt) - ADAM_B1 * mu0) / (1 - ADAM_B1)
            rel = float((o_grad - k_grad).norm() / k_grad.norm())
            if not rel <= GRAD_TOL:
                raise AssertionError(f"{name} local step {i}: gradient relative L2 error {rel}")
            w["grad_rel_l2"] = max(w["grad_rel_l2"], rel)
            w["grad_max_abs_err"] = max(w["grad_max_abs_err"],
                                        float((o_grad - k_grad).abs().max()))
    if pc_ops.launches or dp_ops.launches:
        raise AssertionError("the plain local step launched a kernel")
    return worst


def fedavg_run(dev, noise_scale=None):
    """One kernel fit of FEDAVG_ROUNDS rounds x FEDAVG_STEPS local steps,
    its local steps and averages recorded and its counts read around it."""
    sess = fedavg_session(True, dev, noise_scale)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with (recording(sess.engine, "_local_sgd") as steps,
          recording(fedavg_mod, "average_models") as averages):
        history = sess.fit(queue_shards(), epochs=FEDAVG_ROUNDS, steps_per_epoch=FEDAVG_STEPS)
    torch.cuda.synchronize()
    return sess, history, kernel_counts(), steps, averages, time.perf_counter() - t0


def fedavg_covid(dev, smi: str, tmp: str, split_eval: dict) -> dict:
    """``fedavg_covid``, ``fedavg_restore`` and ``fedavg_forced``: the FedAvg
    engine at COVID-CT width, cuDNN deterministic. Gates: one
    ``privacy_conv`` launch and one ``dp_release`` call (k = 1) a local step,
    2 x 3 x 5 of each (the backward recomputes through the plain versions
    and launches nothing), ``evaluate`` counted apart (one bank: the banks
    are identical); the budget at 10 releases (one a local step, the
    reference's count); each round's average recomputed on the CPU from
    the recorded local models within 1e-6; a save and restore that
    continues a round bit for bit; and every local step retaken from its
    state by the plain path on the card and on the CPU at the calibrated
    sigma, and on the card at sigma 0. Returns the launch counts and the
    trained session."""
    torch.backends.cudnn.deterministic = True
    xt, yt = make_covid_ct(128, hw=64, seed=1)
    n = FEDAVG_ROUNDS * len(SHARES) * FEDAVG_STEPS
    sess, history, ran, steps, averages, wall = fedavg_run(dev)
    (release,) = ran["dp_release"]["plans"]
    (conv,) = ran["privacy_conv"]["plans"]
    got = {k: v["launches"] for k, v in ran.items()}
    if (got != {"privacy_conv": n, "dp_release": n} or release["plan"]["blocks_per_row"] != 1
            or release["calls"] != n or conv["calls"] != n):
        raise AssertionError(f"FedAvg launches {ran}, want {n} of each at k = 1")
    losses = [h["mean_local_loss"] for h in history]
    if len(history) != FEDAVG_ROUNDS or not np.isfinite(losses).all():
        raise AssertionError(f"FedAvg history {history}")
    report = sess.privacy_report()
    want_eps = composed_epsilon(sess.config.privacy, FEDAVG_ROUNDS * FEDAVG_STEPS)
    if (report["releases"] != FEDAVG_ROUNDS * FEDAVG_STEPS or report["basic_epsilon"] != 10.0
            or report["basic_epsilon"] != want_eps["basic_epsilon"]
            or report["advanced_epsilon"] != want_eps["advanced_epsilon"]):
        raise AssertionError(f"FedAvg budget {report}, want {want_eps}")
    # each round's average, recomputed on the CPU from its three local models
    avg_err = 0.0
    to_cpu = lambda t: tree_map(lambda a: a.cpu(), t)  # noqa: E731
    for args, out in averages.calls:
        want = fedavg_mod.average_models([to_cpu(m) for m in args[0]], args[1])
        avg_err = max(avg_err, max_err(
            torch.cat([a.reshape(-1) for a in tree_leaves(out)]).cpu(),
            torch.cat([a.reshape(-1) for a in tree_leaves(want)]), atol=1e-6, rtol=1e-6,
            what="the round's average against the CPU"))
    if len(averages.calls) != FEDAVG_ROUNDS:
        raise AssertionError(f"{len(averages.calls)} averages, want {FEDAVG_ROUNDS}")
    path = sess.save(os.path.join(tmp, "fedavg"))
    reset_counts()
    ev = sess.evaluate(xt, yt)
    eval_counts = {k: v["launches"] for k, v in kernel_counts().items()}
    if eval_counts != {"privacy_conv": 1, "dp_release": 0}:  # one bank scored, no release
        raise AssertionError(f"FedAvg evaluate launches {eval_counts}")
    emit({"phase": "fedavg_covid", "card": smi, "model": COVID_CNN.name, "engine": "fedavg",
          "rounds": FEDAVG_ROUNDS, "local_steps": FEDAVG_STEPS, "local_batch": LOCAL_BATCH,
          "sigma": report["sigma"], "tf32": False, "wall_s": wall,
          "mean_local_losses": losses, "launches": got, "plans": ran,
          "privacy": {k: report[k] for k in ("releases", "basic_epsilon", "advanced_epsilon",
                                             "epsilon_basic_carried")},
          "average_max_abs_err_vs_cpu": avg_err,
          "evaluate": {k: ev[k] for k in ("loss", "accuracy")}, "evaluate_launches": eval_counts,
          "split_learning_evaluate": split_eval,
          "note": "evaluate beside train_covid's (split, e2e, 10 steps): the paper's split vs "
                  "FL comparison on random weights after 10 steps, a result, not a gate"})

    # ---- fedavg_forced at the calibrated sigma: this run's local steps
    forced = {"calibrated": fedavg_gate(sess, steps.calls, ("plain_card", "cpu"))}

    # ---- fedavg_restore: one more round, continued and restored, bit for bit
    more = sess.fit(queue_shards(), epochs=1, steps_per_epoch=FEDAVG_STEPS)
    restored = fedavg_session(True, dev)
    restored.restore(path)
    again = restored.fit(queue_shards(), epochs=1, steps_per_epoch=FEDAVG_STEPS)
    if again != more or not state_equal(restored, sess):
        raise AssertionError(f"the restored FedAvg run differs: {again} against {more}, max "
                             f"abs err {tree_diff(restored.state, sess.state)}")
    emit({"phase": "fedavg_restore", "round": int(restored.state["step"]),
          "bit_identical": True, "history": again,
          "releases": restored.privacy_report()["releases"]})

    # ---- fedavg_forced: the sigma-0 kernel run's local steps against the
    # plain card path (the calibrated run's were gated above)
    zero, _, ran0, steps0, _, _ = fedavg_run(dev, noise_scale=0.0)
    if {k: v["launches"] for k, v in ran0.items()} != {"privacy_conv": n, "dp_release": n}:
        raise AssertionError(f"sigma-0 FedAvg launches {ran0}")
    forced["sigma0"] = fedavg_gate(zero, steps0.calls, ("plain_card",))
    emit({"phase": "fedavg_forced", "local_steps": n, "max_err": forced, "grad_tol": GRAD_TOL,
          "sigma": {"calibrated": report["sigma"], "sigma0": 0.0}, "tf32": False,
          "cudnn_deterministic": True, **TRAIN_TOL})
    torch.backends.cudnn.deterministic = False
    return {"launches": got, "session": sess, "evaluate_launches": eval_counts}


def attack_step(fwd, target, x):
    """One step of ``invert_features`` from ``x``: (loss, g, next x)."""
    z = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = torch.mean(torch.square(fwd(z) - target))
        (g,) = torch.autograd.grad(loss, z)
    with torch.no_grad():
        return loss.detach(), g, torch.clamp(z - ATTACK_LR * torch.sign(g) * 0.01
                                             - ATTACK_LR * g, 0.0, 1.0)


def attack_gate(fwds, target, x0, steps) -> dict:
    """Each step of the kernel attack retaken from its x by the plain path
    on the card and on the CPU, against the same target: the loss within
    KERNEL_TOL (it reads the kernel's forward values), and the next x within
    KERNEL_TOL wherever ``sign(g)`` agrees; where it does not, the element
    parts by at most SIGN_STEP (plus KERNEL_TOL), and those elements are
    counted. The kernel's path is checked against ``invert_features``
    itself, bit for bit."""
    x, worst = x0, {}
    for t in range(steps):
        k_loss, k_g, k_next = attack_step(fwds["kernel"][0], target, x)
        for name in ("plain_card", "cpu"):
            fwd, where = fwds[name]
            loss, g, nxt = attack_step(fwd, target.to(where), x.to(where))
            w = worst.setdefault(name, {"loss": 0.0, "x_agreeing_sign": 0.0,
                                        "x_flipped_sign": 0.0, "sign_flips": []})
            w["loss"] = max(w["loss"], max_err(loss.cpu().reshape(1), k_loss.cpu().reshape(1),
                                               **KERNEL_TOL, what=f"{name} attack step {t} loss"))
            flip = (torch.sign(g).cpu() != torch.sign(k_g).cpu())
            err = (nxt.cpu() - k_next.cpu()).abs()
            agree = err[~flip]
            if (agree > KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * k_next.cpu()[~flip].abs()).any():
                raise AssertionError(f"{name} attack step {t}: x differs by {float(agree.max())} "
                                     "where sign(g) agrees")
            if flip.any() and float(err[flip].max()) > SIGN_STEP + KERNEL_TOL["atol"]:
                raise AssertionError(f"{name} attack step {t}: a flipped element parts by "
                                     f"{float(err[flip].max())}")
            w["x_agreeing_sign"] = max(w["x_agreeing_sign"], float(agree.max()))
            w["x_flipped_sign"] = max(w["x_flipped_sign"],
                                      float(err[flip].max()) if flip.any() else 0.0)
            w["sign_flips"].append(int(flip.sum()))
        x = k_next
    whole = invert_features(fwds["kernel"][0], target, x0.shape, steps=steps, x0=x0)
    if not torch.equal(whole, x):
        raise AssertionError("the retaken kernel steps differ from invert_features")
    for w in worst.values():
        flips = w.pop("sign_flips")
        w.update(first_step_sign_flips=flips[0], max_sign_flips_a_step=max(flips),
                 total_sign_flips=sum(flips))
    return worst


def audit_setup(dev, sess):
    """The audited images (the first AUDIT_ROWS of hospital 0's shard),
    hospital 0's bank, and the attack's forwards ``{path: (fn, device)}``:
    the kernel, the plain version on the card, and the plain version on
    the CPU."""
    x = torch.as_tensor(queue_shards()[0][0][:AUDIT_ROWS], device=dev)
    bank = tree_map(lambda a: a[0], sess.state["client_banks"])
    cpu_bank = tree_map(lambda a: a.cpu(), bank)
    adapters = {on: cnn_adapter(dataclasses.replace(COVID_CNN, use_kernel=on))
                for on in (True, False)}
    fwds = {"kernel": (lambda z: adapters[True].client_forward(bank, z, None), dev),
            "plain_card": (lambda z: adapters[False].client_forward(bank, z, None), dev),
            "cpu": (lambda z: adapters[False].client_forward(cpu_bank, z, None),
                    torch.device("cpu"))}
    return x, bank, fwds


def audit_sweeps(sess, fwds, x, seed: int):
    """The four sweeps of one start point and noise ``seed``: the session's
    (``SplitSession.audit_privacy``, the adapter's kernel), the kernel's
    with the release kernel, and the plain versions' on the card and on the
    CPU. Returns ``(rows, launches, reconstructions)``, each by sweep."""
    kw = dict(sigmas=AUDIT_SIGMAS, clip_norm=1.0, steps=AUDIT_STEPS, seed=seed)
    sweeps, launches, recs = {}, {}, {}
    for name, run in (
            ("session", lambda: sess.audit_privacy(x, sigmas=AUDIT_SIGMAS, steps=AUDIT_STEPS,
                                                   seed=seed)),
            ("kernel_release", lambda: guard_noise_sweep(fwds["kernel"][0], x, use_kernel=True,
                                                         **kw)),
            ("plain_card", lambda: guard_noise_sweep(fwds["plain_card"][0], x, **kw)),
            ("cpu", lambda: guard_noise_sweep(fwds["cpu"][0], x.cpu(), **kw))):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with recording(audit_mod, "invert_features") as rec:
            sweeps[name] = run()
        torch.cuda.synchronize()
        launches[name] = {k: v["launches"] for k, v in kernel_counts().items()}
        launches[name]["wall_s"] = time.perf_counter() - t0
        recs[name] = [out.cpu() for _, out in rec.calls]
    return sweeps, launches, recs


def sweep_spread(sweeps, recs) -> dict:
    """Each sweep's reconstructions against the session's, row by row: L1
    distance, elements parted beyond KERNEL_TOL, the largest element's
    distance, and the MSE, PSNR and NCC differences."""
    spread = {}
    for name in ("kernel_release", "plain_card", "cpu"):
        e = spread[name] = {"l1": [], "parted": [], "max_abs": [], "mse": [], "psnr_db": [],
                            "ncc": []}
        for r, (a, b) in enumerate(zip(recs["session"], recs[name])):
            diff = (b - a).abs()
            e["l1"].append(float(diff.sum()))
            e["parted"].append(int((diff > KERNEL_TOL["atol"]
                                    + KERNEL_TOL["rtol"] * a.abs()).sum()))
            e["max_abs"].append(float(diff.max()))
            for k in ("mse", "psnr_db", "ncc"):
                e[k].append(abs(sweeps["session"][r][k] - sweeps[name][r][k]))
    return spread


def sweep_limits(n_el: int, rows) -> dict:
    """The sweep gate's limits by path, each a list over the session's
    ``rows`` (the argument is at AUDIT_CARD_L1 and AUDIT_CPU_SPREAD). On
    the card the L1 limit L bounds the metrics: with every value in [0, 1]
    two reconstructions part in MSE by at most 2 L / N, in PSNR by
    (10 / ln 10) of that over the smaller MSE, and in NCC by at most
    2 L / |a - mean(a)|_2, orders below float32 rounding of the metrics
    themselves, KERNEL_TOL's atol, which each limit adds."""
    atol = KERNEL_TOL["atol"]
    mse = 2 * AUDIT_CARD_L1 / n_el + atol
    card = {"l1": [AUDIT_CARD_L1] * len(rows), "mse": [mse] * len(rows),
            "ncc": [atol] * len(rows),
            "psnr_db": [10 / math.log(10) * mse / (r["mse"] - mse) + atol for r in rows]}
    cpu = {k: [v] * len(rows) for k, v in AUDIT_CPU_SPREAD.items()}
    return {"kernel_release": card, "plain_card": card, "cpu": cpu}


def audit_covid(dev, smi: str, sess) -> dict:
    """``audit_covid``: the inversion audit of hospital 0's trained privacy
    layer (the FedAvg state) at COVID-CT width. ``SplitSession.audit_privacy``
    with the adapter's kernel (``privacy_conv`` a forward, 3 x (120 + 1)
    launches; the session's sweep releases through the plain guard, as the
    reference's) and ``guard_noise_sweep(..., use_kernel=True)``, which puts
    ``dp_release`` on the audit path (3 releases). Gates: the launch counts;
    every attack step of the kernel run retaken on the plain card and CPU
    paths (:func:`attack_gate`); and the three sweeps' reconstructions
    and MSE, PSNR and NCC against the session's, within
    :func:`sweep_limits`. The MSE-vs-sigma rows are printed, not gated."""
    torch.backends.cudnn.deterministic = True
    x, bank, fwds = audit_setup(dev, sess)
    sweeps, launches, recs = audit_sweeps(sess, fwds, x, seed=0)
    per = len(AUDIT_SIGMAS) * (AUDIT_STEPS + 1)
    want = {"session": (per, 0), "kernel_release": (per, len(AUDIT_SIGMAS)),
            "plain_card": (0, 0), "cpu": (0, 0)}
    for name, (pc, dp) in want.items():
        if (launches[name]["privacy_conv"], launches[name]["dp_release"]) != (pc, dp):
            raise AssertionError(f"audit {name} launches {launches[name]}, want {pc}, {dp}")
    # ---- the forced attack steps from the start point, against the sigma-0
    # row's observed release (the clipped features)
    x0 = (0.5 + 0.01 * torch.randn(tuple(x.shape), generator=torch.Generator().manual_seed(0))
          ).to(dev)
    with torch.no_grad():
        target = PrivacyGuard(DPConfig(clip_norm=1.0, noise_scale=0.0)).release_with_noise(
            fwds["kernel"][0](x), None)
    reset_counts()
    forced = attack_gate(fwds, target, x0, AUDIT_STEPS)
    if pc_ops.launches != 2 * AUDIT_STEPS:  # a step's kernel forward, and the check's
        raise AssertionError(f"forced attack steps launched {pc_ops.launches}")
    # ---- the sweeps' reconstructions and metrics against the session's
    spread = sweep_spread(sweeps, recs)
    limits = sweep_limits(x.numel(), sweeps["session"])
    failed = [f"{name} row {r} {k}: {v} beyond {limits[name][k][r]}"
              for name, e in spread.items() for k in ("l1", "mse", "psnr_db", "ncc")
              for r, v in enumerate(e[k]) if not v <= limits[name][k][r]]
    emit({"phase": "audit_covid", "card": smi, "model": COVID_CNN.name, "client": 0,
          "state": "fedavg_covid", "rows": AUDIT_ROWS, "steps": AUDIT_STEPS,
          "sigmas": list(AUDIT_SIGMAS), "clip_norm": 1.0, "launches": launches,
          "forced_steps": forced, "sweep_vs_session": spread, "sweep_limits": limits,
          "mse_vs_sigma": {name: [{k: r[k] for k in ("sigma", "mse", "psnr_db", "ncc")}
                                  for r in rows] for name, rows in sweeps.items()},
          "tf32": False, "cudnn_deterministic": True, **KERNEL_TOL})
    if failed:
        raise AssertionError("audit sweeps: " + "; ".join(failed))
    torch.backends.cudnn.deterministic = False
    return {"session": (launches["session"]["privacy_conv"], 0),
            "kernel_release": (launches["kernel_release"]["privacy_conv"],
                               launches["kernel_release"]["dp_release"]),
            "x": x, "bank": bank}


def fedavg_time(dev, smi: str, conv_inputs: dict, release_inputs: dict, audit: dict) -> dict:
    """``fedavg_time``: FedAvg local steps per second with the kernels on
    and off (one round of 3 x FEDAVG_STEPS local steps a fit, TIME_ROUNDS
    fits a path in turns, session set-up excluded), the two kernels' device
    time a local step from the profiler, attack steps per second with the
    kernel forward on and off (ATTACK_TIME_STEPS steps a call, 3 calls in
    turns), and both kernels' device ms at the slice's shapes against their
    plain versions and bounds."""
    shards = queue_shards()
    sessions = {name: fedavg_session(on, dev) for name, on in (("kernel", True),
                                                               ("plain", False))}
    local = len(SHARES) * FEDAVG_STEPS

    def fit(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sessions[name].fit(shards, epochs=1, steps_per_epoch=FEDAVG_STEPS)
        torch.cuda.synchronize()
        return local / (time.perf_counter() - t0)

    for name in sessions:
        fit(name)  # warm-up
    rates = {"kernel": [], "plain": []}
    for r in range(TIME_ROUNDS):
        for name in (("kernel", "plain") if r % 2 else ("plain", "kernel")):
            rates[name].append(fit(name))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit("kernel")
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    per_step = {k: sum(e.self_device_time_total for e in dev_events if k in e.key)
                / 1e3 / local for k in ("privacy_conv", "dp_release")}
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3 / local
    x, bank = audit["x"], audit["bank"]
    adapters = {on: cnn_adapter(dataclasses.replace(COVID_CNN, use_kernel=on))
                for on in (True, False)}
    with torch.no_grad():
        target = adapters[False].client_forward(bank, x, None)
    x0 = torch.full_like(x, 0.5)

    def attack(on):
        fwd = lambda z: adapters[on].client_forward(bank, z, None)  # noqa: E731
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        invert_features(fwd, target, x.shape, steps=ATTACK_TIME_STEPS, x0=x0)
        torch.cuda.synchronize()
        return ATTACK_TIME_STEPS / (time.perf_counter() - t0)

    attack(True), attack(False)  # warm-up
    attack_rates = {"kernel": [], "plain": []}
    for r in range(3):
        for on in ((True, False) if r % 2 else (False, True)):
            attack_rates["kernel" if on else "plain"].append(attack(on))
    emit({"phase": "fedavg_time", "card": smi, "tf32": False, "local_steps_per_fit": local,
          "rounds": TIME_ROUNDS, "note": "wall, host clock, session set-up excluded",
          **{f"{k}_local_steps_per_s": float(np.median(v)) for k, v in rates.items()},
          **{f"{k}_local_steps_per_s_all": v for k, v in rates.items()},
          "kernel_device_ms_per_local_step": per_step, "device_busy_ms_per_local_step": busy,
          "attack_steps_per_call": ATTACK_TIME_STEPS, "attack_rows": AUDIT_ROWS,
          **{f"{k}_attack_steps_per_s": float(np.median(v)) for k, v in attack_rates.items()},
          **{f"{k}_attack_steps_per_s_all": v for k, v in attack_rates.items()},
          "top": [{"name": e.key[:90], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]]})
    timed = {}
    for case in ("fedavg_local", "audit"):
        xc, w, b, nz = conv_inputs[case]
        scale = CONV_CASES[case][-1]
        k_ms, p_ms = paired_ms(lambda: pc_ops.privacy_conv_forward(xc, w, b, nz, scale),
                               lambda: privacy_conv_ref(xc, w, b, nz, noise_scale=scale))
        timed[f"privacy_conv/{case}"] = {
            "case": f"privacy_conv/{case}", "ms": k_ms, "plain_ms": p_ms,
            "plan": pc_ops.plan_for(xc, w, nz, scale), "library_ms": None,
            **conv_work(*CONV_CASES[case])}
        xr, nr = release_inputs[case]
        s = AUDIT_RELEASE_SIGMA if case == "audit" else DPConfig().sigma
        k_ms, p_ms = paired_ms(lambda: dp_ops.dp_release_forward(xr, nr, 1.0, s),
                               lambda: dp_release_ref(xr, nr, clip_norm=1.0, sigma=s))
        timed[f"dp_release/{case}"] = {
            "case": f"dp_release/{case}", "shape": list(xr.shape), "sigma": s, "ms": k_ms,
            "plain_ms": p_ms, "plan": dp_ops.plan_for(xr, nr, s), "library_ms": None,
            **release_work(tuple(xr.shape), s)}
    for t in timed.values():
        t["bound_share"] = t["bound_ms"] / t["ms"]
        emit({"phase": "time", "card": smi, **t})
    return {"timed": timed, "device_ms_per_local_step": per_step}


# ==== the LM workload: llama3.2-1b, granite-moe-1b-a400m, falcon-mamba-7b
@dataclasses.dataclass(frozen=True)
class LMSpec:
    """One LM path of the smoke. ``prefix`` names its phases; the config is
    ``config`` at its published width (``n_layers`` cuts its depth; with
    ``reduced``, its ``reduced()`` widths with ``overrides``); ``seq`` is
    the training window, ``cpu_seq`` the window of the step the CPU
    retakes; ``decode`` is (batch, prompt, generated tokens) and
    ``cpu_budget_s`` the CPU decode replay's budget; ``time_rounds`` the
    turns of the timed epochs and ``profile_steps`` the steps profiled
    for the busy share; ``e2e`` and ``remat`` add lm_train_e2e and
    ``<prefix>_remat``."""

    prefix: str
    config: str
    seq: int
    cpu_seq: int
    n_layers: int = 0
    reduced: bool = False
    overrides: tuple = ()
    decode: tuple = (4, 64, 32)
    cpu_budget_s: float = 60.0
    time_rounds: int = 3
    e2e: bool = False
    remat: bool = False
    profile_steps: int = 3


# the LM paths at published widths, float32 (TF32 off), all trained by three
# hospitals (0.7/0.2/0.1 of launch/train.py's corpus shards), one window
# each a step (server batch 3), 2 epochs x 3 steps, AdamW with
# launch/train.py's schedule, the clipped guard at epsilon 1 through
# dp_release at the [3, seq, d] cut; decode with the settings of
# examples/serve_decode.py (batch 4, prompt 64, gen 32):
# - llama3.2-1b (16 layers, d 2048, 32 heads over 8 kv heads, hd 64, d_ff
#   8192, vocab 128,256, rope theta 5e5) at 512 tokens; the CPU retakes a
#   step at 128, since the card's 512 costs the host's 8 cores more than
#   twice as long (``tools/lm_smoke.py --cpu-seq 512`` reads it);
# - granite-moe-1b-a400m (24 layers, d 1024, 16 heads over 8, 32 experts
#   top 8 of d_ff 512, vocab 49,155) at 512 tokens, its published depth;
# - falcon-mamba-7b (d 4096, d_inner 8192, d_state 16, vocab 65,024) cut to
#   12 of its 64 layers (the AdamW state of 64 is ~116 GB; at 16 the
#   restore phase peaked at 70.34 GiB, past the 70 GiB the card's 80 GB
#   leave room for) at 256 tokens: 3 x 256 x 4096 is the 1,048,576-element
#   row that the reference's dp_release kernel admits (its VMEM assert);
#   the CPU step at 64 tokens
# - and, apart (``hybrid``), jamba-1.5-large-398b's layer pattern (16
#   layers: attention at 4 of every 8, MoE every other layer) at its
#   reduced widths, since one of its MoE layers alone is 38.7 GB at the
#   published width
LM_SPECS = {
    "lm": LMSpec("lm", "llama3.2-1b", seq=512, cpu_seq=128, e2e=True),
    "moe": LMSpec("moe", "granite-moe-1b-a400m", seq=512, cpu_seq=128, cpu_budget_s=20.0,
                  time_rounds=2),
    # one step profiled: the scan's ~40,000 launches a step take the
    # profiler's host side ~30 s a step to tabulate
    "ssm": LMSpec("ssm", "falcon-mamba-7b", seq=256, cpu_seq=64, n_layers=12,
                  cpu_budget_s=20.0, time_rounds=2, remat=True,
                  profile_steps=1),
}
HYBRID = LMSpec("hybrid", "jamba-1.5-large-398b", seq=128, cpu_seq=128, reduced=True,
                overrides=(("n_layers", 16), ("attn_period", 8), ("attn_offset", 4),
                           ("moe_period", 2)),
                cpu_budget_s=30.0)
LM_EPOCHS, LM_STEPS = 2, 3
LM_LR = 3e-4  # launch/train.py's default
# decode logits, card against CPU: float32 products of width 1024 to 8192
# summed in another order, carried through 16 to 24 blocks and the head
LM_LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# a MoE token's top-K experts may differ between two runs (card and CPU,
# kernel and plain release) only where its K-th and (K+1)-th router
# probabilities lie this close in the first run: float32 rounding moves a
# probability of ~1/32 by ~1e-7, and the typical gap is ~1e-3
ROUTING_EPS = 1e-4


def spec_config(spec: LMSpec):
    cfg = get_config(spec.config)
    if spec.reduced:
        cfg = cfg.reduced()
    kw = dict(spec.overrides)
    if spec.n_layers:
        kw["n_layers"] = spec.n_layers
    return dataclasses.replace(cfg, **kw) if kw else cfg


def lm_kernel_counts() -> dict:
    """The LM kernels' launch counters (the LM model calls neither: the
    reference's runs its own XLA attention and SSM scan,
    ``repro/models/attention.py:3-6``, ``repro/models/ssm.py:51-73``)."""
    return {"flash_attention": fa_ops.launches, "selective_scan": ss_ops.launches}


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def free_card() -> None:
    """Return the freed blocks of the allocator, before a phase's peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


class Routing:
    """Inside ``with``: every MoE dispatch's top-K expert ids and the gap
    between its K-th and (K+1)-th router probability, call by call
    (``models.moe._top_k`` patched). With ``replay`` (a recorded run), each
    call takes that run's ids in place of its own top-K, its gates read
    from its own probabilities: the same routing, for a comparison of the
    arithmetic where routing flipped."""

    def __init__(self, replay=None):
        self.ids, self.gaps, self.replay = [], [], replay
        self._patch = mock.patch.object(moe_mod, "_top_k", self._top_k)

    def __enter__(self):
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()

    def _top_k(self, probs, k):
        if self.replay is None:
            vals, ids = TOP_K(probs, k)
        else:
            ids = self.replay.ids[len(self.ids)].to(probs.device)
            vals = probs.gather(-1, ids)
        top = torch.topk(probs.detach(), k + 1, dim=-1).values
        self.ids.append(ids.detach())
        self.gaps.append((top[:, k - 1] - top[:, k]).detach())
        return vals, ids


def routing_gate(a: Routing, b: Routing, what: str) -> dict:
    """The top-K expert sets of run ``b`` against run ``a``, call by call
    (``b`` may have stopped earlier): a token whose set differs (a flip)
    must sit at a near tie in ``a`` (gap below ROUTING_EPS), else the gate
    fails. Returns the counts and, by call, the flipped tokens."""
    flips, near, masks = 0, 0, []
    for ia, ib, gap in zip(a.ids, b.ids, a.gaps):
        flipped = (ia.sort(-1).values.cpu() != ib.sort(-1).values.cpu()).any(-1)
        tie = gap.cpu() < ROUTING_EPS
        if bool((flipped & ~tie).any()):
            raise AssertionError(f"{what}: {int((flipped & ~tie).sum())} routing flips away "
                                 f"from a near tie (gap >= {ROUTING_EPS})")
        flips += int(flipped.sum())
        near += int(tie.sum())
        masks.append(flipped)
    return {"routing_calls": len(masks), "routing_flips": flips, "near_ties": near,
            "routing_eps": ROUTING_EPS, "masks": masks}


def routed_grads(fa, fb, what: str):
    """Two gradient runs (``fa``, ``fb``: ``() -> (grad, metrics)``), their
    routing compared (``routing_gate``). Where a token flipped, ``fb`` is
    retaken with ``fa``'s routing, so that the gradients compared come
    from one routing. Returns both runs and the routing counts."""
    with Routing() as ra:
        a = fa()
    with Routing() as rb:
        b = fb()
    route = routing_gate(ra, rb, what)
    del route["masks"]
    route["routing_replayed"] = bool(route["routing_flips"])
    if route["routing_flips"]:
        del b
        with Routing(replay=ra):
            b = fb()
    return a, b, route


def lm_session(dev, spec: LMSpec, mode="detached") -> SplitSession:
    """``spec``'s config split by launch/train.py's recipe: three hospitals,
    one window a step each, adamw(linear_warmup_cosine(3e-4, 20, steps)),
    the guard clipped at epsilon 1, the release through dp_release
    (``lm_parts`` gives the step's other variants)."""
    dp = DPConfig(epsilon=1.0, delta=1e-5, clip_norm=1.0, use_kernel=True)
    tc = SplitTrainConfig(n_clients=3, data_shares=SHARES, server_batch=3, mode=mode, privacy=dp)
    opt = adamw(linear_warmup_cosine(LM_LR, 20, LM_EPOCHS * LM_STEPS))
    adapter = llm_adapter(spec_config(spec), ModelOptions(q_block=spec.seq, kv_block=spec.seq),
                          torch.float32)
    return SplitSession(adapter, tc, opt, engine="llm-split", seed=0, device=dev)


def lm_parts(sess, on: bool, noise_scale=None, remat: bool = False):
    """The flat-domain step of ``sess``'s config with the release through
    the kernel (``on``) or its plain version, at ``noise_scale``; with
    ``remat``, each group recomputed in the backward pass."""
    dp = dataclasses.replace(sess.config.privacy, use_kernel=on,
                             noise_scale=(sess.config.privacy.noise_scale if noise_scale is None
                                          else noise_scale))
    a = sess.adapter
    opts = dataclasses.replace(a.opts, remat=True) if remat else a.opts
    return llm_step_parts(a.cfg, opts, sess.opt, sess.config.n_clients,
                          grad_clip=sess.config.grad_clip, privacy=dp,
                          mode=sess.config.mode)


def lm_plan(sess, shards, steps, seed, dev, seq):
    """``steps`` batches of the session's plan drawn from a CPU generator
    seeded ``seed``: ``[(batch, guard_noise)]`` on ``dev``."""
    data_x, data_y, lens = device_put_shards(shards, dev)
    plan = make_sample_plan(sess.adapter, sess.config, steps)(
        lens, (seq,), torch.Generator().manual_seed(seed), dev)
    rows = torch.arange(sess.config.n_clients, device=dev)[:, None]
    return [({"tokens": data_x[rows, plan.idx[t]], "labels": data_y[rows, plan.idx[t]]},
             None if plan.guard_noise is None else plan.guard_noise[t]) for t in range(steps)]


def grad_gate(k, p, what: str) -> dict:
    """Two ``(grad, metrics)`` of one step from one state: metrics and
    gradient norms within TRAIN_TOL, the gradients within GRAD_TOL in
    relative L2 norm."""
    (kg, km), (pg, pm) = k, p
    pg = pg.to(kg.device)
    worst = 0.0
    for key in km:
        worst = max(worst, max_err(pm[key].cpu(), km[key].cpu(), **TRAIN_TOL,
                                   what=f"{what} {key}"))
    norms = torch.stack([torch.linalg.vector_norm(kg), torch.linalg.vector_norm(pg)]).cpu()
    worst = max(worst, max_err(norms[1:], norms[:1], **TRAIN_TOL, what=f"{what} grad_norm"))
    rel = float(torch.linalg.vector_norm(kg - pg) / norms[0])
    if not rel <= GRAD_TOL:
        raise AssertionError(f"{what}: gradient relative L2 error {rel}")
    return {"metrics": worst, "grad_rel_l2": rel}


def forced_logits(cfg, params, prompts, tokens, budget_s=None) -> torch.Tensor:
    """The logits of every step of ``serve.prefill_and_decode``'s loop with
    ``tokens`` fed in (teacher forcing): the prompt replayed, then token i
    at position prompt + i. ``[B, prompt + gen, V]`` on the CPU; with
    ``budget_s``, the steps until one ends past it."""
    B, P = prompts.shape
    toks = torch.cat([prompts, torch.as_tensor(tokens, device=prompts.device).to(prompts.dtype)],
                     dim=1)
    state = model_lib.init_decode_state(cfg, B, toks.shape[1], torch.float32, prompts.device)
    out = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(toks.shape[1]):
            logits, state = model_lib.serve_step(params, cfg, state, toks[:, t:t + 1], t)
            out.append(logits[:, 0].cpu())
            if budget_s is not None and time.perf_counter() - t0 > budget_s:
                break
    return torch.stack(out, dim=1)


def lm_decode(dev, smi: str, spec: LMSpec) -> dict:
    """``<prefix>_decode``: serve.prefill_and_decode at temperature 0 on
    the card, twice (bit-equal token streams, each step's shape and dtype
    checked), its teacher-forced replay equal to the free run's tokens, and
    the same replay on the CPU for at most ``cpu_budget_s``: the MoE
    routing of each position against the card's (``routing_gate``; a row's
    positions from a flip on are left out), then logits within
    LM_LOGIT_TOL at every other position it reached, greedy tokens equal
    wherever the card's top-2 gap exceeds twice the tolerance. No kernel
    runs on this path."""
    cfg = spec_config(spec)
    B, P, G = spec.decode
    free_card()
    # serve._model's init: the CPU generator of seeded_generator(0)
    params = model_lib.init_model(seeded_generator(0), cfg, torch.float32, dev)
    prompts = serve.make_prompts(cfg, B, P, seed=0, device=dev)
    reset_counts()
    lm0 = lm_kernel_counts()
    runs = [serve.prefill_and_decode(cfg, params, prompts, gen=G, temperature=0.0, seed=0,
                                     check_steps=True) for _ in range(2)]
    launches = {**{k: v["launches"] for k, v in kernel_counts().items()},
                **{k: v - lm0[k] for k, v in lm_kernel_counts().items()}}
    if any(launches.values()):
        raise AssertionError(f"a kernel launched on the decode path: {launches}")
    tokens = runs[0]["tokens"]
    if tokens.shape != (B, G) or not np.array_equal(tokens, runs[1]["tokens"]):
        raise AssertionError("greedy decode is not deterministic on the card")
    if not ((0 <= tokens) & (tokens < cfg.vocab_size)).all():
        raise AssertionError("decoded tokens out of the vocabulary")
    with Routing() as card_route:
        card = forced_logits(cfg, params, prompts, tokens)
    if not np.array_equal(card[:, P - 1:P + G - 1].argmax(-1).numpy(), tokens):
        raise AssertionError("the teacher-forced replay does not give the free run's tokens")
    peak = peak_gib()
    cpu_params = tree_map(lambda a: a.cpu(), params)
    del params
    t0 = time.perf_counter()
    with Routing() as cpu_route:
        cpu = forced_logits(cfg, cpu_params, prompts.cpu(), tokens, budget_s=spec.cpu_budget_s)
    cpu_s = time.perf_counter() - t0
    n = cpu.shape[1]
    if n < min(16, P + G):
        raise AssertionError(f"the CPU replay reached {n} positions in {cpu_s} s")
    route = routing_gate(card_route, cpu_route, f"{spec.prefix}_decode")
    # rows are independent in decode: a flip at (position, row) leaves that
    # row's logits from there on out of the comparison
    same = torch.ones((B, n), dtype=torch.bool)
    per_step = len(card_route.ids) // (P + G)
    for i, flipped in enumerate(route.pop("masks")):
        same[flipped, i // per_step:] = False
    card = card[:, :n]
    err = max_err(cpu[same], card[same], **LM_LOGIT_TOL,
                  what="decode logits, CPU against the card")
    top = card.topk(2, dim=-1).values
    clear = (top[..., 0] - top[..., 1]) > 2 * (LM_LOGIT_TOL["atol"]
                                               + LM_LOGIT_TOL["rtol"] * top[..., 0].abs())
    agree = card.argmax(-1) == cpu.argmax(-1)
    if not bool(agree[clear & same].all()):
        raise AssertionError("greedy tokens differ from the CPU's at a clear top-2 gap")
    timed = {k: runs[1][k] for k in ("tokens_per_s", "prefill_s", "decode_s")}
    emit({"phase": f"{spec.prefix}_decode", "card": smi, "config": cfg.name,
          "n_layers": cfg.n_layers, "batch": B, "prompt": P,
          "gen": G, "dtype": "float32", "tf32": False, "tied_embeddings": cfg.tie_embeddings,
          "bit_equal_runs": True, "steps_checked": P + G, "launches": launches,
          "forced_replay_equals_tokens": True, "cpu_positions": n, "positions": P + G,
          "cpu_s": cpu_s, "cpu_budget_s": spec.cpu_budget_s, **route,
          "positions_compared": int(same.sum()),
          "max_abs_err_vs_cpu": err, "near_ties": int((~clear).sum()),
          "moe_near_ties": route["near_ties"],
          "near_tie_disagreements": int((~agree & ~clear).sum()), **LM_LOGIT_TOL,
          "peak_gib": peak, **timed, "first_tokens": tokens[0][:8].tolist()})
    return {**timed, "launches": launches}


def lm_forced(sess, plan, noise_scale, what: str) -> dict:
    """Each step of ``plan`` retaken from one state by the kernel release
    and the plain one on the card (``routed_grads``, then ``grad_gate``),
    the kernel step then applied, along ``sess``'s native state."""
    k_parts, p_parts = lm_parts(sess, True, noise_scale), lm_parts(sess, False, noise_scale)
    native, unravel = sess.native_state, sess.engine._unravel
    flat, banks, opt_state, step = (native["flat"], native["client_banks"], native["opt"],
                                    native["step"])
    worst = {"metrics": 0.0, "grad_rel_l2": 0.0}
    routing = {"routing_flips": 0, "near_ties": 0, "steps_replayed": 0}
    calls0 = sum(dp_ops.plans.values())
    for t, (batch, noise) in enumerate(plan):
        if noise_scale == 0.0:
            noise = None
        k, p, route = routed_grads(
            lambda: k_parts.grad(flat, unravel, banks, batch, None, noise),
            lambda: p_parts.grad(flat, unravel, banks, batch, None, noise), f"{what} step {t}")
        w = grad_gate(k, p, f"{what} step {t}")
        worst = {key: max(worst[key], w[key]) for key in worst}
        routing = {"routing_flips": routing["routing_flips"] + route["routing_flips"],
                   "near_ties": routing["near_ties"] + route["near_ties"],
                   "steps_replayed": routing["steps_replayed"] + route["routing_replayed"]}
        del p
        k_parts.apply(flat, opt_state, step, k[0])
        step = step + 1
    calls = sum(dp_ops.plans.values()) - calls0
    if calls != len(plan):
        raise AssertionError(f"{what}: {calls} dp_release calls in {len(plan)} steps")
    return {**worst, **routing, "steps": len(plan), "dp_release_calls": calls}


def lm_train(dev, smi: str, tmp: str, spec: LMSpec) -> dict:
    """``<prefix>_train`` and its gates: SplitSession(engine="llm-split")
    trains ``spec``'s config detached, 2 epochs x 3 steps (one dp_release
    call a step over the [3, seq, d] cut, the budget at 6, finite losses),
    evaluates, and restores bit for bit (``<prefix>_restore``); every step
    of a 6-step plan retaken from one state, kernel against the plain
    release on the card at the calibrated sigma and at sigma 0, and one
    step against the CPU at ``cpu_seq`` (``<prefix>_forced``). Returns the
    session, a plan and the path's counts."""
    cfg = spec_config(spec)
    shards = lm_shards(cfg, SHARES, 1, spec.seq, 0)
    n = LM_EPOCHS * LM_STEPS
    free_card()
    t0 = time.perf_counter()
    sess = lm_session(dev, spec)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_counts()
    lm0 = lm_kernel_counts()
    t0 = time.perf_counter()
    sess.fit(shards, epochs=LM_EPOCHS, steps_per_epoch=LM_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = kernel_counts()
    launches = {**{k: v["launches"] for k, v in ran.items()},
                **{k: v - lm0[k] for k, v in lm_kernel_counts().items()}}
    (release,) = ran["dp_release"]["plans"]
    if (release["calls"] != n or launches != {"privacy_conv": 0, "flash_attention": 0,
                                                "selective_scan": 0,
                                                "dp_release": n * release["plan"]["launches"]}):
        raise AssertionError(f"{spec.prefix}_train launches {ran}, want one dp_release call "
                             "a step")
    losses = step_losses(sess)
    if len(losses) != n or not np.isfinite(losses).all():
        raise AssertionError(f"{spec.prefix}_train per-step losses {losses}")
    report = sess.privacy_report()
    if report["releases"] != n:
        raise AssertionError(f"budget counts {report['releases']} releases, want {n}")
    peak_fit = peak_gib()
    canonical = sess.state
    server_params = sum(a.numel() for a in tree_leaves(canonical["server"]))
    bank_params = sum(a.numel() for a in tree_leaves(canonical["client_banks"])) // 3
    del canonical
    path = sess.save(os.path.join(tmp, spec.prefix))
    xe = shards[0][0][:6]
    reset_counts()
    ev = sess.evaluate(xe, xe, batch=3)
    if kernel_counts()["dp_release"]["launches"]:
        raise AssertionError("evaluate released through dp_release")
    emit({"phase": f"{spec.prefix}_train", "card": smi, "config": cfg.name,
          "n_layers": cfg.n_layers, "published_layers": get_config(spec.config).n_layers,
          "family": cfg.family, "mode": "detached",
          "engine": "llm-split", "dtype": "float32", "tf32": False, "clients": 3,
          "seq": spec.seq, "rows_per_step": 3, "epochs": LM_EPOCHS,
          "steps_per_epoch": LM_STEPS,
          "server_params": server_params, "bank_params": bank_params, "init_s": init_s,
          "wall_s": wall, "step_losses": losses, "sigma": report["sigma"],
          "launches": launches, "plans": ran,
          "privacy": {k: report[k] for k in ("releases", "basic_epsilon", "advanced_epsilon")},
          "evaluate": {k: ev[k] for k in ("loss", "accuracy")}, "evaluate_rows": len(xe),
          "peak_gib": peak_fit})

    # ---- <prefix>_restore: the run continues one epoch; a session restored
    # from its checkpoint continues the same epoch, bit for bit
    sess.fit(shards, epochs=1, steps_per_epoch=LM_STEPS)
    want = tree_map(lambda a: a.detach().cpu(), sess.state)
    want_losses = step_losses(sess)
    del sess
    free_card()
    t0 = time.perf_counter()
    sess = lm_session(dev, spec)
    manifest = sess.restore(path)
    restore_s = time.perf_counter() - t0
    sess.fit(shards, epochs=1, steps_per_epoch=LM_STEPS)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(sess.state),
                                                        tree_leaves(want)))
    if not same or step_losses(sess) != want_losses:
        raise AssertionError(f"the restored {spec.prefix} run differs")
    if manifest["metadata"]["epochs_done"] != LM_EPOCHS:
        raise AssertionError(f"restored epoch count {manifest['metadata']['epochs_done']}")
    del want
    checkpoint_gib = os.path.getsize(path) / 2 ** 30
    for f in (path, path.replace(".npz", ".json")):  # the next path's checkpoint needs the disk
        os.remove(f)
    emit({"phase": f"{spec.prefix}_restore", "bit_identical": True, "step_losses": want_losses,
          "checkpoint_gib": checkpoint_gib, "restore_s": restore_s,
          "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
          "peak_gib": peak_gib()})

    # ---- <prefix>_forced: each step retaken from one state, kernel against plain
    free_card()
    plan = lm_plan(sess, shards, n, 5, dev, spec.seq)
    forced = {"calibrated": lm_forced(sess, plan, None, f"{spec.prefix}_forced"),
              "sigma0": lm_forced(sess, plan, 0.0, f"{spec.prefix}_forced sigma 0")}
    forced["peak_gib"] = peak_gib()
    # one step against the CPU at full width (the first cpu_seq tokens)
    batch, noise = plan[0]
    batch = {k: v[..., :spec.cpu_seq] for k, v in batch.items()}
    noise = noise[:, :, :spec.cpu_seq].contiguous()
    native, unravel = sess.native_state, sess.engine._unravel
    cpu_flat = native["flat"].cpu()
    cpu_banks = tree_map(lambda a: a.cpu(), native["client_banks"])
    t0 = []

    def on_cpu():
        t0.append(time.perf_counter())
        return lm_parts(sess, False).grad(cpu_flat, unravel, cpu_banks,
                                          {key: v.cpu() for key, v in batch.items()}, None,
                                          noise.cpu())

    k, cpu, route = routed_grads(
        lambda: lm_parts(sess, True).grad(native["flat"], unravel, native["client_banks"],
                                          batch, None, noise), on_cpu,
        f"{spec.prefix}_forced cpu")
    cpu_s = time.perf_counter() - t0[-1]
    k = (k[0].cpu(), {key: v.cpu() for key, v in k[1].items()})
    forced["cpu"] = {**grad_gate(k, cpu, f"{spec.prefix}_forced cpu"), **route,
                     "seq": spec.cpu_seq, "cpu_s": cpu_s}
    del k, cpu, cpu_flat, cpu_banks
    emit({"phase": f"{spec.prefix}_forced", "sigma": sess.guard.sigma, "tf32": False,
          "grad_tol": GRAD_TOL, **TRAIN_TOL, **forced})
    return {"session": sess, "shards": shards, "launches": launches, "plan": plan,
            "calls": release["calls"], "release_plan": release["plan"], "forced": forced}


def lm_remat(smi: str, sess, plan, spec: LMSpec) -> dict:
    """``<prefix>_remat``: one step's gradient with each group recomputed in
    the backward pass (``ModelOptions(remat=True)``) equals the gradient
    without, bit for bit; the peak memory each adds to what the session
    holds."""
    batch, noise = plan[0]
    native, unravel = sess.native_state, sess.engine._unravel
    grads, extra = {}, {}
    for remat in (False, True):
        free_card()
        base = torch.cuda.memory_allocated()
        grads[remat] = lm_parts(sess, True, remat=remat).grad(
            native["flat"], unravel, native["client_banks"], batch, None, noise)[0]
        torch.cuda.synchronize()
        extra[remat] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    if not torch.equal(grads[False], grads[True]):
        raise AssertionError(f"{spec.prefix}_remat: the gradient with remat differs by "
                             f"{float((grads[False] - grads[True]).abs().max())}")
    out = {"bit_equal": True, "extra_peak_gib_off": extra[False],
           "extra_peak_gib_on": extra[True], "held_gib": torch.cuda.memory_allocated() / 2 ** 30}
    emit({"phase": f"{spec.prefix}_remat", "card": smi, "config": sess.adapter.cfg.name,
          "seq": spec.seq, **out})
    return out


def lm_e2e(dev, smi: str, shards, spec: LMSpec) -> None:
    """``lm_train_e2e``: per-client banks trained e2e; one step's gradient
    (into the banks through dp_release's plain backward) with the kernel
    release against the plain one on the card, from one state; then one
    step of the session, one dp_release call."""
    free_card()
    sess = lm_session(dev, spec, mode="e2e")
    (batch, noise), = lm_plan(sess, shards, 1, 6, dev, spec.seq)
    native, unravel = sess.native_state, sess.engine._unravel
    calls0 = sum(dp_ops.plans.values())
    k = lm_parts(sess, True).grad(native["flat"], unravel, None, batch, None, noise)
    kernel_calls = sum(dp_ops.plans.values()) - calls0
    gate = grad_gate(k, lm_parts(sess, False).grad(native["flat"], unravel, None, batch, None,
                                                   noise), "lm e2e")
    del k
    peak_gate = peak_gib()
    free_card()
    reset_counts()
    sess.fit(shards, epochs=1, steps_per_epoch=1)
    torch.cuda.synchronize()
    calls = sum(dp_ops.plans.values())
    losses = step_losses(sess)
    if kernel_calls != 1 or calls != 1 or not np.isfinite(losses).all():
        raise AssertionError(f"e2e: {kernel_calls} and {calls} dp_release calls, loss {losses}")
    trainable = sess.native_state["flat"].numel()
    emit({"phase": f"{spec.prefix}_train_e2e", "card": smi, "config": spec.config,
          "mode": "e2e", "trainable_params": trainable, "gate": gate, "grad_tol": GRAD_TOL,
          **TRAIN_TOL, "dp_release_calls": calls, "step_loss": losses[0],
          "peak_gib_gate": peak_gate, "peak_gib_step": peak_gib()})


def lm_time(dev, smi: str, sess, shards, decode: dict, release_inputs: dict,
            spec: LMSpec) -> dict:
    """``<prefix>_time``: the end-to-end training rate, steps (and tokens)
    per second of ``sess.fit`` epochs of LM_STEPS (each draws its plan and
    guard noise on the CPU and moves them, as a user's fit does); the
    kernel against the plain release, the step's parts alone along the
    session's state with the plan drawn beforehand, epochs in turns; the
    device's busy share and top kernels over ``profile_steps`` kernel steps
    of the parts;
    decode tokens/s and prefill s from the decode's second run; dp_release
    at the path's cut against its plain version, the plan it beat and its
    bound."""
    rounds = spec.time_rounds
    fit_rates = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.fit(shards, epochs=1, steps_per_epoch=LM_STEPS)
        torch.cuda.synchronize()
        fit_rates.append(LM_STEPS / (time.perf_counter() - t0))
    plan = lm_plan(sess, shards, LM_STEPS, 7, dev, spec.seq)
    native, unravel = sess.native_state, sess.engine._unravel
    parts = {"kernel": lm_parts(sess, True), "plain": lm_parts(sess, False)}

    def epoch(name, steps=LM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch, noise in plan[:steps]:
            g, _ = parts[name].grad(native["flat"], unravel, native["client_banks"], batch,
                                    None, noise)
            parts[name].apply(native["flat"], native["opt"], native["step"], g)
            del g
        torch.cuda.synchronize()
        return steps / (time.perf_counter() - t0)

    for name in parts:
        epoch(name)  # warm-up
    rates = {"kernel": [], "plain": []}
    for r in range(rounds):
        for name in (("kernel", "plain") if r % 2 else ("plain", "kernel")):
            rates[name].append(epoch(name))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch("kernel", spec.profile_steps)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3
    release_ms = sum(e.self_device_time_total for e in dev_events if "dp_release" in e.key) / 1e3
    tokens = 3 * spec.seq
    emit({"phase": f"{spec.prefix}_time", "card": smi, "tf32": False,
          "config": sess.adapter.cfg.name,
          "steps_per_epoch": LM_STEPS, "rounds": rounds, "tokens_per_step": tokens,
          "fit_steps_per_s": float(np.median(fit_rates)),
          "fit_tokens_per_s": float(np.median(fit_rates)) * tokens,
          "fit_steps_per_s_all": fit_rates,
          **{f"{k}_steps_per_s": float(np.median(v)) for k, v in rates.items()},
          **{f"{k}_tokens_per_s": float(np.median(v)) * tokens for k, v in rates.items()},
          **{f"{k}_steps_per_s_all": v for k, v in rates.items()},
          "profiled_steps": spec.profile_steps, "profiled_wall_ms": wall_ms,
          "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
          "dp_release_device_ms_per_step": release_ms / spec.profile_steps,
          "top": [{"name": e.key[:90], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:10]],
          "decode_tokens_per_s": decode["tokens_per_s"], "decode_s": decode["decode_s"],
          "prefill_s": decode["prefill_s"], "decode_batch": spec.decode[0],
          "peak_gib": peak_gib()})
    x, nz = release_inputs[f"{spec.prefix}_cut"]
    sigma = DPConfig().sigma
    fns = (lambda: dp_ops.dp_release_forward(x, nz, 1.0, sigma),
           lambda: dp_release_ref(x, nz, clip_norm=1.0, sigma=sigma))
    k_ms, p_ms = paired_ms(*fns)
    rel_plan = dp_ops.plan_for(x, nz, sigma)
    other = other_release_plan(rel_plan, x.shape[0], int(np.prod(x.shape[1:])),
                               torch.cuda.get_device_properties(dev).multi_processor_count)
    other_ms = paired_ms(fns[0], lambda: dp_ops._launch(x, nz, 1.0, sigma, other["plan"]))[1]
    work = release_work(tuple(x.shape), sigma)
    # the kernel reads x twice where it splits a row (partial sums, then the
    # release): the bound of the bytes it moves, beside the function's
    second = bound(work["bytes"] + (4 * x.numel() if rel_plan["blocks_per_row"] > 1 else 0),
                   work["flops"])
    t = {"case": f"dp_release/{spec.prefix}_cut", "shape": list(x.shape), "sigma": sigma,
         "ms": k_ms, "plain_ms": p_ms, "plan": rel_plan, "other_plan": {**other, "ms": other_ms},
         "library_ms": None, **work, "bound_share": work["bound_ms"] / k_ms,
         "bound_ms_second_read": second["bound_ms"],
         "bound_share_second_read": second["bound_ms"] / k_ms}
    emit({"phase": "time", "card": smi, **t})
    return t


def lm_phases(dev, smi: str, release_inputs: dict, tmp: str, spec: LMSpec) -> dict:
    """One LM path, in order: ``<prefix>_decode``, ``<prefix>_train`` (with
    ``_restore`` and ``_forced``; its checkpoint under ``tmp``, removed
    once restored), ``<prefix>_time`` (the path's cut's release timed on
    ``release_inputs["<prefix>_cut"]``), ``<prefix>_remat`` where
    ``spec.remat`` and ``lm_train_e2e`` where ``spec.e2e``, then each
    phase's wall seconds (``<prefix>_wall``). Returns the decode's and the
    training's results and the timing row."""
    wall = {}
    t0 = time.perf_counter()
    decode = lm_decode(dev, smi, spec)
    wall[f"{spec.prefix}_decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = lm_train(dev, smi, tmp, spec)
    wall[f"{spec.prefix}_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timed = lm_time(dev, smi, lm["session"], lm["shards"], decode, release_inputs, spec)
    wall[f"{spec.prefix}_time"] = time.perf_counter() - t0
    if spec.remat:
        t0 = time.perf_counter()
        lm["remat"] = lm_remat(smi, lm["session"], lm["plan"], spec)
        wall[f"{spec.prefix}_remat"] = time.perf_counter() - t0
    del lm["session"], lm["plan"]
    if spec.e2e:
        t0 = time.perf_counter()
        lm_e2e(dev, smi, lm["shards"], spec)
        wall[f"{spec.prefix}_train_e2e"] = time.perf_counter() - t0
    free_card()
    emit({"phase": f"{spec.prefix}_wall", "card": smi, "phase_wall_s": wall})
    return {"decode": decode, "train": lm, "timed": timed}


def hybrid_phase(dev, smi: str) -> dict:
    """``hybrid_decode`` (``lm_decode`` of HYBRID: bit-equal twice, the CPU
    replay with the routing gate) and ``hybrid_train``: one llm-split step's
    gradient on the card (the release through dp_release) against the CPU
    (the plain release), through the routing gate, then one step of the
    session's fit (one dp_release call, a finite loss)."""
    t0 = time.perf_counter()
    decode = lm_decode(dev, smi, HYBRID)
    cfg = spec_config(HYBRID)
    shards = lm_shards(cfg, SHARES, 1, HYBRID.seq, 0)
    free_card()
    sess = lm_session(dev, HYBRID)
    (batch, noise), = lm_plan(sess, shards, 1, 8, dev, HYBRID.seq)
    native, unravel = sess.native_state, sess.engine._unravel
    cpu_in = (native["flat"].cpu(), tree_map(lambda a: a.cpu(), native["client_banks"]),
              {key: v.cpu() for key, v in batch.items()})
    k, cpu, route = routed_grads(
        lambda: lm_parts(sess, True).grad(native["flat"], unravel, native["client_banks"],
                                          batch, None, noise),
        lambda: lm_parts(sess, False).grad(cpu_in[0], unravel, cpu_in[1], cpu_in[2], None,
                                           noise.cpu()),
        "hybrid cpu")
    gate = grad_gate((k[0].cpu(), {key: v.cpu() for key, v in k[1].items()}), cpu,
                     "hybrid cpu")
    reset_counts()
    lm0 = lm_kernel_counts()
    sess.fit(shards, epochs=1, steps_per_epoch=1)
    torch.cuda.synchronize()
    ran = kernel_counts()
    launches = {**{key: v["launches"] for key, v in ran.items()},
                **{key: v - lm0[key] for key, v in lm_kernel_counts().items()}}
    (release,) = ran["dp_release"]["plans"]
    calls = release["calls"]
    losses = step_losses(sess)
    if (calls != 1 or launches != {"privacy_conv": 0, "flash_attention": 0, "selective_scan": 0,
                                   "dp_release": release["plan"]["launches"]}):
        raise AssertionError(f"hybrid_train launches {ran} {launches}, want one dp_release "
                             "call")
    if not np.isfinite(losses).all():
        raise AssertionError(f"hybrid_train loss {losses}")
    layout = [cfg.layer_kind(i) + ("+moe" if cfg.layer_is_moe(i) else "")
              for i in range(cfg.n_layers)]
    emit({"phase": "hybrid_train", "card": smi, "config": cfg.name, "layers": layout,
          "stack_split": list(stack_split(cfg)),
          "d_model": cfg.d_model, "n_experts": cfg.n_experts, "seq": HYBRID.seq,
          "gate": gate, **route, "grad_tol": GRAD_TOL, **TRAIN_TOL,
          "dp_release_calls": calls, "launches": launches, "step_loss": losses[0],
          "wall_s": time.perf_counter() - t0, "peak_gib": peak_gib()})
    return {"decode": decode, "launches": launches}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them, printed."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


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
    smi = card_line()
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
    banked_inputs = check_banked(gen, dev, errs)
    sigma = DPConfig().sigma
    release_inputs, seen = check_releases(gen, dev, release_cases(sigma), errs)
    if seen != {(k, v, n) for k in (False, True) for v in (False, True) for n in (False, True)}:
        raise AssertionError(f"dp_release plans checked {sorted(seen)}, want k = 1 and k > 1, "
                             "float4 and scalar, each with and without noise")
    half_inputs = check_half(gen, dev, errs, sigma)

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
                             **conv_work(*CONV_CASES["covid"])}
    xt_, wt_, bt_, nzt_ = conv_inputs["train_covid"]
    k_ms, p_ms = paired_ms(lambda: pc_ops.privacy_conv_forward(xt_, wt_, bt_, nzt_, scale),
                           lambda: privacy_conv_ref(xt_, wt_, bt_, nzt_, noise_scale=scale))
    timed["privacy_conv/train_covid"] = {
        "case": "privacy_conv/train_covid", "ms": k_ms, "plain_ms": p_ms,
        "plan": pc_ops.plan_for(xt_, wt_, nzt_, scale), "library_ms": None,
        **conv_work(*CONV_CASES["train_covid"])}
    for case in ("covid", "mura", "train_mura"):
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
    half_timed = time_half(smi, half_inputs)
    del half_inputs

    # ==== the training path: SplitSession.fit of the paper's three models
    build_dir = os.path.join(HERE, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        covid = train_covid(dev, smi, tmp)
    mura_launches = train_mura(dev, smi)
    quickstart(dev)
    train_device_ms = train_time(dev, smi, covid["shards"])

    # ==== the queue path: protocol-async and fused-queue, faults, threads
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        queue = queue_covid(dev, smi, tmp)
    queue_fault_launches = queue_faults(dev, smi)
    queue_thread_launches = queue_threaded(dev, smi)
    queue_timed = queue_time(dev, smi, banked_inputs, release_inputs["fleet_cycle"])

    # ==== FedAvg and the inversion audit at COVID-CT width
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        fed = fedavg_covid(dev, smi, tmp, covid["evaluate"])
    audit = audit_covid(dev, smi, fed["session"])
    fed_timed = fedavg_time(dev, smi, conv_inputs, release_inputs, audit)

    # ==== the LM path: the LM kernels' entry points at the configs' widths
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

    # ==== the LM workload at llama3.2-1b's, granite-moe-1b-a400m's and
    # falcon-mamba-7b's published widths: decode, then split training; then
    # jamba's layer pattern at reduced widths
    del attn, attn_out, scan_in, scan_out
    lm_paths = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        for prefix, spec in LM_SPECS.items():
            lm_paths[prefix] = lm_phases(dev, smi, release_inputs, tmp, spec)
    hybrid = hybrid_phase(dev, smi)
    decode, lm, lm_timed = (lm_paths["lm"][k] for k in ("decode", "train", "timed"))

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
    training = {"privacy_conv": {"train_covid": covid["covid"]["privacy_conv"], "train_mura": 0},
                "dp_release": {"train_covid": covid["covid"]["dp_release"],
                               "train_mura": mura_launches["dp_release"]}}
    # device ms a call at a training shape (a client's batch; MURA's cut)
    training_ms = {"privacy_conv": timed["privacy_conv/train_covid"],
                   "dp_release": timed["dp_release/train_mura"]}
    # launches on the queue path, each phase's run read apart (queue_covid:
    # the calibrated-sigma runs, fleet and per item, each engine)
    calibrated = queue["sigma"]["calibrated"]["counts"]
    queue_launches = {
        name: {"queue_covid": {k: v[name] for k, v in calibrated.items()},
               "queue_faults": queue_fault_launches["chaos"][name],
               "queue_threaded": queue_thread_launches[name]}
        for name in ("privacy_conv", "dp_release")}
    # launches on the audit path: the session's sweep (the adapter's kernel,
    # the plain guard) and the sweep with the release kernel
    audit_launches = {
        name: {"session": audit["session"][i], "kernel_release": audit["kernel_release"][i]}
        for i, name in enumerate(("privacy_conv", "dp_release"))}
    queue_case = {"privacy_conv": ("privacy_conv_banked/fleet_covid", queue_timed["privacy_conv"]),
                  "dp_release": ("dp_release/fleet_cycle", queue_timed["dp_release"])}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep_line,
         "launches": counts[name], "max_abs_err": errs[case], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": t["library_ms"],
         "launches_training": training.get(name, {"train_covid": 0, "train_mura": 0}),
         "training_device_ms_per_step": train_device_ms.get(name),
         "training_case": training_ms[name]["case"] if name in training_ms else None,
         "training_ms": training_ms[name]["ms"] if name in training_ms else None,
         "launches_queue": queue_launches.get(name),
         "queue_case": queue_case[name][0] if name in queue_case else None,
         "queue_max_abs_err": errs[queue_case[name][0]] if name in queue_case else None,
         **({f"queue_{k}": queue_case[name][1][k]
             for k in ("ms", "plain_ms", "bound_ms", "bound_by")} if name in queue_case else {}),
         "launches_fedavg": fed["launches"].get(name, 0),
         "fedavg_device_ms_per_local_step": fed_timed["device_ms_per_local_step"].get(name),
         "launches_audit": audit_launches.get(name, {"session": 0, "kernel_release": 0}),
         **{f"{slice_}_{k}": (fed_timed["timed"][f"{name}/{case_}"][k]
                              if f"{name}/{case_}" in fed_timed["timed"] else None)
            for slice_, case_ in (("fedavg", "fedavg_local"), ("audit", "audit"))
            for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by")},
         # the LM workload: launches on each path's decode and training
         # (the decode's two runs, the training's 2 x 3 steps; the hybrid's
         # one fit step), and each path's cut
         "launches_lm": {f"{p}_{phase}": out[key]["launches"][name]
                         for p, out in lm_paths.items()
                         for phase, key in (("decode", "decode"), ("train", "train"))}
         | {"hybrid_train": hybrid["launches"][name]},
         **({f"{p}_{k}": out["timed"][k] for p, out in lm_paths.items()
             for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_second_read")}
            | {f"{p}_max_abs_err": errs[f"dp_release/{p}_cut"] for p in lm_paths}
            | {f"{p}_train_calls": out["train"]["calls"] for p, out in lm_paths.items()}
            if name == "dp_release" else {}),
         # the half types (check only: the paths run float32)
         "half": [{k: t[k] for k in ("case", "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "max_ulps")}
                  for case, t in half_timed.items() if case.startswith(name + "/")]}
        for name, src, rep_line, case, t, counts in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
