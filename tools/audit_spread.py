#!/usr/bin/env python3
"""How far the inversion audit's sweeps part across paths, over start points.

    python3 tools/audit_spread.py [--seeds 16]

Trains hospital 0's privacy layer as ``chip_smoke.py``'s ``fedavg_covid``
does (the FedAvg engine at COVID-CT width, 2 rounds and then one more),
then runs ``chip_smoke.py``'s four audit sweeps (the session's with the
kernel, the kernel's with the release kernel, the plain versions' on the
card and on the CPU; sigma 0, 0.5 and 4, 120 attack steps each) for each
start-point and noise seed, and holds each against the session's sweep
as ``audit_covid`` does: L1 distance of the reconstructions, elements
parted, and the MSE, PSNR and NCC differences. Prints one JSON line per
seed, then one with the largest of each quantity over all seeds by path,
after the card's name and power limit; ``chip_smoke.py``'s sweep limits
are read from that line. TF32 off, cuDNN deterministic. Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("audit_spread: no CUDA device is available; this script runs on the card")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build()
    sess = cs.fedavg_run(dev)[0]
    sess.fit(cs.queue_shards(), epochs=1, steps_per_epoch=cs.FEDAVG_STEPS)
    x, _, fwds = cs.audit_setup(dev, sess)
    worst: dict = {}
    for seed in range(args.seeds):
        sweeps, _, recs = cs.audit_sweeps(sess, fwds, x, seed)
        spread = cs.sweep_spread(sweeps, recs)
        cs.emit({"seed": seed, "card": smi, "sweep_vs_session": spread,
                 "session_mse": [r["mse"] for r in sweeps["session"]]})
        for name, e in spread.items():
            w = worst.setdefault(name, {})
            for k, v in e.items():
                w[k] = max(w.get(k, 0), max(v))
    cs.emit({"seeds": args.seeds, "card": smi, "steps": cs.AUDIT_STEPS,
             "sigmas": list(cs.AUDIT_SIGMAS), "largest": worst})


if __name__ == "__main__":
    main()
