#!/usr/bin/env python3
"""The LM phases of ``chip_smoke.py`` alone, for iterating on the LM path.

    python3 tools/lm_smoke.py [--cpu-seq 512]

Builds the kernels, checks ``dp_release`` at the LM cut (``[3, 512, 2048]``,
with and without noise; ``chip_smoke.check_releases``), then runs
``chip_smoke.lm_phases`` (``lm_decode``, ``lm_train`` with its restore and
forced-step gates, ``lm_time``, ``lm_train_e2e`` at llama3.2-1b's published
width), after the card's name and power limit. ``--cpu-seq`` sets the
sequence length of the training step that ``lm_forced`` retakes on the CPU
(the smoke's ``LM_CPU_SEQ``), to read what the card's 512 would cost the
host. TF32 off. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-seq", type=int, default=cs.LM_CPU_SEQ)
    cs.LM_CPU_SEQ = ap.parse_args().cpu_seq
    if not torch.cuda.is_available():
        sys.exit("lm_smoke: no CUDA device is available; this script runs on the card")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.card_line()
    cs.build.build()
    cases = {k: v for k, v in cs.release_cases(cs.DPConfig().sigma).items()
             if k.startswith("lm_cut")}
    release_inputs, _ = cs.check_releases(torch.Generator().manual_seed(1), dev, cases, {})
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        cs.lm_phases(dev, smi, release_inputs, tmp)


if __name__ == "__main__":
    main()
