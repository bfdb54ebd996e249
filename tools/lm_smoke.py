#!/usr/bin/env python3
"""The LM phases of ``chip_smoke.py`` alone, for iterating on the LM paths.

    python3 tools/lm_smoke.py [--paths lm moe ssm hybrid] [--cpu-seq N] [--half]

Builds the kernels, checks ``dp_release`` at the cut of each chosen path
(``chip_smoke.check_releases`` on ``<path>_cut`` with and without noise),
then runs ``chip_smoke.lm_phases`` for each of ``lm`` (llama3.2-1b),
``moe`` (granite-moe-1b-a400m) and ``ssm`` (falcon-mamba-7b at 12 layers)
chosen, and ``chip_smoke.hybrid_phase`` for ``hybrid`` (jamba's layer
pattern at reduced widths), after the card's name and power limit;
``--half`` then adds ``chip_smoke.check_half`` (the serving kernels in
bfloat16 and float16) and times it. ``--cpu-seq`` sets the sequence
length of the training step that each path's ``_forced`` phase retakes on
the CPU, to read what the card's window would cost the host. TF32 off.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--paths", nargs="+", default=["lm", "moe", "ssm", "hybrid"],
                    choices=[*cs.LM_SPECS, "hybrid"])
    ap.add_argument("--cpu-seq", type=int, default=None)
    ap.add_argument("--half", action="store_true")
    args = ap.parse_args()
    if args.cpu_seq is not None:
        cs.LM_SPECS = {k: dataclasses.replace(v, cpu_seq=args.cpu_seq)
                       for k, v in cs.LM_SPECS.items()}
    if not torch.cuda.is_available():
        sys.exit("lm_smoke: no CUDA device is available; this script runs on the card")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.card_line()
    cs.build.build()
    gen = torch.Generator().manual_seed(1)
    sigma = cs.DPConfig().sigma
    cases = {k: v for k, v in cs.release_cases(sigma).items()
             if k.split("_cut")[0] in args.paths and "_cut" in k}
    release_inputs, _ = cs.check_releases(gen, dev, cases, {})
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        for prefix in args.paths:
            if prefix in cs.LM_SPECS:
                cs.lm_phases(dev, smi, release_inputs, tmp, cs.LM_SPECS[prefix])
    if "hybrid" in args.paths:
        cs.hybrid_phase(dev, smi)
    if args.half:
        cs.time_half(smi, cs.check_half(gen, dev, {}, sigma))


if __name__ == "__main__":
    main()
