"""End-to-end spatio-temporal split-learning LM training driver, as
``repro.launch.train``: N clients over a synthetic token corpus, the
detached privacy cut, AdamW on the server trunk, checkpoints and metrics,
through ``SplitSession(engine="llm-split")``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch demo-11m --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --arch demo-100m --steps 300 \
      --batch 8 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch demo-11m --dp-sigma 0.1

The reference's flags, plus ``--device`` (default: the card). ``--dp-sigma``
builds the reference's UNCLIPPED guard, which runs no kernel; a clipped
``DPConfig`` goes through the session directly.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.common.tree import tree_size
from repro_torch.configs import get_config
from repro_torch.core import SplitSession, SplitTrainConfig
from repro_torch.core.distributed import llm_adapter
from repro_torch.data.lm import token_stream, token_windows
from repro_torch.models.transformer import ModelOptions
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.privacy import DPConfig


def lm_shards(cfg, shares, batch: int, seq: int, seed: int):
    """Each client's own synthetic corpus shard, ``(windows, windows)``: the
    7:2:1 imbalance comes from the window count (sampling recirculates the
    small shards)."""
    shards = []
    for c, s in enumerate(shares):
        stream = token_stream(cfg.vocab_size, max(int(2e5 * s), 4 * batch * seq),
                              seed=seed + c)
        windows = token_windows(stream, max(4 * batch, int(2000 * s)), seq, seed=seed + 10 + c)
        shards.append((windows, windows))
    return shards


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo-11m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4, help="per-client batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mode", choices=["detached", "e2e"], default="detached",
                    help="detached = paper's temporal split; e2e = classic split learning")
    ap.add_argument("--dp-sigma", type=float, default=0.0,
                    help="PrivacyGuard noise at the cut (0 = guard off)")
    ap.add_argument("--shared-bank", action="store_true",
                    help="one shared client bank (detached only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None, help="write metrics JSON here")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    opts = ModelOptions(q_block=min(512, args.seq), kv_block=min(512, args.seq))
    opt = adamw(linear_warmup_cosine(args.lr, 20, args.steps))
    shares = np.array([0.7, 0.2, 0.1] if args.clients == 3
                      else [1 / args.clients] * args.clients)
    privacy = (DPConfig(clip_norm=None, noise_scale=args.dp_sigma)
               if args.dp_sigma > 0 else None)
    tc = SplitTrainConfig(
        n_clients=args.clients, data_shares=tuple(float(s) for s in shares),
        server_batch=args.clients * args.batch, mode=args.mode, privacy=privacy)
    session = SplitSession(llm_adapter(cfg, opts, torch.float32), tc, opt, engine="llm-split",
                           seed=args.seed, shared_bank=args.shared_bank, device=args.device)
    n_params = tree_size(session.state["server"])
    print(f"arch={cfg.name} server params={n_params/1e6:.1f}M clients={args.clients}")

    shards = lm_shards(cfg, shares, args.batch, args.seq, args.seed)
    steps_per_epoch = max(1, min(args.log_every, args.steps))
    epochs = max(1, -(-args.steps // steps_per_epoch))
    history = []
    t0 = time.time()
    for ep in range(epochs):
        rec = session.fit(shards, epochs=1, steps_per_epoch=steps_per_epoch)[0]
        rec = {"step": (ep + 1) * steps_per_epoch, "loss": rec["loss"],
               "ce": rec["ce"], "grad_norm": rec["grad_norm"],
               "elapsed_s": round(time.time() - t0, 1)}
        history.append(rec)
        print(rec)
        if args.ckpt_dir and ((ep + 1) * steps_per_epoch) % args.ckpt_every == 0:
            session.save(args.ckpt_dir, {"arch": cfg.name, "loss": rec["loss"]})

    first, last = history[0]["ce"], history[-1]["ce"]
    print(f"ce: {first:.4f} -> {last:.4f} ({'improved' if last < first else 'NOT improved'})")
    if privacy is not None:
        print("privacy:", session.privacy_report())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=2)
    return history


if __name__ == "__main__":
    main()
