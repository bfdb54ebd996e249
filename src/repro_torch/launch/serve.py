"""Serving driver: batched prefill + autoregressive decode with KV caches,
as ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch demo-11m --batch 4 \
      --prompt-len 64 --gen 32 [--device cpu]

The LM GENERATION driver: one whole model (client embedding + trunk)
decoding against preallocated KV caches, prefilling by replaying the prompt
through ``serve_step`` so that prefill and decode share one cache layout.
``--smoke`` asserts the decode step's shape and dtype at every step and that
greedy decoding (temperature 0) is deterministic: two runs give bit-equal
token streams. Like the reference's, it builds the named config at full
size. Every family decodes: an attention layer against its KV cache, a
mamba layer against its conv ring and SSM state, a MoE layer routing the
step's tokens. Two options are the port's additions: ``--device`` picks the
device (the default is the card), and ``--reduced`` runs the arch's
``reduced()`` config, which a 7B arch needs on a CPU.

Sampling above temperature 0 draws Gumbel noise from a CPU
``torch.Generator`` seeded with ``--seed`` (the reference folds the step
into a JAX key), so a seed gives one stream.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device, seeded_generator
from repro_torch.configs import get_config
from repro_torch.data.lm import token_stream
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import ModelOptions


def sample_logits(generator: Optional[torch.Generator], logits: torch.Tensor,
                  temperature: float = 0.8) -> torch.Tensor:
    """Temperature 0: the argmax. Above 0: a categorical draw by the Gumbel
    trick, the uniforms from ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=generator.device).clamp_(min=tiny).to(logits.device)
    return torch.argmax(logits.float() / temperature - torch.log(-torch.log(u)), dim=-1)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Batched prefill + KV-cache decode for the LM configs")
    ap.add_argument("--arch", default="demo-11m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--reduced", action="store_true",
                    help="run the arch's reduced() config (2-4 layers, d_model <= 256)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI run: assert decode shape/dtype stability "
                         "and greedy determinism at temperature 0")
    return ap


def make_prompts(cfg, batch: int, prompt_len: int, seed: int, device=None) -> torch.Tensor:
    """The driver's synthetic int32 prompt batch on ``device`` (``None``:
    the card), deterministic given the seed."""
    stream = token_stream(cfg.vocab_size, batch * prompt_len + 1, seed=seed)
    return torch.as_tensor(stream[: batch * prompt_len].reshape(batch, prompt_len),
                           device=resolve_device(device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_and_decode(cfg, params, prompts: torch.Tensor, *, gen: int,
                       temperature: float = 0.8, seed: int = 0,
                       opts: Optional[ModelOptions] = None,
                       check_steps: bool = False) -> Dict[str, object]:
    """Prefill the KV caches by replaying the prompt through ``serve_step``,
    then decode ``gen`` tokens. Returns the generated ``tokens [batch,
    gen]`` (NumPy), the tokens per second of the decode and the prefill and
    decode seconds (the host's clock, the device synchronised); with
    ``check_steps`` asserts that every step's logits keep one shape and
    dtype."""
    batch, prompt_len = prompts.shape
    max_seq = prompt_len + gen
    if opts is None:
        opts = ModelOptions(q_block=min(512, prompt_len), kv_block=min(512, prompt_len))
    device = prompts.device
    state = model_lib.init_decode_state(cfg, batch, max_seq, torch.float32, device)
    generator = seeded_generator(seed)
    expect = None

    def checked(logits):
        nonlocal expect
        if check_steps:
            sig = (tuple(logits.shape), logits.dtype)
            if expect is None:
                expect = sig
                assert sig[0] == (batch, 1, cfg.vocab_size), sig
            assert sig == expect, f"decode step drifted: {sig} != {expect}"
        return logits

    with torch.no_grad():
        t0 = time.time()
        logits = None
        for t in range(prompt_len):
            logits, state = model_lib.serve_step(params, cfg, state, prompts[:, t: t + 1], t,
                                                 opts)
            checked(logits)
        _sync(device)
        t_prefill = time.time() - t0

        out_tokens = []
        tok = sample_logits(generator, logits[:, 0], temperature)[:, None]
        t0 = time.time()
        for t in range(prompt_len, max_seq):
            out_tokens.append(tok.cpu().numpy())
            logits, state = model_lib.serve_step(params, cfg, state, tok, t, opts)
            checked(logits)
            tok = sample_logits(generator, logits[:, 0], temperature)[:, None]
        _sync(device)
        t_decode = time.time() - t0

    return {
        "tokens": np.concatenate(out_tokens, axis=1),
        "tokens_per_s": batch * gen / t_decode if t_decode > 0 else 0.0,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
    }


def _model(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    assert not cfg.is_encoder_only, "encoder-only archs have no decode step"
    device = resolve_device(args.device)
    params = model_lib.init_model(seeded_generator(args.seed), cfg, torch.float32, device)
    return cfg, params, make_prompts(cfg, args.batch, args.prompt_len, args.seed, device)


def run_smoke(args) -> Dict[str, object]:
    """The CI smoke: a greedy double run, asserting each step's shape and
    dtype (``check_steps``) and bit-equal token streams."""
    cfg, params, prompts = _model(args)
    runs = [prefill_and_decode(cfg, params, prompts, gen=args.gen, temperature=0.0,
                               seed=args.seed, check_steps=True) for _ in range(2)]
    a, b = runs[0]["tokens"], runs[1]["tokens"]
    assert a.shape == (args.batch, args.gen), a.shape
    np.testing.assert_array_equal(a, b, err_msg="greedy decode is not deterministic")
    print(f"SMOKE OK arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} greedy-deterministic")
    return runs[0]


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.smoke:
        result = run_smoke(args)
        return {k: result[k] for k in ("tokens_per_s", "prefill_s", "decode_s")}

    cfg, params, prompts = _model(args)
    result = prefill_and_decode(cfg, params, prompts, gen=args.gen,
                                temperature=args.temperature, seed=args.seed)
    gen, tps = result["tokens"], result["tokens_per_s"]
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill {result['prefill_s']:.2f}s, decode {result['decode_s']:.2f}s "
          f"-> {tps:.1f} tok/s")
    print("sample generations (token ids):")
    for b in range(min(2, args.batch)):
        print(f"  req{b}: {gen[b][:16].tolist()}...")
    return {k: result[k] for k in ("tokens_per_s", "prefill_s", "decode_s")}


if __name__ == "__main__":
    main()
