"""The port's LM generation driver (``repro_torch.launch.serve``) against
``repro.launch.serve``: greedy tokens equal to the reference's on the same
(bridged) weights and prompts, the argparse surface, the ``--smoke``
contract and seeded sampling."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as jserve
from repro.models import model as jm
from repro_torch.common.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as tm

BATCH, PROMPT, GEN = 2, 6, 8


@pytest.fixture(scope="module")
def lm():
    """llama3.2-1b reduced to 3 layers (tied embeddings), the reference's
    weights on both sides."""
    jcfg = dataclasses.replace(j_get_config("llama3.2-1b").reduced(), n_layers=3)
    tcfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), n_layers=3)
    jp = jm.init_model(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, tcfg, jp, to_torch(jp, "cpu")


def test_greedy_tokens_match_jax(lm):
    jcfg, tcfg, jp, tp = lm
    prompts = serve.make_prompts(tcfg, BATCH, PROMPT, seed=0, device="cpu")
    np.testing.assert_array_equal(prompts.numpy(),
                                  np.asarray(jserve.make_prompts(jcfg, BATCH, PROMPT, seed=0)))
    want = jserve.prefill_and_decode(jcfg, jp, jnp.asarray(prompts.numpy()), gen=GEN,
                                     temperature=0.0)["tokens"]
    got = serve.prefill_and_decode(tcfg, tp, prompts, gen=GEN, temperature=0.0,
                                   check_steps=True)
    assert got["tokens"].shape == (BATCH, GEN)
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["prefill_s"] > 0 and got["tokens_per_s"] > 0


def test_sampling_is_seeded(lm):
    """Above temperature 0 a seed gives one stream, and another seed
    (almost surely) another; temperature 0 is the argmax."""
    _, tcfg, _, tp = lm
    prompts = serve.make_prompts(tcfg, BATCH, PROMPT, seed=1, device="cpu")
    runs = [serve.prefill_and_decode(tcfg, tp, prompts, gen=GEN, temperature=1.5,
                                     seed=s)["tokens"] for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 0.0, 1.0]])
    assert serve.sample_logits(None, logits, 0.0).tolist() == [1, 0]


def test_decode_step_drift_is_caught(lm, monkeypatch):
    _, tcfg, _, tp = lm
    real_step = tm.serve_step

    def broken_step(*args):
        logits, state = real_step(*args)
        return logits[..., None], state  # a cache layout bug: an extra axis

    monkeypatch.setattr(tm, "serve_step", broken_step)
    with pytest.raises(AssertionError):
        serve.prefill_and_decode(tcfg, tp, serve.make_prompts(tcfg, 1, 3, 1, "cpu"), gen=2,
                                 temperature=0.0, check_steps=True)


def test_argparse_round_trip():
    ap = serve.build_parser()
    args = ap.parse_args(["--arch", "llama3.2-1b", "--batch", "3", "--prompt-len", "16",
                          "--gen", "8", "--temperature", "0.0", "--seed", "7", "--smoke",
                          "--device", "cpu"])
    assert (args.arch, args.batch, args.prompt_len, args.gen) == ("llama3.2-1b", 3, 16, 8)
    assert args.temperature == 0.0 and args.seed == 7 and args.smoke and args.device == "cpu"
    d = ap.parse_args([])
    want = jserve.build_parser().parse_args([])
    # the port's additions: --device and --reduced
    assert {k: v for k, v in vars(d).items() if k not in ("device", "reduced")} == vars(want)
    assert d.device is None and not d.reduced  # the card, the named config


def test_main_smoke_and_regular(capsys):
    common = ["--arch", "demo-11m", "--batch", "1", "--prompt-len", "4", "--gen", "3",
              "--device", "cpu"]
    assert set(serve.main(["--smoke"] + common)) == {"tokens_per_s", "prefill_s", "decode_s"}
    assert "SMOKE OK" in capsys.readouterr().out
    assert serve.main(common + ["--temperature", "0.0"])["tokens_per_s"] > 0
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b",
                                  "granite-moe-1b-a400m"])
def test_family_greedy_tokens_match_jax(arch):
    """The SSM, hybrid and MoE families at their reduced widths: greedy
    tokens equal to the reference's on its weights (the SSM state and the
    MoE routing carried through the prompt and the generation)."""
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jm.init_model(jax.random.PRNGKey(1), jcfg, jnp.float32)
    prompts = serve.make_prompts(tcfg, BATCH, PROMPT, seed=2, device="cpu")
    want = jserve.prefill_and_decode(jcfg, jp, jnp.asarray(prompts.numpy()), gen=GEN,
                                     temperature=0.0)["tokens"]
    got = serve.prefill_and_decode(tcfg, to_torch(jp, "cpu"), prompts, gen=GEN,
                                   temperature=0.0, check_steps=True)
    np.testing.assert_array_equal(got["tokens"], want)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b"])
def test_smoke_runs_the_reduced_family(arch, capsys):
    """``--smoke --reduced --device cpu`` of each family: its reduced
    config, greedy and deterministic."""
    serve.main(["--smoke", "--reduced", "--arch", arch, "--batch", "2", "--prompt-len", "4",
                "--gen", "3", "--device", "cpu"])
    assert f"SMOKE OK arch={arch}-smoke" in capsys.readouterr().out


class _Built(Exception):
    pass


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["demo-11m", "llama3.2-1b", "falcon-mamba-7b"])
def test_smoke_builds_the_references_config(arch, reduced, monkeypatch):
    """``--smoke`` builds the config the reference's ``--smoke`` builds: the
    named one at full size; ``--reduced`` (the port's option, which the
    reference lacks) builds the reference's ``reduced()`` of it. Each
    side's ``init_model`` records its config and stops the run."""
    built = {}

    def recording(side):
        def init_model(key, cfg, *args, **kwargs):
            built[side] = dataclasses.asdict(cfg)
            raise _Built
        return init_model

    monkeypatch.setattr(jm, "init_model", recording("jax"))
    monkeypatch.setattr(tm, "init_model", recording("torch"))
    with pytest.raises(_Built):
        jserve.main(["--smoke", "--arch", arch])
    with pytest.raises(_Built):
        serve.main(["--smoke", "--arch", arch, "--device", "cpu"]
                   + (["--reduced"] if reduced else []))
    want = j_get_config(arch).reduced() if reduced else j_get_config(arch)
    assert built["torch"] == dataclasses.asdict(want)
    if not reduced:
        assert built["torch"] == built["jax"]
