"""The LM training runner: the consortium trains a language model through
``SplitSession(llm_adapter(cfg, opts), ..., engine="llm-split")``.

A unit of work is one ``fit(shards, epochs=1, steps_per_epoch=1)`` call,
which draws its epoch's plan as a user's call does. Each hospital's shard
is ``shard_rows`` token windows of ``window`` tokens (``weights_lm``'s
packed documents), and a step takes ``server_batch / hospitals`` windows a
hospital. The mix's parameters: ``mode`` ("detached", the temporal split),
``window``, ``server_batch``, ``doc_median``, ``doc_sigma``, ``eod_id``,
``shard_rows``, ``optimizer`` (AdamW's lr, b1, b2, eps, weight decay),
``grad_clip``, ``remat`` (every server block checkpointed), ``q_block`` and
``kv_block`` (attention's blocks; masked blocks skipped), ``check_steps``
(the first steps the reference follows) and ``trace_seconds``. The
configuration gives the model (the HF ``config.json`` keys), its dtype,
the cut, ``privacy_noise``, the guard and the hospitals.

Correct, as ``train``'s: set-up drives the session through its first
``check_steps`` steps with the window's own call, keeping the loss a
step, the first step's gradient as AdamW got it (its first moment over
1 - b1) a leaf and the change of the trunk's weights after the last step
a leaf, each gradient and change as a norm. After the window, with the
program's state freed, the plain reference (``reference/jamba.py``,
computed in float32, its weights in the configuration's types) follows the same steps
from the same weights, tokens and noise (the plan worked out again from
the seed). The numbers compared: ``loss_gap``, the first step's relative
loss gap; ``grad_gap`` and ``update_gap``, the worst leaf's gap of norms
over the larger of its reference norm and the median leaf's, over the
leaves whose reference gradient is above a thousandth of the median
leaf's. The control is the reference computed in bfloat16 throughout (the
scan's state, the norms, the logits and the loss too) in the program's
place.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import program, work, work_lm
from perfbench.clock import Phases
from perfbench.reference import cnn as ref_util
from perfbench.reference import draws
from perfbench.reference import jamba as ref
from perfbench.weights import leaves
from perfbench.weights_lm import make_tokens, make_weights


def model_config(cfg: dict):
    """The port's ``JambaConfig`` of a configuration file."""
    from repro_torch.configs.jamba import JambaConfig

    if cfg["model"] != "jamba" or cfg["loss"] != "next_token_ce":
        raise ValueError(f"{cfg['name']}: the LM runner takes Jamba with a next-token loss")
    if cfg["num_experts"] != 1 or not cfg["mamba_conv_bias"] or cfg["mamba_proj_bias"]:
        raise ValueError(f"{cfg['name']}: the port's Jamba has no MoE, a conv bias and no "
                         "projection bias")
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return JambaConfig(
        name=cfg["name"], family="hybrid", n_layers=cfg["num_hidden_layers"], d_model=d,
        n_heads=H, n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], head_dim=d // H, attn_period=cfg["attn_layer_period"],
        attn_offset=cfg["attn_layer_offset"], ssm_state=cfg["mamba_d_state"],
        ssm_expand=cfg["mamba_expand"], ssm_conv=cfg["mamba_d_conv"],
        dt_rank=cfg["mamba_dt_rank"], norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["dtype"],
        cut_layers=cfg["cut_layers"], privacy_noise=cfg["privacy_noise"])


def session(cfg: dict, mix: dict, seed: int, device):
    """A ``SplitSession`` (engine "llm-split") of the configuration."""
    from repro_torch.core.distributed import llm_adapter
    from repro_torch.core.session import SplitSession
    from repro_torch.core.trainer import SplitTrainConfig
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.optim.optimizers import adamw
    from repro_torch.privacy.guard import DPConfig

    g, o = cfg["guard"], mix["optimizer"]
    opts = ModelOptions(q_block=mix["q_block"], kv_block=mix["kv_block"],
                        skip_masked_blocks=True, remat=mix["remat"])
    adapter = llm_adapter(model_config(cfg), opts, getattr(torch, cfg["dtype"]))
    tc = SplitTrainConfig(n_clients=cfg["hospitals"], data_shares=tuple(cfg["shares"]),
                          server_batch=mix["server_batch"], mode=mix["mode"],
                          privacy=DPConfig(epsilon=g["epsilon"], delta=g["delta"],
                                           clip_norm=g["clip_norm"], use_kernel=g["use_kernel"]),
                          grad_clip=mix["grad_clip"])
    optimizer = adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                      weight_decay=o["weight_decay"])
    return SplitSession(adapter, tc, optimizer, engine="llm-split", seed=seed, device=device)


def scan_counters():
    """The scan kernel's forward and backward launch counters."""
    from repro_torch.kernels.selective_scan import ops

    return ops.launches, ops.backward_launches


class Runner:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        if mix["mode"] != "detached":
            raise ValueError("the LM runner's reference follows the detached split")
        model_config(cfg)  # a program without the configuration's type fails here, at once
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), device
        self.c = cfg["hospitals"]
        self.b = max(1, mix["server_batch"] // self.c)
        self.losses = []
        self._batches = self._want = None
        self.phases = Phases(device)

    def _fit(self):
        return self.sess.fit(self.shards, epochs=1, steps_per_epoch=1)

    def _canonical(self):
        """The session's canonical state as views of its buffers (no copy)."""
        return self.sess.engine.to_canonical(self.sess.native_state)

    @torch.no_grad()
    def _put_weights(self, weights: dict) -> None:
        """The benchmark's weights into the session's buffers, read back."""
        state = self._canonical()
        for key in ("client_banks", "server"):
            dst, src = leaves(state[key]), leaves(weights[key])
            if [(tuple(d.shape), d.dtype) for d in dst] != [(tuple(s.shape), s.dtype)
                                                             for s in src]:
                raise RuntimeError(f"the session's {key} is not the configuration's")
            for d, s in zip(dst, src):
                d.copy_(s)
        state = self._canonical()
        for key in ("client_banks", "server"):
            if not all(torch.equal(d, s) for d, s in zip(leaves(state[key]),
                                                           leaves(weights[key]))):
                raise RuntimeError(f"the session did not take the benchmark's {key}")

    def setup(self):
        with self.phases("session"):
            self.sess = session(self.cfg, self.mix, self.seed, self.device)
        with self.phases("weights"):
            weights = make_weights(self.cfg, self.seed, self.device, self.c)
            self._put_weights(weights)
        with self.phases("data"):
            self.shards = [(t, t) for t in make_tokens(self.mix, self.cfg, self.seed, self.c)]
        with self.phases("first_steps"):
            self._first_steps(weights["server"])

    def _first_steps(self, start_server):
        """The first ``check_steps`` steps through the window's own call,
        keeping what the reference is compared with."""
        self.prog_loss = []
        b1 = self.mix["optimizer"]["b1"]
        for step in range(self.mix["check_steps"]):
            self.prog_loss.append(float(self._fit()[0]["loss"]))
            if step == 0:
                mu = self._canonical()["opt"]["mu"]
                self.prog_grad = [ref_util.norm(g) / (1 - b1) for g in leaves(mu)]
        self.prog_change = [ref_util.norm(a.float() - b.float())
                            for a, b in zip(leaves(self._canonical()["server"]),
                                            leaves(start_server))]

    # ------------------------------------------------------------ window
    def start_window(self):
        self.losses = []
        self.launches0 = program.Launches.now()
        self.scan0 = scan_counters()

    def unit(self):
        self.losses.append(float(self._fit()[0]["loss"]))

    def end_to_end(self, window_s: float) -> dict:
        return {"train_samples_per_s": len(self.losses) * self.c * self.b / window_s}

    def attempted_failed(self):
        return len(self.losses), sum(not np.isfinite(v) for v in self.losses)

    def counts(self) -> dict:
        launched = program.Launches.now().since(self.launches0)
        fwd, bwd = (a - b for a, b in zip(scan_counters(), self.scan0))
        steps, S, d = len(self.losses), self.mix["window"], self.cfg["hidden_size"]
        rows = self.c * self.b
        di, st = self.cfg["mamba_expand"] * d, self.cfg["mamba_d_state"]
        u_bytes = torch.finfo(getattr(torch, self.cfg["dtype"])).bits // 8
        return {"steps": steps, "rows": steps * rows,
                "dp_release_calls": launched.dp_release_calls,
                "dp_release_shape": (rows, S, d), "dp_release_x_bytes": u_bytes,
                "dp_release_noise_bytes": 4,
                "model_flops": steps * work_lm.lm_train_flops(self.cfg, rows, S),
                # the client's launches, one a hospital a step, take no
                # gradient and write no checkpoints; every other forward
                # and every backward is the trunk's, over all the rows
                "scan_forward_launches": fwd, "scan_backward_launches": bwd,
                "scan_client_launches": min(fwd, steps * self.c),
                "scan_trunk_shape": (rows, S, di, st), "scan_client_shape": (self.b, S, di, st),
                "scan_u_bytes": u_bytes}

    def release(self):
        del self.sess
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def batches(self):
        """The first ``check_steps`` steps' batches, the plan worked out
        again from the seed, on the device (made once)."""
        if self._batches is None:
            lens = [len(x) for x, _ in self.shards]
            feat = (self.mix["window"], self.cfg["hidden_size"])
            sigma = work.sigma(self.cfg["guard"])
            out = []
            for epoch in range(1, self.mix["check_steps"] + 1):
                idx, mn, gn = draws.train_plan(self.seed, epoch, lens, 1, self.b, feat,
                                               self.cfg["privacy_noise"] > 0, sigma > 0)
                toks = torch.stack([torch.as_tensor(self.shards[c][0][idx[0, c].numpy()])
                                    for c in range(self.c)])
                dev = lambda a: None if a is None else a[0].to(self.device)  # noqa: E731
                out.append({"tokens": toks.to(self.device), "model_noise": dev(mn),
                            "guard_noise": dev(gn)})
            self._batches = out
        return self._batches

    def reference(self, dtype=torch.float32, keep=None):
        """The reference's losses, first gradient and change, a norm a leaf
        (the float32 reference's made once)."""
        sound = dtype == torch.float32 and keep is None
        if sound and self._want is not None:
            return self._want
        weights = make_weights(self.cfg, self.seed, self.device, self.c)
        start = [t.clone() for t in ref.leaves(weights["server"])]
        with ref_util.precision("float32"):
            losses, grad = ref.train_steps(
                ref.Jamba(self.cfg, dtype), weights["client_banks"], weights["server"],
                self.batches(), self.cfg["guard"], work.sigma(self.cfg["guard"]),
                self.mix["optimizer"], self.mix["grad_clip"], keep=keep)
        change = [ref_util.norm(a.float() - b.float())
                  for a, b in zip(ref.leaves(weights["server"]), start)]
        if sound:
            self._want = (losses, grad, change)
        return losses, grad, change

    def compare(self, got, want) -> dict:
        (l_got, g_got, c_got), (l_want, g_want, c_want) = got, want
        counted = ref_util.counted_leaves(g_want)
        self.details = {
            "losses": list(l_got), "ref_losses": list(l_want),
            "loss_gaps": [ref_util.relative_gap(a, b) for a, b in zip(l_got, l_want)],
            "grad_gaps": [abs(a - b) / max(b, 1e-30) for a, b in zip(g_got, g_want)],
            "update_gaps": [abs(a - b) / max(b, 1e-30) for a, b in zip(c_got, c_want)],
            "grad_norms": list(g_want), "counted": counted}
        return {"loss_gap": self.details["loss_gaps"][0],
                "grad_gap": ref_util.leaf_gap(g_got, g_want, counted),
                "update_gap": ref_util.leaf_gap(c_got, c_want, counted)}

    def check(self) -> dict:
        return self.compare((self.prog_loss, self.prog_grad, self.prog_change),
                            self.reference())

    def control(self) -> dict:
        """The control: the reference in bfloat16 throughout in the
        program's place."""
        want = self.reference()
        return self.compare(self.reference(torch.bfloat16), want)

    def fault_half_batch(self) -> dict:
        """A planted fault: the reference scoring only the first half of
        each window's positions, in the program's place."""
        want = self.reference()
        return self.compare(self.reference(keep=self.mix["window"] // 2), want)
