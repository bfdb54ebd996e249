"""The training runner: the consortium trains through ``SplitSession.fit``.

A unit of work is one ``fit(shards, epochs=1, steps_per_epoch=1)`` call,
which draws its epoch's plan as a user's call does. The mix's parameters:
``mode`` ("detached", the temporal split), ``server_batch``,
``optimizer`` (AdamW's lr,
b1, b2, eps, weight decay), ``grad_clip``, ``shard_rows`` (input rows for
the hospitals together), ``check_steps`` (the first steps the reference
follows) and ``trace_seconds``.

Correct: set-up builds the session and drives it through its first
``check_steps`` steps with the window's own call; the same object then
runs the window. On those steps the program's loss, the first step's
gradient as AdamW got it (its first moment over 1 - b1) and the change of
the trunk's parameters after the last of them are kept, each gradient and
change as a norm a leaf. After the window the plain reference follows the
same steps from the same weights, rows and noise (the plan worked out
again from the seed). The numbers compared: ``loss_gap``, the relative gap
of the first step's loss (the later steps' losses part by AdamW's
amplification of rounding, as far as the control's do); ``grad_gap`` and
``update_gap``, the worst
leaf's gap of norms over the larger of its reference norm and the median
leaf's, over the leaves whose reference gradient is above a thousandth of
the median leaf's.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import program, work
from perfbench.clock import Phases
from perfbench.inputs.data import make_images, split_clients
from perfbench.reference import cnn as ref
from perfbench.reference import draws
from perfbench.weights import leaves, make_weights, seed_word

DATA_TAG = 13


class Runner:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        if mix["mode"] != "detached":
            raise ValueError("the training runner's reference follows the detached split")
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), device
        self.c = cfg["hospitals"]
        self.b = max(1, mix["server_batch"] // self.c)
        self.losses = []
        self._batches = None
        self.phases = Phases(device)

    def _fit(self):
        return self.sess.fit(self.shards, epochs=1, steps_per_epoch=1)

    def setup(self):
        with self.phases("session"):
            self.sess = program.session(self.cfg, self.seed, self.device,
                                        server_batch=self.mix["server_batch"],
                                        mode=self.mix["mode"], opt=self.mix["optimizer"],
                                        grad_clip=self.mix["grad_clip"])
        with self.phases("weights"):
            weights = make_weights(self.cfg, self.seed, self.device, self.c)
            program.put_weights(self.sess, weights)
        with self.phases("data"):
            x, y = make_images(self.cfg["images"], self.mix["shard_rows"],
                               seed_word(self.seed, DATA_TAG) % 2**32, self.cfg["input_hw"][0])
            self.shards = split_clients(x, y, self.cfg["shares"],
                                        seed=seed_word(self.seed, DATA_TAG))
        with self.phases("first_steps"):
            self._first_steps(weights)

    def _first_steps(self, weights):
        """The first ``check_steps`` steps through the window's own call,
        keeping what the reference is compared with."""
        self.prog_loss = []
        for step in range(self.mix["check_steps"]):
            self.prog_loss.append(float(self._fit()[0]["loss"]))
            if step == 0:
                mu = self.sess.state["opt"]["mu"]
                b1 = self.mix["optimizer"]["b1"]
                self.prog_grad = [ref.norm(g) for g in self._split(mu / (1 - b1))]
        self.prog_change = [ref.norm(a - b) for a, b in zip(leaves(self.sess.state["server"]),
                                                            leaves(weights["server"]))]

    def _split(self, flat):
        """A flat buffer of the trunk's leaves (the optimizer's order) cut
        into the leaves."""
        sizes = [t.numel() for t in leaves(self.sess.state["server"])]
        if sum(sizes) != flat.numel():
            raise RuntimeError("the optimizer's buffer is not the trunk's leaves")
        return torch.split(flat, sizes)

    # ------------------------------------------------------------ window
    def start_window(self):
        self.losses = []
        self.launches0 = program.Launches.now()

    def unit(self):
        self.losses.append(float(self._fit()[0]["loss"]))

    def end_to_end(self, window_s: float) -> dict:
        return {"train_samples_per_s": len(self.losses) * self.c * self.b / window_s}

    def attempted_failed(self):
        return len(self.losses), sum(not np.isfinite(v) for v in self.losses)

    def counts(self) -> dict:
        launched = program.Launches.now().since(self.launches0)
        rows = len(self.losses) * self.c * self.b
        return {"steps": len(self.losses), "rows": rows,
                "dp_release_calls": launched.dp_release_calls,
                "dp_release_shape": work.feature_shape(self.cfg, self.c * self.b),
                "model_flops": rows * work.detached_train_flops_per_row(self.cfg)}

    def release(self):
        del self.sess
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def batches(self):
        """The first ``check_steps`` steps' batches, the plan worked out
        again from the seed, on the device (made once)."""
        if self._batches is None:
            self._batches = self._make_batches()
        return self._batches

    def _make_batches(self):
        lens = [len(x) for x, _ in self.shards]
        feat = work.feature_shape(self.cfg, self.b)[1:]
        sigma = work.sigma(self.cfg["guard"])
        out = []
        for epoch in range(1, self.mix["check_steps"] + 1):
            idx, mn, gn = draws.train_plan(self.seed, epoch, lens, 1, self.b, feat,
                                           self.cfg["privacy_noise"] > 0, sigma > 0)
            rows = [idx[0, c].numpy() for c in range(self.c)]
            xs = torch.stack([torch.as_tensor(self.shards[c][0][rows[c]]) for c in range(self.c)])
            ys = torch.stack([torch.as_tensor(self.shards[c][1][rows[c]]) for c in range(self.c)])
            dev = lambda a: None if a is None else a[0].to(self.device)  # noqa: E731
            out.append({"xs": xs.to(self.device), "ys": ys.to(self.device),
                        "model_noise": dev(mn), "guard_noise": dev(gn)})
        return out

    def reference(self, mode: str = "float32", drop_half: bool = False):
        """The reference's losses, first gradient and change, a norm a leaf."""
        weights = make_weights(self.cfg, self.seed, self.device, self.c)
        start = [t.clone() for t in leaves(weights["server"])]
        with ref.precision(mode):
            losses, grad = ref.train_steps(
                ref.Model(self.cfg, mode), weights["client_banks"], weights["server"],
                self.batches(), self.cfg["shares"], self.cfg["guard"],
                work.sigma(self.cfg["guard"]), self.mix["optimizer"], self.mix["grad_clip"],
                drop_half=drop_half)
        change = [ref.norm(a - b) for a, b in zip(leaves(weights["server"]), start)]
        return losses, [ref.norm(g) for g in grad], change

    def compare(self, got, want) -> dict:
        (l_got, g_got, c_got), (l_want, g_want, c_want) = got, want
        counted = ref.counted_leaves(g_want)
        self.details = {
            "loss_gaps": [ref.relative_gap(a, b) for a, b in zip(l_got, l_want)],
            "grad_gaps": [abs(a - b) / max(b, 1e-30) for a, b in zip(g_got, g_want)],
            "update_gaps": [abs(a - b) / max(b, 1e-30) for a, b in zip(c_got, c_want)],
            "grad_norms": list(g_want), "counted": counted}
        return {"loss_gap": self.details["loss_gaps"][0],
                "grad_gap": ref.leaf_gap(g_got, g_want, counted),
                "update_gap": ref.leaf_gap(c_got, c_want, counted)}

    def check(self) -> dict:
        return self.compare((self.prog_loss, self.prog_grad, self.prog_change),
                            self.reference())

    def control(self) -> dict:
        """The control: the reference in TF32 in the program's place."""
        want = self.reference()
        return self.compare(self.reference("tf32"), want)

    def fault_half_batch(self) -> dict:
        """A planted fault: the reference with half of each hospital's rows
        left out of the loss, in the program's place."""
        want = self.reference()
        return self.compare(self.reference(drop_half=True), want)
