"""The system under test, built from a configuration file: the port's
``SplitSession`` over its CNN adapter and guard, with the benchmark's
weights put in place of the ones the session drew, and the port's launch
counters. The only module of the harness, with the runners, that imports
the program.
"""
from __future__ import annotations

import dataclasses

import torch

from perfbench.weights import leaves


def model_config(cfg: dict):
    """The port's ``CNNConfig`` of a configuration file."""
    from repro_torch.configs.paper_models import CNNConfig

    if cfg["model"] != "cnn" or cfg["loss"] != "bce" or cfg["dtype"] != "float32":
        raise ValueError(f"{cfg['name']}: the runners take float32 CNNs with a BCE loss")
    return CNNConfig(name=cfg["name"], input_hw=tuple(cfg["input_hw"]),
                     in_channels=cfg["in_channels"],
                     stages=tuple(tuple(s) for s in cfg["stages"]),
                     n_classes=cfg["n_classes"], dense_units=tuple(cfg["dense_units"]),
                     cut_layers=cfg["cut_layers"], privacy_noise=cfg["privacy_noise"],
                     use_kernel=cfg["use_kernel"])


def session(cfg: dict, seed: int, device, *, server_batch: int = 64, mode: str = "detached",
            opt: dict = None, grad_clip: float = 1.0):
    """A ``SplitSession`` (engine "auto") of the configuration: its hospitals
    and shares, its guard, ``adamw`` from ``opt``."""
    from repro_torch.core.adapters import cnn_adapter
    from repro_torch.core.session import SplitSession
    from repro_torch.core.trainer import SplitTrainConfig
    from repro_torch.optim.optimizers import adamw
    from repro_torch.privacy.guard import DPConfig

    g = cfg["guard"]
    dp = DPConfig(epsilon=g["epsilon"], delta=g["delta"], clip_norm=g["clip_norm"],
                  use_kernel=g["use_kernel"])
    tc = SplitTrainConfig(n_clients=cfg["hospitals"], data_shares=tuple(cfg["shares"]),
                          server_batch=server_batch, mode=mode, privacy=dp,
                          grad_clip=grad_clip)
    opt = opt or {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.0}
    optimizer = adamw(opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                      weight_decay=opt["weight_decay"])
    return SplitSession(cnn_adapter(model_config(cfg)), tc, optimizer, engine="auto",
                        seed=seed, device=device)


@torch.no_grad()
def put_weights(sess, weights: dict) -> None:
    """Copy the benchmark's ``client_banks`` and ``server`` into the
    session's state, then read the state back and require every leaf equal
    to the benchmark's, so that a session which handed out a copy is
    caught."""
    for key in ("client_banks", "server"):
        dst, src = leaves(sess.state[key]), leaves(weights[key])
        if [tuple(d.shape) for d in dst] != [tuple(s.shape) for s in src]:
            raise RuntimeError(f"the session's {key} is not the configuration's")
        for d, s in zip(dst, src):
            d.copy_(s)
    for key in ("client_banks", "server"):
        if not all(torch.equal(d, s) for d, s in zip(leaves(sess.state[key]),
                                                       leaves(weights[key]))):
            raise RuntimeError(f"the session did not take the benchmark's {key}")


@dataclasses.dataclass
class Launches:
    """The port's kernel counters: ``privacy_conv`` launches and
    ``dp_release`` calls (one a release, of one or two launches)."""

    privacy_conv: int
    dp_release_calls: int

    @staticmethod
    def now() -> "Launches":
        from repro_torch.kernels.dp_release import ops as dp_ops
        from repro_torch.kernels.privacy_conv import ops as pc_ops

        return Launches(pc_ops.launches, sum(dp_ops.plans.values()))

    def since(self, before: "Launches") -> "Launches":
        return Launches(self.privacy_conv - before.privacy_conv,
                        self.dp_release_calls - before.dp_release_calls)
