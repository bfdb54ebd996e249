"""The model's weights, made by the benchmark from ``--seed`` on the device.

One generator on the device, one standard-normal draw for every weight of
the trunk and of each hospital's client stage, cut into the leaves and
scaled by 1/sqrt(fan-in) (the LeCun-normal init of the port's
``dense_init``); biases are zero, as the port initialises them. The tree
is the port's canonical one: ``client_banks`` with a leading hospital axis
on every leaf, ``server`` with ``stages``, ``dense`` and ``out``. The
benchmark hands the same tensors to the program and, made again from the
same seed, to the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.work import conv_layers, dense_layers

WEIGHTS_TAG = 7


def seed_word(*entropy: int) -> int:
    """The first 63-bit word of ``SeedSequence(entropy)``."""
    seq = np.random.SeedSequence(tuple(int(e) for e in entropy))
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _shapes(cfg: dict, n_clients: int):
    """``(path, shape, fan_in)`` of every weight, the trunk's first, then the
    client stage's with a leading hospital axis."""
    out = []
    convs = conv_layers(cfg)
    client = [c for c in convs if c["client"]]
    trunk = [c for c in convs if not c["client"]]
    i = 0
    for si, (_, repeats) in enumerate(cfg["stages"][cfg["cut_layers"]:]):
        for j in range(repeats):
            c = trunk[i]
            out.append((("server", "stages", si, j), (3, 3, c["cin"], c["cout"]), 9 * c["cin"]))
            i += 1
    dense = dense_layers(cfg)
    for k, d in enumerate(dense[:-1]):
        out.append((("server", "dense", k), (d["d_in"], d["d_out"]), d["d_in"]))
    out.append((("server", "out"), (dense[-1]["d_in"], dense[-1]["d_out"]), dense[-1]["d_in"]))
    i = 0
    for si, (_, repeats) in enumerate(cfg["stages"][:cfg["cut_layers"]]):
        for j in range(repeats):
            c = client[i]
            out.append((("client_banks", "stages", si, j),
                        (n_clients, 3, 3, c["cin"], c["cout"]), 9 * c["cin"]))
            i += 1
    return out


def _empty_tree(cfg: dict):
    cut = cfg["cut_layers"]
    return {
        "client_banks": {"stages": [[None] * r for _, r in cfg["stages"][:cut]]},
        "server": {"stages": [[None] * r for _, r in cfg["stages"][cut:]],
                   "dense": [None] * len(cfg["dense_units"]), "out": None},
    }


def make_weights(cfg: dict, seed: int, device, n_clients: int) -> dict:
    """``{"client_banks": ..., "server": ...}`` drawn on ``device`` from
    ``seed`` in one call, float32."""
    shapes = _shapes(cfg, n_clients)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_word(seed, WEIGHTS_TAG))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    tree = _empty_tree(cfg)
    off = 0
    for path, shape, fan_in in shapes:
        n = math.prod(shape)
        w = flat[off:off + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
        off += n
        b = torch.zeros(shape[:1] + shape[-1:] if path[0] == "client_banks" else shape[-1:],
                        device=device, dtype=torch.float32)
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = {"w": w, "b": b}
    return tree


def leaves(tree):
    """The leaves in the order of ``jax.tree.leaves`` (dict keys sorted,
    lists in order): the order of the port's flat optimizer buffers."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [] if tree is None else [tree]

