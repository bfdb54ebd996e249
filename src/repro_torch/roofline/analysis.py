"""Three-term roofline of one rank's step on an H100 cluster, as
``repro.roofline.analysis``:

  compute    = sum over dtypes of FLOPs / the card's peak for that dtype
  memory     = bytes / HBM bandwidth
  collective = sum over collectives of wire bytes / the group's link rate

The reference reads XLA's ``cost_analysis`` of a compiled module. Here the
counts come from ONE traced step, the very code a real grid runs: the
rank's step (``launch.steps``) runs on the rank's blocks of its inputs as
fake tensors (``FakeTensorMode``, no storage) on a mesh over the fake
process group (``launch.dryrun``), and :func:`count_step` reads it:

  * FLOPs: the formulas of ``torch.utils.flop_counter`` (its
    ``flop_registry``: matmuls, convolutions and attention kernels, the
    count ``FlopCounterMode`` gives; like the reference's FLOP count it is
    per rank, and unlike XLA's it counts no elementwise op), split by the
    dtype each product reads;
  * bytes: the sum of each aten op's input and output bytes (views move
    none), an UNFUSED upper bound: every op here is its own kernel, as in
    eager PyTorch, where XLA would fuse chains of elementwise ops;
  * collectives: the result bytes of every collective the port issues
    (``sharding.collectives.recording``), all-reduce weighted 2x (a ring's
    reduce-scatter and all-gather), each at NVLink's rate where its group
    sits inside one node of eight cards and at the inter-node rate where
    it spans nodes;
  * memory: the rank's held inputs (its blocks of the state and batch)
    plus the peak of the tensors the step holds alive at once.

A Python loop runs every group of the trunk, so every group is counted: no
probe correction is applied (the reference adds ``(n_groups - 1)``
probes, since XLA counts a while loop's body once).

These are predictions from counts for a cluster of H100 SXM5 cards, not
measurements: the constants below are datasheet figures.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.sharding import collectives

HW_H100 = {
    # NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: BF16/FP16 Tensor
    # Core 1,979 TFLOPS with sparsity, so 989e12 dense; FP32 67 TFLOPS
    # (the CUDA cores: float32 products with TF32 off, as the port runs a
    # float32 config; a bf16 config's matmuls count at the bf16 peak)
    "peak_flops": {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12},
    # same datasheet: GPU memory bandwidth 3.35 TB/s (HBM3, 80 GB)
    "hbm_bw": 3.35e12,
    # same datasheet: NVLink 900 GB/s per card, both directions together
    "link_bw": 450e9,
    "node_size": 8,  # NVIDIA DGX H100: 8 cards a node on NVSwitch
    # NVIDIA DGX H100 datasheet: one 400 Gb/s ConnectX-7 InfiniBand port a
    # card, 50 GB/s one way, for a group that spans nodes
    "inter_node_bw": 50e9,
}

_WIRE_FACTOR = {
    "all_reduce": 2.0,  # ring all-reduce = reduce-scatter + all-gather
    "all_gather": 1.0,
    "broadcast": 1.0,
}


@dataclasses.dataclass
class StepCounts:
    """What :func:`count_step` read off one traced step of one rank."""

    flops: float
    flops_by_dtype: Dict[str, float]
    bytes: float
    collectives: list  # (op, result bytes, group ranks)
    held_bytes: float
    peak_live_bytes: float
    ops: list  # (name, opcode, result bytes), in program order


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives_by_type: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_flops_ratio: float
    memory_per_device_bytes: Optional[float] = None
    peak_memory_bytes: Optional[float] = None
    flops_by_dtype: Optional[Dict[str, float]] = None

    def to_dict(self):
        return dataclasses.asdict(self)


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode D = batch."""
    n_active = cfg.active_param_count()
    if shape.kind == "decode":
        tokens = shape.global_batch  # one token a sequence
        return 2.0 * n_active * tokens  # forward only
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens  # forward only
    return 6.0 * n_active * tokens  # forward + backward


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Bytes, FLOPs by dtype, the live tensors' peak and the op record."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops: Dict[str, float] = {}
        self.live: Dict[int, int] = {}
        self.now = self.peak = 0
        self.ops = []

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.now += self.live[key]
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            first = next(_tensors(args))
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            key = str(first.dtype).split(".")[-1]
            self.flops[key] = self.flops.get(key, 0.0) + n
        outs = list(_tensors(out))
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors(args)) + sum(_nbytes(t) for t in outs)
            for t in outs:
                self._alloc(t)
        self.ops.append((f"%{len(self.ops)}", str(packet).split(".")[-1],
                         sum(_nbytes(t) for t in outs)))
        return out


def count_step(lowering, mesh, local=None) -> StepCounts:
    """Run one rank's step of ``lowering`` (``launch.steps``) on its blocks
    of the inputs, in the lowering's fake mode on ``mesh``, and count it."""
    from repro_torch.launch.steps import local_args

    args = local_args(lowering, mesh) if local is None else local
    held = sum(_nbytes(t) for t in _tensors(args))
    with collectives.recording() as record, lowering.mode, _Counter() as c:
        out = lowering.fn(*args)
        del out
    return StepCounts(flops=float(sum(c.flops.values())), flops_by_dtype=dict(c.flops),
                      bytes=float(c.bytes),
                      collectives=record, held_bytes=float(held), peak_live_bytes=float(c.peak),
                      ops=c.ops)


def collective_time(records, hw=HW_H100) -> float:
    """Seconds of the wire: each collective's bytes over its group's rate."""
    t = 0.0
    for op, nbytes, ranks in records:
        nodes = {r // hw["node_size"] for r in ranks}
        rate = hw["link_bw"] if len(nodes) <= 1 else hw["inter_node_bw"]
        t += nbytes * _WIRE_FACTOR[op] / rate
    return t


def analyze_lowering(cfg, shape, mesh_name: str, n_devices: int, counts: StepCounts,
                     hw=HW_H100) -> RooflineReport:
    """The three terms of one rank's counted step (:func:`count_step`)."""
    peak = hw["peak_flops"]
    t_compute = sum(n / peak[getattr(torch, dt)] for dt, n in counts.flops_by_dtype.items())
    t_memory = counts.bytes / hw["hbm_bw"]
    colls: Dict[str, float] = {}
    for op, nbytes, _ in counts.collectives:
        colls[op] = colls.get(op, 0.0) + nbytes * _WIRE_FACTOR[op]
    t_collective = collective_time(counts.collectives, hw)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    mf = model_flops_estimate(cfg, shape)
    total = counts.flops * n_devices
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=counts.flops, bytes_per_device=counts.bytes,
        collective_bytes_per_device=sum(colls.values()), collectives_by_type=colls,
        t_compute=t_compute, t_memory=t_memory, t_collective=t_collective,
        bottleneck=max(terms, key=terms.get), model_flops=mf,
        useful_flops_ratio=mf / total if total else 0.0,
        memory_per_device_bytes=counts.held_bytes,
        peak_memory_bytes=counts.held_bytes + counts.peak_live_bytes,
        flops_by_dtype=dict(counts.flops_by_dtype))
