"""The traced window: the profiler's events reduced to plain records, the
device's busy time, and the breakdown of device time and idle gaps.

An :class:`Event` is a host operation (``kind`` "cpu", with its self time)
or an operation on the device (``kind`` "device": a kernel, a copy or a
memset), with its start and end in microseconds on the profiler's clock.
The readers under ``metrics/`` take these records, never the profiler.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str  # "cpu" or "device"
    start_us: float
    end_us: float
    self_us: float = 0.0

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


def events_from_profiler(prof) -> List[Event]:
    """Every host and device event of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # a record_function span shows on the device's timeline too, as
            # a user annotation; it is no work of the device
            if getattr(e, "is_user_annotation", False) or e.name.startswith("perfbench."):
                continue
            out.append(Event(e.name, "device", e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CPU and not e.is_async:
            out.append(Event(e.name, "cpu", e.time_range.start, e.time_range.end,
                             e.self_cpu_time_total))
    return out


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clipped(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_us(events: Sequence[Event], lo: float, hi: float) -> float:
    """Microseconds of ``[lo, hi]`` in which some operation ran on the device."""
    spans = merged(clipped([(e.start_us, e.end_us) for e in events if e.kind == "device"],
                           lo, hi))
    return sum(e - s for s, e in spans)


def idle_gaps(events: Sequence[Event], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` with nothing on the device."""
    spans = merged(clipped([(e.start_us, e.end_us) for e in events if e.kind == "device"],
                           lo, hi))
    gaps, at = [], lo
    for s, e in spans:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def host_ops_at(cpu: Sequence[Event], times: Sequence[float]) -> List[str]:
    """For each of the sorted ``times``, the innermost host operation running
    then (of those that cover it, the one that started last), or "python"
    where none does: one sweep over the operations sorted by start."""
    ops = sorted(cpu, key=lambda e: e.start_us)
    stack: List[Event] = []
    out, i = [], 0
    for t in times:
        while i < len(ops) and ops[i].start_us <= t:
            stack.append(ops[i])
            i += 1
        while stack and stack[-1].end_us <= t:
            stack.pop()
        out.append(stack[-1].name if stack else "python")
    return out


def device_time_us(events: Sequence[Event], name_part: str) -> float:
    """Microseconds of device operations whose name holds ``name_part``."""
    return sum(e.dur_us for e in events if e.kind == "device" and name_part in e.name)


def breakdown(events: Sequence[Event], lo: float, hi: float, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time of the
    window summed by the host operation running in the middle of each gap,
    each as ``[[name, seconds], ...]``, at most ``top`` entries."""
    dev: Dict[str, float] = collections.defaultdict(float)
    for e in events:
        if e.kind == "device":
            dev[e.name[:120]] += e.dur_us
    gaps = idle_gaps(events, lo, hi)
    names = host_ops_at([e for e in events if e.kind == "cpu"],
                        [0.5 * (s + e) for s, e in gaps])
    idle: Dict[str, float] = collections.defaultdict(float)
    for (s, e), name in zip(gaps, names):
        idle[name] += e - s
    rank = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(dev), "idle_gaps": rank(idle)}
