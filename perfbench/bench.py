"""The harness: one run of one cell, driven by the files the cell names.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the mix's ``kind`` names its runner
(``traffic/<kind>.py``), and ``cells/<cell>.json`` holds the limits of the
numbers that decide ``correct``. Each per-layer metric is read by
``metrics/<metric>.py``. A later change adds cells, mixes, configurations
and readers as new files; this module takes them by name.

A run: set-up (the program's session, the weights made from the seed, the
data, warm-up of the cell's shapes), then the measured window of units of
work (a runner's ``unit``: one ``serve`` call or one ``fit``), with the
profiler around it where ``trace`` is set; then the peak memory, the
program's state freed, the reference's check, and the result.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from perfbench import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """What one run needs to know of its cell."""

    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, Optional[float]]
    end_to_end: List[dict]
    per_layer: List[dict]


def _for_cell(metrics: List[dict], name: str) -> List[dict]:
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of the benchmark file, with its configuration, mix,
    limits and metrics."""
    bench = load_json(bench_path)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in {bench_path.name}")
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(workload=w, config=load_json(ROOT / cfg_entry["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "cells" / f"{name}.json")["limits"],
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner_class(kind: str):
    """The runner of a traffic kind: ``traffic/<kind>.py``'s ``Runner``."""
    return _load_module(HERE / "traffic" / f"{kind}.py", f"perfbench_traffic_{kind}").Runner


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<metric>.py``'s ``read``."""
    mod = _load_module(HERE / "metrics" / f"{metric}.py",
                       "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"))
    return mod.read


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the traced window's events, its length
    by the host's clock and the device's busy seconds in it, the program's
    counts over the traced units, and the configuration."""

    events: List[trace_mod.Event]
    window_s: float
    busy_s: float
    counts: Dict[str, Any]
    cfg: dict


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _window(drv, seconds: float):
    """Units of work until ``seconds`` have passed: (units, seconds taken)."""
    units = 0
    t0 = time.perf_counter()
    while True:
        with torch.profiler.record_function("perfbench.unit"):
            drv.unit()
        units += 1
        if time.perf_counter() - t0 >= seconds:
            return units, time.perf_counter() - t0


def run(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
        t_start: Optional[float] = None, after=None, t_import: float = 0.0) -> dict:
    """One run of ``cell``: the result's dict (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with ``traced`` also
    ``breakdown``, and ``compared`` last), with the set-up's phases in
    seconds under ``setup_phases`` (``t_import``: the seconds the caller
    spent importing). ``after(runner)``, where given, runs once the check
    is done and its dict goes under ``"after"``."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    drv = runner_class(cell.traffic["kind"])(cell.config, cell.traffic, seed, device)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    drv.start_window()
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("perfbench.window"):
                units, window_s = _window(drv, min(seconds, cell.traffic["trace_seconds"]))
        events = trace_mod.events_from_profiler(prof)
        del prof
    else:
        units, window_s = _window(drv, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = drv.end_to_end(window_s)
    counts = drv.counts()
    attempted, failed = drv.attempted_failed()
    drv.release()
    compared = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in drv.check().items()}
    out: Dict[str, Any] = {}
    if after is not None:
        out["after"] = after(drv)
    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        span = [e for e in events if e.kind == "cpu" and e.name == "perfbench.window"][0]
        lo, hi = span.start_us, span.end_us
        busy_s = trace_mod.busy_us(events, lo, hi) / 1e6
        ctx = Context(events, (hi - lo) / 1e6, busy_s, counts, cell.config)
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info.update({"busy_s": busy_s, "window_s": (hi - lo) / 1e6})
        out["breakdown"] = trace_mod.breakdown(events, lo, hi)
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(v["value"] is not None and math.isfinite(v["value"])
                  and v["limit"] is not None and v["value"] <= v["limit"]
                  for v in compared.values())
    return {"correct": bool(correct and compared), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device_info, **out,
            "units": units, "setup_phases": {"import": t_import, **drv.phases},
            "compared": compared}
